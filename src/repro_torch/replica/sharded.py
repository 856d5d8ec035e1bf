"""Sharded replication: one shipper/applier pipeline per shard + the
cross-shard consistent cut applied *continuously*.

Each shard replicates independently with the single-engine machinery
(`repro_torch.replica.replica.Replica` — per-device shippers, vectorized applier,
per-shard watermark).  Cross-shard (``FLAG_XSHARD``) records get the PR-3
cut rule as a live gate instead of a crash-time decision:

* a cross-shard record becomes applicable only once a record with its gtid
  has been **shipped from every participant** (shipped ⇒ durable ⇒ the
  global commit is inevitable), and — when it has reads — once its per-shard
  SSN clears every participant's shipped frontier *and* no other unapplied
  cross-shard record sits below it on any participant (the Qwr rule per
  edge, `repro_torch.shard.recovery.resolve_cut`, evaluated in per-shard SSN
  order; prepare-order serialization on shared shards makes that ordering
  acyclic, so it cannot deadlock);
* until then it is *held*, and — the RAW-safety refinement live shipping
  needs on top of the crash-time cut — each shard's visibility watermark
  for ordinary HAS_READS records is **capped below its oldest unapplied
  cross-shard record**: a later HAS_READS record's RAW predecessor may be
  exactly that in-flight cross-shard transaction (committed on the
  primary, not yet shipped from every participant), so nothing with reads
  may become visible past it.  Frontiers only grow, so the cap only rises
  and every held record eventually applies (on a live primary every
  prepared participant record eventually flushes and ships).

:meth:`ShardedReplica.promote` finalizes exactly like sharded crash
recovery: whatever is still not durable-on-all-participants at the final
frontiers is dropped by ``resolve_cut`` — the promoted per-shard states are
byte-identical to ``recover_sharded()`` on the same devices.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core.recovery import RecoveredState
from ..core.storage import StorageDevice
from ..core.txn import ColumnarLog
from ..shard.recovery import ShardedRecoveredState, resolve_cut
from ..shard.router import Router
from .replica import Replica


class ShardedReplica:
    """N per-shard replication pipelines + the live cross-shard cut.

    ``shard_devices[p]`` must be shard ``p``'s device list in engine shard
    order (xdep shard ids index into it), like ``recover_sharded``.
    """

    def __init__(
        self,
        shard_devices: Sequence[Sequence[StorageDevice]],
        checkpoint_dirs: Optional[Sequence[Optional[str]]] = None,
        mode: str = "kernel",
        parallel: bool = True,
        device="cuda",
    ):
        n = len(shard_devices)
        if checkpoint_dirs is not None:
            assert len(checkpoint_dirs) == n
        self.replicas = [
            Replica(
                shard_devices[p],
                checkpoint_dir=None if checkpoint_dirs is None else checkpoint_dirs[p],
                mode=mode,
                parallel=parallel,
                device=device,
                name=f"replica-shard{p}",
            )
            for p in range(n)
        ]
        self.router = Router(n)
        self.promoted = False
        # cross-shard registry, accumulated from shipped chunks: gtid ->
        # participants seen durable, and gtid -> (participant vector, reads?).
        # Entries are pruned as soon as their transaction is applied (an
        # applied gtid can never be re-decided), so per-poll cut work is
        # O(in-flight cross-shard txns), not O(lifetime).
        self._durable: Dict[int, Set[int]] = {}
        self._info: Dict[int, Tuple[List[Tuple[int, int]], bool]] = {}
        self._seen_x = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # --- cross-shard registry ------------------------------------------------
    def _ingest(self, p: int, log: ColumnarLog) -> None:
        if log.x_rec is None:
            return
        for i, rec in enumerate(log.x_rec.tolist()):
            g = int(log.tid[rec])
            self._durable.setdefault(g, set()).add(p)
            if g not in self._info:
                lo, hi = int(log.xp_start[i]), int(log.xp_start[i + 1])
                self._info[g] = (
                    list(zip(log.xp_shard[lo:hi].tolist(),
                             log.xp_ssn[lo:hi].tolist())),
                    bool(log.has_reads[rec]),
                )
                self._seen_x += 1

    @staticmethod
    def _gate_for(keep: Dict[int, bool]):
        def gate(log: ColumnarLog) -> Optional[np.ndarray]:
            if log.x_rec is None:
                return None
            m = np.ones(log.n_records, dtype=bool)
            for rec in log.x_rec.tolist():
                # a gtid absent from ``keep`` was pruned after being applied
                # — the applier's per-chunk applied mask already blocks it,
                # so True is the safe default
                m[rec] = keep.get(int(log.tid[rec]), True)
            return m

        return gate

    # --- replication rounds --------------------------------------------------
    def _round(self, final: bool = False,
               parallel: Optional[bool] = None) -> Tuple[int, bool]:
        """Ship every shard, re-evaluate the cut, apply.  ``final`` switches
        the live hold-back discipline to the crash-time cut (primary dead:
        undecided cross-shard records are dropped, the watermark cap lifts).
        Returns ``(records applied, anything new shipped)``."""
        new = [r.ship(parallel=parallel) for r in self.replicas]
        shipped = any(log is not None for logs in new for log in logs)
        for p, logs in enumerate(new):
            for log in logs:
                if log is not None:
                    self._ingest(p, log)
        # checkpoint-image coverage (seeded at construction or by a
        # truncation rebase inside ship()): a record with ssn <= the shard's
        # seeded RSN is fully reflected by that image, so it needs no fold —
        # and a cross-shard record whose *every* participant edge is
        # image-covered can never be re-decided (all its records were
        # durable before the checkpoints — see the truncator's coverage
        # rule), so its registry entry is dead.  Without this, a gtid whose
        # copy was truncated away on one participant would sit undecided
        # forever, capping that shard's Qwr visibility below it.
        for r in self.replicas:
            if r.rsns:
                r.applier.prune_below(r.rsns)
        for g in list(self._info):
            parts, _ = self._info[g]
            if all(s <= self.replicas[q].rsns for q, s in parts):
                del self._info[g]
                self._durable.pop(g, None)
        frontiers = [
            min(f) if (f := r.shipped_frontiers()) else 0 for r in self.replicas
        ]
        if final:
            marks = decide = frontiers
        else:
            xmin: List[Optional[int]] = []
            for p, r in enumerate(self.replicas):
                m = r.applier.pending_x_min_ssn()
                for log in new[p]:
                    if log is not None and log.x_rec is not None and len(log.x_rec):
                        mm = int(log.ssn[log.x_rec].min())
                        m = mm if m is None else min(m, mm)
                xmin.append(m)
            # non-x Qwr visibility is capped *below* the oldest unapplied
            # x-record (its RAW predecessor may be exactly that record) ...
            marks = [f if m is None else min(f, m - 1)
                     for f, m in zip(frontiers, xmin)]
            # ... while an x-record itself is decided against the uncapped
            # shipped frontiers — but only the lowest unapplied x-record on
            # each participant may go first (no possibly-RAW-predecessor
            # x-record below it).  ``min(f, m)`` admits exactly the record
            # sitting at the minimum and everything the frontier covers;
            # prepare-order serialization on shared shards makes this
            # ordering acyclic, so every decidable record eventually applies.
            decide = [f if m is None else min(f, m)
                      for f, m in zip(frontiers, xmin)]
        keep = resolve_cut(self._durable, self._info, decide)
        gate = self._gate_for(keep)
        applied = sum(
            r.apply(new[p], gate=gate, watermark=marks[p])
            for p, r in enumerate(self.replicas)
        )
        # prune applied gtids: keep=True required durable-on-all, so every
        # participant's record was in pending and the gate applied it above
        for g, ok in keep.items():
            if ok:
                del self._info[g]
                del self._durable[g]
        return applied, shipped

    def poll(self) -> int:
        """One live replication round over every shard."""
        return self._round(final=False)[0]

    # --- watermark / reads ---------------------------------------------------
    def visible_ssn(self, shard: Optional[int] = None):
        """Per-shard RAW-safe read watermark (list without ``shard``)."""
        if shard is not None:
            return self.replicas[shard].visible_ssn()
        return [r.visible_ssn() for r in self.replicas]

    def read(self, key: str) -> Optional[Tuple[bytes, int]]:
        return self.replicas[self.router.shard_of(key)].read(key)

    def lag_bytes(self) -> int:
        return sum(r.lag_bytes() for r in self.replicas)

    def held(self) -> int:
        return sum(r.held() for r in self.replicas)

    # --- continuous operation ------------------------------------------------
    def start(self, poll_interval: float = 1e-3) -> None:
        """Continuous tailing thread; polls sequentially (see
        :meth:`Replica.start` for why not a thread per device per poll)."""
        self._stop.clear()

        def _loop() -> None:
            while not self._stop.is_set():
                if self._round(final=False, parallel=False)[0] == 0:
                    time.sleep(poll_interval)

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="sharded-replica")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    # --- promotion -----------------------------------------------------------
    def promote(self) -> ShardedRecoveredState:
        """Finalize into a servable sharded state (call once the primary is
        dead/quiesced): drain everything shippable, then apply the crash
        consistent cut — byte-identical to ``recover_sharded()`` on the same
        devices."""
        self.stop()
        while True:
            applied, shipped = self._round(final=True)
            if applied == 0 and not shipped:
                break
        frontiers = [
            min(f) if (f := r.shipped_frontiers()) else 0 for r in self.replicas
        ]
        # the registry now holds only never-applied gtids: exactly the drops
        keep = resolve_cut(self._durable, self._info, frontiers)
        out = ShardedRecoveredState(
            n_cross_seen=self._seen_x,
            n_cross_dropped=sum(1 for v in keep.values() if not v),
        )
        for r in self.replicas:
            out.shards.append(
                RecoveredState(
                    data=r.table.to_dict(),
                    rsns=r.rsns,
                    rsne=r.visible_ssn(),
                    n_replayed=r.applier.n_applied,
                    n_skipped_uncommitted=r.applier.held(),
                )
            )
        self.promoted = True
        return out
