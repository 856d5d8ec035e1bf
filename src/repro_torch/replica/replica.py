"""A RAW-safe read replica over one Poplar engine's log devices.

Wires the pieces together:

* one :class:`~repro_torch.replica.shipper.LogShipper` per log device, polled in
  parallel (no cross-device merge — the point of partially constrained
  logs);
* one :class:`~repro_torch.replica.applier.ReplicaApplier` folding shipped chunks
  into a live :class:`~repro_torch.db.array_table.ArrayTable`;
* the **read watermark** :meth:`Replica.visible_ssn` — the RSNe rule
  (``min`` over per-device shipped durable frontiers) driving *visibility*
  instead of crash recovery: the applier holds every HAS_READS record above
  it, so a replica read can never observe a transaction whose RAW
  predecessor has not been applied.  This is the same
  ``CommitProtocol.committable`` predicate the primary's commit stage uses
  (Qww: own-device durability; Qwr: ``ssn <= min(DSN)``), re-evaluated on
  the replica against shipped frontiers;
* **catch-up** from a fuzzy checkpoint: seed the table from
  :class:`~repro_torch.core.checkpoint.CheckpointData` and ship the log on top —
  replay idempotence (per-key SSN guard, checkpoint wins ties via the
  strict ``>``) makes re-shipping records already reflected in the image
  harmless, so no log/checkpoint coordination is needed;
* **promotion**: :meth:`promote` drains whatever has been shipped, applies
  the recovery consistent cut to it (anything still held is exactly what
  crash recovery would skip), and returns the servable
  :class:`~repro_torch.core.recovery.RecoveredState` — byte-identical to
  ``recover()`` over the same devices.

Runs stepped (tests call :meth:`poll` deterministically) or continuous
(:meth:`start` spawns a tailer thread), like the engines.  ``mode`` is the
applier's: ``"kernel"`` (the default) folds with the scatter-max kernel on
``device`` — launched from whichever thread polls, on that thread's current
CUDA stream — and raises on ``device="cuda"`` without a CUDA device.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.checkpoint import load_latest_checkpoint
from ..core.par import parallel_for
from ..core.recovery import RecoveredState
from ..core.storage import StorageDevice, TruncatedLogError
from ..db.array_table import ArrayTable
from ..obs.metrics import REGISTRY
from .applier import GateFn, ReplicaApplier
from .shipper import LogShipper


class Replica:
    """Continuously replicates one engine's devices into a readable table."""

    def __init__(
        self,
        devices: Sequence[StorageDevice],
        checkpoint_dir: Optional[str] = None,
        mode: str = "kernel",
        parallel: bool = True,
        name: str = "replica",
        device="cuda",
    ):
        self.parallel = parallel
        self.shippers = [LogShipper(d, i) for i, d in enumerate(devices)]
        self.table = ArrayTable(name=name)
        self.applier = ReplicaApplier(self.table, mode=mode, device=device)
        self.checkpoint_dir = checkpoint_dir
        self.rsns = 0
        self.n_rebases = 0
        self.promoted = False
        self._watermark = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # monotonic stamp of the last watermark advance — "lag in seconds"
        self._w_advance_t = time.monotonic()
        self._obs_names = tuple(
            f"replica.{name}.{suffix}"
            for suffix in ("visible_ssn", "lag_ssn", "lag_s",
                           "ship_backlog_bytes", "apply_backlog")
        )
        if checkpoint_dir is not None:
            ckpt = load_latest_checkpoint(checkpoint_dir, parallel=parallel)
            if ckpt is not None:
                self.rsns = ckpt.rsn
                self._seed(ckpt.data)

    def _seed(self, data) -> None:
        """Fold a checkpoint image into the table under the per-key SSN
        guard (one atomic upsert): sound both at construction and when
        re-seeding during a truncation rebase over a table that already
        holds newer applied writes."""
        if not data:
            return
        self.table.upsert_bytes(
            list(data.keys()),
            np.fromiter((v for v, _ in data.values()), object, len(data)),
            np.fromiter((s for _, s in data.values()), np.int64, len(data)),
        )

    # --- truncation re-basing ------------------------------------------------
    def _rebase(self, cause: TruncatedLogError) -> None:
        """A shipper's offset predates its device's truncation point: the
        missing bytes are gone, but the truncator's safe-point rule says the
        checkpoint that anchored the truncation covers every dropped record.
        Catch up from it instead of reading the hole: re-seed the table from
        the newest checkpoint image, then jump every lagging shipper to its
        device's base offset with the device's persisted ``truncated_ssn``
        as its new shipped-frontier floor — byte-identical, by the replay
        idempotence guard, to having shipped the dropped records themselves.
        """
        if self.checkpoint_dir is None:
            raise cause
        ckpt = load_latest_checkpoint(self.checkpoint_dir,
                                      parallel=self.parallel)
        if ckpt is None:
            raise cause
        self._seed(ckpt.data)
        self.rsns = max(self.rsns, ckpt.rsn)
        for sh in self.shippers:
            base_fn = getattr(sh.source, "base_offset", None)
            if base_fn is None:
                continue
            base = base_fn()
            if sh.consumed + len(sh._tail) < base:
                sh.rebase(base, int(getattr(sh.source, "truncated_ssn", 0)))
        # shipped-but-held records at or below the checkpoint RSN are fully
        # reflected by the image just seeded; marking them applied keeps
        # held() honest and lifts any cross-shard visibility cap they pinned
        self.applier.prune_below(ckpt.rsn)
        self.n_rebases += 1

    # --- watermark -----------------------------------------------------------
    def shipped_frontiers(self) -> List[int]:
        """Per-device shipped durable frontiers (the replicated DSNs)."""
        return [s.frontier for s in self.shippers]

    def visible_ssn(self) -> int:
        """The RAW-safe read watermark: every transaction with reads and
        ``ssn <= visible_ssn()`` is applied — the shipped prefix's RSNe.
        Monotone in polls.

        On a standalone replica no HAS_READS transaction *above* the
        watermark is applied either.  Inside a :class:`ShardedReplica` that
        upper bound holds only for ordinary records: a decided cross-shard
        HAS_READS transaction may apply above this shard's (capped)
        watermark — its RAW safety is established per participant edge by
        the live cut, not by this scalar (see `repro_torch.replica.sharded`)."""
        return self._watermark

    # --- stepped operation ---------------------------------------------------
    def ship(self, parallel: Optional[bool] = None):
        """Poll every device shipper (in parallel threads by default);
        returns the new chunks.  A shipper that fell behind a log truncation
        re-bases from the checkpoint transparently (see :meth:`_rebase`) and
        only the *failed* shippers are re-polled: the successful ones
        already advanced their consumed offsets, so discarding their chunks
        for a whole-round retry would lose those records forever while the
        frontiers still covered them."""
        par = self.parallel if parallel is None else parallel
        out: List[Optional[object]] = [None] * len(self.shippers)
        todo = list(range(len(self.shippers)))
        for attempt in range(4):  # a concurrent truncator pass may race
            errs: List[Optional[TruncatedLogError]] = [None] * len(self.shippers)

            def _poll(j: int, idx=tuple(todo)) -> None:
                i = idx[j]
                try:
                    out[i] = self.shippers[i].poll()
                except TruncatedLogError as e:
                    errs[i] = e

            parallel_for(len(todo), _poll, par)
            todo = [i for i in range(len(self.shippers)) if errs[i] is not None]
            if not todo:
                return out
            first = next(e for e in errs if e is not None)
            if attempt == 3:
                raise first
            self._rebase(first)
        return out

    def apply(self, new, gate: Optional[GateFn] = None,
              watermark: Optional[int] = None) -> int:
        """Advance the watermark and fold pre-shipped chunks.  ``watermark``
        caps the advance — the sharded replica uses it to keep visibility
        below undecided cross-shard records."""
        fr = [s.frontier for s in self.shippers]
        w = min(fr) if fr else 0
        if watermark is not None:
            w = min(w, watermark)
        if w > self._watermark:
            self._watermark = w
            self._w_advance_t = time.monotonic()
        n = self.applier.apply(new, self._watermark, gate=gate)
        if REGISTRY.enabled:
            names = self._obs_names
            REGISTRY.gauge_set(names[0], float(self._watermark))
            # SSN lag: spread between the fastest shipped frontier and the
            # RAW-safe watermark — what the min() rule is holding back
            REGISTRY.gauge_set(
                names[1], float((max(fr) if fr else 0) - self._watermark))
            REGISTRY.gauge_set(
                names[2], time.monotonic() - self._w_advance_t)
            REGISTRY.gauge_set(names[3], float(self.lag_bytes()))
            REGISTRY.gauge_set(names[4], float(self.applier.held()))
        return n

    def poll(self, gate: Optional[GateFn] = None,
             watermark: Optional[int] = None,
             parallel: Optional[bool] = None) -> int:
        """One replication round: ship all devices, advance the watermark,
        apply everything it admits.  Returns records newly applied."""
        return self.apply(self.ship(parallel=parallel), gate=gate,
                          watermark=watermark)

    def lag_bytes(self) -> int:
        return sum(s.lag_bytes() for s in self.shippers)

    def held(self) -> int:
        return self.applier.held()

    # --- reads ---------------------------------------------------------------
    def read(self, key: str) -> Optional[Tuple[bytes, int]]:
        """(value, ssn) as of the current watermark, or None.  RAW-safe by
        construction — the applier never folds a HAS_READS record whose
        predecessors could be missing — and torn-pair-safe: the table mutex
        makes the (value, ssn) pair atomic against a concurrent apply
        (``ArrayTable.get`` alone is lockless)."""
        with self.table.mutex:
            return self.table.get(key)

    # --- continuous operation ------------------------------------------------
    def start(self, poll_interval: float = 1e-3) -> None:
        """Tail continuously from a background thread until :meth:`stop`.

        The loop polls the devices *sequentially* — spawning a thread per
        device per poll would churn thread create/teardown thousands of
        times a second against the primary's GIL for reads that are plain
        byte copies."""
        self._stop.clear()

        def _loop() -> None:
            while not self._stop.is_set():
                if self.poll(parallel=False) == 0:
                    time.sleep(poll_interval)

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name=f"replica-{self.table.name}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    # --- promotion -----------------------------------------------------------
    def drain(self, gate: Optional[GateFn] = None,
              watermark: Optional[int] = None) -> None:
        """Ship+apply until a full round makes no progress (primary dead or
        quiesced)."""
        while True:
            before = [s.consumed for s in self.shippers]
            applied = self.poll(gate=gate, watermark=watermark)
            if applied == 0 and [s.consumed for s in self.shippers] == before:
                return

    def promote(self) -> RecoveredState:
        """Turn the replica into a servable primary state: drain whatever is
        still shippable, then run the recovery consistent cut on it — the
        records still held (HAS_READS above the final RSNe) are exactly the
        durable-but-uncommitted ones crash recovery skips.  The result is
        byte-identical to ``recover(devices)`` over the same device state.
        """
        self.stop()
        self.drain()
        self.promoted = True
        return RecoveredState(
            data=self.table.to_dict(),
            rsns=self.rsns,
            rsne=self._watermark,
            n_replayed=self.applier.n_applied,
            n_skipped_uncommitted=self.applier.held(),
        )
