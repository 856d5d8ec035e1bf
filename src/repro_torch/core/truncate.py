"""Checkpoint-anchored log truncation (§5's purpose made operational).

A fuzzy checkpoint exists to *bound* recovery, yet an append-only-forever
log grows the recovery replay, the disk footprint, and replica cold
catch-up without bound.  The truncator closes that loop: once a checkpoint
is durable, every log record the checkpoint image provably covers is dead
weight and its sealed segments can be dropped.

Safe-point rule (per engine):

* the checkpoint contributes its **RSN** — the CSN at checkpoint start.
  Every record with ``ssn <= RSN`` was durable *and applied to the tuple
  store* before the fuzzy scan began (commit required ``CSN >= ssn``, and
  CSN already equalled RSN at start), so the scan observed its write or a
  newer one for every key it touched: the image supersedes the record under
  the per-key SSN guard (checkpoint wins ties).  Note this is deliberately
  *not* ``max_observed``: a record with ``RSN < ssn <= max_observed`` may
  have written a key *after* the scanner passed it, so only the log carries
  its newest value — truncating it would lose a committed write.
* every **live consumer** caps it from below: a registered replica shipper,
  journal tailer, or cross-shard cut contributes the SSN frontier it has
  consumed through (:class:`FrontierRegistry`); records above any
  consumer's frontier stay.  A consumer that instead falls behind a
  truncation (registered late, offline) hits
  :class:`~repro_torch.core.storage.TruncatedLogError` and re-bases from the
  checkpoint — the safe-point rule is exactly what makes that fallback
  lossless.

The truncator seals each device's flushed tail under the owning buffer's
flush lock (so the segment's ``last_ssn`` stamp — the buffer DSN — is
consistent with its bytes), then drops whole sealed segments whose
``last_ssn`` is at or below the safe point.  Per-device SSN monotonicity
makes the per-segment decision exact, and only prefixes are ever dropped,
so the retained log is always a contiguous suffix.

:class:`ShardedLogTruncator` adds the cross-shard refinement: a segment
holding ``FLAG_XSHARD`` records is droppable only if every participant
record of every such transaction is itself checkpoint-covered on its own
shard (``ssn_q <= safe_q`` for all participants q).  Otherwise dropping
this shard's copy would break recovery's durable-on-all-participants cut
and discard the surviving participants' records of a *committed*
transaction that only their logs still carry.  Candidate segments are
decoded once (cold data, about to be deleted) to find their x-records.

**Command-dep pin (adaptive logging).**  A retained ``FLAG_COMMAND``
record re-executes at recovery against its observed pre-image SSN; if the
pre-image is neither in the retained log nor covered by the checkpoint
image, recovery refuses the record (``command-dep-unreplayable``).  Both
truncators therefore refuse to drop any segment that may still hold the
pre-image of a retained command record: the pass scans the segments it is
*keeping* for command deps above the checkpoint RSN (deps at or below the
RSN are image-covered) and pins the droppable prefix below the smallest
such dep.  Under the adaptive policy's own framing rule this floor can
never bite — a dep above the RSN lives above the safe point and is
retained by the plain rule already — so it is a belt-and-suspenders
invariant against foreign or hand-built logs and stale safe points, at the
cost of decoding the retained suffix once per pass.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .checkpoint import load_latest_checkpoint_meta
from .txn import decode_columnar
from ..obs.metrics import REGISTRY


class FrontierRegistry:
    """Live log consumers, by name, each reporting an SSN frontier.

    A consumer's frontier F means "every record with ``ssn <= F`` has been
    consumed" (shipped, applied, tailed).  The truncator never drops a
    segment above ``min`` over registered frontiers, so a *registered*
    consumer never observes a hole; unregistered/lagging consumers rely on
    checkpoint re-basing instead.
    """

    def __init__(self):
        self._fns: Dict[str, Callable[[], int]] = {}
        self._lock = threading.Lock()

    def register(self, name: str, frontier_fn: Callable[[], int]) -> None:
        with self._lock:
            self._fns[name] = frontier_fn

    def unregister(self, name: str) -> None:
        with self._lock:
            self._fns.pop(name, None)

    def register_replica(self, name: str, replica) -> None:
        """A :class:`~repro_torch.replica.replica.Replica`: consumed through the
        min over its per-device shipped frontiers."""
        self.register(
            name,
            lambda: min(f) if (f := replica.shipped_frontiers()) else 0,
        )

    def register_journal(self, name: str, tails) -> None:
        """A :class:`~repro_torch.journal.restore.JournalTails` incremental tailer."""
        self.register(name, tails.min_frontier)

    def frontiers(self) -> Dict[str, int]:
        with self._lock:
            fns = dict(self._fns)
        return {name: fn() for name, fn in fns.items()}

    def min_frontier(self) -> Optional[int]:
        """min over registered consumers' frontiers; None when none are
        registered (no consumer cap)."""
        f = self.frontiers()
        return min(f.values()) if f else None


def retained_command_dep_floor(
    devices, safe: Optional[int], ckpt_rsn: int
) -> Optional[int]:
    """Smallest command-record dep SSN above ``ckpt_rsn`` among the records
    a pass at ``safe`` would *retain* (sealed segments above the safe point
    plus the unsealed tail), or None when no retained command depends on
    log-covered state.  Dropping any segment that may hold a record at or
    above this SSN could strand a retained command's pre-image — see the
    command-dep pin in the module docstring."""
    floor: Optional[int] = None
    for dev in devices:
        if not hasattr(dev, "read_segment_blobs"):
            continue
        segs = dev.segments() if hasattr(dev, "segments") else []
        for i, blob in enumerate(dev.read_segment_blobs()):
            # blobs beyond the sealed metadata (the tail, or a chain that
            # grew mid-pass) are always retained — scan them
            if i < len(segs) and safe is not None and segs[i][2] <= safe:
                continue                     # droppable: goes with its deps
            if not blob:
                continue
            log = decode_columnar(blob)
            if log.cmd_dep_ssn is None or not len(log.cmd_dep_ssn):
                continue
            deps = log.cmd_dep_ssn[log.cmd_dep_ssn > ckpt_rsn]
            if len(deps):
                m = int(deps.min())
                floor = m if floor is None else min(floor, m)
    return floor


def _keep_from_floor(dev, floor: Optional[int]) -> Optional[int]:
    """First sealed-segment index of ``dev`` that may contain a record at
    ``floor`` or above (per-device SSN monotonicity: a segment whose
    ``last_ssn`` is below the floor cannot hold the dep)."""
    if floor is None:
        return None
    for i, (_, _, last_ssn) in enumerate(dev.segments()):
        if last_ssn >= floor:
            return i
    return None


@dataclass
class TruncationStats:
    """Outcome of one truncation pass."""

    epoch: Optional[int] = None       # checkpoint epoch anchoring the pass
    safe_ssn: int = 0                 # the computed safe point (0 = no-op)
    segments_sealed: int = 0
    segments_dropped: int = 0
    bytes_dropped: int = 0
    per_device: List[Dict[str, int]] = field(default_factory=list)


class LogTruncator:
    """Checkpoint-anchored truncation daemon for one Poplar engine.

    Stepped (:meth:`run_once` after each checkpoint) or threaded
    (:meth:`start` polls the checkpoint directory and runs a pass whenever a
    new epoch publishes), like the engines.
    """

    def __init__(
        self,
        engine,
        checkpoint_dir: str,
        registry: Optional[FrontierRegistry] = None,
        min_seal_bytes: int = 1,
    ):
        self.engine = engine
        self.checkpoint_dir = checkpoint_dir
        self.registry = registry or FrontierRegistry()
        self.min_seal_bytes = max(1, min_seal_bytes)
        self.last_epoch: Optional[int] = None
        self.total_bytes_dropped = 0
        self._last_safe = -1       # safe point of the last pass (threaded mode)
        self._safe_advance_t = time.monotonic()  # last time the safe point rose
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # --- safe point --------------------------------------------------------
    def _anchor(self) -> Optional[Tuple[int, int, int]]:
        """``(checkpoint epoch, safe SSN, checkpoint RSN)`` — the one place
        the safe-point rule lives: the newest checkpoint's RSN, capped by
        the registered consumers' min frontier.  None without a checkpoint.
        ``safe < RSN`` means a consumer frontier is pinning the safe point
        below what the checkpoint alone would allow (a truncation stall)."""
        meta = load_latest_checkpoint_meta(self.checkpoint_dir)
        if meta is None:
            return None
        rsn = int(meta["rsn"])
        safe = rsn
        cap = self.registry.min_frontier()
        if cap is not None:
            safe = min(safe, cap)
        return int(meta["epoch"]), safe, rsn

    def safe_ssn(self) -> Optional[int]:
        """The current safe truncation SSN, or None without a checkpoint."""
        a = self._anchor()
        return None if a is None else a[1]

    def stall_ssn(self) -> int:
        """How far a consumer frontier pins the safe point below the
        checkpoint RSN (0 = no stall / no checkpoint).  The health monitor's
        truncation-stall signal."""
        a = self._anchor()
        return 0 if a is None else a[2] - a[1]

    # --- one pass ----------------------------------------------------------
    def _seal_all(self, stats: TruncationStats) -> None:
        """Seal every device's flushed tail at a consistent (bytes, DSN)
        point: the buffer flush lock keeps ``flush_ready`` from landing new
        records between reading the DSN and renaming the tail."""
        for buf, dev in zip(self.engine.buffers, self.engine.devices):
            with buf.flush_lock:
                if dev.tail_bytes() < self.min_seal_bytes:
                    continue
                if dev.seal(buf.dsn) is not None:
                    stats.segments_sealed += 1

    def run_once(self) -> TruncationStats:
        stats = TruncationStats()
        anchor = self._anchor()
        if anchor is None:
            return stats
        stats.epoch, stats.safe_ssn, ckpt_rsn = anchor
        safe = stats.safe_ssn
        self._seal_all(stats)
        floor = retained_command_dep_floor(self.engine.devices, safe, ckpt_rsn)
        if floor is not None and REGISTRY.enabled:
            REGISTRY.count("truncate.cmd_dep_pins")
        for dev in self.engine.devices:
            n, b = dev.truncate_to_ssn(
                safe, keep_from=_keep_from_floor(dev, floor)
            )
            stats.segments_dropped += n
            stats.bytes_dropped += b
            stats.per_device.append({"segments": n, "bytes": b})
        self.last_epoch = stats.epoch
        if stats.safe_ssn > self._last_safe:
            self._safe_advance_t = time.monotonic()
        self._last_safe = stats.safe_ssn
        self.total_bytes_dropped += stats.bytes_dropped
        if REGISTRY.enabled:
            REGISTRY.count("truncate.bytes_reclaimed", stats.bytes_dropped)
            REGISTRY.count("truncate.segments_dropped", stats.segments_dropped)
            REGISTRY.gauge_set("truncate.safe_ssn", float(safe))
            REGISTRY.gauge_set("truncate.pin_ssn", float(ckpt_rsn - safe))
            REGISTRY.gauge_set("truncate.safe_point_age_s",
                               time.monotonic() - self._safe_advance_t)
            if ckpt_rsn > safe:
                REGISTRY.count("truncate.stalled_passes")
        return stats

    # --- continuous operation ----------------------------------------------
    def start(self, poll_interval: float = 50e-3) -> None:
        """Run a pass whenever a new checkpoint epoch publishes — or, with
        registered consumers, whenever the consumer-capped safe point has
        risen past the last pass (a lagging consumer caps a pass below the
        checkpoint RSN; the retained segments become droppable as soon as
        it catches up, without any new checkpoint)."""
        self._stop.clear()

        def _loop() -> None:
            while not self._stop.is_set():
                a = self._anchor()
                if a is not None and (
                    a[0] != self.last_epoch or a[1] > self._last_safe
                ):
                    self.run_once()
                time.sleep(poll_interval)

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="log-truncator")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None


class ShardedLogTruncator:
    """Per-shard truncation with the cross-shard coverage check.

    ``checkpoint_dirs`` aligns with the engine's shard order;  a shard
    without a checkpoint directory (or without a published checkpoint) is
    never truncated, and cross-shard records depending on it pin their
    segments everywhere.  ``registries`` optionally caps each shard's safe
    point with its live consumers (e.g. a ``ShardedReplica``'s per-shard
    shippers).
    """

    def __init__(
        self,
        engine,
        checkpoint_dirs: Sequence[Optional[str]],
        registries: Optional[Sequence[Optional[FrontierRegistry]]] = None,
    ):
        self.engine = engine
        self.checkpoint_dirs = list(checkpoint_dirs)
        assert len(self.checkpoint_dirs) == len(engine.shards)
        self.registries = list(registries) if registries is not None else [
            None
        ] * len(engine.shards)
        self.total_bytes_dropped = 0

    def _safe_points(self) -> List[Optional[int]]:
        out: List[Optional[int]] = []
        for d, reg in zip(self.checkpoint_dirs, self.registries):
            meta = load_latest_checkpoint_meta(d) if d is not None else None
            if meta is None:
                out.append(None)
                continue
            safe = int(meta["rsn"])
            cap = reg.min_frontier() if reg is not None else None
            if cap is not None:
                safe = min(safe, cap)
            out.append(safe)
        return out

    def _droppable_prefix(self, dev, safe: List[Optional[int]],
                          p: int) -> int:
        """Index of the first sealed segment of shard ``p``'s device ``dev``
        that must be kept because of an uncovered cross-shard record.

        Only candidate segments — the droppable prefix at or below the safe
        point — are read and decoded (lazily, one at a time): a pass never
        touches the retained remainder or the tail, so its IO is bounded by
        what it is about to delete.
        """
        segs = dev.segments()
        for i, (_, _, last_ssn) in enumerate(segs):
            if safe[p] is None or last_ssn > safe[p]:
                return i                          # plain rule stops here anyway
            blob = dev.read_sealed_blob(i)
            if blob is None:
                return i
            log = decode_columnar(blob)
            if log.x_rec is None:
                continue
            for j in range(len(log.x_rec)):
                lo, hi = int(log.xp_start[j]), int(log.xp_start[j + 1])
                for q, sq in zip(log.xp_shard[lo:hi].tolist(),
                                 log.xp_ssn[lo:hi].tolist()):
                    if safe[q] is None or sq > safe[q]:
                        return i
        return len(segs)

    def run_once(self) -> List[TruncationStats]:
        safe = self._safe_points()
        out: List[TruncationStats] = []
        for p, sh in enumerate(self.engine.shards):
            stats = TruncationStats(safe_ssn=safe[p] or 0)
            if safe[p] is not None:
                meta = load_latest_checkpoint_meta(self.checkpoint_dirs[p])
                stats.epoch = int(meta["epoch"]) if meta else None
                rsn_p = int(meta["rsn"]) if meta else 0
                for buf, dev in zip(sh.engine.buffers, sh.engine.devices):
                    with buf.flush_lock:
                        if dev.seal(buf.dsn) is not None:
                            stats.segments_sealed += 1
                # command deps are shard-local (the policy value-frames
                # cross-shard records), so the pin floor is per shard
                floor = retained_command_dep_floor(
                    sh.engine.devices, safe[p], rsn_p
                )
                for dev in sh.engine.devices:
                    keep_from = self._droppable_prefix(dev, safe, p)
                    kf_cmd = _keep_from_floor(dev, floor)
                    if kf_cmd is not None:
                        keep_from = min(keep_from, kf_cmd)
                    n, b = dev.truncate_to_ssn(safe[p], keep_from=keep_from)
                    stats.segments_dropped += n
                    stats.bytes_dropped += b
                    stats.per_device.append({"segments": n, "bytes": b})
                self.total_bytes_dropped += stats.bytes_dropped
            out.append(stats)
        return out
