"""Sharded crash recovery (paper §5, applied per shard + per cross edge).

Each shard recovers with the existing vectorized last-writer-wins replay
over its own devices (its SSN space is self-contained), with one addition —
a **consistent cut** over cross-shard transactions:

* every participant of a cross-shard transaction logged a record carrying
  the full ``[(shard, ssn)]`` dependency vector (``FLAG_XSHARD``), so each
  shard's log names the complete participant set;
* a cross-shard transaction is replayed **iff** a record with its gtid is
  durable on *all* participants, and — when it has reads — its per-shard
  SSN clears every participant's RSNe (``ssn_p <= RSNe_p``), the Qwr rule
  evaluated shard-locally on every edge.

Soundness mirrors §3.1/§5 per edge: an *acknowledged* cross-shard commit
required ``ssn_p <= DSN/CSN_p`` on every participant, and per-buffer SSNs
are monotone in flush order, so its records all survive the cut.
Conversely a transaction dropped by the cut was never acknowledged — and
because the forward path defers cross-shard write visibility to global
commit, nothing can have read its writes, so dropping it cascades nowhere.
Replayed RAW edges stay closed: any read predecessor has a tuple SSN below
the shared base, hence below the reader's per-shard SSN, hence durable (and
itself replayed) on its own shard.

Per-shard fuzzy checkpoints plug in unchanged: pass one checkpoint
directory per shard and each shard's image joins its replay reduction.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core.checkpoint import load_latest_checkpoint
from ..core.par import parallel_for
from ..core.recovery import (
    RecoveredState,
    RecoveryReport,
    _replay_scalar,
    compute_rsne,
    device_ssn_floors,
    load_columnar_segmented,
    replay_columnar,
)
from ..core.storage import StorageDevice
from ..core.txn import ColumnarLog, LogRecord, decode_records
from ..kernels.ops import kernel_device

# (participant vector, has_reads) of one cross-shard transaction
_XInfo = Tuple[List[Tuple[int, int]], bool]


@dataclass
class ShardedRecoveredState:
    """Per-shard recovered images + the cross-shard cut statistics."""

    shards: List[RecoveredState] = field(default_factory=list)
    n_cross_seen: int = 0        # distinct gtids observed in any log
    n_cross_dropped: int = 0     # gtids dropped by the consistent cut

    def report_dict(self) -> Dict:
        """Aggregate of the per-shard :class:`RecoveryReport`s plus the
        cut statistics (the sharded counterpart of ``state.report``)."""
        return {
            "n_shards": len(self.shards),
            "n_cross_seen": self.n_cross_seen,
            "n_cross_dropped": self.n_cross_dropped,
            "shards": [
                st.report.to_dict() if st.report is not None else None
                for st in self.shards
            ],
        }

    @property
    def data(self) -> Dict[bytes, Tuple[bytes, int]]:
        """Merged image (keys are disjoint across shards by routing)."""
        out: Dict[bytes, Tuple[bytes, int]] = {}
        for st in self.shards:
            out.update(st.data)
        return out

    def get(self, key: bytes) -> Optional[bytes]:
        for st in self.shards:
            v = st.data.get(key)
            if v is not None:
                return v[0]
        return None


def _collect_cut_columnar(
    shard_logs: Sequence[Sequence[ColumnarLog]],
) -> Tuple[Dict[int, Set[int]], Dict[int, _XInfo]]:
    durable: Dict[int, Set[int]] = {}
    info: Dict[int, _XInfo] = {}
    for p, logs in enumerate(shard_logs):
        for log in logs:
            if log.x_rec is None:
                continue
            for i, rec in enumerate(log.x_rec.tolist()):
                g = int(log.tid[rec])
                durable.setdefault(g, set()).add(p)
                if g not in info:
                    lo, hi = int(log.xp_start[i]), int(log.xp_start[i + 1])
                    info[g] = (
                        list(zip(log.xp_shard[lo:hi].tolist(),
                                 log.xp_ssn[lo:hi].tolist())),
                        bool(log.has_reads[rec]),
                    )
    return durable, info


def resolve_cut(
    durable: Dict[int, Set[int]],
    info: Dict[int, _XInfo],
    rsne: Sequence[int],
) -> Dict[int, bool]:
    """Per-gtid replay decision: durable on all participants, and (for
    RAW-carrying transactions) ``ssn_p <= RSNe_p`` on every participant."""
    keep: Dict[int, bool] = {}
    for g, (parts, has_reads) in info.items():
        ok = all(q in durable.get(g, ()) for q, _ in parts)
        if ok and has_reads:
            ok = all(s <= rsne[q] for q, s in parts)
        keep[g] = ok
    return keep


def _cut_masks(
    shard_logs: Sequence[Sequence[ColumnarLog]], keep: Dict[int, bool]
) -> List[List[Optional[np.ndarray]]]:
    """Per-log boolean record masks encoding the cut (None = no x records)."""
    masks: List[List[Optional[np.ndarray]]] = []
    for logs in shard_logs:
        row: List[Optional[np.ndarray]] = []
        for log in logs:
            if log.x_rec is None:
                row.append(None)
                continue
            m = np.ones(log.n_records, dtype=bool)
            for rec in log.x_rec.tolist():
                m[rec] = keep[int(log.tid[rec])]
            row.append(m)
        masks.append(row)
    return masks


def recover_sharded(
    shard_devices: Sequence[Sequence[StorageDevice]],
    checkpoint_dirs: Optional[Sequence[Optional[str]]] = None,
    parallel: bool = True,
    mode: str = "kernel",
    device="cuda",
) -> ShardedRecoveredState:
    """Restore every shard from its devices (+ optional per-shard fuzzy
    checkpoints), resolving cross-shard transactions against the cut.

    ``shard_devices[p]`` must be shard ``p``'s device list in the same shard
    order the engine ran with (the xdep shard ids index into it).  ``mode``
    is the per-shard replay engine: ``kernel`` (default: the scatter-max
    kernel apply on ``device``), ``vectorized`` (numpy), or ``scalar`` (the
    per-record oracle).  Kernel mode on ``device="cuda"`` raises when no
    CUDA device is present; ``device="cpu"`` runs the kernel's plain
    PyTorch version.
    """
    if mode not in ("vectorized", "kernel", "scalar"):
        raise ValueError(f"unknown recovery mode {mode!r}")
    dev = kernel_device(device) if mode == "kernel" else None
    n = len(shard_devices)
    if checkpoint_dirs is not None:
        assert len(checkpoint_dirs) == n

    if mode == "scalar":
        return _recover_sharded_scalar(shard_devices, checkpoint_dirs, parallel)

    # stage 1: decode every shard's logs (shards in parallel, like the
    # single-engine path parallelizes over devices; within a shard the
    # decode is per (device, sealed segment) — see load_columnar_segmented)
    shard_logs: List[List[ColumnarLog]] = [None] * n  # type: ignore[list-item]
    seg_rows: List[List[Dict]] = [[] for _ in range(n)]

    import time as _time

    decode_s = [0.0] * n

    def _load(p: int) -> None:
        t0 = _time.perf_counter()
        shard_logs[p] = load_columnar_segmented(
            shard_devices[p], parallel=False, segments=seg_rows[p]
        )
        decode_s[p] = _time.perf_counter() - t0

    parallel_for(n, _load, parallel)

    rsne = [
        compute_rsne(logs, floors=device_ssn_floors(shard_devices[p]))
        for p, logs in enumerate(shard_logs)
    ]

    # stage 2: the consistent cut over cross-shard records
    durable, info = _collect_cut_columnar(shard_logs)
    keep = resolve_cut(durable, info, rsne)
    masks = _cut_masks(shard_logs, keep)

    # stage 3: per-shard vectorized replay under the cut
    out = ShardedRecoveredState(
        n_cross_seen=len(info),
        n_cross_dropped=sum(1 for v in keep.values() if not v),
    )
    for p in range(n):
        st = RecoveredState(rsne=rsne[p])
        n_ckpt_keys = 0
        if checkpoint_dirs is not None and checkpoint_dirs[p] is not None:
            ckpt = load_latest_checkpoint(checkpoint_dirs[p], parallel=parallel)
            if ckpt is not None:
                st.rsns = ckpt.rsn
                st.data.update(ckpt.data)
                n_ckpt_keys = len(ckpt.data)
        t_rep = _time.perf_counter()
        data, n_replayed, n_skipped = replay_columnar(
            shard_logs[p],
            rsne[p],
            base=st.data or None,
            use_kernel=(mode == "kernel"),
            device=dev,
            record_mask=masks[p],
        )
        st.data = data
        st.n_replayed = n_replayed
        st.n_skipped_uncommitted = n_skipped
        # the cut's drops land in n_skipped along with the local Qwr rule's;
        # split them back out for the report by re-counting the cut mask
        n_cut_dropped = sum(
            int((~m[log.x_rec]).sum())
            for log, m in zip(shard_logs[p], masks[p])
            if m is not None and log.x_rec is not None
        )
        st.report = RecoveryReport(
            mode=mode,
            n_devices=len(shard_devices[p]),
            rsns=st.rsns,
            rsne=rsne[p],
            n_decoded=sum(lg.n_records for lg in shard_logs[p]),
            n_replayed=n_replayed,
            n_dropped_above_rsne=n_skipped - n_cut_dropped,
            n_dropped_not_durable_all=n_cut_dropped,
            checkpoint_keys=n_ckpt_keys,
            decode_s=decode_s[p],
            replay_s=_time.perf_counter() - t_rep,
            segments=seg_rows[p],
        )
        out.shards.append(st)
    return out


def _recover_sharded_scalar(
    shard_devices: Sequence[Sequence[StorageDevice]],
    checkpoint_dirs: Optional[Sequence[Optional[str]]],
    parallel: bool,
) -> ShardedRecoveredState:
    """Per-record oracle twin of the vectorized path (recovery's
    ``mode="scalar"`` pattern): row-decoded logs, the same cut, guarded
    dict replay."""
    n = len(shard_devices)
    shard_recs: List[List[List[LogRecord]]] = [
        [decode_records(d.read_all()) for d in shard_devices[p]] for p in range(n)
    ]
    rsne = [
        compute_rsne(recs, floors=device_ssn_floors(shard_devices[p]))
        for p, recs in enumerate(shard_recs)
    ]

    durable: Dict[int, Set[int]] = {}
    info: Dict[int, _XInfo] = {}
    for p in range(n):
        for recs in shard_recs[p]:
            for r in recs:
                if r.xdep is None:
                    continue
                durable.setdefault(r.tid, set()).add(p)
                info.setdefault(r.tid, (list(r.xdep), r.has_reads))
    keep = resolve_cut(durable, info, rsne)

    out = ShardedRecoveredState(
        n_cross_seen=len(info),
        n_cross_dropped=sum(1 for v in keep.values() if not v),
    )
    for p in range(n):
        st = RecoveredState(rsne=rsne[p])
        if checkpoint_dirs is not None and checkpoint_dirs[p] is not None:
            ckpt = load_latest_checkpoint(checkpoint_dirs[p], parallel=parallel)
            if ckpt is not None:
                st.rsns = ckpt.rsn
                st.data.update(ckpt.data)
        kept = [
            [r for r in recs if r.xdep is None or keep[r.tid]]
            for recs in shard_recs[p]
        ]
        dropped = sum(len(a) - len(b) for a, b in zip(shard_recs[p], kept))
        _replay_scalar(st, kept, rsne[p], parallel)
        st.n_skipped_uncommitted += dropped
        out.shards.append(st)
    return out
