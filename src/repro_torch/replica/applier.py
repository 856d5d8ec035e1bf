"""Continuous vectorized apply — folding shipped log chunks into a live
:class:`~repro_torch.db.array_table.ArrayTable`.

The applier is incremental crash recovery: every poll it runs the *same*
batched last-writer-wins reduction recovery uses
(:func:`~repro_torch.core.recovery.replay_columnar`) over the not-yet-applied
shipped records, then folds the per-key winners into the table under the
per-key SSN high-water mark the table already carries (its ``ssn`` column —
a log write lands iff its SSN strictly exceeds the row's).  The carried
high-water mark is what makes incremental application exactly equal to a
one-shot replay of the whole log: re-applying a record is a no-op (strict
``>`` guard), and chunk arrival order cannot matter because order was never
encoded in the log to begin with.

Which records apply when is the paper's §5 commit guard evaluated against
the *shipped* watermark instead of the crash-time RSNe:

* write-only (Qww) records apply as soon as shipped — durable on their own
  device implies committed on the primary;
* HAS_READS (Qwr) records apply only once ``ssn <= watermark`` (the shipped
  RSNe): only then is every RAW predecessor — smaller SSN, durable in
  whichever device holds it — guaranteed shipped and applied.  Until then
  the record is **held**, so a replica read can never observe a transaction
  whose RAW predecessor is missing.

Held records stay in their decoded chunk; the chunk is re-offered to the
reduction on each poll (already-applied records masked out) and dropped
once fully applied.  An optional per-chunk ``gate`` mask injects the
cross-shard cut (`repro_torch.replica.sharded`), exactly like recovery's
``record_mask``.

Three modes, kept equivalent (property-tested): ``kernel`` (the default:
the scatter-max kernel apply inside ``replay_columnar``, on ``device``),
``vectorized`` (numpy reduction), ``scalar`` (the per-record guarded walk,
the oracle).  Kernel mode on ``device="cuda"`` raises when no CUDA device
is present; ``device="cpu"`` runs the kernel's plain PyTorch version.  The
kernel launches on the applying thread's current CUDA stream.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np

import time

from ..core.recovery import committed_mask, replay_columnar
from ..core.txn import ColumnarLog
from ..db.array_table import ArrayTable
from ..kernels.ops import kernel_device
from ..trace.span import ST_APPLY, TRACER

# per-chunk gate: None = no extra gating, else a bool mask over the chunk's
# records (the sharded cut predicate, re-evaluated as frontiers advance).
# For cross-shard (x_rec) records the gate is *authoritative* — it already
# evaluates the §5 guard per participant edge, so the applier does not also
# apply the local watermark to them.
GateFn = Callable[[ColumnarLog], Optional[np.ndarray]]

# sentinel RSNe passed to replay_columnar once the §5 guard has already been
# folded into the record mask (far above any real SSN)
_NO_GUARD = 1 << 62


@dataclass
class _Chunk:
    log: ColumnarLog
    applied: np.ndarray = field(default=None)  # type: ignore[assignment]

    def __post_init__(self):
        if self.applied is None:
            self.applied = np.zeros(self.log.n_records, dtype=bool)


class ReplicaApplier:
    """Folds shipped chunks into ``table`` with a carried SSN high-water mark."""

    def __init__(self, table: ArrayTable, mode: str = "kernel", device="cuda"):
        if mode not in ("vectorized", "kernel", "scalar"):
            raise ValueError(f"unknown apply mode {mode!r}")
        self.table = table
        self.mode = mode
        self.device = kernel_device(device) if mode == "kernel" else None
        self.pending: List[_Chunk] = []
        self.n_applied = 0
        self.n_rounds = 0
        # telemetry for the RAW-safety invariant: the largest HAS_READS SSN
        # ever applied — never exceeds the watermark it was applied under,
        # except for gate-decided cross-shard records, whose RAW safety is
        # established per participant edge by the sharded cut instead
        self.max_qwr_applied = 0
        # shard id stamped on trace spans (set by the sharded replica)
        self.trace_shard = 0

    def held(self) -> int:
        """Shipped-but-unapplied records (beyond the watermark / gated out)."""
        return sum(int((~c.applied).sum()) for c in self.pending)

    def prune_below(self, ssn: int) -> int:
        """Mark every pending record with ``log.ssn <= ssn`` applied without
        folding it — the truncation-rebase path, where a freshly seeded
        checkpoint image already reflects those records (the safe-point rule
        bounds every truncated record by the checkpoint RSN, and the image
        wins the per-key SSN guard against them).  Returns records pruned.
        """
        n = 0
        for c in self.pending:
            m = ~c.applied & (c.log.ssn <= ssn)
            k = int(m.sum())
            if k:
                c.applied |= m
                n += k
        self.pending = [c for c in self.pending if not c.applied.all()]
        self.n_applied += n
        return n

    def pending_x_min_ssn(self) -> Optional[int]:
        """Smallest SSN of an unapplied cross-shard record, or None.

        The sharded replica caps its per-shard apply watermark here: a Qwr
        record must not become visible past an undecided cross-shard record
        below it (its RAW predecessor may be exactly that record, committed
        on the primary but not yet shipped on every participant).
        """
        lo: Optional[int] = None
        for c in self.pending:
            if c.log.x_rec is None:
                continue
            un = c.log.x_rec[~c.applied[c.log.x_rec]]
            if len(un):
                m = int(c.log.ssn[un].min())
                lo = m if lo is None else min(lo, m)
        return lo

    def apply(
        self,
        new_logs: Sequence[Optional[ColumnarLog]],
        watermark: int,
        gate: Optional[GateFn] = None,
    ) -> int:
        """One apply round: enqueue ``new_logs`` chunks, apply everything the
        §5 guard (at ``watermark``) and ``gate`` admit, hold the rest.
        Returns the number of records newly applied."""
        self.n_rounds += 1
        _trace = TRACER.enabled
        if _trace:
            _t0 = time.perf_counter()
        for log in new_logs:
            if log is not None and log.n_records:
                self.pending.append(_Chunk(log))
        if not self.pending:
            return 0

        # per-chunk decision mask: §5 guard & not-yet-applied & gate
        oks: List[np.ndarray] = []
        any_ok = False
        for c in self.pending:
            ok = committed_mask(c.log, watermark) & ~c.applied
            if gate is not None:
                g = gate(c.log)
                if g is not None:
                    ok &= g
                    if c.log.x_rec is not None:
                        # the gate's per-edge cut rule fully decides
                        # cross-shard records (it subsumes the local §5
                        # guard on every participant incl. this one); the
                        # local watermark — capped below the oldest
                        # undecided x-record, possibly this very record —
                        # must not re-block one the cut has admitted
                        x = c.log.x_rec
                        ok[x] = g[x] & ~c.applied[x]
            oks.append(ok)
            any_ok = any_ok or bool(ok.any())

        if any_ok:
            if self.mode == "scalar":
                self._apply_scalar(oks)
            else:
                self._apply_vectorized(oks)

        newly = 0
        for c, ok in zip(self.pending, oks):
            n_ok = int(ok.sum())
            if n_ok:
                qwr = c.log.has_reads & ok
                if qwr.any():
                    self.max_qwr_applied = max(
                        self.max_qwr_applied, int(c.log.ssn[qwr].max())
                    )
                c.applied |= ok
                newly += n_ok
        self.pending = [c for c in self.pending if not c.applied.all()]
        self.n_applied += newly
        if _trace and newly:
            TRACER.record(
                ST_APPLY, shard=self.trace_shard, t0=_t0,
                t1=time.perf_counter(), n_txn=newly, aux=watermark,
            )
        return newly

    def _table_lookup(self, key: bytes):
        """Pre-image resolver for command records (adaptive logging): a
        command's dependency may have been folded in an earlier poll — then
        its pre-image is no longer in any pending chunk but lives in the
        table row, whose carried SSN high-water mark is exactly the dep SSN
        the record observed on the primary."""
        return self.table.get(key.decode("utf-8", "surrogateescape"))

    # --- vectorized / kernel -------------------------------------------------
    def _apply_vectorized(self, oks: List[np.ndarray]) -> None:
        logs = [c.log for c in self.pending]
        # all §5/gate gating already lives in ``oks`` (computed in apply());
        # neutralize replay's internal guard so it cannot re-block a
        # cross-shard record the cut admitted past the capped watermark
        data, _, _ = replay_columnar(
            logs,
            _NO_GUARD,
            base=None,
            use_kernel=(self.mode == "kernel"),
            device=self.device,
            record_mask=oks,
            dep_lookup=self._table_lookup,
        )
        if not data:
            return
        ssns = np.fromiter((s for _, s in data.values()), np.int64, len(data))
        vals = np.fromiter((v for v, _ in data.values()), object, len(data))
        # one atomic fold: the whole round's winners become visible together
        self.table.upsert_bytes(list(data.keys()), vals, ssns)

    # --- scalar oracle -------------------------------------------------------
    def _apply_scalar(self, oks: List[np.ndarray]) -> None:
        """Per-write guarded walk.  Equivalence oracle only: each write
        folds under its own mutex hold (no phantom/torn rows, but a round
        is not visibility-atomic the way the vectorized fold is), so live
        serving should use the default modes.

        Command writes (adaptive logging) cannot fold order-free: each needs
        its key's pre-image.  They are collected across the round's chunks
        and re-executed after the value walk in SSN order — by then every
        value pre-image of the round has landed, so the table row *is* the
        dependency (same shape as recovery's deferred command pass)."""
        table = self.table
        one_val = np.empty(1, dtype=object)
        cmds: List[tuple] = []   # (ssn, key, op_id, dep_ssn, param)
        for c, ok in zip(self.pending, oks):
            log = c.log
            if not len(log.wr_rec):
                continue
            lanes = np.flatnonzero(ok[log.wr_rec]).tolist()
            if log.n_command:
                from ..core.recovery import _command_dep_per_write
                wcmd = log.cmd_mask[log.wr_rec]
                dep_w = _command_dep_per_write(log) if wcmd.any() else None
                op_w = log.cmd_op_col[log.wr_rec]
            else:
                wcmd = None
            for j in lanes:
                if wcmd is not None and wcmd[j]:
                    cmds.append((
                        int(log.ssn[log.wr_rec[j]]), log.keys[j],
                        int(op_w[j]), int(dep_w[j]), log.values[j],
                    ))
                    continue
                one_val[0] = log.values[j]
                table.upsert_bytes(
                    [log.keys[j]], one_val,
                    np.asarray([log.ssn[log.wr_rec[j]]], dtype=np.int64),
                )
        if cmds:
            from ..core.command import COMMANDS
            from ..core.recovery import _exec_command_write
            cmds.sort(key=lambda t: t[0])
            staged: dict = {}
            for ssn, key, op_id, dep, param in cmds:
                _exec_command_write(
                    staged, key, ssn, op_id, dep, param, COMMANDS,
                    self._table_lookup,
                )
            for key, (val, ssn) in staged.items():
                one_val[0] = val
                table.upsert_bytes(
                    [key], one_val, np.asarray([ssn], dtype=np.int64)
                )
