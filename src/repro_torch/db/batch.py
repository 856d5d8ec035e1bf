"""Batched array-native OCC + SSN allocation (paper §4.2/§4.4, batched).

The scalar forward path (`repro.db.occ.OCCWorker`) runs one transaction at a
time: per-tuple ``threading.Lock`` round-trips for validation, one buffer
latch acquisition per SSN allocation, one ``Txn.encode()`` per record.
Poplar's own argument — only RAW/WAW dependencies constrain ordering — means
a whole *batch* of transactions can be validated, sequenced, encoded, and
published with array ops instead.  This module is that pipeline:

1. **flatten** — the batch's read/write keys are mapped onto
   :class:`~repro.db.array_table.ArrayTable` rows once (``rows_for``),
   producing transaction-major access arrays reused across retry rounds;
2. **validate** (per round) — intra-batch WW and RW conflicts reduce to one
   segmented *min* over write positions per tuple row: a transaction
   survives iff every tuple it touches has ``first_writer_pos >= its own
   batch position`` (first-come-wins; losers are retried next round or
   returned as aborted).  Driver-observed SSNs (read-modify-write
   workloads) are validated with one vectorized compare against the
   current ``table.ssn`` column; foreign write locks with one gather of
   ``table.lock_owner``;
3. **sequence** — per-transaction base SSNs are one segmented *max* over
   tuple SSNs (Algorithm 1 lines 1–4, ``ssn.base_ssn_batch``), then each
   buffer's winners take SSNs + slots through a single
   :meth:`~repro.core.log_buffer.LogBuffer.reserve_batch` latch
   acquisition (closed-form ``max``-chain + prefix-summed offsets);
4. **publish** — winning records are encoded into one contiguous blob
   (``core.txn.encode_batch``, byte-identical to per-record
   ``Txn.encode``) and land in the ring via one
   :meth:`~repro.core.engine.PoplarEngine.publish_batch` memcpy; tuple
   values/SSNs write back as two scatters.

With ``mode="kernel"`` steps 2 and 3 fuse into ONE device pass
(:func:`repro_torch.kernels.ops.fused_validate_sequence`): the round's
access columns leave the host as a single bucket-padded int32 transfer in a
dense ``(n_txn, k)`` layout and ``(survive, bases)`` come back together —
first-writer min, the three validation masks, the survive reduction and the
base-SSN max all on the device, in one hand-written CUDA kernel.  Batches
out of profile (too small to beat the dispatch floor, pathological access
skew, values beyond int32) fall back per round to the individual segmented
reduces — the ``seg_reduce`` kernel (``kernels/batch_occ.py``) — or, past
int32, the numpy reductions, with identical results.  ``device`` names where
the kernel mode runs: ``"cuda"`` (the default) launches the kernels,
``"cpu"`` runs their plain PyTorch versions.

:class:`ScalarBatchOCC` is the correctness oracle (same pattern as
recovery's ``mode="scalar"``): identical batch semantics, executed with the
existing scalar machinery — dict :class:`~repro.db.table.Table` cells,
per-transaction ``engine.allocate``/``publish``.  The equivalence contract
(same winners, same tids, same per-tuple SSNs, byte-identical logs) is
property-tested in ``tests/test_batch_occ.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import ssn as ssn_mod
from ..core.engine import LoggingEngine
from ..core.txn import FLAG_HAS_READS, Txn, encode_batch, encode_batch_columns
from ..trace.span import (
    ST_ENCODE,
    ST_SEQUENCE,
    ST_VALIDATE,
    ST_WRITEBACK,
    TRACER,
)
from ..kernels.bucketing import bucket, fits_i32, pad_i32, stack_i32
from ..kernels.ops import kernel_device
from ..obs.metrics import REGISTRY
from .array_table import ArrayTable
from .occ import TID_STRIDE, TidStripe
from .table import Table

NO_WRITER = np.int64(np.iinfo(np.int64).max)

# framed-record overhead: header (u32 len + u32 crc) + fixed payload
# (u64 ssn + u64 tid + u8 flags + u32 n_writes); per-write u32 klen + u32 vlen
_REC_FIXED = 8 + 21
_PER_WRITE = 8


@dataclass(slots=True)
class TxnSpec:
    """One transaction intent for the batched executor.

    ``observed`` (optional, aligned with ``reads``) carries the tuple SSNs
    the driver saw when it computed the write values (read-modify-write
    workloads like TPC-C); if given, the validator aborts the transaction
    when any of them is stale.  Without it, reads are observed fresh at each
    round start.

    ``cmd_op``/``cmd_params`` (optional, params aligned with ``writes``)
    declare the *command form* of the transaction: a registered op id
    (:mod:`repro.core.command`) and the per-write parameter such that
    ``op(pre_image, param) == write value``.  They are advisory — the
    executor's :class:`~repro.core.engine.AdaptivePolicy` decides per record
    whether to log the command form or the value form; without a policy (or
    when ineligible: unregistered op, blind writes, cross-shard) the spec
    logs values exactly as before.  The params-match-values contract is the
    workload's to keep; the crash-equivalence suite pins it.
    """

    reads: Sequence[str] = ()
    writes: Sequence[Tuple[str, bytes]] = ()
    observed: Optional[Sequence[int]] = None
    cmd_op: Optional[int] = None
    cmd_params: Optional[Sequence[bytes]] = None


@dataclass
class BatchResult:
    committed: List[Txn] = field(default_factory=list)
    committed_idx: List[int] = field(default_factory=list)  # spec index per Txn
    aborted: List[int] = field(default_factory=list)        # never-won spec indices
    rounds: int = 0


def _pow2(n: int) -> int:
    """Next power of two ≥ n (≥ 1): the kernel mode pads its kernel inputs
    to power-of-two buckets so launch shapes repeat across batches/rounds
    instead of growing with every distinct size."""
    return 1 << max(n - 1, 0).bit_length()


def _pad_i32(a: np.ndarray, n: int, fill: int) -> np.ndarray:
    out = np.full(n, fill, dtype=np.int32)
    out[: len(a)] = a
    return out


def _concat_ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Indices of the concatenation of ``[starts[i], starts[i]+lens[i])``."""
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    out_starts = np.zeros(len(lens), dtype=np.int64)
    np.cumsum(lens[:-1], out=out_starts[1:])
    return np.arange(total, dtype=np.int64) + np.repeat(starts - out_starts, lens)


class _Flat:
    """The batch flattened into transaction-major access arrays (built once,
    reused across retry rounds — keys never change, only table state).

    Built either from string-keyed :class:`TxnSpec`s (:meth:`from_specs`,
    one Python pass mapping keys to rows) or directly from read-index /
    write-index arrays (:meth:`from_indexed`, fully vectorized — the form
    the ISSUE's batched validator takes)."""

    specs: Optional[Sequence[TxnSpec]]

    @classmethod
    def from_specs(
        cls, table: ArrayTable, specs: Sequence[TxnSpec], policy=None
    ) -> "_Flat":
        self = cls.__new__(cls)
        self.specs = specs
        b = len(specs)
        all_keys: List[str] = []
        wr_vals: List[bytes] = []
        obs_l: List[int] = []
        self.rd_len = np.empty(b, dtype=np.int64)
        self.wr_len = np.empty(b, dtype=np.int64)
        self.rec_len = np.empty(b, dtype=np.int64)
        # adaptive framing (decided here because the reservation lengths
        # depend on it — the drift guard in _run pins encode to these):
        # per-spec command flag, op id, (key, dep ssn) list, logged write set
        self.is_cmd = np.zeros(b, dtype=bool)
        self.cmd_op_arr = np.zeros(b, dtype=np.int64)
        self.cmd_deps: List[Optional[List[Tuple[str, int]]]] = [None] * b
        self.cmd_writes: List[Optional[List[Tuple[str, bytes]]]] = [None] * b
        for i, s in enumerate(specs):
            nr, nw = len(s.reads), len(s.writes)
            assert nr + nw > 0, f"spec {i} has no reads and no writes"
            if s.observed is not None:
                assert len(s.observed) == nr, f"spec {i}: observed/reads mismatch"
                obs_l.extend(int(o) for o in s.observed)
            else:
                obs_l.extend((-1,) * nr)
            self.rd_len[i] = nr
            self.wr_len[i] = nw
            all_keys.extend(s.reads)
            as_cmd = False
            if policy is not None and s.cmd_op is not None:
                # dep = observed pre-image SSN per written key; eligible only
                # when every write has one (the spec read what it overwrites)
                obs_map = (
                    dict(zip(s.reads, s.observed))
                    if s.observed is not None else {}
                )
                deps = [int(obs_map.get(k, -1)) for k, _ in s.writes]
                params = s.cmd_params
                as_cmd = (
                    params is not None
                    and len(params) == nw
                    and policy.eligible(s.cmd_op, deps)
                )
            rec = _REC_FIXED
            if as_cmd:
                self.is_cmd[i] = True
                self.cmd_op_arr[i] = s.cmd_op
                self.cmd_deps[i] = [
                    (k, int(d)) for (k, _), d in zip(s.writes, deps)
                ]
                self.cmd_writes[i] = [
                    (k, p) for (k, _), p in zip(s.writes, params)
                ]
                rec += 8  # command footer prefix (u32 op + u32 n_deps)
                for (k, v), p in zip(s.writes, params):
                    all_keys.append(k)
                    wr_vals.append(v)
                    klen = len(k) if k.isascii() else len(k.encode())
                    # write chain carries the param; dep entry repeats the key
                    rec += _PER_WRITE + len(p) + klen + 12 + klen
            else:
                for k, v in s.writes:
                    all_keys.append(k)
                    wr_vals.append(v)
                    # keys are str; ascii length == encoded length (fast path)
                    rec += _PER_WRITE + len(v) + (
                        len(k) if k.isascii() else len(k.encode())
                    )
            self.rec_len[i] = rec

        self.acc_len = self.rd_len + self.wr_len
        self.acc_start = np.zeros(b + 1, dtype=np.int64)
        np.cumsum(self.acc_len, out=self.acc_start[1:])
        self.acc_row = table.rows_for(all_keys)
        self.acc_txn = np.repeat(np.arange(b, dtype=np.int64), self.acc_len)
        # reads occupy the first rd_len slots of each txn's access segment
        self.acc_obs = np.full(int(self.acc_start[-1]), -1, dtype=np.int64)
        rd_idx = _concat_ranges(self.acc_start[:-1], self.rd_len)
        if obs_l:
            self.acc_obs[rd_idx] = np.asarray(obs_l, dtype=np.int64)
        self.acc_iswrite = np.ones(int(self.acc_start[-1]), dtype=bool)
        self.acc_iswrite[rd_idx] = False
        # per-txn write slices into the flat per-write value list
        self.wr_start = np.zeros(b + 1, dtype=np.int64)
        np.cumsum(self.wr_len, out=self.wr_start[1:])
        self.wr_row = self.acc_row[self.acc_iswrite]
        self.wr_vals = np.empty(len(wr_vals), dtype=object)
        self.wr_vals[:] = wr_vals
        self.wr_vlen = None
        return self

    @classmethod
    def from_indexed(
        cls,
        table: ArrayTable,
        rd_row: np.ndarray,
        rd_start: np.ndarray,
        wr_row: np.ndarray,
        wr_start: np.ndarray,
        wr_vals: Sequence[bytes],
        observed: Optional[np.ndarray] = None,
        wr_vlen: Optional[np.ndarray] = None,
    ) -> "_Flat":
        """Vectorized flatten from row-index arrays: ``rd_start``/``wr_start``
        are ``(B+1,)`` prefixes delimiting each transaction's slice of
        ``rd_row``/``wr_row``; ``observed`` (optional) aligns with
        ``rd_row``; ``wr_vlen`` (optional) skips the value-length pass."""
        self = cls.__new__(cls)
        self.specs = None
        b = len(rd_start) - 1
        # indexed batches are value-only (no specs to carry an op form)
        self.is_cmd = np.zeros(b, dtype=bool)
        self.cmd_op_arr = np.zeros(b, dtype=np.int64)
        self.cmd_deps = [None] * b
        self.cmd_writes = [None] * b
        rd_row = np.asarray(rd_row, dtype=np.int64)
        wr_row = np.asarray(wr_row, dtype=np.int64)
        self.rd_len = np.diff(np.asarray(rd_start, dtype=np.int64))
        self.wr_len = np.diff(np.asarray(wr_start, dtype=np.int64))
        assert (self.rd_len + self.wr_len > 0).all(), "empty transaction in batch"
        self.acc_len = self.rd_len + self.wr_len
        self.acc_start = np.zeros(b + 1, dtype=np.int64)
        np.cumsum(self.acc_len, out=self.acc_start[1:])
        total = int(self.acc_start[-1])
        rd_pos = _concat_ranges(self.acc_start[:-1], self.rd_len)
        wr_pos = _concat_ranges(self.acc_start[:-1] + self.rd_len, self.wr_len)
        self.acc_row = np.empty(total, dtype=np.int64)
        self.acc_row[rd_pos] = rd_row
        self.acc_row[wr_pos] = wr_row
        self.acc_txn = np.repeat(np.arange(b, dtype=np.int64), self.acc_len)
        self.acc_obs = np.full(total, -1, dtype=np.int64)
        if observed is not None:
            self.acc_obs[rd_pos] = np.asarray(observed, dtype=np.int64)
        self.acc_iswrite = np.ones(total, dtype=bool)
        self.acc_iswrite[rd_pos] = False
        self.wr_start = np.asarray(wr_start, dtype=np.int64)
        self.wr_row = wr_row
        if isinstance(wr_vals, np.ndarray) and wr_vals.dtype == object:
            self.wr_vals = wr_vals
        else:
            self.wr_vals = np.empty(len(wr_vals), dtype=object)
            self.wr_vals[:] = wr_vals
        if wr_vlen is None:
            wr_vlen = np.fromiter(map(len, wr_vals), np.int64, len(wr_vals))
        self.wr_vlen = np.asarray(wr_vlen, dtype=np.int64)
        # framed record length from the table's key-length column
        wlen = _PER_WRITE + table.key_len[wr_row] + self.wr_vlen
        wcs = np.zeros(len(wr_row) + 1, dtype=np.int64)
        np.cumsum(wlen, out=wcs[1:])
        self.rec_len = _REC_FIXED + wcs[self.wr_start[1:]] - wcs[self.wr_start[:-1]]
        return self


class BatchOCC:
    """Array-native batched OCC executor over an :class:`ArrayTable`.

    ``mode="kernel"`` (default) runs validate→sequence on ``device``
    through the fused round and the segmented-reduce kernel;
    ``mode="vectorized"`` runs the segmented reductions in numpy.  Kernel
    mode on ``device="cuda"`` raises when no CUDA device is present.  The
    engine must be a :class:`~repro_torch.core.engine.PoplarEngine` (or
    expose the same ``buffer_for``/``buffers``/``publish_batch`` surface).
    """

    def __init__(
        self,
        table: ArrayTable,
        engine: LoggingEngine,
        n_workers: int = 1,
        mode: str = "kernel",
        tid_stride: int = TID_STRIDE,
        worker_id_base: int = 0,
        policy=None,
        device="cuda",
    ):
        if mode not in ("vectorized", "kernel"):
            raise ValueError(f"unknown batch OCC mode {mode!r}")
        # where the kernel mode's device functions run (resolved up front so
        # a missing card fails here, not mid-batch)
        self.device = kernel_device(device) if mode == "kernel" else None
        self.table = table
        self.engine = engine
        self.n_workers = n_workers
        self.mode = mode
        # adaptive command/value framing policy (core.engine.AdaptivePolicy);
        # None keeps the executor pure-value, byte-compatible with old logs
        self.policy = policy
        # worker_id_base offsets this executor's worker ids and tid stripes
        # into a disjoint slice of the global spaces — the injection point
        # that lets several executors (one per shard, `repro.shard`) share
        # one tid universe without a cross-shard allocator
        self.worker_id_base = worker_id_base
        self.stripes = [
            TidStripe(worker_id_base + w, tid_stride) for w in range(n_workers)
        ]
        for w in range(n_workers):
            engine.register_worker(worker_id_base + w)
        self.committed_submitted = 0
        self.aborts = 0  # per-round validation losses (retries count, like OCCWorker)
        # shard id stamped on trace spans (worker_id_base = shard * n_workers
        # by construction in repro.shard.engine; 0 for a single engine)
        self.trace_shard = worker_id_base // max(1, n_workers)
        # below this many access lanes the fused device round costs more than
        # the numpy reductions (dispatch + transfer floor); tests drop it to 0
        # to force the fused round on tiny batches
        self.fused_min_lanes = 2048

    # --- fused validate→sequence (mode="kernel") -------------------------------
    def _fused_round(
        self,
        a_row: np.ndarray,
        a_pos: np.ndarray,
        iw: np.ndarray,
        obs: np.ndarray,
        ssn_now: np.ndarray,
        locked: np.ndarray,
        starts: np.ndarray,
        a_len: np.ndarray,
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """One round's validate→sequence on the device, fused: the gathered
        access columns leave the host as ONE stacked int32 transfer in a
        dense bucket-padded ``(n_txn, k)`` layout (every transaction's
        accesses replicated up to ``k`` lanes and masked by true length), and
        ``(survive, bases)`` come back together — replacing the first-writer
        scatter, three compare-masks, the survive ``reduceat`` and the
        base-SSN segmented max (see ``kernels.batch_occ.
        validate_sequence`` for the masking rules).

        Returns ``None`` — the caller runs the numpy round instead, same
        results — when the batch is out of profile: too small to beat the
        dispatch+transfer floor, dense padding blowup under pathological
        access-count skew, or values outside int32 range.
        """
        total = len(a_row)
        n_active = len(a_len)
        if total < self.fused_min_lanes:
            if REGISTRY.enabled:
                REGISTRY.count("occ.fused.decline.small_batch")
            return None
        k = bucket(int(a_len.max()), min_size=1)
        n_txn = bucket(n_active)
        if n_txn * k > max(4 * total, 4096):
            if REGISTRY.enabled:
                REGISTRY.count("occ.fused.decline.dense_padding")
            return None                # dense layout would mostly be padding
        if not fits_i32(ssn_now, obs, a_row):
            if REGISTRY.enabled:
                REGISTRY.count("occ.fused.decline.i32_range")
            return None
        from ..kernels.ops import fused_validate_sequence

        # dense gather: txn j's lane l reads access start[j] + min(l, len-1)
        # — lanes past a txn's true count replicate its last access and are
        # masked out by a_len on the device
        len_p = np.ones(n_txn, np.int64)
        len_p[:n_active] = a_len
        st_p = np.zeros(n_txn, np.int64)
        st_p[:n_active] = starts[:-1]
        lane = np.arange(k, dtype=np.int64)[None, :]
        src = (st_p[:, None] + np.minimum(lane, len_p[:, None] - 1)).ravel()
        acc = stack_i32(
            [a_row[src], a_pos[src], iw[src], obs[src], ssn_now[src],
             locked[src]],
            n_txn * k, fills=(0,) * 6,
        )
        dev = self.device
        survive, bases = fused_validate_sequence(
            torch.from_numpy(acc).to(dev),
            torch.from_numpy(pad_i32(a_len, n_txn, 0)).to(dev),
            n_txn=n_txn, k=k, cap=bucket(len(self.table.ssn)),
        )
        if REGISTRY.enabled:
            from ..kernels.bucketing import gauge_jit_cache

            gauge_jit_cache([fused_validate_sequence])
        return (
            survive.cpu().numpy()[:n_active],
            bases.cpu().numpy()[:n_active].astype(np.int64),
        )

    # --- segmented reductions -------------------------------------------------
    def _first_writer(
        self, w_row: np.ndarray, w_pos: np.ndarray, a_row: np.ndarray
    ) -> np.ndarray:
        """Per access, the smallest batch position among the batch's writers
        of that row (``NO_WRITER`` if the row is not written this round).
        ``w_pos`` is non-decreasing (txn-major flatten), so the stable sort's
        first element per row group is the segment min."""
        if not len(w_row):
            return np.full(len(a_row), NO_WRITER, dtype=np.int64)
        use_kernel = self.mode == "kernel" and int(w_pos.max()) < 2**31
        if use_kernel:
            uniq, inv = np.unique(w_row, return_inverse=True)
            from ..kernels.ops import occ_seg_reduce
            from ..kernels.batch_occ import NO_WRITER as _NW

            np_items = _pow2(len(inv))
            dev = self.device
            fw_uniq = occ_seg_reduce(
                torch.from_numpy(_pad_i32(inv, np_items, -1)).to(dev),
                torch.from_numpy(_pad_i32(w_pos, np_items, int(_NW))).to(dev),
                n_slots=_pow2(len(uniq)), op="min",
            ).cpu().numpy()[: len(uniq)].astype(np.int64)
        else:
            o = np.argsort(w_row, kind="stable")
            rs = w_row[o]
            first = np.empty(len(rs), dtype=bool)
            first[0] = True
            np.not_equal(rs[1:], rs[:-1], out=first[1:])
            uniq = rs[first]
            fw_uniq = w_pos[o][first]
        idx = np.searchsorted(uniq, a_row)
        idx_c = np.minimum(idx, len(uniq) - 1)
        hit = uniq[idx_c] == a_row
        return np.where(hit, fw_uniq[idx_c], NO_WRITER)

    def _base_ssns(
        self, ssn_now: np.ndarray, starts: np.ndarray, n_active: int
    ) -> np.ndarray:
        """Per-active-txn base SSN (Algorithm 1 lines 1–4, segmented max)."""
        if (
            self.mode == "kernel"
            and len(ssn_now)
            and int(ssn_now.max()) < 2**31
        ):
            from ..kernels.ops import occ_seg_reduce

            keys = np.repeat(
                np.arange(n_active, dtype=np.int64), np.diff(starts)
            )
            np_items = _pow2(len(keys))
            dev = self.device
            base = occ_seg_reduce(
                torch.from_numpy(_pad_i32(keys, np_items, -1)).to(dev),
                torch.from_numpy(_pad_i32(ssn_now, np_items, -1)).to(dev),
                n_slots=_pow2(n_active), op="max",
            ).cpu().numpy()[:n_active].astype(np.int64)
            return np.maximum(base, 0)  # empty segments come back as -1
        return ssn_mod.base_ssn_batch(ssn_now, starts)

    # --- the pipeline --------------------------------------------------------
    def execute_batch(
        self,
        specs: Sequence[TxnSpec],
        worker_ids: Optional[Sequence[int]] = None,
        max_rounds: int = 1,
    ) -> BatchResult:
        """Run one batch through validate → sequence → publish, retrying
        round losers up to ``max_rounds`` times (first-come-wins within each
        round).  Returns the committed ``Txn``s (pre-committed, durably
        committed once the engine drains them) and the never-won indices."""
        if len(specs) == 0:
            return BatchResult()
        t_ent = time.perf_counter() if TRACER.enabled else None
        return self._run(_Flat.from_specs(self.table, specs, self.policy),
                         worker_ids, max_rounds, t_enter=t_ent)

    def execute_indexed(
        self,
        rd_row: np.ndarray,
        rd_start: np.ndarray,
        wr_row: np.ndarray,
        wr_start: np.ndarray,
        wr_vals: Sequence[bytes],
        worker_ids: Optional[Sequence[int]] = None,
        observed: Optional[np.ndarray] = None,
        wr_vlen: Optional[np.ndarray] = None,
        max_rounds: int = 1,
    ) -> BatchResult:
        """Fully array-native entry: the batch arrives as read-index /
        write-index arrays over the table's rows (``rd_start``/``wr_start``
        are ``(B+1,)`` per-txn prefixes), with per-write value payloads.
        No string keys are touched until record framing, which pulls the
        encoded key bytes from the table's own columns
        (``encode_batch_columns``).  The committed ``Txn`` objects carry
        only tid/ssn/worker bookkeeping (their read/write sets are not
        materialized); everything else matches :meth:`execute_batch`."""
        if len(rd_start) <= 1:
            return BatchResult()
        t_ent = time.perf_counter() if TRACER.enabled else None
        flat = _Flat.from_indexed(self.table, rd_row, rd_start, wr_row,
                                  wr_start, wr_vals, observed, wr_vlen)
        return self._run(flat, worker_ids, max_rounds, t_enter=t_ent)

    def _run(
        self,
        flat: _Flat,
        worker_ids: Optional[Sequence[int]],
        max_rounds: int,
        t_enter: Optional[float] = None,
    ) -> BatchResult:
        b = len(flat.rd_len)
        res = BatchResult()
        if worker_ids is None:
            worker_ids = [
                self.worker_id_base + i % self.n_workers for i in range(b)
            ]
        workers = np.asarray(worker_ids, dtype=np.int64)
        specs = flat.specs
        table = self.table
        t_start = time.perf_counter()

        active = np.arange(b, dtype=np.int64)
        _trace = TRACER.enabled
        while len(active) and res.rounds < max_rounds:
            res.rounds += 1
            if _trace:
                _bid = TRACER.next_batch_id()
                TRACER.ctx.batch = _bid
                TRACER.ctx.shard = self.trace_shard
                # first round: the span starts at entry so the spec
                # flattening cost is attributed to validate, not lost
                _tv0 = t_enter if t_enter is not None else time.perf_counter()
                t_enter = None
            with table.mutex:
                # --- gather the round's access view -------------------------
                a_len = flat.acc_len[active]
                a_idx = _concat_ranges(flat.acc_start[active], a_len)
                a_row = flat.acc_row[a_idx]
                a_pos = flat.acc_txn[a_idx]      # global batch positions
                starts = np.zeros(len(active) + 1, dtype=np.int64)
                np.cumsum(a_len, out=starts[1:])
                ssn_now = table.ssn[a_row]

                # --- validate + sequence -----------------------------------
                iw = flat.acc_iswrite[a_idx]
                obs = flat.acc_obs[a_idx]
                locked = table.locked_rows(a_row)
                fused = (
                    self._fused_round(a_row, a_pos, iw, obs, ssn_now, locked,
                                      starts, a_len)
                    if self.mode == "kernel" else None
                )
                if fused is not None:
                    survive, bases_all = fused
                    if REGISTRY.enabled:
                        REGISTRY.count("occ.fused.rounds")
                else:
                    fw = self._first_writer(a_row[iw], a_pos[iw], a_row)
                    ok = fw >= a_pos
                    np.logical_and(ok, (obs < 0) | (ssn_now == obs), out=ok)
                    np.logical_and(ok, ~locked, out=ok)
                    survive = np.logical_and.reduceat(ok, starts[:-1])
                    bases_all = None
                win_local = np.flatnonzero(survive)
                self.aborts += len(active) - len(win_local)
                if REGISTRY.enabled:
                    REGISTRY.count("occ.validate.wins", len(win_local))
                    REGISTRY.count("occ.validate.losses",
                                   len(active) - len(win_local))
                if _trace:
                    _tv1 = time.perf_counter()
                    TRACER.record(
                        ST_VALIDATE, shard=self.trace_shard, batch=_bid,
                        t0=_tv0, t1=_tv1, n_txn=len(active),
                        aux=len(win_local),
                    )
                if not len(win_local):
                    break  # nothing can make progress without external change
                win = active[win_local]

                # --- publish the winners -----------------------------------
                bases = (
                    bases_all[win_local] if bases_all is not None
                    else self._base_ssns(ssn_now, starts, len(active))[win_local]
                )
                txns: List[Txn] = []
                if specs is not None:
                    for j, i in zip(win_local.tolist(), win.tolist()):
                        spec = specs[i]
                        w = int(workers[i])
                        t = Txn(tid=self.stripes[w - self.worker_id_base].next())
                        t.worker_id = w  # type: ignore[attr-defined]
                        t.t_start = t_start
                        if spec.reads:
                            robs = ssn_now[starts[j] : starts[j] + len(spec.reads)]
                            t.read_set = list(zip(spec.reads, robs.tolist()))
                        if flat.is_cmd[i]:
                            # command framing: the logged write chain carries
                            # the op params; the dep ssns were validated this
                            # round so they ARE the live pre-image versions
                            t.cmd_op = int(flat.cmd_op_arr[i])
                            t.cmd_deps = flat.cmd_deps[i]
                            t.write_set = flat.cmd_writes[i]
                        else:
                            t.write_set = list(spec.writes)
                            if REGISTRY.enabled and spec.cmd_op is not None:
                                REGISTRY.count("adaptive.policy.forced_value")
                        txns.append(t)
                else:
                    # indexed mode: bookkeeping-only Txns (read_set is a
                    # sentinel so Qww/Qwr routing and the HAS_READS flag
                    # stay correct; sets are not materialized)
                    for i, nr in zip(win.tolist(), flat.rd_len[win].tolist()):
                        w = int(workers[i])
                        t = Txn(tid=self.stripes[w - self.worker_id_base].next())
                        t.worker_id = w  # type: ignore[attr-defined]
                        t.t_start = t_start
                        if nr:
                            t.read_set = [("", 0)]
                        txns.append(t)

                apply_idx = _concat_ranges(flat.wr_start[win], flat.wr_len[win])
                rows = flat.wr_row[apply_idx]
                has_writes = flat.wr_len[win] > 0
                bufs = np.fromiter(
                    (self.engine.buffer_for(int(w)).id for w in workers[win]),
                    np.int64, len(win),
                )
                ssns = np.array(bases)  # read-only winners: ssn = base

                # phase 1 — log side, one buffer at a time: reserve, encode,
                # publish.  Each buffer's reservation is filled before the
                # next buffer is touched, so a failure (space-wait timeout)
                # never leaves an unfillable hole behind — at worst the log
                # runs ahead of the in-memory table (standard WAL property;
                # the affected txns are committed-but-unacknowledged).  The
                # only deterministic failure, a per-buffer batch bigger than
                # the ring, is pre-checked before any reservation.
                write_bufs = np.unique(bufs[has_writes]).tolist()
                for buf_id in write_bufs:
                    sel = np.flatnonzero(has_writes & (bufs == buf_id))
                    total = int(flat.rec_len[win[sel]].sum())
                    cap = self.engine.buffers[buf_id].capacity
                    if total > cap:
                        raise ValueError(
                            f"batch needs {total}B on buffer {buf_id} "
                            f"(> capacity {cap}B); reduce the batch size"
                        )
                if _trace:
                    # sequence span: base SSNs + Txn bookkeeping + buffer
                    # routing (everything between the masks and the first
                    # reserve), so consecutive spans tile the round
                    TRACER.record(
                        ST_SEQUENCE, shard=self.trace_shard, batch=_bid,
                        t0=_tv1, t1=time.perf_counter(), n_txn=len(win),
                    )
                for buf_id in write_bufs:
                    if _trace:
                        _te0 = time.perf_counter()
                    sel = np.flatnonzero(has_writes & (bufs == buf_id))
                    b_ssns, b_offs, seg = self.engine.buffers[buf_id].reserve_batch(
                        bases[sel], flat.rec_len[win[sel]]
                    )
                    ssns[sel] = b_ssns
                    group = [txns[k] for k in sel.tolist()]
                    for t, s in zip(group, b_ssns.tolist()):
                        t.ssn = s
                        t.buffer_id = buf_id
                    if specs is not None:
                        blob, lens = encode_batch(group)
                    else:
                        # columnar framing straight from the arrays: keys
                        # and key lengths come from the table's columns
                        gw = win[sel]
                        g_idx = _concat_ranges(flat.wr_start[gw], flat.wr_len[gw])
                        g_rows = flat.wr_row[g_idx]
                        blob, lens = encode_batch_columns(
                            b_ssns,
                            np.fromiter(
                                (t.tid for t in group), np.int64, len(group)
                            ),
                            np.where(flat.rd_len[gw] > 0, FLAG_HAS_READS, 0
                                     ).astype(np.uint8),
                            flat.wr_len[gw],
                            table.key_bytes_for(g_rows.tolist()),
                            flat.wr_vals[g_idx],
                            klen=table.key_len[g_rows],
                            vlen=flat.wr_vlen[g_idx],
                        )
                    # same guard as the scalar publish(): the reserved slots
                    # came from _Flat's analytic lengths — drift would
                    # corrupt every later record in the segment
                    assert np.array_equal(lens, flat.rec_len[win[sel]]), (
                        "framed length drift between _Flat and encode"
                    )
                    if REGISTRY.enabled:
                        cm = flat.is_cmd[win[sel]]
                        n_cmd = int(cm.sum())
                        cb = int(lens[cm].sum())
                        REGISTRY.count("adaptive.log_bytes_command", cb)
                        REGISTRY.count("adaptive.log_bytes_value",
                                       int(lens.sum()) - cb)
                        REGISTRY.count("adaptive.policy.command", n_cmd)
                        REGISTRY.count("adaptive.policy.value",
                                       len(group) - n_cmd)
                    if _trace:
                        TRACER.record(
                            ST_ENCODE, shard=self.trace_shard,
                            device=buf_id, batch=_bid,
                            txn_lo=int(b_ssns[0]), txn_hi=int(b_ssns[-1]),
                            t0=_te0, t1=time.perf_counter(),
                            nbytes=len(blob), n_txn=len(group),
                        )
                    self.engine.publish_batch(
                        group, blob, buffer_id=buf_id,
                        offset=int(b_offs[0]), seg_idx=seg,
                    )

                # phase 2 — table write-back under claimed locks: values +
                # SSNs as two scatters (intra-txn duplicate keys resolve
                # last-write-wins, like the scalar apply loop); the finally
                # guarantees the locks can't wedge the rows
                if _trace:
                    _tw0 = time.perf_counter()
                tids = np.fromiter((t.tid for t in txns), np.int64, len(txns))
                table.claim_rows(rows, np.repeat(tids, flat.wr_len[win]))
                try:
                    table.values[rows] = flat.wr_vals[apply_idx]
                    table.ssn[rows] = np.repeat(ssns, flat.wr_len[win])
                finally:
                    table.release_rows(rows)
                ro = np.flatnonzero(~has_writes)
                if len(ro):
                    for k in ro.tolist():
                        txns[k].ssn = int(ssns[k])
                    self.engine.publish_batch([txns[k] for k in ro.tolist()])
                if _trace:
                    TRACER.record(
                        ST_WRITEBACK, shard=self.trace_shard, batch=_bid,
                        t0=_tw0, t1=time.perf_counter(), n_txn=len(txns),
                    )

            res.committed.extend(txns)
            res.committed_idx.extend(win.tolist())
            self.committed_submitted += len(txns)
            active = active[~survive]

        if _trace:
            TRACER.ctx.batch = -1
        res.aborted = active.tolist()
        return res

    def drain(self) -> int:
        n = 0
        for w in range(self.n_workers):
            n += self.engine.drain(self.worker_id_base + w)
        return n


class ScalarBatchOCC:
    """Per-transaction oracle for :class:`BatchOCC` (recovery's
    ``mode="scalar"`` pattern): identical batch semantics — reads observed at
    round start, first-come-wins against *all* of the round's write intents,
    driver-observed SSN validation — executed serially with the existing
    scalar machinery (dict ``Table`` cells, per-txn ``engine.allocate`` +
    ``Txn`` writeback + ``engine.publish``).  Runs single-threaded, so
    per-tuple locks are not taken; foreign-lock behaviour is out of scope
    for the oracle."""

    def __init__(
        self,
        table: Table,
        engine: LoggingEngine,
        n_workers: int = 1,
        tid_stride: int = TID_STRIDE,
    ):
        self.table = table
        self.engine = engine
        self.n_workers = n_workers
        self.stripes = [TidStripe(w, tid_stride) for w in range(n_workers)]
        for w in range(n_workers):
            engine.register_worker(w)
        self.committed_submitted = 0
        self.aborts = 0

    def execute_batch(
        self,
        specs: Sequence[TxnSpec],
        worker_ids: Optional[Sequence[int]] = None,
        max_rounds: int = 1,
    ) -> BatchResult:
        b = len(specs)
        res = BatchResult()
        if worker_ids is None:
            worker_ids = [i % self.n_workers for i in range(b)]
        t_start = time.perf_counter()

        active = list(range(b))
        while active and res.rounds < max_rounds:
            res.rounds += 1
            first_writer: Dict[str, int] = {}
            for i in active:
                for k, _ in specs[i].writes:
                    first_writer.setdefault(k, i)
            observed = {}
            for i in active:
                observed[i] = [
                    self.table.get_or_insert(k).ssn for k in specs[i].reads
                ]
                for k, _ in specs[i].writes:
                    # materialize write cells like the scalar read phase does
                    # (the flattened path inserts all accessed keys up front)
                    self.table.get_or_insert(k)
            winners: List[int] = []
            for i in active:
                spec = specs[i]
                ok = all(
                    first_writer.get(k, b) >= i
                    for k in list(spec.reads) + [k for k, _ in spec.writes]
                )
                if ok and spec.observed is not None:
                    ok = all(
                        self.table.get_or_insert(k).ssn == int(o)
                        for k, o in zip(spec.reads, spec.observed)
                    )
                if not ok:
                    self.aborts += 1
                    continue
                w = worker_ids[i]
                cells_r = [self.table.get_or_insert(k) for k in spec.reads]
                cells_w = [self.table.get_or_insert(k) for k, _ in spec.writes]
                txn = Txn(tid=self.stripes[w].next())
                txn.worker_id = w  # type: ignore[attr-defined]
                txn.t_start = t_start
                txn.read_set = [(k, o) for k, o in zip(spec.reads, observed[i])]
                txn.write_set = list(spec.writes)
                self.engine.allocate(txn, cells_r, cells_w)
                for cell, (_, val) in zip(cells_w, spec.writes):
                    cell.value = val
                if txn.write_set:
                    ssn_mod.writeback(txn.ssn, cells_w)
                self.engine.publish(txn)
                winners.append(i)
                res.committed.append(txn)
                res.committed_idx.append(i)
            self.committed_submitted += len(winners)
            if not winners:
                break
            won = set(winners)
            active = [i for i in active if i not in won]

        res.aborted = list(active)
        return res

    def drain(self) -> int:
        n = 0
        for w in range(self.n_workers):
            n += self.engine.drain(w)
        return n
