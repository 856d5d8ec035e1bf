"""Cross-shard transaction coordinator (Algorithm 1 lifted across shards).

A cross-shard transaction T touching shards P = {p1..pk}:

* **prepare** — under every participant's table mutex (acquired in shard-id
  order; deadlock-free against the single-mutex batch executors): validate
  (no foreign write locks on any accessed row, driver-observed SSNs fresh),
  compute the global base SSN ``base = max tuple SSN over RS ∪ WS across
  all participants`` (:func:`repro_torch.core.ssn.base_ssn_global`), then reserve
  one log record on *every* participant shard — including read-only
  participants, which get a zero-write marker — via
  :meth:`~repro_torch.core.engine.PoplarEngine.reserve_record` from that shared
  base.  Once every per-shard SSN is known, each record is framed with the
  full ``[(shard, ssn)]`` dependency vector (the explicit cross-shard
  WAW/RAW edge; ``FLAG_XSHARD``) and memcpy'd into its ring.  Write rows
  stay *locked and unmodified*: cross-shard writes become visible only at
  commit, so no transaction can ever read cross-shard dirty data — which is
  what keeps the recovery cut free of cross-shard cascades.

* **commit** — T commits when the single-shard watermark rule
  (:meth:`~repro_torch.core.commit.CommitProtocol.committable`) passes on *every*
  participant: ``ssn_p <= DSN(buffer_p)`` per shard for write-only
  transactions (Qww generalized), ``ssn_p <= CSN_p`` per shard when T has
  reads (Qwr generalized — any RAW predecessor on shard p has a tuple SSN
  below the shared base, hence ``< ssn_p <= CSN_p``, hence durable on p).
  Only then are the write values + SSNs applied to the tables and the row
  locks released.

Because reserving from the shared base bumps every participant buffer's SSN
past the base, the per-shard SSN spaces stay loosely synchronized without
any global sequencer — the same observation behind Taurus's vector LSNs and
dependency logging, specialized to Poplar's partially-constrained order.
"""

from __future__ import annotations

import threading
import time
from contextlib import ExitStack
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.ssn import base_ssn_global
from ..core.txn import Txn
from ..db.batch import TxnSpec
from ..db.occ import TidStripe
from ..trace.span import ST_XPREPARE, TRACER
from ..obs.metrics import REGISTRY
from .router import Router


@dataclass
class XPart:
    """One participant shard's slice of a cross-shard transaction."""

    shard: int
    buffer_id: int
    ssn: int
    wr_rows: np.ndarray            # table rows this txn writes on the shard
    wr_vals: np.ndarray            # object array of value payloads
    rd_rows: np.ndarray            # rows read on the shard...
    rd_ssn: np.ndarray             # ...and the tuple SSNs observed at prepare


@dataclass
class XTxn:
    """A prepared cross-shard transaction awaiting its global commit."""

    gtid: int
    has_reads: bool
    parts: List[XPart]
    committed: bool = False
    t_start: float = 0.0
    t_precommit: float = 0.0
    t_commit: float = 0.0

    @property
    def shards(self) -> List[int]:
        return [p.shard for p in self.parts]


class CrossShardCoordinator:
    """Prepares and commits cross-shard transactions over a set of shards.

    ``shards`` is the sharded engine's shard list (each exposing ``engine``
    and ``table``); the coordinator owns its own tid stripe so gtids never
    collide with any shard executor's tids.
    """

    def __init__(self, shards: Sequence, router: Router, tids: TidStripe):
        self.shards = shards
        self.router = router
        self.tids = tids
        self.pending: List[XTxn] = []
        self.lock = threading.Lock()
        self.aborts = 0
        self.prepared = 0
        self.committed_total = 0
        self._seq = 0  # spreads cross-shard records across each shard's buffers

    # --- prepare ------------------------------------------------------------
    def execute(
        self, spec: TxnSpec, shard_ids: Optional[Sequence[int]] = None
    ) -> Optional[XTxn]:
        """Run the prepare phase for one cross-shard spec; returns the
        pending :class:`XTxn` (committed later by :meth:`sweep`) or None on
        a validation abort."""
        router = self.router
        shard_ids = sorted(shard_ids) if shard_ids else router.shards_of(spec)
        t_start = time.perf_counter()

        # group accesses per shard (observed SSNs stay aligned with reads)
        rd_keys: Dict[int, List[str]] = {p: [] for p in shard_ids}
        rd_obs: Dict[int, List[int]] = {p: [] for p in shard_ids}
        wr_keys: Dict[int, List[str]] = {p: [] for p in shard_ids}
        wr_vals: Dict[int, List[bytes]] = {p: [] for p in shard_ids}
        for i, k in enumerate(spec.reads):
            p = router.shard_of(k)
            rd_keys[p].append(k)
            rd_obs[p].append(-1 if spec.observed is None else int(spec.observed[i]))
        for k, v in spec.writes:
            p = router.shard_of(k)
            wr_keys[p].append(k)
            wr_vals[p].append(v)

        # map keys to rows before taking any mutex (rows_for locks internally
        # for inserts; rows are append-only so the arrays stay valid)
        rd_rows = {p: self.shards[p].table.rows_for(rd_keys[p]) for p in shard_ids}
        wr_rows = {p: self.shards[p].table.rows_for(wr_keys[p]) for p in shard_ids}

        has_reads = bool(spec.reads)
        xt: Optional[XTxn] = None
        with ExitStack() as stack:
            for p in shard_ids:  # shard-id order: deadlock-free
                stack.enter_context(self.shards[p].table.mutex)

            # --- validate -----------------------------------------------
            for p in shard_ids:
                table = self.shards[p].table
                rows = np.concatenate([rd_rows[p], wr_rows[p]])
                if table.locked_rows(rows).any():
                    self.aborts += 1
                    if REGISTRY.enabled:
                        REGISTRY.count("shard.xprepare.aborts")
                    return None
                obs = np.asarray(rd_obs[p], dtype=np.int64)
                if len(obs) and (
                    (obs >= 0) & (table.ssn[rd_rows[p]] != obs)
                ).any():
                    self.aborts += 1
                    if REGISTRY.enabled:
                        REGISTRY.count("shard.xprepare.aborts")
                    return None

            # --- sequence: shared base, one record per participant -------
            base = base_ssn_global(
                self.shards[p].table.ssn[rows_p]
                for p in shard_ids
                for rows_p in (rd_rows[p], wr_rows[p])
            )
            gtid = self.tids.next()
            self._seq += 1
            txns: List[Txn] = []
            for p in shard_ids:
                t = Txn(tid=gtid)
                t.write_set = list(zip(wr_keys[p], wr_vals[p]))
                if has_reads:
                    t.read_set = [("", 0)]  # sentinel: flags + Qwr routing
                # placeholder vector: fixes the framed length before the
                # per-shard SSNs are known
                t.xdep = [(q, 0) for q in shard_ids]
                t.t_start = t_start
                self.shards[p].engine.reserve_record(t, base, self._seq)
                txns.append(t)
            xdep = [(p, t.ssn) for p, t in zip(shard_ids, txns)]
            parts: List[XPart] = []
            for p, t in zip(shard_ids, txns):
                t.xdep = list(xdep)
                self.shards[p].engine.fill_record(t)
                vals = np.empty(len(wr_vals[p]), dtype=object)
                vals[:] = wr_vals[p]
                parts.append(
                    XPart(
                        shard=p,
                        buffer_id=t.buffer_id,
                        ssn=t.ssn,
                        wr_rows=wr_rows[p],
                        wr_vals=vals,
                        rd_rows=rd_rows[p],
                        rd_ssn=self.shards[p].table.ssn[rd_rows[p]].copy(),
                    )
                )
                # hold the write locks until global commit: values and tuple
                # SSNs are untouched, so concurrent transactions abort (and
                # retry) rather than observe cross-shard dirty state
                self.shards[p].table.claim_rows(wr_rows[p], gtid)

            xt = XTxn(gtid=gtid, has_reads=has_reads, parts=parts,
                      t_start=t_start, t_precommit=time.perf_counter())
            if TRACER.enabled:
                # one span per participant: the durable-on-all join in the
                # trace DAG needs each (shard, buffer, ssn) leg separately
                for part in parts:
                    TRACER.record(
                        ST_XPREPARE, shard=part.shard, device=part.buffer_id,
                        batch=gtid, txn_lo=part.ssn, txn_hi=part.ssn,
                        t0=t_start, t1=xt.t_precommit, n_txn=1,
                        aux=len(parts),
                    )
        # append outside the table mutexes: sweep() applies under self.lock
        # while taking table mutexes, so the reverse nesting would deadlock
        with self.lock:
            self.pending.append(xt)
        self.prepared += 1
        if REGISTRY.enabled:
            REGISTRY.observe("shard.xprepare_s", xt.t_precommit - t_start)
        return xt

    # --- commit -------------------------------------------------------------
    def _committable(self, xt: XTxn) -> bool:
        for part in xt.parts:
            eng = self.shards[part.shard].engine
            if not eng.commit.committable(part.ssn, xt.has_reads, part.buffer_id):
                return False
        return True

    def _apply(self, xt: XTxn) -> None:
        for part in xt.parts:
            sh = self.shards[part.shard]
            with sh.table.mutex:
                if len(part.wr_rows):
                    sh.table.values[part.wr_rows] = part.wr_vals
                    sh.table.ssn[part.wr_rows] = part.ssn
                sh.table.release_rows(part.wr_rows)
            with sh.engine._count_lock:
                sh.engine.txn_committed += 1
        xt.committed = True
        xt.t_commit = time.perf_counter()

    def sweep(self) -> int:
        """Commit every pending cross-shard transaction whose records are
        durable (per the per-shard watermark rule) on all participants.
        Unlike the per-worker FIFO queues, pending transactions are scanned
        in full — per-shard SSN vectors are only partially ordered, so a
        blocked head says nothing about the rest."""
        n = 0
        with self.lock:
            still: List[XTxn] = []
            for xt in self.pending:
                if self._committable(xt):
                    self._apply(xt)
                    self.committed_total += 1
                    n += 1
                else:
                    still.append(xt)
            self.pending = still
        return n

    def pending_count(self) -> int:
        with self.lock:
            return len(self.pending)
