"""Execution backends for the OLTP serving tier.

The :class:`~repro_torch.serve.scheduler.GroupCommitScheduler` is engine-agnostic:
it cuts batches and gates client acks, and delegates execution/durability to
a backend wrapping one of the repo's transaction stacks:

* :class:`SingleBackend` — one Poplar engine + one tuple store + one batch
  executor.  The executor can be the array-native
  :class:`~repro_torch.db.batch.BatchOCC` (``mode='kernel'``, the default,
  on ``device``, or ``'vectorized'``) or the per-txn
  :class:`~repro_torch.db.batch.ScalarBatchOCC` oracle (``mode='scalar'``)
  — the serving tier runs identically over all three, which is what the
  group-commit equivalence property test pins down.
* :class:`ShardedBackend` — a :class:`~repro_torch.shard.engine.ShardedEngine`
  (kernel mode on ``device="cuda"`` unless the overrides say otherwise);
  single-shard sub-batches run each shard's unchanged fast path and
  cross-shard specs go through the coordinator (their acks release only
  when durable on *every* participant, i.e. when the coordinator's sweep
  marks them committed).

The backend contract mirrors the engine's two operating modes: ``tick()``
flushes deterministically (stepped tests pick which devices flush, to
randomize DSN/CSN interleavings), ``start()``/``stop()`` run the real
logger threads (threaded serving, benchmarks).  ``drain()`` is the *only*
place transactions become durably committed — it applies the paper's
Qww/Qwr watermark rule via :meth:`repro_torch.core.commit.CommitProtocol.drain` —
so the scheduler's "ack once ``txn.committed``" gate is exactly
"ack = durable ∧ committable()".
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..core.engine import EngineConfig, LoggingEngine, PoplarEngine
from ..core.txn import Txn
from ..db.array_table import ArrayTable
from ..db.batch import BatchOCC, BatchResult, ScalarBatchOCC, TxnSpec
from ..db.table import Table
from ..kernels.ops import kernel_device
from ..shard.coordinator import XTxn
from ..shard.engine import ShardedConfig, ShardedEngine


class ExecOutcome:
    """Normalized result of one batch execution.

    ``committed`` pairs each winning spec index with its pre-committed
    transaction object (a :class:`~repro_torch.core.txn.Txn`, or an
    :class:`~repro_torch.shard.coordinator.XTxn` for cross-shard specs) whose
    ``.committed`` flag flips once the backend's drain finds it durable and
    committable; ``aborted`` holds the spec indices that lost validation.
    """

    __slots__ = ("committed", "aborted")

    def __init__(
        self,
        committed: List[Tuple[int, Union[Txn, XTxn]]],
        aborted: List[int],
    ):
        self.committed = committed
        self.aborted = aborted


class SingleBackend:
    """One engine + table + batch executor behind the scheduler.

    Build it from parts (tests often pre-build the stack) or via
    :meth:`make`, which wires the standard combination for a mode.
    """

    def __init__(
        self,
        table: Union[ArrayTable, Table],
        engine: LoggingEngine,
        occ: Union[BatchOCC, ScalarBatchOCC],
    ):
        self.table = table
        self.engine = engine
        self.occ = occ

    @classmethod
    def make(
        cls,
        mode: str = "kernel",
        n_workers: int = 1,
        cfg: Optional[EngineConfig] = None,
        table_capacity: int = 1024,
        device="cuda",
    ) -> "SingleBackend":
        """``mode`` is ``"kernel"`` (the fused round and ``seg_reduce`` on
        ``device``; without a card ``device="cuda"`` raises),
        ``"vectorized"`` or ``"scalar"``."""
        if mode == "kernel":
            kernel_device(device)   # a missing card raises before a log opens
        engine = PoplarEngine(cfg or EngineConfig())
        if mode == "scalar":
            table: Union[ArrayTable, Table] = Table()
            occ: Union[BatchOCC, ScalarBatchOCC] = ScalarBatchOCC(
                table, engine, n_workers=n_workers
            )
        else:
            table = ArrayTable(capacity=table_capacity)
            occ = BatchOCC(table, engine, n_workers=n_workers, mode=mode,
                           device=device)
        return cls(table, engine, occ)

    # --- scheduler contract -------------------------------------------------
    @property
    def n_workers(self) -> int:
        return self.occ.n_workers

    def execute(
        self,
        specs: Sequence[TxnSpec],
        worker_ids: Optional[Sequence[int]] = None,
        max_rounds: int = 1,
    ) -> ExecOutcome:
        r: BatchResult = self.occ.execute_batch(
            specs, worker_ids=worker_ids, max_rounds=max_rounds
        )
        return ExecOutcome(
            committed=list(zip(r.committed_idx, r.committed)),
            aborted=list(r.aborted),
        )

    def tick(self, parts: Optional[Sequence[int]] = None) -> None:
        """Stepped flush: force one logger tick on the given buffers (all by
        default).  ``parts`` indexes buffers — partial ticks let tests hold
        one device's DSN back and exercise the CSN gate."""
        idxs = range(len(self.engine.buffers)) if parts is None else parts
        for i in idxs:
            self.engine.logger_tick(i, force=True)

    def drain(self) -> int:
        return self.occ.drain()

    def start(self) -> None:
        self.engine.start()

    def stop(self) -> None:
        self.engine.stop()

    def quiesce(self, timeout: float = 30.0) -> None:
        self.engine.quiesce(
            [self.occ.worker_id_base + w for w in range(self.occ.n_workers)]
            if isinstance(self.occ, BatchOCC)
            else range(self.occ.n_workers),
            timeout=timeout,
        )

    def queue_depths(self) -> List[int]:
        """Pending (logged, not yet durably committed) txns per commit queue
        — the backend-side component of queue depth reporting."""
        return [q.pending() for q in self.engine.queues.values()]

    def saturated(self) -> bool:
        """Log-device saturation signal: any buffer holds more unflushed
        bytes than one io_unit — the flush pipe is behind the offered load."""
        return any(
            b.pending_bytes() > self.engine.cfg.io_unit
            for b in self.engine.buffers
        )


class ShardedBackend:
    """A :class:`ShardedEngine` behind the scheduler.

    ``worker_ids`` are ignored: each shard's executor assigns its own
    (shard-offset) worker stripes to its sub-batch, which keeps the
    single-shard fast path byte-identical to driving the sharded engine
    directly.
    """

    def __init__(self, eng: ShardedEngine):
        self.eng = eng
        self.table = eng  # duck-typed insert/get/to_dict for loaders

    @classmethod
    def make(cls, n_shards: int = 4, **overrides) -> "ShardedBackend":
        """``overrides`` go to :class:`ShardedConfig`, whose defaults are
        ``mode="kernel"`` on ``device="cuda"``."""
        return cls(ShardedEngine(ShardedConfig(n_shards=n_shards, **overrides)))

    @property
    def n_workers(self) -> int:
        return self.eng.cfg.n_shards * self.eng.cfg.n_workers

    def execute(
        self,
        specs: Sequence[TxnSpec],
        worker_ids: Optional[Sequence[int]] = None,
        max_rounds: int = 1,
    ) -> ExecOutcome:
        r = self.eng.execute_batch(specs, max_rounds=max_rounds)
        committed: List[Tuple[int, Union[Txn, XTxn]]] = list(
            zip(r.committed_idx, r.committed)
        )
        committed.extend(zip(r.cross_idx, r.cross))
        return ExecOutcome(committed=committed, aborted=list(r.aborted))

    def tick(self, parts: Optional[Sequence[int]] = None) -> None:
        """Stepped flush; ``parts`` indexes shards (every buffer of each)."""
        if parts is None:
            self.eng.tick(force=True)
            return
        for p in parts:
            sh = self.eng.shards[p]
            for i in range(len(sh.engine.buffers)):
                sh.engine.logger_tick(i, force=True)

    def drain(self) -> int:
        return self.eng.drain()

    def start(self) -> None:
        self.eng.start()

    def stop(self) -> None:
        self.eng.stop()

    def quiesce(self, timeout: float = 30.0) -> None:
        self.eng.quiesce(timeout=timeout)

    def queue_depths(self) -> List[int]:
        """Per-shard pending (logged, not durably committed) txn counts.
        Cross-shard transactions awaiting the durable-on-all sweep are global
        — they count against every participant's depth would double-count, so
        they ride on shard 0's entry."""
        out = [
            sum(q.pending() for q in sh.engine.queues.values())
            for sh in self.eng.shards
        ]
        out[0] += self.eng.coordinator.pending_count()
        return out

    def saturated(self) -> bool:
        return any(
            b.pending_bytes() > sh.engine.cfg.io_unit
            for sh in self.eng.shards
            for b in sh.engine.buffers
        )
