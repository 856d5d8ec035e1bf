"""Partitioned multi-engine logging: N independent Poplar shards + a router.

Each shard owns a full private Poplar stack — :class:`PoplarEngine` (its own
log buffers, devices, logger threads, Qww/Qwr queues),
:class:`~repro_torch.db.array_table.ArrayTable` tuple store, and
:class:`~repro_torch.db.batch.BatchOCC` batched executor — so single-shard
transactions run the existing array-native fast path *unchanged* and the
shards share no latch, no SSN counter and no device head.  A hash
:class:`~repro_torch.shard.router.Router` partitions the key space and splits
incoming :class:`~repro_torch.db.batch.TxnSpec` batches into per-shard
sub-batches; transactions spanning shards go through the
:class:`~repro_torch.shard.coordinator.CrossShardCoordinator` (shared base SSN,
one dependency-stamped record per participant, commit when durable
everywhere).

Worker ids and tid stripes are offset per shard (``worker_id_base``) so the
whole system lives in one collision-free tid universe; the coordinator gets
its own stripe above all shard workers.

Like :class:`PoplarEngine`, the sharded engine runs threaded (``start()``)
or stepped (tests drive :meth:`tick` deterministically).  Kernel mode (the
default) runs every shard's validate→sequence rounds on ``device``: on
``"cuda"`` it raises when no CUDA device is present, ``"cpu"`` runs the
kernels' plain PyTorch versions.  :meth:`ShardedEngine.execute_batch` runs
the per-shard sub-batches one after another on the calling thread, so the
fused rounds of one engine never launch from two threads on one stream.
"""

from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core.engine import EngineConfig, PoplarEngine
from ..core.txn import Txn
from ..db.array_table import ArrayTable
from ..db.batch import BatchOCC, TxnSpec
from ..db.occ import TID_STRIDE, TidStripe
from .coordinator import CrossShardCoordinator, XTxn
from .router import Router


@dataclass
class ShardedConfig:
    n_shards: int = 2
    n_buffers: int = 1            # log buffers (= devices) per shard
    n_workers: int = 1            # executor worker/tid stripes per shard
    mode: str = "kernel"          # BatchOCC mode: 'kernel' | 'vectorized'
    device: str = "cuda"          # where kernel mode runs ('cuda' | 'cpu')
    device_kind: str = "ssd"
    device_dir: Optional[str] = None   # per-shard subdirs are created inside
    device_clock: str = "real"
    table_capacity: int = 1024
    # full per-shard EngineConfig override (n_buffers etc. come from it);
    # device_dir is still re-pointed at the shard subdirectory
    engine: Optional[EngineConfig] = None
    # adaptive command/value framing: ``shard_id -> AdaptivePolicy`` factory
    # handed to each shard's BatchOCC (None keeps every shard pure-value).
    # Per-shard because eligibility depends on the shard's *own* checkpoint
    # RSN — a dep covered by shard 0's image may be uncovered on shard 1.
    policy_factory: Optional[Callable[[int], object]] = None


class Shard:
    """One partition: a private engine, tuple store, and batch executor."""

    def __init__(self, shard_id: int, cfg: ShardedConfig):
        self.id = shard_id
        ecfg = cfg.engine or EngineConfig(
            n_buffers=cfg.n_buffers,
            device_kind=cfg.device_kind,
            device_clock=cfg.device_clock,
        )
        # always re-point a configured device_dir (from either config
        # source) at a per-shard subdirectory — shards sharing one
        # directory would interleave frames into the same log files
        ddir = cfg.device_dir if cfg.device_dir is not None else ecfg.device_dir
        if ddir is not None:
            ecfg = dataclasses.replace(
                ecfg, device_dir=os.path.join(ddir, f"shard{shard_id}")
            )
        self.engine = PoplarEngine(ecfg)
        self.engine._trace_shard = shard_id
        self.table = ArrayTable(capacity=cfg.table_capacity, name=f"shard{shard_id}")
        self.occ = BatchOCC(
            self.table,
            self.engine,
            n_workers=cfg.n_workers,
            mode=cfg.mode,
            device=cfg.device,
            worker_id_base=shard_id * cfg.n_workers,
            policy=(
                cfg.policy_factory(shard_id)
                if cfg.policy_factory is not None else None
            ),
        )


@dataclass
class ShardBatchResult:
    """Outcome of one batch through the sharded engine.

    ``committed`` are the single-shard pre-committed ``Txn``s (durable once
    their shard drains them); ``cross`` the prepared cross-shard ``XTxn``s
    (committed by a later :meth:`ShardedEngine.drain` once durable on every
    participant); ``aborted`` the losing batch indices.
    """

    committed: List[Txn] = field(default_factory=list)
    committed_idx: List[int] = field(default_factory=list)
    cross: List[XTxn] = field(default_factory=list)
    cross_idx: List[int] = field(default_factory=list)
    aborted: List[int] = field(default_factory=list)


class ShardedEngine:
    def __init__(self, cfg: Optional[ShardedConfig] = None, **overrides):
        cfg = cfg or ShardedConfig(**overrides)
        assert (cfg.n_shards + 1) * cfg.n_workers <= TID_STRIDE, (
            "shard x worker grid exceeds the tid stripe space"
        )
        self.cfg = cfg
        self.router = Router(cfg.n_shards)
        self.shards = [Shard(p, cfg) for p in range(cfg.n_shards)]
        self.coordinator = CrossShardCoordinator(
            self.shards, self.router,
            TidStripe(cfg.n_shards * cfg.n_workers),
        )

    # --- tuple-store interop (loader duck-type: insert/get like a table) ----
    def shard_of(self, key: str) -> int:
        return self.router.shard_of(key)

    def insert(self, key: str, value: bytes) -> int:
        return self.shards[self.shard_of(key)].table.insert(key, value)

    def get(self, key: str) -> Optional[Tuple[bytes, int]]:
        return self.shards[self.shard_of(key)].table.get(key)

    def to_dict(self) -> Dict[bytes, Tuple[bytes, int]]:
        out: Dict[bytes, Tuple[bytes, int]] = {}
        for sh in self.shards:
            out.update(sh.table.to_dict())
        return out

    @property
    def devices(self) -> List[List]:
        """Per-shard device lists (the shape sharded recovery takes)."""
        return [sh.engine.devices for sh in self.shards]

    # --- forward path -------------------------------------------------------
    def execute_batch(
        self, specs: Sequence[TxnSpec], max_rounds: int = 1
    ) -> ShardBatchResult:
        """Split one batch by participant set, run the per-shard sub-batches
        through each shard's unchanged fast path, then prepare the
        cross-shard remainder through the coordinator."""
        res = ShardBatchResult()
        if not len(specs):
            return res
        per_shard, cross = self.router.split(specs)
        for p in sorted(per_shard):
            idxs = [i for i, _ in per_shard[p]]
            sub = [s for _, s in per_shard[p]]
            r = self.shards[p].occ.execute_batch(sub, max_rounds=max_rounds)
            res.committed.extend(r.committed)
            res.committed_idx.extend(idxs[j] for j in r.committed_idx)
            res.aborted.extend(idxs[j] for j in r.aborted)
        for i, spec, shard_ids in cross:
            xt = self.coordinator.execute(spec, shard_ids)
            if xt is not None:
                res.cross.append(xt)
                res.cross_idx.append(i)
            else:
                res.aborted.append(i)
        return res

    def drain(self) -> int:
        """Drain every shard's commit queues + sweep the cross-shard
        pending set; returns the number of transactions committed."""
        n = 0
        for sh in self.shards:
            n += sh.occ.drain()
        n += self.coordinator.sweep()
        return n

    # --- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        for sh in self.shards:
            sh.engine.start()

    def stop(self) -> None:
        for sh in self.shards:
            sh.engine.stop()

    def tick(self, force: bool = True) -> None:
        """Stepped mode: one logger tick on every buffer of every shard
        (tests drive flushing deterministically, like ``logger_tick``)."""
        for sh in self.shards:
            for i in range(len(sh.engine.buffers)):
                sh.engine.logger_tick(i, force=force)

    def quiesce(self, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.tick(force=True)
            self.drain()
            pending = self.coordinator.pending_count()
            for sh in self.shards:
                pending += sum(q.pending() for q in sh.engine.queues.values())
                pending += sum(b.pending_bytes() for b in sh.engine.buffers)
            if pending == 0:
                return
            time.sleep(1e-4)
        raise TimeoutError("sharded engine quiesce timed out")

    # --- stats --------------------------------------------------------------
    def stats(self) -> Dict:
        return {
            "engine": "sharded_poplar",
            "n_shards": self.cfg.n_shards,
            "txn_logged": sum(sh.engine.txn_logged for sh in self.shards),
            "txn_committed": sum(sh.engine.txn_committed for sh in self.shards),
            "cross_prepared": self.coordinator.prepared,
            "cross_committed": self.coordinator.committed_total,
            "cross_aborts": self.coordinator.aborts,
            "shards": [sh.engine.stats() for sh in self.shards],
        }
