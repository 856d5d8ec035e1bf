"""Sharded Poplar: partitioned multi-engine logging (`ROADMAP` north star).

Public surface:

* :class:`~repro_torch.shard.engine.ShardedEngine` / ``ShardedConfig`` — N
  independent Poplar shards behind a hash router; single-shard transactions
  run the existing batched fast path unchanged, cross-shard transactions go
  through the coordinator (shared base SSN, per-participant dependency
  records, commit when durable on every participant).
* :class:`~repro_torch.shard.router.Router` — stable crc32 key partitioning +
  batch splitting.
* :func:`~repro_torch.shard.recovery.recover_sharded` — per-shard vectorized
  replay + the cross-shard consistent cut.
"""

from .coordinator import CrossShardCoordinator, XTxn
from .engine import Shard, ShardBatchResult, ShardedConfig, ShardedEngine
from .recovery import ShardedRecoveredState, recover_sharded, resolve_cut
from .router import Router

__all__ = [
    "CrossShardCoordinator",
    "XTxn",
    "Shard",
    "ShardBatchResult",
    "ShardedConfig",
    "ShardedEngine",
    "ShardedRecoveredState",
    "recover_sharded",
    "resolve_cut",
    "Router",
]
