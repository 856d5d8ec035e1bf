"""Hash-based key partitioning for the sharded engine.

Every key lives on exactly one shard: ``shard_of(key) = crc32(key) % N``.
CRC32 rather than Python's ``hash`` so the mapping is stable across
processes — recovery (a different process) must route each key to the same
shard that logged it, and benchmarks must be able to pre-bucket keys.

``split`` partitions an incoming batch of :class:`~repro_torch.db.batch.TxnSpec`
into per-shard sub-batches (every access on one shard — these run the
existing single-engine fast path unchanged) and a cross-shard remainder
(these go through the :class:`~repro_torch.shard.coordinator.CrossShardCoordinator`).
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Sequence, Tuple

from ..db.batch import TxnSpec


class Router:
    def __init__(self, n_shards: int):
        assert n_shards >= 1
        self.n_shards = n_shards
        self._cache: Dict[str, int] = {}

    def shard_of(self, key: str) -> int:
        s = self._cache.get(key)
        if s is None:
            s = zlib.crc32(key.encode()) % self.n_shards
            self._cache[key] = s
        return s

    def shards_of(self, spec: TxnSpec) -> List[int]:
        """Sorted participant shard ids of one spec (reads ∪ writes)."""
        shards = {self.shard_of(k) for k in spec.reads}
        shards.update(self.shard_of(k) for k, _ in spec.writes)
        return sorted(shards)

    def split(
        self, specs: Sequence[TxnSpec]
    ) -> Tuple[
        Dict[int, List[Tuple[int, TxnSpec]]],
        List[Tuple[int, TxnSpec, List[int]]],
    ]:
        """Partition a batch by participant set.

        Returns ``(per_shard, cross)``: ``per_shard[p]`` holds the
        ``(batch_index, spec)`` pairs fully contained in shard ``p`` (batch
        order preserved — it fixes the per-shard WAW chain), ``cross`` the
        ``(batch_index, spec, participant_shards)`` triples spanning more
        than one shard.
        """
        per_shard: Dict[int, List[Tuple[int, TxnSpec]]] = {}
        cross: List[Tuple[int, TxnSpec, List[int]]] = []
        for i, spec in enumerate(specs):
            shards = self.shards_of(spec)
            if len(shards) == 1:
                per_shard.setdefault(shards[0], []).append((i, spec))
            else:
                cross.append((i, spec, shards))
        return per_shard, cross
