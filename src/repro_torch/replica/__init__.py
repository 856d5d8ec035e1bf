"""Replication: parallel log shipping + continuous vectorized apply +
RAW-safe read replicas.

The same partially constrained per-device logs that guarantee crash
recoverability (paper §3–§5) are sufficient to feed a *live* replica — no
cross-device merge, no total order, no extra metadata:

* :class:`~repro_torch.replica.shipper.LogShipper` — tails one log device
  incrementally (``StorageDevice.read_from``) with torn-tail-aware framing:
  a partial trailing record is retried, never decoded.
* :class:`~repro_torch.replica.applier.ReplicaApplier` — folds shipped chunks
  into an :class:`~repro_torch.db.array_table.ArrayTable` with the vectorized
  last-writer-wins replay, carried per-key SSN high-water marks, and the §5
  commit guard as a *visibility* rule (Qwr records held until the shipped
  RSNe passes them).
* :class:`~repro_torch.replica.replica.Replica` — one engine's devices → a
  readable table with the :meth:`~repro_torch.replica.replica.Replica.visible_ssn`
  watermark, checkpoint catch-up, and
  :meth:`~repro_torch.replica.replica.Replica.promote` (byte-identical to
  ``recover()``).
* :class:`~repro_torch.replica.sharded.ShardedReplica` — one pipeline per shard
  plus the cross-shard consistent cut applied continuously
  (``FLAG_XSHARD`` records visible only when shipped-durable from every
  participant); promotes byte-identically to ``recover_sharded()``.
"""

from .applier import ReplicaApplier
from .replica import Replica
from .sharded import ShardedReplica
from .shipper import FileSource, LogShipper, ship_all

__all__ = [
    "FileSource",
    "LogShipper",
    "Replica",
    "ReplicaApplier",
    "ShardedReplica",
    "ship_all",
]
