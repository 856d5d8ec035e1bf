"""Poplar - recoverable, partially constrained transaction logging (paper core).

Public surface:

* :class:`~repro_torch.core.engine.PoplarEngine` - the paper's contribution (section 4).
* :class:`~repro_torch.core.engine.EngineConfig`, :class:`~repro_torch.core.engine.Worker`
* :func:`~repro_torch.core.recovery.recover` - section 5 parallel recovery.
* :class:`~repro_torch.core.checkpoint.CheckpointDaemon` - section 5 fuzzy checkpoints.
"""

from .engine import EngineConfig, LoggingEngine, PoplarEngine, Worker
from .recovery import RecoveredState, recover, replay_columnar
from .checkpoint import (
    CheckpointDaemon,
    load_latest_checkpoint,
    load_latest_checkpoint_meta,
)
from .storage import DeviceSpec, StorageDevice, TruncatedLogError, make_devices
from .txn import (
    Txn,
    LogRecord,
    ColumnarLog,
    decode_records,
    decode_columnar,
    decode_columnar_stream,
    encode_batch,
)

__all__ = [
    "EngineConfig",
    "LoggingEngine",
    "PoplarEngine",
    "Worker",
    "recover",
    "replay_columnar",
    "RecoveredState",
    "CheckpointDaemon",
    "load_latest_checkpoint",
    "load_latest_checkpoint_meta",
    "DeviceSpec",
    "StorageDevice",
    "TruncatedLogError",
    "make_devices",
    "Txn",
    "LogRecord",
    "ColumnarLog",
    "decode_records",
    "decode_columnar",
    "decode_columnar_stream",
    "encode_batch",
]
