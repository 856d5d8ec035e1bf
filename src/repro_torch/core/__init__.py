"""Poplar - recoverable, partially constrained transaction logging (paper core).

Public surface:

* :class:`~repro_torch.core.engine.PoplarEngine` - the paper's contribution (section 4).
* :class:`~repro_torch.core.engine.EngineConfig`, :class:`~repro_torch.core.engine.Worker`
* Baselines (sections 3.3/6.1): :class:`~repro_torch.core.variants.CentrEngine`,
  :class:`~repro_torch.core.variants.SiloEngine`, :class:`~repro_torch.core.variants.NvmDEngine`
* :func:`~repro_torch.core.recovery.recover` - section 5 parallel recovery.
* :class:`~repro_torch.core.checkpoint.CheckpointDaemon` - section 5 fuzzy checkpoints.
* :mod:`~repro_torch.core.levels` - section 3.1 constraint-level checkers.
"""

from .engine import EngineConfig, LoggingEngine, PoplarEngine, Worker
from .variants import CentrEngine, NvmDEngine, SiloEngine
from .recovery import RecoveredState, recover, replay_columnar
from .checkpoint import (
    CheckpointDaemon,
    load_latest_checkpoint,
    load_latest_checkpoint_meta,
)
from .storage import DeviceSpec, StorageDevice, TruncatedLogError, make_devices
from .truncate import FrontierRegistry, LogTruncator, ShardedLogTruncator
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
    "CentrEngine",
    "SiloEngine",
    "NvmDEngine",
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
    "FrontierRegistry",
    "LogTruncator",
    "ShardedLogTruncator",
    "Txn",
    "LogRecord",
    "ColumnarLog",
    "decode_records",
    "decode_columnar",
    "decode_columnar_stream",
    "encode_batch",
]
