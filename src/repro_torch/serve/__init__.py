"""OLTP serving tier: open-loop group commit over the Poplar engines.

* :class:`~repro_torch.serve.scheduler.GroupCommitScheduler` — coalesces
  single-transaction client submissions into batched executor calls under a
  latency budget, with admission control, retry-with-backoff, and acks
  gated on the Qww/Qwr committable() rule (ack = durable ∧ committable).
* :class:`~repro_torch.serve.backend.SingleBackend` /
  :class:`~repro_torch.serve.backend.ShardedBackend` — the executor stacks the
  scheduler drives (BatchOCC kernel/vectorized, ScalarBatchOCC, or a
  ShardedEngine).  Both ``make`` entry points run kernel mode on
  ``device="cuda"`` by default and raise without a card unless given
  ``device="cpu"``.
* :class:`~repro_torch.serve.driver.OpenLoopDriver` — Poisson open-loop client
  sessions with coordinated-omission-safe latency accounting.

(The LLM token-serving engine lives in ``repro_torch.models.serve_llm``.)
"""

from .backend import ExecOutcome, ShardedBackend, SingleBackend
from .driver import DriverReport, OpenLoopDriver, run_stepped_schedule
from .scheduler import (
    ABORTED,
    ACKED,
    INFLIGHT,
    QUEUED,
    REJECTED,
    RETRY_WAIT,
    GroupCommitScheduler,
    ServeConfig,
    Ticket,
)

__all__ = [
    "GroupCommitScheduler",
    "ServeConfig",
    "Ticket",
    "SingleBackend",
    "ShardedBackend",
    "ExecOutcome",
    "OpenLoopDriver",
    "DriverReport",
    "run_stepped_schedule",
    "QUEUED",
    "INFLIGHT",
    "RETRY_WAIT",
    "ACKED",
    "ABORTED",
    "REJECTED",
]
