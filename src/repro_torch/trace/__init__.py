"""Stage-level tracing, dependency-DAG cost model, and what-if simulator.

The observability subsystem: a near-zero-overhead
structured tracer with hook points in all seven pipeline stages
(`repro_torch.trace.span`), a dependency-DAG builder with critical-path
extraction (`repro_torch.trace.dag`), a discrete-event replay simulator that
predicts txn/s and commit latency for a hypothetical configuration without
running the engine (`repro_torch.trace.sim`), and an autotuner sweeping the
simulator to pick batch size and device count per workload
(`repro_torch.trace.tune`).
"""

from .span import (  # noqa: F401
    CPU_STAGES,
    LLM_STAGES,
    STAGE_NAMES,
    ST_ACK,
    ST_APPLY,
    ST_BACKWARD,
    ST_CUT,
    ST_DECODE_STEP,
    ST_DRIVER,
    ST_ENCODE,
    ST_FLASH_BWD,
    ST_FLUSH,
    ST_FORWARD,
    ST_MOE_DISPATCH,
    ST_MOE_ROUTE,
    ST_OPTIMIZER,
    ST_PREFILL,
    ST_PUBLISH,
    ST_RDECODE,
    ST_RREPLAY,
    ST_SCAN_BWD,
    ST_SEQUENCE,
    ST_SHIP,
    ST_VALIDATE,
    ST_WRITEBACK,
    ST_XPREPARE,
    TRACER,
    TraceDump,
    Tracer,
    disable,
    enable,
)
from .dag import TraceDAG, build_dag, critical_path  # noqa: F401
from .sim import (  # noqa: F401
    CostModel,
    SimConfig,
    SimResult,
    WorkloadProfile,
    simulate,
    simulate_dag,
)
from .tune import TuneResult, autotune  # noqa: F401
