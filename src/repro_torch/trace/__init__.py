"""Stage-level tracing: the structured span tracer with hook points in the
pipeline stages (`repro_torch.trace.span`)."""

from .span import (  # noqa: F401
    CPU_STAGES,
    STAGE_NAMES,
    ST_ACK,
    ST_APPLY,
    ST_CUT,
    ST_DRIVER,
    ST_ENCODE,
    ST_FLUSH,
    ST_PUBLISH,
    ST_RDECODE,
    ST_RREPLAY,
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
