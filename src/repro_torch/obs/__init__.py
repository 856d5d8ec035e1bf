"""Online observability: the process-local metrics registry.

Instrumented hot modules (``core.engine``, ``db.batch``, ...) import
``repro_torch.obs.metrics`` directly.
"""

from .metrics import (  # noqa: F401
    QuantileSketch,
    Registry,
    REGISTRY,
    disable,
    enable,
)

__all__ = ["QuantileSketch", "Registry", "REGISTRY", "disable", "enable"]
