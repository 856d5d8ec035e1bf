"""Online observability: metrics registry, health monitors, crash flight
recorder, and post-crash recovery forensics.

This package is the *runtime* counterpart of the offline tracer in
``repro_torch.trace``: the tracer reconstructs a dependency DAG after the fact,
while ``repro_torch.obs`` keeps always-on aggregates a live system (or a crash
handler) can read right now.

* ``metrics`` — process-local ``REGISTRY`` of counters / gauges / log2
  quantile sketches, zero-alloc when disarmed;
* ``health`` — threshold monitors (replica-lag SLO, truncation stall,
  serve-tier saturation) yielding structured ``HealthEvent``s;
* ``flight`` — crash flight recorder snapshotting the registry and the
  tracer ring to ``*.flight.json`` on fault or signal;
* ``forensics`` — ``explain_recovery()``: a per-gtid kept/dropped verdict
  with the §5 rule that decided it, byte-checked against what
  ``recover()`` / ``recover_sharded()`` actually kept.

Instrumented hot modules (``core.engine``, ``db.batch``, ...) import
``repro_torch.obs.metrics`` directly; everything heavier is resolved lazily here
(PEP 562) so arming a counter never drags the recovery stack into the
import graph.
"""

from .metrics import (  # noqa: F401
    QuantileSketch,
    Registry,
    REGISTRY,
    disable,
    enable,
)

_LAZY = {
    "HealthEvent": "health",
    "HealthMonitor": "health",
    "Monitor": "health",
    "ReplicaLagMonitor": "health",
    "SaturationMonitor": "health",
    "TruncationStallMonitor": "health",
    "FlightRecorder": "flight",
    "load_flight": "flight",
    "GtidVerdict": "forensics",
    "RecoveryExplanation": "forensics",
    "explain_recovery": "forensics",
    "explain_recovery_sharded": "forensics",
}

__all__ = [
    "QuantileSketch", "Registry", "REGISTRY", "disable", "enable",
    *sorted(_LAZY),
]


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)
