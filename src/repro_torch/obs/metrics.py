"""Process-local online metrics: counters, gauges, and a streaming
log2-bucketed quantile sketch.

This is the *runtime* counterpart of ``repro.trace.span``: where the tracer
captures per-span structure for post-hoc analysis, the registry keeps cheap
always-on aggregates (flush bytes per device, validate win rates, replica
lag, queue depth, ack-latency quantiles) that health monitors and the crash
flight recorder can snapshot at any moment.

The cost discipline is identical to the tracer's:

* a single module-level ``REGISTRY`` with an ``enabled`` bool;
* every hook in hot code is guarded by ``if REGISTRY.enabled:`` so the
  disarmed path is one attribute load and a false branch — measured
  zero-alloc by ``tests/test_obs.py`` with a tracemalloc filter pinned to
  this file, mirroring ``test_trace.py``;
* armed mutations take one short-lived lock per *event* (events are batch-
  or flush-granular, never per-key), keeping armed overhead under the 3%
  budget on the fig5 batch loop.

The quantile sketch is a fixed array of 64 power-of-two buckets indexed by
the binary exponent of the observed value: O(1) record, O(1) memory, no
stored samples, and any quantile is reconstructed to within the bucket
width (a factor of 2 relative error bound, typically much tighter because
the reported value is the geometric bucket midpoint).
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

# Bucket b of the sketch covers values v with frexp-exponent b + _E_LO,
# i.e. v in [2^(b+_E_LO-1), 2^(b+_E_LO)).  With _E_LO = -40 the 64 buckets
# span ~9.1e-13 .. ~8.4e6 — sub-picosecond to ~97 days when observing
# seconds, and 1 .. 8.4M when observing integer lags.  Out-of-range values
# clamp to the edge buckets (their mass is still counted; min/max/sum stay
# exact).
_N_BUCKETS = 64
_E_LO = -40


class QuantileSketch:
    """Streaming histogram over power-of-two buckets.

    ``record`` is O(1) and allocation-free after construction; quantiles
    are interpolated from cumulative bucket counts.  ``count``/``total``/
    ``min``/``max`` are exact; a quantile is exact to within its bucket
    (ratio to the true sample quantile bounded by 2x either way).
    """

    __slots__ = ("counts", "count", "total", "vmin", "vmax")

    def __init__(self) -> None:
        self.counts = np.zeros(_N_BUCKETS, dtype=np.int64)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def _bucket(self, v: float) -> int:
        if v <= 0.0:
            return 0
        e = math.frexp(v)[1] - _E_LO
        if e < 0:
            return 0
        if e >= _N_BUCKETS:
            return _N_BUCKETS - 1
        return e

    def record(self, v: float) -> None:
        v = float(v)
        self.counts[self._bucket(v)] += 1
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def record_many(self, values: Sequence[float]) -> None:
        """Vectorized ``record`` — one bincount for a whole batch."""
        a = np.asarray(values, dtype=np.float64)
        if a.size == 0:
            return
        _, e = np.frexp(np.maximum(a, 0.0))
        idx = np.clip(e - _E_LO, 0, _N_BUCKETS - 1)
        idx[a <= 0.0] = 0
        self.counts += np.bincount(idx, minlength=_N_BUCKETS)
        self.count += int(a.size)
        self.total += float(a.sum())
        self.vmin = min(self.vmin, float(a.min()))
        self.vmax = max(self.vmax, float(a.max()))

    @staticmethod
    def _bucket_mid(b: int) -> float:
        # geometric midpoint of [2^(e-1), 2^e) for e = b + _E_LO
        return math.ldexp(1.0, b + _E_LO) * (0.5 * math.sqrt(2.0))

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1]; 0.0 when empty."""
        if self.count == 0:
            return 0.0
        if q <= 0.0:
            return self.vmin          # the extremes are tracked exactly
        if q >= 1.0:
            return self.vmax
        rank = q * (self.count - 1)
        cum = 0
        for b in range(_N_BUCKETS):
            c = int(self.counts[b])
            if c == 0:
                continue
            cum += c
            if cum > rank:
                v = self._bucket_mid(b)
                # clamp to the exact observed range so p0/p100 are exact
                return min(max(v, self.vmin), self.vmax)
        return self.vmax

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0}
        return {
            "count": int(self.count),
            "sum": float(self.total),
            "mean": self.mean(),
            "min": float(self.vmin),
            "max": float(self.vmax),
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
        }

    def reset(self) -> None:
        self.counts[:] = 0
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf


class Registry:
    """Named counters, gauges, and sketches behind one ``enabled`` switch.

    All mutators are safe to call whether or not the registry is enabled;
    the ``enabled`` guard lives at the *call sites* so that disarmed hot
    paths never enter this module at all (the zero-alloc contract).
    """

    def __init__(self) -> None:
        self.enabled = False
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.sketches: Dict[str, QuantileSketch] = {}
        self._callbacks: Dict[str, Callable[[], float]] = {}
        self._device: Dict[str, object] = {}     # device tensors (add_device)

    # --- mutators (armed hot path: one lock per batch-granular event) ----

    def count(self, name: str, delta: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + delta

    def add_device(self, name: str, value) -> None:
        """Add a device tensor (a count, or counts to sum) into counter
        ``name``'s accumulator on that device, without waiting for the
        device; :meth:`fold_device` moves the accumulators into the
        counters."""
        import torch

        with self._lock:
            acc = self._device.get(name)
            if acc is None:
                acc = self._device[name] = torch.zeros((), dtype=torch.int64,
                                                       device=value.device)
            acc += value if value.dim() == 0 else value.sum()

    def fold_device(self) -> None:
        """Add each device accumulator into its counter and drop it.  Reading
        an accumulator waits for the device work enqueued before it: call
        this once that work is known to be done (``Tracer.collect``)."""
        with self._lock:
            accs, self._device = self._device, {}
        for name, acc in accs.items():
            self.count(name, int(acc))

    def gauge_set(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = value

    def gauge_max(self, name: str, value: float) -> None:
        with self._lock:
            cur = self.gauges.get(name)
            if cur is None or value > cur:
                self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            sk = self.sketches.get(name)
            if sk is None:
                sk = self.sketches[name] = QuantileSketch()
            sk.record(value)

    def observe_many(self, name: str, values: Sequence[float]) -> None:
        with self._lock:
            sk = self.sketches.get(name)
            if sk is None:
                sk = self.sketches[name] = QuantileSketch()
            sk.record_many(values)

    # --- derived gauges (evaluated at snapshot time) ---------------------

    def register_callback(self, name: str, fn: Callable[[], float]) -> None:
        """Register a pull gauge, sampled on every ``snapshot()``."""
        with self._lock:
            self._callbacks[name] = fn

    def unregister_callback(self, name: str) -> None:
        with self._lock:
            self._callbacks.pop(name, None)

    # --- read side -------------------------------------------------------

    def sketch(self, name: str) -> QuantileSketch:
        with self._lock:
            sk = self.sketches.get(name)
            if sk is None:
                sk = self.sketches[name] = QuantileSketch()
            return sk

    def counter_value(self, name: str) -> float:
        with self._lock:
            return self.counters.get(name, 0)

    def gauge_value(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self.gauges.get(name, default)

    def snapshot(self) -> Dict[str, Dict]:
        """Deterministically ordered point-in-time view of every metric.

        Pull-gauge callbacks are evaluated best-effort (a failing callback
        is reported as the string form of its exception rather than taking
        down a crash-path snapshot).
        """
        with self._lock:
            cbs = list(self._callbacks.items())
            counters = dict(sorted(self.counters.items()))
            gauges = dict(sorted(self.gauges.items()))
            sketches = {k: self.sketches[k].summary()
                        for k in sorted(self.sketches)}
        for name, fn in sorted(cbs):
            try:
                gauges[name] = fn()
            except Exception as e:  # crash-path snapshots must not raise
                gauges[name] = f"<callback error: {e!r}>"
        return {"counters": counters, "gauges": gauges, "sketches": sketches}

    def reset(self) -> None:
        """Drop every metric (callbacks stay registered)."""
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.sketches.clear()
            self._device.clear()


#: process-wide registry, disarmed by default (hooks reduce to a bool load)
REGISTRY = Registry()


def enable(reset: bool = True) -> Registry:
    """Arm the process registry (optionally clearing prior metrics)."""
    if reset:
        REGISTRY.reset()
    REGISTRY.enabled = True
    return REGISTRY


def disable() -> Dict[str, Dict]:
    """Disarm the registry and return a final snapshot."""
    REGISTRY.enabled = False
    return REGISTRY.snapshot()
