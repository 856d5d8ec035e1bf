"""Threshold-based health monitors over the live system.

Each :class:`Monitor` reads its component directly (not the metrics
registry — monitors must work whether or not the registry is armed) and
yields structured :class:`HealthEvent`s when a threshold is crossed:

* :class:`ReplicaLagMonitor` — the replica-lag SLO: visible_ssn lag in
  SSNs (shipped-frontier spread the RSNe min-rule is holding back),
  seconds since the watermark last advanced, and ship backlog bytes;
* :class:`TruncationStallMonitor` — a consumer frontier pinning the
  truncator's safe point below the checkpoint RSN for several consecutive
  polls (disk grows without bound until the consumer catches up or is
  unregistered);
* :class:`SaturationMonitor` — serve-tier saturation: admission rejects in
  ``sustain`` consecutive polls (the queue-capacity backpressure signal),
  plus the backend's device-queue saturation flag as an early warning.

:class:`HealthMonitor` aggregates monitors and runs stepped
(:meth:`poll` from tests/drivers) or threaded (:meth:`start`), like every
other daemon in this repo.  Events are kept in a bounded history and
optionally pushed to a callback.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence

from .metrics import REGISTRY

WARN = "warn"
CRIT = "crit"


@dataclass
class HealthEvent:
    """One threshold crossing: what, how bad, and the numbers behind it."""

    kind: str                 # "replica_lag" | "truncation_stall" | "saturation"
    severity: str             # WARN | CRIT
    value: float              # the observed magnitude
    threshold: float          # the configured limit it crossed
    message: str
    t: float = field(default_factory=time.monotonic)

    def to_dict(self) -> Dict:
        return {
            "kind": self.kind, "severity": self.severity,
            "value": self.value, "threshold": self.threshold,
            "message": self.message, "t": self.t,
        }


class Monitor:
    """One health check; subclasses implement :meth:`check`."""

    def check(self) -> List[HealthEvent]:
        raise NotImplementedError


class ReplicaLagMonitor(Monitor):
    """SLO on a :class:`~repro_torch.replica.replica.Replica`'s visibility lag."""

    def __init__(
        self,
        replica,
        max_lag_ssn: Optional[int] = None,
        max_lag_s: Optional[float] = None,
        max_backlog_bytes: Optional[int] = None,
    ):
        self.replica = replica
        self.max_lag_ssn = max_lag_ssn
        self.max_lag_s = max_lag_s
        self.max_backlog_bytes = max_backlog_bytes

    def check(self) -> List[HealthEvent]:
        out: List[HealthEvent] = []
        r = self.replica
        fr = r.shipped_frontiers()
        lag_ssn = (max(fr) if fr else 0) - r.visible_ssn()
        if self.max_lag_ssn is not None and lag_ssn > self.max_lag_ssn:
            out.append(HealthEvent(
                "replica_lag", CRIT, float(lag_ssn), float(self.max_lag_ssn),
                f"visible_ssn lags the shipped frontier by {lag_ssn} SSNs "
                f"(> {self.max_lag_ssn})",
            ))
        lag_s = time.monotonic() - getattr(r, "_w_advance_t", time.monotonic())
        if self.max_lag_s is not None and lag_s > self.max_lag_s:
            out.append(HealthEvent(
                "replica_lag", WARN, lag_s, self.max_lag_s,
                f"watermark has not advanced for {lag_s:.3f}s "
                f"(> {self.max_lag_s}s)",
            ))
        if self.max_backlog_bytes is not None:
            backlog = r.lag_bytes()
            if backlog > self.max_backlog_bytes:
                out.append(HealthEvent(
                    "replica_lag", WARN, float(backlog),
                    float(self.max_backlog_bytes),
                    f"ship backlog {backlog} bytes (> {self.max_backlog_bytes})",
                ))
        return out


class TruncationStallMonitor(Monitor):
    """A consumer frontier pinning the safe point below the checkpoint RSN
    on ``sustain`` consecutive checks (one slow poll is normal; a *sustained*
    pin means the log only grows)."""

    def __init__(self, truncator, max_pin_ssn: int = 0, sustain: int = 2):
        self.truncator = truncator
        self.max_pin_ssn = max_pin_ssn
        self.sustain = max(1, sustain)
        self._streak = 0

    def check(self) -> List[HealthEvent]:
        pin = self.truncator.stall_ssn()
        if pin > self.max_pin_ssn:
            self._streak += 1
        else:
            self._streak = 0
        if self._streak >= self.sustain:
            return [HealthEvent(
                "truncation_stall", CRIT, float(pin), float(self.max_pin_ssn),
                f"safe point pinned {pin} SSNs below the checkpoint RSN for "
                f"{self._streak} consecutive checks "
                f"(frontiers: {self.truncator.registry.frontiers()})",
            )]
        return []


class SaturationMonitor(Monitor):
    """Serve-tier saturation: sustained admission rejects (and, as an early
    warning, device-queue saturation reported by the backend)."""

    def __init__(self, scheduler, sustain: int = 3):
        self.scheduler = scheduler
        self.sustain = max(1, sustain)
        self._last_rejected = scheduler.n_rejected
        self._streak = 0

    def check(self) -> List[HealthEvent]:
        out: List[HealthEvent] = []
        cur = self.scheduler.n_rejected
        delta = cur - self._last_rejected
        self._last_rejected = cur
        if delta > 0:
            self._streak += 1
        else:
            self._streak = 0
        if self._streak >= self.sustain:
            out.append(HealthEvent(
                "saturation", CRIT, float(delta), 0.0,
                f"admission rejecting for {self._streak} consecutive checks "
                f"({delta} rejects since last check, "
                f"{cur} total) — queue capacity saturated",
            ))
        backend = getattr(self.scheduler, "backend", None)
        if backend is not None and getattr(backend, "saturated", None):
            try:
                if backend.saturated():
                    out.append(HealthEvent(
                        "saturation", WARN, 1.0, 0.0,
                        "backend device queues saturated "
                        f"(depths: {backend.queue_depths()})",
                    ))
            except Exception:
                pass  # a mid-teardown backend is not a health signal
        return out


class HealthMonitor:
    """Aggregates monitors; pollable or threaded.

    Every poll appends events to a bounded ``history``, mirrors an event
    counter into the metrics registry when it is armed, and pushes each
    event to ``on_event`` (if given).
    """

    def __init__(
        self,
        monitors: Sequence[Monitor],
        on_event: Optional[Callable[[HealthEvent], None]] = None,
        history: int = 256,
    ):
        self.monitors = list(monitors)
        self.on_event = on_event
        self.history: Deque[HealthEvent] = deque(maxlen=history)
        self.n_polls = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def poll(self) -> List[HealthEvent]:
        self.n_polls += 1
        events: List[HealthEvent] = []
        for m in self.monitors:
            events.extend(m.check())
        for ev in events:
            self.history.append(ev)
            if REGISTRY.enabled:
                REGISTRY.count(f"health.events.{ev.kind}")
            if self.on_event is not None:
                self.on_event(ev)
        return events

    # --- continuous operation (mirrors LogTruncator.start) ---------------
    def start(self, poll_interval: float = 50e-3) -> None:
        self._stop.clear()

        def _loop() -> None:
            while not self._stop.is_set():
                self.poll()
                time.sleep(poll_interval)

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="health-monitor")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
