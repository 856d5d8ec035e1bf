"""Crash flight recorder: the last-known metrics + trace state on disk.

A :class:`FlightRecorder` snapshots the online metrics registry
(`repro_torch.obs.metrics`) and the offline tracer ring (`repro_torch.trace.span`) into
one JSON document and writes it to ``<path>.flight.json`` — on demand
(:meth:`dump`), on an unhandled exception, or on a termination signal
(:meth:`install`).  The dump is the forensic context for
``repro_torch.obs.forensics.explain_recovery``: what the process was doing —
queue depths, flush rates, replica lag, the last ~64k trace spans — at the
moment it died, pinned next to the log bytes recovery will later decode.

Writes are atomic (tmp + rename): a crash *during* the flight dump leaves
either the previous dump or nothing, never a torn JSON.
"""

from __future__ import annotations

import json
import os
import signal as _signal
import sys
import time
from typing import Callable, Dict, List, Optional

from .metrics import REGISTRY, Registry

_SCHEMA = 1


def load_flight(path: str) -> Dict:
    """Load a ``*.flight.json`` dump written by :class:`FlightRecorder`."""
    with open(path) as f:
        return json.load(f)


class FlightRecorder:
    """Snapshot metrics + tracer ring to ``*.flight.json`` on fault/signal.

    ``path`` is the output file (conventionally ending ``.flight.json``;
    the suffix is appended when missing).  ``extra_fn`` optionally
    contributes an application payload (e.g. ``scheduler.stats()``) to every
    snapshot — it runs best-effort: a raising callback is recorded as an
    error string, never propagated from a crash path.
    """

    def __init__(
        self,
        path: str,
        registry: Optional[Registry] = None,
        tracer=None,
        extra_fn: Optional[Callable[[], Dict]] = None,
    ):
        if not path.endswith(".flight.json"):
            path += ".flight.json"
        self.path = path
        self.registry = registry if registry is not None else REGISTRY
        if tracer is None:
            from ..trace.span import TRACER as tracer
        self.tracer = tracer
        self.extra_fn = extra_fn
        self.n_dumps = 0
        self._installed_signals: Dict[int, object] = {}
        self._prev_excepthook: Optional[Callable] = None

    # --- snapshot + dump ---------------------------------------------------
    def snapshot(self, reason: str = "manual") -> Dict:
        """The full flight document (no IO)."""
        doc: Dict = {
            "schema": _SCHEMA,
            "reason": reason,
            "t_unix": time.time(),
            "pid": os.getpid(),
            "metrics": self.registry.snapshot(),
            "trace": self.tracer.dump().to_dict(),
        }
        if self.extra_fn is not None:
            try:
                doc["extra"] = self.extra_fn()
            except Exception as e:
                doc["extra"] = {"error": repr(e)}
        return doc

    def dump(self, reason: str = "manual") -> str:
        """Write the flight document atomically; returns the path."""
        doc = self.snapshot(reason)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self.n_dumps += 1
        return self.path

    # --- fault / signal hooks ----------------------------------------------
    def install(
        self,
        signals: Optional[List[int]] = None,
        exceptions: bool = True,
    ) -> "FlightRecorder":
        """Arm the crash hooks: dump on the given signals (default SIGTERM,
        plus SIGUSR1 as a non-fatal snapshot trigger) and, with
        ``exceptions``, on any unhandled exception.  The previous handlers
        are chained, not replaced: after the dump a fatal signal still
        terminates the process and an exception still prints its traceback.
        Signal handlers only bind from the main thread; elsewhere the
        exception hook alone is installed.
        """
        if signals is None:
            signals = [_signal.SIGTERM]
            if hasattr(_signal, "SIGUSR1"):
                signals.append(_signal.SIGUSR1)
        for sig in signals:
            try:
                prev = _signal.signal(sig, self._on_signal)
            except ValueError:     # not the main thread
                break
            self._installed_signals[sig] = prev
        if exceptions:
            self._prev_excepthook = sys.excepthook
            sys.excepthook = self._on_exception
        return self

    def uninstall(self) -> None:
        for sig, prev in self._installed_signals.items():
            try:
                _signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass
        self._installed_signals.clear()
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None

    def _on_signal(self, signum, frame) -> None:
        try:
            self.dump(reason=f"signal:{_signal.Signals(signum).name}")
        finally:
            prev = self._installed_signals.get(signum)
            if callable(prev):
                prev(signum, frame)
            elif prev == _signal.SIG_DFL and signum != getattr(
                _signal, "SIGUSR1", None
            ):
                # re-deliver with the default disposition: the process dies
                # with the correct wait status, as if never intercepted
                _signal.signal(signum, _signal.SIG_DFL)
                _signal.raise_signal(signum)

    def _on_exception(self, exc_type, exc, tb) -> None:
        try:
            self.dump(reason=f"exception:{exc_type.__name__}")
        except Exception:
            pass                     # never mask the original failure
        hook = self._prev_excepthook or sys.__excepthook__
        hook(exc_type, exc, tb)
