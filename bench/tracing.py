"""The traced run: profiler ranges set from outside the program, and what
the per-layer metrics read from the CUDA profiler's events.

A per-layer metric's file (``bench/metrics/<name>.py``) declares the
ranges it reads as ``RANGES``: ``(range, module, attribute, cost)``.  The
range is set where the caller looks the function up (the callers import
these functions by name, so the wrapper goes on the caller's module), for
the traced units only.  ``cost``, where given, takes the call's arguments
and returns ``(flops, bytes, peak)``: the bound of that call.  The copy of
``chip_smoke.py``'s ``_Annotated`` and ``_kernels_under`` is here.

The traced units run twice: first under the profiler's device activity
alone (busy time, window, device operations by name, the units' times:
what a host-paced path costs is not inflated by recording every host
operation), then as many again with host operations recorded and the
ranges set (the kernels of torch ops under each range, and each call's
cost).  A hand-written kernel is launched through the driver API, which
the profiler does not link to its host range, so its device time is read
by its kernel's name in the first pass.
"""

from __future__ import annotations

import bisect
import importlib
import re
from typing import Callable, Dict, List, Optional, Tuple

PREFIX = "bench."


class Ranges:
    """Wrap each named function in a profiler range while inside, and
    record the cost of each call for the ranges that have one."""

    def __init__(self, ranges):
        self.ranges = {}
        for name, module, attr, cost in ranges:
            self.ranges.setdefault(name, (module, attr, cost))
        self.costs: Dict[str, List[Tuple[float, float, float]]] = {n: [] for n in self.ranges}

    def __enter__(self):
        from torch.profiler import record_function

        self._saved = []
        for name, (module, attr, cost) in self.ranges.items():
            owner = importlib.import_module(module)
            *path, last = attr.split(".")
            for part in path:
                owner = getattr(owner, part)
            fn = getattr(owner, last)
            self._saved.append((owner, last, fn))

            def wrapped(*a, _fn=fn, _name=name, _cost=cost, **kw):
                if _cost is not None:
                    self.costs[_name].append(_cost(*a, **kw))
                with record_function(_name):
                    return _fn(*a, **kw)

            setattr(owner, last, wrapped)
        return self

    def __exit__(self, *exc):
        for owner, last, fn in reversed(self._saved):
            setattr(owner, last, fn)


def _union(intervals):
    total, end = 0.0, float("-inf")
    merged = []
    for s, e in sorted(intervals):
        if s > end:
            merged.append([s, e])
            end = e
        elif e > end:
            merged[-1][1] = e
            end = e
    for s, e in merged:
        total += e - s
    return total, merged


class Trace:
    """The events of a traced window, with the cell's shapes and the units
    (steps or calls) it ran."""

    def __init__(self, device_events, window_s, units, events, ranges, ranged_units, ctx):
        from torch.autograd import DeviceType

        self.window_s, self.units, self.ctx = window_s, units, ctx
        self.costs, self.ranged_units = ranges.costs, ranged_units
        # the ranges' own spans on the device timeline are not work
        work = lambda evs: [e for e in evs if e.device_type == DeviceType.CUDA
                            and not e.name.startswith(PREFIX)]
        self.device = work(device_events)
        busy_us, _ = _union((e.time_range.start, e.time_range.end) for e in self.device)
        self.busy_s = busy_us / 1e6
        self.host = [e for e in events if e.device_type == DeviceType.CPU]
        _, self.busy_intervals = _union((e.time_range.start, e.time_range.end) for e in work(events))

    def device_s_under(self, name: str, within: Optional[str] = None) -> Optional[float]:
        """Seconds of the device kernels launched inside every range
        ``name`` (inside a range ``within``, where given); None where no
        such range ran."""
        found, kernels = False, []

        def walk(e, inside):
            nonlocal found
            if e.name == name and inside:
                found = True
                collect(e)
                return
            for ch in e.cpu_children:
                walk(ch, inside or e.name == within)

        def collect(e):
            kernels.extend(e.kernels)
            for ch in e.cpu_children:
                collect(ch)

        roots = [e for e in self.host if e.cpu_parent is None]
        for e in roots:
            walk(e, within is None)
        if not found:
            return None
        return sum(k.duration for k in kernels) / 1e6

    def kernels_named(self, pattern: str) -> Tuple[float, Dict[str, int]]:
        """Seconds of the first pass's device kernels whose name matches
        ``pattern`` (a regular expression, searched), and how many times
        each such name was launched."""
        rx = re.compile(pattern)
        secs, launches = 0.0, {}
        for e in self.device:
            if rx.search(e.name):
                secs += e.time_range.elapsed_us() / 1e6
                launches[e.name] = launches.get(e.name, 0) + 1
        return secs, launches

    def top_device_ops(self, n: int = 10):
        agg: Dict[str, float] = {}
        for e in self.device:
            agg[e.name] = agg.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
        return sorted(([k, v] for k, v in agg.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10, labelled: int = 2000):
        """Idle time on the device by what the host was doing when the
        device went idle: the outermost ``bench.`` range and the innermost
        host operation around the gap's start, for the ``labelled`` longest
        gaps; the shorter ones are summed as one entry."""
        host = sorted(((e.time_range.start, e.time_range.end, e.name) for e in self.host),
                      key=lambda x: x[0])
        starts = [h[0] for h in host]
        gaps = sorted(((s1 - e0, e0) for (_, e0), (s1, _) in
                       zip(self.busy_intervals, self.busy_intervals[1:]) if s1 > e0), reverse=True)
        agg: Dict[str, float] = {}
        for gap, e0 in gaps[:labelled]:
            i = bisect.bisect_right(starts, e0) - 1
            inner, outer = None, None
            for j in range(i, max(-1, i - 400), -1):
                _, he, name = host[j]
                if he >= e0:
                    if inner is None and not name.startswith("cuda"):
                        inner = name
                    if name.startswith(PREFIX):
                        outer = name
            label = f"{outer or '-'} / {inner or '-'}" if inner or outer else "host: no operation"
            agg[label] = agg.get(label, 0.0) + gap / 1e6
        rest = gaps[labelled:]
        if rest:
            agg[f"{len(rest)} shorter gaps"] = sum(g for g, _ in rest) / 1e6
        return sorted(([k, v] for k, v in agg.items()), key=lambda kv: -kv[1])[:n]


def profile_units(run: Callable[[], List[dict]], ranges, ctx) -> Trace:
    """Run ``run`` (the traced units, each ending in a synchronise) under
    the CUDA profiler's device activity, then again with host operations
    recorded and ``ranges`` set."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        units = run()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    device_events = prof.events()
    rg = Ranges(ranges)
    with rg, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ranged_units = run()
        torch.cuda.synchronize()
    return Trace(device_events, window_s, units, prof.events(), rg, ranged_units, ctx)
