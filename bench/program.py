"""What the program's own tracer records over a traced run: two more passes
of the traced units, after the harness's two (``bench/tracing.py``), run
once a traced run by the first reader that asks and kept on its trace.

* The ranged pass: the program's tracer on with profiler ranges
  (``repro_torch.<stage>``) under the CUDA profiler, host operations
  recorded.  Each device operation goes to the chain of program ranges
  open around the host operation that launched it, on that operation's
  thread; the profiler's own event tree is never built, so the pass costs
  the run and a walk over the raw events.
* The span pass: the tracer on without ranges and without a profiler,
  what an operator with tracing on sees: the ring (host stamps, and each
  span's device interval from its CUDA event pair) and the registry's
  ``llm.*`` counters added over the pass.  It runs first, with the objects
  alive before it frozen out of the garbage collector's scans.

A reader is handed only the trace; the passes run the driver's live state
again (the one ``State`` of ``bench/drivers/<kind>.py``, found among the
live objects).  Where the program has no spans (``Tracer.span``) or no
one state is found, the passes give nothing and every reader of this
module returns None.
"""

from __future__ import annotations

import bisect
import gc
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

RANGE = "repro_torch."


@dataclass
class Ranged:
    """The ranged pass: device seconds by the chain of program stages open
    around each device operation's launch (outermost first), the stages
    whose ranges ran, and the pass's units."""

    by_chain: Dict[Tuple[str, ...], float]
    seen: set
    units: List[dict]


@dataclass
class Program:
    """The two passes' readings: the ranged pass (None where it did not
    run), the span pass's ring, counters and units."""

    ranged: Optional[Ranged]
    dump: object
    counters: Dict[str, float]
    units: List[dict]


def _state(trace):
    """The driver's live state: its one ``State`` object."""
    cls = getattr(trace.ctx.driver, "State", None)
    found = [o for o in gc.get_objects() if type(o) is cls] if cls is not None else []
    return found[0] if len(found) == 1 else None


def _has_spans() -> bool:
    from repro_torch.trace import span

    return hasattr(span.Tracer, "span") and "moe_route" in span.STAGE_NAMES


def chains(events) -> Tuple[Dict[Tuple[str, ...], float], set]:
    """Device seconds of the raw profiler ``events`` (``kineto_results.events()``)
    by the chain of ``repro_torch.`` ranges open around the host operation
    each device operation is linked to, on that operation's thread; and the
    stages whose ranges ran.  A device operation linked to no host
    operation (a driver-API launch) goes to the empty chain."""
    from torch.autograd import DeviceType

    ranges, ops, dev = {}, {}, []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if e.linked_correlation_id() == 0:             # an operation or a range
                t = e.start_thread_id()
                if name.startswith(RANGE):
                    ranges.setdefault(t, []).append((e.start_ns(), e.end_ns(), name[len(RANGE):]))
                ops[e.correlation_id()] = (t, e.start_ns())
        elif not name.startswith((RANGE, "bench.")):      # not a range's own span
            dev.append((e.linked_correlation_id(), e.end_ns() - e.start_ns()))
    index = {}
    for t, rs in ranges.items():
        rs.sort()
        parent, stack = [], []
        for i, (s, _, _) in enumerate(rs):
            while stack and rs[stack[-1]][1] <= s:
                stack.pop()
            parent.append(stack[-1] if stack else -1)
            stack.append(i)
        index[t] = ([r[0] for r in rs], rs, parent)
    out: Dict[Tuple[str, ...], float] = {}
    for corr, ns in dev:
        chain = ()
        t, s = ops.get(corr, (None, 0))
        if t in index:
            starts, rs, parent = index[t]
            i = bisect.bisect_right(starts, s) - 1
            while i >= 0 and rs[i][1] <= s:    # a range closed before: its parent may hold s
                i = parent[i]
            names = []
            while i >= 0:
                names.append(rs[i][2])
                i = parent[i]
            chain = tuple(reversed(names))
        out[chain] = out.get(chain, 0.0) + ns / 1e9
    return out, {r[2] for rs in ranges.values() for r in rs}


def _ranged_pass(run) -> Ranged:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.trace import span

    torch.cuda.synchronize()
    span.enable(ranges=True)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            units = run()
            torch.cuda.synchronize()
    finally:
        span.disable()
    by_chain, seen = chains(prof.profiler.kineto_results.events())
    return Ranged(by_chain, seen, units)


def _span_pass(run):
    import torch

    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.trace import span

    torch.cuda.synchronize()
    before = dict(REGISTRY.counters)
    # the harness's profiler events stay alive beside the pass: keep them
    # out of the collector's scans, so its host times are the program's
    gc.collect()
    gc.freeze()
    span.enable(capacity=1 << 18)
    try:
        units = run()
        torch.cuda.synchronize()
    finally:
        dump = span.disable()          # collects the event pairs after the synchronise
        gc.unfreeze()
    counters = {k: v - before.get(k, 0) for k, v in REGISTRY.counters.items()
                if k.startswith("llm.")}
    return dump, counters, units


def of(trace) -> Optional[Program]:
    """The program's passes over ``trace``'s units, run on the first call."""
    if "program" not in vars(trace):
        trace.program = None
        st = _state(trace) if _has_spans() else None
        if st is not None:
            run = lambda: trace.ctx.driver.traced_units(trace.ctx, st)
            spans = _span_pass(run)
            trace.program = Program(_ranged_pass(run), *spans)
    return trace.program


def _stage(name: str) -> int:
    from repro_torch.trace import span

    return span.STAGE_NAMES.index(name)


def device_ms_per_unit(trace, stage: str) -> Optional[float]:
    """Device ms of the span pass's ``stage`` spans (each span's event
    pair), per unit."""
    p = of(trace)
    if p is None or not p.units:
        return None
    d = p.dump
    rows = d.stage == _stage(stage)
    dev = d.dev_t1[rows] - d.dev_t0[rows]
    if not rows.any() or np.isnan(dev).any():
        return None
    return 1e3 * float(dev.sum()) / len(p.units)


def kernels_ms(trace, stages, within: Optional[str] = None, per: Optional[int] = None):
    """Device ms of the ranged pass's operations under the program's ranges
    of ``stages`` (inside a ``within`` range, where given), per unit (or per
    ``per``); None where a stage's range never ran."""
    p = of(trace)
    if p is None or p.ranged is None:
        return None
    r = p.ranged
    n = len(r.units) if per is None else per
    if not set(stages) <= r.seen or (within and within not in r.seen) or not n:
        return None
    secs = sum(v for chain, v in r.by_chain.items()
               if any(s in chain for s in stages) and (within is None or within in chain))
    return 1e3 * secs / n


def drop_pct(trace, phase: str) -> Optional[float]:
    """The MoE's dropped over routed (token, slot) pairs in ``phase``
    (the outermost span's stage) over the span pass, in %."""
    p = of(trace)
    if p is None:
        return None
    routed = p.counters.get(f"llm.moe.slots_routed.{phase}", 0)
    if routed <= 0:
        return None
    return 100.0 * p.counters.get(f"llm.moe.slots_dropped.{phase}", 0) / routed


def token_intervals_ms(trace) -> Optional[np.ndarray]:
    """Per call of the span pass, the device ms between consecutive ends of
    its ``prefill`` and ``decode_step`` spans: one interval an output token
    after the first."""
    p = of(trace)
    if p is None:
        return None
    d = p.dump
    out = []
    top = (d.parent == -1) & np.isin(d.stage, [_stage("prefill"), _stage("decode_step")])
    for unit in np.unique(d.batch[top]):
        ends = d.dev_t1[top & (d.batch == unit)]
        if len(ends) < 2 or np.isnan(ends).any():
            return None
        out.append(np.diff(ends))
    return 1e3 * np.concatenate(out) if out else None


def host_ms(trace, stage: str) -> Optional[np.ndarray]:
    """Host ms of each of the span pass's ``stage`` spans."""
    p = of(trace)
    if p is None:
        return None
    d = p.dump
    rows = d.stage == _stage(stage)
    return 1e3 * (d.t1[rows] - d.t0[rows]) if rows.any() else None
