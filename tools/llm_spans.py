"""What the program's spans read on the card for one benchmark cell, and
what tracing costs there.

    python3 tools/llm_spans.py --workload mixtral-8x22b.decode --seed 7 --units 3

Sets the cell up as ``bench/run.py`` does, then runs its traced units
(``bench/drivers/<kind>.py``'s ``traced_units``) three ways, each
``--units`` rounds:

* ``off``: the tracer off, nothing recording: each unit's seconds;
* ``spans``: the tracer on without ranges or a profiler (the benchmark's
  span pass): each unit's seconds, and per stage the spans' count, median
  host ms and device ms per unit; then each unit's seconds with the spans'
  CUDA events left out;
* ``ranged``: the tracer on with ranges, under the CUDA profiler with host
  operations recorded, once: how far each ring row's host interval, taken
  onto the profiler's clock, lies from its ``repro_torch.<stage>`` range
  (median and largest gap, us, at each end), the device's idle time by the
  innermost program span open on the host when the device went idle, and
  the device ms by chain of program stages (``bench/program.py``); with
  ``--tree`` each stage's ms from the profiler's own event tree beside.

Prints one JSON line.  Needs a card.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _units(run, rounds):
    import torch

    out = []
    for _ in range(rounds):
        out += [u["seconds"] for u in run()]
        torch.cuda.synchronize()
    return out


def _by_stage(dump, units):
    import numpy as np

    from repro_torch.trace.span import STAGE_NAMES

    out = {}
    for s in np.unique(dump.stage):
        rows = dump.stage == s
        dev = np.nansum(dump.dev_t1[rows] - dump.dev_t0[rows])
        out[STAGE_NAMES[s]] = dict(
            spans=int(rows.sum()),
            host_ms_median=float(1e3 * np.median(dump.t1[rows] - dump.t0[rows])),
            device_ms_per_unit=float(1e3 * dev / units))
    return out


def _raw(events, cuda: bool):
    from torch.autograd import DeviceType

    want = DeviceType.CUDA if cuda else DeviceType.CPU
    return [e for e in events if e.device_type() == want]


def _alignment(dump, events):
    """Gaps (us) between each ring row's host interval, taken onto the
    profiler's clock (epoch ns), and its ``repro_torch.<stage>`` range."""
    import numpy as np

    from repro_torch.trace.span import RANGE_PREFIX, STAGE_NAMES

    ranges = sorted((e for e in _raw(events, False) if e.name().startswith(RANGE_PREFIX)),
                    key=lambda e: e.start_ns())
    if len(ranges) != dump.n:
        return {"ranges": len(ranges), "rows": int(dump.n)}
    t0 = (dump.t0 + dump.clock_offset) * 1e9
    t1 = (dump.t1 + dump.clock_offset) * 1e9
    gaps = np.array([((t0[i] - e.start_ns()) / 1e3, (e.end_ns() - t1[i]) / 1e3)
                     for e, i in zip(ranges, np.argsort(t0, kind="stable"))
                     if e.name() == RANGE_PREFIX + STAGE_NAMES[dump.stage[i]]])
    a = np.abs(gaps)
    return dict(rows=int(dump.n), matched=len(gaps), median_us=np.median(a, axis=0).tolist(),
                max_us=a.max(axis=0).tolist(), signed_median_us=np.median(gaps, axis=0).tolist())


def _idle_by_span(events, top: int = 12):
    """Idle seconds between the device's busy intervals, by the innermost
    ``repro_torch.`` range open on the host at each gap's start."""
    from bench.tracing import _union

    _, busy = _union((e.start_ns(), e.end_ns()) for e in _raw(events, True)
                     if not e.name().startswith(("repro_torch.", "bench.")))
    spans = sorted((e.start_ns(), e.end_ns(), e.name()) for e in _raw(events, False)
                   if e.name().startswith("repro_torch."))
    starts = [s[0] for s in spans]
    agg = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        if s1 <= e0:
            continue
        label = "-"
        for j in range(bisect.bisect_right(starts, e0) - 1, -1, -1):
            if spans[j][1] >= e0:      # nested spans start later: the first found is innermost
                label = spans[j][2]
                break
        agg[label] = agg.get(label, 0.0) + (s1 - e0) / 1e9
    return sorted(([k, v] for k, v in agg.items()), key=lambda kv: -kv[1])[:top]


def _tree_check(prof, by_chain, seen):
    """Device ms under each program stage's ranges, from the raw events'
    chains and from the profiler's own event tree (``bench/tracing.py``)."""
    from bench.tracing import Ranges, Trace

    events = prof.events()
    tr = Trace(events, 0.0, [], events, Ranges(()), [], None)
    return {s: [1e3 * sum(v for c, v in by_chain.items() if s in c),
                1e3 * (tr.device_s_under("repro_torch." + s) or 0.0)] for s in sorted(seen)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--units", type=int, default=2, help="rounds of the traced units a way")
    ap.add_argument("--tree", action="store_true",
                    help="also read each stage from the profiler's event tree (slow)")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bench import program, run
    from repro_torch.trace import span

    ctx = run.make_ctx(args.workload, args.seed)
    drv = ctx.driver
    t0 = time.perf_counter()
    st = drv.setup(ctx, "cuda")
    torch.cuda.synchronize()
    out = {"workload": args.workload, "seed": args.seed, "setup_s": time.perf_counter() - t0,
           "device": torch.cuda.get_device_name(0)}
    units = lambda: drv.traced_units(ctx, st)
    out["off_unit_s"] = _units(units, args.units)
    span.enable(capacity=1 << 20)
    out["spans_unit_s"] = _units(units, args.units)
    dump = span.disable()
    out["by_stage"] = _by_stage(dump, len(out["spans_unit_s"]))
    span.enable(capacity=1 << 20)
    span.TRACER.card = False            # the spans without their CUDA events
    out["spans_no_events_unit_s"] = _units(units, args.units)
    span.disable()
    out["off_unit_s"] += _units(units, args.units)      # off again, after: a drift shows
    span.enable(capacity=1 << 20, ranges=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        units()
        torch.cuda.synchronize()
    dump = span.disable()
    events = prof.profiler.kineto_results.events()
    out["alignment"] = _alignment(dump, events)
    out["idle_by_span_s"] = _idle_by_span(events)
    by_chain, seen = program.chains(events)
    out["device_ms_by_chain"] = sorted(([" / ".join(c), 1e3 * v] for c, v in by_chain.items()),
                                       key=lambda kv: -kv[1])[:16]
    if args.tree:
        out["stage_ms_chains_vs_tree"] = _tree_check(prof, by_chain, seen)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
