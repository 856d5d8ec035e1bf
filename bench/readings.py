"""The readings that a cell's limits are set from, over many seeds in one
process: the program's numbers (a sound run), the control's (the reference
put in the program's place in float8, ``plain_lm``'s ``fp8``) and, for a
training cell, the program with half of each batch left out.  Benchmark
runs do not run this.

    python3 bench/readings.py --workload <cell> --seeds 1,2,3 [--control] [--half] [--seconds 5]

One JSON line a seed and kind of reading.  A serving cell's window is
``--seconds`` at the cell's own load; the control reads, at each position
of the same prompts and served tokens, the gap of the token that float8
puts first.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time

_HERE = os.path.realpath(os.path.dirname(__file__))
sys.path[:] = [p for p in sys.path if os.path.realpath(p or ".") != _HERE]
ROOT = os.path.dirname(_HERE)
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

from bench import judge, run  # noqa: E402
from bench.drivers import serve as serve_drv  # noqa: E402
from bench.drivers import train as train_drv  # noqa: E402
from bench.weights import allocate, fill  # noqa: E402


def _free(device):
    gc.collect()
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()


@contextlib.contextmanager
def patched(owner, name: str, wrap):
    """``owner.name`` replaced by ``wrap(owner.name)`` while inside."""
    orig = getattr(owner, name)
    setattr(owner, name, wrap(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def half_batch(make_train_step):
    """``make_train_step`` whose steps leave out the second half of each
    batch: the mean is taken over the rest."""
    def make(*a, **kw):
        step = make_train_step(*a, **kw)

        def faulty(params, opt, batch):
            return step(params, opt, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
        return faulty
    return make


def train_readings(ctx, device, control: bool, half: bool):
    st = train_drv.setup(ctx, device)
    kept = train_drv.release(ctx, st)
    del st
    _free(device)
    clip, layers = ctx.traffic["optimizer"]["grad_clip"], kept["layers"]
    ref = train_drv.reference_readings(ctx, kept["batches"], device, keep_first=True)
    ref_first = ref.pop("first")
    cos = lambda first: train_drv.cosines(first, ref_first, layers, device)
    prog_first = train_drv.by_name(kept["first_moment"], layers)
    out = {"program": judge.train_numbers(kept["readings"], ref, layers, clip, cos(prog_first))}
    del prog_first, kept["first_moment"]
    if control:
        _free(device)
        low = train_drv.reference_readings(ctx, kept["batches"], device, precision="fp8",
                                           keep_first=True)
        low_first = low.pop("first")
        out["control"] = judge.train_numbers(_restack(low, layers), ref, layers, clip,
                                             cos(low_first))
        del low_first
    if half:
        _free(device)
        from repro_torch.train import step as step_mod

        with patched(step_mod, "make_train_step", half_batch):
            st = train_drv.setup(ctx, device)
        fault = train_drv.release(ctx, st)
        del st
        _free(device)
        out["half_batch"] = judge.train_numbers(
            fault["readings"], ref, layers, clip, cos(train_drv.by_name(fault["first_moment"], layers)))
    return out


def _restack(per_layer, layers):
    """Reference readings by the reference's names -> by optimizer leaf."""
    stack = lambda d: {leaf: sum(d[n] ** 2 for n in names) ** 0.5 for leaf, names in layers.items()}
    return {"loss": per_layer["loss"], "grad": stack(per_layer["grad"]),
            "delta": stack(per_layer["delta"]), "grad_norm": per_layer["grad_norm"]}


def serve_readings(ctx, device, seconds: float, control: bool):
    from bench.reference.plain_lm import fp32_matmuls

    st = serve_drv.setup(ctx, device)
    serve_drv.window(ctx, st, seconds)
    kept = serve_drv.release(ctx, st)
    del st
    _free(device)
    fp32_matmuls()
    w = allocate(ctx.plist, device)
    fill(w, ctx.plist, ctx.seed)
    rows, gaps, ranks, errs = [], [], [], []
    for prompt, served, first in kept["sample"]:
        ref, row = serve_drv.compare_call(ctx, w, prompt, served, first, device)
        rows.append(row)
        if control:
            low = serve_drv.reference_logits(ctx, w, prompt, served, device, precision="fp8")
            g, r = serve_drv.served_gaps(ref, low.argmax(dim=-1))
            gaps.append(g.flatten().cpu())
            ranks.append(r.flatten().cpu())
            errs.append(serve_drv.logit_errors(low[:, 0], ref[:, 0]))
            del low
        del ref
    del w
    out = {"program": serve_drv.numbers_of(rows)}
    if control:
        out["control"] = (serve_drv.summary(gaps, ranks, errs),
                          {"served_tokens": int(sum(g.numel() for g in gaps))})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--half", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = run.make_ctx(args.workload, seed)
        if ctx.traffic["kind"] == "train":
            out = train_readings(ctx, args.device, args.control, args.half)
        else:
            out = serve_readings(ctx, args.device, args.seconds, args.control)
        for kind, (numbers, detail) in out.items():
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                              "numbers": numbers, "detail": detail,
                              "seconds": time.perf_counter() - t0}), flush=True)
        _free(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
