"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (``bench/configs/<config>.json``, its plain
reference ``bench/reference/<config>.py``), a traffic mix
(``bench/traffic/<mix>.json``, whose ``kind`` picks a closed-loop driver of
``bench/drivers/``) and its limits (``bench/limits/<cell>.json``).  The
per-layer metrics are readers of their own: ``bench/metrics/<metric>.py``,
or where none is there ``bench/metrics/<base>.py`` for the part of the
metric's name before its first dot (``idle_pct.train`` -> ``idle_pct``).
Nothing here is particular to a cell.

Set-up (process start to the first measured step) builds the program, makes
its weights and inputs from the seed and warms the cell's shapes.  With
``--trace 0`` the window runs for ``--seconds`` and the end-to-end metrics
are printed; with ``--trace 1`` the mix's traced units run under the CUDA
profiler and the per-layer metrics are printed.  Then the program's state
is freed and the reference judges what the window served.  The last line
of standard output is the result; the last lines of standard error give
each compared number beside its limit.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import sys  # noqa: E402

# run as a script, this folder leads sys.path: take it off, so that none of
# its modules shadows another's name; the harness imports them as bench.*
_HERE = __import__("os").path.realpath(__import__("os").path.dirname(__file__))
sys.path[:] = [p for p in sys.path if __import__("os").path.realpath(p or ".") != _HERE]

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import typing  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
META_KEYS = ("name", "source", "reduced", "source_values", "assumed", "deployment", "departures")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _process_start() -> float:
    """The process's start on the ``perf_counter`` clock (Linux: its start
    tick against the uptime)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return T_IMPORT - max(0.0, age - (time.perf_counter() - T_IMPORT))
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path):
    return json.loads(path.read_text())


def arch_config(cfg):
    """The program's ``ArchConfig`` of a configuration file: every key but
    the file's own notes is a field; a nested group builds the field's
    dataclass."""
    from repro_torch.configs import base

    hints = typing.get_type_hints(base.ArchConfig)
    fields = {f.name for f in dataclasses.fields(base.ArchConfig)}
    unknown = set(cfg) - fields - set(META_KEYS)
    if unknown:
        raise ValueError(f"{cfg['name']}: keys the program does not have: {sorted(unknown)}")
    kw = {}
    for k in fields & set(cfg):
        v = cfg[k]
        if isinstance(v, dict):
            cls = next(a for a in typing.get_args(hints[k]) if dataclasses.is_dataclass(a))
            v = cls(**v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[k] = v
    return base.ArchConfig(**kw)


def make_ctx(workload: str, seed: int, root: Path = ROOT):
    import numpy as np

    spec = _json(root / "BENCHMARK.json")
    cell = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = _json(root / conf["file"])
    ref = _load(root / "bench" / "reference" / f"{cell['config']}.py",
                "bench_reference_" + re.sub(r"\W", "_", cell["config"]))
    traffic = _json(root / "bench" / "traffic" / f"{cell['traffic']}.json")
    limits_file = root / "bench" / "limits" / f"{workload}.json"
    limits = _json(limits_file)["limits"] if limits_file.exists() else {}
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return SimpleNamespace(
        seed=int(seed), data_seed=int(np.random.SeedSequence([int(seed), 1]).generate_state(1)[0]),
        workload=cell, cfg=cfg, arch=arch_config(cfg), ref=ref, plist=ref.param_list(cfg),
        traffic=traffic, limits=limits, end_to_end=e2e, per_layer=per_layer, root=root,
        driver=importlib.import_module(f"bench.drivers.{traffic['kind']}"),
        t_start=_process_start())


def reader_path(root: Path, metric: str) -> Path:
    """A per-layer metric's reader: its own file, else its base name's."""
    own = root / "bench" / "metrics" / f"{metric}.py"
    return own if own.exists() else root / "bench" / "metrics" / f"{metric.split('.')[0]}.py"


def reader(root: Path, metric: str):
    return _load(reader_path(root, metric), "bench_metric_" + re.sub(r"\W", "_", metric))


def _sync(device):
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def run_cell(ctx, seconds: float, trace: bool, device="cuda"):
    """Set-up, the window (or the traced units), then the check.  Returns
    ``(result, rows)``: the result's object and the compared numbers."""
    import torch

    from bench import judge, tracing

    drv = ctx.driver
    st = drv.setup(ctx, device)
    _sync(device)
    setup_s = time.perf_counter() - ctx.t_start
    cuda = str(device).startswith("cuda")
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": int(ctx.workload["chips"])}
    breakdown = None
    if trace:
        readers = {m["name"]: reader(ctx.root, m["name"]) for m in ctx.per_layer}
        ranges = [r for mod in readers.values() for r in mod.RANGES]
        tr = tracing.profile_units(lambda: drv.traced_units(ctx, st), ranges, ctx)
        metrics = {}
        for m in ctx.per_layer:
            v = readers[m["name"]].read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        per = ctx.traffic.get("batch", 1) if ctx.traffic["kind"] == "serve" else 1
        attempted, failed = len(tr.units) * per, 0
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
        del tr
    else:
        res = drv.window(ctx, st, seconds)
        metrics = {k: {"value": v, "unit": u} for k, (v, u) in res["metrics"].items()}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        attempted, failed = res["attempted"], res["failed"]
    device_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated()) if cuda else 0
    kept = drv.release(ctx, st)
    del st
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers, detail = drv.check(ctx, kept, device)
    correct, rows = judge.decide(numbers, ctx.limits)
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    # the numbers not compared, for the record; the compared ones come last
    result["detail"] = {**detail, **{n: v for n, v, lim in rows if lim is None}}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows if lim is not None}
    return result, [r for r in rows if r[2] is not None]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache the program builds lives at a fixed path inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "bench" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "bench" / "triton")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    spec = _json(ROOT / "BENCHMARK.json")
    cell = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = make_ctx(args.workload, args.seed)
    result, rows = run_cell(ctx, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark may not load JAX or the JAX package",
              file=sys.stderr)
        return 3
    sys.stderr.write("".join(f"check {n}: {v!r} limit {lim!r}\n" for n, v, lim in rows))
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
