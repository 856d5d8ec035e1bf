"""Training step times of two trees side by side, on one card.

    python tools/train_path_ab.py --root PARENT --root . --root . --root PARENT \\
        --arch tinyllama-1.1b --arch hymba-1.5b --layers 0 --out train_ab.jsonl

Each ``--root`` is a checkout of this repo (its ``chip_smoke.py`` and
``src/``).  In the order given, one fresh process per root builds that
tree's kernels and runs that tree's own ``chip_smoke.run_train_path`` for
each ``--arch`` with the journal off (the gradient oracle, run A's steps,
the profiled step; a journaled run would log 11-13 GB a tree and arch),
then its ``_flash_case`` at
tinyllama-1.1b's training shape (B=8, S=T=2048, 32/4 heads of 64, causal,
bfloat16), whose ``bwd_ms`` times the torch-op attention backward
(``models/attention.py::_flash_bwd``) alone.  Prints one line per (root,
arch) with every step's ms, and appends the JSON rows to ``--out``.  Each
tree runs an arch at its own ``TrainRun`` depth unless ``--layers N`` sets
it for every tree (0: full depth).  Give parent, change, change, parent, so
that a drift of the machine over the call shows as a difference between
the two readings of one tree.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

KEEP = ("arch", "step_ms_each", "step_ms", "tokens_per_s", "peak_gib", "seconds", "profile")


def child(root: str, archs, seed: int, layers) -> int:
    root = os.path.abspath(root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch
    import chip_smoke as cs

    smi = cs._smi()
    t0 = time.perf_counter()
    cs.kcuda.build()
    cs.kcuda.lib()
    build_s = time.perf_counter() - t0
    for arch in archs:
        run = dataclasses.replace(next(r for r in cs.TRAIN_RUNS if r.arch == arch),
                                  journal=(), saves=())
        if layers is not None:
            run = dataclasses.replace(run, layers=layers)
        workdir = tempfile.mkdtemp(prefix="train_ab-")
        cs.kcuda.reset_launches()
        train = cs.run_train_path(workdir, seed, smi, run)
        row = {k: v for k, v in train.items() if k in KEEP}
        print("train_ab " + json.dumps(dict(root=root, build_s=build_s, smi=smi, **row),
                                       default=float), flush=True)
        torch.cuda.empty_cache()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    case = cs._flash_case(gen, cs.TRAIN_BATCH, cs.TRAIN_SEQ, None, torch.bfloat16, dev,
                          hq=32, hkv=4, d=64, train=True)
    print("train_ab " + json.dumps(dict(root=root, smi=smi, arch="flash_bwd", shape=case["shape"],
                                        bwd_ms=case["bwd_ms"], sdpa_bwd_ms=case["sdpa_bwd_ms"]),
                                   default=float), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", required=True)
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    archs = args.arch or ["tinyllama-1.1b", "hymba-1.5b"]
    if args.child:
        return child(args.child, archs, args.seed, args.layers)
    rows = []
    for i, root in enumerate(args.root):
        cmd = [sys.executable, os.path.abspath(__file__), "--root", root, "--child", root,
               "--seed", str(args.seed)] + [a for arch in archs for a in ("--arch", arch)]
        if args.layers is not None:
            cmd += ["--layers", str(args.layers)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], sep="\n", file=sys.stderr)
            return res.returncode
        for line in res.stdout.splitlines():
            if line.startswith("train_ab "):
                rows.append(dict(json.loads(line[len("train_ab "):]), order=i))
    for r in rows:
        if r["arch"] == "flash_bwd":
            print(f"[{r['order']}] {r['root']}: _flash_bwd {r['bwd_ms']:.3f} ms, SDPA backward "
                  f"{r['sdpa_bwd_ms']:.3f} ms ({r['shape']}) | {r['smi']}")
        else:
            prof = r.get("profile", {})
            print(f"[{r['order']}] {r['root']}: {r['arch']} step {r['step_ms']:.1f} ms (each "
                  f"{[round(x, 1) for x in r['step_ms_each']]}), busy "
                  f"{prof.get('busy', float('nan')):.3f} of the profiled step, device ms "
                  f"{prof.get('device_ms')}, peak {r.get('peak_gib', 0):.2f} GiB, path "
                  f"{r['seconds']:.1f} s | {r['smi']}")
    if args.out:
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r, default=float) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
