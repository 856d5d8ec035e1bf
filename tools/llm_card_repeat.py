#!/usr/bin/env python3
"""Repeat the computation of the card test
``tests/test_torch_cuda.py::test_llm_serve_path_on_the_card_matches_the_cpu``
and show where its error against the CPU comes from.

Run from the repository root on a machine with a CUDA card:

    python3 tools/llm_card_repeat.py [--trials 8] [--processes 3]

The test's model and data: reduced hymba-1.5b (head dim 64, 4 query and 2
KV heads), float32, TF32 off, weights from seed 0, tokens from seed 0; a
prefill of 90 tokens into a cache of 128, then 10 decode steps.  The CPU
runs it once (the kernels' plain versions); the card runs it ``--trials``
times in this process, each time on a freshly loaded model, and before
every odd trial the card's free memory is filled with NaN (a kernel that
reads memory it never wrote would then differ); every third trial runs
beside float32 GEMMs that another thread keeps launching on a side stream
(a kernel whose result depends on timing would then differ).  Per trial and output (the
prefill logits, every cache tensor of every layer, each decode step's
logits) it reports the largest ratio |card - cpu| / (atol + rtol |cpu|)
with the test's atol = rtol = 1e-4 (the test fails above 1) and its
element, |card - cpu| at the two cache elements that once broke the limit
in every k and v tensor, and whether the card's outputs equal trial 0's bit
for bit.
The CPU runs it a second time on one thread, to show whether its result
depends on the thread count.  ``--processes`` child processes do the same,
and every process reports the sha256 of its CPU and card outputs, so that
differences between processes
show, with the host's name, CPU model and the vector unit torch's CPU
kernels dispatch to.  The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import platform
import subprocess
import sys
import threading

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402

ATOL = RTOL = 1e-4
PROMPT, TOTAL, CACHE = 90, 100, 128
POISON_BYTES = (512, 4096, 1 << 16, 1 << 20, 1 << 24)   # allocation sizes filled with NaN
POISON_TOTAL = 64 << 20                                  # bytes per size
# the two elements that broke the test's limit once (a k or v cache tensor
# of shape (1, 2, 128, 2, 64): layer-stack, batch, position, KV head, dim)
FAILED_ELEMENTS = ((0, 1, 44, 1, 61), (0, 0, 41, 0, 54))


def _outputs(model, toks, dev):
    """The test's outputs, in order, as CPU tensors keyed by name."""
    out = {}
    logits, caches = model.prefill({"tokens": toks[:, :PROMPT].to(dev)}, CACHE)
    out["prefill.logits"] = logits
    for li, c in enumerate(caches):
        for k, v in c.items():
            out[f"prefill.layer{li}.{k}"] = v
    for i in range(PROMPT, TOTAL):
        logits, caches = model.decode_step(caches, toks[:, i:i + 1].to(dev), i)
        out[f"decode{i}.logits"] = logits
    return {k: v.detach().float().cpu() for k, v in out.items()}


def _digest(outs) -> str:
    h = hashlib.sha256()
    for k in sorted(outs):
        h.update(k.encode())
        h.update(outs[k].numpy().tobytes())
    return h.hexdigest()


def _poison(dev):
    """Fill free blocks of the caching allocator's pools with NaN."""
    for size in POISON_BYTES:
        n = max(1, POISON_TOTAL // size)
        blocks = [torch.full((size // 4,), float("nan"), device=dev) for _ in range(n)]
        del blocks
    torch.cuda.synchronize(dev)


class _Load:
    """Float32 GEMMs on a side stream from another thread, so that the
    trial's kernels run beside other work on the card."""

    def __init__(self, dev):
        self.dev, self.stop = dev, threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        a = torch.randn(2048, 2048, device=self.dev)
        with torch.cuda.stream(torch.cuda.Stream(self.dev)):
            while not self.stop.is_set():
                a = torch.tanh(a @ a)
                torch.cuda.current_stream().synchronize()

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()


def _worst(got, want):
    r = (got - want).abs() / (ATOL + RTOL * want.abs())
    i = int(torch.argmax(r))
    idx = np.unravel_index(i, tuple(want.shape))
    return float(r.reshape(-1)[i]), [int(x) for x in idx], float(got.reshape(-1)[i]), float(want.reshape(-1)[i])


def run(trials: int) -> dict:
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config("hymba-1.5b"), head_dim=64, n_heads=4, n_kv_heads=2)
    cpu = build_model(cfg, device="cpu", dtype=torch.float32).init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, TOTAL)).astype(np.int32))
    want = _outputs(cpu, toks, "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    want_1 = _outputs(cpu, toks, "cpu")
    torch.set_num_threads(threads)
    rows, first = [], None
    for t in range(trials):
        if t % 2:
            _poison(dev)
        loaded = t % 3 == 2
        gpu = build_model(cfg, device=dev, dtype=torch.float32)
        gpu.lm.load_state_dict(cpu.lm.state_dict())
        if loaded:
            with _Load(dev):
                got = _outputs(gpu, toks, dev)
        else:
            got = _outputs(gpu, toks, dev)
        if first is None:
            first = got
        worst = {k: _worst(got[k], want[k]) for k in want}
        name = max(worst, key=lambda k: worst[k][0])
        at_failed = {f"{k}{list(e)}": float((got[k][e] - want[k][e]).abs())
                     for k in want if k.endswith((".k", ".v")) for e in FAILED_ELEMENTS}
        rows.append(dict(trial=t, poisoned=bool(t % 2), loaded=loaded, card_sha256=_digest(got),
                         at_failed_elements=at_failed,
                         equal_to_trial0=all(torch.equal(got[k], first[k]) for k in got),
                         max_ratio=worst[name][0], at=name, element=worst[name][1],
                         card=worst[name][2], cpu=worst[name][3],
                         over_1={k: w[0] for k, w in worst.items() if w[0] > 1.0},
                         per_output={k: w[0] for k, w in worst.items()}))
        del gpu
    return dict(pid=os.getpid(), cpu_sha256=_digest(want), threads=threads,
                cpu_1thread_sha256=_digest(want_1),
                cpu_1thread_vs_threads_max_abs=max(float((want_1[k] - want[k]).abs().max())
                                                   for k in want),
                host=_host(), trials=rows)


def _host() -> dict:
    """The host and the vector unit its CPU matmuls dispatch to."""
    cpu = "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            cpu = next((ln.split(":", 1)[1].strip() for ln in f if ln.startswith("model name")), cpu)
    except OSError:
        pass
    return dict(name=platform.node(), cpu=cpu, capability=torch.backends.cpu.get_cpu_capability())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--processes", type=int, default=3)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("llm_card_repeat: no CUDA device is available", file=sys.stderr)
        return 1
    res = run(args.trials)
    if args.child:
        print(json.dumps(res))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    procs = [res]
    for _ in range(args.processes):
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                            "--trials", str(args.trials)],
                           capture_output=True, text=True, check=True)
        procs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    for p in procs:
        for row in p["trials"]:
            print(f"pid {p['pid']} trial {row['trial']}{' (NaN-filled memory)' if row['poisoned'] else ''}"
                  f"{' (GEMMs beside it)' if row['loaded'] else ''}: "
                  f"max ratio {row['max_ratio']:.4f} at {row['at']}{row['element']} (card "
                  f"{row['card']:.7g}, cpu {row['cpu']:.7g}); equal to trial 0: "
                  f"{row['equal_to_trial0']}; card {row['card_sha256'][:12]}, cpu "
                  f"{p['cpu_sha256'][:12]}; |card - cpu| at the elements that failed once: "
                  f"{max(row['at_failed_elements'].values()):.3g} at most | {smi}")
    print(f"host {res['host']}, {res['threads']} CPU threads; the CPU on 1 thread differs by "
          f"{res['cpu_1thread_vs_threads_max_abs']:.3g} at most | {smi}")
    summary = dict(
        smi=smi, host=res["host"], processes=len(procs), trials_per_process=args.trials,
        cpu_digests=sorted({p["cpu_sha256"] for p in procs}),
        cpu_1thread_digests=sorted({p["cpu_1thread_sha256"] for p in procs}),
        card_digests=sorted({r["card_sha256"] for p in procs for r in p["trials"]}),
        max_ratio=max(r["max_ratio"] for p in procs for r in p["trials"]),
        min_ratio=min(r["max_ratio"] for p in procs for r in p["trials"]),
        failing_trials=sum(bool(r["over_1"]) for p in procs for r in p["trials"]),
        procs=procs)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
