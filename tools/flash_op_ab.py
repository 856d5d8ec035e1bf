"""Host cost of the flash kernel's dispatcher op, on one card.

    python tools/flash_op_ab.py
    python tools/flash_op_ab.py --root PARENT --root . --root . --root PARENT

On the card ``flash_attention_fwd`` runs its checks and calls the kernel's
launch directly; the port's dispatcher op ``repro_torch::flash_attention``
has a Meta kernel only.  Without ``--root`` this registers the launch as the
CUDA kernel of an op of its own (``flash_op_ab::flash_attention``, the same
schema, a ``torch.library.Library`` kernel as the port's Meta one) and times
the two routes in this tree, the checks and that op (``op``) against the
wrapper (``direct``), in turns (op, direct, direct, op); both must give the
same bits.  Each
``--root`` is a checkout of this repo: in the order given, one fresh process
per root times that tree's ``flash_attention_fwd`` (give parent, change,
change, parent, so that a drift of the machine over the call shows as a
difference between the two readings of one tree).

Every reading is at hymba-1.5b's prefill shape (B=8, S=T=2048, 25 query and
5 KV heads of 64, bfloat16, causal, window 1024 and full, as
``chip_smoke.py``'s first flash cases): ``chip_smoke._median_ms`` (CUDA
events around one call, median of 20 after warm-up: the smoke's ``ms``) and
host microseconds per call (host clock over 200 calls, no synchronisation).
Prints one line per reading and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

HOST_CALLS = 200
WINDOWS = (1024, None)


def _setup(root: str):
    """``root``'s chip_smoke and flash module, and hymba's prefill inputs."""
    root = os.path.abspath(root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, hq, hkv, d = 8, 2048, 25, 5, 64
    qkv = [torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16().transpose(1, 2)
           for h in (hq, hkv, hkv)]
    return torch, cs, fa, qkv


def _reading(torch, cs, fn) -> str:
    ms = cs._median_ms(fn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    torch.cuda.synchronize()
    return f"{ms:.4f} ms (CUDA events, median of 20), host {us:.2f} us per call"


def _cuda_op(torch, fa):
    """The flash launch as the CUDA kernel of ``flash_op_ab::flash_attention``,
    with the port's op's schema (an empty ``lse`` when none is asked for);
    returns the library, which must stay alive, and the op."""
    lib = torch.library.Library("flash_op_ab", "DEF")
    lib.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, int window, "
               "float softcap, bool return_lse) -> (Tensor, Tensor)")

    def kernel(q, k, v, causal, window, softcap, return_lse):
        out, lse = fa._launch(q, k, v, causal, window, softcap, return_lse)
        return out, q.new_empty((0,), dtype=torch.float32) if lse is None else lse

    lib.impl("flash_attention", kernel, "CUDA")
    return lib, torch.ops.flash_op_ab.flash_attention.default


def routes(root: str) -> None:
    torch, cs, fa, (q, k, v) = _setup(root)
    print(cs._smi(), flush=True)
    _lib, op = _cuda_op(torch, fa)
    for window in WINDOWS:
        def through_op():
            fa._check_kernel_inputs(q, k, v, window, None)
            return op(q, k, v, True, int(window or 0), 0.0, False)[0]

        ways = {"op": through_op, "direct": lambda: fa.flash_attention_fwd(q, k, v, window=window)}
        assert torch.equal(ways["op"](), ways["direct"]()), "the two routes differ"
        for name in ("op", "direct", "direct", "op"):
            print(f"flash_op_ab window={window} {name}: {_reading(torch, cs, ways[name])}",
                  flush=True)


def tree(root: str) -> None:
    torch, cs, fa, (q, k, v) = _setup(root)
    for window in WINDOWS:
        reading = _reading(torch, cs, lambda: fa.flash_attention_fwd(q, k, v, window=window))
        print(f"flash_op_ab root={root} window={window}: {reading}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", default=[],
                    help="a checkout whose flash_attention_fwd to time (repeat; in order)")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("flash_op_ab: no CUDA device is available", file=sys.stderr)
        return 1
    if args.child:
        tree(args.child)
        return 0
    if not args.root:
        routes(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        return 0
    for root in args.root:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
