#!/usr/bin/env python3
"""Time the kept bf16 flash attention kernel at head dim 160 beside
text-patched copies of it: a design measured and not kept, and copies with
one step taken out.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 tools/flash_variants.py

Each variant is the kept source ``src/repro_torch/kernels/csrc/
flash_attention.cu`` with a few text replacements (each must match the
source exactly once, or the tool stops), built into its own library and
driven through the port's own wrapper at stablelm-12b's prefill shape (B=8,
S=T=2048, 32 query / 8 KV heads of 160, causal, bfloat16, the model's
layout).  Variants:

- ``kept``: the source as it is (64-key K/V tiles, two Q stages).
- ``keys128_one_stage``: K/V tiles of 128 keys in a ring of one stage,
  which fits the same shared memory (204,800 B): a tile's loads wait for
  the previous tile's S (K) and P V (V).
- ``single_p`` (timing only, outside the one-ulp limit): P V with P_hi
  alone, the P_lo products taken out; P is still split.
- ``no_exp`` and ``no_pv`` (timing only, wrong output): the softmax without
  its exp2s, or no P V products at all, to show what each step costs.

The kept design and ``keys128_one_stage`` are held against the plain version
(one bf16 ulp: atol 1e-3, rtol 2^-7); ``single_p``'s largest error is
printed.  Each variant is timed under the CUDA profiler over 20 calls after a
warm-up (device ms per call), beside SDPA ``is_causal`` on the same inputs.
Variants run in the order given, then ``kept`` once more, so that drift
shows.  The last line is one JSON object with every reading and the card's
name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import cuda as kcuda  # noqa: E402
from repro_torch.kernels import flash_attention as kf  # noqa: E402

SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc", "flash_attention.cu")
OUT = os.path.join(ROOT, "build", "flash_variants")
B, S, HQ, HKV, D = 8, 2048, 32, 8, 160
CALLS = 20
TOL = dict(atol=1e-3, rtol=2.0 ** -7)

_P_LO = "for (int kk = 0; kk < kKeys / 16; ++kk)\n        wgmma_pv<D>(o, p_lo[kk]"
_P_HI = "for (int kk = 0; kk < kKeys / 16; ++kk)\n        wgmma_pv<D>(o, p_hi[kk]"

VARIANTS = {
    "kept": [],
    "keys128_one_stage": [
        ("static constexpr int kKeys = D == 160 ? 64 : 128;", "static constexpr int kKeys = 128;"),
        ("constexpr int kStages = 2;", "constexpr int kStages = 1;"),
    ],
    "single_p": [(_P_LO, _P_LO.replace("kKeys / 16", "0"))],
    "no_exp": [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));', "y = x;")],
    "no_pv": [(_P_LO, _P_LO.replace("kKeys / 16", "0")),
              (_P_HI, _P_HI.replace("kKeys / 16", "0"))],
}
COMPUTES = {"kept", "keys128_one_stage"}


def _source(name: str) -> str:
    text = open(SOURCE).read()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: a replacement matches {text.count(old)} times, not once:\n{old}")
        text = text.replace(old, new)
    return text + ('\nextern "C" const char* repro_cuda_error_string(int e) '
                   '{ return cudaGetErrorString(static_cast<cudaError_t>(e)); }\n')


def _build(name: str) -> ctypes.CDLL:
    os.makedirs(OUT, exist_ok=True)
    cu, so = os.path.join(OUT, f"{name}.cu"), os.path.join(OUT, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(_source(name))
    log = subprocess.run([kcuda._nvcc(), *kcuda.NVCC_FLAGS, "-I", str(kcuda.CSRC), "-shared", cu,
                          "-o", so], check=True, capture_output=True, text=True)
    for line in (log.stdout + log.stderr).splitlines():
        if "wgmma_kernelILi160" in line or "spill" in line or "registers" in line:
            print(f"  {name}: {line.strip()}")
    dll = ctypes.CDLL(so)
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    dll.repro_flash_attention.argtypes = [p, p, p, p, p, ctypes.POINTER(ll), i, i, i, i, f, f, i, p]
    dll.repro_flash_attention.restype = i
    dll.repro_cuda_error_string.argtypes = [i]
    dll.repro_cuda_error_string.restype = ctypes.c_char_p
    return dll


def _device_ms(fn) -> float:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
               for e in prof.key_averages()) / 1e3 / CALLS


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(B, S, h, D, generator=gen, device=dev).bfloat16().transpose(1, 2)
               for h in (HQ, HKV, HKV))
    want = kf.flash_attention_plain(q, k, v)
    pairs = B * HQ * S * (S + 1) // 2
    result = {"card": smi, "shape": dict(B=B, S=S, T=S, Hq=HQ, Hkv=HKV, D=D, causal=True,
                                         dtype="bfloat16"),
              "bound_ms": 4 * D * pairs / 989e12 * 1e3, "hi_lo_floor_ms": 6 * D * pairs / 989e12 * 1e3,
              "sdpa_is_causal_device_ms": _device_ms(
                  lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True))}
    print(f"sdpa is_causal: {result['sdpa_is_causal_device_ms']:.4f} device ms | {smi}")
    for name in list(VARIANTS) + ["kept"]:
        kcuda._lib = _build(name)
        got = kf.flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if name in COMPUTES:
            torch.testing.assert_close(got.float(), want.float(), **TOL)
        r = dict(device_ms=_device_ms(lambda: kf.flash_attention_fwd(q, k, v)),
                 max_abs_err=err, checked=name in COMPUTES)
        result.setdefault(name, []).append(r)
        print(f"{name}: {r} | {smi}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
