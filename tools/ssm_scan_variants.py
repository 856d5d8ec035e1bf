#!/usr/bin/env python3
"""Time the kept chunked SSM scan kernel beside designs measured and not
kept, and beside copies with one step of the output kernel taken out.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 tools/ssm_scan_variants.py

Each variant is the kept source ``src/repro_torch/kernels/csrc/ssm_scan.cu``
with a few text replacements (each must match the source exactly once, or
the tool stops), built into its own library and driven through the port's
own wrapper at hymba-1.5b's prefill shape (B=8, H=25, S=2048, P=64, N=16,
float32, the model's layout).  Variants:

- ``kept``: the source as it is.
- ``cb_shared``: C·Bᵀ formed once per (batch, chunk) for all heads, by the
  head-0 block of the chunk-state kernel into a (B, nc, 64, 64) buffer, and
  read by the output kernel in place of its own product.
- ``no_m`` and ``no_intra`` (timing only, wrong output): the output kernel
  without forming M, or without the intra-chunk product M u, to show what
  each step costs.

Every variant that computes the function is held against the plain version
(float32 within 2e-4).  Each is timed under the CUDA profiler over 20 calls
after a warm-up: device ms per call of each of its launches.  Variants run
in the order given, then ``kept`` once more, so that drift shows.  The last
line is one JSON object with every reading and the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import cuda as kcuda  # noqa: E402
from repro_torch.kernels import ssm_scan as ks  # noqa: E402

SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc", "ssm_scan.cu")
OUT = os.path.join(ROOT, "build", "ssm_scan_variants")
B, H, S, P, N = 8, 25, 2048, 64, 16
CALLS = 20

_CB_PHASE1 = """  if (tid == 0) a.lalast[cb] = static_cast<float>(la_last);
  if (hi == 0) {    // C.B of this (batch, chunk), once for all heads, in uw's room
    float* ctv = uw;
    float* btv = uw + n * kLd;
    RowsN cr;
    cr.load(static_cast<const T*>(a.cm) + bi * a.csb + c0 * a.css, a.css, n, a.s - c0);
    cr.store(n, [&](int t, int k, float v) { ctv[k * kLd + t] = v; });
    for (int e = tid; e < kChunk * n; e += kThreadsSsm) btv[(e % n) * kLd + e / n] = bs[e / n][e % n];
    __syncthreads();
    const int t0 = 4 * (tid % 16), s0 = 4 * (tid / 16);
    float m[4][4] = {};
    for (int k = 0; k < n; ++k) {
      const float4 c4 = *reinterpret_cast<const float4*>(&ctv[k * kLd + t0]);
      const float4 b4 = *reinterpret_cast<const float4*>(&btv[k * kLd + s0]);
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) m[i][j] = fmaf(cv[i], bv[j], m[i][j]);
    }
    float* o = a.cbuf + (bi * a.nc + c0 / kChunk) * kChunk * kChunk;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(&o[(t0 + i) * kChunk + s0]) =
          make_float4(m[i][0], m[i][1], m[i][2], m[i][3]);
  }
"""

_CB_PHASE3_OLD = """      float m[4][4] = {};
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const float4 c4 = *reinterpret_cast<const float4*>(&ct[k * kLd + t0]);
        const float4 b4 = *reinterpret_cast<const float4*>(&bt[k * kLd + s0]);
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) m[i][j] = fmaf(cv[i], bv[j], m[i][j]);
      }
"""

_CB_PHASE3_NEW = """      float m[4][4];
      const float* cbi = a.cbuf + (bi * a.nc + c0 / kChunk) * kChunk * kChunk;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 q = *reinterpret_cast<const float4*>(&cbi[(t0 + i) * kChunk + s0]);
        m[i][0] = q.x; m[i][1] = q.y; m[i][2] = q.z; m[i][3] = q.w;
      }
"""

_CB_ALLOC = """  a.lalast = a.dstate + a.b * a.h * a.nc * a.p * a.n;
  static float* cbuf = nullptr;
  static long long cap = 0;
  if (cap < a.b * a.nc * kChunk * kChunk) {
    if (cbuf != nullptr) cudaFree(cbuf);
    cap = a.b * a.nc * kChunk * kChunk;
    if (cudaMalloc(&cbuf, cap * sizeof(float)) != cudaSuccess) return 2;
  }
  a.cbuf = cbuf;
"""

VARIANTS = {
    "kept": [],
    "cb_shared": [
        ("  float* lalast;    // (B*H, nc)\n",
         "  float* lalast;    // (B*H, nc)\n  float* cbuf;\n"),
        ("  if (tid == 0) a.lalast[cb] = static_cast<float>(la_last);\n", _CB_PHASE1),
        (_CB_PHASE3_OLD, _CB_PHASE3_NEW),
        ("  a.lalast = a.dstate + a.b * a.h * a.nc * a.p * a.n;\n", _CB_ALLOC),
    ],
    "no_m": [("    if (s0 <= t0) {\n      float m[4][4] = {};\n",
              "    if (false) {\n      float m[4][4] = {};\n")],
    "no_intra": [("    for (int s4 = 0; s4 < t0 + 4; s4 += 4) {\n",
                  "    for (int s4 = 0; s4 < 0; s4 += 4) {\n")],
}
COMPUTES = {"kept", "cb_shared"}


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
    subprocess.run([kcuda._nvcc(), *kcuda.NVCC_FLAGS[:4], "-I", str(kcuda.CSRC), "-shared", cu,
                    "-o", so], check=True)
    dll = ctypes.CDLL(so)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.repro_ssm_scan_chunked.argtypes = [p, p, p, p, p, p, p, p, ctypes.POINTER(ll), i, i, p]
    dll.repro_ssm_scan_chunked.restype = i
    dll.repro_cuda_error_string.argtypes = [i]
    dll.repro_cuda_error_string.restype = ctypes.c_char_p
    return dll


def _inputs(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(B, S, H, P, generator=gen, device=dev).transpose(1, 2)
    dt = (0.01 + 0.19 * torch.rand(B, S, H, generator=gen, device=dev)).transpose(1, 2)
    decay = (0.7 + 0.299 * torch.rand(B, S, H, generator=gen, device=dev)).transpose(1, 2)
    bm = torch.randn(B, S, N, generator=gen, device=dev)
    cm = torch.randn(B, S, N, generator=gen, device=dev)
    return x, dt, decay, bm, cm


def _phases(fn):
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if us:
            m = re.search(r"ssm_chunked_\w+?_kernel", e.key)
            name = m.group(0) if m else e.key[:60]
            out[name] = out.get(name, 0.0) + us / 1e3 / CALLS
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("ssm_scan_variants: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    args = _inputs(torch.device("cuda"))
    yw, stw = ks.ssm_scan_chunked_plain(*args)
    result = {"card": smi, "shape": dict(B=B, H=H, S=S, P=P, N=N, dtype="float32")}
    for name in list(VARIANTS) + ["kept"]:
        kcuda._lib = _build(name)
        y, st = ks.ssm_scan_chunked(*args)
        torch.cuda.synchronize()
        if name in COMPUTES:
            torch.testing.assert_close(y, yw, atol=2e-4, rtol=2e-4)
            torch.testing.assert_close(st, stw, atol=2e-4, rtol=2e-4)
        phases = _phases(lambda: ks.ssm_scan_chunked(*args))
        r = dict(device_ms=sum(phases.values()), phase_device_ms=phases,
                 checked=name in COMPUTES)
        result.setdefault(name, []).append(r)
        print(f"{name}: {r} | {smi}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
