#!/usr/bin/env python3
"""Time the kept chunked wkv6 kernel beside text-patched copies of it: the
settings tried and not kept, and copies with one step taken out.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 tools/rwkv6_variants.py

Each variant is the kept source ``src/repro_torch/kernels/csrc/rwkv6.cu``
with a few text replacements (each must match the source exactly once, or
the tool stops), built into its own library and driven through the port's
own wrapper at rwkv6-7b's prefill shape (B=8, H=64, S=2048, K=V=64,
float32, the model's layout).  Variants:

- ``kept``: the source as it is.
- ``state_chunk_64``: state chunks of 64 steps (two inner chunks) in place
  of 128: twice the blocks and twice the scratch.
- ``out_2_blocks``, ``state_4_blocks``: the output kernel's launch bound
  asks for two resident blocks per SM instead of three (more registers a
  thread), the state kernel's for four instead of three (fewer).
- ``a_2x2``: A's lower triangle in 2 x 2 tiles on the first 136 threads
  (8 shared loads per 16 terms) in place of 1 x 2 tiles on all 256 (12).
- ``no_l2_prefetch``: the output kernel without asking L2 for the next
  inner chunk while it works on this one.
- ``no_cumsum``, ``no_a``, ``no_y``, ``no_update`` (timing only, wrong
  output): the output kernel without the in-order log-cumsum, without A's
  strict lower triangle, without the y products, or without the in-block
  state update, to show what each step costs.

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
from repro_torch.kernels import rwkv6 as kw  # noqa: E402

SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc", "rwkv6.cu")
OUT = os.path.join(ROOT, "build", "rwkv6_variants")
B, H, S, K = 8, 64, 2048, 64
CALLS = 20

_OUT_BOUND = "__launch_bounds__(kThreadsWkv, 3) rwkv6_chunked_out_kernel"
_STATE_BOUND = "__launch_bounds__(kThreadsWkv, 3) rwkv6_chunked_state_kernel"
_BREAK = "if ({} >= 0) break;\n"

_A_MAP = """  // A's strict lower triangle in 1 x 2 tiles: row pt, columns ps and ps + 1
  // (ps only where ps + 1 == pt); row t holds ceil(t / 2) tiles, 256 in all.
  int pt = 1, base = 0;
  while (base + (pt + 1) / 2 <= tid) {
    base += (pt + 1) / 2;
    ++pt;
  }
  const int ps = 2 * (tid - base);
  const bool half = ps + 1 == pt;
  const int ps1 = half ? ps : ps + 1;
"""

_A2X2_MAP = """  const bool atile = tid < kChunk / 2 * (kChunk / 2 + 1) / 2;
  int ap = 0, base = 0;
  while (atile && base + ap / 2 + 1 <= tid) {
    base += ap / 2 + 1;
    ap += 2;
  }
  const int aq = 2 * (tid - base);
"""

_A_BODY = """    {
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < kKMax; kk += 4) {
        const float4 r4 = ld4(&sm.r[pt][kk]), x4 = ld4(&sm.lx[pt][kk]);
        const float4 k04 = ld4(&sm.k[ps][kk]), l04 = ld4(&sm.lw[ps][kk]);
        const float4 k14 = ld4(&sm.k[ps1][kk]), l14 = ld4(&sm.lw[ps1][kk]);
        acc0 = fmaf(r4.x * k04.x, expf(x4.x - l04.x), acc0);
        acc0 = fmaf(r4.y * k04.y, expf(x4.y - l04.y), acc0);
        acc0 = fmaf(r4.z * k04.z, expf(x4.z - l04.z), acc0);
        acc0 = fmaf(r4.w * k04.w, expf(x4.w - l04.w), acc0);
        acc1 = fmaf(r4.x * k14.x, expf(x4.x - l14.x), acc1);
        acc1 = fmaf(r4.y * k14.y, expf(x4.y - l14.y), acc1);
        acc1 = fmaf(r4.z * k14.z, expf(x4.z - l14.z), acc1);
        acc1 = fmaf(r4.w * k14.w, expf(x4.w - l14.w), acc1);
      }
      sm.a[pt][ps] = acc0;
      if (!half) sm.a[pt][ps + 1] = acc1;
    }
"""

_A2X2_BODY = """    if (atile) {
      float acc[2][2] = {};
#pragma unroll 2
      for (int kk = 0; kk < kKMax; kk += 4) {
        const float4 ra = ld4(&sm.r[ap][kk]), rb = ld4(&sm.r[ap + 1][kk]);
        const float4 xa = ld4(&sm.lx[ap][kk]), xb = ld4(&sm.lx[ap + 1][kk]);
        const float4 ka = ld4(&sm.k[aq][kk]), kb = ld4(&sm.k[aq + 1][kk]);
        const float4 la = ld4(&sm.lw[aq][kk]), lb = ld4(&sm.lw[aq + 1][kk]);
        const float rv[2][4] = {{ra.x, ra.y, ra.z, ra.w}, {rb.x, rb.y, rb.z, rb.w}};
        const float xv[2][4] = {{xa.x, xa.y, xa.z, xa.w}, {xb.x, xb.y, xb.z, xb.w}};
        const float kv[2][4] = {{ka.x, ka.y, ka.z, ka.w}, {kb.x, kb.y, kb.z, kb.w}};
        const float lv[2][4] = {{la.x, la.y, la.z, la.w}, {lb.x, lb.y, lb.z, lb.w}};
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              acc[i][j] = fmaf(rv[i][c] * kv[j][c], expf(xv[i][c] - lv[j][c]), acc[i][j]);
      }
      if (aq < ap) {
        sm.a[ap][aq] = acc[0][0];
        sm.a[ap][aq + 1] = acc[0][1];
        sm.a[ap + 1][aq + 1] = acc[1][1];
      }
      sm.a[ap + 1][aq] = acc[1][0];
    }
"""

VARIANTS = {
    "kept": [],
    "state_chunk_64": [("constexpr int kL = 128;", "constexpr int kL = 64;")],
    "out_2_blocks": [(_OUT_BOUND, _OUT_BOUND.replace("3)", "2)"))],
    "state_4_blocks": [(_STATE_BOUND, _STATE_BOUND.replace("3)", "4)"))],
    "a_2x2": [(_A_MAP, _A2X2_MAP), (_A_BODY, _A2X2_BODY)],
    "no_l2_prefetch": [("    if (more) prefetch_chunk(rp, kp, vp, wp, a, c0 + kChunk);\n", "")],
    "no_cumsum": [("        const float l = sm.lx[t][tid];\n",
                   "        " + _BREAK.format("t") + "        const float l = sm.lx[t][tid];\n")],
    "no_a": [("        const float4 r4 = ld4(&sm.r[pt][kk]), x4 = ld4(&sm.lx[pt][kk]);\n",
              "        " + _BREAK.format("kk")
              + "        const float4 r4 = ld4(&sm.r[pt][kk]), x4 = ld4(&sm.lx[pt][kk]);\n")],
    "no_y": [("        float rv[4][4];\n", "        " + _BREAK.format("kk") + "        float rv[4][4];\n"),
             ("      for (int s = 0; s < t0 + 4; s += 4) {\n",
              "      for (int s = 0; s < 0; s += 4) {\n")],
    "no_update": [("        const float4 ka = ld4(&sm.k[s][kk0]),",
                   "        " + _BREAK.format("s") + "        const float4 ka = ld4(&sm.k[s][kk0]),")],
}
COMPUTES = {"kept", "state_chunk_64", "out_2_blocks", "state_4_blocks", "a_2x2",
            "no_l2_prefetch"}
STATE_CHUNK = {"state_chunk_64": 64}


def _source(name: str) -> str:
    text = open(SOURCE).read()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: a replacement matches {text.count(old)} times, not once:\n{old}")
        text = text.replace(old, new)
    return text + ('\nextern "C" const char* repro_cuda_error_string(int e) '
                   '{ return cudaGetErrorString(static_cast<cudaError_t>(e)); }\n')


def _build(name: str):
    """The variant's library and the registers and spills ptxas reports for
    its float32 kernels."""
    os.makedirs(OUT, exist_ok=True)
    cu, so = os.path.join(OUT, f"{name}.cu"), os.path.join(OUT, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(_source(name))
    log = subprocess.run([kcuda._nvcc(), *kcuda.NVCC_FLAGS, "-I", str(kcuda.CSRC), "-shared", cu,
                          "-o", so], check=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True).stdout
    regs, kernel = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*?(rwkv6_chunked_\w+?_kernel)I(f|Li4E)Lb1", line)
        m = m or re.search(r"Compiling entry function '.*?(rwkv6_chunked_pass_kernel)I(Li4E)", line)
        if "Compiling entry" in line:
            kernel = m.group(1) if m else None
        elif kernel and "registers" in line:
            regs[kernel] = line.split("ptxas info    : ")[-1].strip()
    dll = ctypes.CDLL(so)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.repro_rwkv6_chunked.argtypes = [p, p, p, p, p, p, p, p, ctypes.POINTER(ll), i, i, p]
    dll.repro_rwkv6_chunked.restype = i
    dll.repro_cuda_error_string.argtypes = [i]
    dll.repro_cuda_error_string.restype = ctypes.c_char_p
    return dll, regs


def _inputs(dev):
    # the model's (B, S, H, K) activations as (B, H, S, K) views
    gen = torch.Generator(device=dev).manual_seed(0)
    r, k, v = ((0.5 * torch.randn(B, S, H, K, generator=gen, device=dev)).transpose(1, 2)
               for _ in range(3))
    w = torch.exp(-torch.exp(-1.5 + torch.rand(B, S, H, K, generator=gen, device=dev))).transpose(1, 2)
    u = 0.125 * torch.randn(H, K, generator=gen, device=dev)
    return r, k, v, w, u


def _phases(fn):
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):    # the profiler may drop a window's events: take it again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)]
        if sum(e.count for e in rows) == 3 * CALLS:
            break
    out = {}
    for e in rows:
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        m = re.search(r"rwkv6_chunked_\w+?_kernel", e.key)
        name = m.group(0) if m else e.key[:60]
        out[name] = out.get(name, 0.0) + us / 1e3 / CALLS
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("rwkv6_variants: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    args = _inputs(torch.device("cuda"))
    yw, stw = kw.rwkv6_chunked_plain(*args)
    result = {"card": smi, "shape": dict(B=B, H=H, S=S, K=K, V=K, dtype="float32")}
    kept_chunk = kw.STATE_CHUNK
    for name in list(VARIANTS) + ["kept"]:
        kcuda._lib, regs = _build(name)
        kw.STATE_CHUNK = STATE_CHUNK.get(name, kept_chunk)
        y, st = kw.rwkv6_chunked(*args)
        torch.cuda.synchronize()
        if name in COMPUTES:
            torch.testing.assert_close(y, yw, atol=2e-4, rtol=2e-4)
            torch.testing.assert_close(st, stw, atol=2e-4, rtol=2e-4)
        phases = _phases(lambda: kw.rwkv6_chunked(*args))
        r = dict(device_ms=sum(phases.values()), phase_device_ms=phases,
                 checked=name in COMPUTES, ptxas=regs)
        result.setdefault(name, []).append(r)
        print(f"{name}: {r} | {smi}")
    kw.STATE_CHUNK = kept_chunk
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
