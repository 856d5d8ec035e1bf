#!/usr/bin/env python3
"""Time the kept ``ssn_scatter_max``, ``seg_reduce`` and ``validate_sequence``
kernels beside the designs the port measured and did not keep
(``tools/launch_variants.cu``).

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 tools/launch_variants.py

Every variant is first held against the plain PyTorch version (exact), then
timed under the CUDA profiler: device microseconds and device operations
per call, over 50 calls after a warm-up.  Shapes are those of
``chip_smoke.py``: the scatter at S = 2^19 slots and W = 2^18 lanes against
a checkpoint image, the segmented max at 2^16 items over 2^14 slots, the
fused OCC round at the hybrid batch's (6, 2^20) lanes (k = 16) and the
write-only batch's (6, 2^16) (k = 1), both at cap 2^20.  The last line is
one JSON object with every reading and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import cuda as kcuda  # noqa: E402
from repro_torch.kernels.batch_occ import (  # noqa: E402
    seg_reduce,
    seg_reduce_plain,
    validate_sequence,
    validate_sequence_plain,
)
from repro_torch.kernels.scatter_max import (  # noqa: E402
    NO_POS,
    ssn_scatter_max,
    ssn_scatter_max_plain,
)


class Scatter(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "img_ssn", "img_pos", "key", "ssn", "pos", "packed", "out_ssn", "out_pos")] + [
        ("s", ctypes.c_longlong), ("w", ctypes.c_longlong)]


class Validate(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in ("acc", "a_len", "fw", "survive", "bases")] + [
        ("n_txn", ctypes.c_longlong), ("n_lanes", ctypes.c_longlong), ("k", ctypes.c_int),
        ("kshift", ctypes.c_int), ("cap", ctypes.c_int), ("epoch", ctypes.c_uint)]


def _build() -> ctypes.CDLL:
    out_dir = os.path.join(ROOT, "build", "launch_variants")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "liblaunch_variants.so")
    subprocess.run([kcuda._nvcc(), *kcuda.NVCC_FLAGS[:4], "-shared",
                    os.path.join(ROOT, "tools", "launch_variants.cu"), "-o", so], check=True)
    lib = ctypes.CDLL(so)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.variant_scatter.argtypes = [i, ctypes.POINTER(Scatter), p]
    lib.variant_seg.argtypes = [i, p, p, ll, p, i, p]
    lib.variant_empty.argtypes = [i, p]
    lib.variant_validate.argtypes = [i, ctypes.POINTER(Validate), p]
    return lib


def _round_inputs(rng, write_only: bool):
    """The fused round of ``chip_smoke.py``'s hybrid batch (65,536 txns x
    16 lanes, 11 valid, one write) or write-only batch (65,536 txns of one
    write lane), rows over 1,000,000 tuples, cap 2^20, on the card."""
    n_txn, k, cap = 1 << 16, (1 if write_only else 16), 1 << 20
    lanes = n_txn * k
    lane = np.tile(np.arange(k), n_txn)
    acc = np.empty((6, lanes), np.int32)
    acc[0] = rng.integers(0, 1_000_000, lanes)
    acc[1] = np.repeat(np.arange(n_txn), k)
    acc[2] = lane == (0 if write_only else 10)
    acc[4] = rng.integers(0, 1 << 20, lanes)
    seen = rng.random(lanes) < 0.05
    acc[3] = np.where(seen, acc[4] + (rng.random(lanes) < 0.3), -1)
    acc[5] = rng.random(lanes) < 0.01
    a_len = np.full(n_txn, k if write_only else 11, np.int32)
    if not write_only:
        a_len[-1000:] = 0
    dev = torch.device("cuda")
    return torch.from_numpy(acc).to(dev), torch.from_numpy(a_len).to(dev), n_txn, k, cap


def _per_call(fn, calls: int = 50, tries: int = 3):
    """(device us, device operations) per call, CUDA profiler; the profiler
    may drop a window's events, so a window with fewer than ``calls``
    operations is taken again."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = n = 0
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
            if t:
                us, n = us + t, n + e.count
        if n >= calls:
            break
    return us / calls, n / calls


def _host_path(lib, stream, calls: int = 200):
    """Host microseconds per step of one ``ssn_scatter_max`` call at the
    shapes above, each step repeated ``calls`` times with no synchronisation,
    beside the whole call, one ``seg_reduce`` call, an empty launch through
    ctypes and the library's ``scatter_reduce_``."""
    import time

    from repro_torch.kernels.batch_occ import _check_i32
    from repro_torch.kernels.scatter_max import _scratch

    dev = torch.device("cuda")
    s, w = 1 << 19, 1 << 18
    args = [torch.zeros(n, dtype=torch.int32, device=dev) for n in (s, s, w, w, w)]
    args[2].fill_(-1)
    out = torch.empty((2, s), dtype=torch.int32, device=dev)
    index = torch.cuda.current_device()
    ssn_scatter_max(*args)
    scratch = _scratch[(index, stream())]
    call = kcuda.lib().repro_ssn_scatter_max
    ptrs = [a.data_ptr() for a in args]
    key, val = args[2][: 1 << 16], args[3][: 1 << 16]
    idx = torch.zeros(w, dtype=torch.long, device=dev)
    packed = torch.zeros(w, dtype=torch.long, device=dev)
    lib_out = torch.zeros(s + 1, dtype=torch.long, device=dev)
    steps = {
        "checks (5 tensors)": lambda: _check_i32("x", *args),
        "raw stream": stream,
        "torch.empty((2, S))": lambda: torch.empty((2, s), dtype=torch.int32, device=dev),
        "unbind": lambda: out.unbind(0),
        "7 data_ptr": lambda: [a.data_ptr() for a in (*args, scratch, out)],
        "ctypes call with the launch": lambda: call(ptrs[0], ptrs[1], s, ptrs[2], ptrs[3], ptrs[4], w,
                                                    scratch.data_ptr(), out.data_ptr(), index, stream()),
        "empty launch through ctypes": lambda: lib.variant_empty(0, stream()),
        "whole ssn_scatter_max": lambda: ssn_scatter_max(*args),
        "whole seg_reduce": lambda: seg_reduce(key, val, 1 << 14),
        "library scatter_reduce_": lambda: lib_out.scatter_reduce_(0, idx, packed, "amax", include_self=True),
    }
    result = {}
    for name, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        result[name] = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        print(f"host {name}: {result[name]:.2f} us per call")
    return result


def _validate_host_path(calls: int = 200):
    """Host microseconds per call of ``validate_sequence`` at the hybrid
    round's shape, of its stream-capture check, and of its two output
    allocations beside one int32 block with two views into it, each
    repeated ``calls`` times with no synchronisation."""
    import time

    acc, a_len, n_txn, k, cap = _round_inputs(np.random.default_rng(1), False)
    steps = {
        "validate: stream-capture check": torch.cuda.is_current_stream_capturing,
        "validate: two outputs (kept: bool, int32)": lambda: (
            acc.new_empty(n_txn, dtype=torch.bool), acc.new_empty(n_txn)),
        "validate: one int32 block and its two views": lambda: (
            lambda o: (o[:n_txn], o[n_txn:].view(torch.bool)[:n_txn]))(
                acc.new_empty(n_txn + (n_txn + 3) // 4)),
        "validate: whole validate_sequence": lambda: validate_sequence(acc, a_len, n_txn, k, cap),
    }
    result = {}
    for name, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        result[name] = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        print(f"host {name}: {result[name]:.2f} us per call")
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("launch_variants: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    lib = _build()
    stream = lambda: kcuda.current_stream(torch.cuda.current_device())  # noqa: E731
    rng = np.random.default_rng(0)
    rows = {}

    def record(name, got, want, fn):
        exact = all(torch.equal(g, w) for g, w in zip(got, want))
        us, ops = _per_call(fn)
        rows[name] = dict(exact=exact, device_us=us, ops_per_call=ops)
        print(f"{name}: exact {exact}, {us:.2f} device us, {ops:.2f} device ops per call | {smi}")
        assert exact, name

    s, w = 1 << 19, 1 << 18
    img_ssn = np.full(s, -1, np.int32)
    img_pos = np.full(s, NO_POS, np.int32)
    ck = rng.random(s) < 0.3
    img_ssn[ck] = rng.integers(0, 1 << 20, ck.sum())
    img_pos[ck] = -1
    key = rng.integers(0, s, w).astype(np.int32)
    ssn = rng.integers(0, 1 << 20, w).astype(np.int32)
    pos = np.arange(w, dtype=np.int32)
    pad = np.arange(w - w // 32, w)
    key[pad] = np.where(pad % 2, -1, s)
    ssn[pad] = -1
    pos[pad] = NO_POS
    args = [torch.from_numpy(a).to(dev) for a in (img_ssn, img_pos, key, ssn, pos)]
    want = ssn_scatter_max_plain(*args)
    record("ssn_scatter_max (kept: one launch, touched words cleared)",
           ssn_scatter_max(*args), want, lambda: ssn_scatter_max(*args))
    packed = torch.zeros(s, dtype=torch.int64, device=dev)
    out = torch.empty((2, s), dtype=torch.int32, device=dev)
    a = Scatter(*(t.data_ptr() for t in args), packed.data_ptr(), out[0].data_ptr(),
                out[1].data_ptr(), s, w)
    for variant, name in ((0, "scatter_uncleared (one launch, every word cleared)"),
                          (1, "scatter_three (first port: pack, scatter, unpack)")):
        assert lib.variant_scatter(variant, ctypes.byref(a), stream()) == 0, name
        torch.cuda.synchronize()
        record(name, out.unbind(0), want, lambda: lib.variant_scatter(variant, ctypes.byref(a), stream()))

    n_slots, items = 1 << 14, 1 << 16
    key = rng.integers(0, n_slots, items).astype(np.int32)
    key[rng.random(items) < 0.05] = -1
    val = rng.integers(0, 2**31 - 1, items).astype(np.int32)
    kt, vt = torch.from_numpy(key).to(dev), torch.from_numpy(val).to(dev)
    want = [seg_reduce_plain(kt, vt, n_slots, "max")]
    record("seg_reduce (kept: one cooperative launch)", [seg_reduce(kt, vt, n_slots)], want,
           lambda: seg_reduce(kt, vt, n_slots))
    o = torch.empty(n_slots, dtype=torch.int32, device=dev)
    for variant, name in ((0, "seg_two (first port: fill, atomics)"),
                          (1, "seg_cluster_dist (8-block cluster, slots spread over the blocks)"),
                          (2, "seg_cluster_priv (8-block cluster, all slots in every block)")):
        call = lambda: lib.variant_seg(variant, kt.data_ptr(), vt.data_ptr(), items,  # noqa: E731
                                       o.data_ptr(), n_slots, stream())
        assert call() == 0, name
        torch.cuda.synchronize()
        record(name, [o], want, call)

    for variant, name in ((0, "empty plain launch"), (1, "empty cooperative launch, 132 x 1024, grid.sync"),
                          (2, "empty 8-block cluster of 1024, cluster.sync")):
        assert lib.variant_empty(variant, stream()) == 0, name
        us, ops = _per_call(lambda: lib.variant_empty(variant, stream()))
        rows[name] = dict(device_us=us, ops_per_call=ops)
        print(f"{name}: {us:.2f} device us | {smi}")
    for write_only in (False, True):
        acc, a_len, n_txn, k, cap = _round_inputs(rng, write_only)
        tag = "write-only" if write_only else "hybrid"
        want = validate_sequence_plain(acc, a_len, n_txn, k, cap)
        record(f"validate_sequence {tag} (kept: one launch, epoch-tagged scratch)",
               validate_sequence(acc, a_len, n_txn, k, cap), want,
               lambda: validate_sequence(acc, a_len, n_txn, k, cap))
        out = torch.empty(n_txn * 2, dtype=torch.int32, device=dev)
        got = (out[n_txn:].view(torch.bool)[:n_txn], out[:n_txn])
        for variant, name in ((3, "validate_three (first port: fill, first writer, one thread per transaction)"),
                              (0, "validate_fill (cleared int32 table, two barriers)"),
                              (1, "validate_txn (phase B at one thread per transaction)"),
                              (2, "validate_regs (lanes held in registers across the barrier)")):
            table = torch.zeros(cap, dtype=torch.int64, device=dev)   # its own epochs
            a = Validate(acc.data_ptr(), a_len.data_ptr(), table.data_ptr(),
                         got[0].data_ptr(), got[1].data_ptr(), n_txn, n_txn * k, k,
                         k.bit_length() - 1, cap, 0)

            def call(variant=variant, a=a):
                a.epoch += 1
                return lib.variant_validate(variant, ctypes.byref(a), stream())

            out.zero_()
            assert call() == 0, name
            torch.cuda.synchronize()
            record(f"{name} {tag}", got, want, call)
        # again after the variants: the first kernel timed in a row may pay for the order
        record(f"validate_sequence {tag} (kept, again)", validate_sequence(acc, a_len, n_txn, k, cap),
               want, lambda: validate_sequence(acc, a_len, n_txn, k, cap))
    host = _host_path(lib, stream)
    host.update(_validate_host_path())
    print(json.dumps({"card": smi, "variants": rows, "host_us": host}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
