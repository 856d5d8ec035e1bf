#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It puts ``src`` on ``sys.path`` itself, builds the three ``sm_90a`` kernels
from ``src/repro_torch/kernels/csrc``, and then:

1. prints the card's name and power limit as ``nvidia-smi`` gives them;
2. holds each kernel exactly equal to its plain PyTorch version on the card,
   on seeded random inputs at the main path's shapes, and times both (CUDA
   events, median after warm-up);
3. drives the main path: YCSB (paper §6.2, one table, key plus 10 columns of
   100 B) with 1,000,000 rows through ``BatchOCC(mode="kernel")`` onto four
   path-backed SSD devices, alternating write-only and hybrid batches of
   65,536 transactions, a fuzzy checkpoint, one small batch that the fused
   round declines, and a kill with the last batch published but not drained
   and a torn frame on device 0;
4. recovers with ``recover(mode="kernel")`` and holds it equal to the
   vectorized and scalar modes and to every drained write, and replays the
   logs against the checkpoint through ``replay_columnar(use_kernel=True)``;
5. asserts that every kernel launched on the main path;
6. prints throughput and recovery times beside the card's name and power
   limit, one JSON line of kernel results, and as its last line
   ``{"ok": true, "device": {...}}``.

Every phase asserts; any failure raises and the exit code is non-zero.
Without a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import numpy as np
import torch

from repro_torch.core import EngineConfig, PoplarEngine, Txn, make_devices, recover
from repro_torch.core.checkpoint import CheckpointDaemon, load_latest_checkpoint
from repro_torch.core.recovery import (
    compute_rsne,
    device_ssn_floors,
    load_columnar_segmented,
    replay_columnar,
)
from repro_torch.db import ArrayTable, BatchOCC
from repro_torch.db import ycsb
from repro_torch.kernels import cuda as kcuda
from repro_torch.kernels.batch_occ import (
    seg_reduce,
    seg_reduce_plain,
    validate_sequence,
    validate_sequence_plain,
)
from repro_torch.kernels.scatter_max import NO_POS, ssn_scatter_max, ssn_scatter_max_plain
from repro_torch.obs import metrics
from repro_torch.trace import span as tspan

# NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3.  int32 ALU rate: the data
# sheet's 67 TFLOP/s fp32 counts an FMA as two operations on 128 lanes per
# SM; int32 has 64 lanes per SM, one operation each: 67 / 4 TOP/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4

PAPER_ROWS = 10_000_000
N_ROWS = 1_000_000          # cut from PAPER_ROWS for the smoke's time limit
BATCH = 65_536              # transactions per main-path batch
N_BATCHES = 8
SMALL_BATCH = 1_500         # its rounds fall under the fused round's 2048 lanes
SEGMENT_BYTES = 64 << 20    # recovery sees sealed tiles and tail tiles
TORN_VALUE = b"TORN-VALUE-NEVER-COMMITTED"
DECLINES = ("occ.fused.decline.small_batch", "occ.fused.decline.dense_padding",
            "occ.fused.decline.i32_range")
# the executing thread's stages of one BatchOCC call (trace/span.py)
BATCH_STAGES = (tspan.ST_VALIDATE, tspan.ST_SEQUENCE, tspan.ST_ENCODE,
                tspan.ST_PUBLISH, tspan.ST_WRITEBACK)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def _median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _device_ms(fn):
    """Run ``fn`` under the CUDA profiler; returns ``(fn(), {activity:
    (device ms, count)})`` for every kernel and copy the card ran, or an
    empty dict when the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            rows[e.key] = (us / 1e3, e.count)
    return out, rows


def _per_call_device_ms(fn, calls: int = 20):
    _, rows = _device_ms(lambda: [fn() for _ in range(calls)])
    return sum(ms for ms, _ in rows.values()) / calls if rows else None


def _max_abs_err(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def _bound(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --- phase 2: each kernel against its plain version ---------------------------

def _validate_inputs(rng, dev):
    """The fused round of a hybrid batch: 65,536 txns x 16 lanes (10 reads
    plus 1 write each, the rest masked), rows over 1,000,000 tuples."""
    n_txn, k, cap = 1 << 16, 16, 1 << 20
    lanes = n_txn * k
    lane = np.tile(np.arange(k), n_txn)
    acc = np.empty((6, lanes), np.int32)
    acc[0] = rng.integers(0, 1_000_000, lanes)
    acc[1] = np.repeat(np.arange(n_txn), k)
    acc[2] = lane == 10
    ssn = rng.integers(0, 1 << 20, lanes).astype(np.int32)
    acc[4] = ssn
    obs = np.full(lanes, -1, np.int32)
    seen = rng.random(lanes) < 0.05
    obs[seen] = ssn[seen] + (rng.random(seen.sum()) < 0.3)   # some stale
    acc[3] = obs
    acc[5] = rng.random(lanes) < 0.01
    a_len = np.full(n_txn, 11, np.int32)
    a_len[-1000:] = 0                                         # padded txns
    args = (torch.from_numpy(acc).to(dev), torch.from_numpy(a_len).to(dev), n_txn, k, cap)
    nbytes = acc.nbytes + a_len.nbytes + n_txn * (1 + 4)
    ops = 8 * lanes
    return args, nbytes, ops, f"acc (6, {lanes}) int32, n_txn={n_txn}, k={k}, cap={cap}"


def _scatter_inputs(rng, dev):
    """The replay apply against a checkpoint image: 2^19 slots (30% from
    the checkpoint), 2^18 lanes with SSN ties, duplicate keys, pad lanes at
    key -1 and at the overflow slot S."""
    s, w = 1 << 19, 1 << 18
    img_ssn = np.full(s, -1, np.int32)
    img_pos = np.full(s, NO_POS, np.int32)
    ck = rng.random(s) < 0.3
    img_ssn[ck] = rng.integers(0, 1 << 20, ck.sum())
    img_pos[ck] = -1
    key = rng.integers(0, s, w).astype(np.int32)
    ssn = rng.integers(0, 1 << 20, w).astype(np.int32)
    pos = np.arange(w, dtype=np.int32)
    tie = (rng.random(w) < 0.05) & ck[key]
    ssn[tie] = img_ssn[key[tie]]                  # ties with the checkpoint
    dup = rng.integers(0, w, w // 50)
    key[dup[1:]] = key[dup[:-1]]                  # same key, same SSN, later pos
    ssn[dup[1:]] = ssn[dup[:-1]]
    pad = np.arange(w - w // 32, w)
    key[pad] = np.where(pad % 2, -1, s)
    ssn[pad] = -1
    pos[pad] = NO_POS
    arrs = (img_ssn, img_pos, key, ssn, pos)
    args = tuple(torch.from_numpy(a).to(dev) for a in arrs)
    nbytes = sum(a.nbytes for a in arrs) + 8 * s
    ops = 2 * w + 2 * s
    return args, nbytes, ops, f"S={s} slots, W={w} lanes"


def _seg_inputs(rng, dev):
    """The declined round's first-writer / base-SSN reduce: 2^16 items over
    2^14 slots, 5% pad items at key -1."""
    w, n_slots = 1 << 16, 1 << 14
    key = rng.integers(0, n_slots, w).astype(np.int32)
    key[rng.random(w) < 0.05] = -1
    val = rng.integers(0, 2**31 - 1, w).astype(np.int32)
    args = (torch.from_numpy(key).to(dev), torch.from_numpy(val).to(dev), n_slots)
    nbytes = key.nbytes + val.nbytes + 4 * n_slots
    return args, nbytes, w, f"W={w} items, n_slots={n_slots}"


def check_kernels(seed: int):
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    results = []

    args, nbytes, ops, shape = _validate_inputs(rng, dev)
    got = validate_sequence(*args)
    torch.cuda.synchronize()
    want = validate_sequence_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want)), "validate_sequence != plain"
    assert bool(got[0].any()) and not bool(got[0].all()), "degenerate survive mask"
    results.append(dict(
        name="validate_sequence", shape=shape, max_abs_err=_max_abs_err(got, want),
        ms=_median_ms(lambda: validate_sequence(*args)),
        device_ms=_per_call_device_ms(lambda: validate_sequence(*args)),
        plain_ms=_median_ms(lambda: validate_sequence_plain(*args)),
        bound=_bound(nbytes, ops), library_ms=None,
        source="src/repro_torch/kernels/csrc/validate_sequence.cu",
        replaces="src/repro/kernels/batch_occ.py:83",
    ))

    args, nbytes, ops, shape = _scatter_inputs(rng, dev)
    got = ssn_scatter_max(*args)
    torch.cuda.synchronize()
    want = ssn_scatter_max_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want)), "ssn_scatter_max != plain"
    assert bool((got[1] == -1).any()), "no checkpoint slot survived its tie"
    results.append(dict(
        name="ssn_scatter_max", shape=shape, max_abs_err=_max_abs_err(got, want),
        ms=_median_ms(lambda: ssn_scatter_max(*args)),
        device_ms=_per_call_device_ms(lambda: ssn_scatter_max(*args)),
        plain_ms=_median_ms(lambda: ssn_scatter_max_plain(*args)),
        bound=_bound(nbytes, ops), library_ms=None,
        source="src/repro_torch/kernels/csrc/scatter_max.cu",
        replaces="src/repro/kernels/scatter_max.py:125",
    ))

    (key, val, n_slots), nbytes, ops, shape = _seg_inputs(rng, dev)
    errs = []
    for op in ("min", "max"):
        got = seg_reduce(key, val, n_slots, op=op)
        torch.cuda.synchronize()
        want = seg_reduce_plain(key, val, n_slots, op)
        assert torch.equal(got, want), f"seg_reduce {op} != plain"
        errs.append(_max_abs_err([got], [want]))
    # the one PyTorch call that computes the same reduce, on prepared inputs
    idx = torch.where(key >= 0, key, n_slots).long()
    lib_out = torch.full((n_slots + 1,), -1, dtype=torch.int32, device=dev)
    results.append(dict(
        name="seg_reduce", shape=shape + ", op=max", max_abs_err=max(errs),
        ms=_median_ms(lambda: seg_reduce(key, val, n_slots, op="max")),
        device_ms=_per_call_device_ms(lambda: seg_reduce(key, val, n_slots, op="max")),
        plain_ms=_median_ms(lambda: seg_reduce_plain(key, val, n_slots, "max")),
        bound=_bound(nbytes, ops),
        library_ms=_median_ms(
            lambda: lib_out.scatter_reduce_(0, idx, val, "amax", include_self=True)),
        source="src/repro_torch/kernels/csrc/seg_reduce.cu",
        replaces="src/repro/kernels/batch_occ.py:118",
    ))
    return results


# --- phases 3-5: the main path ----------------------------------------------

def _counters(reg):
    return {name: reg.counter_value(name) for name in ("occ.fused.rounds", *DECLINES)}


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def _torn_record() -> bytes:
    t = Txn(tid=777777, write_set=[(ycsb.key_of(0), TORN_VALUE)])
    t.ssn = 1 << 40          # would win every last-writer-wins race if replayed
    return t.encode()[:-7]


def run_main_path(workdir, seed=0):
    """Forward path, checkpoint, kill and recovery on the card; returns the
    measurements, with ``out["launches"]``: each kernel's launches over
    exactly that run (the extra recovery under the CUDA profiler comes
    after it and is not counted)."""
    reg = metrics.enable()
    out = {"rows": N_ROWS, "batch": BATCH, "batches": []}
    logdir = os.path.join(workdir, "logs")
    ckdir = os.path.join(workdir, "ckpt")

    t0 = time.perf_counter()
    table = ArrayTable()
    ycsb.load(table, N_ROWS, seed=seed)
    out["load_s"] = time.perf_counter() - t0

    engine = PoplarEngine(EngineConfig(
        n_buffers=4, device_kind="ssd", device_dir=logdir, device_clock="virtual",
        segment_bytes=SEGMENT_BYTES))
    engine.start()
    occ = BatchOCC(table, engine, n_workers=4, mode="kernel", device="cuda")
    # per round, in order: did the fused round take it (or decline it)?
    fused_log = []
    fused_round = occ._fused_round

    def _logged_fused_round(*a):
        res = fused_round(*a)
        fused_log.append(res is not None)
        return res

    occ._fused_round = _logged_fused_round
    wo = ycsb.YCSBWriteOnly(N_ROWS, seed=seed)
    hy = ycsb.YCSBHybrid(N_ROWS, scan_length=10, seed=seed)
    expect = {}   # key -> (value, ssn) of the newest drained write

    def _record(res, writes_of):
        for t, i in zip(res.committed, res.committed_idx):
            assert t.committed, "a drained transaction is not committed"
            for kb, v in writes_of(t, i):
                if kb not in expect or t.ssn > expect[kb][1]:
                    expect[kb] = (v, t.ssn)

    def _run(kind, n, drain=True, profiled=False):
        launches0, c0 = dict(kcuda.LAUNCHES), _counters(reg)
        if kind == "write-only":
            rd_row, rd_start, wr_row, wr_start, vals, vlen = wo.next_batch_indexed(n)
            entry = "execute_indexed"

            def execute():
                return occ.execute_indexed(rd_row, rd_start, wr_row, wr_start, vals,
                                           wr_vlen=vlen, max_rounds=3)

            def writes_of(t, i):
                return [(ycsb.key_of(int(wr_row[i])).encode(), vals[i])]
        else:
            specs = hy.next_batch(n)
            entry = "execute_batch"

            def execute():
                return occ.execute_batch(specs, max_rounds=3)

            def writes_of(t, i):
                return [(k.encode(), v) for k, v in t.write_set]
        tspan.TRACER.reset()
        fused_log.clear()
        device = {}
        t1 = time.perf_counter()
        if profiled:
            res, device = _device_ms(execute)
        else:
            res = execute()
        secs = time.perf_counter() - t1
        trace = tspan.TRACER.dump()
        stages = {tspan.STAGE_NAMES[st]: float(trace.duration()[trace.stage == st].sum())
                  for st in BATCH_STAGES}
        if drain:
            occ.drain()
            engine.quiesce(range(4))
            _record(res, writes_of)
        row = dict(kind=kind, entry=entry, txns=n, committed=len(res.committed),
                   rounds=res.rounds, fused_per_round=list(fused_log), seconds=secs,
                   txn_per_s=len(res.committed) / secs,
                   launches=_delta(dict(kcuda.LAUNCHES), launches0),
                   counters=_delta(_counters(reg), c0), drained=drain,
                   stages_s=stages, profiled=profiled)
        if device:
            copies = sum(ms for k, (ms, _) in device.items() if "emcpy" in k)
            row["device_ms"] = {"kernels": sum(ms for ms, _ in device.values()) - copies,
                                "copies": copies}
        out["batches"].append(row)
        print(f"batch {len(out['batches']) - 1}: {kind} {entry}, {n} txns, "
              f"{row['committed']} committed in {res.rounds} rounds "
              f"(fused per round {row['fused_per_round']}), {secs:.3f} s, "
              f"{row['txn_per_s']:.0f} txn/s, launches {row['launches']}, "
              f"host stages " + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
              + (f", device {row['device_ms']} ms" if device else ""))
        return row

    kinds = ["write-only", "hybrid"] * (N_BATCHES // 2)
    tspan.enable()
    for b, kind in enumerate(kinds):
        if b == N_BATCHES - 1:
            # a batch under 2048 lanes: the fused round declines every round
            # and the segmented reduces of _first_writer/_base_ssns take
            # seg_reduce
            row = _run("write-only", SMALL_BATCH)
            assert row["fused_per_round"] == [False] * row["rounds"], row
            assert row["counters"]["occ.fused.decline.small_batch"] == row["rounds"], row
            assert row["launches"]["seg_reduce"] >= 2, row
            # the kill: the last batch is published, not drained
            row = _run(kind, BATCH, drain=False)
        else:
            # the first batch of each kind also runs under the CUDA profiler
            row = _run(kind, BATCH, profiled=b < 2)
        # A full-size batch's first round always takes the fused round, and
        # the fused rounds come first.  Only its retry rounds may decline,
        # and only for size: the losers they retry can fall under the 2048
        # lanes below which the reference's rule (BatchOCC.fused_min_lanes)
        # declines, so decline.small_batch is held to rounds - 1, not to 0.
        c, per_round = row["counters"], row["fused_per_round"]
        assert len(per_round) == row["rounds"] and per_round[0], row
        assert per_round == sorted(per_round, reverse=True), row
        assert c["occ.fused.rounds"] == sum(per_round), row
        assert c["occ.fused.decline.dense_padding"] == 0, row
        assert c["occ.fused.decline.i32_range"] == 0, row
        assert c["occ.fused.decline.small_batch"] == row["rounds"] - sum(per_round), row
        if b == 3:
            t1 = time.perf_counter()
            ck = CheckpointDaemon(ckdir, n_threads=2, m_files=2,
                                  csn_fn=lambda: engine.commit.csn)
            n, keys, vals, ssns = table.n, table._keys_b, table.values, table.ssn
            parts = [((keys[r], vals[r], int(ssns[r])) for r in range(lo, hi))
                     for lo, hi in ((0, n // 2), (n // 2, n))]
            ck.run_once(parts, epoch=1)
            out["checkpoint_s"] = time.perf_counter() - t1
            print(f"checkpoint after batch {b}: {n} rows in {out['checkpoint_s']:.3f} s")

    tspan.disable()
    engine.stop()                 # kill: loggers die, the ring's contents are lost
    for d in engine.devices:
        d.close()
    with open(os.path.join(logdir, "log_0.bin"), "ab") as f:
        f.write(_torn_record())   # a mid-flush kill leaves a partial frame
        f.flush()
        os.fsync(f.fileno())

    devs = make_devices(4, "ssd", logdir, "virtual")
    assert any(len(d.read_segment_entries()) > 1 for d in devs), "no sealed segment"
    rec = {}
    states = {}
    for mode in ("kernel", "vectorized", "scalar"):
        launches0 = dict(kcuda.LAUNCHES)
        t1 = time.perf_counter()
        kw = {"device": "cuda"} if mode == "kernel" else {}
        states[mode] = recover(devs, mode=mode, **kw)
        rec[mode] = dict(seconds=time.perf_counter() - t1,
                         launches=_delta(dict(kcuda.LAUNCHES), launches0),
                         fused=states[mode].report.fused)
        print(f"recover mode={mode}: {rec[mode]['seconds']:.3f} s, "
              f"launches {rec[mode]['launches']}, fused {rec[mode]['fused']}")
    st = states["kernel"]
    assert st.report.fused is True, "the fused kernel recovery did not engage"
    assert rec["kernel"]["launches"]["ssn_scatter_max"] >= 1, rec["kernel"]
    for mode in ("vectorized", "scalar"):
        o = states[mode]
        assert (o.data, o.rsns, o.rsne, o.n_replayed, o.n_skipped_uncommitted) == (
            st.data, st.rsns, st.rsne, st.n_replayed, st.n_skipped_uncommitted), mode
    assert all(v != TORN_VALUE for v, _ in st.data.values())
    for kb, (v, s) in expect.items():
        got = st.data.get(kb)
        assert got is not None and got[1] >= s, (kb, s, got)
        if got[1] == s:
            assert got[0] == v, kb
    rec["drained_writes_checked"] = len(expect)
    rec["rsne"] = st.rsne
    rec["replayed"] = st.n_replayed
    rec["skipped"] = st.n_skipped_uncommitted
    out["recovery"] = rec
    print(f"durability: {len(expect)} drained keys read back; rsne {st.rsne}, "
          f"replayed {st.n_replayed}, skipped {st.n_skipped_uncommitted}")

    ckpt = load_latest_checkpoint(ckdir)
    logs = load_columnar_segmented(devs, parallel=True)
    rsne = compute_rsne(logs, floors=device_ssn_floors(devs))
    launches0 = dict(kcuda.LAUNCHES)
    t1 = time.perf_counter()
    with_kernel = replay_columnar(logs, rsne, base=ckpt.data, use_kernel=True,
                                  device="cuda")
    t_kernel = time.perf_counter() - t1
    launches = _delta(dict(kcuda.LAUNCHES), launches0)
    t1 = time.perf_counter()
    plain = replay_columnar(logs, rsne, base=ckpt.data)
    t_vec = time.perf_counter() - t1
    assert with_kernel == plain, "checkpoint replay: kernel apply != vectorized"
    assert launches["ssn_scatter_max"] >= 1, launches
    out["checkpoint_replay"] = dict(kernel_s=t_kernel, vectorized_s=t_vec,
                                    launches=launches, base_keys=len(ckpt.data))
    print(f"replay_columnar against the checkpoint ({len(ckpt.data)} keys): kernel "
          f"{t_kernel:.3f} s, vectorized {t_vec:.3f} s, launches {launches}")
    out["launches"] = dict(kcuda.LAUNCHES)    # the main path ends here

    # once more under the CUDA profiler: the card's share of a recovery
    t1 = time.perf_counter()
    again, dev_rows = _device_ms(lambda: recover(devs, mode="kernel", device="cuda"))
    assert again.data == st.data
    copies = sum(ms for k, (ms, _) in dev_rows.items() if "emcpy" in k)
    rec["kernel_profiled"] = dict(
        seconds=time.perf_counter() - t1, copies_ms=copies,
        kernels_ms=sum(ms for ms, _ in dev_rows.values()) - copies)
    print(f"recover mode=kernel under the profiler: {rec['kernel_profiled']}")
    for d in devs:
        d.close()
    metrics.disable()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    smi = _smi()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")

    t0 = time.perf_counter()
    so = kcuda.build()
    kcuda.lib()
    print(f"built {os.path.basename(so)} in {time.perf_counter() - t0:.1f} s")
    for line in kcuda.build_log().splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  " + line.strip())

    kernels = check_kernels(args.seed)
    for k in kernels:
        print(f"kernel {k['name']} ({k['shape']}): exact; {k['ms']:.4f} ms "
              f"(device {k['device_ms']} ms), plain "
              f"{k['plain_ms']:.4f} ms, bound {k['bound'][0]:.4f} ms ({k['bound'][1]})"
              f", library {k['library_ms']} ms | {smi}")
    print(f"main path: YCSB {N_ROWS} rows (reduced from the paper's {PAPER_ROWS}"
          f" for the smoke's time limit), 4 SSD devices, segments of "
          f"{SEGMENT_BYTES >> 20} MiB")
    workdir = tempfile.mkdtemp(prefix="chip_smoke-")
    try:
        kcuda.reset_launches()
        out = run_main_path(workdir, seed=args.seed)
        launches = out["launches"]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for name, n in launches.items():
        assert n > 0, f"kernel {name} never launched on the main path"

    for b in out["batches"]:
        tag = ", under the CUDA profiler" if b["profiled"] else ""
        print(f"txn/s {b['entry']} ({b['kind']}, {b['txns']} txns{tag}): "
              f"{b['txn_per_s']:.1f} | {smi}")
    for mode in ("kernel", "vectorized", "scalar"):
        print(f"recovery s mode={mode}: {out['recovery'][mode]['seconds']:.3f} | {smi}")
    print("main_path " + json.dumps(out, default=float))

    line = []
    for k in kernels:
        line.append({
            "name": k["name"], "route": "cuda", "source": k["source"],
            "replaces": k["replaces"], "launches": launches[k["name"]],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound"][0], "bound_by": k["bound"][1],
            "library_ms": k["library_ms"], "shape": k["shape"],
            "device_ms": k["device_ms"],
        })
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
