"""The hand-written CUDA kernels against their plain PyTorch versions on the
card (the OLTP kernels exactly, the LLM kernels within float tolerances),
the port's kernel mode end to end on the card against its own vectorized
and scalar modes, and the LLM serve path on the card against the CPU.

These tests import no JAX, so they run on a machine with a CUDA card and
PyTorch alone:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Each test asks for the ``cuda_device`` fixture, which skips it where no CUDA
device is present (the kernels have no CPU mode).
"""

import re

import numpy as np
import pytest
import torch

from repro_torch.core import EngineConfig, PoplarEngine, recover
from repro_torch.db import ArrayTable, BatchOCC
from repro_torch.db import ycsb
from repro_torch.kernels import cuda
from repro_torch.kernels import ops
from repro_torch.kernels import scatter_max as smx
from repro_torch.kernels.batch_occ import (
    seg_reduce,
    seg_reduce_plain,
    validate_sequence,
    validate_sequence_plain,
)
from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_plain
from repro_torch.kernels.ref import scatter_max_ref, seg_reduce_ref
from repro_torch.kernels.rwkv6 import rwkv6_chunked, rwkv6_chunked_plain
from repro_torch.kernels.scatter_max import NO_POS, ssn_scatter_max_plain
from repro_torch.kernels.ssm_scan import ssm_scan_chunked, ssm_scan_chunked_plain
from repro_torch.models.api import attention_calls, draw_extras


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)


def _scatter_arrays(rng, s, w):
    img_ssn = np.full(s, -1, np.int32)
    img_pos = np.full(s, NO_POS, np.int32)
    ck = rng.random(s) < 0.3
    img_ssn[ck] = rng.integers(0, 64, ck.sum())
    img_pos[ck] = -1
    key = rng.integers(0, s, w).astype(np.int32)
    ssn = rng.integers(0, 64, w).astype(np.int32)       # dense: many ties
    pos = np.arange(w, dtype=np.int32)
    pad = np.arange(w - w // 16, w)
    key[pad] = np.where(pad % 2, -1, s)                  # both pad conventions
    ssn[pad] = 10**6                                     # would win if not skipped
    pos[pad] = -1
    return img_ssn, img_pos, key, ssn, pos


@pytest.mark.parametrize("s,w", [(1 << 14, 1 << 16), (1000, 37), (7, 0)])
def test_ssn_scatter_max_kernel_equals_plain(cuda_device, s, w):
    arrs = _scatter_arrays(np.random.default_rng(s + w), s, w)
    args = [_t(a, cuda_device) for a in arrs]
    n0 = cuda.LAUNCHES["ssn_scatter_max"]
    got = ops.ssn_scatter_max(*args)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["ssn_scatter_max"] == n0 + 1
    want = ssn_scatter_max_plain(*args)
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)
    if w and w < 100:
        keep = (arrs[2] >= 0) & (arrs[2] < s)
        ref = scatter_max_ref(arrs[0], arrs[1], *(a[keep] for a in arrs[2:]))
        assert np.array_equal(got[0].cpu().numpy(), ref[0])
        assert np.array_equal(got[1].cpu().numpy(), ref[1])


@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("w,n_slots", [(1 << 16, 1 << 12), (50, 64), (0, 8)])
def test_seg_reduce_kernel_equals_plain(cuda_device, op, w, n_slots):
    rng = np.random.default_rng(w + n_slots)
    key = rng.integers(-1, n_slots, w).astype(np.int32)
    val = rng.integers(0, 1 << 30, w).astype(np.int32)
    k, v = _t(key, cuda_device), _t(val, cuda_device)
    got = ops.occ_seg_reduce(k, v, n_slots=n_slots, op=op)
    torch.cuda.synchronize()
    assert torch.equal(got, seg_reduce_plain(k, v, n_slots, op))
    keep = key >= 0
    assert np.array_equal(got.cpu().numpy(),
                          seg_reduce_ref(key[keep], val[keep], n_slots, op))


def _scratch_is_clean():
    index = torch.cuda.current_device()
    bufs = [b for (i, _), b in smx._scratch.items() if i == index]
    return bool(bufs) and all(not bool(b.any()) for b in bufs)


def test_ssn_scatter_max_scratch_comes_back_clean(cuda_device):
    """Calls at S = 2^14, then 2^10, then 2^16, twice, on one stream share
    one scratch buffer: each equals the plain version, which a word left
    dirty by the call before could break, and the scratch is all zero after
    each."""
    for i, s in enumerate((1 << 14, 1 << 10, 1 << 16) * 2):
        arrs = _scatter_arrays(np.random.default_rng(i), s, 4 * s)
        args = [_t(a, cuda_device) for a in arrs]
        got = ops.ssn_scatter_max(*args)
        torch.cuda.synchronize()
        want = ssn_scatter_max_plain(*args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), s
        assert _scratch_is_clean(), s


@pytest.mark.parametrize("s,w", [(1 << 14, 1 << 16), (1000, 37), (5, 0)])
def test_no_image_scan_equals_the_cpu(cuda_device, s, w):
    """``fused_replay_scan`` passes no image to the kernel: one launch, and
    the result of the CPU's plain version on an all-empty image."""
    _, _, key, ssn, pos = _scatter_arrays(np.random.default_rng(s), s, w)
    scan = np.stack([key, ssn, pos])
    n0 = cuda.LAUNCHES["ssn_scatter_max"]
    got = ops.fused_replay_scan(_t(scan, cuda_device), n_slots=s)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["ssn_scatter_max"] == n0 + 1
    want = ops.fused_replay_scan(_t(scan, "cpu"), n_slots=s)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert _scratch_is_clean()


def test_kernels_launch_on_the_callers_stream(cuda_device):
    """Under ``torch.cuda.stream(side)`` the inputs are written on ``side``
    just after a long kernel there: a launch on any other stream would read
    the stale inputs (all pad lanes / all keys -1) and the test would fail."""
    s, w = 1 << 12, 1 << 14
    arrs = _scatter_arrays(np.random.default_rng(5), s, w)
    host = [_t(a, "cpu").pin_memory() for a in arrs]
    stale = [torch.full((len(a),), -1, dtype=torch.int32, device=cuda_device) for a in arrs]
    torch.cuda.synchronize()
    side = torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        for dst, src in zip(stale, host):
            dst.copy_(src, non_blocking=True)
        got = ops.ssn_scatter_max(*stale)
        got_seg = seg_reduce(stale[2], stale[4], s, op="min")
    side.synchronize()
    want = ssn_scatter_max_plain(*host)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got_seg.cpu(), seg_reduce_plain(host[2], host[4], s, "min"))


@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("n_slots,w", [(1 << 19, 1 << 16), (464_897, 1 << 18), (1 << 21, 1 << 12)])
def test_seg_reduce_one_launch_at_large_sizes(cuda_device, op, n_slots, w):
    """More slots than items, and more than any block's shared memory holds:
    one cooperative launch fills and scatters them all."""
    rng = np.random.default_rng(n_slots + w)
    key = rng.integers(-1, n_slots + 2, w).astype(np.int32)     # pads at -1, n_slots
    key[:64] = n_slots - 1                                      # the last slot
    val = rng.integers(0, 1 << 30, w).astype(np.int32)
    k, v = _t(key, cuda_device), _t(val, cuda_device)
    n0 = cuda.LAUNCHES["seg_reduce"]
    got = seg_reduce(k, v, n_slots, op=op)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["seg_reduce"] == n0 + 1
    assert torch.equal(got, seg_reduce_plain(k, v, n_slots, op))


def _device_ops(fn, calls=10, per_call=1):
    """The device operations of ``calls`` calls of ``fn`` under the
    profiler, as {name: count}."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):    # the profiler may drop a window's events: take it again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ops = {e.key: e.count for e in prof.key_averages()
               if (getattr(e, "self_device_time_total", None)
                   or getattr(e, "self_cuda_time_total", 0))}
        if sum(ops.values()) >= per_call * calls:
            break
    return ops


def _ops_per_call(fn, calls=10, per_call=1):
    return sum(_device_ops(fn, calls, per_call).values()) / calls


def _validate_arrays(rng, n_txn, k, cap, edge_pos=False):
    lanes = n_txn * k
    acc = np.empty((6, lanes), np.int32)
    acc[0] = rng.integers(0, cap, lanes)
    acc[1] = np.repeat(np.arange(n_txn), k)
    if edge_pos:    # the int32 extremes, -1 and other negatives, on few rows
        acc[0] = rng.integers(0, min(cap, 64), lanes)
        acc[1] = rng.choice(np.array([-2**31, -2**31 + 1, -7, -1, 0, 1, 5, 2**31 - 2, 2**31 - 1]),
                            lanes)
    acc[2] = rng.integers(0, 2, lanes)
    ssn = rng.integers(0, 40, lanes).astype(np.int32)
    acc[3] = np.where(rng.random(lanes) < 0.3, ssn + (rng.random(lanes) < 0.2), -1)
    acc[4] = ssn
    acc[5] = rng.random(lanes) < 0.05
    a_len = rng.integers(1, k + 1, n_txn).astype(np.int32)
    a_len[-max(1, n_txn // 8):] = 0
    return acc, a_len


def test_one_device_operation_per_call(cuda_device):
    """Under the profiler: one device operation per call for the scatter
    (with an image, and in the no-image scan form), for the segmented
    reduce, min and max, and for the fused round, at a power-of-two k and
    in its warp-per-transaction form."""
    arrs = _scatter_arrays(np.random.default_rng(9), 1 << 16, 1 << 15)
    args = [_t(a, cuda_device) for a in arrs]
    scan = torch.stack(args[2:])
    key = _t(np.random.default_rng(1).integers(-1, 1 << 14, 1 << 16), cuda_device)
    val = _t(np.random.default_rng(2).integers(0, 1 << 30, 1 << 16), cuda_device)
    assert _ops_per_call(lambda: ops.ssn_scatter_max(*args)) == 1
    assert _ops_per_call(lambda: ops.fused_replay_scan(scan, n_slots=1 << 16)) == 1
    for op in ("max", "min"):
        assert _ops_per_call(lambda: seg_reduce(key, val, 1 << 14, op=op)) == 1
    for n_txn, k in ((1 << 12, 16), (1 << 10, 11)):
        acc, a_len = _validate_arrays(np.random.default_rng(k), n_txn, k, 1 << 14)
        a, n = _t(acc, cuda_device), _t(a_len, cuda_device)
        assert _ops_per_call(lambda: validate_sequence(a, n, n_txn, k, 1 << 14)) == 1


@pytest.mark.parametrize("n_txn,k,cap,edge_pos", [
    (1 << 12, 16, 1 << 14, False),
    (8, 1, 64, False),
    (64, 4, 32, False),
    (1 << 16, 1, 1 << 20, False),   # the write-only round's shape
    (1 << 10, 64, 1 << 12, False),  # k > 32: one warp per transaction
    (1 << 10, 11, 1 << 12, False),  # k not a power of two: the same form
    (1 << 10, 16, 1 << 12, True),
    (1 << 10, 1, 1 << 12, True),
    (1 << 8, 11, 1 << 12, True),
])
def test_validate_sequence_kernel_equals_plain(cuda_device, n_txn, k, cap, edge_pos):
    acc, a_len = _validate_arrays(np.random.default_rng(n_txn * k), n_txn, k, cap, edge_pos)
    a, n = _t(acc, cuda_device), _t(a_len, cuda_device)
    got = ops.fused_validate_sequence(a, n, n_txn=n_txn, k=k, cap=cap)
    torch.cuda.synchronize()
    want = validate_sequence_plain(a, n, n_txn, k, cap)
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int32
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)


def test_validate_sequence_scratch_does_not_leak(cuda_device):
    """Rounds with writers on rows 0..63, then on the same stream rounds
    that read those rows with no writer, at a smaller and a larger cap and
    across the epoch's wrap: each equals the plain version, so no call reads
    an earlier call's first writers."""
    from repro_torch.kernels import batch_occ

    rng = np.random.default_rng(20)
    n_txn, k = 1 << 10, 4
    lanes = n_txn * k
    a_len = _t(np.full(n_txn, k), cuda_device)
    index = torch.cuda.current_device()
    slot = (index, cuda.current_stream(index))

    def round_(cap, writes):
        acc = np.zeros((6, lanes), np.int32)
        acc[0] = rng.integers(0, 64, lanes)
        acc[1] = np.arange(lanes) if writes else np.full(lanes, 1 << 30)
        acc[2] = writes
        acc[3] = -1
        acc[4] = rng.integers(0, 1 << 20, lanes)
        a = _t(acc, cuda_device)
        got = validate_sequence(a, a_len, n_txn, k, cap)
        torch.cuda.synchronize()
        want = validate_sequence_plain(a, a_len, n_txn, k, cap)
        for g, wnt in zip(got, want):
            assert torch.equal(g, wnt), (cap, writes)
        assert writes or bool(got[0].all()), (cap, "a stale first writer")

    for cap in (1 << 10, 1 << 16):      # smaller, then larger (the scratch grows)
        round_(1 << 14, True)
        round_(cap, False)
    batch_occ._fw_scratch[slot][1] = batch_occ._EPOCH_MAX - 1
    for writes in (True, True, False, True, False):    # the epoch wraps on the second call
        round_(1 << 12, writes)
    assert batch_occ._fw_scratch[slot][1] == 4


def test_validate_sequence_refuses_graph_capture(cuda_device):
    """A captured launch would replay a stale epoch, so capture raises and
    the call after it on the same stream still equals the plain version."""
    n_txn, k, cap = 256, 4, 1 << 10
    acc = np.zeros((6, n_txn * k), np.int32)
    acc[0] = np.arange(n_txn * k) % 64
    acc[1] = np.arange(n_txn * k)
    acc[2] = 1
    acc[3] = -1
    a, a_len = _t(acc, cuda_device), _t(np.full(n_txn, k), cuda_device)
    validate_sequence(a, a_len, n_txn, k, cap)         # the scratch exists before capture
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        graph = torch.cuda.CUDAGraph()
        with pytest.raises(RuntimeError, match="CUDA graph"):
            with torch.cuda.graph(graph, stream=stream):
                validate_sequence(a, a_len, n_txn, k, cap)
    got = validate_sequence(a, a_len, n_txn, k, cap)
    want = validate_sequence_plain(a, a_len, n_txn, k, cap)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_validate_sequence_two_threads_on_one_stream(cuda_device):
    """Two host threads launch 200 rounds each on the same (default) stream,
    rounds with writers and rounds that read the same rows with none: each
    result equals the plain version, so no round read the other thread's
    first writers under a shared epoch and no wrap re-zeroed words in use."""
    import sys
    import threading

    from repro_torch.kernels import batch_occ

    n_txn, k, cap = 1 << 8, 4, 1 << 12
    lanes = n_txn * k
    a_len = _t(np.full(n_txn, k), cuda_device)
    index = torch.cuda.current_device()
    slot = (index, cuda.current_stream(index))
    validate_sequence(_t(np.zeros((6, lanes)), cuda_device), a_len, n_txn, k, cap)
    batch_occ._fw_scratch[slot][1] = batch_occ._EPOCH_MAX - 150   # both threads cross the wrap
    failures, done = [], []

    def run(seed):
        rng = np.random.default_rng(seed)
        try:
            for i in range(200):
                writes = i % 2 == 0
                acc = np.zeros((6, lanes), np.int32)
                acc[0] = rng.integers(0, 64, lanes)
                acc[1] = np.arange(lanes) if writes else np.full(lanes, 1 << 30)
                acc[2] = writes
                acc[3] = -1
                acc[4] = rng.integers(0, 1 << 20, lanes)
                a = _t(acc, cuda_device)
                got = validate_sequence(a, a_len, n_txn, k, cap)
                want = validate_sequence_plain(a, a_len, n_txn, k, cap)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    failures.append((seed, i))
            done.append(seed)
        except Exception as e:   # reported by the main thread's assert
            failures.append((seed, repr(e)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(s,)) for s in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not failures, failures[:5]
    assert sorted(done) == [1, 2]
    assert batch_occ._fw_scratch[slot][1] == 400 - 150


def test_stepped_serve_equals_direct_batch_at_4096_lane_cuts(cuda_device, tmp_path):
    """The serving tier's group-commit transparency (P1) on the card: 8,192
    conflict-free write-only specs arriving 2,048 per step, cut at 4,096
    lanes (every cut takes the fused round), give the byte-identical log,
    the same SSNs and the same state as one direct ``execute_batch`` of the
    same specs on a second stack, and acks in admission order."""
    from repro_torch.db import TxnSpec
    from repro_torch.obs import metrics
    from repro_torch.serve import (ACKED, GroupCommitScheduler, ServeConfig, SingleBackend,
                                   run_stepped_schedule)

    rng = np.random.default_rng(22)
    n, per_step = 8192, 2048
    blob = rng.bytes(n * 100)
    specs = [TxnSpec(writes=[(ycsb.key_of(i), blob[100 * i:100 * (i + 1)])]) for i in range(n)]

    def stack(tag):
        cfg = EngineConfig(n_buffers=1, device_kind="null", device_dir=str(tmp_path / tag),
                           device_clock="virtual", flush_interval=60.0)
        return SingleBackend.make("kernel", n_workers=2, cfg=cfg, table_capacity=2 * n,
                                  device="cuda")

    be_s, be_d = stack("serve"), stack("direct")
    reg = metrics.enable()
    try:
        fused0 = reg.counter_value("occ.fused.rounds")
        # a budget of 2 steps: two steps' arrivals fill each 4,096-txn cut
        sched = GroupCommitScheduler(be_s, ServeConfig(max_batch=4096, latency_budget_steps=2,
                                                       queue_capacity=10**6))
        tickets = run_stepped_schedule(sched, [(i // per_step, s) for i, s in enumerate(specs)])
        fused_serve = reg.counter_value("occ.fused.rounds") - fused0
    finally:
        metrics.disable()
    assert all(t.status == ACKED for t in tickets)
    assert [t.ack_seq for t in tickets] == list(range(n))
    assert sched.stats()["exec_errors"] == 0
    assert sched.n_cuts == n // 4096 and sched.n_cut_txns == n
    assert fused_serve == sched.n_cuts
    res = be_d.occ.execute_batch(specs, max_rounds=1)
    assert not res.aborted and list(res.committed_idx) == list(range(n))
    for _ in range(200):
        be_d.tick()
        be_d.drain()
        if all(t.committed for t in res.committed):
            break
    assert [t.ssn for t in tickets] == [t.ssn for t in res.committed]
    assert be_s.table.to_dict() == be_d.table.to_dict()
    for d in be_s.engine.devices + be_d.engine.devices:
        d.close()
    assert [d.read_all() for d in be_s.engine.devices] == \
        [d.read_all() for d in be_d.engine.devices]


def test_kernel_mode_end_to_end_on_the_card(cuda_device, tmp_path):
    """YCSB batches through ``BatchOCC(mode="kernel")`` on the card equal the
    vectorized executor's; the logs recover identically in all three modes,
    with the fused kernel pipeline engaged."""
    n_rows = 4000
    runs = {}
    for mode in ("kernel", "vectorized"):
        tab = ArrayTable()
        ycsb.load(tab, n_rows, seed=1)
        eng = PoplarEngine(EngineConfig(
            n_buffers=2, device_kind="null", device_dir=str(tmp_path / mode),
            flush_interval=60.0, device_clock="virtual", logger_poll=1e-5,
            segment_bytes=2 << 20))
        occ = BatchOCC(tab, eng, n_workers=4, mode=mode, device=cuda_device)
        wo = ycsb.YCSBWriteOnly(n_rows, seed=2)
        hy = ycsb.YCSBHybrid(n_rows, scan_length=10, seed=3)
        out = []
        for b in range(4):
            specs = (wo if b % 2 == 0 else hy).next_batch(3000)
            res = occ.execute_batch(specs, max_rounds=3)
            out.append((res.committed_idx, res.aborted,
                        [(t.tid, t.ssn) for t in res.committed]))
            occ.drain()
            eng.quiesce(range(4))
        for d in eng.devices:
            d.close()
        runs[mode] = (out, tab.to_dict(), eng)
    assert runs["kernel"][:2] == runs["vectorized"][:2]

    devs = runs["kernel"][2].devices
    n0 = cuda.LAUNCHES["ssn_scatter_max"]
    st = recover(devs, mode="kernel", device=cuda_device)
    assert st.report.fused and cuda.LAUNCHES["ssn_scatter_max"] > n0
    for mode in ("vectorized", "scalar"):
        o = recover(devs, mode=mode)
        assert (o.data, o.rsne, o.n_replayed, o.n_skipped_uncommitted) == (
            st.data, st.rsne, st.n_replayed, st.n_skipped_uncommitted)


def _csn_fn(engine):
    """The checkpoint's CSN source: a forced tick of every buffer (a lagging
    one heartbeats up to the frontier), then the CSN."""
    def csn_fn():
        for i in range(len(engine.buffers)):
            engine.logger_tick(i, force=True)
        return engine.commit.advance_csn()

    return csn_fn


def _sharded_crash(tmp_path, n_batches=6):
    """A 3-shard engine in kernel mode on the card: batches with cross-shard
    specs, a fuzzy checkpoint per shard after batch 2, a crash with one shard's
    buffers unflushed and a torn frame on shard 0's first device."""
    import os
    import random

    from repro_torch.core import CheckpointDaemon
    from repro_torch.db import TxnSpec
    from repro_torch.shard import ShardedConfig, ShardedEngine

    eng = ShardedEngine(ShardedConfig(
        n_shards=3, n_buffers=2, n_workers=2, device_kind="ssd", device_clock="virtual",
        device_dir=str(tmp_path / "devs"), table_capacity=1 << 12))
    assert all(sh.occ.mode == "kernel" and sh.occ.device.type == "cuda" for sh in eng.shards)
    rng = random.Random(5)
    keys = [f"user{i:010d}" for i in range(3000)]
    ckpt_dirs = None
    for b in range(n_batches):
        specs = []
        for k in rng.sample(keys, 1200):
            if rng.random() < 0.1:
                specs.append(TxnSpec(writes=[(k, b"x" * 40), (rng.choice(keys), b"y" * 40)]))
            else:
                specs.append(TxnSpec(reads=[k] if rng.random() < 0.2 else [],
                                     writes=[(k, f"{b}:{k}".encode() * 4)]))
        eng.execute_batch(specs, max_rounds=2)
        if b < n_batches - 1:
            eng.quiesce()
        else:                                  # shard 2 dies unflushed
            for sh in eng.shards[:2]:
                for i in range(len(sh.engine.buffers)):
                    sh.engine.logger_tick(i, force=True)
        if b == 1:
            ckpt_dirs = []
            for p, sh in enumerate(eng.shards):
                d = str(tmp_path / f"ckpt{p}")
                CheckpointDaemon(d, n_threads=1, m_files=2, csn_fn=_csn_fn(sh.engine)) \
                    .run_once([sorted((k.encode(), v, s) for k, v, s in sh.table.items() if s > 0)],
                              epoch=1)
                ckpt_dirs.append(d)
    for devs in eng.devices:
        for d in devs:
            d.close()
    with open(os.path.join(str(tmp_path / "devs"), "shard0", "log_0.bin"), "ab") as f:
        f.write(b"\x07" * 9)
    return eng, ckpt_dirs


def test_recover_sharded_kernel_on_the_card_equals_the_cpu(cuda_device, tmp_path):
    """``recover_sharded(mode="kernel")`` on the card gives the state of the
    same call with ``device="cpu"`` and of the vectorized and scalar modes,
    on logs with cross-shard records, a torn tail and checkpoint images."""
    from repro_torch.shard import recover_sharded

    eng, ckpt_dirs = _sharded_crash(tmp_path)

    def view(st):
        return (st.n_cross_seen, st.n_cross_dropped,
                [(s.data, s.rsns, s.rsne, s.n_replayed, s.n_skipped_uncommitted)
                 for s in st.shards])

    n0 = cuda.LAUNCHES["ssn_scatter_max"]
    got = recover_sharded(eng.devices, checkpoint_dirs=ckpt_dirs)      # kernel, cuda
    assert cuda.LAUNCHES["ssn_scatter_max"] >= n0 + 3                  # one per shard
    want = view(got)
    assert want[0] > 0 and all(s.rsns > 0 for s in got.shards)
    assert view(recover_sharded(eng.devices, checkpoint_dirs=ckpt_dirs, mode="kernel",
                                device="cpu")) == want
    for mode in ("vectorized", "scalar"):
        assert view(recover_sharded(eng.devices, checkpoint_dirs=ckpt_dirs, mode=mode)) == want
    assert _scratch_is_clean()


def test_concurrent_appliers_leave_the_scratch_clean(cuda_device, tmp_path):
    """Two replicas tail two engines from their own threads, applying through
    the scatter kernel on the default stream, while this thread launches the
    same kernel there: every result equals the plain version, the cached
    scratch is all zero afterwards, and each promoted state equals
    ``recover()``."""
    import random

    from repro_torch.core import Txn, Worker
    from repro_torch.replica import Replica

    engines, replicas = [], []
    for r in range(2):
        eng = PoplarEngine(EngineConfig(
            n_buffers=2, device_kind="null", device_dir=str(tmp_path / f"e{r}"),
            flush_interval=60.0, device_clock="virtual"))
        engines.append(eng)
        replicas.append(Replica(eng.devices, parallel=False, name=f"r{r}"))
    n0 = cuda.LAUNCHES["ssn_scatter_max"]
    for rep in replicas:
        rep.start(poll_interval=1e-4)
    try:
        rng = random.Random(9)
        workers = [[Worker(eng, i) for i in range(4)] for eng in engines]
        cells = [{f"k{i}": type("Cell", (), {"ssn": 0})() for i in range(64)} for _ in engines]
        for i in range(3000):
            e = i % 2
            ks = rng.sample(sorted(cells[e]), 3)
            t = Txn(tid=10 + i, write_set=[(k, f"{i}".encode() * 8) for k in ks[:2]],
                    read_set=[(ks[2], cells[e][ks[2]].ssn)] if i % 5 == 0 else [])
            workers[e][i % 4].run(t, [cells[e][ks[2]]] if t.read_set else [],
                                  [cells[e][k] for k in ks[:2]])
            if i % 25 == 0:
                for b in range(2):
                    engines[e].logger_tick(b, force=True)
            if i % 100 == 0:
                arrs = _scatter_arrays(np.random.default_rng(i), 1 << (8 + i % 7), 1 << 12)
                args = [_t(a, cuda_device) for a in arrs]
                got = ops.ssn_scatter_max(*args)
                want = ssn_scatter_max_plain(*args)
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), i
        for eng in engines:
            eng.quiesce(range(4))
    finally:
        for rep in replicas:
            rep.stop()
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["ssn_scatter_max"] > n0 + 60
    assert _scratch_is_clean()
    for eng, rep in zip(engines, replicas):
        st = rep.promote()
        ref = recover(eng.devices, mode="vectorized")
        assert (st.data, st.rsne, st.n_replayed, st.n_skipped_uncommitted) == (
            ref.data, ref.rsne, ref.n_replayed, ref.n_skipped_uncommitted)
        assert len(st.data) == 64
    assert _scratch_is_clean()


# --- the LLM kernels -----------------------------------------------------------
# Both versions compute in float32 from the same inputs in another order, so
# they agree to float32 rounding (the reference's kernel-test tolerance,
# tests/test_kernels.py::_tol); a bfloat16 output may then round one ulp
# apart, which is at most 2^-7 of its magnitude.

def _ftol(dtype):
    return dict(atol=1e-3, rtol=2.0 ** -7) if dtype == torch.bfloat16 else dict(atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,hq,hkv,s,t,d,causal,window,softcap",
    [
        (1, 2, 2, 128, 128, 64, True, None, None),
        (2, 4, 2, 256, 256, 128, True, None, None),     # GQA, D=128
        (1, 2, 1, 128, 256, 128, False, None, None),    # bidirectional, T > S
        (2, 2, 2, 256, 256, 64, True, 64, None),        # sliding window
        (1, 2, 2, 128, 128, 64, True, None, 30.0),      # softcap
        (1, 25, 5, 1000, 1000, 64, True, 256, None),    # hymba heads, ragged S
        (1, 2, 1, 77, 133, 128, False, None, None),     # ragged S and T
    ],
)
def test_flash_attention_kernel_matches_plain(cuda_device, b, hq, hkv, s, t, d, causal,
                                              window, softcap, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(s * t + d)
    q = torch.randn(b, hq, s, d, generator=g, device=cuda_device).to(dtype)
    k = torch.randn(b, hkv, t, d, generator=g, device=cuda_device).to(dtype)
    v = torch.randn(b, hkv, t, d, generator=g, device=cuda_device).to(dtype)
    n0 = cuda.LAUNCHES["flash_attention"]
    got = flash_attention_fwd(q, k, v, causal=causal, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["flash_attention"] == n0 + 1
    want = flash_attention_plain(q, k, v, causal=causal, window=window, softcap=softcap)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **_ftol(dtype))


def test_flash_attention_kernel_takes_model_layout(cuda_device):
    """(B, S, H, D) activations passed as (B, H, S, D) views: no copy, and
    the output comes back in the same layout."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q = torch.randn(2, 200, 10, 64, generator=g, device=cuda_device)
    k = torch.randn(2, 200, 2, 64, generator=g, device=cuda_device)
    v = torch.randn(2, 200, 2, 64, generator=g, device=cuda_device)
    qv, kv, vv = (x.transpose(1, 2) for x in (q, k, v))
    got = flash_attention_fwd(qv, kv, vv, window=64)
    assert got.transpose(1, 2).is_contiguous()
    want = flash_attention_plain(qv, kv, vv, window=64)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)


# The bf16 kernel (tensor cores, TMA loads) at the serve path's shapes and
# at its edges, with the model's (B, S, H, D) activations passed as
# (B, H, S, D) views: hymba's full prefill, qwen2-1.5b's and grok's D = 128
# heads, keys past the queries, ragged S and T with a window that cuts a
# tile, and peaky early rows that a single bf16 rounding of P would fail.
BF16_CASES = [
    # (b, hq, hkv, s, t, d, causal, window, softcap, q scale)
    (8, 25, 5, 2048, 2048, 64, True, 1024, None, 1.0),    # hymba prefill, windowed layers
    (8, 25, 5, 2048, 2048, 64, True, None, None, 1.0),    # hymba prefill, full layers
    (2, 12, 2, 2048, 2048, 128, True, None, None, 1.0),   # qwen2-1.5b heads
    (1, 48, 8, 512, 512, 128, True, None, 30.0, 1.0),     # grok heads and softcap
    (2, 4, 2, 300, 700, 64, False, None, None, 1.0),      # bidirectional, T > S
    (2, 4, 2, 300, 700, 128, False, None, None, 1.0),
    (1, 2, 1, 1, 1, 64, True, 37, None, 1.0),             # ragged S and T
    (1, 5, 1, 63, 63, 64, True, 37, None, 1.0),
    (2, 4, 2, 65, 65, 128, True, 37, None, 1.0),
    (2, 5, 1, 129, 129, 64, True, 37, None, 1.0),
    (1, 4, 2, 65, 129, 64, True, 100, None, 1.0),         # S < T, causal
    (2, 5, 1, 512, 512, 64, True, None, None, 8.0),       # peaky softmax
    (1, 4, 1, 512, 512, 128, True, 200, None, 8.0),
]


@pytest.mark.parametrize("b,hq,hkv,s,t,d,causal,window,softcap,qscale", BF16_CASES)
def test_flash_attention_bf16_kernel_cases(cuda_device, b, hq, hkv, s, t, d, causal, window,
                                           softcap, qscale):
    g = torch.Generator(device=cuda_device).manual_seed(s * 31 + t + d)
    q = (qscale * torch.randn(b, s, hq, d, generator=g, device=cuda_device)).bfloat16()
    k = torch.randn(b, t, hkv, d, generator=g, device=cuda_device).bfloat16()
    v = torch.randn(b, t, hkv, d, generator=g, device=cuda_device).bfloat16()
    qv, kv, vv = (x.transpose(1, 2) for x in (q, k, v))
    n0 = cuda.LAUNCHES["flash_attention"]
    got = flash_attention_fwd(qv, kv, vv, causal=causal, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["flash_attention"] == n0 + 1
    assert got.transpose(1, 2).is_contiguous()
    want = flash_attention_plain(qv, kv, vv, causal=causal, window=window, softcap=softcap)
    torch.testing.assert_close(got.float(), want.float(), **_ftol(torch.bfloat16))


def test_flash_attention_bf16_kernel_refuses_unaligned_strides(cuda_device):
    """A bf16 view whose position stride (68 elements, 136 B) is not a
    multiple of 16 B cannot be read by TMA: the wrapper raises, launches
    nothing and copies nothing."""
    base = torch.randn(1, 2, 40, 68, device=cuda_device).bfloat16()
    q = base[..., :64]
    k = torch.randn(1, 2, 40, 64, device=cuda_device).bfloat16()
    n0 = cuda.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="position stride"):
        flash_attention_fwd(q, k, k)
    with pytest.raises(ValueError, match="position stride"):
        flash_attention_fwd(k, q, q)
    assert cuda.LAUNCHES["flash_attention"] == n0
    # the same view of float32 values (272 B) is taken: the CUDA-core kernel
    # reads any strides
    q32 = base.float()[..., :64]
    got = flash_attention_fwd(q32, k.float(), k.float())
    want = flash_attention_plain(q32, k.float(), k.float())
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)
    # head dim 160 on the tensor-core kernel: a position stride of 164
    # elements (328 B)
    q160 = torch.randn(1, 2, 40, 164, device=cuda_device).bfloat16()[..., :160]
    k160 = torch.randn(1, 2, 40, 160, device=cuda_device).bfloat16()
    n0 = cuda.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="position stride"):
        flash_attention_fwd(q160, k160, k160)
    with pytest.raises(ValueError, match="position stride"):
        flash_attention_fwd(k160, q160, q160)
    assert cuda.LAUNCHES["flash_attention"] == n0


# Head dim 160 (stablelm-12b): bf16 on the tensor-core kernel (64-key
# tiles in five 64-B-swizzled boxes), fp32 on the CUDA-core kernel, with the
# model's (B, S, H, D) layout, the log-sum-exp output, GQA, window, softcap
# and ragged S and T.
D160_CASES = [
    # (b, hq, hkv, s, t, causal, window, softcap)
    (2, 32, 8, 1024, 1024, True, None, None),     # stablelm-12b's heads
    (1, 4, 1, 300, 300, True, 64, None),          # window, ragged S
    (1, 4, 2, 200, 200, True, None, 30.0),        # softcap
    (1, 6, 2, 150, 150, True, 40, 20.0),          # window and softcap
    (1, 2, 1, 77, 133, False, None, None),        # bidirectional, ragged S and T
    (2, 4, 2, 333, 301, True, 100, None),         # window; S % 128, T % 64 != 0: TMA's zero fill
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,t,causal,window,softcap", D160_CASES)
def test_flash_attention_head_dim_160_matches_plain(cuda_device, b, hq, hkv, s, t, causal, window,
                                                    softcap, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(s * 7 + t + hq)
    q = torch.randn(b, s, hq, 160, generator=g, device=cuda_device).to(dtype).transpose(1, 2)
    k = torch.randn(b, t, hkv, 160, generator=g, device=cuda_device).to(dtype).transpose(1, 2)
    v = torch.randn(b, t, hkv, 160, generator=g, device=cuda_device).to(dtype).transpose(1, 2)
    kw = dict(causal=causal, window=window, softcap=softcap)
    n0 = cuda.LAUNCHES["flash_attention"]
    o, lse = flash_attention_fwd(q, k, v, return_lse=True, **kw)
    o_alone = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["flash_attention"] == n0 + 2
    assert torch.equal(o, o_alone) and o.dtype == dtype
    assert o.transpose(1, 2).is_contiguous()
    want_o, want_lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(o.float(), want_o.float(), **_ftol(dtype))
    torch.testing.assert_close(lse, want_lse, atol=2e-4, rtol=2e-4)


def test_flash_attention_head_dim_160_kernels_by_name(cuda_device):
    """Under the profiler, at stablelm-12b's heads: one bf16 call is one
    device operation, the tensor-core kernel; fp32 keeps the CUDA-core
    kernel."""
    g = torch.Generator(device=cuda_device).manual_seed(160)
    for dtype, name in ((torch.bfloat16, "flash_fwd_wgmma_kernel<160>"),
                        (torch.float32, "flash_fwd_kernel<160>")):
        q, k, v = (torch.randn(1, 256, h, 160, generator=g, device=cuda_device).to(dtype)
                   .transpose(1, 2) for h in (32, 8, 8))
        ops = _device_ops(lambda: flash_attention_fwd(q, k, v))
        assert sum(ops.values()) == 10, ops
        assert [re.search(r"flash_fwd_\w*kernel<\d+>", key)[0] for key in ops] == [name], ops


# The encoder-decoder, MoE and VLM families' flash configurations at their
# full widths and sequence lengths, at a reduced batch (and, for mixtral's
# window, 12 of its 48 query heads, so the plain version's (B, H, S, T)
# float32 scores fit): whisper's bidirectional encoder (a last 64-key tile
# of 28 keys) and cross-attention (S != T), mixtral's 4096-token window over
# an 8192-token prompt, grok's softcap at its 48 / 8 heads of 128.
FAMILY_CASES = [
    # (b, hq, hkv, s, t, d, causal, window, softcap, dtypes)
    (1, 16, 16, 1500, 1500, 64, False, None, None, (torch.float32, torch.bfloat16)),
    (2, 16, 16, 384, 1500, 64, False, None, None, (torch.bfloat16,)),
    (1, 12, 2, 8192, 8192, 128, True, 4096, None, (torch.bfloat16,)),
    (1, 48, 8, 2048, 2048, 128, True, None, 30.0, (torch.bfloat16,)),
]


@pytest.mark.parametrize("case,dtype", [(c, dt) for c in FAMILY_CASES for dt in c[-1]])
def test_flash_attention_family_shapes_match_plain(cuda_device, case, dtype):
    b, hq, hkv, s, t, d, causal, window, softcap, _ = case
    g = torch.Generator(device=cuda_device).manual_seed(s + t + hq)
    q = torch.randn(b, s, hq, d, generator=g, device=cuda_device).to(dtype).transpose(1, 2)
    k = torch.randn(b, t, hkv, d, generator=g, device=cuda_device).to(dtype).transpose(1, 2)
    v = torch.randn(b, t, hkv, d, generator=g, device=cuda_device).to(dtype).transpose(1, 2)
    kw = dict(causal=causal, window=window, softcap=softcap)
    n0 = cuda.LAUNCHES["flash_attention"]
    o, lse = flash_attention_fwd(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["flash_attention"] == n0 + 1
    assert o.dtype == dtype and o.transpose(1, 2).is_contiguous()
    want_o, want_lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(o.float(), want_o.float(), **_ftol(dtype))
    torch.testing.assert_close(lse, want_lse, atol=2e-4, rtol=2e-4)


def test_flash_attention_refuses_other_head_dims(cuda_device):
    q = torch.randn(1, 2, 16, 96, device=cuda_device)
    n0 = cuda.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="head dim 64, 128 or 160, not 96"):
        flash_attention_fwd(q, q, q)
    assert cuda.LAUNCHES["flash_attention"] == n0


def _ssm_inputs(b, h, s, p, n, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, h, s, p, generator=g, device=dev).to(dtype)
    dt = 0.01 + 0.19 * torch.rand(b, h, s, generator=g, device=dev)
    decay = 0.7 + 0.299 * torch.rand(b, h, s, generator=g, device=dev)
    bm = torch.randn(b, s, n, generator=g, device=dev).to(dtype)
    cm = torch.randn(b, s, n, generator=g, device=dev).to(dtype)
    return x, dt, decay, bm, cm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,h,s,p,n",
    [(1, 2, 128, 16, 8), (2, 3, 64, 32, 16), (1, 1, 256, 8, 4),
     (2, 25, 1000, 64, 16), (1, 2, 77, 96, 32),
     (2, 25, 50, 64, 16),       # one chunk: a state pass of one step
     (1, 4, 4096, 64, 16),      # 64 chunks
     (1, 1, 300, 64, 16),       # B*H = 1 at hymba's widths
     (1, 3, 100, 30, 8)],       # P % 4 != 0: rows move element by element
)
def test_ssm_scan_kernel_matches_plain(cuda_device, b, h, s, p, n, dtype):
    args = _ssm_inputs(b, h, s, p, n, dtype, cuda_device, s + p)
    n0 = cuda.LAUNCHES["ssm_scan_chunked"]
    y, st = ssm_scan_chunked(*args)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["ssm_scan_chunked"] == n0 + 1
    yw, stw = ssm_scan_chunked_plain(*args)
    assert y.dtype == dtype and st.dtype == torch.float32
    torch.testing.assert_close(y.float(), yw.float(), **_ftol(dtype))
    torch.testing.assert_close(st, stw, atol=2e-4, rtol=2e-4)


def test_ssm_scan_kernel_strong_decay_is_finite(cuda_device):
    """Decay at the 1e-30 clamp in some steps: exp(la) underflows to 0 from
    there on in the chunk, and every exponent stays a difference <= 0."""
    x, dt, decay, bm, cm = _ssm_inputs(2, 25, 1000, 64, 16, torch.float32, cuda_device, 5)
    g = torch.Generator(device=cuda_device).manual_seed(6)
    hit = torch.rand(decay.shape, generator=g, device=cuda_device) < 0.05
    decay = torch.where(hit, torch.full_like(decay, 1e-30), decay)
    decay[:, :, 64:70] = 0.0            # below the clamp
    y, st = ssm_scan_chunked(x, dt, decay, bm, cm)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    yw, stw = ssm_scan_chunked_plain(x, dt, decay, bm, cm)
    torch.testing.assert_close(y, yw, **_ftol(torch.float32))
    torch.testing.assert_close(st, stw, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_kernel_is_deterministic(cuda_device, dtype):
    """No atomics: two calls on the same inputs give the same bits."""
    args = _ssm_inputs(2, 25, 1000, 64, 16, dtype, cuda_device, 11)
    y1, st1 = ssm_scan_chunked(*args)
    y2, st2 = ssm_scan_chunked(*args)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(st1, st2)


def test_ssm_scan_kernel_takes_model_layout(cuda_device):
    """(B, S, H, P) activations and (B, S, H) steps as (B, H, S, ...) views."""
    x, dt, decay, bm, cm = _ssm_inputs(2, 5, 150, 64, 16, torch.float32, cuda_device, 9)
    xs = x.transpose(1, 2).contiguous().transpose(1, 2)
    dts = dt.transpose(1, 2).contiguous().transpose(1, 2)
    ds = decay.transpose(1, 2).contiguous().transpose(1, 2)
    y, st = ssm_scan_chunked(xs, dts, ds, bm, cm)
    assert y.transpose(1, 2).is_contiguous()
    yw, stw = ssm_scan_chunked_plain(x, dt, decay, bm, cm)
    torch.testing.assert_close(y, yw, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(st, stw, atol=2e-4, rtol=2e-4)


def test_llm_serve_path_on_the_card_matches_the_cpu(cuda_device):
    """Reduced hymba with head dim 64 (the kernel's width), float32, TF32
    off: the card's prefill (both kernels) and decode steps equal the CPU's
    (the kernels' plain versions) on the same weights and tokens."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config("hymba-1.5b"), head_dim=64, n_heads=4, n_kv_heads=2)
    cpu = build_model(cfg, device="cpu", dtype=torch.float32).init(torch.Generator().manual_seed(0))
    gpu = build_model(cfg, device=cuda_device, dtype=torch.float32)
    gpu.lm.load_state_dict(cpu.lm.state_dict())
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 100)).astype(np.int32))
    n0 = dict(cuda.LAUNCHES)
    want, wc = cpu.prefill({"tokens": toks[:, :90]}, 128)
    got, gc = gpu.prefill({"tokens": toks[:, :90].to(cuda_device)}, 128)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["flash_attention"] - n0["flash_attention"] == cfg.n_layers
    assert cuda.LAUNCHES["ssm_scan_chunked"] - n0["ssm_scan_chunked"] == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    for g, w in zip(gc, wc):
        for k in w:
            torch.testing.assert_close(g[k].cpu(), w[k], atol=1e-4, rtol=1e-4)
    for i in range(90, 100):
        want, wc = cpu.decode_step(wc, toks[:, i:i + 1], i)
        got, gc = gpu.decode_step(gc, toks[:, i:i + 1].to(cuda_device), i)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


def _family_inputs(cfg, rng, b, s, dev):
    """Tokens, then ``draw_extras`` (a vlm's patch or an encoder-decoder's
    frame embeddings), from ``rng``."""
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             **draw_extras(cfg, rng, b)}
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


@pytest.mark.parametrize("s,t,k_common,pins_one_pass", [
    pytest.param(448, 1500, 100.0, False, id="448-1500"),
    pytest.param(1500, 1500, 100.0, False, id="1500-1500"),
    pytest.param(448, 1500, 300.0, True, id="448-1500-keys300"),
    pytest.param(1500, 1500, 300.0, True, id="1500-1500-keys300"),
])
def test_flash_backward_on_the_card_tracks_a_float64_backward(cuda_device, s, t, k_common,
                                                              pins_one_pass):
    """``_Flash`` on the card (the kernel's float32 forward and log-sum-exp,
    then the torch-op backward) at whisper-medium's cross-attention (448
    decoder queries over 1,500 frames) and encoder shapes, 16 heads of 64,
    bidirectional, on near-uniform rows: keys with a common part 100 or 300
    times their spread.  Each of dq, dk and dv stays within the larger of
    1e-4 and twice the distance of float32 autograd through the plain
    attention on the card (the float32 floor, near 1e-4 for dq at 100) from
    the float64 backward (TF32 off).

    The one-pass backward that takes ``dsum = do · out`` and each row's
    normaliser from the kernel's forward, built here, misses that bound at a
    common part of 300.  At 100 it lands near the bound, on either side, so
    those inputs cannot tell the two forms apart and are not asked to.  Each
    case prints both backwards' distances over the bound."""
    from repro_torch.models.attention import attend

    def plain(q, k, v):
        scores = torch.einsum("bshd,bthd->bhst", q, k) / 8.0
        return torch.einsum("bhst,bthd->bshd", torch.softmax(scores, dim=-1), v)

    def one_pass(q, k, v, do):
        """dsum = do · out and p = exp(scores - lse), out and lse from the
        kernel's forward."""
        q, k, v, do = (x.detach().transpose(1, 2) for x in (q, k, v, do))    # (B, H, S, D)
        out, lse = flash_attention_fwd(q, k, v, causal=False, return_lse=True)
        p = torch.exp(q @ k.transpose(-1, -2) / 8.0 - lse[..., None])
        ds = p * (do @ v.transpose(-1, -2) - (do * out).sum(-1, keepdim=True))
        grads = (ds @ k / 8.0, ds.transpose(-1, -2) @ q / 8.0, p.transpose(-1, -2) @ do)
        return [x.transpose(1, 2) for x in grads]

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    q = 0.05 * torch.randn(1, s, 16, 64, generator=gen)
    k = k_common + torch.randn(1, t, 16, 64, generator=gen)
    v = torch.randn(1, t, 16, 64, generator=gen)
    do = torch.randn(1, s, 16, 64, generator=gen)
    leaves = [x.to(cuda_device).requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad(attend(*leaves, causal=False), leaves, do.to(cuda_device))
    floor = torch.autograd.grad(plain(*leaves), leaves, do.to(cuda_device))
    exact = [x.double().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(plain(*exact), exact, do.double())

    def rel(g, w):
        return float((g.cpu().double() - w).abs().max() / w.abs().max())

    limits = [max(1e-4, 2 * rel(f, w)) for f, w in zip(floor, want)]
    kept = [rel(g, w) / limit for g, w, limit in zip(got, want, limits)]
    misses = [rel(g, w) / limit for g, w, limit in zip(one_pass(*leaves, do.to(cuda_device)),
                                                        want, limits)]
    print(f"dq, dk, dv over the bound: kept {kept}, one-pass {misses}")
    assert max(kept) <= 1, (kept, limits)
    if pins_one_pass:
        assert max(misses) > 1, misses


@pytest.mark.parametrize("arch", ["whisper-medium", "mixtral-8x22b", "llava-next-mistral-7b"])
def test_family_serve_path_on_the_card_matches_the_cpu(cuda_device, arch):
    """Reduced whisper (encoder, causal and cross attention), mixtral (MoE,
    window) and llava (the patch prefix) with head dim 64 (the kernel's
    width), float32, TF32 off: the card's prefill (the flash kernel) and
    decode steps equal the CPU's on the same weights and inputs."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config(arch), head_dim=64, n_heads=4, n_kv_heads=2)
    cpu = build_model(cfg, device="cpu", dtype=torch.float32).init(torch.Generator().manual_seed(0))
    gpu = build_model(cfg, device=cuda_device, dtype=torch.float32)
    gpu.lm.load_state_dict(cpu.lm.state_dict())
    rng = np.random.default_rng(0)
    batch = _family_inputs(cfg, rng, 2, 90, "cpu")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 10)).astype(np.int32))
    prefix = cfg.vlm.n_patches if cfg.vlm is not None else 0
    n0 = dict(cuda.LAUNCHES)
    want, wc = cpu.prefill(batch, 128)
    got, gc = gpu.prefill({k: v.to(cuda_device) for k, v in batch.items()}, 128)
    torch.cuda.synchronize()
    launched = {name: cuda.LAUNCHES[name] - n0[name] for name in n0}
    assert launched == {name: attention_calls(cfg) if name == "flash_attention" else 0
                        for name in launched}
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    for k, (g, w) in _cache_pairs(gc, wc):
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-4, msg=k)
    for i in range(10):
        want, wc = cpu.decode_step(wc, toks[:, i:i + 1], prefix + 90 + i)
        got, gc = gpu.decode_step(gc, toks[:, i:i + 1].to(cuda_device), prefix + 90 + i)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


def _cache_pairs(got, want):
    """(name, got, want) over a decoder-only LM's list of group caches or
    an encoder-decoder's dict."""
    if isinstance(want, dict):
        return [(k, (got[k], want[k])) for k in want]
    return [(f"{i}.{k}", (g[k], w[k])) for i, (g, w) in enumerate(zip(got, want)) for k in w]


def _rwkv6_inputs(b, h, s, kd, vd, dtype, dev, seed, w_lo=0.5):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = (0.5 * torch.randn(b, h, s, kd, generator=g, device=dev)).to(dtype)
    k = (0.5 * torch.randn(b, h, s, kd, generator=g, device=dev)).to(dtype)
    v = torch.randn(b, h, s, vd, generator=g, device=dev).to(dtype)
    w = w_lo + (0.999 - w_lo) * torch.rand(b, h, s, kd, generator=g, device=dev)
    u = 0.5 * torch.randn(h, kd, generator=g, device=dev)
    return r, k, v, w, u


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,h,s,kd,vd",
    [(1, 2, 64, 16, 16), (2, 4, 100, 16, 16), (1, 1, 96, 64, 64), (2, 8, 1000, 64, 64),
     (1, 2, 77, 64, 64), (1, 3, 33, 32, 48),
     # rwkv6-7b's heads across the state chunks (128 steps) and inner chunks
     # (32): one step, a ragged inner chunk, one whole state chunk, one step
     # past it, a ragged tail of 5 in a fourth state chunk, and the main shape
     (1, 64, 1, 64, 64), (1, 64, 31, 64, 64), (1, 64, 128, 64, 64),
     (1, 64, 129, 64, 64), (1, 64, 389, 64, 64), (1, 64, 2048, 64, 64),
     (2, 3, 150, 30, 18)],      # K, V % 4 != 0: rows move element by element
)
def test_rwkv6_kernel_matches_plain(cuda_device, b, h, s, kd, vd, dtype):
    args = _rwkv6_inputs(b, h, s, kd, vd, dtype, cuda_device, s + kd)
    n0 = cuda.LAUNCHES["rwkv6_chunked"]
    y, st = rwkv6_chunked(*args)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["rwkv6_chunked"] == n0 + 1
    yw, stw = rwkv6_chunked_plain(*args)
    assert y.dtype == dtype and st.dtype == torch.float32 and st.shape == (b, h, kd, vd)
    torch.testing.assert_close(y.float(), yw.float(), **_ftol(dtype))
    torch.testing.assert_close(st, stw, atol=2e-4, rtol=2e-4)


def test_rwkv6_kernel_strong_decay_is_finite(cuda_device):
    r, k, v, _, u = _rwkv6_inputs(2, 2, 200, 64, 64, torch.float32, cuda_device, 1)
    w = torch.full_like(r, 0.01)
    y, st = rwkv6_chunked(r, k, v, w, u)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    yw, stw = rwkv6_chunked_plain(r, k, v, w, u)
    torch.testing.assert_close(y, yw, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(st, stw, atol=2e-4, rtol=2e-4)


def test_rwkv6_kernel_clamped_decay_matches_plain(cuda_device):
    """5% of decays at the 1e-30 clamp and a run of 40 clamped steps across
    the state-chunk boundary at 128: the state chunk's decay underflows to 0,
    and every exponent stays a difference of cumsums within one inner chunk."""
    r, k, v, w, u = _rwkv6_inputs(2, 4, 1000, 64, 64, torch.float32, cuda_device, 12)
    g = torch.Generator(device=cuda_device).manual_seed(13)
    hit = torch.rand(w.shape, generator=g, device=cuda_device) < 0.05
    w = torch.where(hit, torch.full_like(w, 1e-30), w)
    w[:, :, 108:148] = 1e-30
    y, st = rwkv6_chunked(r, k, v, w, u)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    yw, stw = rwkv6_chunked_plain(r, k, v, w, u)
    torch.testing.assert_close(y, yw, **_ftol(torch.float32))
    torch.testing.assert_close(st, stw, **_ftol(torch.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_kernel_three_device_operations_per_call(cuda_device, dtype):
    """Under the profiler: the state kernel, the state pass and the output
    kernel, and nothing else (the scratch is allocated, not filled)."""
    args = _rwkv6_inputs(2, 64, 1000, 64, 64, dtype, cuda_device, 14)
    assert _ops_per_call(lambda: rwkv6_chunked(*args), per_call=3) == 3


def test_rwkv6_kernel_takes_model_layout(cuda_device):
    """(B, S, H, K) activations as (B, H, S, K) views; y comes back in the
    same layout."""
    r, k, v, w, u = _rwkv6_inputs(2, 6, 150, 64, 64, torch.float32, cuda_device, 9)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (r, k, v, w)]
    y, st = rwkv6_chunked(*views, u)
    assert y.transpose(1, 2).is_contiguous()
    yw, stw = rwkv6_chunked_plain(r, k, v, w, u)
    torch.testing.assert_close(y, yw, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(st, stw, atol=2e-4, rtol=2e-4)


def test_rwkv6_kernel_refuses_what_it_does_not_take(cuda_device):
    r, k, v, w, u = _rwkv6_inputs(1, 2, 40, 16, 16, torch.float32, cuda_device, 2)
    with pytest.raises(TypeError):
        rwkv6_chunked(r, k.bfloat16(), v, w, u)
    with pytest.raises(TypeError):
        rwkv6_chunked(r, k, v, w.double(), u)
    big = torch.zeros(1, 2, 40, 80, device=cuda_device)
    with pytest.raises(ValueError):
        rwkv6_chunked(big, big, big, big, torch.zeros(2, 80, device=cuda_device))


def test_rwkv_serve_path_on_the_card_matches_the_cpu(cuda_device):
    """Reduced rwkv6 (head dim 16), float32, TF32 off: the card's prefill
    (the wkv6 kernel, a ragged 90-token prompt) and decode steps equal the
    CPU's on the same weights and tokens."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config("rwkv6-7b"))
    cpu = build_model(cfg, device="cpu", dtype=torch.float32).init(torch.Generator().manual_seed(0))
    gpu = build_model(cfg, device=cuda_device, dtype=torch.float32)
    gpu.lm.load_state_dict(cpu.lm.state_dict())
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 100)).astype(np.int32))
    n0 = dict(cuda.LAUNCHES)
    want, wc = cpu.prefill({"tokens": toks[:, :90]}, 128)
    got, gc = gpu.prefill({"tokens": toks[:, :90].to(cuda_device)}, 128)
    torch.cuda.synchronize()
    launched = {name: cuda.LAUNCHES[name] - n0[name] for name in n0}
    assert launched["rwkv6_chunked"] == cfg.n_layers
    assert launched["flash_attention"] == 0 and launched["ssm_scan_chunked"] == 0
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    for g, w in zip(gc, wc):
        for k in w:
            torch.testing.assert_close(g[k].cpu(), w[k], atol=1e-4, rtol=1e-4)
    for i in range(90, 100):
        want, wc = cpu.decode_step(wc, toks[:, i:i + 1], i)
        got, gc = gpu.decode_step(gc, toks[:, i:i + 1].to(cuda_device), i)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


# --- training: the flash kernel's log-sum-exp, _Flash, the train step ------------------
# The log-sum-exp is float32 from both sides (the bf16 kernel's from its
# float32 row max and sum), so it holds the float32 attention tolerance.

LSE_CASES = [
    # (b, hq, hkv, s, d, window, softcap)
    (2, 32, 4, 512, 64, None, None),      # tinyllama's heads
    (2, 25, 5, 1000, 64, 256, None),      # hymba's heads, ragged S, window
    (1, 12, 2, 300, 128, None, 30.0),     # D = 128, softcap
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,d,window,softcap", LSE_CASES)
def test_flash_attention_lse_matches_plain(cuda_device, b, hq, hkv, s, d, window, softcap, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(s + d)
    q = torch.randn(b, s, hq, d, generator=g, device=cuda_device).to(dtype).transpose(1, 2)
    k = torch.randn(b, s, hkv, d, generator=g, device=cuda_device).to(dtype).transpose(1, 2)
    v = torch.randn(b, s, hkv, d, generator=g, device=cuda_device).to(dtype).transpose(1, 2)
    kw = dict(window=window, softcap=softcap)
    n0 = cuda.LAUNCHES["flash_attention"]
    o, lse = flash_attention_fwd(q, k, v, return_lse=True, **kw)
    o_alone = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["flash_attention"] == n0 + 2
    assert torch.equal(o, o_alone)                 # asking for lse leaves o bit for bit
    want_o, want_lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    assert lse.shape == (b, hq, s) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want_lse, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(o.float(), want_o.float(), **_ftol(dtype))


def _plain_attend(q, k, v, window, softcap):
    from repro_torch.kernels.flash_attention import flash_attention_plain as plain

    out = plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), window=window,
                softcap=softcap)
    return out.transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,hq,hkv,d,window,softcap", [
    (300, 8, 2, 64, None, None),
    (300, 4, 4, 128, None, None),
    (1100, 4, 1, 64, 256, None),        # window; S past the backward's chunk of 1024
    (200, 4, 2, 64, None, 20.0),        # softcap
])
def test_flash_gradients_match_autograd_over_plain(cuda_device, s, hq, hkv, d, window, softcap,
                                                   dtype):
    """``_Flash`` (kernel forward, torch-op backward) against autograd
    through the plain version; float32 at 1e-4, bfloat16 at 3e-2 (each side
    rounds its gradients to bfloat16 on its own) relative to the leaf's
    largest gradient; TF32 off."""
    from repro_torch.models.attention import attend

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(s + hq)
    q = torch.randn(2, s, hq, d, generator=g, device=cuda_device).to(dtype)
    k = torch.randn(2, s, hkv, d, generator=g, device=cuda_device).to(dtype)
    v = torch.randn(2, s, hkv, d, generator=g, device=cuda_device).to(dtype)
    w = torch.randn(2, s, hq, d, generator=g, device=cuda_device)
    grads = []
    for fn in (lambda *a: attend(*a, window=window, logit_softcap=softcap),
               lambda *a: _plain_attend(*a, window, softcap)):
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        n0 = cuda.LAUNCHES["flash_attention"]
        (fn(*leaves).float() * w).sum().backward()
        grads.append([x.grad.float() for x in leaves])
    assert cuda.LAUNCHES["flash_attention"] == n0        # the plain pass launched nothing
    rel = 1e-4 if dtype == torch.float32 else 3e-2
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=rel, atol=rel * float(want.abs().max()))


# --- the backward kernel (flash_attention_bwd) against its plain twin (_flash_bwd) ---

def _bwd_inputs(gen, b, s, hq, hkv, dev, k_common=0.0, q_scale=1.0):
    """bf16 q, k, v and do in the model's (B, S, H, D) layout at head dim 64."""
    q = q_scale * torch.randn(b, s, hq, 64, generator=gen)
    k = k_common + torch.randn(b, s, hkv, 64, generator=gen)
    v = torch.randn(b, s, hkv, 64, generator=gen)
    do = torch.randn(b, s, hq, 64, generator=gen)
    return [x.to(dev, torch.bfloat16) for x in (q, k, v, do)]


def _kernel_and_plain_bwd(q, k, v, do, window):
    """The kernel's and ``_flash_bwd``'s gradients on the same inputs and the
    forward kernel's log-sum-exp, both in the model's (B, S, H, D) layout."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.models.attention import _flash_bwd

    _, lse = flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                 window=window, return_lse=True)
    n0 = cuda.LAUNCHES["flash_attention_bwd"]
    got = flash_attention_bwd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), lse,
                              do.transpose(1, 2), window=window)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["flash_attention_bwd"] == n0 + 1
    want = _flash_bwd(q, k, v, lse, do, True, window, None)
    return [g.transpose(1, 2) for g in got], want


@pytest.mark.parametrize("b,s,hq,hkv,window", [
    pytest.param(2, 2048, 25, 5, 1024, id="hymba-window"),
    pytest.param(2, 2048, 25, 5, None, id="hymba-full"),
    pytest.param(2, 2048, 32, 4, None, id="tinyllama"),
    pytest.param(2, 1000, 25, 5, 256, id="ragged-window"),
    pytest.param(1, 77, 8, 8, None, id="one-ragged-tile"),
])
def test_flash_attention_bwd_matches_plain(cuda_device, b, s, hq, hkv, window):
    """The kernel's dq, dk and dv against ``_flash_bwd`` on the same bf16
    inputs at hymba-1.5b's heads (25 query / 5 KV of 64, its window of 1024
    and its full causal layers), tinyllama-1.1b's (32 / 4) and ragged
    lengths, within 3e-2 of each leaf's largest gradient (each side rounds
    its gradients to bf16 on its own; the kernel's P and dS enter the
    tensor cores in bf16)."""
    gen = torch.Generator().manual_seed(s + hq)
    got, want = _kernel_and_plain_bwd(*_bwd_inputs(gen, b, s, hq, hkv, cuda_device), window)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert torch.isfinite(g.float()).all()
        torch.testing.assert_close(g.float(), w.float(), rtol=3e-2,
                                   atol=3e-2 * float(w.float().abs().max()))


def _causal_plain(q, k, v):
    """Causal attention in the inputs' dtype, (B, S, H, D), GQA by repetition."""
    g = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q, k) / 8.0
    s = q.shape[1]
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, v)


@pytest.mark.parametrize("k_common,pins_one_pass", [
    pytest.param(100.0, True, id="keys100"),
    pytest.param(300.0, True, id="keys300"),
])
def test_flash_attention_bwd_tracks_a_float64_backward(cuda_device, k_common, pins_one_pass):
    """The row-sum repair on the kernel's path: causal bf16 attention on
    near-uniform rows (1,024 queries of 8 heads over 2 KV heads, keys with
    a common part 100 or 300 times their spread), against a float64
    backward of the same bf16-valued inputs.  Each of dq, dk and dv stays
    within twice the distance of ``_flash_bwd`` on the same inputs (float32
    torch ops, its gradients rounded to bf16 as it returns them).

    A one-pass backward built here, ``dsum = do · out`` with the forward
    kernel's bf16 output and the forward's normaliser, in float32 with its
    gradients rounded to bf16, misses that bound where ``pins_one_pass``
    says (as it did on the card).  Each case prints both distances over
    the bound."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(int(k_common))
    q, k, v, do = _bwd_inputs(gen, 1, 1024, 8, 2, cuda_device, k_common=k_common, q_scale=0.05)
    got, plain = _kernel_and_plain_bwd(q, k, v, do, None)
    exact = [x.cpu().double().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(_causal_plain(*exact), exact, do.cpu().double())

    def one_pass():
        qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))    # (B, H, S, D)
        out, lse = flash_attention_fwd(qh, kh, vh, return_lse=True)
        kr, vr = (x.repeat_interleave(4, dim=1).float() for x in (kh, vh))
        qf, dof = qh.float(), doh.float()
        mask = torch.ones(1024, 1024, dtype=torch.bool, device=cuda_device).tril()
        p = torch.exp((qf @ kr.transpose(-1, -2) / 8.0).masked_fill(~mask, -1e30) - lse[..., None])
        ds = p * (dof @ vr.transpose(-1, -2) - (dof * out.float()).sum(-1, keepdim=True))
        dkr, dvr = ds.transpose(-1, -2) @ qf / 8.0, p.transpose(-1, -2) @ dof
        grads = (ds @ kr / 8.0, dkr.unflatten(1, (2, 4)).sum(2), dvr.unflatten(1, (2, 4)).sum(2))
        return [x.transpose(1, 2).to(torch.bfloat16) for x in grads]

    def rel(g, w):
        return float((g.cpu().double() - w).abs().max() / w.abs().max())

    limits = [2 * rel(f, w) for f, w in zip(plain, want)]
    kept = [rel(g, w) / limit for g, w, limit in zip(got, want, limits)]
    misses = [rel(g, w) / limit for g, w, limit in zip(one_pass(), want, limits)]
    print(f"dq, dk, dv over the bound: kernel {kept}, one-pass {misses}, limits {limits}")
    assert max(kept) <= 1, (kept, limits)
    assert (max(misses) > 1) == pins_one_pass, misses


def test_flash_backward_launches_only_on_the_kernels_inputs(cuda_device):
    """One ``flash_attention_bwd`` launch per ``_Flash.backward`` on causal
    bf16 inputs at head dim 64 (with a window or without), and none for
    float32, head dim 128, a softcap, bidirectional attention or S != T."""
    from repro_torch.models.attention import attend

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    cases = [  # (dtype, d, causal, window, softcap, t, launches)
        (torch.bfloat16, 64, True, None, None, 256, 1),
        (torch.bfloat16, 64, True, 100, None, 256, 1),
        (torch.float32, 64, True, None, None, 256, 0),
        (torch.bfloat16, 128, True, None, None, 256, 0),
        (torch.bfloat16, 64, True, None, 30.0, 256, 0),
        (torch.bfloat16, 64, False, None, None, 256, 0),
        (torch.bfloat16, 64, False, None, None, 320, 0),
    ]
    for dtype, d, causal, window, softcap, t, launches in cases:
        q = torch.randn(2, 256, 4, d, generator=gen, device=cuda_device).to(dtype)
        k, v = (torch.randn(2, t, 2, d, generator=gen, device=cuda_device).to(dtype)
                for _ in range(2))
        leaves = [x.requires_grad_(True) for x in (q, k, v)]
        n0 = dict(cuda.LAUNCHES)
        out = attend(*leaves, causal=causal, window=window, logit_softcap=softcap)
        grads = torch.autograd.grad(out.float().sum(), leaves)
        torch.cuda.synchronize()
        assert all(torch.isfinite(g.float()).all() for g in grads)
        assert cuda.LAUNCHES["flash_attention_bwd"] - n0["flash_attention_bwd"] == launches, \
            (dtype, d, causal, window, softcap, t)
        assert cuda.LAUNCHES["flash_attention"] - n0["flash_attention"] == 1


def test_flash_attention_bwd_refuses_what_it_does_not_take(cuda_device):
    """Unaligned strides, head dims other than 64, float32 and non-causal
    attention raise before any launch."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    def args(d=64, dtype=torch.bfloat16, pad=0):
        base = torch.randn(1, 128, 4, d + pad, device=cuda_device).to(dtype)
        x = base[..., :d].transpose(1, 2)                          # (B, H, S, D) views
        kv = torch.randn(1, 128, 2, d, device=cuda_device).to(dtype).transpose(1, 2)
        lse = torch.zeros(1, 4, 128, device=cuda_device)
        return x, kv, kv, lse, x

    n0 = cuda.LAUNCHES["flash_attention_bwd"]
    with pytest.raises(ValueError, match="16 B"):
        flash_attention_bwd(*args(pad=1))                          # position stride of 65 x 2 B
    for d in (32, 128, 160):
        with pytest.raises(ValueError, match="head dim 64"):
            flash_attention_bwd(*args(d=d))
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention_bwd(*args(dtype=torch.float32))
    with pytest.raises(ValueError, match="causal"):
        flash_attention_bwd(*args(), causal=False)
    assert cuda.LAUNCHES["flash_attention_bwd"] == n0


TRAIN_KERNELS = {"tinyllama-1.1b": ("flash_attention",),
                 "hymba-1.5b": ("flash_attention", "ssm_scan_chunked"),
                 "rwkv6-7b": ("rwkv6_chunked",),
                 "whisper-medium": ("flash_attention",),
                 "mixtral-8x22b": ("flash_attention",)}


@pytest.mark.parametrize("arch", sorted(TRAIN_KERNELS))
def test_train_step_on_the_card_matches_the_cpu(cuda_device, arch):
    """Reduced tinyllama, hymba, whisper (its encoder, causal and cross
    attention) and mixtral (MoE) with head dim 64 (the flash kernel's width)
    and reduced rwkv6, float32, TF32 off: three train steps on the card
    (each kernel's forward and its recompute, the torch-op backwards)
    against the CPU's on the same weights and batches, at 1e-4 of each
    leaf's largest magnitude."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models.api import build_model
    from repro_torch.models.weights import to_reference
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    heads = {} if arch == "rwkv6-7b" else dict(head_dim=64, n_heads=4, n_kv_heads=2)
    cfg = reduced(get_config(arch), **heads)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    cpu = build_model(cfg, device="cpu", dtype=torch.float32).init(torch.Generator().manual_seed(0))
    gpu = build_model(cfg, device=cuda_device, dtype=torch.float32)
    gpu.lm.load_state_dict(cpu.lm.state_dict())
    out = []
    for model in (cpu, gpu):
        params = to_reference(model, device=model.device)
        opt = adamw.init(params, opt_cfg)
        step = make_train_step(model, opt_cfg)
        pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, batch=2, seq_len=128))
        rng = np.random.default_rng(1)
        n0 = dict(cuda.LAUNCHES)
        losses = []
        for _ in range(3):
            batch = {k: torch.from_numpy(v).to(model.device) for k, v in pipe.next_batch().items()}
            extra = _family_inputs(cfg, rng, 2, 1, model.device)
            batch.update({k: v for k, v in extra.items() if k != "tokens"})
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
        launched = {k: n - n0[k] for k, n in cuda.LAUNCHES.items()}
        out.append((losses, tree_map(lambda t: t.cpu(), params), launched))
    (cpu_losses, cpu_params, cpu_launched), (gpu_losses, gpu_params, launched) = out
    assert not any(cpu_launched.values())
    for name, n in launched.items():      # forward and recompute per layer and step
        per = attention_calls(cfg) if name == "flash_attention" else cfg.n_layers
        assert n == (3 * 2 * per if name in TRAIN_KERNELS[arch] else 0), launched
    np.testing.assert_allclose(gpu_losses, cpu_losses, rtol=1e-4)
    for got, want in zip(tree_leaves(gpu_params), tree_leaves(cpu_params)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("arch,width", [("hymba-1.5b", ["--d-model", "256"]), ("rwkv6-7b", [])])
def test_train_cli_runs_on_the_card(cuda_device, tmp_path, capsys, arch, width):
    """``launch/train.py --arch ... --reduced`` on the card (hymba at
    d_model 256, so its head dim is the flash kernel's 64): two steps,
    journaled and committed."""
    from repro_torch.launch import train as train_cli

    n0 = dict(cuda.LAUNCHES)
    assert train_cli.main(["--arch", arch, "--reduced", *width, "--steps", "2", "--batch", "2",
                           "--seq", "64", "--save-every", "1", "--log-every", "1",
                           "--journal-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "device=cuda" in out
    assert "[journal] last committed step: 1" in out
    kernel = "ssm_scan_chunked" if arch == "hymba-1.5b" else "rwkv6_chunked"
    assert cuda.LAUNCHES[kernel] - n0[kernel] == 2 * 2 * 2       # 2 layers, 2 steps, recompute


@pytest.fixture
def nccl_group(cuda_device, tmp_path):
    """A world-size-1 NCCL process group, met through a file under
    ``tmp_path``, destroyed after the test."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1, device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        yield cuda_device
    finally:
        dist.destroy_process_group()


def test_compressed_psum_on_one_card_is_fake_quantize(nccl_group):
    """On one rank the shared scale is the rank's own and the requantized
    payload is ``q``: the int8 all-reduce equals ``fake_quantize`` bit for
    bit, ragged tail chunk and all-zero chunk included."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.compression import compressed_psum, fake_quantize

    mesh = make_mesh((1,), ("data",))
    g = torch.Generator(device=nccl_group).manual_seed(0)
    x = torch.randn(3000, 700, generator=g, device=nccl_group)
    x[:4] = 0.0
    got = compressed_psum(x, mesh, "data")
    assert got.device.type == "cuda" and torch.equal(got, fake_quantize(x))


def test_sharded_step_on_the_card_equals_the_unsharded_step(nccl_group):
    """Reduced tinyllama with the flash kernel's head dim, float32, TF32
    off, ``compress_grads``: two steps of ``shard_train_step`` on a (1, 1)
    mesh against ``make_train_step`` on the same weights and batches; every
    leaf within 1e-5 of its largest magnitude (the embedding's backward adds
    with atomics on the card, so two runs need not be bit-identical), the
    same flash launches."""
    from repro_torch.configs.base import ShapeConfig, reduced
    from repro_torch.configs.registry import get_config, make_inputs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.models.weights import to_reference
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import distribute_tree, shard_train_step
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config("tinyllama-1.1b"), head_dim=64, n_heads=4, n_kv_heads=2)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batches = [make_inputs(cfg, ShapeConfig("t", 128, 4, "train"), seed=i) for i in range(2)]
    mesh = make_mesh((1, 1), ("data", "model"))
    out = []
    for sharded in (False, True):
        model = build_model(cfg, dtype=torch.float32).init(
            torch.Generator(device=nccl_group).manual_seed(0))
        params = to_reference(model)
        assert tree_leaves(params)[0].device.type == "cuda"
        opt = adamw.init(params, opt_cfg)
        if sharded:
            step = shard_train_step(model, opt_cfg, mesh, compress_grads=True)
            params = distribute_tree(params, step.param_shardings)
            opt = distribute_tree(opt, step.opt_shardings)
        else:
            step = make_train_step(model, opt_cfg, compress_grads=True)
        n0 = cuda.LAUNCHES["flash_attention"]
        losses = []
        for b in batches:
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
        state = {"params": params, "opt": opt}
        if sharded:
            state = tree_map(lambda t: t.to_local(), state)
        out.append((losses, state, cuda.LAUNCHES["flash_attention"] - n0))
    (want_losses, want, want_n), (losses, got, n) = out
    assert n == want_n == 2 * 2 * cfg.n_layers       # 2 steps, forward and recompute
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))
