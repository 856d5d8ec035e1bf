"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card, exactly — and the port's kernel mode end to end on the card against
its own vectorized and scalar modes.

These tests import no JAX, so they run on a machine with a CUDA card and
PyTorch alone:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Each test asks for the ``cuda_device`` fixture, which skips it where no CUDA
device is present (the kernels have no CPU mode).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import EngineConfig, PoplarEngine, recover
from repro_torch.db import ArrayTable, BatchOCC
from repro_torch.db import ycsb
from repro_torch.kernels import cuda
from repro_torch.kernels import ops
from repro_torch.kernels.batch_occ import seg_reduce_plain, validate_sequence_plain
from repro_torch.kernels.ref import scatter_max_ref, seg_reduce_ref
from repro_torch.kernels.scatter_max import NO_POS, ssn_scatter_max_plain


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


@pytest.mark.parametrize("n_txn,k,cap", [(1 << 12, 16, 1 << 14), (8, 1, 64), (64, 4, 32)])
def test_validate_sequence_kernel_equals_plain(cuda_device, n_txn, k, cap):
    rng = np.random.default_rng(n_txn * k)
    lanes = n_txn * k
    acc = np.empty((6, lanes), np.int32)
    acc[0] = rng.integers(0, cap, lanes)
    acc[1] = np.repeat(np.arange(n_txn), k)
    acc[2] = rng.integers(0, 2, lanes)
    ssn = rng.integers(0, 40, lanes).astype(np.int32)
    acc[3] = np.where(rng.random(lanes) < 0.3, ssn + (rng.random(lanes) < 0.2), -1)
    acc[4] = ssn
    acc[5] = rng.random(lanes) < 0.05
    a_len = rng.integers(1, k + 1, n_txn).astype(np.int32)
    a_len[-max(1, n_txn // 8):] = 0
    a, n = _t(acc, cuda_device), _t(a_len, cuda_device)
    got = ops.fused_validate_sequence(a, n, n_txn=n_txn, k=k, cap=cap)
    torch.cuda.synchronize()
    want = validate_sequence_plain(a, n, n_txn, k, cap)
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int32
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)


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
