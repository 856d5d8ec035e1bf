"""The port's OLTP device functions against the reference's, exactly.

Each plain PyTorch version (what the port's wrappers run for CPU tensors) is
held against the JAX package's function on the same numpy-seeded int32
inputs: the Pallas kernels in interpret mode, their XLA twins, and the numpy
oracles.  Pad lanes (key -1 and the overflow slot), checkpoint ties and
empty inputs are included.  All of it is integer max/min, so every
comparison is exact.

The cases that hold each hand-written kernel against its plain version on
the card are in ``test_torch_cuda.py``, which imports no JAX.
"""

import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.batch_occ import validate_sequence_xla
from repro.kernels.ref import scatter_max_ref as jscatter_max_ref
from repro.kernels.ref import seg_reduce_ref as jseg_reduce_ref
from repro.kernels.scatter_max import ssn_scatter_max_xla
from repro_torch.kernels import cuda
from repro_torch.kernels import ops as tops
from repro_torch.kernels.bucketing import ladder
from repro_torch.kernels.ref import scatter_max_ref, seg_reduce_ref
from repro_torch.kernels.scatter_max import NO_POS, _scatter_max_blocks

I32_MAX = np.iinfo(np.int32).max


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


# --- inputs -------------------------------------------------------------------

def _scatter_case(n_slots, n_writes, ckpt_frac, seed):
    rng = np.random.default_rng(seed)
    image_ssn = np.full(n_slots, -1, np.int32)
    image_pos = np.full(n_slots, NO_POS, np.int32)
    ckpt = rng.random(n_slots) < ckpt_frac
    image_ssn[ckpt] = rng.integers(0, 50, ckpt.sum())
    image_pos[ckpt] = -1
    key = rng.integers(0, n_slots, n_writes).astype(np.int32)
    ssn = rng.integers(0, 60, n_writes).astype(np.int32)   # dense: many ties
    pos = np.arange(n_writes, dtype=np.int32)
    return image_ssn, image_pos, key, ssn, pos


def _pad_lanes(key, ssn, pos, pad_key, n_pad):
    """Append ``n_pad`` lanes at ``pad_key`` that would win every slot if
    they were not skipped (huge SSN, position -1)."""
    return (
        np.concatenate([key, np.full(n_pad, pad_key, np.int32)]),
        np.concatenate([ssn, np.full(n_pad, 10**6, np.int32)]),
        np.concatenate([pos, np.full(n_pad, -1, np.int32)]),
    )


def _validate_case(n_txn, k, cap, lock_frac, seed):
    rng = np.random.default_rng(seed)
    lanes = n_txn * k
    acc = np.empty((6, lanes), np.int32)
    acc[0] = rng.integers(0, cap, lanes)
    acc[1] = rng.permutation(lanes)
    acc[2] = rng.integers(0, 2, lanes)
    ssn = rng.integers(1, 40, lanes).astype(np.int32)
    acc[3] = np.where(rng.random(lanes) < 0.5, ssn, -1)
    acc[4] = ssn
    acc[5] = (rng.random(lanes) < lock_frac).astype(np.int32)
    stale = rng.random(lanes) < 0.15
    acc[3] = np.where(stale & (acc[3] >= 0), acc[3] + 1, acc[3])
    a_len = rng.integers(1, k + 1, n_txn).astype(np.int32)
    a_len[-max(1, n_txn // 8):] = 0          # padded transactions
    return acc, a_len


# --- ssn_scatter_max ------------------------------------------------------------

@pytest.mark.parametrize("n_slots,n_writes,ckpt_frac", [
    (64, 256, 0.0),     # single slot block, padded writes
    (300, 1000, 0.3),   # unaligned sizes, checkpoint image
    (1000, 300, 0.9),   # more slots than writes
    (17, 5, 0.5),       # tiny
])
def test_ssn_scatter_max_matches_reference(n_slots, n_writes, ckpt_frac):
    img_s, img_p, key, ssn, pos = _scatter_case(
        n_slots, n_writes, ckpt_frac, seed=n_slots * 7 + n_writes)
    ref_s, ref_p = jscatter_max_ref(img_s, img_p, key, ssn, pos)
    np.testing.assert_array_equal(scatter_max_ref(img_s, img_p, key, ssn, pos)[0], ref_s)

    # the Pallas kernel's pad convention (key -1) and the twin's (slot S)
    k_all, s_all, p_all = _pad_lanes(key, ssn, pos, -1, 5)
    k_all, s_all, p_all = _pad_lanes(k_all, s_all, p_all, n_slots, 5)
    pal_s, pal_p = jops.ssn_scatter_max(img_s, img_p, k_all, s_all, p_all,
                                        interpret=True)
    k_ov, s_ov, p_ov = _pad_lanes(key, ssn, pos, n_slots, 5)
    xla_s, xla_p = ssn_scatter_max_xla(img_s, img_p, k_ov, s_ov, p_ov, n_slots)

    out_s, out_p = tops.ssn_scatter_max(_t(img_s), _t(img_p), _t(k_all),
                                        _t(s_all), _t(p_all))
    for got_s, got_p in ((pal_s, pal_p), (xla_s, xla_p), (out_s, out_p)):
        np.testing.assert_array_equal(np.asarray(got_s), ref_s)
        np.testing.assert_array_equal(np.asarray(got_p), ref_p)


def test_ssn_scatter_max_empty_writes_is_identity():
    img_s = np.arange(8, dtype=np.int32)
    img_p = np.full(8, -1, np.int32)
    empty = np.empty(0, np.int32)
    out_s, out_p = tops.ssn_scatter_max(_t(img_s), _t(img_p), _t(empty),
                                        _t(empty), _t(empty))
    ref_s, ref_p = jops.ssn_scatter_max(img_s, img_p, empty, empty, empty,
                                        interpret=True)
    np.testing.assert_array_equal(out_s.numpy(), np.asarray(ref_s))
    np.testing.assert_array_equal(out_p.numpy(), np.asarray(ref_p))


@pytest.mark.parametrize("n_slots,n_lanes", [(64, 40), (256, 300)])
def test_fused_replay_ops_match_reference(n_slots, n_lanes):
    """``fused_replay_scan`` (empty image) and ``fused_replay_apply``
    (checkpoint image) against the reference entry points on one
    bucket-padded stacked block with overflow-slot padding."""
    img_s, img_p, key, ssn, pos = _scatter_case(n_slots, n_lanes, 0.4,
                                                seed=n_slots + n_lanes)
    n_pad = 64 - n_lanes % 64
    scan = np.stack(_pad_lanes(key, ssn, pos, n_slots, n_pad))
    scan[1, n_lanes:] = -1
    scan[2, n_lanes:] = NO_POS
    image = np.stack([img_s, img_p])

    ref_scan = jops.fused_replay_scan(scan, n_slots=n_slots)
    got_scan = tops.fused_replay_scan(_t(scan), n_slots=n_slots)
    ref_apply = jops.fused_replay_apply(image, scan)
    got_apply = tops.fused_replay_apply(_t(image), _t(scan))
    for ref, got in ((ref_scan, got_scan), (ref_apply, got_apply)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize("n_slots,n_lanes", [(96, 300), (1000, 4096)])
def test_no_image_scatter_matches_reference_scan(n_slots, n_lanes):
    """The launch helper with no image (what ``fused_replay_scan`` runs) on
    CPU tensors: an all-empty image, both pad conventions skipped."""
    _, _, key, ssn, pos = _scatter_case(n_slots, n_lanes, 0.0, seed=n_slots + 3)
    key, ssn, pos = _pad_lanes(key, ssn, pos, n_slots, 7)
    scan = np.stack([key, ssn, pos])
    ref = jops.fused_replay_scan(scan, n_slots=n_slots)
    key, ssn, pos = _pad_lanes(key, ssn, pos, -1, 5)
    got = _scatter_max_blocks(None, _t(np.stack([key, ssn, pos])), n_slots)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


# --- seg_reduce -------------------------------------------------------------------

@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("n_slots,n_items", [
    (64, 256),    # every slot hit
    (300, 1000),  # unaligned sizes
    (1024, 37),   # sparse: most slots empty
    (5, 3),       # tiny
])
def test_seg_reduce_matches_reference(op, n_slots, n_items):
    rng = np.random.default_rng(n_slots * 13 + n_items + (op == "min"))
    key = rng.integers(0, n_slots, n_items).astype(np.int32)
    val = rng.integers(0, 500, n_items).astype(np.int32)
    key[::7] = -1                          # pad items match no slot
    pal = jops.occ_seg_reduce(key, val, n_slots=n_slots, op=op, interpret=True)
    ref = jseg_reduce_ref(key[key >= 0], val[key >= 0], n_slots, op)
    np.testing.assert_array_equal(np.asarray(pal), ref)
    np.testing.assert_array_equal(
        seg_reduce_ref(key[key >= 0], val[key >= 0], n_slots, op), ref)
    got = tops.occ_seg_reduce(_t(key), _t(val), n_slots=n_slots, op=op)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("op,init", [("max", -1), ("min", I32_MAX)])
def test_seg_reduce_empty_items(op, init):
    empty = np.empty(0, np.int32)
    got = tops.occ_seg_reduce(_t(empty), _t(empty), n_slots=7, op=op)
    ref = jops.occ_seg_reduce(empty, empty, n_slots=7, op=op, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), np.full(7, init, np.int32))


# --- fused validate -> sequence -----------------------------------------------------

@pytest.mark.parametrize("n_txn,k,cap,lock_frac", [
    (8, 1, 64, 0.0),
    (64, 4, 128, 0.2),      # ragged a_len, locked tuples
    (128, 2, 64, 0.0),      # conflict-heavy: cap << lanes
    (32, 16, 512, 0.1),     # hybrid-shaped: 16 lanes per txn
    (16, 64, 256, 0.1),     # k > 32: the kernel's warp-per-transaction form
    (32, 3, 64, 0.1),       # k not a power of two: the same form
])
def test_validate_sequence_matches_reference(n_txn, k, cap, lock_frac):
    acc, a_len = _validate_case(n_txn, k, cap, lock_frac, seed=n_txn * 31 + k)
    ref_sv, ref_b = validate_sequence_xla(acc, a_len, n_txn, k, cap)
    got_sv, got_b = tops.fused_validate_sequence(_t(acc), _t(a_len),
                                                 n_txn=n_txn, k=k, cap=cap)
    assert got_sv.dtype == torch.bool and got_b.dtype == torch.int32
    np.testing.assert_array_equal(got_sv.numpy(), np.asarray(ref_sv))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(ref_b))


def test_plain_versions_count_no_launches():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    before = dict(cuda.LAUNCHES)
    acc, a_len = _validate_case(8, 2, 32, 0.0, seed=1)
    tops.fused_validate_sequence(_t(acc), _t(a_len), n_txn=8, k=2, cap=32)
    tops.occ_seg_reduce(_t(acc[0]), _t(acc[1]), n_slots=32, op="min")
    tops.fused_replay_scan(_t(acc[:3]), n_slots=32)
    assert cuda.LAUNCHES == before


def test_launch_shapes_stay_on_the_ladder():
    """Bucket-padded inputs of many distinct sizes reuse at most one launch
    shape per ladder rung."""
    from repro_torch.kernels.bucketing import bucket

    before = tops.fused_cache_sizes()["fused_replay_scan"]
    rng = np.random.default_rng(3)
    for n in rng.integers(1, 300, 25).tolist():
        n_slots = 2 * bucket(n)
        scan = np.stack([
            np.full(bucket(n), n_slots, np.int32),
            np.full(bucket(n), -1, np.int32),
            np.full(bucket(n), NO_POS, np.int32),
        ])
        scan[0, :n] = rng.integers(0, n_slots, n)
        scan[1, :n] = rng.integers(0, 9, n)
        scan[2, :n] = np.arange(n)
        tops.fused_replay_scan(_t(scan), n_slots=n_slots)
    grown = tops.fused_cache_sizes()["fused_replay_scan"] - before
    assert 0 < grown <= len(ladder(300))


def test_wrappers_reject_wrong_dtype():
    with pytest.raises(TypeError):
        tops.occ_seg_reduce(torch.zeros(4, dtype=torch.int64),
                            torch.zeros(4, dtype=torch.int64), n_slots=4)


def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


@pytest.mark.parametrize("call,error", [
    (lambda: tops.ssn_scatter_max(_i32(4), _i32(4).long(), _i32(2), _i32(2), _i32(2)), TypeError),
    (lambda: tops.ssn_scatter_max(_i32(4), _i32(4), _i32(2), _i32(3), _i32(2)), ValueError),
    (lambda: tops.ssn_scatter_max(_i32(4), _i32(5), _i32(2), _i32(2), _i32(2)), ValueError),
    (lambda: tops.ssn_scatter_max(_i32(4), _i32(4), _i32(2, 2).t()[0], _i32(2), _i32(2)),
     ValueError),
    (lambda: tops.fused_replay_scan(_i32(2, 8), n_slots=4), ValueError),
    (lambda: tops.fused_replay_scan(_i32(3, 8).float(), n_slots=4), TypeError),
    (lambda: tops.fused_replay_scan(_i32(3, 16)[:, ::2], n_slots=4), ValueError),
    (lambda: tops.fused_replay_apply(_i32(2, 4), _i32(3, 8)[:, ::2]), ValueError),
    (lambda: tops.fused_replay_apply(_i32(3, 4), _i32(3, 8)), ValueError),
    (lambda: tops.occ_seg_reduce(_i32(4), _i32(5), n_slots=4), ValueError),
    (lambda: tops.occ_seg_reduce(_i32(4), _i32(4), n_slots=4, op="sum"), ValueError),
    (lambda: tops.fused_validate_sequence(_i32(6, 8), _i32(3), n_txn=4, k=2, cap=8),
     ValueError),
])
def test_wrappers_reject_what_the_kernels_do_not_take(call, error):
    """Every check of the launch path holds on CPU tensors too: dtype,
    lengths, contiguity, layout and op."""
    before = dict(cuda.LAUNCHES)
    with pytest.raises(error):
        call()
    assert cuda.LAUNCHES == before

