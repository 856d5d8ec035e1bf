"""The port's LLM kernels' plain versions against the reference's kernels.

Each plain PyTorch version (what the port's wrappers run for CPU tensors)
is held against the JAX package's Pallas kernel in interpret mode and its
``ref.py`` oracle on the same numpy-seeded inputs, over the sweep of
``tests/test_kernels.py``, at that file's tolerances (``_tol``: 2e-4 for
float32; 2e-2 for bfloat16, whose inputs carry ~3 decimal digits while
both sides accumulate in float32).  Beyond the reference's sweep: the
hymba head dim 64, and S and T that are not multiples of any block, which
the port's kernels take and the TPU kernels do not.

The cases that hold each hand-written kernel against its plain version on
the card are in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd as jflash
from repro.kernels.ref import attention_ref, rwkv6_ref, ssm_scan_ref
from repro.kernels.rwkv6 import rwkv6_chunked as jrwkv6
from repro.kernels.ssm_scan import ssm_scan_chunked as jssm
from repro_torch.kernels import cuda
from repro_torch.kernels.flash_attention import (
    check_tma_layout,
    flash_attention_bwd,
    flash_attention_fwd,
    flash_attention_plain,
)
from repro_torch.kernels.rwkv6 import CHUNK, rwkv6_chunked, rwkv6_chunked_plain
from repro_torch.kernels.ssm_scan import ssm_scan_chunked, ssm_scan_chunked_plain

TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == jnp.bfloat16 else dict(atol=2e-4, rtol=2e-4)


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor of one dtype."""
    j = jnp.asarray(a, dtype)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TORCH[dtype])


def _np(t):
    return t.float().numpy()


# --- flash attention ------------------------------------------------------------

SWEEP = [
    (1, 2, 2, 128, 128, 128, True, None, None),
    (2, 4, 2, 256, 256, 128, True, None, None),    # GQA
    (1, 2, 1, 128, 256, 128, False, None, None),   # bidir, longer kv
    (2, 2, 2, 256, 256, 128, True, 64, None),      # sliding window
    (1, 2, 2, 128, 128, 128, True, None, 30.0),    # grok softcap
    (1, 8, 2, 384, 384, 128, True, 128, None),     # window + GQA
]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,t,d,causal,window,softcap", SWEEP)
def test_flash_attention_plain_matches_pallas(b, hq, hkv, s, t, d, causal, window,
                                              softcap, dtype):
    rng = np.random.default_rng(s * 7 + t + hq)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.normal(0, 1, shape), dtype)
        for shape in ((b, hq, s, d), (b, hkv, t, d), (b, hkv, t, d)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = flash_attention_plain(qt, kt, vt, **kw)
    assert got.dtype == TORCH[dtype] and got.shape == (b, hq, s, d)
    pallas = np.asarray(jflash(qj, kj, vj, interpret=True, **kw).astype(jnp.float32))
    oracle = np.asarray(attention_ref(qj, kj, vj, **kw).astype(jnp.float32))
    np.testing.assert_allclose(_np(got), pallas, **_tol(dtype))
    np.testing.assert_allclose(_np(got), oracle, **_tol(dtype))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize(
    "b,hq,hkv,s,t,causal,window",
    [
        (2, 25, 5, 128, 128, True, None),     # hymba heads, D = 64
        (1, 25, 5, 200, 200, True, 64),       # ragged S, window
        (1, 4, 2, 77, 133, False, None),      # ragged S and T, bidir
        (1, 4, 1, 100, 100, True, 1),         # window 1: attends itself only
    ],
)
def test_flash_attention_plain_head_dim_64_and_ragged(b, hq, hkv, s, t, causal, window, dtype):
    rng = np.random.default_rng(s + t)
    d = 64
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.normal(0, 1, shape), dtype)
        for shape in ((b, hq, s, d), (b, hkv, t, d), (b, hkv, t, d)))
    got = flash_attention_plain(qt, kt, vt, causal=causal, window=window)
    oracle = attention_ref(qj, kj, vj, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), np.asarray(oracle.astype(jnp.float32)), **_tol(dtype))


def test_flash_attention_wrapper_runs_plain_on_cpu_tensors():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (1, 4, 50, 16)).astype(np.float32))
               for _ in range(3))
    before = dict(cuda.LAUNCHES)
    got = flash_attention_fwd(q, k[:, :2], v[:, :2], window=8)
    assert cuda.LAUNCHES == before
    assert torch.equal(got, flash_attention_plain(q, k[:, :2], v[:, :2], window=8))
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k[:, :3], v[:, :3])       # 4 heads over 3


def _strided(shape, strides, offset=0, dtype=torch.bfloat16):
    """A (B, H, S, D) view with the given element strides into a fresh buffer."""
    span = offset + 1 + sum((n - 1) * st for n, st in zip(shape, strides))
    return torch.zeros(span, dtype=dtype).as_strided(shape, strides, offset)


TMA_LAYOUTS = [
    # (tensor, meets the rule)
    pytest.param(lambda: torch.zeros(2, 4, 33, 64, dtype=torch.bfloat16), True, id="contiguous"),
    pytest.param(lambda: torch.zeros(2, 33, 25, 64, dtype=torch.bfloat16).transpose(1, 2), True,
                 id="model (B, S, H, D) view, hymba heads"),
    pytest.param(lambda: torch.zeros(1, 12, 7, 128, dtype=torch.bfloat16), True, id="D=128, 12 heads"),
    pytest.param(lambda: _strided((1, 1, 5, 64), (3, 5, 64, 1)), True,
                 id="size-1 batch and head: their strides are free"),
    pytest.param(lambda: _strided((1, 2, 9, 64), (2 * 9 * 68, 9 * 68, 68, 1)), False,
                 id="position stride 68 elements"),
    pytest.param(lambda: _strided((1, 3, 8, 64), (3 * 516, 516, 64, 1)), False,
                 id="head stride 516 elements"),
    pytest.param(lambda: _strided((2, 2, 64, 64), (8196, 4096, 64, 1)), False,
                 id="batch stride 8196 elements"),
    pytest.param(lambda: _strided((1, 2, 8, 64), (1024, 512, 64, 1), offset=1), False,
                 id="base pointer 2 B past alignment"),
]


@pytest.mark.parametrize("make,ok", TMA_LAYOUTS)
def test_tma_layout_rule(make, ok):
    """The rule the CUDA branch applies to bf16 q, k and v before it builds
    their TMA maps: 16-B aligned base pointers, and batch, head and position
    strides that are multiples of 16 B."""
    x = make()
    if ok:
        check_tma_layout(q=x)
    else:
        with pytest.raises(ValueError):
            check_tma_layout(q=x)


def _bwd_args(b=1, s=40, hq=4, hkv=2, d=64, dtype=torch.bfloat16):
    """q, k, v, lse and do of the backward kernel, (B, H, S, D) views of the
    model's (B, S, H, D) layout, on the CPU."""
    q, do = (torch.zeros(b, s, hq, d, dtype=dtype).transpose(1, 2) for _ in range(2))
    k, v = (torch.zeros(b, s, hkv, d, dtype=dtype).transpose(1, 2) for _ in range(2))
    return dict(q=q, k=k, v=v, lse=torch.zeros(b, hq, s), do=do)


BWD_REFUSED = [
    # (how the arguments differ from the kernel's, keywords, error, message)
    pytest.param(dict(d=128), {}, ValueError, "head dim 64", id="D=128"),
    pytest.param(dict(d=160), {}, ValueError, "head dim 64", id="D=160"),
    pytest.param(dict(dtype=torch.float32), {}, TypeError, "bfloat16", id="float32"),
    pytest.param({}, dict(causal=False), ValueError, "causal", id="bidirectional"),
    pytest.param({}, dict(window=0), ValueError, "window", id="window 0"),
    pytest.param(dict(hkv=3), {}, ValueError, "shapes", id="4 heads over 3"),
    pytest.param({}, dict(k=torch.zeros(1, 2, 48, 64, dtype=torch.bfloat16)), ValueError,
                 "shapes", id="S != T"),
    pytest.param({}, dict(lse=torch.zeros(1, 4, 40, dtype=torch.bfloat16)), ValueError, "lse",
                 id="bf16 lse"),
    pytest.param({}, dict(q=_strided((1, 4, 40, 64), (4 * 40 * 68, 68, 4 * 68, 1))), ValueError,
                 "16 B", id="unaligned position stride"),
    pytest.param({}, dict(q=torch.zeros(1, 4, 40, 128, dtype=torch.bfloat16)[..., ::2]),
                 ValueError, "contiguous", id="strided head dim"),
    pytest.param({}, {}, ValueError, "on the card", id="CPU tensors it would take"),
]


@pytest.mark.parametrize("shape,kw,err,match", BWD_REFUSED)
def test_flash_attention_bwd_checks_its_inputs_on_the_cpu(shape, kw, err, match):
    """The backward kernel's wrapper raises on every input it does not take,
    and on CPU tensors it would take (the plain twin is ``_flash_bwd``),
    launching nothing."""
    args = {**_bwd_args(**shape), **kw}
    causal = args.pop("causal", True)
    window = args.pop("window", None)
    before = dict(cuda.LAUNCHES)
    with pytest.raises(err, match=match):
        flash_attention_bwd(args["q"], args["k"], args["v"], args["lse"], args["do"],
                            causal=causal, window=window)
    assert cuda.LAUNCHES == before


# --- chunked SSM scan -------------------------------------------------------------

def _ssm_inputs(b, h, s, p, n, dtype, seed):
    rng = np.random.default_rng(seed)
    x = _pair(rng.normal(0, 1, (b, h, s, p)), dtype)
    dt = _pair(rng.uniform(0.01, 0.2, (b, h, s)), jnp.float32)
    decay = _pair(rng.uniform(0.7, 0.999, (b, h, s)), jnp.float32)
    bm = _pair(rng.normal(0, 1, (b, s, n)), dtype)
    cm = _pair(rng.normal(0, 1, (b, s, n)), dtype)
    return [a[0] for a in (x, dt, decay, bm, cm)], [a[1] for a in (x, dt, decay, bm, cm)]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize(
    "b,h,s,p,n,chunk",
    [(1, 2, 128, 16, 8, 64), (2, 3, 64, 32, 16, 32), (1, 1, 256, 8, 4, 64)],
)
def test_ssm_scan_plain_matches_pallas(b, h, s, p, n, chunk, dtype):
    jargs, targs = _ssm_inputs(b, h, s, p, n, dtype, s + p + n)
    y, st = ssm_scan_chunked_plain(*targs, chunk=chunk)
    assert y.dtype == TORCH[dtype] and st.dtype == torch.float32
    yp, stp = jssm(*jargs, chunk=chunk, interpret=True)
    yr, str_ = ssm_scan_ref(*jargs)
    st_tol = dict(atol=5e-2, rtol=5e-2) if dtype == jnp.bfloat16 else dict(atol=2e-4, rtol=2e-4)
    for want_y, want_st in ((yp, stp), (yr, str_)):
        np.testing.assert_allclose(_np(y), np.asarray(want_y.astype(jnp.float32)), **_tol(dtype))
        np.testing.assert_allclose(st.numpy(), np.asarray(want_st), **st_tol)


@pytest.mark.parametrize("s", [1, 63, 65, 100, 200])
def test_ssm_scan_plain_ragged_padding_is_exact(s):
    """A ragged S is padded with dt = 0 and decay = 1: u = 0 and the state
    carries unchanged, so the result is the naive scan's over S steps, and
    bit-equal to padding the inputs by hand."""
    b, h, p, n = 2, 3, 16, 8
    jargs, (x, dt, decay, bm, cm) = _ssm_inputs(b, h, s, p, n, jnp.float32, s)
    y, st = ssm_scan_chunked_plain(x, dt, decay, bm, cm)
    yr, str_ = ssm_scan_ref(*jargs)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(str_), atol=2e-4, rtol=2e-4)

    pad = (-s) % 64
    rng = np.random.default_rng(1)
    junk = lambda *shape: torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
    xp = torch.cat([x, junk(b, h, pad, p)], dim=2)          # any x: u = dt * x = 0
    dtp = torch.cat([dt, torch.zeros(b, h, pad)], dim=2)
    dp = torch.cat([decay, torch.ones(b, h, pad)], dim=2)
    bp = torch.cat([bm, junk(b, pad, n)], dim=1)
    cp = torch.cat([cm, junk(b, pad, n)], dim=1)
    y2, st2 = ssm_scan_chunked_plain(xp, dtp, dp, bp, cp)
    assert torch.equal(y2[:, :, :s], y) and torch.equal(st2, st)


def test_ssm_scan_wrapper_runs_plain_on_cpu_tensors():
    _, args = _ssm_inputs(1, 2, 70, 8, 4, jnp.float32, 5)
    before = dict(cuda.LAUNCHES)
    got = ssm_scan_chunked(*args)
    assert cuda.LAUNCHES == before
    for g, w in zip(got, ssm_scan_chunked_plain(*args)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        ssm_scan_chunked(args[0], args[1][:, :, :5], *args[2:])


# --- chunked wkv6 -------------------------------------------------------------------

def _rwkv6_inputs(b, h, s, kd, vd, dtype, seed, w_range=(0.5, 0.999)):
    rng = np.random.default_rng(seed)
    r = _pair(rng.normal(0, 0.5, (b, h, s, kd)), dtype)
    k = _pair(rng.normal(0, 0.5, (b, h, s, kd)), dtype)
    v = _pair(rng.normal(0, 1, (b, h, s, vd)), dtype)
    w = _pair(rng.uniform(*w_range, (b, h, s, kd)), jnp.float32)
    u = _pair(rng.normal(0, 0.5, (h, kd)), jnp.float32)
    return [a[0] for a in (r, k, v, w, u)], [a[1] for a in (r, k, v, w, u)]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize(
    "b,h,s,kd,vd", [(1, 2, 64, 16, 16), (2, 2, 128, 32, 32), (1, 1, 96, 64, 64)],
)
def test_rwkv6_plain_matches_pallas(b, h, s, kd, vd, dtype):
    """The reference's sweep, all at its chunk of 32, which is the port's."""
    jargs, targs = _rwkv6_inputs(b, h, s, kd, vd, dtype, s + kd)
    y, st = rwkv6_chunked_plain(*targs)
    assert y.dtype == TORCH[dtype] and y.shape == (b, h, s, vd)
    assert st.dtype == torch.float32 and st.shape == (b, h, kd, vd)
    for want_y, want_st in (jrwkv6(*jargs, chunk=CHUNK, interpret=True), rwkv6_ref(*jargs)):
        np.testing.assert_allclose(_np(y), np.asarray(want_y.astype(jnp.float32)), **_tol(dtype))
        np.testing.assert_allclose(st.numpy(), np.asarray(want_st), **_tol(dtype))


def test_rwkv6_plain_strong_decay_is_finite():
    """w = 0.01 (log decay -4.6 a step, -147 over a chunk): the
    later-minus-earlier exponents never overflow."""
    jargs, targs = _rwkv6_inputs(1, 1, 64, 16, 16, jnp.float32, 3, w_range=(0.01, 0.01))
    jargs[4], targs[4] = jnp.zeros((1, 16), jnp.float32), torch.zeros(1, 16)
    y, st = rwkv6_chunked_plain(*targs)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    yp, stp = jrwkv6(*jargs, chunk=CHUNK, interpret=True)
    yr, str_ = rwkv6_ref(*jargs)
    for want_y, want_st in ((yp, stp), (yr, str_)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-4, rtol=1e-3)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_st), atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("s", [1, 31, 33, 77, 100])
def test_rwkv6_plain_ragged_padding_is_exact(s):
    """A ragged S is padded with r = k = v = 0 and w = 1: the state carries
    unchanged, so the result is the naive recurrence's over S steps, and
    bit-equal to padding by hand with any r and v, zero k and unit w."""
    b, h, kd, vd = 2, 3, 16, 16
    jargs, (r, k, v, w, u) = _rwkv6_inputs(b, h, s, kd, vd, jnp.float32, s)
    y, st = rwkv6_chunked_plain(r, k, v, w, u)
    yr, str_ = rwkv6_ref(*jargs)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(str_), atol=2e-4, rtol=2e-4)

    pad = (-s) % CHUNK
    rng = np.random.default_rng(1)
    junk = lambda *shape: torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
    rp = torch.cat([r, junk(b, h, pad, kd)], dim=2)      # y past S is dropped
    kp = torch.cat([k, torch.zeros(b, h, pad, kd)], dim=2)
    vp = torch.cat([v, junk(b, h, pad, vd)], dim=2)      # k = 0: k^T v = 0
    wp = torch.cat([w, torch.ones(b, h, pad, kd)], dim=2)
    y2, st2 = rwkv6_chunked_plain(rp, kp, vp, wp, u)
    assert torch.equal(y2[:, :, :s], y) and torch.equal(st2, st)


def test_rwkv6_wrapper_runs_plain_on_cpu_tensors():
    _, args = _rwkv6_inputs(1, 2, 70, 16, 16, jnp.float32, 5)
    before = dict(cuda.LAUNCHES)
    got = rwkv6_chunked(*args)
    assert cuda.LAUNCHES == before
    for g, w in zip(got, rwkv6_chunked_plain(*args)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        rwkv6_chunked(args[0], args[1][:, :, :5], *args[2:])
    with pytest.raises(ValueError):
        rwkv6_chunked(*args[:4], args[4][:1])             # u is not (H, K)
