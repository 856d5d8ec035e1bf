"""The port's training path against the reference's, on the CPU.

Inputs are made by numpy from a seed and handed to both packages; the
reference's weights are carried over with ``from_reference``.  Everything
is float32 unless a case says otherwise, and the two sides differ only in
summation order, so gradients, losses and updates agree to 1e-4 relative
to each leaf's largest magnitude (the optimizer alone to 1e-6: it is
elementwise with one global norm).  The flash backward (``_Flash``) is held
against ``jax.grad`` of the reference's ``attend(impl="flash")``, whose
``custom_vjp`` it ports; ``train_loss`` against ``jax.value_and_grad`` of
the reference's (its attention is ``masked_scan`` there, the same function;
its scan and wkv6 are ``mixer_impl``'s ``"scan"`` or ``"chunked"``, which the
port's one path matches both).  The scan's and wkv6's backwards
(``_SsmScan``, ``_Wkv6``) are held against ``jax.grad`` of the reference's
block forms, ``_chunked_selective_scan`` and ``_chunked_wkv``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced as jreduced
from repro.configs.registry import get_config as jget_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models.api import build_model as jbuild_model
from repro.models.attention import attend as jattend
from repro.models.lm import chunked_xent as jchunked_xent
from repro.models.rwkv import _chunked_wkv as j_chunked_wkv
from repro.models.ssm import _chunked_selective_scan as j_chunked_selective_scan
from repro.optim import adamw as jadamw
from repro.parallel import compression as jcompression
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.rwkv6 import rwkv6_chunked
from repro_torch.kernels.ssm_scan import ssm_scan_chunked
from repro_torch.models.api import build_model, draw_extras
from repro_torch.models import attention as attention_mod
from repro_torch.models.attention import attend
from repro_torch.kernels import rwkv6 as rwkv6_kernel
from repro_torch.kernels import ssm_scan as ssm_kernel
from repro_torch.models.lm import chunked_xent
from repro_torch.models.rwkv import _chunked_wkv, _Wkv6
from repro_torch.models.ssm import _chunked_selective_scan, _SsmScan
from repro_torch.models.weights import from_reference, to_reference
from repro_torch.optim import adamw
from repro_torch.parallel import compression
from repro_torch.train.step import make_train_step
from repro_torch.tree import keystr_items, tree_leaves, tree_map


def _close(got, want, rel=1e-4):
    """Within ``rel`` of the reference leaf's largest magnitude."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * max(float(np.abs(want).max()), 1e-30))


def _jtree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _ttree(tree, grad=False):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a, np.float32), requires_grad=grad), tree)


def _pair(arch, seed=1, **overrides):
    """The reference model and its float32 params, and the port model."""
    jcfg = jreduced(jget_config(arch), **overrides)
    jmodel = jbuild_model(jcfg)
    params = _jtree(jax.jit(jmodel.init)(jax.random.PRNGKey(seed)))
    model = build_model(reduced(get_config(arch), **overrides), device="cpu", dtype=torch.float32)
    return jmodel, params, model


def _batch(rng, vocab, b, s):
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# --- attention ------------------------------------------------------------------

ATTN_CASES = [
    # (b, s, hq, hkv, d, window, softcap)
    (2, 40, 4, 4, 16, None, None),      # causal
    (2, 50, 4, 2, 16, 8, None),         # sliding window, GQA
    (1, 37, 6, 3, 16, None, 5.0),       # softcap
    (1, 48, 8, 2, 32, 16, 3.0),         # GQA, window and softcap together
    (1, 1100, 2, 1, 16, None, None),    # S not a multiple of the backward's chunk of 1024
]


@pytest.mark.parametrize("b,s,hq,hkv,d,window,softcap", ATTN_CASES)
def test_flash_backward_matches_reference(b, s, hq, hkv, d, window, softcap):
    rng = np.random.default_rng(s + hq)
    q, w = (rng.standard_normal((b, s, hq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, s, hkv, d)).astype(np.float32) for _ in range(2))

    def f(q, k, v):
        out = jattend(q, k, v, causal=True, window=window, impl="flash", logit_softcap=softcap)
        return jnp.sum(out * w)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = attend(tq, tk, tv, causal=True, window=window, logit_softcap=softcap)
    (out * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got, ref)


@pytest.mark.parametrize("b,s,t,hq,hkv,d", [
    (2, 24, 40, 4, 4, 16),       # whisper's cross-attention shape, reduced: S < T
    (1, 40, 24, 4, 2, 16),       # S > T, GQA
    (1, 30, 1100, 2, 1, 16),     # T past the backward's chunk of 1024
])
def test_flash_backward_bidirectional_matches_reference(b, s, t, hq, hkv, d):
    """``_Flash`` with ``causal=False`` and S != T (the encoder-decoder's
    cross-attention) against ``jax.grad`` of the reference's
    ``attend(causal=False, impl="flash")``."""
    rng = np.random.default_rng(s * t)
    q, w = (rng.standard_normal((b, s, hq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, t, hkv, d)).astype(np.float32) for _ in range(2))

    def f(q, k, v):
        return jnp.sum(jattend(q, k, v, causal=False, impl="flash") * w)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    (attend(tq, tk, tv, causal=False) * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got, ref)


def test_flash_backward_ignores_the_forwards_rounding(monkeypatch):
    """``_Flash``'s backward takes each row's normaliser and ``dsum`` from
    its own recomputed scores, not from the forward's ``out`` and ``lse``
    (on the card the kernel's, whose float32 sums run in another order).
    Here the forward's ``out`` and ``lse`` are each moved by 1e-5 noise, on
    inputs where that matters: 448 near-uniform queries over 1,500 keys
    with a common part 100 times their spread.  dq, dk and dv stay within
    1e-4 of a float64 backward of their largest values (with the
    reference's ``dsum = do · out``, dq does not)."""
    gen = torch.Generator().manual_seed(0)
    q = 0.05 * torch.randn(1, 448, 4, 64, generator=gen)
    k = 100.0 + torch.randn(1, 1500, 4, 64, generator=gen)
    v = torch.randn(1, 1500, 4, 64, generator=gen)
    do = torch.randn(1, 448, 4, 64, generator=gen)
    fwd = attention_mod.flash_attention_fwd

    def rounded(*args, **kw):
        out, lse = fwd(*args, **kw)
        return (out + 1e-5 * torch.randn(out.shape, generator=gen),
                lse + 1e-5 * torch.randn(lse.shape, generator=gen))

    monkeypatch.setattr(attention_mod, "flash_attention_fwd", rounded)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad(attend(*leaves, causal=False), leaves, do)
    qd, kd, vd = (x.double().requires_grad_(True) for x in (q, k, v))
    scores = torch.einsum("bshd,bthd->bhst", qd, kd) / 8.0
    out = torch.einsum("bhst,bthd->bshd", torch.softmax(scores, dim=-1), vd)
    want = torch.autograd.grad(out, (qd, kd, vd), do.double())
    for g, w in zip(got, want):
        _close(g, w.numpy(), rel=1e-4)
    # the first pass's scores recomputed instead of kept: the same values
    monkeypatch.setattr(attention_mod, "flash_attention_fwd", fwd)
    kept = torch.autograd.grad(attend(*leaves, causal=False), leaves, do)
    monkeypatch.setattr(attention_mod, "BWD_CACHE_BYTES", 0)
    again = torch.autograd.grad(attend(*leaves, causal=False), leaves, do)
    assert all(torch.equal(a, b) for a, b in zip(again, kept))


@pytest.mark.parametrize("device,dtype,d,causal,softcap,s,t,kernel", [
    ("cuda", torch.bfloat16, 64, True, None, 2048, 2048, True),
    ("cuda", torch.bfloat16, 64, True, None, 77, 77, True),
    ("cuda", torch.float32, 64, True, None, 2048, 2048, False),
    ("cuda", torch.float16, 64, True, None, 2048, 2048, False),
    ("cuda", torch.bfloat16, 128, True, None, 2048, 2048, False),
    ("cuda", torch.bfloat16, 160, True, None, 2048, 2048, False),
    ("cuda", torch.bfloat16, 64, True, 30.0, 2048, 2048, False),
    ("cuda", torch.bfloat16, 64, False, None, 1500, 1500, False),
    ("cuda", torch.bfloat16, 64, False, None, 448, 1500, False),
    ("cuda", torch.bfloat16, 64, True, None, 448, 1500, False),
    ("cpu", torch.bfloat16, 64, True, None, 2048, 2048, False),
    ("cpu", torch.float32, 64, True, None, 2048, 2048, False),
    ("meta", torch.bfloat16, 64, True, None, 2048, 2048, True),
    ("meta", torch.float32, 64, True, None, 2048, 2048, False),
    ("meta", torch.bfloat16, 128, True, None, 2048, 2048, False),
])
def test_flash_backward_dispatch_rule(device, dtype, d, causal, softcap, s, t, kernel):
    """``_Flash.backward`` calls the kernel only for causal bf16 attention
    at head dim 64 with no softcap and S == T (the window is free), on the
    card and on meta tensors (the dry run counts the card's program); the
    CPU and every other form take ``_flash_bwd``."""
    assert attention_mod.kernel_backward(device, dtype, d, causal, softcap, s, t) is kernel


@pytest.mark.parametrize("window", [None, 5])
def test_flash_backward_on_the_cpu_is_the_plain_twin(monkeypatch, window):
    """On CPU tensors, bf16 ones included, ``_Flash.backward`` returns
    ``_flash_bwd``'s gradients, looked up by name at each call."""
    calls = []
    plain = attention_mod._flash_bwd

    def counted(*a):
        calls.append(a[4].dtype)
        return plain(*a)

    monkeypatch.setattr(attention_mod, "_flash_bwd", counted)
    gen = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(1, 12, h, 64, generator=gen).to(torch.bfloat16) for h in (4, 2, 2))
    leaves = [x.requires_grad_(True) for x in (q, k, v)]
    out = attend(*leaves, window=window)
    do = torch.randn(out.shape, generator=gen).to(torch.bfloat16)
    got = torch.autograd.grad(out, leaves, do)
    assert calls == [torch.bfloat16]
    _, lse = flash_attention_fwd(*(x.detach().transpose(1, 2) for x in (q, k, v)), window=window,
                                 return_lse=True)
    want = plain(*(x.detach() for x in (q, k, v)), lse, do, True, window, None)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_flash_forward_returns_the_plain_lse():
    """The kernel wrapper's CPU path: ``lse`` is ``logsumexp`` of the
    scaled, masked scores, and asking for it leaves ``o`` unchanged."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 4, 30, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, 30, 16)).astype(np.float32))
            for _ in range(2))
    o, lse = flash_attention_fwd(q, k, v, window=7, return_lse=True)
    assert torch.equal(o, flash_attention_fwd(q, k, v, window=7))
    kr = k.repeat_interleave(2, dim=1)
    scores = torch.einsum("bhsd,bhtd->bhst", q, kr) / 4.0
    pos = torch.arange(30)
    ok = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < 7)
    want = torch.logsumexp(scores.masked_fill(~ok, float("-inf")), dim=-1)
    assert lse.shape == (1, 4, 30) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-5)


# --- the loss and its gradients ----------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_chunked_xent_matches_reference(masked):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 64, 32)).astype(np.float32)
    w = (0.3 * rng.standard_normal((32, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 64)).astype(np.int32)
    mask = (rng.random((2, 64)) < 0.7).astype(np.float32) if masked else None
    for chunk in (16, 64):          # the chunked branch, then one pass
        f = lambda x, w: jchunked_xent(x, w, labels, None if mask is None else mask, chunk=chunk)
        want, (gx, gw) = jax.value_and_grad(f, argnums=(0, 1))(x, w)
        tx, tw = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
        got = chunked_xent(tx, tw, torch.from_numpy(labels),
                           None if mask is None else torch.from_numpy(mask), chunk=chunk)
        got.backward()
        _close(got, want)
        _close(tx.grad, gx)
        _close(tw.grad, gw)


@pytest.mark.parametrize("arch,overrides,seq", [
    ("tinyllama-1.1b", {}, 64),
    ("tinyllama-1.1b", {}, 2048),        # the loss's and the backward's chunks of 1024
    ("qwen2-1.5b", {}, 64),              # qkv bias
    ("tinyllama-1.1b", {"sliding_window": 16, "attn_softcap": 20.0}, 64),
    # the hybrid and rwkv families against both of the reference's mixers,
    # and a ragged S (61: no multiple of the scan's 64, wkv6's 16 or 32)
    ("hymba-1.5b", {}, 64),
    ("hymba-1.5b", {"mixer_impl": "chunked"}, 128),
    ("hymba-1.5b", {}, 61),
    ("rwkv6-7b", {}, 64),
    ("rwkv6-7b", {"mixer_impl": "chunked"}, 64),
    ("rwkv6-7b", {}, 61),
])
def test_train_loss_and_grads_match_reference(arch, overrides, seq):
    jmodel, params, model = _pair(arch, **overrides)
    batch = _batch(np.random.default_rng(seq), model.cfg.vocab, 1 if seq > 64 else 2, seq)
    want, grads = jax.jit(jax.value_and_grad(jmodel.train_loss))(params, batch)
    tparams = _ttree(params, grad=True)
    got = model.train_loss(tparams, _tbatch(batch))
    got.backward()
    _close(got, want)
    ref = dict(keystr_items(jax.tree.map(np.asarray, grads)))
    for key, leaf in keystr_items(tparams):
        _close(leaf.grad, ref[key])


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "hymba-1.5b", "rwkv6-7b"])
def test_remat_policies_give_the_same_gradients(arch):
    """``none`` (every block recomputed), ``dots`` (weight products kept)
    and ``full`` (nothing recomputed) differ in memory, not in values; the
    model's own parameters (``trainable``) give the tree's gradients."""
    _, params, _ = _pair(arch)
    cfg = reduced(get_config(arch))
    batch = _tbatch(_batch(np.random.default_rng(5), cfg.vocab, 2, 64))
    grads = {}
    for policy in ("none", "dots", "full"):
        model = build_model(cfg, device="cpu", dtype=torch.float32, remat_policy=policy)
        tparams = _ttree(params, grad=True)
        model.train_loss(tparams, batch).backward()
        grads[policy] = {key: leaf.grad for key, leaf in keystr_items(tparams)}
    for policy in ("dots", "full"):
        for key, g in grads[policy].items():
            torch.testing.assert_close(g, grads["none"][key], atol=1e-6, rtol=1e-6)
    own = from_reference(params, cfg, device="cpu", dtype=torch.float32).trainable()
    own.train_loss(None, batch).backward()
    # block j is layer i of group g
    where = [(g, i) for g, gd in enumerate(own.lm.groups) for i in range(gd.n_layers)]
    for name, p in own.lm.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            g, i = where[int(parts[1])]
            key = f"['groups'][{g}]" + "".join(f"[{x!r}]" for x in parts[2:])
            want = grads["none"][key][i]
        else:
            want = grads["none"]["".join(f"[{x!r}]" for x in parts)]
        torch.testing.assert_close(p.grad, want, atol=1e-6, rtol=1e-6)


# --- the scan's and wkv6's backwards against the reference's block forms -----------

def _scan_inputs(rng, b, s, h, p, n):
    xh = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (0.01 + 0.19 * rng.random((b, s, h))).astype(np.float32)
    decay = (0.7 + 0.299 * rng.random((b, s, h))).astype(np.float32)
    bt, ct = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    return xh, dt, decay, bt, ct


def _pad_steps(arrays, s_pad, ones=()):
    """Pad dim 1 to ``s_pad`` with zeros (ones for the arrays at ``ones``):
    the reference's block forms take whole chunks only."""
    out = []
    for i, a in enumerate(arrays):
        widths = [(0, 0)] * a.ndim
        widths[1] = (0, s_pad - a.shape[1])
        out.append(np.pad(a, widths, constant_values=1.0 if i in ones else 0.0))
    return out


def _scan_grads(args, w, s_pad):
    """The reference's gradients of sum(y * w) for its block form from a
    zero state, on inputs padded to whole chunks, cut back to S."""
    s = args[0].shape[1]
    b, _, h, p = args[0].shape
    h0 = np.zeros((b, h, p, args[3].shape[-1]), np.float32)
    padded = _pad_steps(args, s_pad, ones=(2,))
    wp = _pad_steps([w], s_pad)[0]
    f = lambda *a: jnp.sum(j_chunked_selective_scan(*a, h0, 64)[0] * wp)
    return [np.asarray(g)[:, :s] for g in jax.grad(f, argnums=(0, 1, 2, 3, 4))(*padded)]


def _port_grads(fn, args, w):
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    y, _ = fn(*leaves)
    (y * torch.from_numpy(w)).sum().backward()
    return [t.grad for t in leaves]


@pytest.mark.parametrize("s,clamp", [(128, False), (100, False), (128, True)])
def test_ssm_scan_backward_matches_reference(s, clamp):
    """``_SsmScan`` (the wrapper forward, the block form's backward) against
    ``jax.grad`` of ``_chunked_selective_scan``: whole chunks, a ragged S,
    and decays at 0 (the 1e-30 clamp), one per chunk, whose log-decay
    gradient is 0 on both sides."""
    rng = np.random.default_rng(s + clamp)
    args = list(_scan_inputs(rng, 2, s, 3, 8, 4))
    if clamp:
        args[2][:, [10, 70]] = 0.0
    w = rng.standard_normal(args[0].shape).astype(np.float32)
    want = _scan_grads(args, w, -(-s // 64) * 64)
    got = _port_grads(_SsmScan.apply, args, w)
    for g, ref in zip(got, want):
        assert torch.isfinite(g).all()
        _close(g, ref)
    # the forward is the wrapper's, equal to the ported block form
    with torch.no_grad():
        y_fn, h_fn = _SsmScan.apply(*(torch.from_numpy(a) for a in args))
        if s % 64 == 0:
            h0 = torch.zeros(2, 3, 8, 4)
            y_bf, h_bf = _chunked_selective_scan(*(torch.from_numpy(a) for a in args), h0, 64)
            _close(y_fn, y_bf.numpy())
            _close(h_fn, h_bf.numpy())


def _wkv_inputs(rng, b, s, h, kd):
    r, k, v = (0.5 * rng.standard_normal((b, s, h, kd)).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(-1.5 + rng.random((b, s, h, kd)))).astype(np.float32)
    u = (0.125 * rng.standard_normal((h, kd))).astype(np.float32)
    return [r, k, v, w, u]


def _wkv_grads(args, wy, s_pad):
    r, k, v, w, u = args
    b, s, h, kd = r.shape
    S0 = np.zeros((b, h, kd, v.shape[-1]), np.float32)
    rp, kp, vp, wp = _pad_steps([r, k, v, w], s_pad, ones=(3,))
    wyp = _pad_steps([wy.reshape(b, s, -1)], s_pad)[0]
    f = lambda r, k, v, w, u: jnp.sum(j_chunked_wkv(r, k, v, w, u, S0, 16)[0] * wyp)
    g = jax.grad(f, argnums=(0, 1, 2, 3, 4))(rp, kp, vp, wp, u)
    return [np.asarray(x)[:, :s] for x in g[:4]] + [np.asarray(g[4])]


@pytest.mark.parametrize("s,clamp", [(64, False), (50, False), (64, True)])
def test_wkv6_backward_matches_reference(s, clamp):
    """``_Wkv6`` (the wrapper forward, the block form's backward) against
    ``jax.grad`` of ``_chunked_wkv`` at its chunk of 16: whole chunks, a
    ragged S, and decays at 0 (the 1e-30 clamp), at most one per chunk and
    channel."""
    rng = np.random.default_rng(s + clamp)
    args = _wkv_inputs(rng, 2, s, 3, 8)
    if clamp:
        args[3][:, [5, 21, 40], 1] = 0.0
    wy = rng.standard_normal(args[2].shape).astype(np.float32)
    want = _wkv_grads(args, wy, -(-s // 16) * 16)
    got = _port_grads(_Wkv6.apply, args, wy)
    for g, ref in zip(got, want):
        assert torch.isfinite(g).all()
        _close(g, ref)
    if s % 16 == 0:
        with torch.no_grad():
            y_fn, S_fn = _Wkv6.apply(*(torch.from_numpy(a) for a in args))
            S0 = torch.zeros(2, 3, 8, 8)
            y_bf, S_bf = _chunked_wkv(*(torch.from_numpy(a) for a in args), S0, 16)
            _close(y_fn.reshape(2, s, -1), y_bf.numpy())
            _close(S_fn, S_bf.numpy())


def test_wkv6_backward_on_clamped_decays_repairs_the_references_nan():
    """The clamped-decay input of the card's ``test_rwkv6_kernel_clamped_
    decay_matches_plain`` (5% of decays at 1e-30 and a run of 40 clamped
    steps across step 128; B=2, H=4, S=1000, K=V=64).  In the reference's
    ``_chunked_wkv`` a masked (s >= t) exponent of a chunk with two or more
    clamped steps overflows to inf, and ``where``'s backward multiplies it by
    0: the w gradient of every such chunk is NaN.  The port takes masked
    exponents at -inf: every gradient is finite, and r, k, v, u and the w
    gradient wherever the reference's is finite agree with the reference
    (w at exactly the clamp aside: there the derivative of ``max`` is a
    convention, half in JAX, whole in torch)."""
    rng = np.random.default_rng(12)
    args = _wkv_inputs(rng, 2, 1000, 4, 64)
    hit = rng.random(args[3].shape) < 0.05
    args[3] = np.where(hit, np.float32(1e-30), args[3])
    args[3][:, 108:148] = 1e-30
    wy = rng.standard_normal(args[2].shape).astype(np.float32)
    want = _wkv_grads(args, wy, 1008)
    got = _port_grads(_Wkv6.apply, args, wy)
    bad = ~np.isfinite(want[3])
    assert bad[:, 112:144].all() and bad.mean() > 0.2, bad.mean()   # the run's whole chunks
    bad |= args[3] <= 1e-30
    assert all(np.isfinite(x).all() for i, x in enumerate(want) if i != 3)
    for i, (g, ref) in enumerate(zip(got, want)):
        assert torch.isfinite(g).all(), i
        if i == 3:
            g, ref = g.numpy()[~bad], ref[~bad]
        _close(g, ref)


def test_ssm_scan_backward_on_clamped_decays_repairs_the_references_nan():
    """Two decays at 0 (clamped to 1e-30) in one chunk of 64: the reference's
    masked exponent across both is exp(+138) = inf, and its decay gradient
    is NaN over the whole chunk; the port's is finite, 0 at the clamped
    steps, and agrees wherever the reference's is finite."""
    rng = np.random.default_rng(3)
    args = list(_scan_inputs(rng, 2, 128, 3, 8, 4))
    args[2][:, [20, 40]] = 0.0
    w = rng.standard_normal(args[0].shape).astype(np.float32)
    want = _scan_grads(args, w, 128)
    got = _port_grads(_SsmScan.apply, args, w)
    bad = ~np.isfinite(want[2])
    assert bad[:, :64].all() and not bad[:, 64:].any()
    for i, (g, ref) in enumerate(zip(got, want)):
        assert torch.isfinite(g).all(), i
        if i == 2:
            assert (g[:, [20, 40]] == 0).all()
            g, ref = g.numpy()[~bad], ref[~bad]
        _close(g, ref)


def test_backwards_never_call_the_plain_versions(monkeypatch):
    """The scan's and wkv6's backwards are the block forms' gradients, not
    autograd through the kernels' plain twins: on the CPU each forward calls
    the plain version once (the wrapper's own choice) and the backward never."""
    calls = {"ssm": 0, "wkv": 0}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(ssm_kernel, "ssm_scan_chunked_plain",
                        counted("ssm", ssm_kernel.ssm_scan_chunked_plain))
    monkeypatch.setattr(rwkv6_kernel, "rwkv6_chunked_plain",
                        counted("wkv", rwkv6_kernel.rwkv6_chunked_plain))
    rng = np.random.default_rng(0)
    for name, fn, args in (("ssm", _SsmScan.apply, _scan_inputs(rng, 1, 70, 2, 4, 3)),
                           ("wkv", _Wkv6.apply, _wkv_inputs(rng, 1, 40, 2, 4))):
        leaves = [torch.tensor(a, requires_grad=True) for a in args]
        y, _ = fn(*leaves)
        assert calls[name] == 1
        y.sum().backward()
        assert calls[name] == 1 and all(t.grad is not None for t in leaves)


def test_kernel_wrappers_refuse_inputs_that_need_a_gradient():
    """Each wrapper's output has no grad_fn on the card, so each refuses,
    on the CPU as there, an input that requires a gradient while grad mode
    is on; under ``no_grad`` (or detached) the same call runs."""
    rng = np.random.default_rng(0)
    t = lambda *shape: torch.from_numpy(rng.random(shape).astype(np.float32))
    calls = {
        "flash_attention": (flash_attention_fwd, (t(1, 2, 8, 16), t(1, 1, 8, 16), t(1, 1, 8, 16))),
        "ssm_scan_chunked": (ssm_scan_chunked, (t(1, 2, 8, 4), t(1, 2, 8), t(1, 2, 8),
                                                t(1, 8, 3), t(1, 8, 3))),
        "rwkv6_chunked": (rwkv6_chunked, (t(1, 2, 8, 4), t(1, 2, 8, 4), t(1, 2, 8, 4),
                                          t(1, 2, 8, 4), t(2, 4))),
    }
    for name, (fn, args) in calls.items():
        args[0].requires_grad_(True)
        with pytest.raises(RuntimeError, match=f"{name}: the kernel has no backward"):
            fn(*args)
        with torch.no_grad():
            fn(*args)
        fn(args[0].detach(), *args[1:])


# --- the optimizer, compression, the train step ---------------------------------------

def _opt_tree(rng):
    return {"a": rng.standard_normal((6, 5)).astype(np.float32),
            "groups": [{"w": rng.standard_normal((2, 5, 3)).astype(np.float32),
                        "s": rng.standard_normal((2, 3)).astype(np.float32)}]}


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moments):
    rng = np.random.default_rng(7)
    params = _opt_tree(rng)
    jcfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6,
                              moment_dtype=getattr(jnp, moments))
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6,
                            moment_dtype=getattr(torch, moments))
    jp, js = params, jadamw.init(params, jcfg)
    tp = _ttree(params)
    ts = adamw.init(tp, cfg)
    rel = 1e-6 if moments == "float32" else 2.0 ** -8     # a bf16 moment may round an ulp apart
    for step in range(5):
        grads = jax.tree.map(lambda a: (3.0 * rng.standard_normal(a.shape)).astype(np.float32), params)
        jp, js, jm = jadamw.update(grads, js, jp, jcfg)
        tp, ts, tm = adamw.update(_ttree(grads), ts, tp, cfg)
        for key in ("grad_norm", "lr"):
            _close(tm[key], jm[key], 1e-6)
        assert int(ts["count"]) == int(js["count"]) == step + 1
        for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            _close(got, want, 1e-6)
        for part in ("mu", "nu"):
            for got, want in zip(tree_leaves(ts[part]), jax.tree.leaves(js[part])):
                assert got.dtype == getattr(torch, moments)
                _close(got, np.asarray(want, np.float32), rel)
    specs = adamw.opt_state_specs(build_model(reduced(get_config("tinyllama-1.1b")),
                                              device="cpu").param_specs(), cfg)
    assert specs["count"].dtype == torch.int32
    assert all(s.dtype == cfg.moment_dtype for s in tree_leaves(specs["mu"]))


def test_adamw_updates_a_large_leaf_in_parts_exactly(monkeypatch):
    """A leaf over ``UPDATE_PART`` elements is updated in flat parts (their
    float32 temporaries bounded); every element equals the one-pass update
    bit for bit, moments included."""
    cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    gen = torch.Generator().manual_seed(3)
    params = {"w": torch.randn(3, 5, 7, generator=gen).bfloat16(), "b": torch.randn(4, generator=gen)}
    grads = {k: torch.randn(v.shape, generator=gen).to(v.dtype) for k, v in params.items()}
    state = adamw.init(params, cfg)
    state["mu"]["w"] += torch.randn(3, 5, 7, generator=gen)
    whole = adamw.update(grads, state, params, cfg)
    monkeypatch.setattr(adamw, "UPDATE_PART", 8)
    parts = adamw.update(grads, state, params, cfg)
    for got, want in zip(tree_leaves(parts[:2]), tree_leaves(whole[:2])):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)


def test_quantize_is_exact():
    rng = np.random.default_rng(11)
    for shape in ((5000,), (3, 2048), (7, 13, 5), ()):
        x = np.asarray(rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 3), np.float32)
        jq, js = jcompression.quantize(x)
        tq, ts = compression.quantize(torch.from_numpy(x))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(compression.fake_quantize(torch.from_numpy(x)).numpy(),
                                      np.asarray(jcompression.fake_quantize(x)))
        err = np.asarray(0.01 * rng.standard_normal(shape), np.float32)
        jy, je = jcompression.ef_quantize(x, err)
        ty, te = compression.ef_quantize(torch.from_numpy(x), torch.from_numpy(err))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    tree = {"a": torch.ones(3), "b": [torch.arange(4.0)]}
    out = compression.fake_quantize_tree(tree)
    assert sorted(out) == ["a", "b"] and out["b"][0].shape == (4,)


@pytest.mark.parametrize("arch,accum,compress", [
    ("tinyllama-1.1b", 1, False), ("tinyllama-1.1b", 2, False), ("tinyllama-1.1b", 1, True),
    ("tinyllama-1.1b", 2, True), ("hymba-1.5b", 2, False), ("rwkv6-7b", 2, False)])
def test_train_step_matches_reference(arch, accum, compress):
    jmodel, params, model = _pair(arch)
    jcfg = jadamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jmake_train_step(jmodel, jcfg, accum_steps=accum, compress_grads=compress))
    tstep = make_train_step(model, cfg, accum_steps=accum, compress_grads=compress)
    jp, js = params, jadamw.init(params, jcfg)
    tp = _ttree(params)
    ts = adamw.init(tp, cfg)
    rng = np.random.default_rng(accum + 2 * compress)
    for _ in range(3):
        batch = _batch(rng, model.cfg.vocab, 4, 32)
        jp, js, jm = jstep(jp, js, batch)
        tp, ts, tm = tstep(tp, ts, _tbatch(batch))
        _close(tm["loss"], jm["loss"])
        _close(tm["grad_norm"], jm["grad_norm"], 1e-3 if compress else 1e-4)
    # Adam moves each element by about lr per step, normalised by the
    # gradient's own scale.  Accumulated gradients are cast to bfloat16 on
    # both sides and may round one ulp (2^-8) apart, which moves a step by
    # at most about 2^-8 lr: the parameters agree to 3 x 2^-8 lr over the 3
    # steps.  With compression, a gradient 1 ulp apart can round to the next
    # int8 quantum, which moves that element's steps by up to lr each: every
    # element stays within 3 lr, and all but 1% of them within 3 x 2^-8 lr.
    # Where two microbatches' gradients nearly cancel, their float32 mean is
    # known only to the rounding of the parts, which can exceed one bf16 ulp
    # of the mean, and such an element's Adam step (g / (|g| + eps)) moves by
    # a part of lr: the hybrid's reduced tree holds 3 such elements of
    # 133,720 (0.0223 lr apart at most).  For the hybrid and rwkv cases every
    # element stays within 3 lr, and all but 1e-4 of them within 3 x 2^-8 lr.
    near = 3 * 2.0 ** -8 * cfg.lr
    diff = np.concatenate([np.abs(got.numpy() - np.asarray(want)).ravel()
                           for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp))])
    loose = compress or arch != "tinyllama-1.1b"
    assert diff.max() <= (3 * cfg.lr if loose else near), diff.max()
    assert (diff > near).mean() <= (1e-2 if compress else 1e-4), (diff > near).mean()
    assert all(not t.requires_grad for t in tree_leaves(tp))


def test_token_pipeline_is_the_references():
    for cfg_args in ((256, 2, 16), (32000, 3, 40)):
        j, t = JTokenPipeline(JDataConfig(*cfg_args)), TokenPipeline(DataConfig(*cfg_args))
        for _ in range(3):
            a, b = j.next_batch(), t.next_batch()
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        assert int(t.state()["cursor"]) == 3
        again = TokenPipeline.restore(DataConfig(*cfg_args), t.state())
        np.testing.assert_array_equal(again.next_batch()["tokens"], j.next_batch()["tokens"])


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-1.5b", "hymba-1.5b", "rwkv6-7b",
                                  "whisper-medium", "mixtral-8x22b", "grok-1-314b",
                                  "llava-next-mistral-7b"])
def test_to_reference_inverts_from_reference(arch):
    """The reference's bfloat16 tree through the port and back, exactly:
    the same keys, shapes, dtypes and values."""
    jcfg = jreduced(jget_config(arch))
    params = jax.tree.map(np.asarray, jax.jit(jbuild_model(jcfg).init)(jax.random.PRNGKey(2)))
    model = from_reference(params, reduced(get_config(arch)), device="cpu")
    back = to_reference(model)
    want = list(keystr_items(params))
    got = list(keystr_items(back))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, g), (_, w) in zip(got, want):
        assert g.device.type == "cpu" and tuple(g.shape) == w.shape, key
        assert str(g.dtype).replace("torch.", "") == w.dtype.name, key
        np.testing.assert_array_equal(g.float().numpy(), w.astype(np.float32), err_msg=key)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-medium", "mixtral-8x22b",
                                  "llava-next-mistral-7b"])
def test_to_reference_release_hands_the_parameters_over(arch):
    """``to_reference(release=True)`` gives the same tree as a copy, leaves
    every parameter of the model empty, and the model's ``train_loss``
    through that tree is the loss before the release, bit for bit."""
    cfg = reduced(get_config(arch))
    model = build_model(cfg, device="cpu", dtype=torch.float32).init(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 17)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
    batch.update({k: torch.from_numpy(v) for k, v in draw_extras(cfg, rng, 2).items()})
    kept = tree_map(lambda t: t.clone(), to_reference(model))
    want = model.train_loss(kept, batch)
    given = to_reference(model, release=True)
    assert all(p.numel() == 0 for p in model.lm.parameters())
    got, ref = list(keystr_items(given)), list(keystr_items(kept))
    assert [k for k, _ in got] == [k for k, _ in ref]
    for (key, g), (_, w) in zip(got, ref):
        assert torch.equal(g, w), key
    assert torch.equal(model.train_loss(given, batch), want)
