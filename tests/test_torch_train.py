"""The port's training path against the reference's, on the CPU.

Inputs are made by numpy from a seed and handed to both packages; the
reference's weights are carried over with ``from_reference``.  Everything
is float32 unless a case says otherwise, and the two sides differ only in
summation order, so gradients, losses and updates agree to 1e-4 relative
to each leaf's largest magnitude (the optimizer alone to 1e-6: it is
elementwise with one global norm).  The flash backward (``_Flash``) is held
against ``jax.grad`` of the reference's ``attend(impl="flash")``, whose
``custom_vjp`` it ports; ``train_loss`` against ``jax.value_and_grad`` of
the reference's (its attention is ``masked_scan`` there, the same function).
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
from repro.optim import adamw as jadamw
from repro.parallel import compression as jcompression
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.rwkv6 import rwkv6_chunked
from repro_torch.kernels.ssm_scan import ssm_scan_chunked
from repro_torch.models.api import build_model
from repro_torch.models.attention import attend
from repro_torch.models.lm import NO_GRAD_ITEM, chunked_xent
from repro_torch.models.weights import from_reference, to_reference
from repro_torch.optim import adamw
from repro_torch.parallel import compression
from repro_torch.train.step import make_train_step
from repro_torch.tree import keystr_items, tree_leaves


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


def test_remat_policies_give_the_same_gradients():
    """``none`` (every block recomputed), ``dots`` (weight products kept)
    and ``full`` (nothing recomputed) differ in memory, not in values; the
    model's own parameters (``trainable``) give the tree's gradients."""
    _, params, _ = _pair("tinyllama-1.1b")
    cfg = reduced(get_config("tinyllama-1.1b"))
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
    for name, p in own.lm.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":      # tinyllama's layers are one group
            key, i = "['groups'][0]" + "".join(f"[{x!r}]" for x in parts[2:]), int(parts[1])
            want = grads["none"][key][i]
        else:
            want = grads["none"]["".join(f"[{x!r}]" for x in parts)]
        torch.testing.assert_close(p.grad, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-7b"])
def test_families_without_a_backward_raise(arch):
    model = build_model(reduced(get_config(arch)), device="cpu")
    tree = to_reference(model)
    batch = _tbatch(_batch(np.random.default_rng(0), model.cfg.vocab, 1, 16))
    for params in (tree, None):
        with pytest.raises(NotImplementedError, match="ROADMAP") as err:
            model.train_loss(params, batch)
        assert NO_GRAD_ITEM in str(err.value)


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


@pytest.mark.parametrize("accum,compress", [(1, False), (2, False), (1, True), (2, True)])
def test_train_step_matches_reference(accum, compress):
    jmodel, params, model = _pair("tinyllama-1.1b")
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
    near = 3 * 2.0 ** -8 * cfg.lr
    diff = np.concatenate([np.abs(got.numpy() - np.asarray(want)).ravel()
                           for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp))])
    assert diff.max() <= (3 * cfg.lr if compress else near), diff.max()
    assert (diff > near).mean() <= 1e-2, (diff > near).mean()
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


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-1.5b", "hymba-1.5b", "rwkv6-7b"])
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
