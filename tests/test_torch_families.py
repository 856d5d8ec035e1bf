"""The encoder-decoder, MoE and VLM families of the port against the
reference's, on the CPU.

Reduced ``whisper-medium`` (encoder-decoder: bidirectional encoder,
causal self-attention and cross-attention in the decoder),
``mixtral-8x22b`` (MoE with a sliding window), ``grok-1-314b`` (MoE with
an attention logit softcap) and ``llava-next-mistral-7b`` (vision
embeddings prepended to the tokens): the reference's ``Model.init`` draws
the weights, ``repro_torch.models.weights.from_reference`` carries them
over, and both packages run the same numpy-seeded tokens, frame and patch
embeddings.  Prefill logits and every cache leaf, 8 decode steps and
``ServeEngine.generate``'s tokens; ``train_loss`` and every gradient leaf;
the MoE dispatch alone on a config that drops slots.

Tolerances, as ``tests/test_torch_llm.py`` states them: float32 at 1e-4
(summation order only), bfloat16 at 3e-2 against the reference run op by
op under ``jax.disable_jit()`` (each side rounds every op to bfloat16 on its
own), gradients at 1e-4 of each leaf's largest magnitude.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoECfg as JMoECfg
from repro.configs.base import reduced as jreduced
from repro.configs.registry import get_config as jget_config
from repro.models import ffn as jffn
from repro.models.api import build_model as jbuild_model
from repro.models.serve_llm import ServeEngine as JServeEngine
from repro_torch.configs.base import MoECfg
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.launch import train as train_cli
from repro_torch.models import ffn
from repro_torch.models.api import build_model, draw_extras
from repro_torch.models.common import iter_leaves
from repro_torch.models.serve_llm import ServeEngine
from repro_torch.models.weights import from_reference
from repro_torch.tree import keystr_items

FAMILIES = ["whisper-medium", "mixtral-8x22b", "grok-1-314b", "llava-next-mistral-7b"]
PROMPT, STEPS, CACHE_LEN = 64, 8, 80


def _tol(dtype):
    return dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else dict(atol=3e-2, rtol=3e-2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _reference_mode(dtype):
    """bfloat16: the reference op by op (ROADMAP Queue C, "bf16 rounding of
    the compiled reference")."""
    return jax.disable_jit() if dtype == "bfloat16" else contextlib.nullcontext()


def _pair(arch, dtype, seed=1, moe=None, **overrides):
    """The reference model with its params, and the port model holding the
    same params (float32: every leaf cast to float32 on both sides); ``moe``:
    the MoE config's fields, as each package's own ``MoECfg``."""
    jover, over = dict(overrides), dict(overrides)
    if moe is not None:
        jover["moe"], over["moe"] = JMoECfg(**moe), MoECfg(**moe)
    jmodel = jbuild_model(jreduced(jget_config(arch), **jover))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    host = jax.tree.map(np.asarray, params)
    model = from_reference(host, reduced(get_config(arch), **over), device="cpu",
                           dtype=getattr(torch, dtype))
    return jmodel, params, model


def _batches(extras, dtype, **arrays):
    """The same inputs for both packages: the embeddings rounded to the
    model's dtype on both sides."""
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    tb = {k: torch.from_numpy(v) for k, v in arrays.items()}
    for k, v in extras.items():
        jv = jnp.asarray(v, getattr(jnp, dtype))
        jb[k] = jv
        tb[k] = torch.from_numpy(_np(jv)).to(getattr(torch, dtype))
    return jb, tb


def _assert_trees_close(got, want, tol):
    got, want = dict(iter_leaves(got)), dict(iter_leaves(want))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
        np.testing.assert_allclose(_np(got[k]), _np(w), err_msg=k, **tol)


def _prefix(cfg, extras):
    return extras["vision_embeds"].shape[1] if cfg.vlm is not None else 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_reference(arch, dtype):
    jmodel, params, model = _pair(arch, dtype)
    cfg, tol = model.cfg, _tol(dtype)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 256, (2, PROMPT + STEPS)).astype(np.int32)
    extras = draw_extras(cfg, rng, 2)
    jb, tb = _batches(extras, dtype, tokens=toks[:, :PROMPT])
    cache_len = CACHE_LEN + _prefix(cfg, extras)
    with _reference_mode(dtype):
        jlogits, jcache = jmodel.prefill(params, jb, cache_len=cache_len)
        logits, cache = model.prefill(tb, cache_len)
        assert logits.dtype == getattr(torch, dtype) and logits.shape == (2, 1, 256)
        np.testing.assert_allclose(_np(logits), _np(jlogits), **tol)
        _assert_trees_close(cache, jcache, tol)
        for i in range(PROMPT, PROMPT + STEPS):
            pos = i + _prefix(cfg, extras)
            jlogits, jcache = jmodel.decode_step(params, jcache, jnp.asarray(toks[:, i:i + 1]),
                                                 jnp.asarray(pos, jnp.int32))
            logits, cache = model.decode_step(cache, torch.from_numpy(toks[:, i:i + 1]), pos)
            np.testing.assert_allclose(_np(logits), _np(jlogits), err_msg=f"step {i}", **tol)
        _assert_trees_close(cache, jcache, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_generate_tokens_match_reference(arch, dtype):
    """Greedy tokens equal; for llava the decode positions start after the
    8 patches and the prompt (the engine's position offset)."""
    jmodel, params, model = _pair(arch, dtype, seed=3)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 256, (3, PROMPT)).astype(np.int32)
    extras = draw_extras(model.cfg, rng, 3)
    jb, tb = _batches(extras, dtype, tokens=toks)
    cache_len = CACHE_LEN + _prefix(model.cfg, extras)
    with _reference_mode(dtype):
        want = JServeEngine(jmodel, params, cache_len=cache_len).generate(jb, max_new=10)
    got = ServeEngine(model, cache_len=cache_len).generate(tb, max_new=10)
    assert got.tokens.shape == (3, 10) and got.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


def test_vlm_decode_needs_the_position_offset():
    """The engine's offset matters: decoding llava from position PROMPT
    (the prompt alone) gives other logits than from PROMPT + patches."""
    _, _, model = _pair("llava-next-mistral-7b", "float32")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 256, (2, PROMPT + 1)).astype(np.int32)
    _, tb = _batches(draw_extras(model.cfg, rng, 2), "float32", tokens=toks[:, :PROMPT])
    n = model.cfg.vlm.n_patches
    nxt = torch.from_numpy(toks[:, PROMPT:])
    right, _ = model.decode_step(model.prefill(tb, CACHE_LEN + n)[1], nxt, PROMPT + n)
    wrong, _ = model.decode_step(model.prefill(tb, CACHE_LEN + n)[1], nxt, PROMPT)
    assert (right - wrong).abs().max() > 1e-3


# --- training ----------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["none", "full"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_loss_and_grads_match_reference(arch, policy):
    """float32: the loss and every gradient leaf against
    ``jax.value_and_grad`` of the reference's ``train_loss`` under the same
    rematerialisation policy, at 1e-4 of each leaf's largest magnitude."""
    jcfg = jreduced(jget_config(arch))
    jmodel = jbuild_model(jcfg, remat_policy=policy)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          jax.jit(jmodel.init)(jax.random.PRNGKey(5)))
    model = build_model(reduced(get_config(arch)), device="cpu", dtype=torch.float32,
                        remat_policy=policy)
    rng = np.random.default_rng(13)
    b, s = 2, 48
    arrays = dict(tokens=rng.integers(0, 256, (b, s)).astype(np.int32),
                  labels=rng.integers(0, 256, (b, s)).astype(np.int32))
    jb, tb = _batches(draw_extras(model.cfg, rng, b), "float32", **arrays)
    want, grads = jax.jit(jax.value_and_grad(jmodel.train_loss))(params, jb)
    tparams = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True), params)
    got = model.train_loss(tparams, tb)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    ref = dict(keystr_items(jax.tree.map(np.asarray, grads)))
    for key, leaf in keystr_items(tparams):
        w = ref[key]
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(float(np.abs(w).max()), 1e-30), err_msg=key)


def test_train_cli_trains_the_moe_family_on_the_cpu(tmp_path, capsys):
    assert train_cli.main(["--arch", "mixtral-8x22b", "--device", "cpu", "--reduced",
                           "--steps", "2", "--batch", "2", "--seq", "32", "--save-every", "1",
                           "--log-every", "1", "--journal-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "arch=mixtral-8x22b" in out and "[journal] last committed step: 1" in out


# --- the MoE dispatch ------------------------------------------------------------------

class _Recorder:
    """Records what the reference's ``moe_fwd`` hands to ``jax.nn.one_hot``
    (the chosen experts, then each slot's position with the capacity) and
    to its first dispatch einsum (the expert one-hot masked by ``keep``)."""

    def __init__(self, monkeypatch):
        self.one_hot, self.disp = [], None
        one_hot, einsum = jffn.jax.nn.one_hot, jffn.jnp.einsum

        def rec_one_hot(x, n, **kw):
            self.one_hot.append((np.asarray(x), n))
            return one_hot(x, n, **kw)

        def rec_einsum(spec, *ops, **kw):
            if spec == "GskE,GskC->GsEC" and self.disp is None:
                self.disp = np.asarray(ops[0].astype(jnp.float32))
            return einsum(spec, *ops, **kw)

        monkeypatch.setattr(jffn.jax.nn, "one_hot", rec_one_hot)
        monkeypatch.setattr(jffn.jnp, "einsum", rec_einsum)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_moe_dispatch_matches_reference_where_slots_drop(monkeypatch, dtype, tol):
    """E=4, k=2, capacity factor 0.5, groups of 16 over 2 x 23 tokens (the
    last group ragged, 2 pad tokens): capacity 4 of the 8 slots a group
    sends to each expert on average, so slots drop.  The chosen experts,
    every slot's position, ``keep`` and the capacity equal the reference's
    exactly; the output agrees within ``tol``."""
    d, f, e, k = 32, 48, 4, 2
    kw = dict(n_experts=e, top_k=k, capacity_factor=0.5, group_size=16)
    rng = np.random.default_rng(21)
    spec = jffn.moe_spec(d, f, e)
    params = {name: (rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])).astype(np.float32)
              for name, s in spec.items()}
    x = rng.standard_normal((2, 23, d)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    jp = {n: jnp.asarray(v, jnp.float32 if n == "router" else jdt) for n, v in params.items()}
    jx = jnp.asarray(x, jdt)
    rec = _Recorder(monkeypatch)
    with _reference_mode(dtype):
        want = jffn.moe_fwd(jp, jx, **kw)
    (top_i, n_e), (pos, capacity) = rec.one_hot
    assert n_e == e and capacity == 4

    tp = torch.nn.Module()
    for n, v in jp.items():
        tp.register_parameter(n, torch.nn.Parameter(
            torch.from_numpy(_np(v)).to(torch.float32 if n == "router" else getattr(torch, dtype)),
            requires_grad=False))
    tx = torch.from_numpy(_np(jx)).to(getattr(torch, dtype))
    got = ffn.moe_fwd(tp, tx, **kw)
    xg = torch.nn.functional.pad(tx.reshape(46, d), (0, 0, 0, 2)).reshape(3, 16, d)
    valid = (torch.arange(48) < 46).reshape(3, 16)
    r = ffn.moe_route(tp.router, xg, valid, n_experts=e, top_k=k, capacity_factor=0.5)
    keep = rec.disp.sum(-1) > 0                                       # (G, g, k)
    np.testing.assert_array_equal(r.top_i.numpy(), top_i)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert r.capacity == capacity
    dropped = int((~r.keep & valid[..., None]).sum())
    assert dropped > 0 and int((~valid).sum()) == 2
    # the real tokens' router probabilities have no ties; the 2 pad tokens
    # (zeros) tie all 4 experts, and take experts 0 and 1 in both packages
    probs = torch.softmax(xg.float() @ tp.router, dim=-1).sort(dim=-1).values
    assert (probs[valid][:, 1:] - probs[valid][:, :-1]).min() > 1e-6
    assert (r.top_i[~valid] == torch.tensor([0, 1])).all()
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_moe_decode_capacity_convention_is_the_references(monkeypatch):
    """The reference's MoE is not continuation-exact by its design: a decode
    step's group is its B tokens, with a capacity of max(ceil(B k cf / E),
    k), while a prefill groups up to ``group_size`` tokens across batch
    rows.  Reduced mixtral with 4 experts, top 2, capacity factor 1.0 and
    no window: a decode step of 8 tokens has a capacity of 4 per expert and
    drops slots.  Both packages agree on the decode logits (the port drops
    those slots), and both differ from one longer prefill."""
    moe = dict(n_experts=4, top_k=2, capacity_factor=1.0, group_size=16)
    jmodel, params, model = _pair("mixtral-8x22b", "float32", seed=4, moe=moe,
                                  sliding_window=None)
    toks = np.random.default_rng(8).integers(0, 256, (8, 13)).astype(np.int32)
    jl, jc = jmodel.prefill(params, {"tokens": jnp.asarray(toks[:, :12])}, cache_len=16)
    _, tc = model.prefill({"tokens": torch.from_numpy(toks[:, :12])}, 16)
    routes, route = [], ffn.moe_route
    monkeypatch.setattr(ffn, "moe_route", lambda *a, **kw: routes.append(route(*a, **kw)) or routes[-1])
    tl, _ = model.decode_step(tc, torch.from_numpy(toks[:, 12:]), 12)
    jl, _ = jmodel.decode_step(params, jc, jnp.asarray(toks[:, 12:]), jnp.asarray(12, jnp.int32))
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=1e-4)
    assert len(routes) == model.cfg.n_layers and all(r.capacity == 4 for r in routes)
    assert sum(int((~r.keep).sum()) for r in routes) > 0
    jfull, _ = jmodel.prefill(params, {"tokens": jnp.asarray(toks)}, cache_len=16)
    tfull, _ = model.prefill({"tokens": torch.from_numpy(toks)}, 16)
    np.testing.assert_allclose(_np(tfull), _np(jfull), atol=1e-4, rtol=1e-4)
    assert np.abs(_np(jl)[:, 0] - _np(jfull)[:, 0]).max() > 1e-3
    assert np.abs(_np(tl)[:, 0] - _np(tfull)[:, 0]).max() > 1e-3
