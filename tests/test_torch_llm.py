"""The port's LLM serve path against the reference's, on the CPU.

Reduced ``hymba-1.5b`` (hybrid: sliding-window and full attention layers,
the Mamba branch), reduced ``tinyllama-1.1b`` (dense) and reduced
``rwkv6-7b`` (attention-free, the wkv6 recurrence): the reference's
``Model.init`` draws the weights, ``repro_torch.models.weights.
from_reference`` carries them over, and both packages run the same
numpy-seeded tokens: prefill logits and caches (per group, stacked over
its layers), 8 decode steps, and ``ServeEngine.generate``'s tokens.

Tolerances: float32 weights at 1e-4 (the two sides differ in summation
order and in the attention and scan algorithms' rounding only); bfloat16
weights at 3e-2, the tolerance of ``tests/test_decode_oracles.py``, since
both sides round every matmul output and activation to bfloat16 (2^-8
relative) on their own.  The reference runs with ``mixer_impl="scan"``
(per-step recurrence) and ``"chunked"`` (block form); the port always takes
the chunked kernel's plain version in prefill.  The prompt is 64 tokens,
longer than the reduced window of 32 (so the window masks bite) and a
multiple of the chunk (so the reference's chunked form runs).
"""

import contextlib
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced as jreduced
from repro.configs.registry import ARCH_NAMES as JARCH_NAMES
from repro.configs.registry import get_config as jget_config
from repro.models.api import build_model as jbuild_model
from repro.models.attention import attend as jattend
from repro.models.lm import layer_groups as jlayer_groups
from repro.models.serve_llm import ServeEngine as JServeEngine
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import ARCH_NAMES, get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import encdec as tencdec
from repro_torch.models import lm as tlm
from repro_torch.models.api import build_model
from repro_torch.models.attention import attend as tattend
from repro_torch.models.common import iter_leaves
from repro_torch.models.serve_llm import ServeEngine
from repro_torch.models.weights import from_reference

PROMPT, STEPS, CACHE_LEN = 64, 8, 80


def _tol(dtype):
    return dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else dict(atol=3e-2, rtol=3e-2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(arch, dtype, seed=1, **overrides):
    """The reference model with its params, and the port model holding the
    same params (float32: every leaf cast to float32 on both sides)."""
    jcfg = jreduced(jget_config(arch), **overrides)
    jmodel = jbuild_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    host = jax.tree.map(np.asarray, params)
    model = from_reference(host, reduced(get_config(arch), **overrides), device="cpu",
                           dtype=getattr(torch, dtype))
    return jmodel, params, model


def _assert_caches_close(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert tuple(g[k].shape) == tuple(w[k].shape), k
            np.testing.assert_allclose(_np(g[k]), _np(w[k]), err_msg=k, **tol)


CASES = [("hymba-1.5b", dt, impl) for dt in ("float32", "bfloat16") for impl in ("scan", "chunked")]
CASES += [("tinyllama-1.1b", dt, "scan") for dt in ("float32", "bfloat16")]
CASES += [("rwkv6-7b", dt, impl) for dt in ("float32", "bfloat16") for impl in ("scan", "chunked")]


def _reference_mode(dtype):
    """bfloat16: the reference op by op (``jax.disable_jit``), which rounds
    every op's output to bfloat16 as its model code says and as the port
    does.  Compiled, XLA fuses chains of bfloat16 elementwise ops and skips
    their intermediate roundings, which moves the reference's own reduced
    hymba logits by 0.06 (ROADMAP Queue C)."""
    return jax.disable_jit() if dtype == "bfloat16" else contextlib.nullcontext()


@pytest.mark.parametrize("arch,dtype,impl", CASES)
def test_prefill_and_decode_match_reference(arch, dtype, impl):
    with _reference_mode(dtype):
        _prefill_and_decode(arch, dtype, impl)


def _prefill_and_decode(arch, dtype, impl, **overrides):
    jmodel, params, model = _pair(arch, dtype, mixer_impl=impl, **overrides)
    tol = _tol(dtype)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 256, (2, PROMPT + STEPS)).astype(np.int32)

    jlogits, jcache = jmodel.prefill(params, {"tokens": jnp.asarray(toks[:, :PROMPT])},
                                     cache_len=CACHE_LEN)
    logits, cache = model.prefill({"tokens": torch.from_numpy(toks[:, :PROMPT])}, CACHE_LEN)
    assert logits.dtype == getattr(torch, dtype) and logits.shape == (2, 1, 256)
    np.testing.assert_allclose(_np(logits), _np(jlogits), **tol)
    _assert_caches_close(cache, jcache, tol)

    for i in range(PROMPT, PROMPT + STEPS):
        jlogits, jcache = jmodel.decode_step(params, jcache, jnp.asarray(toks[:, i:i + 1]),
                                             jnp.asarray(i, jnp.int32))
        logits, cache = model.decode_step(cache, torch.from_numpy(toks[:, i:i + 1]), i)
        np.testing.assert_allclose(_np(logits), _np(jlogits), err_msg=f"step {i}", **tol)
    _assert_caches_close(cache, jcache, tol)


def test_reduced_stablelm_head_dim_160_matches_reference():
    """stablelm-12b's head dim of 160 (LayerNorm, 4 query and 2 KV heads of
    160 at the reduced width), float32: prefill logits and caches and 8
    decode steps against the reference at 1e-4."""
    _prefill_and_decode("stablelm-12b", "float32", "scan", head_dim=160)


# per head dim: (bf16 output elements that differ, of all) measured on these inputs
Q_SCALE_GAP = {128: (23_852, 65_536), 160: (30_964, 81_920)}


@pytest.mark.parametrize("d", [64, 128, 160])
def test_bf16_q_scale_convention(d):
    """The reference's model path scales q by 1/sqrt(D) in q's dtype
    (``repro/models/attention.py::attend``: ``qg * scale`` in bfloat16); the
    port's attention (the kernel and its plain version) scales in float32.
    At D = 16 and 64 the scale is a power of two and the scaled q is the
    same bit for bit; the outputs differ only by float32 summation order (3
    of 32,768 bf16 elements, by 2.4e-4, measured).  1/sqrt(128) = 2^-3.5 is
    not a power of two: at D = 128 (llava, mixtral, grok, qwen2,
    deepseek) and D = 160 every element of the scaled q differs (the
    reference rounds the scale and the product to bfloat16), and the outputs
    differ in 23,852 of 65,536 (D = 128) and 30,964 of 81,920 (D = 160)
    elements by up to 0.0078 (two bf16 ulps at |o| < 4), measured on these
    inputs: a convention, within the bf16 tolerance."""
    rng = np.random.default_rng(d)
    q = rng.standard_normal((2, 64, 4, d)).astype(np.float32)
    k, v = (rng.standard_normal((2, 64, 2, d)).astype(np.float32) for _ in range(2))
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    scale = 1.0 / math.sqrt(d)        # a Python float, weakly typed in JAX
    with jax.disable_jit():
        ref = _np(jattend(qb, kb, vb, causal=True))
        ref_q = _np(qb * scale)
    tq, tk, tv = (torch.from_numpy(_np(x)).to(torch.bfloat16) for x in (qb, kb, vb))
    got = _np(tattend(tq, tk, tv, causal=True))
    port_q = (tq.float() * scale).numpy()
    diff = np.abs(got - ref)
    if d == 64:
        np.testing.assert_array_equal(ref_q, port_q)
        assert diff.max() <= 2.0 ** -12 and (diff > 0).sum() <= 3
    else:
        assert (ref_q != port_q).all()
        # the scale and the product, each rounded to bfloat16 (2^-8 apiece)
        np.testing.assert_allclose(ref_q, port_q, rtol=2.0 ** -7, atol=0)
        assert diff.max() == 0.0078125 and ((diff > 0).sum(), diff.size) == Q_SCALE_GAP[d]
        np.testing.assert_allclose(got, ref, **_tol("bfloat16"))


@pytest.mark.parametrize("arch,dtype", [("hymba-1.5b", "float32"), ("hymba-1.5b", "bfloat16"),
                                        ("tinyllama-1.1b", "float32"),
                                        ("tinyllama-1.1b", "bfloat16"),
                                        ("rwkv6-7b", "float32"), ("rwkv6-7b", "bfloat16")])
def test_generate_tokens_match_reference(arch, dtype):
    jmodel, params, model = _pair(arch, dtype, seed=3, mixer_impl="chunked")
    toks = np.random.default_rng(11).integers(0, 256, (3, PROMPT)).astype(np.int32)
    with _reference_mode(dtype):
        want = JServeEngine(jmodel, params, cache_len=CACHE_LEN).generate(
            {"tokens": jnp.asarray(toks)}, max_new=10)
    got = ServeEngine(model, cache_len=CACHE_LEN).generate({"tokens": torch.from_numpy(toks)},
                                                           max_new=10)
    assert got.tokens.shape == (3, 10) and got.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    assert got.prefill_s > 0 and got.decode_s > 0 and got.tokens_per_s > 0


# --- the reference's ring-cache divergence, pinned --------------------------------

def _continuation(jmodel, params, model, toks, prompt, cache_len):
    """Prefill ``prompt`` tokens, decode the rest one by one; returns each
    package's final logits."""
    total = toks.shape[1]
    jl, jc = jmodel.prefill(params, {"tokens": jnp.asarray(toks[:, :prompt])}, cache_len=cache_len)
    tl, tc = model.prefill({"tokens": torch.from_numpy(toks[:, :prompt])}, cache_len)
    for i in range(prompt, total):
        jl, jc = jmodel.decode_step(params, jc, jnp.asarray(toks[:, i:i + 1]),
                                    jnp.asarray(i, jnp.int32))
        tl, tc = model.decode_step(tc, torch.from_numpy(toks[:, i:i + 1]), i)
    return _np(jl)[:, 0], _np(tl)[:, 0]


def test_ring_cache_divergence_is_the_references():
    """``_attn_prefill`` stores the last ``cache_len`` keys in slots
    ``0..C-1`` while ``_attn_decode`` reads position p at slot ``p % C``.
    With prompt 11 > cache_len 8 (not a multiple), decoding after a prefill
    no longer equals one long prefill — in the reference and, by design, in
    the port, which matches it.  With prompt <= cache_len both agree with
    the long prefill."""
    over = dict(sliding_window=8, full_attn_layers=())
    jmodel, params, model = _pair("hymba-1.5b", "float32", seed=2, **over)
    toks = np.random.default_rng(5).integers(0, 256, (1, 14)).astype(np.int32)
    jfull, _ = jmodel.prefill(params, {"tokens": jnp.asarray(toks)}, cache_len=8)
    tfull, _ = model.prefill({"tokens": torch.from_numpy(toks)}, 8)
    full = _np(jfull)[:, 0]
    np.testing.assert_allclose(_np(tfull)[:, 0], full, atol=1e-4, rtol=1e-4)

    jl, tl = _continuation(jmodel, params, model, toks, prompt=11, cache_len=8)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)     # port == reference
    assert np.abs(jl - full).max() > 0.1                          # both diverge
    assert np.abs(tl - full).max() > 0.1

    for prompt in (6, 8):
        jl, tl = _continuation(jmodel, params, model, toks, prompt=prompt, cache_len=8)
        np.testing.assert_allclose(jl, full, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(tl, full, atol=1e-4, rtol=1e-4)


# --- configs, specs and families ----------------------------------------------------

@pytest.mark.parametrize("arch", JARCH_NAMES)
def test_configs_and_groups_are_the_references(arch):
    assert ARCH_NAMES == JARCH_NAMES
    for make_j, make_t in ((lambda c: c, lambda c: c), (jreduced, reduced)):
        jcfg, cfg = make_j(jget_config(arch)), make_t(get_config(arch))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.n_params() == jcfg.n_params() and cfg.hd == jcfg.hd
        assert [dataclasses.astuple(g) for g in tlm.layer_groups(cfg)] == \
               [dataclasses.astuple(g) for g in jlayer_groups(jcfg)]


def test_layer_groups_under_a_depth_cut_are_the_references():
    """A fault of the reference that the port keeps: ``layer_groups`` puts
    a one-layer full-attention group at every index of
    ``full_attn_layers``, at or past ``n_layers`` too.  hymba-1.5b cut to 8
    layers (full attention at 0, 16 and 31) gets groups of 1, 15, 1, 14 and
    1 layers, 32 in all, in both packages."""
    jcfg = dataclasses.replace(jget_config("hymba-1.5b"), n_layers=8)
    cfg = dataclasses.replace(get_config("hymba-1.5b"), n_layers=8)
    want = [("hymba", 1, None), ("hymba", 15, 1024), ("hymba", 1, None), ("hymba", 14, 1024),
            ("hymba", 1, None)]
    assert [dataclasses.astuple(g) for g in jlayer_groups(jcfg)] == want
    assert [dataclasses.astuple(g) for g in tlm.layer_groups(cfg)] == want


def test_rwkv_param_count_divergence_is_the_references():
    """The analytic count of the rwkv family (``ArchConfig.n_params``, the
    reference's formula) takes the channel mix as 1.5·d·f where the model
    holds 2·d·f + d², and leaves out the norms, the token-shift mixes, the
    decay's base ``w0`` and the bonus ``u``.  On reduced rwkv6 the config
    says 100,352 and the port's model holds 118,784; the reference's
    config says the same 100,352."""
    cfg = reduced(get_config("rwkv6-7b"))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    held = sum(p.numel() for p in model.lm.parameters())
    assert cfg.n_params() == 100_352 and held == 118_784
    assert cfg.n_params() != held
    assert jreduced(jget_config("rwkv6-7b")).n_params() == cfg.n_params()


@pytest.mark.parametrize("arch", JARCH_NAMES)
def test_param_and_cache_specs_are_the_references(arch):
    """Every arch at full size, specs only (no parameter is allocated)."""
    from repro.models import encdec as jencdec
    from repro.models import lm as jlm

    cfg, jcfg = get_config(arch), jget_config(arch)
    if cfg.enc_dec is not None:
        pairs = ((tencdec.param_specs(cfg), jencdec.param_specs(jcfg)),
                 (tencdec.cache_specs(cfg, 4, 448), jencdec.EncDecLM(jcfg).cache_specs(4, 448)))
    else:
        pairs = ((tlm.param_specs(cfg), jlm.param_specs(jcfg)),
                 (tlm.cache_specs(cfg, 4, 4096), jlm.cache_specs(jcfg, 4, 4096)))
    for got, want in pairs:
        got, want = dict(iter_leaves(got)), dict(iter_leaves(want))
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            g = got[k]
            assert (g.shape, g.logical, g.init, g.init_scale) == \
                   (w.shape, w.logical, w.init, w.init_scale), k
            assert str(g.dtype).split(".")[-1] == np.dtype(w.dtype).name, k


def test_reduced_rwkv6_ragged_prompt_matches_reference():
    """A prompt of 61 tokens: the kernel's last chunk is ragged (the port
    pads it) and the reference's chunked form, which needs a multiple of its
    chunk, falls back to its scan.  Prefill logits and state, then decode."""
    jmodel, params, model = _pair("rwkv6-7b", "float32", seed=4, mixer_impl="chunked")
    toks = np.random.default_rng(9).integers(0, 256, (2, 66)).astype(np.int32)
    jl, jc = jmodel.prefill(params, {"tokens": jnp.asarray(toks[:, :61])}, cache_len=CACHE_LEN)
    tl, tc = model.prefill({"tokens": torch.from_numpy(toks[:, :61])}, CACHE_LEN)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=1e-4)
    _assert_caches_close(tc, jc, dict(atol=1e-4, rtol=1e-4))
    jl, tl = _continuation(jmodel, params, model, toks, prompt=61, cache_len=CACHE_LEN)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)


def test_from_reference_carries_rwkv_params():
    """Every rwkv leaf of the reference's tree (``time.*`` and
    ``channel.*``, stacked over the group's layers) lands in its layer."""
    jcfg = jreduced(jget_config("rwkv6-7b"))
    params = jax.tree.map(np.asarray, jbuild_model(jcfg).init(jax.random.PRNGKey(6)))
    model = from_reference(params, reduced(get_config("rwkv6-7b")), device="cpu")
    group = dict(iter_leaves(params["groups"][0]))
    assert any(n.startswith("time.") for n in group) and any(n.startswith("channel.") for n in group)
    for name, arr in group.items():
        for i, blk in enumerate(model.lm.blocks):
            p = blk.get_parameter(name)
            want = torch.from_numpy(np.array(arr[i], np.float32))
            assert p.dtype == (torch.bfloat16 if arr.dtype.name == "bfloat16" else torch.float32)
            assert torch.equal(p.float(), want), (name, i)


def test_reduced_qwen2_with_qkv_bias_matches_reference():
    """The dense family's options: QKV bias and a non-default RoPE theta."""
    jmodel, params, model = _pair("qwen2-1.5b", "float32")
    toks = np.random.default_rng(2).integers(0, 256, (2, 20)).astype(np.int32)
    jl, tl = _continuation(jmodel, params, model, toks, prompt=12, cache_len=32)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)


def test_seeded_init_draws_the_reference_distributions():
    cfg = reduced(get_config("hymba-1.5b"))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    model.init(torch.Generator().manual_seed(0))
    lm = model.lm
    assert torch.all(lm.final_norm.scale == 1)
    blk = lm.blocks[0]
    assert torch.all(blk.ssm.dt_bias == 0) and torch.all(blk.ssm.d_skip == 1)
    assert torch.all((blk.ssm.a_log <= -0.5) & (blk.ssm.a_log > -1.5))
    std = float(blk.attn.wq.std())
    assert abs(std - 1 / np.sqrt(cfg.d_model)) < 0.2 / np.sqrt(cfg.d_model)
    again = build_model(cfg, device="cpu", dtype=torch.float32).init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(lm.parameters(), again.lm.parameters()))


@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-7b", "stablelm-12b", "whisper-medium",
                                  "mixtral-8x22b", "grok-1-314b", "llava-next-mistral-7b"])
def test_serve_cli_runs_reduced_on_the_cpu(capsys, arch):
    assert serve_cli.main(["--arch", arch, "--device", "cpu", "--reduced",
                           "--batch", "2", "--prompt-len", "40", "--max-new", "4",
                           "--cache-len", "64"]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "device=cpu" in out and "tok/s" in out


def test_cast_to_float32_keeps_every_value():
    cfg = reduced(get_config("hymba-1.5b"))
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(4))
    wide = model.cast(torch.float32)
    assert model.dtype == torch.bfloat16 and wide.dtype == torch.float32
    for (name, p), (name2, q) in zip(model.lm.named_parameters(), wide.lm.named_parameters()):
        assert name == name2 and q.dtype == torch.float32
        assert torch.equal(p.float(), q), name
    assert model.lm.blocks[0].ssm.a_log.dtype == torch.float32     # declared float32
