"""The port's cost model (``repro_torch/parallel/cost_analysis.py``) and the
LLM kernel wrappers on meta tensors, on the CPU.

* The toy stack, the counterpart of ``tests/test_substrates.py``'s
  ``test_hlo_cost_model_counts_loops``: an L-layer D x D linear stack on an
  (8, D) input counts ``dot_flops == 2·8·D·D·L`` exactly (the reference's
  ``analyze_hlo`` of the same stack too), and its traffic, memory and op
  histogram equal their hand counts.
* Casts, overwrites, frees and collectives are counted by the module's
  rules; on a 2x2 fake process group ``ShardedTrainStep``'s counted
  all-gather bytes equal the sum of its leaves' gathers and its all-reduce
  traffic twice the float32 gradient bytes (and the loss).
* On meta, every registry arch's forward (reduced width at the kernel's
  head dim) counts one ``flash_attention`` op per ``attention_calls(cfg)``
  and one scan or wkv6 op per mixer layer, and a train step twice that (the
  recompute); no plain version runs and nothing is launched.
* A wrapper on meta runs the card's checks: it raises on what the kernel
  refuses, with the card's message; ``kernel_device("cuda")`` still raises
  without a card; the OLTP wrappers refuse meta.
* Each kernel op's flop formula equals a count of its work.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from repro.parallel.hlo_analysis import analyze_hlo
from repro_torch.configs.base import ShapeConfig, reduced
from repro_torch.configs.registry import ARCH_NAMES, get_config, make_inputs
from repro_torch.kernels import batch_occ, cuda, flash_attention, rwkv6, ssm_scan
from repro_torch.kernels.ops import kernel_device
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models.api import attention_calls, build_model
from repro_torch.models.weights import to_reference
from repro_torch.optim import adamw
from repro_torch.parallel import cost_analysis
from repro_torch.parallel.cost_analysis import analyze, op_histogram
from repro_torch.parallel.sharding import batch_shardings, distribute_tree, shard_train_step
from repro_torch.train.step import make_train_step
from repro_torch.tree import keystr_items, tree_leaves, tree_map


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# --- the toy stack -----------------------------------------------------------------------

@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("L", [1, 4])
def test_toy_stack_counts_exactly(device, L):
    D = 64
    ws = [torch.zeros(D, D, device=device) for _ in range(L)]
    x = torch.zeros(8, D, device=device)

    def stack(ws, x):
        for w in ws:
            x = x @ w
        return x

    c = analyze(stack, ws, x)
    assert c.dot_flops == 2 * 8 * D * D * L
    # each product reads x and w and writes its (8, D) result, float32
    assert c.traffic_bytes == L * 4 * (8 * D + D * D + 8 * D)
    assert c.convert_traffic == 0 and c.collective_traffic == 0 and c.collectives == {}
    assert c.ops == {"aten::mm": L} and op_histogram(stack, ws, x) == {"aten::mm": L}
    # the arguments, then at most two (8, D) activations live at once
    assert c.argument_bytes == 4 * (L * D * D + 8 * D)
    assert c.peak_bytes == c.argument_bytes + 4 * 8 * D * min(L, 2)
    assert c.output_bytes == 4 * 8 * D
    assert tuple(c.result.shape) == (8, D) and c.result.device.type == device


def test_toy_stack_flops_equal_the_references_hlo_count():
    D, L = 64, 4

    def unroll_model(ws, x):
        for i in range(L):
            x = x @ ws[i]
        return x.sum()

    hlo = jax.jit(unroll_model).lower(jnp.zeros((L, D, D)), jnp.zeros((8, D))).compile().as_text()
    got = analyze(lambda ws, x: [x := x @ w for w in ws], [_meta(D, D) for _ in range(L)],
                  _meta(8, D))
    assert got.dot_flops == analyze_hlo(hlo).dot_flops == 2 * 8 * D * D * L


# --- the counting rules ------------------------------------------------------------------

def test_casts_overwrites_and_frees():
    n = 1 << 10
    x = _meta(n, dtype=torch.bfloat16)

    def fn(x):
        y = x.float()                      # a cast: reads 2n, writes 4n
        z = torch.empty_like(y).copy_(y)   # empty is free; copy_ reads y, writes z
        del y
        z.zero_()                          # writes z only
        return z.view(2, -1)               # a view is free

    c = analyze(fn, x)
    assert c.convert_traffic == 6 * n
    assert c.traffic_bytes == 6 * n + 8 * n + 4 * n
    assert c.argument_bytes == 2 * n and c.output_bytes == 4 * n
    assert c.peak_bytes == 2 * n + 8 * n          # x, y and z
    assert c.ops["aten::view"] == 1 and c.dot_flops == 0


@pytest.mark.parametrize("where", ["argument", "operand"])
def test_cost_mode_refuses_a_tensor_on_the_card(where):
    # a fake tensor whose device is cuda stands for the card here
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        card = torch.empty(4, 4, device="cuda")
    assert card.device.type == "cuda"
    fn, arg = (lambda x: x @ x, card) if where == "argument" else (lambda x: x @ card, _meta(4, 4))
    with pytest.raises(ValueError, match="meta tensors only"):
        analyze(fn, arg)


def test_collectives_on_a_fake_group():
    with fake_world(4):
        t = _meta(256)
        c = analyze(lambda t: dist.all_reduce(t), t)
        assert c.collectives == {"all-reduce": {"count": 1.0, "bytes": 1024.0, "traffic": 2048.0}}
        assert c.collective_traffic == 2048.0
        mesh = make_smoke_mesh(device_type="cpu")
        d = DTensor.from_local(_meta(8, 3), mesh, [Shard(0), Shard(1)], run_check=False)
        c = analyze(lambda d: d.full_tensor(), d)
        assert tuple(c.result.shape) == (16, 6) and c.argument_bytes == 8 * 3 * 4
        # the model axis first, (8, 6), then the data axis, (16, 6)
        assert c.collectives["all-gather"] == {"count": 2.0, "bytes": 4.0 * (48 + 96),
                                               "traffic": 4.0 * (48 + 96)}


def _gather_bytes(t: DTensor) -> int:
    """Result bytes of ``full_tensor()``'s gathers: one a sharded mesh dim,
    the last mesh dim first, each growing the local tensor by its extent."""
    size, total = t.to_local().numel() * t.element_size(), 0
    for i in reversed(range(t.device_mesh.ndim)):
        if t.placements[i].is_shard():
            size *= t.device_mesh.size(i)
            total += size
    return total


def test_sharded_step_collectives_equal_their_closed_form():
    cfg = reduced(get_config("tinyllama-1.1b"), head_dim=64)
    opt_cfg = adamw.AdamWConfig()
    with fake_world(4):
        mesh = make_smoke_mesh(device_type="cpu")
        model = build_model(cfg, device="meta", dtype=torch.bfloat16)
        params = to_reference(model, release=True)
        step = shard_train_step(model, opt_cfg, mesh)
        sp = distribute_tree(params, step.param_shardings)
        so = distribute_tree(adamw.init(params, opt_cfg), step.opt_shardings)
        batch = make_inputs(cfg, ShapeConfig("t", 32, 4, "train"), device="meta")
        batch = distribute_tree(batch, batch_shardings(batch, mesh))
        c = analyze(step, sp, so, batch)
        leaves = tree_leaves(sp)
        gathered = sum(map(_gather_bytes, leaves))
        assert gathered > 0 and any(len([p for p in t.placements if p.is_shard()]) == 2
                                    for t in leaves)
        assert c.collectives["all-gather"]["bytes"] == gathered
        # one float32 all-reduce per gradient leaf and one for the loss, over "data"
        f32 = sum(4 * t.numel() for t in leaves) + 4
        assert c.collectives["all-reduce"] == {"count": len(leaves) + 1, "bytes": f32,
                                               "traffic": 2 * f32}
        assert c.collective_traffic == gathered + 2 * f32
        assert c.argument_bytes == sum(t.to_local().untyped_storage().nbytes()
                                       for _, t in keystr_items((sp, so, batch)))


# --- the kernels on meta -----------------------------------------------------------------

def _kernel_cfg(arch: str):
    """The reduced config at a head dim the flash kernel takes."""
    return reduced(get_config(arch), head_dim=64)


@pytest.fixture
def no_plain(monkeypatch):
    """Every kernel's plain version raises if called; launches are
    unchanged."""
    def refuse(*a, **k):
        raise AssertionError("a plain version ran on meta")

    for mod, name in ((flash_attention, "flash_attention_plain"),
                      (ssm_scan, "ssm_scan_chunked_plain"), (rwkv6, "rwkv6_chunked_plain")):
        monkeypatch.setattr(mod, name, refuse)
    before = dict(cuda.LAUNCHES)
    yield
    assert cuda.LAUNCHES == before


def _mixer_layers(cfg) -> dict:
    if cfg.ssm is not None:
        return {"ssm_scan_chunked": cfg.n_layers}
    if cfg.rwkv is not None:
        return {"rwkv6_chunked": cfg.n_layers}
    return {}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_forward_counts_one_kernel_op_per_call(arch, no_plain):
    cfg = _kernel_cfg(arch)
    model = build_model(cfg, device="meta")
    batch = make_inputs(cfg, ShapeConfig("t", 64, 2, "prefill"), device="meta")
    c = analyze(model.prefill, batch, 64)
    want = {**({"flash_attention": attention_calls(cfg)} if attention_calls(cfg) else {}),
            **_mixer_layers(cfg)}
    assert c.kernel_ops == want
    logits = c.result[0]
    assert logits.device.type == "meta" and tuple(logits.shape) == (2, 1, cfg.vocab)
    assert c.kernel_flops > 0 and c.dot_flops > c.kernel_flops


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "hymba-1.5b", "rwkv6-7b", "whisper-medium"])
def test_train_step_counts_the_forward_and_its_recompute(arch, no_plain):
    cfg = _kernel_cfg(arch)
    model = build_model(cfg, device="meta")
    params = to_reference(model, release=True)
    opt_cfg = adamw.AdamWConfig()
    batch = make_inputs(cfg, ShapeConfig("t", 64, 2, "train"), device="meta")
    c = analyze(make_train_step(model, opt_cfg), params, adamw.init(params, opt_cfg), batch)
    want = {**({"flash_attention": attention_calls(cfg)} if attention_calls(cfg) else {}),
            **_mixer_layers(cfg)}
    # the backward kernel's op once per causal self-attention call (every
    # attention layer, an encoder-decoder's decoder layers)
    bwd = {"flash_attention_bwd": cfg.n_layers} if attention_calls(cfg) else {}
    assert c.kernel_ops == {**{k: 2 * n for k, n in want.items()}, **bwd}
    new_params = c.result[0]
    assert all(t.device.type == "meta" for t in tree_leaves(new_params))
    assert tree_map(lambda t: tuple(t.shape), new_params) == tree_map(lambda t: tuple(t.shape),
                                                                      params)


def test_kernel_ops_count_their_formulas():
    q = _meta(2, 4, 100, 64, dtype=torch.bfloat16)
    k = _meta(2, 2, 100, 64, dtype=torch.bfloat16)
    c = analyze(lambda: flash_attention.flash_attention_fwd(q, k, k, window=16, return_lse=True))
    flops, nbytes = flash_attention.op_cost(q, k, k, True, 16, 0.0, True)
    assert c.kernel_ops == {"flash_attention": 1}
    assert c.dot_flops == c.kernel_flops == flops == 4 * 64 * 2 * 4 * sum(
        min(i + 1, 16) for i in range(100))
    assert c.traffic_bytes == nbytes == 2 * (2 * 2 * 4 * 100 * 64 + 2 * 2 * 2 * 100 * 64) \
        + 4 * 2 * 4 * 100
    out, lse = c.result
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert tuple(lse.shape) == (2, 4, 100) and out.stride() == q.stride()


def test_backward_kernel_op_counts_its_formula():
    """The backward kernel on meta: one op, 10·D flops an unmasked pair,
    q, k, v, do and lse read once and dq, dk, dv written once, each
    gradient in its input's layout."""
    q, do = (_meta(2, 100, 4, 64, dtype=torch.bfloat16).transpose(1, 2) for _ in range(2))
    k = _meta(2, 100, 2, 64, dtype=torch.bfloat16).transpose(1, 2)
    lse = _meta(2, 4, 100)
    c = analyze(lambda: flash_attention.flash_attention_bwd(q, k, k, lse, do, window=16))
    flops, nbytes = flash_attention.op_cost_bwd(q, k, k, lse, do, 16)
    assert c.kernel_ops == {"flash_attention_bwd": 1}
    assert c.dot_flops == c.kernel_flops == flops == 10 * 64 * 2 * 4 * sum(
        min(i + 1, 16) for i in range(100))
    assert c.traffic_bytes == nbytes == 2 * (3 * 2 * 4 * 100 * 64 + 4 * 2 * 2 * 100 * 64) \
        + 4 * 2 * 4 * 100
    dq, dk, dv = c.result
    assert dq.stride() == q.stride() and dk.stride() == k.stride() and dv.dtype == torch.bfloat16


@pytest.mark.parametrize("s,t,window,causal", [
    (100, 100, None, True), (100, 100, 16, True), (64, 200, None, True), (200, 64, 8, True),
    (37, 53, None, False), (37, 53, 5, False), (1, 1, None, True)])
def test_attention_pairs_count_the_unmasked_pairs(s, t, window, causal):
    q, kv = np.arange(s)[:, None], np.arange(t)[None, :]
    mask = np.ones((s, t), bool)
    if causal:
        mask &= q >= kv
    if window is not None:
        mask &= q - kv < window
    assert flash_attention.attention_pairs(s, t, window, causal) == int(mask.sum())


def test_wkv6_block_flops_at_one_chunk():
    # one chunk of c steps, K = V = 1: state term and update 2c each, A's
    # strict lower triangle 4 a pair, its diagonal 3, A v over s <= t
    c = rwkv6.CHUNK
    assert rwkv6.block_flops(1, 1, c, 1, 1) == 4 * c + 4 * c * (c - 1) // 2 + 3 * c \
        + c * (c + 1)
    assert rwkv6.block_flops(2, 3, 4 * c, 8, 16) == 2 * 3 * 4 * (
        4 * c * 8 * 16 + 2 * c * (c - 1) * 8 + 3 * c * 8 + c * (c + 1) * 16)


def test_scan_op_cost():
    x = _meta(2, 3, 100, 16)
    dt, bm = _meta(2, 3, 100), _meta(2, 100, 8)
    flops, nbytes = ssm_scan.op_cost(x, dt, dt, bm, bm)
    assert flops == 5 * 2 * 3 * 100 * 16 * 8
    assert nbytes == 4 * (2 * 2 * 3 * 100 * 16 + 2 * 2 * 3 * 100 + 2 * 2 * 100 * 8
                          + 2 * 3 * 16 * 8)


# --- the card's checks on meta ----------------------------------------------------------

def test_meta_wrappers_refuse_what_the_kernel_refuses():
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="the kernel takes head dim 64, 128 or 160, not 32"):
        flash_attention.flash_attention_fwd(_meta(1, 2, 8, 32, dtype=bf), _meta(1, 2, 8, 32, dtype=bf),
                                            _meta(1, 2, 8, 32, dtype=bf))
    with pytest.raises(TypeError, match="must share float32 or bfloat16"):
        flash_attention.flash_attention_fwd(_meta(1, 2, 8, 64, dtype=bf), _meta(1, 2, 8, 64),
                                            _meta(1, 2, 8, 64))
    # a bf16 position stride of 65 elements (130 B) breaks the TMA rule
    odd = _meta(1, 1, 8, 65, dtype=bf)[..., :64]
    with pytest.raises(ValueError, match="position stride of 65 elements"):
        flash_attention.flash_attention_fwd(odd, odd, odd)
    with pytest.raises(ValueError, match="window must be positive"):
        flash_attention.flash_attention_fwd(*[_meta(1, 2, 8, 64, dtype=bf)] * 3, window=0)
    with pytest.raises(ValueError, match=r"the kernel takes N in \[1, 32\], not 48"):
        ssm_scan.ssm_scan_chunked(_meta(1, 2, 8, 4), _meta(1, 2, 8), _meta(1, 2, 8),
                                  _meta(1, 8, 48), _meta(1, 8, 48))
    with pytest.raises(TypeError, match="dt and decay must be float32"):
        ssm_scan.ssm_scan_chunked(_meta(1, 2, 8, 4), _meta(1, 2, 8, dtype=bf), _meta(1, 2, 8),
                                  _meta(1, 8, 4), _meta(1, 8, 4))
    with pytest.raises(ValueError, match="not K=80, V=80"):
        r = _meta(1, 2, 8, 80)
        rwkv6.rwkv6_chunked(r, r, r, r, _meta(2, 80))
    with pytest.raises(ValueError, match="unsupported device"):
        batch_occ.seg_reduce(torch.zeros(4, dtype=torch.int32, device="meta"),
                             torch.zeros(4, dtype=torch.int32, device="meta"), 4)


def test_kernel_device_admits_meta_and_still_refuses_a_missing_card():
    assert kernel_device("meta") == torch.device("meta")
    assert kernel_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            kernel_device("cuda")
    with pytest.raises(ValueError, match="unsupported kernel device"):
        kernel_device("xpu")


def test_kernel_ops_are_the_wrappers_dispatcher_ops():
    assert set(name for name, _ in cost_analysis.KERNEL_COSTS.values()) == {
        "flash_attention", "flash_attention_bwd", "ssm_scan_chunked", "rwkv6_chunked"}
    assert flash_attention.OP is torch.ops.repro_torch.flash_attention.default
    assert flash_attention.OP_BWD is torch.ops.repro_torch.flash_attention_bwd.default
    assert ssm_scan.OP is torch.ops.repro_torch.ssm_scan_chunked.default
    assert rwkv6.OP is torch.ops.repro_torch.rwkv6_chunked.default
    # a Meta kernel only: on the card the wrappers launch directly
    for op in cost_analysis.KERNEL_COSTS:
        assert torch._C._dispatch_has_kernel_for_dispatch_key(op.name(), "Meta")
        assert not torch._C._dispatch_has_kernel_for_dispatch_key(op.name(), "CUDA")
