"""The port's spans and counters inside its LLM path, on the CPU.

* Off, ``TRACER.span`` allocates nothing in ``trace/span.py`` and opens no
  profiler range; on, serving and training leave tokens and parameters
  bit-identical.
* A ``generate`` call is one ``prefill`` span and one ``decode_step``
  span a step, each the parent of a ``moe_route`` and two ``moe_dispatch``
  spans per MoE layer.  A train step is ``forward``, ``backward`` (a
  microbatch each) and ``optimizer``; the scan's backward nests under the
  backward.
* The MoE's dropped-slot counter equals a count by hand of ``moe_route``'s
  ``keep`` where slots drop.
* With ``ranges=True`` under ``torch.profiler``, each row's host interval,
  taken onto the profiler's clock by the dump's offset, matches its
  ``repro_torch.<stage>`` range.
"""

import gc
import json
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.models import ffn
from repro_torch.models.api import build_model
from repro_torch.models.serve_llm import ServeEngine
from repro_torch.models.weights import to_reference
from repro_torch.obs.metrics import REGISTRY
from repro_torch.optim import adamw
from repro_torch.trace import span as tspan
from repro_torch.trace.span import (
    STAGE_NAMES,
    ST_BACKWARD,
    ST_DECODE_STEP,
    ST_FORWARD,
    ST_MOE_DISPATCH,
    ST_MOE_ROUTE,
    ST_OPTIMIZER,
    ST_PREFILL,
    ST_SCAN_BWD,
    TRACER,
    TraceDump,
)
from repro_torch.train.step import make_train_step


@pytest.fixture(autouse=True)
def _disarm():
    yield
    TRACER.enabled = TRACER.ranges = False
    TRACER.reset()
    REGISTRY.reset()


def _model(arch, **kw):
    cfg = reduced(get_config(arch), **kw)
    return build_model(cfg, device="cpu", dtype=torch.float32).init(
        torch.Generator().manual_seed(3))


def _tokens(cfg, b, s, seed=5):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)))


def _generate(model, max_new, tokens):
    return ServeEngine(model, cache_len=32).generate({"tokens": tokens}, max_new=max_new).tokens


def test_span_off_allocates_nothing_and_opens_no_range():
    model = _model("mixtral-8x22b")
    toks = _tokens(model.cfg, 2, 8)
    _generate(model, 3, toks)                  # warm every path first
    assert not TRACER.enabled
    flt = tracemalloc.Filter(True, "*repro_torch/trace/span.py")
    tracemalloc.start()
    try:
        for _ in range(64):
            with TRACER.span(ST_PREFILL, unit=1, tokens=8) as sp:
                assert sp.layer == -1
        _generate(model, 3, toks)
        snap = tracemalloc.take_snapshot().filter_traces([flt])
    finally:
        tracemalloc.stop()
    assert sum(s.size for s in snap.statistics("filename")) == 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _generate(model, 3, toks)
    assert not [e.name for e in prof.events() if e.name.startswith(tspan.RANGE_PREFIX)]
    assert TRACER.dump().n == 0


def _rows(dump, stage):
    return [i for i in range(dump.n) if dump.stage[i] == stage]


def test_generate_spans_nest_per_moe_layer():
    model = _model("mixtral-8x22b")
    layers = model.cfg.n_layers
    toks = _tokens(model.cfg, 2, 8)
    off = _generate(model, 4, toks)
    tspan.enable()
    on = _generate(model, 4, toks)
    d = tspan.disable()
    np.testing.assert_array_equal(on, off)
    prefill, steps = _rows(d, ST_PREFILL), _rows(d, ST_DECODE_STEP)
    assert len(prefill) == 1 and len(steps) == 3
    top = prefill + steps
    assert [d.parent[i] for i in top] == [-1] * 4
    assert len(set(d.batch[i] for i in top)) == 1 and d.batch[top[0]] >= 0
    assert d.n_txn[prefill[0]] == 2 * 8 and all(d.n_txn[i] == 2 for i in steps)
    for p in top:
        kids = [i for i in range(d.n) if d.parent[i] == p]
        moe = [ST_MOE_ROUTE, ST_MOE_DISPATCH, ST_MOE_DISPATCH]
        assert [d.stage[i] for i in kids] == moe * layers
        assert [d.aux[i] for i in kids] == [l for l in range(layers) for _ in range(3)]
        assert all(d.batch[i] == d.batch[p] for i in kids)
        assert all(d.t0[p] <= d.t0[i] <= d.t1[i] <= d.t1[p] for i in kids)
    assert d.n == 4 * (1 + 3 * layers)
    assert np.isnan(d.dev_t0).all() and np.isnan(d.dev_t1).all()      # off the card
    # the LLM columns survive a round trip; an OLTP-only dump keeps the reference's keys
    back = TraceDump.from_dict(json.loads(json.dumps(d.to_dict())))
    np.testing.assert_array_equal(back.parent, d.parent)
    assert back.clock_offset == d.clock_offset
    assert "parent" not in TraceDump.from_dict({k: v[:0] if isinstance(v, list) else v
                                                for k, v in d.to_dict().items()}).to_dict()
    assert set(d.structural_dict()) == set(back.structural_dict())
    routed = REGISTRY.counter_value("llm.moe.slots_routed.prefill")
    assert routed == 2 * 8 * model.cfg.moe.top_k * layers
    assert REGISTRY.counter_value("llm.moe.slots_routed.decode_step") == 3 * 2 * 2 * layers


def test_drop_counter_equals_keep_counted_by_hand():
    """The slots-drop case of ``test_moe_dispatch_matches_reference_where_slots_drop``:
    E=4, k=2, capacity factor 0.5, groups of 16 over 2 x 23 tokens."""
    d, f, e, k = 32, 48, 4, 2
    kw = dict(n_experts=e, top_k=k, capacity_factor=0.5, group_size=16)
    rng = np.random.default_rng(21)
    tp = torch.nn.Module()
    for name, shape in (("router", (d, e)), ("w_gate", (e, d, f)), ("w_up", (e, d, f)),
                        ("w_down", (e, f, d))):
        w = rng.standard_normal(shape) / np.sqrt(shape[-2])
        tp.register_parameter(name, torch.nn.Parameter(torch.tensor(w, dtype=torch.float32),
                                                       requires_grad=False))
    x = torch.tensor(rng.standard_normal((2, 23, d)), dtype=torch.float32)
    off = ffn.moe_fwd(tp, x, **kw)
    tspan.enable()
    with TRACER.span(ST_PREFILL):
        on = ffn.moe_fwd(tp, x, **kw)
    tspan.disable()
    assert torch.equal(on, off)
    xg = torch.nn.functional.pad(x.reshape(46, d), (0, 0, 0, 2)).reshape(3, 16, d)
    valid = (torch.arange(48) < 46).reshape(3, 16)
    r = ffn.moe_route(tp.router, xg, valid, n_experts=e, top_k=k, capacity_factor=0.5)
    dropped = int((~r.keep & valid[..., None]).sum())
    assert dropped > 0
    assert REGISTRY.counter_value("llm.moe.slots_dropped.prefill") == dropped
    assert REGISTRY.counter_value("llm.moe.slots_routed.prefill") == 46 * k


def _train(arch, accum_steps, trace, steps=2):
    model = _model(arch)
    params = to_reference(model, release=True)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    opt = adamw.init(params, opt_cfg)
    step = make_train_step(model, opt_cfg, accum_steps=accum_steps)
    rng = np.random.default_rng(9)
    if trace:
        tspan.enable()
    try:
        for _ in range(steps):
            rows = torch.from_numpy(rng.integers(0, model.cfg.vocab, (4, 65)))
            params, opt, m = step(params, opt, {"tokens": rows[:, :-1], "labels": rows[:, 1:]})
    finally:
        dump = tspan.disable() if trace else None
    return params, m, dump


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_spans_in_order_and_bits_unchanged(accum_steps):
    p_off, m_off, _ = _train("hymba-1.5b", accum_steps, False)
    p_on, m_on, d = _train("hymba-1.5b", accum_steps, True)
    assert float(m_on["loss"]) == float(m_off["loss"])
    for a, b in zip(torch.utils._pytree.tree_leaves(p_on), torch.utils._pytree.tree_leaves(p_off)):
        assert torch.equal(a, b)
    top = [i for i in range(d.n) if d.parent[i] == -1]
    want = [ST_FORWARD, ST_BACKWARD] * accum_steps + [ST_OPTIMIZER]
    assert [d.stage[i] for i in top] == want * 2
    units = [d.batch[i] for i in top]
    assert units[:len(want)] == [units[0]] * len(want) and units[len(want)] != units[0]
    assert all(d.n_txn[i] == 4 * 64 // accum_steps for i in top if d.stage[i] != ST_OPTIMIZER)
    # one scan backward a layer (every hymba layer has the Mamba branch)
    scans = _rows(d, ST_SCAN_BWD)
    assert len(scans) == 2 * accum_steps * 2
    assert all(d.stage[d.parent[i]] == ST_BACKWARD for i in scans)
    assert all(d.t0[i] < d.t0[j] for i, j in zip(top, top[1:]))


def test_attention_backward_span_per_layer_and_its_counters():
    """A CPU train step: one ``flash_bwd`` span per attention layer under
    each backward, ``llm.attn.bwd_calls`` equal to the layer count a
    backward, and ``llm.attn.bwd_kernel`` 0 (the CPU takes ``_flash_bwd``)."""
    _, _, d = _train("hymba-1.5b", 1, True)
    layers = _model("hymba-1.5b").cfg.n_layers
    spans = _rows(d, tspan.ST_FLASH_BWD)
    assert len(spans) == 2 * layers
    assert all(d.stage[d.parent[i]] == ST_BACKWARD for i in spans)
    assert sorted(d.aux[i] for i in spans) == sorted(list(range(layers)) * 2)
    assert all(d.n_txn[i] == 4 * 64 for i in spans)
    assert REGISTRY.counter_value("llm.attn.bwd_calls") == 2 * layers
    assert REGISTRY.counter_value("llm.attn.bwd_kernel") == 0
    assert tspan.STAGE_NAMES[tspan.ST_FLASH_BWD] == "flash_bwd"
    assert tspan.ST_FLASH_BWD in tspan.LLM_STAGES


def _aligned(model, toks):
    """Median and largest gap (us) between the rows' and the ranges' starts
    and ends on the profiler's clock, over every span of a run."""
    gc.collect()
    gc.disable()
    try:
        tspan.enable(ranges=True)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("warm"):     # the profiler's first range is slow to open
                pass
            _generate(model, 20, toks)
        d = tspan.disable()
    finally:
        gc.enable()
    ranges = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name().startswith(tspan.RANGE_PREFIX)), key=lambda e: e.start_ns())
    assert len(ranges) == d.n >= 100
    # a row's stamp plus the dump's offset is the profiler's clock: epoch ns
    t0, t1 = (d.t0 + d.clock_offset) * 1e9, (d.t1 + d.clock_offset) * 1e9
    gaps = []
    for e, i in zip(ranges, np.argsort(t0, kind="stable")):
        assert e.name() == tspan.RANGE_PREFIX + STAGE_NAMES[d.stage[i]]
        gaps.append((abs(t0[i] - e.start_ns()) / 1e3, abs(t1[i] - e.end_ns()) / 1e3))
    g = np.array(gaps)
    return np.median(g, axis=0), g.max(axis=0)


def test_rows_map_onto_the_profilers_ranges():
    """Median gap at each end under 50 us, every gap under 0.5 ms.  A busy
    host can preempt the process between a range's stamp and the row's:
    the run is made up to three times, and one must hold throughout."""
    model = _model("mixtral-8x22b")
    toks = _tokens(model.cfg, 2, 8)
    _generate(model, 2, toks)
    seen = []
    for _ in range(3):
        med, most = _aligned(model, toks)
        seen.append((med.tolist(), most.tolist()))
        if (med < 50).all() and (most < 500).all():
            return
    pytest.fail(f"gaps (median, largest) us at (start, end): {seen}")
