"""Tiny versions of the benchmark's cells, for the CPU tests: the cell's
own harness, driver, reference and sample of calls at a few hundred
weights."""

from __future__ import annotations

import copy

from bench import run

TINY_CFG = {
    "hymba-1.5b": dict(n_layers=8, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16, d_ff=256,
                       vocab=4096, sliding_window=32, full_attn_layers=[0, 4, 7],
                       ssm={"state_dim": 4, "n_heads": 4, "head_dim": 16, "dt_rank": 0,
                            "conv_width": 4}),
    "mixtral-8x22b": dict(n_layers=8, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16, d_ff=256,
                          vocab=32768, moe={"n_experts": 4, "top_k": 2, "capacity_factor": 1.25,
                                          "group_size": 16}),
}
TINY_TRAFFIC = {
    "hymba-1.5b.train": dict(batch=2, seq=64, pool=8),
    "mixtral-8x22b.prefill": dict(batch=2, prompt=16, cache_len=17, pool=4),
    "mixtral-8x22b.decode": dict(batch=4, prompt=8, max_new=6, cache_len=16, pool=4),
}


def tiny_ctx(workload: str, seed: int):
    ctx = run.make_ctx(workload, seed)
    cfg = copy.deepcopy(ctx.cfg)
    cfg.update(copy.deepcopy(TINY_CFG[ctx.workload["config"]]))
    ctx.cfg, ctx.arch, ctx.plist = cfg, run.arch_config(cfg), ctx.ref.param_list(cfg)
    ctx.traffic = {**ctx.traffic, **TINY_TRAFFIC[workload]}
    return ctx
