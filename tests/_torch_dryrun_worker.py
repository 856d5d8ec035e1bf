"""One rank of the sharded steps' multi-process runs (CPU, gloo), for
``tests/test_torch_dryrun.py``:

    python tests/_torch_dryrun_worker.py RANK WORLD STORE_FILE OUT_DIR

The ranks meet through a ``FileStore`` at STORE_FILE.  On a 2x2 ("data",
"model") mesh each runs ``shard_train_step(accum_steps=2)`` against
``make_train_step(accum_steps=2)`` (reduced tinyllama, two steps), and the
gather-on-use ``ShardedPrefill`` and ``ShardedDecode`` against the
unsharded model's prefill and decode step on the same inputs (reduced
tinyllama, hymba, rwkv6 and whisper).  It writes ``OUT_DIR/rank{RANK}.json``.
It imports neither JAX nor the reference package.
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ShapeConfig, reduced
from repro_torch.configs.registry import get_config, make_inputs
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models.api import build_model
from repro_torch.models.weights import to_reference
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import (ShardedDecode, ShardedPrefill, batch_shardings,
                                           distribute_tree, local_shard, shard_train_step)
from repro_torch.train.step import make_train_step
from repro_torch.tree import keystr_items, tree_map

torch.set_num_threads(1)   # four ranks share the cores

OPT = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
ACCUM = 2
STEPS = 2
SERVE_ARCHS = ("tinyllama-1.1b", "hymba-1.5b", "rwkv6-7b", "whisper-medium")
PROMPT, CACHE_LEN = 16, 24


def _err(got, want) -> float:
    """max |got - want| over max |want| (1 where want is all zero)."""
    g = got.full_tensor() if isinstance(got, DTensor) else got
    scale = max(float(want.float().abs().max()), 1e-30)
    return float((g.float() - want.float()).abs().max()) / scale


def _leaf_errors(got, want) -> dict:
    return {k: _err(g, w) for (k, g), (_, w) in zip(keystr_items(got), keystr_items(want))}


def accum_case(mesh) -> dict:
    cfg = reduced(get_config("tinyllama-1.1b"), n_layers=2, d_model=64, vocab=256)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    model.init(torch.Generator().manual_seed(0))
    params0 = to_reference(model)
    batches = [make_inputs(cfg, ShapeConfig("t", 32, 8, "train"), seed=i, device="cpu")
               for i in range(STEPS)]
    step = make_train_step(model, OPT, accum_steps=ACCUM)
    params, opt = params0, adamw.init(params0, OPT)
    plain = []
    for b in batches:
        params, opt, m = step(params, opt, b)
        plain.append(m)
    sstep = shard_train_step(model, OPT, mesh, accum_steps=ACCUM)
    sparams = distribute_tree(params0, sstep.param_shardings)
    sopt = distribute_tree(adamw.init(params0, OPT), sstep.opt_shardings)
    sharded = []
    for b in batches:
        sparams, sopt, m = sstep(sparams, sopt, b)
        sharded.append(m)
    return {
        "loss": [float(m["loss"]) for m in sharded],
        "loss_plain": [float(m["loss"]) for m in plain],
        "grad_norm": [float(m["grad_norm"]) for m in sharded],
        "grad_norm_plain": [float(m["grad_norm"]) for m in plain],
        "leaf_err": _leaf_errors({"params": sparams, "opt": sopt}, {"params": params, "opt": opt}),
    }


def serve_case(mesh, arch: str) -> dict:
    cfg = reduced(get_config(arch), vocab=256)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    model.init(torch.Generator().manual_seed(1))
    batch = make_inputs(cfg, ShapeConfig("t", PROMPT, 4, "prefill"), seed=2, device="cpu")
    batch = {k: v.float() if v.is_floating_point() else v for k, v in batch.items()}
    tokens = make_inputs(cfg, ShapeConfig("t", 1, 4, "decode"), seed=3, device="cpu")["tokens"]
    pos = PROMPT + (cfg.vlm.n_patches if cfg.vlm is not None else 0)
    logits, caches = model.prefill(batch, CACHE_LEN)
    dlogits, caches = model.decode_step(caches, tokens, pos)

    params = to_reference(model)
    prefill = ShardedPrefill(model, mesh, CACHE_LEN)
    decode = ShardedDecode(model, mesh, CACHE_LEN)
    sparams = distribute_tree(params, prefill.param_shardings)
    slogits, scaches = prefill(sparams, batch)
    rows = local_shard(logits, batch_shardings({"x": logits}, mesh, "serve")["x"])
    cache_sh = prefill.cache_shardings(4)
    wrap = lambda t, s: DTensor.from_local(t, mesh, s.placements, run_check=False)
    dslogits, dscaches = decode(sparams, tree_map(wrap, scaches, cache_sh), tokens, pos)
    drows = local_shard(dlogits, batch_shardings({"x": dlogits}, mesh, "serve")["x"])
    want = tree_map(local_shard, caches, cache_sh)
    return {
        "arch": arch,
        "prefill_logits_err": _err(slogits, rows),
        "decode_logits_err": _err(dslogits, drows),
        "cache_err": max(_leaf_errors(dscaches, want).values()),
        "cache_shapes_match": all(tuple(g.shape) == tuple(w.shape) for (_, g), (_, w)
                                  in zip(keystr_items(dscaches), keystr_items(want))),
        "some_cache_split": any(g.numel() < w.numel() for (_, g), (_, w)
                                in zip(keystr_items(dscaches), keystr_items(caches))),
    }


def main(rank: int, world: int, store: str, out_dir: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        mesh = make_smoke_mesh(device_type="cpu")
        res = {"accum": accum_case(mesh), "serve": [serve_case(mesh, a) for a in SERVE_ARCHS]}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
