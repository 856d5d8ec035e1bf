"""One rank of the port's multi-process parallel-layer runs (CPU, gloo).

Started by ``tests/test_torch_parallel.py`` once per rank:

    python tests/_torch_parallel_worker.py RANK WORLD STORE_FILE OUT_DIR

The ranks meet through a ``FileStore`` at STORE_FILE (no TCP port).  On a
2x2 ("data", "model") mesh each runs the sharded train step against the
unsharded one and ``constrain`` on a DTensor; on a 4-rank ("data",) mesh
``compressed_psum``; on a 4-stage ("pod",) mesh ``gpipe_apply``.  It writes
``OUT_DIR/rank{RANK}.json`` and ``OUT_DIR/rank{RANK}.npz``.  It imports
neither JAX nor the reference package: the test compares with those.
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ShapeConfig, reduced
from repro_torch.configs.registry import get_config, make_inputs
from repro_torch.launch.mesh import make_mesh, make_smoke_mesh
from repro_torch.models.api import build_model
from repro_torch.models.weights import to_reference
from repro_torch.optim import adamw
from repro_torch.parallel import pipeline
from repro_torch.parallel.axes import constrain, logical_context
from repro_torch.parallel.compression import compressed_psum
from repro_torch.parallel.sharding import distribute_tree, shard_train_step, to_placements
from repro_torch.train.step import make_train_step
from repro_torch.tree import keystr_items, tree_leaves

torch.set_num_threads(1)   # four ranks share the cores

STEP_ARCHS = ("tinyllama-1.1b", "llava-next-mistral-7b")
STEPS = 2
OPT = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
PIPE = dict(S=4, M=6, MB=3, D=8)


def _bytes_at_rest(tree) -> int:
    """Bytes of storage the rank's local tensors hold."""
    return sum(t.to_local().untyped_storage().nbytes() for t in tree_leaves(tree))


def _leaf_errors(got, want) -> dict:
    """Per leaf: max |got - want| over the leaf's max |want|."""
    out = {}
    for (k, g), (_, w) in zip(keystr_items(got), keystr_items(want)):
        g = g.full_tensor() if isinstance(g, DTensor) else g
        scale = max(float(w.float().abs().max()), 1e-30)
        out[k] = float((g.float() - w.float()).abs().max()) / scale
    return out


def sharded_step_case(mesh, arch: str, compress: bool) -> dict:
    cfg = reduced(get_config(arch), n_layers=2, d_model=64, vocab=256)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    model.init(torch.Generator().manual_seed(0))
    params0 = to_reference(model)
    batches = [make_inputs(cfg, ShapeConfig("t", 32, 4, "train"), seed=i, device="cpu")
               for i in range(STEPS)]

    step = make_train_step(model, OPT, compress_grads=compress)
    params, opt = params0, adamw.init(params0, OPT)
    plain = []
    for b in batches:
        params, opt, m = step(params, opt, b)
        plain.append(m)
    want = {"params": params, "opt": opt}

    sstep = shard_train_step(model, OPT, mesh, compress_grads=compress)
    sparams = distribute_tree(params0, sstep.param_shardings)
    sopt = distribute_tree(adamw.init(params0, OPT), sstep.opt_shardings)
    at_rest = _bytes_at_rest({"params": sparams, "opt": sopt})
    sharded = []
    for b in batches:
        sparams, sopt, m = sstep(sparams, sopt, b)
        sharded.append(m)
    got = {"params": sparams, "opt": sopt}
    return {
        "arch": arch, "compress": compress,
        "loss": [float(m["loss"]) for m in sharded],
        "loss_plain": [float(m["loss"]) for m in plain],
        "bits": [{k: float(v).hex() for k, v in m.items()} for m in sharded],
        "grad_norm": [float(m["grad_norm"]) for m in sharded],
        "grad_norm_plain": [float(m["grad_norm"]) for m in plain],
        "leaf_err": _leaf_errors(got, want),
        "bytes_at_rest": at_rest,
        "bytes_at_rest_after": _bytes_at_rest(got),
        "all_dtensor": all(isinstance(t, DTensor) for t in tree_leaves(got)),
    }


def constrain_case(mesh) -> dict:
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    d = DTensor.from_local(x, mesh, to_placements((), mesh), run_check=False)
    outside = constrain(d, ("batch", "vocab"))
    with logical_context(mesh, "train"):
        inside = constrain(d, ("batch", "vocab"))
        plain = constrain(x, ("batch", "vocab"))
    return {"outside_same": outside is d, "plain_same": plain is x,
            "placements": [repr(p) for p in inside.placements],
            "local": inside.to_local().tolist(),
            "values_equal": bool(torch.equal(inside.full_tensor(), x))}


def main(rank: int, world: int, store: str, out_dir: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        mesh = make_smoke_mesh(device_type="cpu")
        res = {"coordinate": list(mesh.get_coordinate()),
               "steps": [sharded_step_case(mesh, a, c) for a in STEP_ARCHS for c in (False, True)],
               "constrain": constrain_case(mesh)}

        data = make_mesh((world,), ("data",), device_type="cpu")
        x = np.random.default_rng(0).normal(0, 1, (world, 512)).astype(np.float32)
        psum = compressed_psum(torch.from_numpy(x[rank]), data, "data").numpy()

        pod = make_mesh((world,), ("pod",), device_type="cpu")
        S, M, MB, D = PIPE["S"], PIPE["M"], PIPE["MB"], PIPE["D"]
        rng = np.random.default_rng(0)
        w = rng.normal(0, 0.5, (S, D, D)).astype(np.float32)
        xs = rng.normal(0, 1, (M, MB, D)).astype(np.float32)
        stage_fn = lambda p, v: torch.tanh(v @ p["w"])
        params = {"w": torch.from_numpy(w)}
        pipeline.reset_hops()
        piped = pipeline.gpipe_apply(stage_fn, params, torch.from_numpy(xs), pod)
        res["hops"] = {f"{a}-{b}": n for (a, b), n in pipeline.HOPS.items()}
        seq = pipeline.sequential_reference(stage_fn, params, torch.from_numpy(xs))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), psum=psum, piped=piped.numpy(),
                 seq=seq.numpy())
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
