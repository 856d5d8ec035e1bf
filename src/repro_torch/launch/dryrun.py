"""Multi-pod dry run: every (arch x shape x mesh) cell's per-device program,
traced on meta tensors over a fake process group.

The counterpart of ``repro/launch/dryrun.py``.  For each cell this builds
the port's real step (the sharded train step, prefill or serve decode step
of ``parallel/sharding.py``) at full width and depth with the production
shardings, holds rank 0's state at rest (parameters, AdamW moments, the
batch shard and caches as DTensors of meta tensors), runs the step once
under the cost mode (``parallel/cost_analysis.py``) and reports:

  * memory            — per-device argument, output and temporary bytes
                        and their peak (the fit proof)
  * flops and bytes   — per device: matrix products and the hand-written
                        kernels' own flops, every op's device-memory traffic
  * collective traffic — per device, per kind, from the dispatched
                        ``c10d`` ops
  * roofline terms     — seconds on H100 constants (below)

The numbers describe the port's program on the card: its hand-written
kernels (one op each, with their flop and byte formulas), the torch-op
backwards and the gathers the card runs.  No card is needed: a mesh kind
runs on a fake process group of its world size (256 ranks for ``single``,
512 for ``multi``), one process, rank 0; every placement divides evenly, so
all ranks are alike.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both --out build/dryrun

Results are written as one JSON per cell into ``--out`` (default
``build/dryrun``).  Keys follow the reference's where the meaning is the
same.  ``trace_s`` (the traced step) replaces ``lower_s`` and
``compile_s``.  Dropped: ``alias_bytes`` (eager torch donates nothing: the
old state stays live until the caller drops it, and the peak shows that),
``memory_tpu_s`` and ``step_s_lower_bound_raw`` (there is no CPU-backend
convert churn to correct for), ``xla_cost_analysis`` and ``hlo_bytes``
(there is no compiler and no HLO).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

# H100 SXM constants (per card): NVIDIA's data sheet figures, not measurements
PEAK_FLOPS = 989e12          # bf16 dense FLOP/s (PERF.md §6's bound uses the same)
HBM_BW = 3.35e12             # HBM3 bytes/s (PERF.md §6)
LINK_BW = 50e9               # bytes/s: one 400 Gb/s NDR InfiniBand NIC per card; both
                             # production meshes span more than one 8-card NVLink node
NVLINK_BW = 450e9            # NVLink 4 bytes/s each way within a node: reported, not bounded by

MESH_RANKS = {"single": 256, "multi": 512}


@contextlib.contextmanager
def fake_world(world_size: int):
    """The default process group as rank 0 of a fake group of
    ``world_size`` ranks (its collectives move nothing), torn down on
    exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def build_cell(arch: str, shape_name: str, policy: str, *,
               remat: str = "none",
               accum_steps: int = 1,
               moe_group: Optional[int] = None):
    """Returns ``(make, meta, cfg, shape)``, where ``make(mesh)`` gives
    ``(step_fn, args)``: the cell's step and rank 0's state at rest on
    meta.  For a cell ``cell_applicable`` refuses, ``make`` is None and
    ``meta`` the reason."""
    from ..configs.base import SHAPES
    from ..configs.registry import cell_applicable, get_config, input_specs
    from ..models.api import build_model
    from ..models.weights import to_reference
    from ..optim import adamw
    from ..parallel import sharding as shd

    cfg = get_config(arch)
    if moe_group and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, group_size=moe_group))
    shape = SHAPES[shape_name]
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return None, why, cfg, shape

    def state(mesh):
        """The model (holding no weights) and the parameters at rest."""
        model = build_model(cfg, device="meta", remat_policy=remat)
        params = to_reference(model, release=True)
        sh = shd.tree_shardings(model.param_specs(), mesh, policy)
        return model, shd.distribute_tree(params, sh)

    def batch_at_rest(mesh):
        specs = input_specs(cfg, shape)
        whole = {k: _meta(s.shape, s.dtype) for k, s in specs.items()}
        return shd.distribute_tree(whole, shd.batch_shardings(whole, mesh, policy))

    if shape.phase == "train":
        opt_cfg = adamw.AdamWConfig(moment_dtype=torch.bfloat16
                                    if cfg.opt_moment_dtype == "bfloat16" else torch.float32)

        def make(mesh):
            model, params = state(mesh)
            step = shd.shard_train_step(model, opt_cfg, mesh, policy, accum_steps=accum_steps)
            specs = adamw.opt_state_specs(model.param_specs(), opt_cfg)
            opt = shd.distribute_tree(
                {"mu": _meta_tree(specs["mu"]), "nu": _meta_tree(specs["nu"]),
                 "count": _meta((), torch.int32)}, step.opt_shardings)
            return step, (params, opt, batch_at_rest(mesh))

        meta = {"phase": "train", "fn": "train_step"}

    elif shape.phase == "prefill":
        def make(mesh):
            model, params = state(mesh)
            step = shd.ShardedPrefill(model, mesh, shape.seq_len, policy)
            return step, (params, batch_at_rest(mesh))

        meta = {"phase": "prefill", "fn": "prefill"}

    else:  # decode: one new token against a cache of shape.seq_len
        pos = shape.seq_len - 1      # the position make_inputs gives the batch's "pos"

        def make(mesh):
            model, params = state(mesh)
            step = shd.ShardedDecode(model, mesh, shape.seq_len, policy)
            caches = shd.distribute_tree(_meta_tree(step.cache_specs(shape.global_batch)),
                                         step.cache_shardings(shape.global_batch))

            def serve_step(params, caches, batch):
                return step(params, caches, batch["tokens"], pos)

            return serve_step, (params, caches, batch_at_rest(mesh))

        meta = {"phase": "decode", "fn": "serve_step"}

    return make, meta, cfg, shape


def _meta_tree(spec_tree):
    """A meta tensor for every ParamSpec leaf."""
    from ..tree import tree_map

    return tree_map(lambda s: _meta(s.shape, s.dtype), spec_tree)


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6·N_active·D train, 2·N_active·D inference."""
    n = cfg.n_active_params()
    mult = 6.0 if shape.phase == "train" else 2.0
    toks = shape.tokens if shape.phase != "decode" else shape.global_batch
    return mult * n * toks


def roofline(flops: float, nbytes: float, collective_bytes: float) -> Dict[str, Any]:
    """Seconds of one device's step at the H100 constants: compute, memory
    and collectives, the bottleneck and their max, the step's lower
    bound."""
    terms = {"compute": flops / PEAK_FLOPS, "memory": nbytes / HBM_BW,
             "collective": collective_bytes / LINK_BW}
    return {"compute_s": terms["compute"], "memory_s": terms["memory"],
            "collective_s": terms["collective"],
            "bottleneck": max(terms.items(), key=lambda kv: kv[1])[0],
            "step_s_lower_bound": max(terms.values())}


def run_cell(arch: str, shape_name: str, mesh_kind: str, policy: str,
             out_dir: str, tag: str = "baseline", **kw) -> Dict[str, Any]:
    from ..parallel import cost_analysis
    from .mesh import make_production_mesh

    t0 = time.time()
    made = build_cell(arch, shape_name, policy, **kw)
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "policy": policy, "tag": tag, **{k: v for k, v in kw.items() if v},
    }
    if made[0] is None:
        result["status"] = "skipped"
        result["reason"] = made[1]
        _write(out_dir, result, tag)
        return result

    make, meta, cfg, shape = made
    result.update(meta)
    n_chips = MESH_RANKS[mesh_kind]
    try:
        with fake_world(n_chips):
            mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device_type="cpu")
            step, args = make(mesh)
            t1 = time.time()
            cost = cost_analysis.analyze(step, *args)
            t2 = time.time()
            cost.result = None
            del step, args

        flops_dev = float(cost.dot_flops)
        bytes_dev = float(cost.traffic_bytes)
        coll_traffic = float(cost.collective_traffic)
        mf = model_flops(cfg, shape)
        result.update({
            "status": "ok",
            "n_chips": n_chips,
            "trace_s": round(t2 - t1, 2),
            "memory": {
                "argument_bytes": cost.argument_bytes,
                "output_bytes": cost.output_bytes,
                "temp_bytes": cost.peak_bytes - cost.argument_bytes,
                "peak_gb": round(cost.peak_bytes / 1e9, 3),
            },
            "flops_per_device": flops_dev,
            "bytes_per_device": bytes_dev,
            "kernel_ops": cost.kernel_ops,
            "kernel_flops_per_device": cost.kernel_flops,
            "collectives": cost.collectives,
            "collective_traffic_per_device": coll_traffic,
            "model_flops_global": mf,
            "model_flops_per_device": mf / n_chips,
            "useful_flop_ratio": round(mf / n_chips / flops_dev, 4) if flops_dev else None,
            "convert_traffic_per_device": cost.convert_traffic,
            "roofline": roofline(flops_dev, bytes_dev, coll_traffic),
            "constants": {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "link_bw": LINK_BW,
                          "nvlink_bw": NVLINK_BW, "source": "H100 SXM data sheet"},
        })
    except Exception as e:  # noqa: BLE001 - report the cell failure verbatim
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
    result["total_s"] = round(time.time() - t0, 2)
    _write(out_dir, result, tag)
    return result


def _write(out_dir: str, result: Dict[str, Any], tag: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    name = f"{result['arch']}__{result['shape']}__{result['mesh']}__{tag}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(result, f, indent=1, default=str)


# the reference's variants of each kind, which compute the port's one function
_ONE_PATH = {
    "--attn-impl": ("flash", "the port's attention is its flash kernel (models/attention.py); "
                    "the reference's masked_scan and triangular variants compute the same "
                    "function and are no separate paths here"),
    "--mixer-impl": ("chunked", "the port's scan and wkv6 mixers are their chunked kernels; "
                     "the reference's per-step scan computes the same function and is no "
                     "separate path here"),
}


def main(argv=None) -> int:
    from ..configs.base import SHAPES
    from ..configs.registry import ARCH_NAMES

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--policy", default=None, help="sharding policy (default: train/serve by phase)")
    ap.add_argument("--all", action="store_true", help="sweep all arch x shape cells")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--attn-impl", default=None, help="only 'flash', the port's one attention")
    ap.add_argument("--mixer-impl", default=None, help="only 'chunked', the port's one mixer")
    ap.add_argument("--remat", default="none", choices=["none", "dots", "full"])
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--moe-group", type=int, default=None)
    args = ap.parse_args(argv)
    for flag, value in (("--attn-impl", args.attn_impl), ("--mixer-impl", args.mixer_impl)):
        one, why = _ONE_PATH[flag]
        if value not in (None, one):
            ap.error(f"{flag} {value}: {why}")

    archs = list(ARCH_NAMES) if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = 0
    for arch in archs:
        for shape_name in shapes:
            phase = SHAPES[shape_name].phase
            policy = args.policy or ("train" if phase == "train" else "serve")
            for mesh_kind in meshes:
                r = run_cell(
                    arch, shape_name, mesh_kind, policy, args.out, tag=args.tag,
                    remat=args.remat, accum_steps=args.accum_steps, moe_group=args.moe_group,
                )
                line = {
                    "ok": lambda: (
                        f"OK   {arch:24s} {shape_name:12s} {mesh_kind:6s} "
                        f"trace={r['trace_s']:7.1f}s peak={r['memory']['peak_gb']:7.2f}GB "
                        f"bottleneck={r['roofline']['bottleneck']:10s} "
                        f"step>={r['roofline']['step_s_lower_bound']:.4f}s"
                    ),
                    "skipped": lambda: f"SKIP {arch:24s} {shape_name:12s} {mesh_kind:6s} {r['reason'][:60]}",
                    "error": lambda: f"FAIL {arch:24s} {shape_name:12s} {mesh_kind:6s} {r['error'][:120]}",
                }[r["status"]]()
                print(line, flush=True)
                if r["status"] == "error":
                    failures += 1
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
