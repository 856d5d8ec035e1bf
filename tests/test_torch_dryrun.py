"""The port's dry run (``repro_torch/launch/dryrun.py``) and its sharded
steps against the reference's, on the CPU.

* Bytes at rest: for every cell the reference's ``cell_applicable`` admits,
  on both production meshes (16x16 and 2x16x16, fake process groups of 256
  and 512 ranks), rank 0's parameters, AdamW moments, batch shard and
  caches at rest in ``build_cell``'s state equal the sums of the JAX side's
  ``NamedSharding(mesh, resolve_pspec(...)).shard_shape`` bytes, computed in
  a subprocess with 512 forced host devices (nothing is compiled there).
* ``model_flops`` and ``cell_applicable`` equal the reference's in every
  cell.
* Every admitted cell runs to ``status == "ok"`` on the single-pod mesh at
  full width, cut in depth to two layers (the first two, with their
  full-attention layers, as ``chip_smoke.py``'s ``_cut``); the others are
  ``skipped`` with the reference's reason.  The CLI runs one full-depth cell
  and refuses the reference's other attention and mixer variants.
* Four gloo processes (``tests/_torch_dryrun_worker.py``): the sharded
  train step with ``accum_steps=2`` against ``make_train_step(accum_steps=
  2)``, and ``ShardedPrefill`` / ``ShardedDecode`` against the unsharded
  prefill and decode step, on a 2x2 mesh.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time

import pytest
import torch.distributed as dist

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.registry import cell_applicable as jcell_applicable
from repro.configs.registry import get_config as jget_config
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCH_NAMES, cell_applicable, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.tree import keystr_items

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_dryrun_worker.py")
WORLD = 4
SPAWN_TIMEOUT_S = 180     # each spawn's own limit; a normal run takes seconds
CUT_LAYERS = 2

CELLS = [(a, s) for a in ARCH_NAMES for s in SHAPES]
ADMITTED = [(a, s) for a, s in CELLS if jcell_applicable(jget_config(a), JSHAPES[s])[0]]

JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import sys, json, math
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding
    from repro.configs.base import SHAPES
    from repro.configs.registry import ARCH_NAMES, cell_applicable, get_config, input_specs
    from repro.launch.dryrun import model_flops
    from repro.launch.mesh import make_production_mesh
    from repro.models.api import build_model
    from repro.models.common import ParamSpec
    from repro.optim import adamw
    from repro.parallel.sharding import POLICIES, batch_shardings, resolve_pspec

    def spec_bytes(tree, mesh, policy):
        leaves = jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, ParamSpec))
        return sum(math.prod(NamedSharding(mesh, resolve_pspec(s.shape, s.logical, mesh,
                                                               POLICIES[policy]))
                             .shard_shape(s.shape)) * jnp.dtype(s.dtype).itemsize
                   for s in leaves)

    out = {}
    meshes = {"single": make_production_mesh(), "multi": make_production_mesh(multi_pod=True)}
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        model = build_model(cfg)
        pspecs = model.param_specs()
        for name, shape in SHAPES.items():
            ok, why = cell_applicable(cfg, shape)
            cell = {"applicable": [ok, why], "model_flops": model_flops(cfg, shape)}
            policy = "train" if shape.phase == "train" else "serve"
            for kind, mesh in meshes.items():
                if not ok:
                    continue
                sds = input_specs(cfg, shape)
                bsh = batch_shardings(sds, mesh, policy)
                parts = {"params": spec_bytes(pspecs, mesh, policy),
                         "batch": sum(math.prod(bsh[k].shard_shape(s.shape))
                                      * jnp.dtype(s.dtype).itemsize for k, s in sds.items())}
                if shape.phase == "train":
                    ocfg = adamw.AdamWConfig(moment_dtype=jnp.bfloat16
                                             if cfg.opt_moment_dtype == "bfloat16" else jnp.float32)
                    parts["opt"] = spec_bytes(adamw.opt_state_specs(pspecs, ocfg), mesh, policy)
                if shape.phase == "decode":
                    parts["caches"] = spec_bytes(
                        model.cache_specs(shape.global_batch, shape.seq_len), mesh, policy)
                cell[kind] = parts
            out[f"{arch}|{name}"] = cell
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    script = tmp_path_factory.mktemp("jax_side") / "jax_dryrun_side.py"
    script.write_text(JAX_SCRIPT)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True, cwd=ROOT,
                         env=env, timeout=SPAWN_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _rest_bytes(tree) -> int:
    """Bytes of storage rank 0's local tensors hold."""
    return sum(t.to_local().untyped_storage().nbytes() for _, t in keystr_items(tree))


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_bytes_at_rest_match_the_references_shard_shapes(jax_side, mesh_kind):
    seen = 0
    with dryrun.fake_world(dryrun.MESH_RANKS[mesh_kind]):
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi", device_type="cpu")
        for arch, shape_name in ADMITTED:
            shape = SHAPES[shape_name]
            policy = "train" if shape.phase == "train" else "serve"
            make, _, _, _ = dryrun.build_cell(arch, shape_name, policy)
            _, args = make(mesh)
            names = {"train": ("params", "opt", "batch"), "prefill": ("params", "batch"),
                     "decode": ("params", "caches", "batch")}[shape.phase]
            got = {name: _rest_bytes(a) for name, a in zip(names, args)}
            assert got == jax_side[f"{arch}|{shape_name}"][mesh_kind], (arch, shape_name)
            seen += 1
    assert seen == len(ADMITTED) > 30


def test_model_flops_and_applicability_match_the_reference(jax_side):
    for arch, shape_name in CELLS:
        want = jax_side[f"{arch}|{shape_name}"]
        cfg, shape = get_config(arch), SHAPES[shape_name]
        assert list(cell_applicable(cfg, shape)) == want["applicable"], (arch, shape_name)
        assert dryrun.model_flops(cfg, shape) == want["model_flops"], (arch, shape_name)


@pytest.fixture
def cut_depth(monkeypatch):
    """The registry's configs at their first CUT_LAYERS layers, with the
    full-attention layers among them (``chip_smoke.py``'s ``_cut``)."""
    full = registry.get_config

    def cut(name):
        cfg = full(name)
        return dataclasses.replace(cfg, n_layers=CUT_LAYERS, full_attn_layers=tuple(
            i for i in cfg.full_attn_layers if i < CUT_LAYERS))

    monkeypatch.setattr(registry, "get_config", cut)


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_every_cell_runs_on_the_single_pod_mesh(tmp_path, cut_depth, arch, shape_name):
    shape = SHAPES[shape_name]
    policy = "train" if shape.phase == "train" else "serve"
    r = dryrun.run_cell(arch, shape_name, "single", policy, str(tmp_path))
    ok, why = jcell_applicable(jget_config(arch), JSHAPES[shape_name])
    if not ok:
        assert r["status"] == "skipped" and r["reason"] == why
        return
    assert r["status"] == "ok", r.get("traceback")
    assert r["n_chips"] == 256 and not dist.is_initialized()
    mem = r["memory"]
    assert 0 < mem["argument_bytes"] <= mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["peak_gb"] == round((mem["argument_bytes"] + mem["temp_bytes"]) / 1e9, 3)
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    roof = r["roofline"]
    assert roof["step_s_lower_bound"] == max(roof["compute_s"], roof["memory_s"],
                                             roof["collective_s"]) > 0
    # every step gathers the weights; a train step also averages the gradients
    assert r["collectives"]["all-gather"]["bytes"] > 0
    assert ("all-reduce" in r["collectives"]) == (shape.phase == "train")
    assert os.path.exists(tmp_path / f"{arch}__{shape_name}__single__baseline.json")


def test_cli_runs_a_full_depth_cell_and_refuses_the_references_variants(tmp_path, capsys):
    assert dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k", "--out",
                        str(tmp_path), "--attn-impl", "flash", "--mixer-impl", "chunked"]) == 0
    assert capsys.readouterr().out.startswith("OK   tinyllama-1.1b")
    with open(tmp_path / "tinyllama-1.1b__decode_32k__single__baseline.json") as f:
        r = json.load(f)
    assert r["status"] == "ok" and r["fn"] == "serve_step"
    assert r["kernel_ops"] == {}             # decode attends in torch ops, as the reference does
    for flag, value in (("--attn-impl", "masked_scan"), ("--attn-impl", "triangular"),
                        ("--mixer-impl", "scan")):
        with pytest.raises(SystemExit):
            dryrun.main(["--arch", "tinyllama-1.1b", flag, value, "--out", str(tmp_path)])
        assert "no separate path" in capsys.readouterr().err


# --- four gloo processes -----------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("ranks")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    logs = [out_dir / f"rank{r}.log" for r in range(WORLD)]
    procs = []
    try:
        for r, log in enumerate(logs):
            with open(log, "w") as f:     # a file, not a pipe: no rank blocks on its output
                procs.append(subprocess.Popen(
                    [sys.executable, WORKER, str(r), str(WORLD), str(out_dir / "store"),
                     str(out_dir)], stdout=f, stderr=subprocess.STDOUT, env=env))
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log.read_text()[-2000:] for log in logs)
    res = []
    for r in range(WORLD):
        with open(out_dir / f"rank{r}.json") as f:
            res.append(json.load(f))
    return res


# tests/test_torch_parallel.py's tolerances.  The loss and the grad norm:
# summation order only.  The leaves: the step casts the microbatches' float32
# mean to bfloat16 (as the reference does), and an element whose two float32
# means (summed in another order) straddle a bfloat16 rounding boundary lands
# one bfloat16 ulp (2^-8 of it) away: a moment carries that difference, a
# parameter almost none of it (the update is normalised by the second
# moment), as with compress_grads' int8 quantum there
STEP_RTOL = 1e-5
COMPRESSED_MOMENT_TOL = 2 / 127
COMPRESSED_PARAM_TOL = 1e-4


def test_sharded_step_accumulates_like_the_unsharded_step(ranks):
    for r in ranks:
        c = r["accum"]
        for got, want in zip(c["loss"], c["loss_plain"]):
            assert abs(got - want) <= STEP_RTOL * abs(want), (got, want)
        for got, want in zip(c["grad_norm"], c["grad_norm_plain"]):
            assert abs(got - want) <= STEP_RTOL * abs(want), (got, want)
        for key, err in c["leaf_err"].items():
            tol = COMPRESSED_PARAM_TOL if key.startswith("['params']") else COMPRESSED_MOMENT_TOL
            assert err <= tol, (key, err, tol)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "hymba-1.5b", "rwkv6-7b", "whisper-medium"])
def test_sharded_prefill_and_decode_equal_the_unsharded_ones(ranks, arch):
    for r in ranks:
        c = next(c for c in r["serve"] if c["arch"] == arch)
        # the same weights and rows, one rank's batch shard at a time
        assert c["prefill_logits_err"] == 0.0 and c["decode_logits_err"] == 0.0, c
        assert c["cache_err"] == 0.0 and c["cache_shapes_match"] and c["some_cache_split"], c
