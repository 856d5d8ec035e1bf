"""The port's parallel layer against the reference's, on the CPU.

* Resolution: the reference's six rule cases (``tests/test_sharding.py``)
  run through both packages, and every arch's param, optimizer-state and
  cache specs (``decode_32k``'s and ``long_500k``'s) resolve to the same
  spec under all three policies on the 16x16, 2x16x16, 2x2 and 2x2x2 meshes
  (duck-typed meshes with a name -> extent ``.shape``, as the reference's
  tests use).
* Placements: on the smoke meshes, built as ``DeviceMesh``es under the fake
  process group one rank at a time, each coordinate's local slice (DTensor's
  own offset computation) equals JAX's ``devices_indices_map`` for the
  device at the same mesh coordinate.  The production meshes have the
  reference's shapes and axis names.  The JAX side runs in a subprocess
  with 512 forced host devices.
* The registry's ``cell_applicable``, ``input_specs`` and ``make_inputs``
  (bit for bit).
* ``constrain``: a no-op outside a context; inside one, a DTensor moves to
  the resolved placements.
* Four gloo processes (``tests/_torch_parallel_worker.py``, meeting
  through a ``FileStore`` under ``tmp_path``): the sharded train step on the
  2x2 mesh against the unsharded one (reduced tinyllama and llava, two steps,
  with and without ``compress_grads``), ``compressed_psum`` against the
  reference's ``shard_map`` run, ``gpipe_apply`` against both packages'
  ``sequential_reference``.
"""

import json
import math
import os
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import reduced as jreduced
from repro.configs.registry import cell_applicable as jcell_applicable
from repro.configs.registry import get_config as jget_config
from repro.configs.registry import input_specs as jinput_specs
from repro.configs.registry import make_inputs as jmake_inputs
from repro.models.api import build_model as jbuild_model
from repro.models.common import ParamSpec as JParamSpec
from repro.optim import adamw as jadamw
from repro.parallel import pipeline as jpipeline
from repro.parallel.sharding import POLICIES as JPOLICIES
from repro.parallel.sharding import resolve_pspec as jresolve_pspec
from repro_torch.configs.base import SHAPES, ShapeConfig, reduced
from repro_torch.configs.registry import ARCH_NAMES, cell_applicable, get_config, input_specs, make_inputs
from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh, mesh_context
from repro_torch.models import encdec, lm
from repro_torch.models.common import ParamSpec
from repro_torch.optim import adamw
from repro_torch.parallel.axes import constrain, logical_context
from repro_torch.parallel.sharding import POLICIES, mesh_axes, resolve_pspec, spec_sharding, to_placements
from repro_torch.tree import keystr_items

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_parallel_worker.py")
WORLD = 4
SPAWN_TIMEOUT_S = 180     # each spawn's own limit; a normal run takes seconds


class _FakeMesh:
    """Duck-typed mesh exposing a name -> extent .shape."""

    def __init__(self, shape):
        self.shape = shape


MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "2x2": {"data": 2, "model": 2},
    "2x2x2": {"pod": 2, "data": 2, "model": 2},
}


def _both(shape, logical, mesh_shape, policy="train"):
    """The reference's and the port's resolution of one leaf."""
    mesh = _FakeMesh(mesh_shape)
    want = tuple(jresolve_pspec(shape, logical, mesh, JPOLICIES[policy]))
    got = resolve_pspec(shape, logical, mesh, POLICIES[policy])
    assert got == want, (shape, logical, mesh_shape, policy, got, want)
    return got


# --- the reference's rule cases (its six tests) ------------------------------------------------

def _check_fsdp_tp_weight(spec):
    assert spec == (("pod", "data"), "model")


def _check_single_pod(spec):
    assert spec == ("data", "model")


def _check_heads_divide(spec):
    assert spec == ("data", "model")


def _check_expert(spec):
    assert spec[0] is None and spec[1] == "data" and spec[2] == "model"


def _check_no_reuse(spec):
    assert spec[1] == ("pod", "data") and spec[2] is None
    assert spec[4] == "model" or spec[3] == "model"


def _check_long500k(spec):
    assert spec[1] is None and spec[2] == "data"


RULE_CASES = {
    "fsdp_tp_weight": ((6144, 16384), ("embed", "mlp"), MESHES["2x16x16"], _check_fsdp_tp_weight),
    "single_pod_fallback": ((6144, 16384), ("embed", "mlp"), MESHES["16x16"], _check_single_pod),
    # qwen2: 12 heads x 128 = 1536 divides 16, so the heads dim is sharded
    "divisibility_qwen2_heads": ((1536, 12 * 128), ("embed", "heads"), MESHES["16x16"],
                                 _check_heads_divide),
    # hymba q proj: 25*64=1600 divides 16 even though heads=25 don't
    "divisibility_hymba_heads": ((1600, 1600), ("embed", "heads"), MESHES["16x16"],
                                 _check_heads_divide),
    "expert_dim_unsharded": ((8, 6144, 32768), ("expert", "embed", "mlp"), MESHES["16x16"],
                             _check_expert),
    "no_axis_reuse_per_leaf": ((32, 128, 32768, 8, 128),
                               ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
                               MESHES["2x16x16"], _check_no_reuse),
    "long500k_seq_sharding": ((32, 1, 4096, 8, 128),
                              ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
                              MESHES["16x16"], _check_long500k),
}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_rule_case_matches_the_reference(case):
    shape, logical, mesh_shape, check = RULE_CASES[case]
    check(_both(shape, logical, mesh_shape))


# --- every arch's specs -----------------------------------------------------------

def _jspecs(cfg):
    model = jbuild_model(cfg)
    params = model.param_specs()
    tree = {"params": params, "opt": jadamw.opt_state_specs(params, jadamw.AdamWConfig())}
    for name in ("decode_32k", "long_500k"):
        s = JSHAPES[name]
        tree[name] = model.cache_specs(s.global_batch, s.seq_len)
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JParamSpec))
    return {jax.tree_util.keystr(p): s for p, s in flat}


def _specs(cfg):
    mod = encdec if cfg.enc_dec is not None else lm
    params = mod.param_specs(cfg)
    tree = {"params": params, "opt": adamw.opt_state_specs(params, adamw.AdamWConfig())}
    for name in ("decode_32k", "long_500k"):
        s = SHAPES[name]
        tree[name] = mod.cache_specs(cfg, s.global_batch, s.seq_len)
    return dict(keystr_items(tree))


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_every_spec_resolves_like_the_reference(arch, policy):
    want, got = _jspecs(jget_config(arch)), _specs(get_config(arch))
    assert list(got) == list(want)
    assert len(got) > 10
    sharded = 0
    for key, spec in got.items():
        jspec = want[key]
        assert tuple(spec.shape) == tuple(jspec.shape) and tuple(spec.logical) == tuple(jspec.logical), key
        for mesh_shape in MESHES.values():
            sharded += bool(_both(spec.shape, spec.logical, mesh_shape, policy))
    assert sharded > 0


def test_policies_are_the_references():
    assert POLICIES == {k: {n: [tuple(c) for c in cands] for n, cands in v.items()}
                        for k, v in JPOLICIES.items()}


def test_to_placements():
    mesh = _FakeMesh(MESHES["2x2x2"])
    assert to_placements((("pod", "data"), None, "model"), mesh) == (Shard(0), Shard(0), Shard(2))
    assert to_placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        to_placements((("data", "pod"),), mesh)


# --- placements on DeviceMeshes against JAX's layout --------------------------------

PLACEMENT_LEAVES = {
    # tinyllama-1.1b at full width
    "embed": ((32000, 2048), ("vocab", "embed")),
    "w_gate": ((22, 2048, 5632), ("layers", "embed", "mlp")),
    "cache_k": ((22, 128, 32768, 4, 64), ("layers", "batch", "kv_seq", "kv_heads", "head_dim")),
}

SMOKE_ARCHS = ("tinyllama-1.1b", "llava-next-mistral-7b")

JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import sys, json
    sys.path.insert(0, "src")
    from functools import partial
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    from repro.configs.base import reduced
    from repro.configs.registry import get_config
    from repro.launch.mesh import make_production_mesh, make_smoke_mesh, mesh_context
    from repro.models.api import build_model
    from repro.models.common import ParamSpec
    from repro.optim import adamw
    from repro.parallel.compression import compressed_psum
    from repro.parallel.sharding import POLICIES, resolve_pspec

    leaves, archs = json.loads(sys.argv[1]), json.loads(sys.argv[2])
    out = {"production": {}, "index": {}, "shard_shapes": {}}
    for mp in (False, True):
        m = make_production_mesh(multi_pod=mp)
        out["production"][str(mp)] = {a: int(m.shape[a]) for a in m.axis_names}
        mesh = make_smoke_mesh(multi_pod=mp)
        for policy, rules in POLICIES.items():
            for name, (shape, logical) in leaves.items():
                dmap = NamedSharding(mesh, resolve_pspec(shape, logical, mesh, rules)) \\
                    .devices_indices_map(tuple(shape))
                for coord in np.ndindex(mesh.devices.shape):
                    sl = dmap[mesh.devices[coord]]
                    out["index"][f"{mp}|{policy}|{name}|{list(coord)}"] = [
                        [s.start or 0, n if s.stop is None else s.stop] for s, n in zip(sl, shape)]

    mesh = make_smoke_mesh()
    for arch in archs:
        cfg = reduced(get_config(arch), n_layers=2, d_model=64, vocab=256)
        specs = build_model(cfg).param_specs()
        tree = {"params": specs, "opt": adamw.opt_state_specs(specs, adamw.AdamWConfig())}
        flat, _ = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, ParamSpec))
        out["shard_shapes"][arch] = [
            list(NamedSharding(mesh, resolve_pspec(s.shape, s.logical, mesh, POLICIES["train"]))
                 .shard_shape(s.shape)) for _, s in flat]

    # the reference test's compressed psum, on a 4-device data mesh
    mesh4 = jax.make_mesh((4,), ("data",))
    x = jnp.asarray(np.random.default_rng(0).normal(0, 1, (4, 512)), jnp.float32)

    @partial(shard_map, mesh=mesh4, in_specs=P("data"), out_specs=P("data"), check_rep=False)
    def f(xs):
        return compressed_psum(xs[0], "data")[None]

    with mesh_context(mesh4):
        out["psum"] = np.asarray(jax.jit(f)(x)).tolist()
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    script = tmp_path_factory.mktemp("jax_side") / "jax_side.py"
    script.write_text(JAX_SCRIPT)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, str(script), json.dumps(PLACEMENT_LEAVES), json.dumps(SMOKE_ARCHS)],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=SPAWN_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


class _FakeWorld:
    """The fake process group at one rank: collectives do nothing, which is
    enough to build a DeviceMesh of any size and read its layout."""

    def __init__(self, rank: int, world: int):
        self.rank, self.world = rank, world

    def __enter__(self):
        dist.init_process_group("fake", store=FakeStore(), rank=self.rank, world_size=self.world)
        return self

    def __exit__(self, *exc):
        dist.destroy_process_group()


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("multi_pod", [False, True], ids=["2x2", "2x2x2"])
def test_local_slices_match_devices_indices_map(jax_side, multi_pod, policy):
    world = 8 if multi_pod else 4
    seen = 0
    for rank in range(world):
        with _FakeWorld(rank, world):
            mesh = make_smoke_mesh(multi_pod=multi_pod, device_type="cpu")
            coord = list(mesh.get_coordinate())
            for name, (shape, logical) in PLACEMENT_LEAVES.items():
                sh = spec_sharding(ParamSpec(shape, logical), mesh, POLICIES[policy])
                local, offset = compute_local_shape_and_global_offset(shape, mesh, list(sh.placements))
                got = [[o, o + n] for o, n in zip(offset, local)]
                assert got == jax_side["index"][f"{multi_pod}|{policy}|{name}|{coord}"], (name, coord)
                seen += 1
    assert seen == world * len(PLACEMENT_LEAVES)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_production_mesh_matches_the_reference(jax_side, multi_pod):
    world = 512 if multi_pod else 256
    with _FakeWorld(0, world):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        assert mesh_axes(mesh) == jax_side["production"][str(multi_pod)]
        assert mesh.mesh.numel() == world


def test_mesh_needs_an_initialised_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_smoke_mesh(device_type="cpu")


# --- the registry --------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cell_applicable_and_input_specs_match_the_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    for name in JSHAPES:
        assert cell_applicable(cfg, SHAPES[name]) == jcell_applicable(jcfg, JSHAPES[name])
        want, got = jinput_specs(jcfg, JSHAPES[name]), input_specs(cfg, SHAPES[name])
        assert list(got) == list(want)
        for k, s in got.items():
            assert tuple(s.shape) == tuple(want[k].shape), (name, k)
            assert str(s.dtype).replace("torch.", "") == str(want[k].dtype), (name, k)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("phase", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_make_inputs_match_the_reference_bit_for_bit(arch, phase):
    want = jmake_inputs(jreduced(jget_config(arch)), JShapeConfig("t", 32, 4, phase), seed=3)
    got = make_inputs(reduced(get_config(arch)), ShapeConfig("t", 32, 4, phase), seed=3,
                      device="cpu")
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)


# --- constrain ---------------------------------------------------------------------------

def test_constrain_is_a_no_op_outside_a_context():
    x = torch.ones(4, 8)
    assert constrain(x, ("batch", "vocab")) is x


def test_constrain_moves_a_dtensor_to_the_resolved_placements():
    with _FakeWorld(0, 4), mesh_context(make_smoke_mesh(device_type="cpu")) as mesh:
        d = DTensor.from_local(torch.ones(8, 6), mesh, [Replicate(), Replicate()], run_check=False)
        assert constrain(d, ("batch", "vocab")) is d
        with logical_context(mesh, "train"):
            out = constrain(d, ("batch", "vocab"))
            plain = torch.ones(8, 6)
            assert constrain(plain, ("batch", "vocab")) is plain
        assert isinstance(out, DTensor)
        assert tuple(out.placements) == (Shard(0), Shard(1))
        assert tuple(out.to_local().shape) == (4, 3)


# --- four gloo processes ----------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the worker on WORLD ranks; each rank's JSON and arrays."""
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
        res[-1]["arrays"] = dict(np.load(out_dir / f"rank{r}.npz"))
    return res


# the loss and the grad norm: summation order only
STEP_RTOL = 1e-5
# every parameter and moment leaf, as max |sharded - unsharded| over the
# leaf's max |unsharded|: summation order only
LEAF_TOL = 1e-5
# with compress_grads an element of the averaged gradient that falls within
# float32 rounding of an int8 rounding boundary may land one quantum (its
# chunk's max / 127) away; a moment carries that difference (per step at
# most 1/127 of the leaf's max), a parameter almost none of it (the update
# is normalised by the second moment)
COMPRESSED_MOMENT_TOL = 2 / 127
COMPRESSED_PARAM_TOL = 1e-4


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "compressed"])
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_sharded_step_matches_the_unsharded_step(ranks, arch, compress):
    cases = [next(c for c in r["steps"] if c["arch"] == arch and c["compress"] == compress)
             for r in ranks]
    c = cases[0]
    # the replicated metrics are the same bits on every rank
    assert all(o["bits"] == c["bits"] for o in cases), [o["bits"] for o in cases]
    for got, want in zip(c["loss"], c["loss_plain"]):
        assert abs(got - want) < 2e-2                     # the reference's own bound
        assert abs(got - want) <= STEP_RTOL * abs(want), (got, want)
    np.testing.assert_allclose(c["grad_norm"], c["grad_norm_plain"], rtol=STEP_RTOL)
    assert all(o["all_dtensor"] for o in cases)
    for key, err in c["leaf_err"].items():
        if not compress:
            tol = LEAF_TOL
        else:
            tol = COMPRESSED_PARAM_TOL if key.startswith("['params']") else COMPRESSED_MOMENT_TOL
        assert err <= tol, (key, err, tol)


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_sharded_state_rests_at_the_references_shard_bytes(ranks, jax_side, arch):
    # the port's test model is float32 throughout, the step counter int32
    want = sum(4 * math.prod(s) for s in jax_side["shard_shapes"][arch])
    for r in ranks:
        case = next(c for c in r["steps"] if c["arch"] == arch and not c["compress"])
        assert case["bytes_at_rest"] == want
        assert case["bytes_at_rest_after"] == want


def test_constrain_redistributes_on_four_ranks(ranks):
    for r in ranks:
        c = r["constrain"]
        assert c["outside_same"] and c["plain_same"] and c["values_equal"]
        assert c["placements"] == ["Shard(dim=0)", "Shard(dim=1)"]
        row, col = r["coordinate"]
        full = np.arange(48, dtype=np.float32).reshape(8, 6)
        np.testing.assert_array_equal(c["local"], full[4 * row:4 * row + 4, 3 * col:3 * col + 3])


def test_compressed_psum_matches_the_references_shard_map(ranks, jax_side):
    want = np.asarray(jax_side["psum"], np.float32)
    x = np.random.default_rng(0).normal(0, 1, (WORLD, 512)).astype(np.float32)
    exact = x.sum(axis=0)
    for i, r in enumerate(ranks):
        got = r["arrays"]["psum"]
        np.testing.assert_array_max_ulp(got, want[i], maxulp=1)
        np.testing.assert_array_equal(got, ranks[0]["arrays"]["psum"])
        assert float(np.abs(got - exact).max()) / float(np.abs(exact).max()) < 0.05


def test_gpipe_matches_both_sequential_references(ranks):
    S, M, MB, D = 4, 6, 3, 8
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.5, (S, D, D)).astype(np.float32)
    xs = rng.normal(0, 1, (M, MB, D)).astype(np.float32)
    jref = np.asarray(jpipeline.sequential_reference(
        lambda p, x: jnp.tanh(x @ p["w"]), {"w": jnp.asarray(w)}, jnp.asarray(xs)))
    T = M + S - 1
    for stage, r in enumerate(ranks):
        piped = r["arrays"]["piped"]
        assert piped.shape == (M, MB, D)
        assert float(np.abs(piped - r["arrays"]["seq"]).max()) < 1e-5
        assert float(np.abs(piped - jref).max()) < 1e-6
        # each rank sends to the next stage once a tick
        assert r["hops"] == ({f"{stage}-{stage + 1}": T} if stage < S - 1 else {})
