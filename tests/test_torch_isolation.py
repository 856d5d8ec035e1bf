"""The port stands alone: it imports neither JAX nor the reference package,
and its kernel mode never runs quietly on the CPU.

* An ``ast`` walk over every module of ``src/repro_torch/`` and over
  ``chip_smoke.py`` finds no import of ``jax``, ``repro`` or ``ml_dtypes``
  (the journal writes bfloat16 from torch tensors itself).
* ``import repro_torch`` (and its main-path modules) in a fresh interpreter
  leaves ``jax``, ``repro`` and ``ml_dtypes`` out of ``sys.modules``.
* With no CUDA device, ``BatchOCC(mode="kernel")``,
  ``recover(mode="kernel")``, ``ShardedEngine()``,
  ``recover_sharded(mode="kernel")``, ``ReplicaApplier``, ``Replica``,
  ``ShardedReplica``, the serving tier's ``SingleBackend.make()`` and
  ``ShardedBackend.make()``, ``build_model`` (and so ``train_loss``), the
  serve CLI, the train CLI, ``make_smoke_mesh()`` and
  ``make_production_mesh()`` on the default device raise; each of the OLTP
  ones runs with ``device="cpu"``.
* The kernel wrappers pick the kernel or the plain version by the tensor's
  device alone: no environment switch exists.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    return files


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(root, line) for root, line in _imported_roots(tree) if root in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


def test_fresh_import_leaves_jax_and_reference_out():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.db, repro_torch.obs\n"
        "import repro_torch.trace, repro_torch.db.ycsb, repro_torch.kernels.ops\n"
        "import repro_torch.kernels.ref, repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.ssm_scan, repro_torch.kernels.rwkv6\n"
        "import repro_torch.configs.registry, repro_torch.models.rwkv\n"
        "import repro_torch.models.api, repro_torch.models.weights\n"
        "import repro_torch.models.serve_llm, repro_torch.launch.serve\n"
        "import repro_torch.shard, repro_torch.replica, repro_torch.core.truncate\n"
        "import repro_torch.core.variants, repro_torch.core.levels, repro_torch.db.tpcc\n"
        "import repro_torch.serve, repro_torch.obs.health, repro_torch.obs.flight\n"
        "import repro_torch.obs.forensics, repro_torch.trace.dag, repro_torch.trace.sim\n"
        "import repro_torch.trace.tune, repro_torch.journal, repro_torch.optim.adamw\n"
        "import repro_torch.parallel.compression, repro_torch.train.step\n"
        "import repro_torch.data.pipeline, repro_torch.launch.train, repro_torch.tree\n"
        "import repro_torch.parallel.sharding, repro_torch.parallel.axes\n"
        "import repro_torch.parallel.pipeline, repro_torch.launch.mesh\n"
        "from repro_torch.configs.registry import ARCH_NAMES, get_config\n"
        "[get_config(a) for a in ARCH_NAMES]\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_kernel_batch_occ_without_cuda_raises(no_cuda, tmp_path):
    from repro_torch.core import EngineConfig, PoplarEngine
    from repro_torch.db import ArrayTable, BatchOCC

    eng = PoplarEngine(EngineConfig(n_buffers=1, device_kind="null",
                                    device_clock="virtual", flush_interval=5e-4,
                                    logger_poll=1e-5))
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchOCC(ArrayTable(), eng)                       # defaults: kernel, cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchOCC(ArrayTable(), eng, mode="kernel", device="cuda")
    assert BatchOCC(ArrayTable(), eng, mode="kernel", device="cpu").device.type == "cpu"
    assert BatchOCC(ArrayTable(), eng, mode="vectorized").device is None


def test_kernel_recover_without_cuda_raises(no_cuda):
    from repro_torch.core import recover
    from repro_torch.core.recovery import replay_columnar
    from repro_torch.core.storage import DeviceSpec, StorageDevice

    devs = [StorageDevice(DeviceSpec.null(), clock="virtual")]
    with pytest.raises(RuntimeError, match="CUDA"):
        recover(devs)                                      # defaults: kernel, cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        recover(devs, mode="kernel", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        replay_columnar([], 0, use_kernel=True)
    assert recover(devs, mode="kernel", device="cpu").data == {}
    assert recover(devs, mode="vectorized").data == {}


def test_sharded_engine_and_recovery_without_cuda_raise(no_cuda, tmp_path):
    from repro_torch.db import TxnSpec
    from repro_torch.shard import ShardedConfig, ShardedEngine, recover_sharded

    cfg = dict(n_shards=2, device_kind="null", device_clock="virtual")
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedEngine(**cfg)                               # defaults: kernel, cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedEngine(ShardedConfig(mode="kernel", device="cuda", **cfg))
    eng = ShardedEngine(device="cpu", device_dir=str(tmp_path), **cfg)
    assert all(sh.occ.mode == "kernel" and sh.occ.device.type == "cpu" for sh in eng.shards)
    res = eng.execute_batch([TxnSpec(writes=[(f"user{i}", b"v")]) for i in range(8)])
    assert len(res.committed) + len(res.cross) == 8
    eng.quiesce()
    with pytest.raises(RuntimeError, match="CUDA"):
        recover_sharded(eng.devices)                       # defaults: kernel, cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        recover_sharded(eng.devices, mode="kernel", device="cuda")
    st = recover_sharded(eng.devices, mode="kernel", device="cpu")
    assert st.data == recover_sharded(eng.devices, mode="vectorized").data
    assert len(st.data) == 8


def test_replicas_without_cuda_raise(no_cuda, tmp_path):
    from repro_torch.core import EngineConfig, PoplarEngine, Txn, Worker, recover
    from repro_torch.db import ArrayTable
    from repro_torch.replica import Replica, ReplicaApplier, ShardedReplica

    eng = PoplarEngine(EngineConfig(n_buffers=2, device_kind="null", device_clock="virtual",
                                    device_dir=str(tmp_path)))
    w = Worker(eng, 0)
    for i in range(5):
        w.run(Txn(tid=i + 1, write_set=[(f"k{i}", b"v")]), [], [type("C", (), {"ssn": 0})()])
    eng.quiesce([0])
    with pytest.raises(RuntimeError, match="CUDA"):
        ReplicaApplier(ArrayTable())                       # defaults: kernel, cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        Replica(eng.devices)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedReplica([eng.devices])
    assert ReplicaApplier(ArrayTable(), device="cpu").device.type == "cpu"
    assert ReplicaApplier(ArrayTable(), mode="vectorized").device is None
    rep = Replica(eng.devices, device="cpu", parallel=False)
    assert rep.applier.mode == "kernel"
    assert rep.promote().data == recover(eng.devices, mode="vectorized").data
    srep = ShardedReplica([eng.devices], device="cpu", parallel=False)
    assert srep.promote().shards[0].data == rep.table.to_dict()


def test_serve_backends_without_cuda_raise(no_cuda, tmp_path):
    from repro_torch.core import EngineConfig
    from repro_torch.db import TxnSpec
    from repro_torch.serve import (ACKED, GroupCommitScheduler, ServeConfig, ShardedBackend,
                                   SingleBackend, run_stepped_schedule)

    cfg = EngineConfig(n_buffers=1, device_kind="null", device_dir=str(tmp_path / "single"),
                       device_clock="virtual", flush_interval=60.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        SingleBackend.make()                               # defaults: kernel, cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        SingleBackend.make("kernel", cfg=cfg, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedBackend.make()                              # ShardedConfig: kernel, cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedBackend.make(n_shards=2, device_kind="null", device_dir=str(tmp_path / "x"))
    with pytest.raises(ValueError, match="mode"):
        SingleBackend.make("pallas", cfg=cfg, device="cpu")
    single = SingleBackend.make(cfg=cfg, device="cpu")
    sharded = ShardedBackend.make(n_shards=2, device="cpu", device_kind="null",
                                  device_clock="virtual", device_dir=str(tmp_path / "sharded"))
    assert single.occ.mode == "kernel" and single.occ.device.type == "cpu"
    assert all(sh.occ.mode == "kernel" and sh.occ.device.type == "cpu" for sh in sharded.eng.shards)
    for be in (single, sharded):
        sched = GroupCommitScheduler(be, ServeConfig(max_batch=4))
        tickets = run_stepped_schedule(
            sched, [(i // 3, TxnSpec(writes=[(f"user{i}", b"v")])) for i in range(10)])
        assert [t.status for t in tickets] == [ACKED] * 10


def test_llm_entry_points_without_cuda_raise(no_cuda):
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models.api import build_model
    from repro_torch.models.serve_llm import ServeEngine
    from repro_torch.models.weights import from_reference

    cfg = reduced(get_config("hymba-1.5b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)                                   # default: cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(reduced(get_config("rwkv6-7b")))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(get_config("hymba-1.5b"), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        from_reference({}, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--reduced"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "rwkv6-7b", "--reduced"])
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(build_model(cfg))
    model = build_model(cfg, device="cpu")
    assert model.device.type == "cpu" and ServeEngine(model).model is model


def test_train_entry_points_without_cuda_raise(no_cuda):
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train
    from repro_torch.models.api import build_model

    cfg = reduced(get_config("tinyllama-1.1b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg).train_loss(None, {})             # default: cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg, remat_policy="full")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced", "--steps", "1"])
    model = build_model(cfg, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    loss = model.train_loss(None, {"tokens": tokens, "labels": tokens})
    assert loss.device.type == "cpu" and loss.dtype == torch.float32


def test_no_environment_switch_in_the_kernel_modules():
    for name in ("ops.py", "batch_occ.py", "scatter_max.py", "flash_attention.py",
                 "ssm_scan.py", "rwkv6.py", "cuda.py"):
        src = (PORT / "kernels" / name).read_text()
        assert "environ" not in src and "getenv" not in src, name


def test_meshes_without_cuda_raise(no_cuda):
    from repro_torch.launch.mesh import make_mesh, make_production_mesh, make_smoke_mesh

    for build in (make_smoke_mesh, make_production_mesh,
                  lambda: make_smoke_mesh(multi_pod=True), lambda: make_mesh((1,), ("data",))):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()                                        # default: cuda
