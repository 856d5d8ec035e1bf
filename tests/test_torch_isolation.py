"""The port stands alone: it imports neither JAX nor the reference package,
and its kernel mode never runs quietly on the CPU.

* An ``ast`` walk over every module of ``src/repro_torch/`` and over
  ``chip_smoke.py`` finds no import of ``jax`` or ``repro``.
* ``import repro_torch`` (and its main-path modules) in a fresh interpreter
  leaves ``jax`` and ``repro`` out of ``sys.modules``.
* With no CUDA device, ``BatchOCC(mode="kernel")`` and
  ``recover(mode="kernel")`` on the default device raise.
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
FORBIDDEN = ("jax", "jaxlib", "repro")


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
        "import repro_torch.kernels.ref\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
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


def test_no_environment_switch_in_the_kernel_modules():
    for name in ("ops.py", "batch_occ.py", "scatter_max.py"):
        src = (PORT / "kernels" / name).read_text()
        assert "environ" not in src and "getenv" not in src, name
