"""Production and smoke meshes as ``DeviceMesh``es.

The counterpart of ``repro/launch/mesh.py``.  Kept as functions (never
module-level constants), so importing this module touches no process
group.  Each builds a ``DeviceMesh`` with ``init_device_mesh`` over the
default process group, which the caller must have initialised
(``torch.distributed.init_process_group`` with its address, world size and
rank): a mesh whose size is not the world's raises.  The meshes live on
``device_type="cuda"`` unless the caller asks for ``"cpu"``.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape: Sequence[int], axes: Sequence[str], device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` with axis names ``axes`` over the initialised
    default process group."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs a CUDA device and none is available; "
                           "pass device_type='cpu'")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise the default process group first "
                           "(torch.distributed.init_process_group)")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


@contextlib.contextmanager
def mesh_context(mesh: DeviceMesh):
    """Yields ``mesh``.  The reference installs its mesh as JAX's global
    one; torch has no global mesh (a DTensor carries its own), so this
    context only keeps the reference's calling form."""
    yield mesh


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_smoke_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """Tiny mesh for tests: 2x2 (4 ranks) or 2x2x2 (8 ranks)."""
    shape = (2, 2, 2) if multi_pod else (2, 2)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)
