"""Logical sharding-constraint context.

The counterpart of ``repro/parallel/axes.py``.  Model code never names mesh
axes; it calls ``constrain(x, logical)`` with logical names ("batch",
"vocab", ...).  A caller installs a (mesh, rules) context with
:func:`logical_context`; outside any context ``constrain`` is a no-op, as in
the reference.

Inside a context, a DTensor is redistributed to the placements its logical
names resolve to on the context's mesh.  A plain tensor is returned as it
is: the port's sharded step (``sharding.ShardedTrainStep``) gathers the
weights and computes on plain tensors, so there is no activation sharding
to pin, and the port's model code calls no ``constrain``.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence

import torch
from torch.distributed.tensor import DTensor

from .sharding import POLICIES, resolve_pspec, to_placements

_CTX: contextvars.ContextVar = contextvars.ContextVar("repro_torch_logical_ctx", default=None)


@contextlib.contextmanager
def logical_context(mesh, policy: str = "train"):
    token = _CTX.set((mesh, POLICIES[policy]))
    try:
        yield
    finally:
        _CTX.reset(token)


def constrain(x: torch.Tensor, logical: Sequence[Optional[str]]) -> torch.Tensor:
    ctx = _CTX.get()
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    if x.device_mesh != mesh:
        raise ValueError("constrain: the DTensor lives on another mesh than the context's")
    pspec = resolve_pspec(x.shape, tuple(logical), mesh, rules)
    return x.redistribute(mesh, to_placements(pspec, mesh))
