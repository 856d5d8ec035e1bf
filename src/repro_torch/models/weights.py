"""Carry the reference's weights into the port.

:func:`from_reference` takes the reference's parameter tree (``Model.init``
of ``repro.models.api``) as numpy arrays: top-level ``embed``,
``final_norm``, ``unembed``, and ``groups``, one dict per layer group with
every leaf stacked over the group's layers.  It unstacks the groups into
the port's per-layer :class:`~repro_torch.models.lm.Block` modules.  Dense
weights keep the reference's ``(d_in, d_out)`` layout on both sides (the
port applies them as ``x @ W``), so nothing is transposed; this function
is the one place the two layouts meet.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ArchConfig
from .api import Model, build_model
from .common import iter_leaves


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)          # exact: bfloat16 widens to float32
    return torch.from_numpy(np.array(a))


@torch.no_grad()
def from_reference(params: Dict[str, Any], cfg: ArchConfig, *, device="cuda",
                   dtype: torch.dtype = torch.bfloat16) -> Model:
    """A port model holding the reference's parameters (numpy arrays, in
    the reference's tree).  Every leaf must match a parameter's shape, and
    every parameter must be set."""
    model = build_model(cfg, device=device, dtype=dtype)
    lm = model.lm
    seen = set()

    def load(name: str, arr) -> None:
        p = lm.get_parameter(name)
        t = _tensor(arr)
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: reference shape {tuple(t.shape)}, port {tuple(p.shape)}")
        p.copy_(t)
        seen.add(name)

    for name, arr in iter_leaves({k: v for k, v in params.items() if k != "groups"}):
        load(name, arr)
    j = 0
    for g, group in zip(lm.groups, params["groups"]):
        leaves = list(iter_leaves(group))
        for i in range(g.n_layers):
            for name, arr in leaves:
                load(f"blocks.{j + i}.{name}", np.asarray(arr)[i])
        j += g.n_layers
    missing = {n for n, _ in lm.named_parameters()} - seen
    if missing or len(params["groups"]) != len(lm.groups):
        raise ValueError(f"reference tree does not cover the port's parameters: {sorted(missing)}")
    return model
