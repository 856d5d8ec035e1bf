"""Carry parameters between the reference's tree and the port's model.

:func:`from_reference` takes the reference's parameter tree (``Model.init``
of ``repro.models.api``) as numpy arrays or tensors: top-level ``embed``,
``final_norm``, ``unembed``, and ``groups``, one dict per layer group with
every leaf stacked over the group's layers.  It unstacks the groups into
the port's per-layer :class:`~repro_torch.models.lm.Block` modules
(:func:`load_reference` does the same into a model that exists).
:func:`to_reference` is the exact inverse: the model's parameters as that
tree, which is what the train step, the optimizer and the training journal
work on, so that a journal keys its records as the reference's does.  Dense
weights keep the reference's ``(d_in, d_out)`` layout on both sides (the
port applies them as ``x @ W``), so nothing is transposed; this module is
the one place the two layouts meet.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ArchConfig
from .api import Model, build_model
from .common import iter_leaves


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)          # exact: bfloat16 widens to float32
    return torch.from_numpy(np.array(a))


@torch.no_grad()
def load_reference(model: Model, params: Dict[str, Any]) -> Model:
    """Copy the reference's parameter tree into ``model``.  Every leaf must
    match a parameter's shape, and every parameter must be set."""
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
        leaves = [(name, _tensor(arr)) for name, arr in iter_leaves(group)]
        for i in range(g.n_layers):
            for name, arr in leaves:
                load(f"blocks.{j + i}.{name}", arr[i])
        j += g.n_layers
    missing = {n for n, _ in lm.named_parameters()} - seen
    if missing or len(params["groups"]) != len(lm.groups):
        raise ValueError(f"reference tree does not cover the port's parameters: {sorted(missing)}")
    return model


def from_reference(params: Dict[str, Any], cfg: ArchConfig, *, device="cuda",
                   dtype: torch.dtype = torch.bfloat16) -> Model:
    """A port model holding the reference's parameters (numpy arrays or
    tensors, in the reference's tree)."""
    model = build_model(cfg, device=device, dtype=dtype)
    return load_reference(model, params)


def _nest(flat) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, t in flat:
        *path, last = name.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[last] = t
    return out


@torch.no_grad()
def to_reference(model: Model, device="cpu") -> Dict[str, Any]:
    """The model's parameters in the reference's tree, groups stacked over
    their layers, as detached tensors on ``device`` in their own dtypes:
    ``load_reference(model, to_reference(model))`` changes nothing."""
    lm = model.lm
    top = [(name, p.detach().to(device)) for name, p in lm.named_parameters()
           if not name.startswith("blocks.")]
    tree = _nest(top)
    groups = []
    for _, blocks in lm._group_blocks():
        names = [name for name, _ in blocks[0].named_parameters()]
        groups.append(_nest(
            (name, torch.stack([blk.get_parameter(name).detach() for blk in blocks]).to(device))
            for name in names))
    tree["groups"] = groups
    return tree
