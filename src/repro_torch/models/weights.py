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
    names = {id(p): n for n, p in lm.named_parameters()}
    seen = set()

    def load(p: torch.nn.Parameter, t: torch.Tensor, what: str) -> None:
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{what}: reference shape {tuple(t.shape)}, port {tuple(p.shape)}")
        p.copy_(t)
        seen.add(names[id(p)])

    # "groups.0." (a list entry) or "enc.": the stacked leaves of those blocks
    stacks = {".".join(map(str, key)) + ".": blocks for key, blocks in lm.stacks()}
    for name, arr in iter_leaves(params):
        t = _tensor(arr)
        prefix = next((pre for pre in stacks if name.startswith(pre)), None)
        if prefix is None:
            load(lm.get_parameter(name), t, name)
            continue
        blocks = stacks[prefix]
        if t.shape[0] != len(blocks):
            raise ValueError(f"{name}: {t.shape[0]} stacked layers, port {len(blocks)}")
        for i, blk in enumerate(blocks):
            load(blk.get_parameter(name[len(prefix):]), t[i], f"{name}[{i}]")
    missing = set(names.values()) - seen
    if missing:
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
def to_reference(model: Model, device=None, release: bool = False) -> Dict[str, Any]:
    """The model's parameters in the reference's tree, stacked over their
    layers, as detached tensors on ``device`` (None: the device that holds
    the model's parameters) in their own dtypes:
    ``load_reference(model, to_reference(model))`` changes nothing.

    ``release=True`` hands the parameters over: each of the model's
    parameters is emptied as soon as the tree holds its values, so the two
    never hold two full copies (a mixtral-8x22b layer's bf16 weights are
    5 GB).  The model then holds no weights: it serves no more, and trains
    only through ``train_loss(tree, batch)``."""
    lm = model.lm
    device = model.device if device is None else device
    stacks = lm.stacks()
    in_blocks = {id(p) for _, blocks in stacks for p in blocks.parameters()}

    def take(ps, t):
        if release:
            for p in ps:
                p.data = p.data.new_empty(0)
        return t

    tree = _nest((name, take([p], p.detach().to(device))) for name, p in lm.named_parameters()
                 if id(p) not in in_blocks)
    for key, blocks in stacks:
        names = [name for name, _ in blocks[0].named_parameters()]
        stacked = _nest((name, take(ps, torch.stack([p.detach() for p in ps]).to(device)))
                        for name in names
                        for ps in [[blk.get_parameter(name) for blk in blocks]])
        if len(key) == 1:
            tree[key[0]] = stacked
        else:                 # ("groups", g): the g-th entry of a list
            tree.setdefault(key[0], []).append(stacked)
    return tree


def reference_views(model: Model, tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`to_reference` without a copy: each of the
    model's parameter names (``model.lm.named_parameters()``) mapped to its
    value in ``tree``, a stacked leaf's layer as a view (``leaf[i]``).  With
    ``torch.func.functional_call`` the model then runs on the tree's
    weights in place of its own (the sharded serve steps' gathered
    weights)."""
    lm = model.lm
    names = {id(p): n for n, p in lm.named_parameters()}
    out: Dict[str, torch.Tensor] = {}
    for key, blocks in lm.stacks():
        group = tree
        for part in key:
            group = group[part]
        for name, leaf in iter_leaves(group):
            for i, blk in enumerate(blocks):
                out[names[id(blk.get_parameter(name))]] = leaf[i]
    top = set(names.values())
    for name, leaf in iter_leaves(tree):
        if name in top and name not in out:
            out[name] = leaf
    missing = top - set(out)
    if missing:
        raise ValueError(f"reference tree does not cover the port's parameters: {sorted(missing)}")
    return out
