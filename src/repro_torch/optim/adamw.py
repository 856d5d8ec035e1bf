"""AdamW with global-norm clipping and a cosine schedule, functional over
the reference's parameter tree.

The counterpart of ``repro/optim/adamw.py``: the moments mirror the
parameters' tree (the reference's layout, stacked groups), so the state
``{"mu", "nu", "count"}`` journals under the reference's keys.  Every
update is computed in float32 with the reference's casts and in its order
of operations; the moments are stored in ``moment_dtype`` (float32 by
default, bfloat16 for the largest archs).  ``update`` returns new tensors
and leaves its inputs as they were, as the reference does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from ..models.common import ParamSpec
from ..tree import tree_leaves, tree_map, tree_unflatten_like


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    moment_dtype: torch.dtype = torch.float32


def opt_state_specs(param_specs, cfg: AdamWConfig) -> Dict[str, Any]:
    """ParamSpec tree for the optimizer state."""
    def _m(s: ParamSpec) -> ParamSpec:
        return ParamSpec(s.shape, s.logical, cfg.moment_dtype, "zeros")

    return {
        "mu": tree_map(_m, param_specs),
        "nu": tree_map(_m, param_specs),
        "count": ParamSpec((), (), torch.int32, "zeros"),
    }


def init(params, cfg: AdamWConfig) -> Dict[str, Any]:
    z = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
    leaves = tree_leaves(params)
    return {
        "mu": tree_map(z, params),
        "nu": tree_map(z, params),
        "count": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
    }


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp(step / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def global_norm(tree) -> torch.Tensor:
    """The square root of the sum, in flattening order, of each leaf's sum
    of squares in float32."""
    total = None
    for leaf in tree_leaves(tree):
        sq = torch.sum(torch.square(leaf.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


UPDATE_PART = 1 << 26      # elements of a leaf updated at once


def update(grads, state, params, cfg: AdamWConfig, grad_norm=None):
    """Returns ``(new_params, new_state, metrics)``.  ``grad_norm``: the
    norm to clip by, where ``grads`` are one rank's slices of the gradient
    (the sharded step's); None for the norm of ``grads``."""
    count = state["count"] + 1
    gn = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    lr = schedule(cfg, count)
    b1c = 1.0 - torch.pow(cfg.b1, count.float())
    b2c = 1.0 - torch.pow(cfg.b2, count.float())

    def _upd_part(p, g, m, v):
        g = g.float() * scale
        m32, v32 = m.float(), v.float()
        m_new = cfg.b1 * m32 + (1.0 - cfg.b1) * g
        v_new = cfg.b2 * v32 + (1.0 - cfg.b2) * g * g
        mhat = m_new / b1c
        vhat = v_new / b2c
        step = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        p_new = p.float() - lr * step
        return p_new.to(p.dtype), m_new.to(cfg.moment_dtype), v_new.to(cfg.moment_dtype)

    def _upd(p, g, m, v):
        """Elementwise, so a large leaf is updated in flat parts of at most
        UPDATE_PART elements: its float32 temporaries stay that small (an
        expert weight of mixtral-8x22b holds 805 M elements) and every
        element's value is the same."""
        n = p.numel()
        if n <= UPDATE_PART:
            return _upd_part(p, g, m, v)
        outs = (torch.empty_like(p), torch.empty(p.shape, dtype=cfg.moment_dtype, device=p.device),
                torch.empty(p.shape, dtype=cfg.moment_dtype, device=p.device))
        flat = [t.reshape(-1) for t in (p, g, m, v)]
        for i in range(0, n, UPDATE_PART):
            parts = _upd_part(*(t[i:i + UPDATE_PART] for t in flat))
            for out, part in zip(outs, parts):
                out.view(-1)[i:i + UPDATE_PART] = part
        return outs

    out = [_upd(*leaves) for leaves in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state["mu"]), tree_leaves(state["nu"]))]
    new_params = tree_unflatten_like(params, [o[0] for o in out])
    new_state = {
        "mu": tree_unflatten_like(params, [o[1] for o in out]),
        "nu": tree_unflatten_like(params, [o[2] for o in out]),
        "count": count,
    }
    return new_params, new_state, {"grad_norm": gn, "lr": lr}
