"""Shared model building blocks: param specs, norms, RoPE, initializers.

Parameters are described by :class:`ParamSpec` trees (nested dicts and
lists with ``ParamSpec`` leaves), as in the reference.  :class:`ParamTree`
turns one such tree into an ``nn.Module`` of ``nn.Parameter``s whose
attribute paths are the tree's keys, so ``block.attn.wq`` is the
reference's ``params["groups"][g]["attn"]["wq"][i]``.  Dense weights keep
the reference's ``(d_in, d_out)`` layout and are applied as ``x @ W``.

The logical sharding axes of the reference's specs are kept as data; one
card has no mesh, so nothing reads them yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
from torch import nn


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"       # 'normal' | 'zeros' | 'ones' | 'decay'
    init_scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def stack_specs(spec_tree, n: int):
    """Prepend a stacked 'layers' dim of size n to every leaf (the
    reference's per-group layout, used by ``cache_specs``)."""
    if isinstance(spec_tree, ParamSpec):
        s = spec_tree
        return ParamSpec((n,) + s.shape, ("layers",) + s.logical, s.dtype, s.init, s.init_scale)
    return {k: stack_specs(v, n) for k, v in spec_tree.items()}


def iter_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(dotted path, leaf)`` for every leaf of a nested dict/list tree, in
    key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from iter_leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from iter_leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


class ParamTree(nn.Module):
    """An ``nn.Module`` holding one parameter per ``ParamSpec`` leaf of a
    nested dict, allocated (uninitialised) on ``device``.  A leaf whose spec
    says bfloat16 is held in ``dtype``; the reference's float32 leaves (norm
    scales, SSM decay and bias) stay float32.  ``specs`` maps each direct
    parameter name to its spec, for :func:`init_params`."""

    def __init__(self, spec_tree: Dict[str, Any], device, dtype: torch.dtype):
        super().__init__()
        for k, v in spec_tree.items():
            if isinstance(v, ParamSpec):
                dt = dtype if v.dtype == torch.bfloat16 else v.dtype
                t = torch.empty(v.shape, dtype=dt, device=device)
                self.register_parameter(k, nn.Parameter(t, requires_grad=False))
            else:
                self.add_module(k, ParamTree(v, device, dtype))
        self.specs = {k: v for k, v in spec_tree.items() if isinstance(v, ParamSpec)}


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every :class:`ParamTree` parameter under ``module`` from its
    spec, drawing from ``generator`` (which lives on the parameters'
    device): zeros, ones, the decay init ``-0.5 - U[0, 1)``, or
    ``N(0, 1) * init_scale / sqrt(fan_in)`` drawn in float32 and cast.  The
    distributions are the reference's; the numbers are not (a JAX key and a
    torch generator give different draws from one seed)."""
    for mod in module.modules():
        if not isinstance(mod, ParamTree):
            continue
        for name, spec in mod.specs.items():
            p = getattr(mod, name)
            if spec.init == "zeros":
                p.zero_()
            elif spec.init == "ones":
                p.fill_(1.0)
            elif spec.init == "decay":
                u = torch.rand(p.shape, generator=generator, device=p.device)
                p.copy_(-0.5 - u)
            else:
                fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
                std = spec.init_scale / math.sqrt(max(1, fan_in))
                r = torch.randn(p.shape, generator=generator, device=p.device)
                p.copy_(r * std)


# --- norms -----------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def norm_spec(cfg, d: int) -> Dict[str, ParamSpec]:
    if cfg.norm == "layernorm":
        return {
            "scale": ParamSpec((d,), (None,), torch.float32, "ones"),
            "bias": ParamSpec((d,), (None,), torch.float32, "zeros"),
        }
    return {"scale": ParamSpec((d,), (None,), torch.float32, "ones")}


def apply_norm(cfg, p: nn.Module, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, p.scale, p.bias)
    return rms_norm(x, p.scale)


# --- rotary position embeddings ---------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).  Split-half
    rotation: the first and second halves of D are the pair's two parts."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)              # (D/2,)
    angles = positions[..., None].float() * freqs              # (..., S, D/2)
    sin = torch.sin(angles)[..., None, :]                      # (..., S, 1, D/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def dense_spec(d_in: int, d_out: int, logical: Tuple[Optional[str], Optional[str]],
               dtype=torch.bfloat16, init_scale: float = 1.0) -> ParamSpec:
    return ParamSpec((d_in, d_out), logical, dtype, "normal", init_scale)
