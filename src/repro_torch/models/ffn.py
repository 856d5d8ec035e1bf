"""Feed-forward blocks: gated MLP (llama-style) and gelu MLP (whisper).

The reference's top-k MoE (``moe_fwd``) waits for the slice that ports the
``moe`` family.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from .common import ParamSpec, dense_spec


def mlp_spec(d: int, f: int, style: str = "swiglu") -> Dict[str, ParamSpec]:
    if style == "gelu2":
        return {
            "w_in": dense_spec(d, f, ("embed", "mlp")),
            "b_in": ParamSpec((f,), ("mlp",), torch.bfloat16, "zeros"),
            "w_out": dense_spec(f, d, ("mlp", "embed")),
            "b_out": ParamSpec((d,), (None,), torch.bfloat16, "zeros"),
        }
    return {
        "w_gate": dense_spec(d, f, ("embed", "mlp")),
        "w_up": dense_spec(d, f, ("embed", "mlp")),
        "w_down": dense_spec(f, d, ("mlp", "embed")),
    }


def mlp_fwd(p: nn.Module, x: torch.Tensor, style: str = "swiglu") -> torch.Tensor:
    """The activation runs in float32 and is cast back before the gate
    product, as in the reference (jax.nn.gelu is the tanh form)."""
    if style == "gelu2":
        h = x @ p.w_in + p.b_in
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        return h @ p.w_out + p.b_out
    g = x @ p.w_gate
    u = x @ p.w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ p.w_down
