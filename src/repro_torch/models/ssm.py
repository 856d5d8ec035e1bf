"""Mamba-style selective SSM branch (hymba's parallel-head hybrid).

Mamba2-flavoured head-structured selective scan, as in the reference
(``repro/models/ssm.py``):

    h_t = exp(-exp(A_log) * dt_t) * h_{t-1} + dt_t * (x_t ⊗ B_t)
    y_t = (h_t · C_t) + D * x_t

with per-head scalar decay ``A_log``, data-dependent ``dt_t`` (softplus),
shared B/C projections (single group), a causal depthwise conv on the input
path, and a SiLU gate branch.

A prefill (no carried state) runs the scan through the chunked kernel
wrapper (``kernels/ssm_scan.py``): the hand-written kernel on the card, its
plain block-form version on the CPU, for any S.  A step with carried state
(decode, S = 1) runs the per-step recurrence in torch ops, as the reference
does; so does the causal conv.

State for decode: conv tail (B, cw-1, di) + ssm state (B, H, hd, N).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.ssm_scan import ssm_scan_chunked
from .common import ParamSpec, dense_spec


def ssm_spec(d: int, n_heads: int, head_dim: int, state: int, conv_width: int) -> Dict[str, ParamSpec]:
    di = n_heads * head_dim
    return {
        "in_proj": dense_spec(d, di, ("embed", "heads")),
        "gate_proj": dense_spec(d, di, ("embed", "heads")),
        "conv_w": ParamSpec((conv_width, di), (None, "heads"), torch.bfloat16, "normal", 0.5),
        "dt_proj": dense_spec(d, n_heads, ("embed", None)),
        "dt_bias": ParamSpec((n_heads,), (None,), torch.float32, "zeros"),
        "b_proj": dense_spec(d, state, ("embed", None)),
        "c_proj": dense_spec(d, state, ("embed", None)),
        "a_log": ParamSpec((n_heads,), (None,), torch.float32, "decay"),
        "d_skip": ParamSpec((n_heads,), (None,), torch.float32, "ones"),
        "out_proj": dense_spec(di, d, ("heads", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv via shifted adds, in x's dtype.  x: (B, S, di);
    w: (cw, di).  ``tail``: (B, cw-1, di) previous context (decode) —
    returns the new tail."""
    cw = w.shape[0]
    b, s, di = x.shape
    if tail is None:
        tail = torch.zeros((b, cw - 1, di), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail, x], dim=1)                     # (B, S+cw-1, di)
    y = torch.zeros_like(x)
    for i in range(cw):
        y = y + xp[:, i:i + s] * w[cw - 1 - i]
    new_tail = xp[:, -(cw - 1):] if cw > 1 else tail
    return y, new_tail


def ssm_scan(
    p: nn.Module,
    x: torch.Tensor,
    st: Optional[Dict[str, torch.Tensor]],
    n_heads: int,
    head_dim: int,
    state: int,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Selective scan over the full input; returns (y, new_state).
    ``st=None`` starts from zeros (prefill) and takes the chunked kernel."""
    b, s, d = x.shape
    di = n_heads * head_dim
    xs = x @ p.in_proj
    z = x @ p.gate_proj
    conv_tail = st["conv"] if st is not None else None
    xs, new_tail = _causal_conv(xs, p.conv_w, conv_tail)
    xs = F.silu(xs.float()).to(x.dtype)

    # jax.nn.softplus is logaddexp(x, 0)
    pre = x.float() @ p.dt_proj.float() + p.dt_bias
    dt = torch.logaddexp(pre, torch.zeros((), device=x.device))           # (B, S, H)
    decay = torch.exp(-torch.exp(p.a_log)[None, None, :] * dt)           # (B, S, H)
    bt = (x @ p.b_proj).float()
    ct = (x @ p.c_proj).float()
    xh = xs.reshape(b, s, n_heads, head_dim).float()

    if st is None:
        y, h_final = ssm_scan_chunked(xh.transpose(1, 2), dt.transpose(1, 2),
                                      decay.transpose(1, 2), bt, ct)
        y = y.transpose(1, 2)                                             # (B, S, H, hd)
    else:
        h = st["ssm"]
        ys = []
        for t in range(s):
            upd = (dt[:, t, :, None] * xh[:, t])[..., None] * bt[:, t, None, None, :]
            h = decay[:, t, :, None, None] * h + upd
            ys.append(torch.einsum("bhdn,bn->bhd", h, ct[:, t]))
        y = torch.stack(ys, dim=1)
        h_final = h
    y = y + p.d_skip[None, None, :, None] * xh
    y = y.reshape(b, s, di).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    out = y @ p.out_proj
    return out, {"conv": new_tail, "ssm": h_final}


def ssm_step(
    p: nn.Module,
    x1: torch.Tensor,
    st: Dict[str, torch.Tensor],
    n_heads: int,
    head_dim: int,
    state: int,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token decode step. x1: (B, 1, d)."""
    return ssm_scan(p, x1, st, n_heads, head_dim, state)
