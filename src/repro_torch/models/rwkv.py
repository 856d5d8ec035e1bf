"""RWKV6 ("Finch") block: token-shift time-mix with data-dependent decay
(the wkv6 recurrence) and a gated channel-mix, as in the reference
(``repro/models/rwkv.py``).  Attention-free: the decode state is two
token-shift vectors and one (H, hd, hd) wkv state per layer.

wkv6 per head (hd = head dim, keys and values of one width):

    S_t = diag(w_t) S_{t-1} + k_t^T v_t          # (hd, hd) state
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with ``w_t = exp(-exp(w0 + lora(x_t)))``, a per-channel, data-dependent
decay.

A prefill (``st=None``: the zero state) runs the recurrence through the
chunked kernel wrapper (``kernels/rwkv6.py``): the hand-written kernel on
the card, its plain block-form version on the CPU, for any S.  A step with
carried state (decode, S = 1) runs the per-step recurrence in torch ops, as
the reference's default ``"scan"`` does.  The casts follow the reference's:
r, k, v and the decay enter the wkv in float32, the group norm runs in
float32 and returns y's type, and the output projection takes y in x's
type.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.rwkv6 import rwkv6_chunked
from .common import ParamSpec, dense_spec


def rwkv_spec(d: int, f: int, n_heads: int, head_dim: int, lora: int) -> Dict[str, Dict[str, ParamSpec]]:
    di = n_heads * head_dim
    return {
        "time": {
            # token-shift interpolation coefficients for r, k, v, g, w
            "mu_r": ParamSpec((d,), (None,), torch.float32, "ones", 0.5),
            "mu_k": ParamSpec((d,), (None,), torch.float32, "ones", 0.5),
            "mu_v": ParamSpec((d,), (None,), torch.float32, "ones", 0.5),
            "mu_g": ParamSpec((d,), (None,), torch.float32, "ones", 0.5),
            "mu_w": ParamSpec((d,), (None,), torch.float32, "ones", 0.5),
            "w_r": dense_spec(d, di, ("embed", "heads")),
            "w_k": dense_spec(d, di, ("embed", "heads")),
            "w_v": dense_spec(d, di, ("embed", "heads")),
            "w_g": dense_spec(d, di, ("embed", "heads")),
            "w_o": dense_spec(di, d, ("heads", "embed")),
            # data-dependent decay: w0 + tanh(x A1) A2
            "w0": ParamSpec((di,), (None,), torch.float32, "decay"),
            "w_lora_a": dense_spec(d, lora, ("embed", None), torch.float32),
            "w_lora_b": dense_spec(lora, di, (None, "heads"), torch.float32),
            "u": ParamSpec((n_heads, head_dim), (None, None), torch.float32, "normal", 1.0),
            "ln_scale": ParamSpec((di,), (None,), torch.float32, "ones"),
            "ln_bias": ParamSpec((di,), (None,), torch.float32, "zeros"),
        },
        "channel": {
            "mu_k": ParamSpec((d,), (None,), torch.float32, "ones", 0.5),
            "mu_r": ParamSpec((d,), (None,), torch.float32, "ones", 0.5),
            "w_k": dense_spec(d, f, ("embed", "mlp")),
            "w_v": dense_spec(f, d, ("mlp", "embed")),
            "w_r": dense_spec(d, d, ("embed", "embed2")),
        },
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d); prev: (B, d), the token before x[:, 0].  Returns x
    shifted right by one along S with ``prev`` in slot 0."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _mix(x: torch.Tensor, x_prev: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    return x + (x_prev - x) * mu.to(x.dtype)


def _group_norm(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                n_heads: int) -> torch.Tensor:
    b, s, di = y.shape
    yh = y.reshape(b, s, n_heads, di // n_heads).float()
    mu = yh.mean(-1, keepdim=True)
    var = ((yh - mu) ** 2).mean(-1, keepdim=True)
    yh = (yh - mu) * torch.rsqrt(var + 64e-5)
    return (yh.reshape(b, s, di) * scale + bias).to(y.dtype)


def time_mix(
    p: nn.Module,
    x: torch.Tensor,
    st: Optional[Dict[str, torch.Tensor]],
    n_heads: int,
    head_dim: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (y, new shift (B, d), new wkv state (B, H, hd, hd)).
    ``st`` holds ``att_x`` and ``wkv``; ``None`` is the zero state of a
    prefill and takes the chunked kernel."""
    b, s, d = x.shape
    di = n_heads * head_dim
    prev = x.new_zeros(b, d) if st is None else st["att_x"]
    xs = _token_shift(x, prev)
    r = _mix(x, xs, p.mu_r) @ p.w_r
    k = _mix(x, xs, p.mu_k) @ p.w_k
    v = _mix(x, xs, p.mu_v) @ p.w_v
    g = _mix(x, xs, p.mu_g) @ p.w_g
    xw = _mix(x, xs, p.mu_w).float()
    lora = torch.tanh(xw @ p.w_lora_a) @ p.w_lora_b
    w = torch.exp(-torch.exp(p.w0 + lora))                  # (B, S, di) in (0, 1)

    rh, kh, vh = (t.reshape(b, s, n_heads, head_dim).float() for t in (r, k, v))
    wh = w.reshape(b, s, n_heads, head_dim)
    if st is None:
        y, wkv = rwkv6_chunked(rh.transpose(1, 2), kh.transpose(1, 2), vh.transpose(1, 2),
                               wh.transpose(1, 2), p.u)
        y = y.transpose(1, 2)                               # (B, S, H, hd)
    else:
        wkv = st["wkv"]
        ys = []
        for t in range(s):
            kv = kh[:, t, :, :, None] * vh[:, t, :, None, :]   # (B, H, hd, hd)
            ys.append(torch.einsum("bhk,bhkv->bhv", rh[:, t], wkv + p.u[None, :, :, None] * kv))
            wkv = wh[:, t, :, :, None] * wkv + kv
        y = torch.stack(ys, dim=1)
    y = _group_norm(y.reshape(b, s, di), p.ln_scale, p.ln_bias, n_heads)
    y = y * F.silu(g.float()).to(y.dtype)
    return y.to(x.dtype) @ p.w_o, x[:, -1, :], wkv


def channel_mix(p: nn.Module, x: torch.Tensor,
                prev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, new shift (B, d)); ``prev`` (B, d) is the token before
    x[:, 0]."""
    xs = _token_shift(x, prev)
    k = _mix(x, xs, p.mu_k) @ p.w_k
    k = torch.square(torch.relu(k.float())).to(x.dtype)
    r = torch.sigmoid((_mix(x, xs, p.mu_r) @ p.w_r).float()).to(x.dtype)
    return r * (k @ p.w_v), x[:, -1, :]

