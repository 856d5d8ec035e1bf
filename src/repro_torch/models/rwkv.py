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
the reference's default ``"scan"`` does.  Training differentiates the
recurrence through :class:`_Wkv6`: the same wrapper call forward, and the
gradient of the reference's block form (``_chunked_wkv``, ported here) by
autograd, batched over chunks (``ssm.chunk_scan_grads``).  The casts follow the reference's:
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
from .ssm import GROUP_BYTES, ChunkForm, _causal_tri, chunk_scan_grads, ordered_cumsum

WKV_CHUNK = 16      # the reference's time_mix chunk


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
    if st is None and torch.is_grad_enabled() and any(
            t.requires_grad for t in (rh, kh, vh, wh, p.u)):
        y, wkv = _Wkv6.apply(rh, kh, vh, wh, p.u)
    elif st is None:
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



# --- training: the reference's block form and the wkv6 backward ---------------

def _wkv_block_inputs(rh, kh, vh, wh, chunk):
    """r, k, v, the raw log-decays and their ordered cumsum per chunk, each
    as (B, nc, C, H, ·)."""
    b, s, h, kd = rh.shape
    nc = s // chunk
    shape5 = (b, nc, chunk, h, kd)
    lw_raw = torch.log(torch.clamp_min(wh, 1e-30)).reshape(shape5)
    return (rh.reshape(shape5), kh.reshape(shape5), vh.reshape(b, nc, chunk, h, vh.shape[-1]),
            lw_raw, ordered_cumsum(lw_raw))


def _wkv_chunk_y_state(S, r, lw_raw, lw):
    """A chunk's outputs from the state entering it (the reference's
    ``chunk_step``): r/lw (B, C, H, K), S (B, H, K, V)."""
    return torch.einsum("bchk,bhkv->bchv", r * torch.exp(lw - lw_raw), S)


def _wkv_chunk_y_intra(r, k, v, lw_raw, lw, u, tri, eye):
    """A chunk's outputs from its own inputs: v (B, C, H, V), u (H, K).
    Every exponent is a later-minus-earlier difference inside the chunk; the
    masked ones (s >= t) are taken at -inf, so the backward multiplies no 0
    by an overflowed exp."""
    rel = (lw - lw_raw)[:, :, None] - lw[:, None, :, :]                   # (B,t,s,H,K)
    decay = torch.exp(torch.where(tri[None, :, :, None, None], rel, float("-inf")))
    a = torch.einsum("bthk,bshk,btshk->btsh", r, k, decay)
    a_diag = torch.einsum("bchk,hk,bchk->bch", r, u, k)
    a = a + torch.where(eye[None, :, :, None], a_diag[:, :, None, :], 0.0)
    return torch.einsum("btsh,bshv->bthv", a, v)


def _wkv_chunk_decay(lw):
    """The factor by which a chunk carries the state entering it."""
    return torch.exp(lw[:, -1])[..., None]


def _wkv_chunk_state(S, k, v, lw):
    """The state leaving one chunk."""
    k_scaled = k * torch.exp(lw[:, -1:] - lw)
    return _wkv_chunk_decay(lw) * S + torch.einsum("bchk,bchv->bhkv", k_scaled, v)


def _chunked_wkv(rh, kh, vh, wh, u, S0, chunk):
    """The reference's block-form wkv6 (``repro/models/rwkv.py::
    _chunked_wkv``).  rh/kh/wh (B, S, H, K) float32, vh (B, S, H, V), u
    (H, K), S0 (B, H, K, V); S a multiple of ``chunk``.  Returns (y (B, S,
    H·V), the final state)."""
    b, s, h, _ = rh.shape
    r, k, v, lw_raw, lw = _wkv_block_inputs(rh, kh, vh, wh, chunk)
    tri, eye = _causal_tri(chunk, rh.device, -1), torch.eye(chunk, dtype=torch.bool, device=rh.device)
    S, ys = S0.float(), []
    for c in range(s // chunk):
        ins = (r[:, c], k[:, c], v[:, c], lw_raw[:, c], lw[:, c])
        ys.append(_wkv_chunk_y_state(S, ins[0], ins[3], ins[4])
                  + _wkv_chunk_y_intra(*ins, u, tri, eye))
        S = _wkv_chunk_state(S, ins[1], ins[2], ins[4])
    return torch.stack(ys, dim=1).reshape(b, s, -1), S


def _chunked_wkv_grad(rh, kh, vh, wh, u, dy, chunk: int = WKV_CHUNK):
    """Gradients of ``sum(y * dy)`` for y of :func:`_chunked_wkv` from a
    zero state, for r, k, v, w and u (dy: (B, S, H, V)): the block form's
    autograd (``ssm.chunk_scan_grads``, as many chunks at a time as keep
    their (B, C, C, H, K) decays within ``ssm.GROUP_BYTES``), then through
    the log-decays' cumsum to w.  A ragged S is padded as the kernel wrapper
    pads it (r = k = v = 0, w = 1, zero dy)."""
    b, s, h, kd = rh.shape
    vd = vh.shape[-1]
    pad = (-s) % chunk
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (rh, kh, vh, wh)]
        r_, k_, v_, w_ = leaves
        if pad:
            r_, k_, v_ = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r_, k_, v_))
            w_ = F.pad(w_, (0, 0, 0, 0, 0, pad), value=1.0)
        inputs = _wkv_block_inputs(r_, k_, v_, w_, chunk)
    tri, eye = _causal_tri(chunk, rh.device, -1), torch.eye(chunk, dtype=torch.bool, device=rh.device)
    form = ChunkForm(
        y_state=lambda st, r, k, v, lw_raw, lw: _wkv_chunk_y_state(st, r, lw_raw, lw),
        y_intra=lambda r, k, v, lw_raw, lw, uu: _wkv_chunk_y_intra(r, k, v, lw_raw, lw, uu, tri, eye),
        state=lambda st, r, k, v, lw_raw, lw: _wkv_chunk_state(st, k, v, lw),
        decay=lambda r, k, v, lw_raw, lw: _wkv_chunk_decay(lw))
    grads, (du,) = chunk_scan_grads(
        form, torch.zeros(b, h, kd, vd, dtype=torch.float32, device=rh.device),
        [t.detach() for t in inputs], [u.detach()],
        F.pad(dy.float(), (0, 0, 0, 0, 0, pad)).reshape(b, -1, chunk, h, vd),
        group=max(1, GROUP_BYTES // (b * chunk * chunk * h * kd * 4)))
    with torch.enable_grad():
        dr, dk, dv, dw = torch.autograd.grad(inputs, leaves, grads)
    return dr, dk, dv, dw, du


class _Wkv6(torch.autograd.Function):
    """wkv6 from a zero state with a backward: the forward is the kernel
    wrapper on detached inputs (the hand-written kernel on the card, its
    plain version on the CPU); r, k, v, w and u are saved and the backward
    is :func:`_chunked_wkv_grad`.  Takes and returns the model's layout: r,
    k, w (B, S, H, K), v (B, S, H, V), u (H, K) -> (y (B, S, H, V), the
    final state (B, H, K, V)).  The final state is returned without a
    gradient: training discards it."""

    @staticmethod
    def forward(ctx, rh, kh, vh, wh, u):
        y, S = rwkv6_chunked(*(t.detach().transpose(1, 2) for t in (rh, kh, vh, wh)), u.detach())
        ctx.save_for_backward(rh, kh, vh, wh, u)
        ctx.mark_non_differentiable(S)
        return y.transpose(1, 2), S

    @staticmethod
    def backward(ctx, dy, _dS):
        return _chunked_wkv_grad(*ctx.saved_tensors, dy)
