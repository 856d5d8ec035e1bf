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

Training differentiates the scan through :class:`_SsmScan`: its forward is
the same wrapper call, and its backward is the gradient of the reference's
model-level block form (``_chunked_selective_scan``, ported here) by
autograd, batched over chunks, with the state's gradient carried from the
last chunk to the first (:func:`chunk_scan_grads`).  The kernel has no backward of its
own, and the reference has none to port: its gradients come from JAX's AD
of that form.

State for decode: conv tail (B, cw-1, di) + ssm state (B, H, hd, N).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.ssm_scan import ssm_scan_chunked
from ..trace.span import ST_SCAN_BWD, TRACER
from .common import ParamSpec, dense_spec

SCAN_CHUNK = 64     # the reference's ssm_scan chunk


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

    if st is None and torch.is_grad_enabled() and any(
            t.requires_grad for t in (xh, dt, decay, bt, ct)):
        y, h_final = _SsmScan.apply(xh, dt, decay, bt, ct)
    elif st is None:
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


# --- training: the reference's block form and the scan's backward -------------

def ordered_cumsum(t: torch.Tensor) -> torch.Tensor:
    """The cumulative sum along dim 2 of ``(B, nc, C, ...)`` chunks, as C
    ordered adds over every chunk at once (``torch.cumsum`` on the card has
    no deterministic implementation)."""
    parts = [t[:, :, 0]]
    for i in range(1, t.shape[2]):
        parts.append(parts[-1] + t[:, :, i])
    return torch.stack(parts, dim=2)


def _causal_tri(c: int, device, diagonal: int = 0) -> torch.Tensor:
    return torch.tril(torch.ones(c, c, dtype=torch.bool, device=device), diagonal=diagonal)


def _ssm_chunk_y_state(h_prev, la, cc):
    """A chunk's outputs from the state entering it: la (B, C, H) the
    chunk's log-decay cumsum, cc (B, C, N), h_prev (B, H, P, N)."""
    return torch.exp(la)[..., None] * torch.einsum("bcn,bhpn->bchp", cc, h_prev)


def _ssm_chunk_y_intra(uc, la, bc, cc, tri):
    """A chunk's outputs from its own inputs: uc (B, C, H, P), bc (B, C, N).
    The masked (later-key) exponents are taken at -inf, so the backward
    multiplies no 0 by an overflowed exp."""
    cb = torch.einsum("btn,bsn->bts", cc, bc)                             # (B,C,C)
    rel = la[:, :, None, :] - la[:, None, :, :]                           # (B,t,s,H)
    m = torch.exp(torch.where(tri[None, :, :, None], rel, float("-inf"))) * cb[..., None]
    return torch.einsum("btsh,bshp->bthp", m, uc)


def _ssm_chunk_decay(la):
    """The factor by which a chunk carries the state entering it."""
    return torch.exp(la[:, -1, :])[:, :, None, None]


def _ssm_chunk_state(h_prev, uc, la, bc):
    """The state leaving one chunk."""
    scaled_u = uc * torch.exp(la[:, -1:, :] - la)[..., None]
    return _ssm_chunk_decay(la) * h_prev + torch.einsum("bchp,bcn->bhpn", scaled_u, bc)


def _ssm_block_inputs(xh, dt, decay, bt, ct, chunk):
    """u = dt x and the log-decays' ordered cumsum per chunk, with B and C,
    each as (B, nc, C, ...)."""
    b, s, h, p = xh.shape
    n, nc = bt.shape[-1], s // chunk
    u = (dt[..., None] * xh).reshape(b, nc, chunk, h, p)
    la = ordered_cumsum(torch.log(torch.clamp_min(decay, 1e-30)).reshape(b, nc, chunk, h))
    return u, la, bt.reshape(b, nc, chunk, n), ct.reshape(b, nc, chunk, n)


def _chunked_selective_scan(xh, dt, decay, bt, ct, h0, chunk):
    """The reference's SSD block form (``repro/models/ssm.py::
    _chunked_selective_scan``).  xh (B, S, H, P) float32; dt/decay (B, S, H);
    bt/ct (B, S, N); h0 (B, H, P, N); S a multiple of ``chunk``.  Returns (y
    (B, S, H, P), the final state)."""
    b, s, h, p = xh.shape
    u, la, bc, cc = _ssm_block_inputs(xh, dt, decay, bt, ct, chunk)
    tri = _causal_tri(chunk, xh.device)
    state, ys = h0.float(), []
    for c in range(s // chunk):
        ys.append(_ssm_chunk_y_state(state, la[:, c], cc[:, c])
                  + _ssm_chunk_y_intra(u[:, c], la[:, c], bc[:, c], cc[:, c], tri))
        state = _ssm_chunk_state(state, u[:, c], la[:, c], bc[:, c])
    return torch.stack(ys, dim=1).reshape(b, s, h, p), state


class ChunkForm(NamedTuple):
    """A chunked linear scan, chunk c taking the state S_c entering it and
    its inputs (slices of every chunked input, and the shared inputs) to

        y_c = y_state(S_c, *slices) + y_intra(*slices, *shared)
        S_{c+1} = state(S_c, *slices) = decay(*slices) * S_c + (a term free of S_c)
    """
    y_state: Callable
    y_intra: Callable
    state: Callable
    decay: Callable


GROUP_BYTES = 1 << 28    # the largest per-group tensor of the batched backward


def chunk_scan_grads(form: ChunkForm, state0, chunks, shared, dy, group: int):
    """The gradients of ``sum(y * dy)`` for a chunked scan ``form`` from
    ``state0`` over ``chunks`` ((B, nc, C, ...) each) and ``shared``; the
    final state is discarded (no gradient).  The states entering the chunks
    come first (a pass without a graph); then the gradient each state gets
    through its own chunk's outputs, for every chunk at once by autograd;
    then the state gradients, last chunk first, ``dS_c = (that gradient) +
    decay_c * dS_{c+1}``; then every chunk's input gradients by autograd of
    its outputs and of the state leaving it, ``group`` chunks at a time,
    folded into the batch.  Returns the gradients of ``chunks`` and of
    ``shared`` (summed over the chunks).  One ``scan_bwd`` span while
    the tracer is on."""
    b, nc = chunks[0].shape[:2]

    def fold(t):                    # (B, g, ...) -> (B·g, ...)
        return t.reshape(b * t.shape[1], *t.shape[2:])

    def unfold(t):
        return t.reshape(b, -1, *t.shape[1:])

    with TRACER.span(ST_SCAN_BWD, tokens=b * nc * chunks[0].shape[2]):
        with torch.no_grad():
            states = [state0]
            for c in range(nc - 1):
                states.append(form.state(states[-1], *(t[:, c] for t in chunks)))
            states = torch.stack(states, dim=1)                          # (B, nc, ...)
        with torch.enable_grad():
            s_leaf = states.detach().requires_grad_()
            y_state = form.y_state(fold(s_leaf), *(fold(t) for t in chunks))
            local = torch.autograd.grad(y_state, s_leaf, fold(dy))[0]
        with torch.no_grad():
            decay = unfold(form.decay(*(fold(t) for t in chunks)))
            d_next = torch.zeros_like(states)     # chunk c: the gradient of S_{c+1}
            acc = torch.zeros_like(states[:, 0])
            for c in range(nc - 1, 0, -1):
                acc = local[:, c] + decay[:, c] * acc
                d_next[:, c - 1] = acc
        grads = [torch.zeros_like(t) for t in chunks]
        shared_grads = [torch.zeros_like(t) for t in shared]
        for c0 in range(0, nc, group):
            c1 = min(c0 + group, nc)
            with torch.enable_grad():
                ins = [t[:, c0:c1].detach().requires_grad_() for t in chunks]
                sh = [t.detach().requires_grad_() for t in shared]
                flat, st = [fold(t) for t in ins], fold(states[:, c0:c1])
                outs = [form.y_state(st, *flat) + form.y_intra(*flat, *sh), form.state(st, *flat)]
                got = torch.autograd.grad(outs, ins + sh,
                                          [fold(dy[:, c0:c1]), fold(d_next[:, c0:c1])])
            for g, piece in zip(grads, got):
                g[:, c0:c1] = piece
            for g, piece in zip(shared_grads, got[len(ins):]):
                g += piece
    return grads, shared_grads


def _chunked_scan_grad(xh, dt, decay, bt, ct, dy, chunk: int = SCAN_CHUNK):
    """Gradients of ``sum(y * dy)`` for y of :func:`_chunked_selective_scan`
    from a zero state, for x, dt, decay, B and C: the block form's autograd
    (:func:`chunk_scan_grads`), then through dt x and the log-decays'
    cumsum to the inputs.  A ragged S is padded as the kernel wrapper pads
    it (dt = 0, decay = 1, zero x, B, C and dy)."""
    b, s, h, p = xh.shape
    pad = (-s) % chunk
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (xh, dt, decay, bt, ct)]
        x_, dt_, dec_, bt_, ct_ = leaves
        if pad:
            x_, bt_, ct_ = (F.pad(t, (0,) * (2 * t.dim() - 4) + (0, pad)) for t in (x_, bt_, ct_))
            dt_ = F.pad(dt_, (0, 0, 0, pad))
            dec_ = F.pad(dec_, (0, 0, 0, pad), value=1.0)
        inputs = _ssm_block_inputs(x_, dt_, dec_, bt_, ct_, chunk)
    tri = _causal_tri(chunk, xh.device)
    form = ChunkForm(
        y_state=lambda st, u, la, bc, cc: _ssm_chunk_y_state(st, la, cc),
        y_intra=lambda u, la, bc, cc: _ssm_chunk_y_intra(u, la, bc, cc, tri),
        state=lambda st, u, la, bc, cc: _ssm_chunk_state(st, u, la, bc),
        decay=lambda u, la, bc, cc: _ssm_chunk_decay(la))
    grads, _ = chunk_scan_grads(
        form, torch.zeros(b, h, p, bt.shape[-1], dtype=torch.float32, device=xh.device),
        [t.detach() for t in inputs], [],
        F.pad(dy.float(), (0, 0, 0, 0, 0, pad)).reshape(b, -1, chunk, h, p),
        group=max(1, GROUP_BYTES // (b * chunk * chunk * h * 4)))
    with torch.enable_grad():
        return torch.autograd.grad(inputs, leaves, grads)


class _SsmScan(torch.autograd.Function):
    """The selective scan from a zero state with a backward: the forward is
    the kernel wrapper on detached inputs (the hand-written kernel on the
    card, its plain version on the CPU); x, dt, decay, B and C are saved and
    the backward is :func:`_chunked_scan_grad`.  Takes and returns the
    model's layout: xh (B, S, H, P), dt/decay (B, S, H), B/C (B, S, N) ->
    (y (B, S, H, P), the final state (B, H, P, N)).  The final state is
    returned without a gradient: training discards it."""

    @staticmethod
    def forward(ctx, xh, dt, decay, bt, ct):
        y, h_final = ssm_scan_chunked(xh.detach().transpose(1, 2), dt.detach().transpose(1, 2),
                                      decay.detach().transpose(1, 2), bt.detach(), ct.detach())
        ctx.save_for_backward(xh, dt, decay, bt, ct)
        ctx.mark_non_differentiable(h_final)
        return y.transpose(1, 2), h_final

    @staticmethod
    def backward(ctx, dy, _dh):
        return _chunked_scan_grad(*ctx.saved_tensors, dy)
