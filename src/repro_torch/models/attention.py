"""Attention: GQA with causal/sliding-window masks for prefill, and
decode-time reads of a ring cache.

Shapes follow the reference (``repro/models/attention.py``): q (B, S, H, D);
k/v (B, T, Hkv, D).  Prefill attention (:func:`attend`) is the flash
attention kernel wrapper: on the card the hand-written kernel runs, on the
CPU its plain version.  The reference's pure-JAX variants (``masked_scan``,
``triangular``, ``flash``) compute the same function and are not separate
paths here.  Decode attention (:func:`decode_attend`) is plain torch ops,
as the reference computes it outside any kernel.

Training differentiates :func:`attend` through :class:`_Flash`, the
counterpart of the reference's ``custom_vjp`` ``_flash``: its forward is
the same kernel call, which also returns each row's log-sum-exp.  Its
backward is the reference's ``_flash_vjp_bwd`` (with each row's normaliser
and ``dsum`` recomputed in a first pass) in one of two forms, chosen by
what the inputs show (:func:`kernel_backward`): the hand-written kernel
``flash_attention_bwd`` for causal bfloat16 attention at head dim 64 on the
card (and on meta tensors, as the dispatcher op the dry run counts), and
its plain twin :func:`_flash_bwd`, torch ops in float32, for every other
form (float32, other head dims, the softcap, bidirectional and cross
attention) and on the CPU.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels.flash_attention import BWD_HEAD_DIM, flash_attention_bwd, flash_attention_fwd
from ..obs.metrics import REGISTRY
from ..trace.span import ST_FLASH_BWD, TRACER

NEG_INF = -1e30
CHUNK_K = 1024      # the backward's KV chunk (the reference's attend default)
# the backward's first-pass p and dp (float32) kept for its second pass.  8 GiB
# holds all of them at tinyllama-1.1b's training shape (8 x 2048, 32 heads:
# 6 GiB), hymba-1.5b's (4.7) and whisper-medium's encoder (2.1), so those
# recompute nothing; at mixtral-8x22b's 48 heads (9 GiB) the second KV chunk
# (3 GiB) is recomputed and its one-layer step peaks at 62.5 GiB of the 80-GB
# card.  It bounds what the backward adds over one pass whatever the shape.
BWD_CACHE_BYTES = 8 << 30


def _split_gqa(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def _softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def _flash_bwd(q, k, v, lse, do, causal: bool, window: Optional[int],
               softcap: Optional[float]):
    """The reference's ``_flash_vjp_bwd`` over KV chunks of ``CHUNK_K``:
    recompute the chunk's probabilities from the saved log-sum-exp, then
    ``dsum``, ``ds`` (times the softcap's derivative), dq, dk and dv, all in
    float32.  q and do are (B, S, H, D), k and v (B, T, Hkv, D), lse
    (B, H, S).  The reference differentiates the scaled q; the kernel takes
    q unscaled, so dq carries the scale once more.

    One change: the reference takes ``dsum`` as ``do · out`` with the
    forward's output, and the forward's log-sum-exp as each row's
    normaliser.  Here they come from the kernel, whose float32 sums run in
    another order, and the rows of ``ds`` then miss summing to zero by a
    residual that dq and the keys' gradient carry times the keys' (queries')
    common part: on whisper-medium's 1,500 bidirectional frames dq moved by
    7.2e-4 of its largest value (ROADMAP Queue C).  So a first pass over
    the chunks takes each row's own normaliser ``P = sum_j p_ij`` and
    ``sum_j p_ij dp_ij`` from the recomputed scores, and the second pass
    uses ``p / P`` and ``dsum = sum_j p_ij dp_ij / P``: every row of ``ds``
    sums to zero up to its own rounding, and ``out`` is not read.  The first
    pass keeps each chunk's p and dp for the second while their bytes fit
    in ``BWD_CACHE_BYTES`` (the rest are recomputed), so up to that size the
    two passes cost one's products.

    The work is laid out per KV head as (B, Hkv, G·S, D), the G query heads
    of a KV head stacked along the rows, so each product is one batched
    matrix product (dk and dv sum over the group inside it) and the
    elementwise passes run over contiguous (B, Hkv, G, S, c) scores.  Under
    a causal mask a chunk's rows before its first key have no unmasked
    score (their probabilities are exactly 0), so they are left out of its
    products."""
    b, s, h, d = q.shape
    t, n = k.shape[1], k.shape[2]
    g = h // n
    scale = 1.0 / math.sqrt(d)

    def heads(x):                 # (B, S, H, D) -> (B, Hkv, G, S, D) float32
        return x.transpose(1, 2).float().reshape(b, n, g, s, d)

    qf, dof = heads(q) * scale, heads(do)
    lse = lse.reshape(b, n, g, s)
    kf, vf = k.transpose(1, 2).float(), v.transpose(1, 2).float()   # (B, Hkv, T, D)
    q_pos = torch.arange(s, device=q.device)
    # (first key, last key + 1, first row with an unmasked score)
    chunks = [(j0, min(j0 + CHUNK_K, t), min(j0, s) if causal else 0) for j0 in range(0, t, CHUNK_K)]
    chunks = [c for c in chunks if c[2] < s]

    def chunk(j0, j1, lo, shift):
        """The chunk's rows lo.. as (B, Hkv, rows, D) q and do, its keys and
        values, exp(scores - shift) (B, Hkv, G, S - lo, c), dp and the
        softcap's derivative."""
        rows = (s - lo) * g
        qc = qf[:, :, :, lo:].reshape(b, n, rows, d)
        doc = dof[:, :, :, lo:].reshape(b, n, rows, d)
        kj, vj = kf[:, :, j0:j1], vf[:, :, j0:j1]
        sc = torch.matmul(qc, kj.transpose(-1, -2)).view(b, n, g, s - lo, j1 - j0)
        dcap = None
        if softcap is not None:
            th = torch.tanh(sc / softcap)
            dcap = 1.0 - th * th
            sc = softcap * th
        kv_pos = torch.arange(j0, j1, device=q.device)
        mask = torch.ones((s - lo, j1 - j0), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[lo:, None] >= kv_pos[None, :]
        if window is not None:
            mask &= q_pos[lo:, None] - kv_pos[None, :] < window
        p = sc.masked_fill_(~mask, NEG_INF).sub_(shift[..., lo:, None]).exp_()
        dp = torch.matmul(doc, vj.transpose(-1, -2)).view(b, n, g, s - lo, j1 - j0)
        return qc, doc, kj, vj, p, dp, dcap

    # pass 1: each row's normaliser and sum of p dp; a chunk's p and dp are
    # kept for pass 2 while they fit in BWD_CACHE_BYTES, else recomputed
    norm = torch.zeros((b, n, g, s), dtype=torch.float32, device=q.device)
    pdp = torch.zeros_like(norm)
    kept, cached = 0, []
    for j0, j1, lo in chunks:
        parts = chunk(j0, j1, lo, lse)
        p, dp = parts[4], parts[5]
        norm[..., lo:] += p.sum(-1)
        pdp[..., lo:] += (p * dp).sum(-1)
        size = sum(x.numel() * x.element_size() for x in parts[4:] if x is not None)
        if kept + size <= BWD_CACHE_BYTES:
            kept += size
        else:
            parts = None
        cached.append(parts)
    inv = 1.0 / norm
    dsum = pdp * inv
    dq = torch.zeros_like(qf)
    dk = torch.zeros((b, n, t, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for i, (j0, j1, lo) in enumerate(chunks):
        parts = cached[i] if cached[i] is not None else chunk(j0, j1, lo, lse)
        cached[i] = None                  # freed once this chunk is done
        qc, doc, kj, vj, p, dp, dcap = parts
        rows = (s - lo) * g
        p = p.mul_(inv[..., lo:, None])                       # normalized
        ds = dp.sub_(dsum[..., lo:, None]).mul_(p)
        if dcap is not None:
            ds = ds.mul_(dcap)
        ds, p = ds.view(b, n, rows, j1 - j0), p.view(b, n, rows, j1 - j0)
        dq[:, :, :, lo:] += torch.matmul(ds, kj).view(b, n, g, s - lo, d)
        dk[:, :, j0:j1] = torch.matmul(ds.transpose(-1, -2), qc)
        dv[:, :, j0:j1] = torch.matmul(p.transpose(-1, -2), doc)
    dq = (dq * scale).reshape(b, h, s, d).transpose(1, 2)
    return dq.to(q.dtype), dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)


def kernel_backward(device_type: str, dtype: torch.dtype, head_dim: int, causal: bool,
                    softcap: Optional[float], s: int, t: int) -> bool:
    """Whether :class:`_Flash`'s backward calls ``flash_attention_bwd``: on
    the card (and on meta, which counts the card's program), bfloat16, head
    dim 64, causal (any window), no softcap and S == T.  Every other input,
    and the CPU, takes :func:`_flash_bwd`."""
    return (device_type in ("cuda", "meta") and dtype == torch.bfloat16
            and head_dim == BWD_HEAD_DIM and causal and softcap is None and s == t)


class _Flash(torch.autograd.Function):
    """Attention with the flash backward: the forward is the kernel wrapper
    on detached inputs, returning the output and each row's log-sum-exp;
    q, k, v and the log-sum-exp are saved; the backward is the kernel
    ``flash_attention_bwd`` where :func:`kernel_backward` says so, else
    :func:`_flash_bwd`, inside one ``flash_bwd`` span while the tracer is
    on, which also counts ``llm.attn.bwd_calls`` and, on the kernel,
    ``llm.attn.bwd_kernel``.  Inputs and output are (B, S, H, D)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = flash_attention_fwd(
            q.detach().transpose(1, 2), k.detach().transpose(1, 2), v.detach().transpose(1, 2),
            causal=causal, window=window, softcap=softcap, return_lse=True,
        )
        ctx.save_for_backward(q, k, v, lse)
        ctx.causal, ctx.window, ctx.softcap = causal, window, softcap
        return out.transpose(1, 2)

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        b, s, _, d = q.shape
        kernel = kernel_backward(q.device.type, q.dtype, d, ctx.causal, ctx.softcap, s, k.shape[1])
        with TRACER.span(ST_FLASH_BWD, tokens=b * s):
            if kernel:
                dq, dk, dv = flash_attention_bwd(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), lse,
                    do.contiguous().transpose(1, 2), causal=True, window=ctx.window)
                dq, dk, dv = dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)
            else:
                dq, dk, dv = _flash_bwd(q, k, v, lse, do, ctx.causal, ctx.window, ctx.softcap)
        if TRACER.enabled:
            REGISTRY.count("llm.attn.bwd_calls")
            if kernel:
                REGISTRY.count("llm.attn.bwd_kernel")
        return dq, dk, dv, None, None, None


def attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Full-sequence attention (prefill and training): (B, S, H, D) out in
    v's dtype.  With grad mode on and an input that requires a gradient it
    runs through :class:`_Flash`; otherwise it calls the kernel wrapper.

    The kernel scales q in float32 (as the TPU kernel does), where the
    reference's model path scales it in q's dtype first; for the power-of-two
    scales of D = 16 and D = 64 the two are the same."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Flash.apply(q, k, v, causal, window, logit_softcap).to(v.dtype)
    out = flash_attention_fwd(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, softcap=logit_softcap,
    )
    return out.transpose(1, 2).to(v.dtype)


def attend_bidir(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bidirectional attention (encoder / cross-attention)."""
    return attend(q, k, v, causal=False)


def decode_attend(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    valid: torch.Tensor,
    *,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Single-step decode attention against a cache.

    q: (B, 1, H, D); caches: (B, W, Hkv, D); ``valid``: (W,) bool, the
    slots that take part."""
    b, _, h, d = q.shape
    n_kv = k_cache.shape[2]
    scale = 1.0 / math.sqrt(d)
    qg = _split_gqa(q, n_kv)[:, 0] * scale                     # (B, n_kv, G, D)
    scores = torch.einsum("bngd,bcnd->bngc", qg.float(), k_cache.float())
    scores = _softcap(scores, logit_softcap)
    scores = scores.masked_fill(~valid[None, None, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngc,bcnd->bngd", p, v_cache.float())
    return out.reshape(b, 1, n_kv * (h // n_kv), d).to(v_cache.dtype)
