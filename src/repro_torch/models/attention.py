"""Attention: GQA with causal/sliding-window masks for prefill, and
decode-time reads of a ring cache.

Shapes follow the reference (``repro/models/attention.py``): q (B, S, H, D);
k/v (B, T, Hkv, D).  Prefill attention (:func:`attend`) is the flash
attention kernel wrapper: on the card the hand-written kernel runs, on the
CPU its plain version.  The reference's pure-JAX variants (``masked_scan``,
``triangular``, ``flash``) compute the same function and are not separate
paths here.  Decode attention (:func:`decode_attend`) is plain torch ops,
as the reference computes it outside any kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels.flash_attention import flash_attention_fwd

NEG_INF = -1e30


def _split_gqa(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def _softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Full-sequence attention (prefill): (B, S, H, D) out in v's dtype.

    The kernel scales q in float32 (as the TPU kernel does), where the
    reference's model path scales it in q's dtype first; for the power-of-two
    scales of D = 16 and D = 64 the two are the same."""
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
