"""Pure-numpy oracles for every kernel (small-shape exact references).

The OLTP oracles take and return numpy arrays.  The LLM oracles
(:func:`attention_ref`, :func:`ssm_scan_ref`, :func:`rwkv6_ref`) take the
kernels' CPU tensors, compute in float32 numpy the naive way (the whole
score matrix; one step at a time), and return tensors: outputs in the
input's dtype, states in float32, as the reference's ``ref.py`` does."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch


def scatter_max_ref(
    image_ssn: np.ndarray,  # (S,) int, -1 = empty slot
    image_pos: np.ndarray,  # (S,) int, -1 = checkpoint value
    key_id: np.ndarray,     # (W,) int
    ssn: np.ndarray,        # (W,) int
    pos: np.ndarray,        # (W,) int
) -> Tuple[np.ndarray, np.ndarray]:
    """Sequential oracle for the SSN-guarded scatter-max: per slot keep the
    max-SSN write, breaking SSN ties toward the smallest replay position
    (the checkpoint image sits at pos -1 and so wins its ties — exactly the
    scalar replay's strict ``ssn > image.ssn`` guard)."""
    out_ssn = np.array(image_ssn, dtype=np.int64)
    out_pos = np.array(image_pos, dtype=np.int64)
    for k, s, p in zip(key_id, ssn, pos):
        if s > out_ssn[k] or (s == out_ssn[k] and p < out_pos[k]):
            out_ssn[k] = s
            out_pos[k] = p
    return out_ssn.astype(image_ssn.dtype), out_pos.astype(image_pos.dtype)


def seg_reduce_ref(
    key_id: np.ndarray,   # (W,) int slot id per item
    val: np.ndarray,      # (W,) int value per item
    n_slots: int,
    op: str = "max",
) -> np.ndarray:
    """Sequential oracle for the batched-OCC segmented reduce: per slot the
    max (or min) value among items with that key; slots with no member stay
    at the identity (-1 for max, int32-max ``NO_WRITER`` for min)."""
    init = np.iinfo(np.int32).max if op == "min" else -1
    out = np.full(n_slots, init, dtype=np.int64)
    for k, v in zip(key_id, val):
        if op == "min":
            if v < out[k]:
                out[k] = v
        elif v > out[k]:
            out[k] = v
    return out.astype(np.int32)


def _f32(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().numpy()


def attention_ref(
    q: torch.Tensor,   # (B, Hq, S, D)
    k: torch.Tensor,   # (B, Hkv, T, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """GQA attention over the whole (S, T) score matrix: scaled scores, the
    tanh softcap, masked scores at -1e30, softmax, then ``p @ v``."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    kr = np.repeat(_f32(k), hq // hkv, axis=1)
    vr = np.repeat(_f32(v), hq // hkv, axis=1)
    scores = np.einsum("bhsd,bhtd->bhst", _f32(q), kr) / np.float32(math.sqrt(d))
    if softcap is not None:
        scores = np.float32(softcap) * np.tanh(scores / np.float32(softcap))
    q_pos, k_pos = np.arange(s)[:, None], np.arange(t)[None, :]
    mask = np.ones((s, t), bool)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    scores = np.where(mask, scores, np.float32(-1e30))
    p = np.exp(scores - scores.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    return torch.from_numpy(np.einsum("bhst,bhtd->bhsd", p, vr)).to(q.dtype)


def ssm_scan_ref(
    x: torch.Tensor,       # (B, H, S, P)   inputs per head
    dt: torch.Tensor,      # (B, H, S)      softplus'd step sizes
    decay: torch.Tensor,   # (B, H, S)      exp(-exp(A) dt) in (0, 1)
    bmat: torch.Tensor,    # (B, S, N)
    cmat: torch.Tensor,    # (B, S, N)
    h0: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive selective scan: h_t = a_t h + dt_t x_t ⊗ B_t ; y_t = h_t · C_t."""
    b, h, s, p = x.shape
    n = bmat.shape[-1]
    xf, dtf, af, bf, cf = (_f32(a) for a in (x, dt, decay, bmat, cmat))
    hh = np.zeros((b, h, p, n), np.float32) if h0 is None else _f32(h0)
    ys = []
    for t in range(s):
        upd = (dtf[:, :, t, None] * xf[:, :, t])[..., None] * bf[:, None, t, None, :]
        hh = af[:, :, t, None, None] * hh + upd
        ys.append(np.einsum("bhpn,bn->bhp", hh, cf[:, t]))
    return torch.from_numpy(np.stack(ys, axis=2)).to(x.dtype), torch.from_numpy(hh)


def rwkv6_ref(
    r: torch.Tensor,   # (B, H, S, K)
    k: torch.Tensor,   # (B, H, S, K)
    v: torch.Tensor,   # (B, H, S, V)
    w: torch.Tensor,   # (B, H, S, K)   per-channel decay in (0, 1)
    u: torch.Tensor,   # (H, K)         bonus
    s0: Optional[torch.Tensor] = None,  # (B, H, K, V)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive wkv6: y_t = r_t (S_{t-1} + u ⊙ k_t^T v_t); S_t = w_t S_{t-1} + k_t^T v_t."""
    b, h, s, kd = r.shape
    rf, kf, vf, wf, uf = (_f32(a) for a in (r, k, v, w, u))
    st = np.zeros((b, h, kd, v.shape[-1]), np.float32) if s0 is None else _f32(s0)
    ys = []
    for t in range(s):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        ys.append(np.einsum("bhk,bhkv->bhv", rf[:, :, t], st + uf[None, :, :, None] * kv))
        st = wf[:, :, t, :, None] * st + kv
    return torch.from_numpy(np.stack(ys, axis=2)).to(v.dtype), torch.from_numpy(st)
