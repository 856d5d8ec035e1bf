"""Chunked wkv6 — the RWKV6 ("Finch") prefill's time-mix recurrence.

:func:`rwkv6_chunked` runs, from a zero state,

    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t);   S_t = diag(w_t) S_{t-1} + k_t^T v_t

in the block form of the reference's Pallas kernel ``repro/kernels/
rwkv6.py::rwkv6_chunked``: per chunk of 32 steps, with ``Λ = cumsum(log
max(w, 1e-30))`` along the chunk and ``Λ̄ = Λ − log max(w, 1e-30)``,

    y[t]   = (r_t ⊙ exp(Λ̄_t)) · S_prev + Σ_s A[t, s] v_s
    A[t,s] = Σ_k r_tk k_sk exp(Λ̄_tk − Λ_sk)  (s < t),   A[t,t] = Σ_k r_tk u_k k_tk
    S_new  = diag(exp(Λ_last)) S_prev + Σ_s (k_s ⊙ exp(Λ_last − Λ_s))^T v_s

Every exponent is a later-minus-earlier difference, so it stays ≤ 0 under
any decay; the form is never factored as ``exp(Λ)·exp(−Λ)``, which
overflows when the decay is strong.  Returns ``y (B, H, S, V)`` in v's
dtype and the final state ``(B, H, K, V)`` in float32.

Any S is taken: a ragged tail is padded with r = k = v = 0 and w = 1 (log
decay 0), which leaves y and the state exactly unchanged.

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/rwkv6.cu``: inner chunk 32, K and V in [1, 64], r/k/v float32 or
bfloat16 of one type, w and u float32, any strides with a contiguous last
dim), a chunk-parallel scan in three device launches over state chunks of
``STATE_CHUNK`` = 128 steps (each state chunk's own state contribution and
decay, one pass over the state chunks for the state entering each, then
the outputs) through one float32 scratch of ``B·H·nc·(K·V + K)`` elements
for ``nc = ceil(S / 128)``; on a CPU tensor it runs
:func:`rwkv6_chunked_plain`.  On a meta tensor it runs the card's checks and
returns meta outputs, launching nothing: one dispatcher op,
``repro_torch::rwkv6_chunked`` (:data:`OP`; on the card the wrapper calls
its launch directly, as the flash wrapper does); :func:`op_cost` gives its
flops and bytes.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import cuda

CHUNK = 32
STATE_CHUNK = 128      # steps per state chunk of the kernel (kL in csrc/rwkv6.cu)
KERNEL_MAX_DIM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rwkv6_chunked_plain(
    r: torch.Tensor,       # (B, H, S, K)
    k: torch.Tensor,       # (B, H, S, K)
    v: torch.Tensor,       # (B, H, S, V)
    w: torch.Tensor,       # (B, H, S, K)   per-channel decay in (0, 1)
    u: torch.Tensor,       # (H, K)         bonus
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block form in PyTorch ops, one chunk of ``CHUNK`` steps at a
    time, after padding S to a multiple of it with r = k = v = 0 and log
    w = 0."""
    b, h, s, kd = r.shape
    vd = v.shape[-1]
    pad = (-s) % CHUNK
    rf, kf, vf = r.float(), k.float(), v.float()
    lraw = torch.log(torch.clamp_min(w.float(), 1e-30))
    if pad:
        rf, kf, vf, lraw = (F.pad(t, (0, 0, 0, pad)) for t in (rf, kf, vf, lraw))
    nc = (s + pad) // CHUNK
    rc, kc, lc = (t.reshape(b, h, nc, CHUNK, kd) for t in (rf, kf, lraw))
    vc = vf.reshape(b, h, nc, CHUNK, vd)
    uf = u.float()[None, :, None, :]                                     # (1,H,1,K)
    dev = r.device
    tri = torch.tril(torch.ones(CHUNK, CHUNK, dtype=torch.bool, device=dev), diagonal=-1)
    eye = torch.eye(CHUNK, dtype=torch.bool, device=dev)
    state = torch.zeros(b, h, kd, vd, dtype=torch.float32, device=dev)
    ys = []
    for c in range(nc):
        rr, kk, vv, lr = rc[:, :, c], kc[:, :, c], vc[:, :, c], lc[:, :, c]
        lw = torch.cumsum(lr, dim=2)                                     # (B,H,C,K)
        lw_excl = lw - lr
        y_state = (rr * torch.exp(lw_excl)) @ state                      # (B,H,C,V)
        rel = lw_excl[:, :, :, None, :] - lw[:, :, None, :, :]           # (B,H,t,s,K)
        decay = torch.where(tri[:, :, None], torch.exp(rel), 0.0)
        a = (rr[:, :, :, None, :] * kk[:, :, None, :, :] * decay).sum(-1)
        a_diag = (rr * uf * kk).sum(-1)                                  # (B,H,C)
        a = a + torch.where(eye, a_diag[..., None], 0.0)
        y_intra = a @ vv
        lw_last = lw[:, :, -1:, :]                                       # (B,H,1,K)
        k_scaled = kk * torch.exp(lw_last - lw)
        state = torch.exp(lw_last).transpose(-1, -2) * state + k_scaled.transpose(-1, -2) @ vv
        ys.append(y_state + y_intra)
    y = torch.cat(ys, dim=2)[:, :, :s]
    return y.to(v.dtype), state


def _check_kernel_inputs(r, k, v, w, u) -> None:
    """What the kernel takes, checked alike on the card and on meta."""
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"rwkv6: r/k/v must share float32 or bfloat16, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError("rwkv6: w and u must be float32")
    kd, vd = r.shape[-1], v.shape[-1]
    if not (1 <= kd <= KERNEL_MAX_DIM and 1 <= vd <= KERNEL_MAX_DIM):
        raise ValueError(f"rwkv6: the kernel takes K and V in [1, {KERNEL_MAX_DIM}], "
                         f"not K={kd}, V={vd}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.stride(-1) != 1:
            raise ValueError(f"rwkv6: {name}'s last dim must be contiguous")


def _outputs(r, k, v, w, u):
    """y in v's layout and the float32 final state (the op's Meta kernel)."""
    b, h, _, kd = r.shape
    y = torch.empty_like(v)
    if y.stride(-1) != 1:
        y = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    return y, torch.empty((b, h, kd, v.shape[-1]), dtype=torch.float32, device=v.device)


def _launch(r, k, v, w, u):
    """Three launches on checked inputs (``u`` contiguous)."""
    y, state = _outputs(r, k, v, w, u)
    b, h, s, kd = r.shape
    vd = v.shape[-1]
    dev = r.device
    # per state chunk: its state contribution, then the state entering it; its decay
    nc = -(-s // STATE_CHUNK)
    scratch = r.new_empty(b * h * nc * (kd * vd + kd), dtype=torch.float32)
    meta = (ctypes.c_longlong * 20)(
        b, h, s, kd, vd,
        r.stride(0), r.stride(1), r.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        w.stride(0), w.stride(1), w.stride(2),
        y.stride(0), y.stride(1), y.stride(2),
    )
    err = cuda.lib().repro_rwkv6_chunked(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        y.data_ptr(), state.data_ptr(), scratch.data_ptr(), meta, _DTYPES[r.dtype], dev.index,
        cuda.current_stream(dev.index),
    )
    cuda.check(err, "rwkv6_chunked")
    cuda.count_launch("rwkv6_chunked")
    return y, state


OP = cuda.define_op(
    "rwkv6_chunked",
    "(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u) -> (Tensor, Tensor)",
    _outputs)


def block_flops(b: int, h: int, s: int, kd: int, vd: int, c: int = CHUNK) -> int:
    """The block form's flops at chunk c: per chunk and head, the state
    term and the state update (2cKV each), A's lower triangle (4 per pair
    and channel: the exponent's difference, two products, the sum; the exp
    aside) and diagonal (3 per channel), and A v over s <= t; chunks
    counted as s / c, the steps this input has."""
    per_chunk = 4 * c * kd * vd + 2 * c * (c - 1) * kd + 3 * c * kd + c * (c + 1) * vd
    return int(b * h * per_chunk * s / c)


def op_cost(r, k, v, w, u) -> Tuple[int, int]:
    """``(flops, bytes)`` of one kernel call: :func:`block_flops`, and r,
    k, v, w and u read once, y and the state written once."""
    b, h, s, kd = r.shape
    vd = v.shape[-1]
    esz = r.element_size()
    nbytes = (esz * b * h * s * (2 * kd + 2 * vd) + 4 * b * h * s * kd + 4 * h * kd
              + 4 * b * h * kd * vd)
    return block_flops(b, h, s, kd, vd), nbytes


def rwkv6_chunked(
    r: torch.Tensor,       # (B, H, S, K)
    k: torch.Tensor,       # (B, H, S, K)
    v: torch.Tensor,       # (B, H, S, V)
    w: torch.Tensor,       # (B, H, S, K)
    u: torch.Tensor,       # (H, K)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(y (B, H, S, V), final state (B, H, K, V))``."""
    cuda.refuse_grad("rwkv6_chunked", r, k, v, w, u)
    b, h, s, kd = r.shape
    vd = v.shape[-1]
    if k.shape != r.shape or w.shape != r.shape or v.shape != (b, h, s, vd):
        raise ValueError(f"rwkv6: r {tuple(r.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"w {tuple(w.shape)} do not match")
    if u.shape != (h, kd):
        raise ValueError(f"rwkv6: u {tuple(u.shape)} is not (H, K) = {(h, kd)}")
    dev = r.device
    if any(t.device != dev for t in (k, v, w, u)):
        raise ValueError("rwkv6: inputs on different devices")
    if dev.type == "cpu":
        return rwkv6_chunked_plain(r, k, v, w, u)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"rwkv6: unsupported device {dev}")
    _check_kernel_inputs(r, k, v, w, u)
    return (OP if dev.type == "meta" else _launch)(r, k, v, w, u.contiguous())
