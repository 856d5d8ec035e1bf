"""Flash attention forward — the LLM prefill's attention.

:func:`flash_attention_fwd` computes GQA attention over ``q (B, Hq, S, D)``
and ``k``/``v (B, Hkv, T, D)`` with the causal and sliding-window masks and
an optional tanh softcap: the function of the reference's Pallas kernel
``repro/kernels/flash_attention.py::flash_attention_fwd``.  Scores, the
softmax and the accumulation are float32 whatever the input type; the
output has q's type.

``return_lse=True`` also returns each row's float32 natural-log
log-sum-exp of its scaled, softcapped and masked scores, ``(B, Hq, S)``:
the statistics from which the training backward
(``repro_torch.models.attention._Flash``) recomputes the probabilities.

The kernel has no backward of its own: the wrapper refuses, on either
device, inputs that require a gradient while grad mode is on (its output
would carry none); ``_Flash`` calls it on detached inputs.

On a CUDA tensor it launches the hand-written kernel
(``csrc/flash_attention.cu``: D of 64, 128 or 160, any S and T; bfloat16 on
the tensor cores with TMA loads, float32 on the CUDA cores); on a CPU tensor
it runs :func:`flash_attention_plain`, the reference's ``attention_ref``
computation in PyTorch ops.  On a meta tensor it runs every check of the
card's branch (the TMA rule on strides only) and returns meta outputs of the
kernel's shapes and dtypes: the card's program, shapes only, which the dry
run (``launch/dryrun.py``) counts.  The choice follows the tensors' device
and nothing else.  On meta a call is one dispatcher op,
``repro_torch::flash_attention`` (:data:`OP`), whose only kernel, the Meta
one, allocates the outputs; :func:`op_cost` gives its flops and bytes.  On
the card the wrapper calls the launch directly: whether a dispatcher op
costs a call host time there is not resolved within the host's noise
(``tools/flash_op_ab.py``), so the launch keeps its direct route.

:func:`flash_attention_bwd` is the training backward of causal bfloat16
attention at head dim 64 (``csrc/flash_attention_bwd.cu``): ``_Flash.backward``
calls it for those inputs on the card and on meta tensors, and takes its
plain twin, ``repro_torch.models.attention._flash_bwd``, for every other
form and on the CPU.  It raises on what it does not take; on meta it is one
dispatcher op, ``repro_torch::flash_attention_bwd`` (:data:`OP_BWD`,
:func:`op_cost_bwd`), as the forward is.

Layout: the wrapper takes any strides whose last (head) dim is contiguous
and passes them to the kernel, so the model hands over ``(B, S, H, D)``
activations as ``(B, H, S, D)`` views without a copy; the output is
allocated in q's layout.  bfloat16 tensors must also meet the TMA rule of
:func:`check_tma_layout`; the wrapper raises on one that does not, and
never copies it.  float32 tensors have no such rule.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import cuda

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128, 160)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _mask(s: int, t: int, causal: bool, window: Optional[int], device) -> torch.Tensor:
    q_pos = torch.arange(s, device=device)[:, None]
    k_pos = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    return mask


def check_tma_layout(**tensors: torch.Tensor) -> None:
    """Raise ``ValueError`` unless every ``(B, H, S, D)`` tensor can be read
    by TMA: its base pointer 16-B aligned and its batch, head and position
    strides multiples of 16 B (a dimension of size 1 never moves, so its
    stride is free).  A meta tensor has no pointer: its strides are
    checked."""
    for name, x in tensors.items():
        if x.device.type != "meta" and x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name}'s base pointer is not 16-B aligned")
        for dim, what in enumerate(("batch", "head", "position")):
            if x.shape[dim] > 1 and (x.stride(dim) * x.element_size()) % 16:
                raise ValueError(f"flash_attention: {name}'s {what} stride of "
                                 f"{x.stride(dim)} elements is not a multiple of 16 B")


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    return_lse: bool = False,
):
    """Plain PyTorch attention: the whole ``(S, T)`` score matrix in
    float32, masked to -1e30, softmax, then ``p @ v`` (``ref.py::
    attention_ref``); with ``return_lse``, also ``logsumexp`` of the masked
    scores."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = hq // hkv
    kr = k.repeat_interleave(g, dim=1).float()
    vr = v.repeat_interleave(g, dim=1).float()
    scores = torch.einsum("bhsd,bhtd->bhst", q.float(), kr) / math.sqrt(d)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    mask = _mask(s, t, causal, window, q.device)
    scores = scores.masked_fill(~mask[None, None], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", p, vr).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(scores, dim=-1)
    return out


def _check_kernel_inputs(q, k, v, window, softcap) -> None:
    """What the kernel takes, checked alike on the card and on meta: one
    float type, head dim 64, 128 or 160, contiguous head dims, a positive
    window and softcap, and bfloat16's TMA rule."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    d = q.shape[3]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes head dim 64, 128 or 160, not {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"flash_attention: {name}'s head dim must be contiguous")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, not {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention: softcap must be positive, not {softcap}")
    if q.dtype == torch.bfloat16:      # every bf16 head dim runs the TMA kernel
        check_tma_layout(q=q, k=k, v=v)


def _outputs(q, return_lse: bool):
    """The kernel's outputs, allocated in q's layout; ``lse`` only when it
    is asked for."""
    out = torch.empty_like(q)
    if out.stride(3) != 1:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    b, hq, s, _ = q.shape
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device) if return_lse else None
    return out, lse


def _launch(q, k, v, causal, window, softcap, return_lse):
    """One launch on checked inputs (``window`` and ``softcap`` 0 for
    none); returns ``(out, lse or None)``."""
    out, lse = _outputs(q, return_lse)
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    dev = q.device
    meta = (ctypes.c_longlong * 17)(
        b, hq, hkv, s, t,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
    )
    err = cuda.lib().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), meta,
        _DTYPES[q.dtype], d, int(causal), window, softcap, 1.0 / math.sqrt(d), dev.index,
        cuda.current_stream(dev.index),
    )
    cuda.check(err, "flash_attention")
    cuda.count_launch("flash_attention")
    return out, lse


def _meta(q, k, v, causal, window, softcap, return_lse):
    """The outputs' shapes and dtypes, nothing launched; the op's schema
    returns two tensors, so an empty ``lse`` when none is asked for."""
    out, lse = _outputs(q, return_lse)
    return out, q.new_empty((0,), dtype=torch.float32) if lse is None else lse


OP = cuda.define_op(
    "flash_attention",
    "(Tensor q, Tensor k, Tensor v, bool causal, int window, float softcap, bool return_lse)"
    " -> (Tensor, Tensor)",
    _meta)


def attention_pairs(s: int, t: int, window: Optional[int], causal: bool = True) -> int:
    """Unmasked (query, key) pairs of one (batch row, head): the work the
    mask leaves.  Query i sees keys j < t with j <= i when causal and
    i - j < window when windowed (positions from 0 on both sides, as the
    kernel masks)."""
    q = np.arange(s, dtype=np.int64)
    hi = np.minimum(q, t - 1) if causal else np.full(s, t - 1, dtype=np.int64)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(s, dtype=np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def op_cost(q, k, v, causal, window, softcap, return_lse) -> Tuple[int, int]:
    """``(flops, bytes)`` of one kernel call, from the op's arguments:
    4·D flops per unmasked pair and head (the two products, QK and PV), and
    q, k and v read once, the output (and ``lse``) written once."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    flops = 4 * d * b * hq * attention_pairs(s, t, window or None, causal)
    nbytes = q.element_size() * (2 * b * hq * s * d + 2 * b * hkv * t * d)
    return flops, nbytes + (4 * b * hq * s if return_lse else 0)


def flash_attention_fwd(
    q: torch.Tensor,      # (B, Hq, S, D)
    k: torch.Tensor,      # (B, Hkv, T, D)
    v: torch.Tensor,      # (B, Hkv, T, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    return_lse: bool = False,
):
    """Attention forward; returns ``(B, Hq, S, D)`` in q's dtype, and with
    ``return_lse`` also the ``(B, Hq, S)`` float32 log-sum-exp."""
    cuda.refuse_grad("flash_attention", q, k, v)
    b, hq, s, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"flash_attention: {hq} query heads over {hkv} kv heads")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("flash_attention: q, k and v on different devices")
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, softcap=softcap,
                                     return_lse=return_lse)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: unsupported device {dev}")
    _check_kernel_inputs(q, k, v, window, softcap)
    args = (q, k, v, causal, int(window or 0), float(softcap or 0.0), return_lse)
    # on the card the launch is called directly: the op's dispatch costs host time
    out, lse = OP(*args) if dev.type == "meta" else _launch(*args)
    return (out, lse) if return_lse else out


BWD_HEAD_DIM = 64


def _check_bwd_inputs(q, k, v, lse, do, causal, window) -> None:
    """What the backward kernel takes: causal attention, bfloat16 q, k, v
    and do at head dim 64, S == T, whole groups of query heads, the
    forward's float32 ``(B, Hq, S)`` log-sum-exp, a positive window, and
    the forward's layout rules (contiguous head dims, TMA's alignment)."""
    if not causal:
        raise ValueError("flash_attention_bwd: the kernel takes causal attention only")
    if any(x.dtype != torch.bfloat16 for x in (q, k, v, do)):
        raise TypeError(f"flash_attention_bwd: q/k/v/do must be bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}, {do.dtype}")
    b, hq, s, d = q.shape
    if d != BWD_HEAD_DIM:
        raise ValueError(f"flash_attention_bwd: the kernel takes head dim {BWD_HEAD_DIM}, not {d}")
    hkv = k.shape[1]
    if (k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (s, d) or do.shape != q.shape
            or hq % hkv):
        raise ValueError(f"flash_attention_bwd: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, do {tuple(do.shape)} (S == T, whole head groups)")
    if lse.shape != (b, hq, s) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous float32 {(b, hq, s)}")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention_bwd: window must be positive, not {window}")
    if any(x.device != q.device for x in (k, v, lse, do)):
        raise ValueError("flash_attention_bwd: the inputs are on different devices")
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do)):
        if x.stride(3) != 1:
            raise ValueError(f"flash_attention_bwd: {name}'s head dim must be contiguous")
    check_tma_layout(q=q, k=k, v=v, do=do)


def _meta_bwd(q, k, v, lse, do, window):
    """dq, dk and dv's shapes and dtypes in q's, k's and v's layouts, nothing launched."""
    return tuple(torch.empty_like(x) for x in (q, k, v))


OP_BWD = cuda.define_op(
    "flash_attention_bwd",
    "(Tensor q, Tensor k, Tensor v, Tensor lse, Tensor do, int window) -> (Tensor, Tensor, Tensor)",
    _meta_bwd)


def op_cost_bwd(q, k, v, lse, do, window) -> Tuple[int, int]:
    """``(flops, bytes)`` of one backward call, from the op's arguments:
    10·D flops per unmasked pair and head (S, dP, dV, dK and dQ), and q, k,
    v, do and lse read once, dq, dk and dv written once."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    flops = 10 * d * b * hq * attention_pairs(s, s, window or None, True)
    return flops, q.element_size() * (3 * b * hq * s * d + 4 * b * hkv * s * d) + 4 * b * hq * s


def flash_attention_bwd(
    q: torch.Tensor,      # (B, Hq, S, D)
    k: torch.Tensor,      # (B, Hkv, S, D)
    v: torch.Tensor,      # (B, Hkv, S, D)
    lse: torch.Tensor,    # (B, Hq, S) float32, from flash_attention_fwd(..., return_lse=True)
    do: torch.Tensor,     # (B, Hq, S, D): the output's gradient
    *,
    causal: bool = True,
    window: Optional[int] = None,
):
    """dq, dk and dv of causal attention, in q's, k's and v's layouts and
    bfloat16: ``_flash_bwd``'s function (each row's normaliser and ``dsum``
    from the recomputed scores), computed by the two launches of
    ``csrc/flash_attention_bwd.cu``; on meta tensors, :data:`OP_BWD`'s
    outputs.  Raises on any input the kernel does not take, and on the CPU."""
    _check_bwd_inputs(q, k, v, lse, do, causal, window)
    dev = q.device
    if dev.type == "meta":
        return OP_BWD(q, k, v, lse, do, int(window or 0))
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_bwd: the kernel runs on the card, not on {dev}; "
                         f"the plain twin is repro_torch.models.attention._flash_bwd")
    b, hq, s, d = q.shape
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))     # dense inputs keep their strides
    inv = torch.empty((b, hq, s), dtype=torch.float32, device=dev)
    dsum = torch.empty_like(inv)
    meta = (ctypes.c_longlong * 25)(
        b, hq, k.shape[1], s,
        *(x.stride(i) for x in (q, k, v, do, dq, dk, dv) for i in range(3)),
    )
    err = cuda.lib().repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        inv.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), meta,
        int(window or 0), 1.0 / math.sqrt(d), dev.index, cuda.current_stream(dev.index),
    )
    cuda.check(err, "flash_attention_bwd")
    cuda.count_launch("flash_attention_bwd")
    return dq, dk, dv
