"""Chunked selective scan — the hybrid LLM prefill's Mamba branch.

:func:`ssm_scan_chunked` runs the recurrence ``h_t = a_t h_{t-1} + dt_t
(x_t ⊗ B_t)``, ``y_t = C_t · h_t`` from a zero state in the SSD block form
of the reference's Pallas kernel ``repro/kernels/ssm_scan.py::
ssm_scan_chunked``: per chunk of 64 steps, with ``la = cumsum(log(max(a,
1e-30)))``,

    y[t]  = exp(la_t) (C_t · S_prev) + Σ_{s≤t} exp(la_t − la_s) (C_t · B_s) u_s
    S_new = exp(la_last) S_prev + Σ_s exp(la_last − la_s) u_s ⊗ B_s

where ``u = dt ⊙ x``.  Every exponent is a later-minus-earlier difference,
so it stays ≤ 0.  Returns ``y (B, H, S, P)`` in x's dtype and the final
state ``(B, H, P, N)`` in float32.

Any S is taken: a ragged tail is the reference's exact padding, ``dt = 0``
and ``decay = 1`` (so ``u = 0`` and the state is carried unchanged).

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/ssm_scan.cu``: chunk 64, N ≤ 32, x/B/C float32 or bfloat16 of one
type, dt and decay float32, any strides with a contiguous last dim), a
chunk-parallel scan in three device launches (chunk states, one pass over
the chunks for the state, then the outputs) through one float32 scratch of
``B·H·nc·(P·N + 1)`` elements for ``nc = ceil(S / 64)`` chunks; on a CPU
tensor it runs :func:`ssm_scan_chunked_plain`.  On a meta tensor it runs the
card's checks and returns meta outputs, launching nothing: one dispatcher
op, ``repro_torch::ssm_scan_chunked`` (:data:`OP`; on the card the wrapper
calls its launch directly, as the flash wrapper does); :func:`op_cost` gives
its flops and bytes.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import cuda

DEFAULT_CHUNK = 64
KERNEL_MAX_N = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ssm_scan_chunked_plain(
    x: torch.Tensor,       # (B, H, S, P)
    dt: torch.Tensor,      # (B, H, S)
    decay: torch.Tensor,   # (B, H, S)
    bmat: torch.Tensor,    # (B, S, N)
    cmat: torch.Tensor,    # (B, S, N)
    *,
    chunk: int = DEFAULT_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block form in PyTorch ops, one chunk at a time, after padding S
    to a multiple of ``chunk`` with ``dt = 0``, ``decay = 1`` and zero x,
    B and C."""
    b, h, s, p = x.shape
    n = bmat.shape[-1]
    pad = (-s) % chunk
    xf, dtf, af = x.float(), dt.float(), decay.float()
    bf, cf = bmat.float(), cmat.float()
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
        dtf = F.pad(dtf, (0, pad))
        af = F.pad(af, (0, pad), value=1.0)
        bf = F.pad(bf, (0, 0, 0, pad))
        cf = F.pad(cf, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    u = (dtf[..., None] * xf).reshape(b, h, nc, chunk, p)
    la_all = torch.log(torch.clamp_min(af, 1e-30)).reshape(b, h, nc, chunk)
    bc = bf.reshape(b, nc, chunk, n)
    cc = cf.reshape(b, nc, chunk, n)
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=x.device))
    state = torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        la = torch.cumsum(la_all[:, :, c], dim=-1)                       # (B,H,C)
        uc, bcc, ccc = u[:, :, c], bc[:, c], cc[:, c]
        y_state = torch.exp(la)[..., None] * torch.einsum("btn,bhpn->bhtp", ccc, state)
        cb = torch.einsum("btn,bsn->bts", ccc, bcc)                      # (B,C,C)
        rel = la[..., :, None] - la[..., None, :]                        # (B,H,t,s)
        m = torch.where(tri, torch.exp(rel), 0.0) * cb[:, None]
        y_intra = torch.einsum("bhts,bhsp->bhtp", m, uc)
        la_last = la[..., -1:]
        scaled_u = uc * torch.exp(la_last - la)[..., None]
        state = torch.exp(la_last)[..., None] * state + torch.einsum(
            "bhsp,bsn->bhpn", scaled_u, bcc)
        ys.append(y_state + y_intra)
    y = torch.cat(ys, dim=2)[:, :, :s]
    return y.to(x.dtype), state


def _check_kernel_inputs(x, dt, decay, bmat, cmat) -> None:
    """What the kernel takes, checked alike on the card and on meta."""
    if x.dtype not in _DTYPES or bmat.dtype != x.dtype or cmat.dtype != x.dtype:
        raise TypeError(f"ssm_scan: x/B/C must share float32 or bfloat16, got "
                        f"{x.dtype}, {bmat.dtype}, {cmat.dtype}")
    if dt.dtype != torch.float32 or decay.dtype != torch.float32:
        raise TypeError("ssm_scan: dt and decay must be float32")
    n = bmat.shape[-1]
    if not 1 <= n <= KERNEL_MAX_N:
        raise ValueError(f"ssm_scan: the kernel takes N in [1, {KERNEL_MAX_N}], not {n}")
    for name, t in (("x", x), ("B", bmat), ("C", cmat)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssm_scan: {name}'s last dim must be contiguous")


def _outputs(x, dt, decay, bmat, cmat):
    """y in x's layout and the float32 final state (the op's Meta kernel)."""
    b, h, _, p = x.shape
    y = torch.empty_like(x)
    if y.stride(-1) != 1:
        y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    return y, torch.empty((b, h, p, bmat.shape[-1]), dtype=torch.float32, device=x.device)


def _launch(x, dt, decay, bmat, cmat):
    """Three launches on checked inputs."""
    y, state = _outputs(x, dt, decay, bmat, cmat)
    b, h, s, p = x.shape
    n = bmat.shape[-1]
    dev = x.device
    # per chunk: its state contribution, then the state entering it; its decay
    nc = -(-s // DEFAULT_CHUNK)
    scratch = x.new_empty(b * h * nc * (p * n + 1), dtype=torch.float32)
    meta = (ctypes.c_longlong * 21)(
        b, h, s, p, n,
        x.stride(0), x.stride(1), x.stride(2),
        dt.stride(0), dt.stride(1), dt.stride(2),
        decay.stride(0), decay.stride(1), decay.stride(2),
        bmat.stride(0), bmat.stride(1),
        cmat.stride(0), cmat.stride(1),
        y.stride(0), y.stride(1), y.stride(2),
    )
    err = cuda.lib().repro_ssm_scan_chunked(
        x.data_ptr(), dt.data_ptr(), decay.data_ptr(), bmat.data_ptr(),
        cmat.data_ptr(), y.data_ptr(), state.data_ptr(), scratch.data_ptr(), meta,
        _DTYPES[x.dtype], dev.index, cuda.current_stream(dev.index),
    )
    cuda.check(err, "ssm_scan_chunked")
    cuda.count_launch("ssm_scan_chunked")
    return y, state


OP = cuda.define_op(
    "ssm_scan_chunked",
    "(Tensor x, Tensor dt, Tensor decay, Tensor bmat, Tensor cmat) -> (Tensor, Tensor)",
    _outputs)


def op_cost(x, dt, decay, bmat, cmat) -> Tuple[int, int]:
    """``(flops, bytes)`` of one kernel call: 5·P·N flops per step and head
    (the decay, the input's outer product and the add on the state, then
    y = C·h), x, dt, decay, B and C read once, y and the state written
    once."""
    b, h, s, p = x.shape
    n = bmat.shape[-1]
    esz = x.element_size()
    nbytes = 2 * esz * b * h * s * p + 2 * 4 * b * h * s + 2 * esz * b * s * n + 4 * b * h * p * n
    return 5 * b * h * s * p * n, nbytes


def ssm_scan_chunked(
    x: torch.Tensor,       # (B, H, S, P)
    dt: torch.Tensor,      # (B, H, S)
    decay: torch.Tensor,   # (B, H, S)   a_t = exp(-exp(A) dt_t) in (0, 1)
    bmat: torch.Tensor,    # (B, S, N)
    cmat: torch.Tensor,    # (B, S, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(y (B, H, S, P), final state (B, H, P, N))``."""
    cuda.refuse_grad("ssm_scan_chunked", x, dt, decay, bmat, cmat)
    b, h, s, p = x.shape
    n = bmat.shape[-1]
    if dt.shape != (b, h, s) or decay.shape != (b, h, s):
        raise ValueError(f"ssm_scan: dt {tuple(dt.shape)} / decay {tuple(decay.shape)} "
                         f"do not match x {tuple(x.shape)}")
    if bmat.shape != (b, s, n) or cmat.shape != (b, s, n):
        raise ValueError(f"ssm_scan: B {tuple(bmat.shape)} / C {tuple(cmat.shape)} "
                         f"do not match x {tuple(x.shape)}")
    dev = x.device
    if any(t.device != dev for t in (dt, decay, bmat, cmat)):
        raise ValueError("ssm_scan: inputs on different devices")
    if dev.type == "cpu":
        return ssm_scan_chunked_plain(x, dt, decay, bmat, cmat)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"ssm_scan: unsupported device {dev}")
    _check_kernel_inputs(x, dt, decay, bmat, cmat)
    return (OP if dev.type == "meta" else _launch)(x, dt, decay, bmat, cmat)
