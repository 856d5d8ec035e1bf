"""Gradient compression: per-chunk symmetric int8 quantization.

The counterpart of ``repro/parallel/compression.py``: gradients are
quantized to int8 with one float32 scale per chunk of 2048 values and
dequantized before the optimizer (``fake_quantize``), which models the
accuracy contract of 8-bit gradient exchange; ``ef_quantize`` carries the
quantization residual to the next step (error feedback).
``compressed_psum`` is the int8 all-reduce itself, over one axis of a
``DeviceMesh``: quantize, reduce the int8 payload against a shared scale,
rescale.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..tree import tree_map

CHUNK = 2048


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-chunk symmetric int8 quantization.  Returns ``(q (n, CHUNK)
    int8, scales (n, 1) float32)``; the tail chunk is zero-padded."""
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % CHUNK
    if pad:
        flat = F.pad(flat, (0, pad))
    chunks = flat.reshape(-1, CHUNK)
    scale = chunks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(chunks / torch.clamp(scale, min=1e-12)), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape, dtype) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape).to(dtype)


def fake_quantize(x: torch.Tensor) -> torch.Tensor:
    q, s = quantize(x)
    return dequantize(q, s, x.shape, x.dtype)


def fake_quantize_tree(tree):
    return tree_map(fake_quantize, tree)


def ef_quantize(x: torch.Tensor, err: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback quantization: returns (quantized value, new residual)."""
    y = x.float() + err.float()
    yq = fake_quantize(y)
    return yq.to(x.dtype), (y - yq).to(err.dtype)


def compressed_psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks along ``axis`` of ``mesh``, reduced
    as int8 values: quantize, then on ``axis``'s process group take the max
    of each chunk's scale, requantize the payload against it and sum it as
    int32, and rescale.  Scales are reduced with max (conservative) so
    dequantization stays within range after summation.  Every rank of the
    group gets the same result."""
    group = mesh.get_group(axis)
    q, s = quantize(x)
    s_max = s.clone()
    dist.all_reduce(s_max, op=dist.ReduceOp.MAX, group=group)
    # requantize against the shared scale so the int8 payload is summable
    req = torch.clamp(torch.round(q.float() * s / torch.clamp(s_max, min=1e-12)),
                      -127, 127).to(torch.int32)
    dist.all_reduce(req, op=dist.ReduceOp.SUM, group=group)
    flat = (req.float() * s_max).reshape(-1)
    return flat[:x.numel()].reshape(x.shape).to(x.dtype)
