"""Gradient compression: per-chunk symmetric int8 quantization.

The counterpart of ``repro/parallel/compression.py``: gradients are
quantized to int8 with one float32 scale per chunk of 2048 values and
dequantized before the optimizer (``fake_quantize``), which models the
accuracy contract of 8-bit gradient exchange; ``ef_quantize`` carries the
quantization residual to the next step (error feedback).  The int8
all-reduce itself (``compressed_psum``) needs a mesh axis and waits for a
multi-card slice.
"""

from __future__ import annotations

from typing import Tuple

import torch
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
