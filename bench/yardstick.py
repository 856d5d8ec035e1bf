"""The benchmark's own arithmetic: the chip's peaks and the operations and
bytes of a step, a call and a kernel call, from shapes alone.

Frozen copies, so that a change to the program cannot move the yardstick:
``attention_pairs``, the flash ``op_cost`` and ``op_cost_bwd`` of
``src/repro_torch/kernels/flash_attention.py``, the scan's ``op_cost`` of
``src/repro_torch/kernels/ssm_scan.py``, and ``chip_smoke.py``'s
``_train_flops`` with one change: the input embedding (a lookup, no
product) is not among the 6·N weights unless the head shares it.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at its 700-W limit
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
HBM_BYTES_PER_S = 3.35e12

# weights used as a product's operand (the rest are lookups, scales, biases
# and the conv's taps)
PRODUCT_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "router", "in_proj",
                   "gate_proj", "dt_proj", "b_proj", "c_proj", "out_proj", "unembed")
ESIZE = {"bf16": 2, "fp32": 4}


def attention_pairs(s: int, t: int, window: Optional[int], causal: bool = True) -> int:
    """Unmasked (query, key) pairs of one (batch row, head): query i sees
    keys j < t with j <= i when causal and i - j < window when windowed."""
    q = np.arange(s, dtype=np.int64)
    hi = np.minimum(q, t - 1) if causal else np.full(s, t - 1, dtype=np.int64)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(s, dtype=np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_cost(b, hq, hkv, s, t, d, esize, causal, window, return_lse):
    """``(flops, bytes)`` of one flash forward: 4·D flops a pair and head;
    q, k and v read once, the output (and the float32 log-sum-exp) written
    once."""
    flops = 4 * d * b * hq * attention_pairs(s, t, window or None, causal)
    nbytes = esize * (2 * b * hq * s * d + 2 * b * hkv * t * d)
    return flops, nbytes + (4 * b * hq * s if return_lse else 0)


def flash_bwd_cost(b, hq, hkv, s, t, d, esize, causal, window):
    """``(flops, bytes)`` of one flash backward: 10·D flops a pair and head
    (S and dP recomputed, dV, dK and dQ); q, k, v, do and the float32
    log-sum-exp read once, dq, dk and dv written once."""
    flops = 10 * d * b * hq * attention_pairs(s, t, window or None, causal)
    return flops, esize * (3 * b * hq * s * d + 4 * b * hkv * t * d) + 4 * b * hq * s


def scan_cost(b, h, s, p, n, esize):
    """``(flops, bytes)`` of one chunked-scan call: 5·P·N flops a step and
    head; x, dt, decay, B and C read once, y and the state written once."""
    nbytes = 2 * esize * b * h * s * p + 2 * 4 * b * h * s + 2 * esize * b * s * n + 4 * b * h * p * n
    return 5 * b * h * s * p * n, nbytes


def least_s(flops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    """The least time on the chip: operations at their peak, or the bytes
    at the memory's, whichever is longer."""
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)


def _leaf(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def windows(cfg):
    full = set(cfg.get("full_attn_layers") or ())
    w = cfg.get("sliding_window")
    return [None if (w is None or i in full) else w for i in range(cfg["n_layers"])]


def product_params(cfg, plist, active: bool = True) -> int:
    """Weights a token's products pass through: a MoE's top k of its
    experts when ``active``; no input embedding unless tied."""
    n = sum(math.prod(shape) for name, shape, *_ in plist if _leaf(name) in PRODUCT_WEIGHTS)
    if cfg.get("tie_embeddings"):
        n += cfg["vocab"] * cfg["d_model"]
    moe = cfg.get("moe")
    if active and moe:
        per_expert = 3 * cfg["d_model"] * cfg["d_ff"]
        n -= cfg["n_layers"] * (moe["n_experts"] - moe["top_k"]) * per_expert
    return n


def weight_bytes(plist) -> int:
    """Every weight but the input embedding table, read once."""
    return sum(math.prod(shape) * ESIZE[dt] for name, shape, dt, *_ in plist if name != "embed")


def _hd(cfg) -> int:
    return cfg["head_dim"] or cfg["d_model"] // cfg["n_heads"]


def train_step_flops(cfg, plist, b: int, s: int) -> int:
    """6·N·tokens plus 12·Hq·D per unmasked pair, row and layer."""
    pairs = sum(attention_pairs(s, s, w) for w in windows(cfg))
    return 6 * product_params(cfg, plist) * b * s + 12 * cfg["n_heads"] * _hd(cfg) * pairs * b


def prefill_least_s(cfg, plist, b: int, s: int) -> float:
    """One prefill of B x S: 2·N per token (the head at the last position
    only), 4·Hq·D per pair; every weight read once, the prompt's
    embedding rows read and its keys and values written once."""
    hd, kv = _hd(cfg), cfg["n_kv_heads"]
    head = cfg["d_model"] * cfg["vocab"]
    pairs = sum(attention_pairs(s, s, w) for w in windows(cfg))
    flops = (2 * (product_params(cfg, plist) - head) * b * s + 2 * head * b
             + 4 * cfg["n_heads"] * hd * pairs * b)
    nbytes = (weight_bytes(plist) + 2 * b * s * cfg["d_model"]
              + cfg["n_layers"] * 2 * b * s * kv * hd * 2)
    return least_s(flops, nbytes)


def decode_step_least_s(cfg, plist, b: int, pos: int, cache_len: int) -> float:
    """One decode step at absolute position ``pos``: 2·N per token, 4·Hq·D
    per cached key attended; every weight read once (at this batch every
    expert takes tokens), each cached key and value read once."""
    hd, kv = _hd(cfg), cfg["n_kv_heads"]
    slots = 0
    for w in windows(cfg):
        ring = cache_len if w is None else min(w, cache_len)
        seen = min(pos, ring) if w is None else min(pos, ring, w - 1)
        slots += seen + 1
    flops = 2 * product_params(cfg, plist) * b + 4 * cfg["n_heads"] * hd * slots * b
    nbytes = weight_bytes(plist) + 2 * b * cfg["d_model"] + 2 * b * slots * kv * hd * 2
    return least_s(flops, nbytes)
