"""Pure-numpy oracles for the OLTP kernels (small-shape exact references)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


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
