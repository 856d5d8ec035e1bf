"""Bucket padding for the kernel OLTP hot path.

Each fused OLTP entry point launches its kernel at the *shape* of its
inputs: feeding every batch's exact record or access count produces one
launch shape per distinct size, and every new shape is a new allocation
pattern for the caching allocator.  All fused OLTP entry points therefore
take their inputs padded up to a power-of-two **bucket**, so a stream of
arbitrary-size batches touches at most ``log2(max_size)`` distinct shapes —
the *bucket ladder*.

Padding is only sound if the padded lanes can never influence a result.
Each fused op routes its pad lanes to a dedicated overflow slot and/or fills
them with the identity of the reduction they feed (``-1`` for a max over
non-negative values, ``NO_POS``/``NO_WRITER`` for a min, "valid=False" for a
segmented all): see ``kernels/scatter_max.py`` / ``kernels/batch_occ.py``
for the per-op conventions, and ``tests/test_bucketing.py`` for the
non-interference property tests.

This module also owns the **guarded int32 downcast**: device arrays are
int32 (the kernels take int32, and a silent narrowing would wrap), so every
caller must either prove its values fit or fall back to the numpy path.  ``fits_i32`` is the decision, ``checked_i32``
the enforcing cast — silent ``.astype(np.int32)`` narrowing is a bug.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np

I32_MAX = np.iinfo(np.int32).max
I32_MIN = np.iinfo(np.int32).min


def bucket(n: int, min_size: int = 8) -> int:
    """Smallest power of two ≥ ``max(n, min_size)``."""
    return 1 << (max(int(n), min_size, 1) - 1).bit_length()


def ladder(max_n: int, min_size: int = 8) -> List[int]:
    """Every bucket a stream of sizes ``1..max_n`` can map to — the upper
    bound on distinct launch shapes per fused op."""
    out = [bucket(min_size, min_size)]
    while out[-1] < bucket(max_n, min_size):
        out.append(out[-1] * 2)
    return out


def fits_i32(*arrays: np.ndarray) -> bool:
    """True iff every value of every array is representable as int32 —
    the precondition for the compiled (device) path.  Empty arrays fit."""
    for a in arrays:
        if a.size and (int(a.max()) > I32_MAX or int(a.min()) < I32_MIN):
            return False
    return True


def checked_i32(a: np.ndarray, what: str = "array") -> np.ndarray:
    """Downcast to int32, raising ``OverflowError`` on any value outside the
    int32 range instead of silently wrapping (callers that can fall back
    should test :func:`fits_i32` first; this is the last line of defence)."""
    if not fits_i32(a):
        raise OverflowError(
            f"{what} exceeds int32 range (max {int(a.max())}); "
            "the compiled kernel path requires a guarded numpy fallback"
        )
    return a.astype(np.int32, copy=False)


def pad_i32(a: np.ndarray, n: int, fill: int, what: str = "array") -> np.ndarray:
    """``a`` checked-downcast to int32 and right-padded to length ``n`` with
    the reduction-identity ``fill``."""
    out = np.full(n, fill, dtype=np.int32)
    out[: len(a)] = checked_i32(np.asarray(a), what)
    return out


def stack_i32(
    cols: Sequence[np.ndarray], n: int, fills: Sequence[int]
) -> np.ndarray:
    """Stack equal-length columns into one ``(len(cols), n)`` int32 matrix,
    padding each with its own identity — the single host→device transfer of
    the fused passes."""
    out = np.empty((len(cols), n), dtype=np.int32)
    for i, (c, f) in enumerate(zip(cols, fills)):
        out[i, : len(c)] = checked_i32(np.asarray(c), f"column {i}")
        out[i, len(c):] = f
    return out


def jit_cache_size(fn) -> int:
    """Number of distinct launch shapes a kernel entry point of
    :mod:`repro_torch.kernels.ops` has seen (0 for plain callables) — the
    observable the shape-stability contract is stated in."""
    return len(getattr(fn, "shapes", ()))


def total_jit_cache_size(fns: Iterable) -> int:
    return sum(jit_cache_size(f) for f in fns)


def gauge_jit_cache(fns: Iterable, name: str = "kernels.jit_cache_size") -> int:
    """Publish the total launch-shape count as a registry gauge (and return
    it).  Sampled, not hooked: shape growth is driven by batch-size churn,
    so callers gauge it at batch boundaries or register it as a snapshot
    callback:

        REGISTRY.register_callback("kernels.jit_cache_size",
                                   lambda: total_jit_cache_size(fns))
    """
    from ..obs.metrics import REGISTRY

    n = total_jit_cache_size(fns)
    if REGISTRY.enabled:
        REGISTRY.gauge_set(name, float(n))
    return n
