"""Public wrappers for the OLTP device functions — where PyTorch starts.

Every function here takes and returns ``torch.int32`` tensors (``bool`` for
the survive mask) on one explicit device.  On a CUDA tensor it launches the
hand-written kernel (``kernels/csrc``); on a CPU tensor it runs the kernel's
plain PyTorch version.  The choice follows the tensor's device and nothing
else: there is no fallback from a failed launch and no switch that swaps a
kernel for its plain version.

The fused entry points (:func:`fused_replay_scan`, :func:`fused_replay_apply`,
:func:`fused_validate_sequence`) are what ``mode="kernel"`` runs in recovery
and the batched executor.  Their callers pad inputs to the power-of-two
bucket ladder (``kernels/bucketing.py``), so the number of distinct launch
shapes per op stays bounded; :func:`fused_cache_sizes` reports it.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from .batch_occ import seg_reduce as _seg_reduce
from .batch_occ import validate_sequence as _validate_sequence
from .bucketing import jit_cache_size
from .scatter_max import NO_POS
from .scatter_max import ssn_scatter_max as _ssn_scatter_max


def kernel_device(device) -> torch.device:
    """Resolve the device a kernel-mode entry point runs on.  A CUDA device
    on a machine without one raises: kernel mode never quietly runs on the
    CPU — the caller asks for it with ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "kernel mode needs a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported kernel device {dev}")
    return dev


def _tracks_shapes(fn):
    """Record each distinct launch shape (tensor shapes plus the static
    arguments) on ``fn.shapes``."""
    shapes = set()

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        shapes.add((
            tuple(tuple(a.shape) if isinstance(a, torch.Tensor) else a for a in args),
            tuple(sorted(kwargs.items())),
        ))
        return fn(*args, **kwargs)

    wrapper.shapes = shapes
    return wrapper


@_tracks_shapes
def ssn_scatter_max(image_ssn, image_pos, key_id, ssn, pos):
    """SSN-guarded scatter-max batch replay (recovery §5):
    returns (winning ssn per slot, winning write position per slot)."""
    return _ssn_scatter_max(image_ssn, image_pos, key_id, ssn, pos)


@_tracks_shapes
def occ_seg_reduce(key_id, val, *, n_slots: int, op: str = "max"):
    """Segmented max/min for the batched OCC validator (§4.2/§4.4): per-txn
    base-SSN max (``op="max"`` keyed by txn id) and per-tuple first-writer
    position (``op="min"`` keyed by compacted row id)."""
    return _seg_reduce(key_id, val, n_slots, op=op)


@_tracks_shapes
def fused_replay_scan(scan: torch.Tensor, *, n_slots: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused hash-slot last-writer-wins scan — the device half of the
    kernel replay path (`repro_torch.core.recovery`).

    ``scan`` is one stacked ``(3, N)`` int32 block: slot id, SSN, replay
    position per write lane, bucket-padded to ``N`` with the identity lanes
    ``(n_slots, -1, NO_POS)`` (the overflow slot).  Returns the winning
    ``(ssn, pos)`` per slot under the ``(max ssn, then min pos)`` lattice —
    the host resolves slot hash spills exactly afterwards.
    """
    image_ssn = torch.full((n_slots,), -1, dtype=torch.int32, device=scan.device)
    image_pos = torch.full((n_slots,), int(NO_POS), dtype=torch.int32, device=scan.device)
    return _ssn_scatter_max(image_ssn, image_pos, scan[0], scan[1], scan[2])


@_tracks_shapes
def fused_replay_apply(image: torch.Tensor, scan: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like :func:`fused_replay_scan` but against a *preloaded* image — the
    guarded apply of ``replay_columnar``, where the checkpoint seeds the
    per-slot ``(ssn, pos)`` state.  ``image`` is one stacked ``(2, S)``
    int32 block (ssn row, pos row — empty slots ``(-1, NO_POS)``); ``scan``
    is the ``(3, N)`` lane block with padding lanes pointing at the
    overflow slot ``S``."""
    return _ssn_scatter_max(image[0], image[1], scan[0], scan[1], scan[2])


@_tracks_shapes
def fused_validate_sequence(acc: torch.Tensor, a_len: torch.Tensor, *,
                            n_txn: int, k: int, cap: int):
    """Fused validate→sequence pass for ``BatchOCC`` rounds: one stacked
    ``(6, n_txn*k)`` int32 block in, ``(survive, bases)`` out — see
    ``batch_occ.validate_sequence`` for the layout and masking rules."""
    return _validate_sequence(acc, a_len, n_txn, k, cap)


def fused_cache_sizes() -> Dict[str, int]:
    """Distinct launch shapes per entry point — with bucket padding these
    stay ≤ the bucket-ladder size no matter how many distinct batch shapes
    stream through."""
    return {
        "fused_replay_scan": jit_cache_size(fused_replay_scan),
        "fused_replay_apply": jit_cache_size(fused_replay_apply),
        "fused_validate_sequence": jit_cache_size(fused_validate_sequence),
        "ssn_scatter_max": jit_cache_size(ssn_scatter_max),
        "occ_seg_reduce": jit_cache_size(occ_seg_reduce),
    }
