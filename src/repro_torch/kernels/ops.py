"""Public wrappers for the device functions — where PyTorch starts.

The OLTP functions take and return ``torch.int32`` tensors (``bool`` for
the survive mask) on one explicit device; the LLM prefill's
(:func:`flash_attention`, :func:`ssm_scan`, :func:`rwkv6`) float32 or
bfloat16 tensors in the reference's layout.  On a CUDA tensor each launches the
hand-written kernel (``kernels/csrc``); on a CPU tensor it runs the kernel's
plain PyTorch version.  The choice follows the tensor's device and nothing
else: there is no fallback from a failed launch and no switch that swaps a
kernel for its plain version.

The fused entry points (:func:`fused_replay_scan`, :func:`fused_replay_apply`,
:func:`fused_validate_sequence`) are what ``mode="kernel"`` runs in recovery
and the batched executor.  Their callers pad inputs to the power-of-two
bucket ladder (``kernels/bucketing.py``), so the number of distinct launch
shapes per op stays bounded; :func:`fused_cache_sizes` reports it.

On meta tensors the three LLM entry points run the card's checks and return
meta outputs (see each wrapper); each such call is one dispatcher op,
``repro_torch::flash_attention``, ``repro_torch::ssm_scan_chunked`` or
``repro_torch::rwkv6_chunked``.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from .batch_occ import seg_reduce as _seg_reduce
from .batch_occ import validate_sequence as _validate_sequence
from .bucketing import jit_cache_size
from .flash_attention import flash_attention_fwd
from .rwkv6 import rwkv6_chunked
from .scatter_max import _scatter_max_blocks
from .scatter_max import ssn_scatter_max as _ssn_scatter_max
from .ssm_scan import ssm_scan_chunked


def kernel_device(device) -> torch.device:
    """Resolve the device a kernel-mode entry point runs on.  A CUDA device
    on a machine without one raises: kernel mode never quietly runs on the
    CPU — the caller asks for it with ``device="cpu"``.  ``"meta"``, named by
    the caller, is the card's program with shapes only: the LLM kernel
    wrappers run their card checks and return meta outputs (the dry run's
    device); the OLTP kernels refuse it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "kernel mode needs a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions"
            )
    elif dev.type not in ("cpu", "meta"):
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


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None):
    """q (B,Hq,S,D); k/v (B,Hkv,T,D) -> (B,Hq,S,D).  The reference's block
    sizes and interpret switch are the TPU kernel's; the port's kernel takes
    any S and T."""
    return flash_attention_fwd(q, k, v, causal=causal, window=window, softcap=softcap)


def ssm_scan(x, dt, decay, bmat, cmat):
    """Chunked selective scan (chunks of 64, the reference's default):
    returns (y, final_state)."""
    return ssm_scan_chunked(x, dt, decay, bmat, cmat)


def rwkv6(r, k, v, w, u):
    """Chunked wkv6 (chunks of 32, the reference's default): returns
    (y, final_state)."""
    return rwkv6_chunked(r, k, v, w, u)


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
    the host resolves slot hash spills exactly afterwards.  The image is all
    empty, so on the card none is built or read: one launch per call.
    """
    return _scatter_max_blocks(None, scan, n_slots)


@_tracks_shapes
def fused_replay_apply(image: torch.Tensor, scan: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like :func:`fused_replay_scan` but against a *preloaded* image — the
    guarded apply of ``replay_columnar``, where the checkpoint seeds the
    per-slot ``(ssn, pos)`` state.  ``image`` is one stacked ``(2, S)``
    int32 block (ssn row, pos row — empty slots ``(-1, NO_POS)``); ``scan``
    is the ``(3, N)`` lane block with padding lanes pointing at the
    overflow slot ``S``."""
    return _scatter_max_blocks(image, scan, image.shape[-1])


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
