"""SSN-guarded scatter-max — batched log replay (paper §5).

Recovery's inner loop is, per log write ``(key, value, ssn)``::

    if ssn > image[key].ssn: image[key] = (value, ssn)

i.e. a scatter-max over SSNs with the *argmax payload* (which write won)
carried along — the Thomas write rule that makes Poplar's replay order-free.
:func:`ssn_scatter_max` applies a whole batch of writes against an image in
one pass: per slot, the winner under the ``(max ssn, then min pos)``
lattice.  Ties between equal SSNs resolve to the first write in replay
order, matching the scalar oracle's strict ``>`` guard.

Sentinels: a slot with no value has ``ssn = -1`` and ``pos = NO_POS``; a
checkpoint-provided slot has ``pos = -1`` (smaller than every log position,
so the checkpoint wins SSN ties exactly like the scalar guard).  Lanes whose
key lies outside ``[0, S)`` are ignored: the pad key ``-1`` and the
overflow slot ``S`` that bucket padding routes to.

The kernel (``csrc/scatter_max.cu``) packs each ``(ssn, pos)`` pair into one
unsigned 64-bit word and does one ``atomicMax`` per lane into scratch words,
then, after a grid-wide barrier in the same cooperative launch, joins the
image, unpacks and clears the scratch: one launch per call.  It takes ssn
and pos in ``[-1, 2**31 - 1]``, which every caller's padding and sentinels
respect.  :func:`ssn_scatter_max_plain` is the two-scatter PyTorch version.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import cuda
from .batch_occ import _I32, _check_i32

NO_POS = np.int32(np.iinfo(np.int32).max)

#: the kernel's scratch per (device index, raw stream): int64 words, all 0
#: between calls (the kernel clears every word it uses), grown to the
#: largest S seen.  Keyed by stream, so that no two streams share one.
_scratch: Dict[Tuple[int, int], torch.Tensor] = {}


def ssn_scatter_max_plain(
    image_ssn: torch.Tensor,
    image_pos: torch.Tensor,
    key_id: torch.Tensor,
    ssn: torch.Tensor,
    pos: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch scatter-max: the same lattice as two native scatters
    (``amax`` of the SSNs, then ``amin`` of the positions among each slot's
    max-SSN candidates), with out-of-range lanes routed to a dropped
    overflow slot ``S``."""
    s = image_ssn.shape[0]
    dev = image_ssn.device
    idx = torch.where((key_id >= 0) & (key_id < s), key_id, s).long()
    ext_ssn = torch.cat([image_ssn, torch.full((1,), -1, dtype=torch.int32, device=dev)])
    out_ssn = ext_ssn.scatter_reduce_(0, idx, ssn, "amax", include_self=True)
    cand = ssn == out_ssn[idx]
    cpos = torch.where(cand, pos, int(NO_POS))
    keep = image_ssn == out_ssn[:s]              # image still (co-)maximal?
    base = torch.cat([
        torch.where(keep, image_pos, int(NO_POS)),
        torch.full((1,), int(NO_POS), dtype=torch.int32, device=dev),
    ])
    out_pos = base.scatter_reduce_(0, idx, cpos, "amin", include_self=True)
    return out_ssn[:s], out_pos[:s]


def _launch(like: torch.Tensor, s: int, w: int, image, lanes) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one kernel launch behind every form, on the device of ``like``
    (an int32 input): ``image`` is the pair of image row pointers,
    ``(None, None)`` for an all-empty image that the kernel never reads;
    ``lanes`` the key, ssn and pos pointers.  Returns the rows of one
    ``(2, s)`` output block."""
    index = like.get_device()
    stream = cuda.current_stream(index)
    slot = (index, stream)
    scratch = _scratch.get(slot)
    if scratch is None or scratch.shape[0] < s:
        scratch = _scratch[slot] = like.new_zeros(s, dtype=torch.int64)
    out = like.new_empty((2, s))
    err = cuda.lib().repro_ssn_scatter_max(
        image[0], image[1], s, lanes[0], lanes[1], lanes[2], w,
        scratch.data_ptr(), out.data_ptr(), index, stream,
    )
    if err != 0:
        _scratch.pop(slot, None)   # a refused or half-run call may leave words dirty
        cuda.check(err, "ssn_scatter_max")
    cuda.count_launch("ssn_scatter_max")
    return out.unbind(0)


def _scatter_max_blocks(
    image: Optional[torch.Tensor], scan: torch.Tensor, s: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ops.fused_replay_scan`` (``image`` None: an all-empty image of ``s``
    slots, never built or read on the card) and ``ops.fused_replay_apply``
    (``image`` a contiguous ``(2, s)`` block of ssn and pos rows): ``scan``
    is one contiguous ``(3, N)`` block of key, ssn and pos rows.  On the card
    the rows are addressed inside the blocks, with no views made.  On CPU
    tensors the empty image is built and the plain version runs."""
    dev = _check_i32("ssn_scatter_max", scan) if image is None else \
        _check_i32("ssn_scatter_max", image, scan)
    if scan.dim() != 2 or scan.shape[0] != 3 or (
            image is not None and tuple(image.shape) != (2, s)):
        raise ValueError(f"ssn_scatter_max: scan {tuple(scan.shape)} is not (3, N) or the "
                         f"image is not (2, {s})")
    if dev.type == "cpu":
        img = (torch.full((s,), -1, dtype=_I32), torch.full((s,), int(NO_POS), dtype=_I32)) \
            if image is None else image.unbind(0)
        return ssn_scatter_max_plain(*img, *scan.unbind(0))
    if s == 0:
        return torch.empty((2, 0), dtype=_I32, device=dev).unbind(0)
    w = scan.shape[1]
    lanes = scan.data_ptr()
    img = (None, None) if image is None else (image.data_ptr(), image.data_ptr() + 4 * s)
    return _launch(scan, s, w, img, (lanes, lanes + 4 * w, lanes + 8 * w))


def ssn_scatter_max(
    image_ssn: torch.Tensor,   # (S,) int32, -1 = empty slot
    image_pos: torch.Tensor,   # (S,) int32, -1 = checkpoint value, NO_POS = empty
    key_id: torch.Tensor,      # (W,) int32 slot id per write; outside [0, S) = ignored
    ssn: torch.Tensor,         # (W,) int32 SSN per write (-1 for padded lanes)
    pos: torch.Tensor,         # (W,) int32 replay position (NO_POS for padding)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply a batch of SSN-guarded writes; returns ``(new_ssn, new_pos)``,
    both (S,): the winning SSN per slot and the position of the winning
    write (-1 if the checkpoint value stands, NO_POS if the slot is empty).
    """
    dev = _check_i32("ssn_scatter_max", image_ssn, image_pos, key_id, ssn, pos)
    s, w = image_ssn.shape[0], key_id.shape[0]
    if image_pos.shape[0] != s or ssn.shape[0] != w or pos.shape[0] != w:
        raise ValueError("ssn_scatter_max: image or lane lengths differ")
    if dev.type == "cpu":
        return ssn_scatter_max_plain(image_ssn, image_pos, key_id, ssn, pos)
    if s == 0:
        return image_ssn.clone(), image_pos.clone()
    return _launch(key_id, s, w, (image_ssn.data_ptr(), image_pos.data_ptr()),
                   (key_id.data_ptr(), ssn.data_ptr(), pos.data_ptr()))
