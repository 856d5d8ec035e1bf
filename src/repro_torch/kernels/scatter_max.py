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
unsigned 64-bit word and does one ``atomicMax`` per lane; it takes ssn and
pos in ``[-1, 2**31 - 1]``, which every caller's padding and sentinels
respect.  :func:`ssn_scatter_max_plain` is the two-scatter PyTorch version.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import cuda
from .batch_occ import _check_i32

NO_POS = np.int32(np.iinfo(np.int32).max)


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
    scratch = torch.empty(s, dtype=torch.int64, device=dev)
    out_ssn = torch.empty(s, dtype=torch.int32, device=dev)
    out_pos = torch.empty(s, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = cuda.lib().repro_ssn_scatter_max(
            image_ssn.data_ptr(), image_pos.data_ptr(), s,
            key_id.data_ptr(), ssn.data_ptr(), pos.data_ptr(), w,
            scratch.data_ptr(), out_ssn.data_ptr(), out_pos.data_ptr(),
            cuda.stream_of(out_ssn),
        )
    cuda.check(err, "ssn_scatter_max")
    cuda.LAUNCHES["ssn_scatter_max"] += 1
    return out_ssn, out_pos
