"""Segmented reduce and the fused validate→sequence round — batched OCC
conflict detection (paper §4.2/§4.4, `repro_torch.db.batch`).

Two device functions, each a hand-written CUDA kernel (``csrc/``) with a
plain PyTorch version beside it:

* :func:`seg_reduce` — ``out[k] = max``/``min`` of ``val[i]`` over the items
  with ``key[i] == k``: per-transaction base-SSN max (Algorithm 1 lines 1–4,
  batched) and per-tuple first-writer min (intra-batch WW/RW conflicts,
  first-come-wins).  Kernel: ``csrc/seg_reduce.cu``, one cooperative launch
  (identity fill, grid-wide barrier, atomics) for every size.
* :func:`validate_sequence` — one round's first-writer min, the three
  validation masks, the survive reduction and the base-SSN max over one
  stacked ``(6, n_txn*k)`` int32 block.  Kernel:
  ``csrc/validate_sequence.cu``, one cooperative launch (first-writer
  atomics, grid-wide barrier, per-transaction reductions) over a cached,
  epoch-tagged first-writer scratch that no call fills.

Sentinels: padded items use ``key = -1``, which matches no slot; empty slots
come back as ``SEG_MAX_INIT`` (-1) for ``op="max"`` and ``NO_WRITER``
(int32 max) for ``op="min"`` — exactly the "no writer in batch" value the
validator wants.  Values are int32; the callers fall back to their numpy
twins when a batch exceeds the range.

Each wrapper runs the plain version for a CPU tensor and launches the kernel
for a CUDA tensor; any other device raises.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import cuda

SEG_MAX_INIT = np.int32(-1)
NO_WRITER = np.int32(np.iinfo(np.int32).max)

_I32 = torch.int32

#: ``validate_sequence``'s first-writer scratch per (device index, raw
#: stream): ``[words, epoch]``, int64 words grown to the largest cap seen and
#: the epoch of the last call on them.  A word holds its writer's epoch in
#: its high half, so every call raises the epoch and leaves earlier calls'
#: words unread; the words are zeroed again only when the 32-bit epoch would
#: wrap.  Keyed by stream, so that no two streams share one.
_fw_scratch: Dict[Tuple[int, int], List] = {}
_EPOCH_MAX = 2**32 - 1
#: Held from the scratch lookup through the launch: two host threads on one
#: stream then raise the epoch one after the other and enqueue in that order,
#: so neither reads the other's first writers nor re-zeroes words in use.
_fw_lock = threading.Lock()


def _check_i32(name: str, *tensors: torch.Tensor) -> torch.device:
    """One pass over ``tensors``: each int32, contiguous and on the first's
    device, which is the CPU or a CUDA device.  Returns that device."""
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in tensors:
        if t.dtype is not _I32 or not t.is_contiguous() or t.device != dev:
            if t.dtype is not _I32:
                raise TypeError(f"{name}: expected int32, got {t.dtype}")
            if t.device != dev:
                raise ValueError(f"{name}: tensors on {t.device} and {dev}")
            raise ValueError(f"{name}: tensors must be contiguous")
    return dev


# --- segmented max / min ------------------------------------------------------

def seg_reduce_plain(
    key_id: torch.Tensor, val: torch.Tensor, n_slots: int, op: str = "max"
) -> torch.Tensor:
    """Plain PyTorch segmented reduce: one ``scatter_reduce_`` into the
    identity-filled slots, with out-of-range keys routed to a dropped
    overflow slot."""
    init = int(NO_WRITER) if op == "min" else int(SEG_MAX_INIT)
    out = torch.full((n_slots + 1,), init, dtype=torch.int32, device=key_id.device)
    idx = torch.where((key_id >= 0) & (key_id < n_slots), key_id, n_slots).long()
    out.scatter_reduce_(0, idx, val, "amin" if op == "min" else "amax",
                        include_self=True)
    return out[:n_slots]


def seg_reduce(
    key_id: torch.Tensor,   # (W,) int32 slot id per item, -1 = padding
    val: torch.Tensor,      # (W,) int32 value per item
    n_slots: int,
    *,
    op: str = "max",
) -> torch.Tensor:
    """Segmented ``max``/``min`` of ``val`` grouped by ``key_id`` into
    ``n_slots`` dense slots.  Slots with no member come back as
    ``SEG_MAX_INIT`` (max) / ``NO_WRITER`` (min)."""
    if op not in ("max", "min"):
        raise ValueError(f"seg_reduce: op must be 'max' or 'min', not {op!r}")
    dev = _check_i32("seg_reduce", key_id, val)
    if key_id.shape != val.shape or key_id.dim() != 1:
        raise ValueError("seg_reduce: key_id and val must be equal-length 1-D")
    if dev.type == "cpu":
        return seg_reduce_plain(key_id, val, n_slots, op)
    out = key_id.new_empty(n_slots)
    err = cuda.lib().repro_seg_reduce(
        key_id.data_ptr(), val.data_ptr(), key_id.shape[0], out.data_ptr(), n_slots,
        op == "min", dev.index, cuda.current_stream(dev.index),
    )
    cuda.check(err, "seg_reduce")
    cuda.count_launch("seg_reduce")
    return out


# --- fused validate -> sequence -------------------------------------------------

def validate_sequence_plain(
    acc: torch.Tensor, a_len: torch.Tensor, n_txn: int, k: int, cap: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch fused round: ``scatter_reduce_`` for the first writer,
    then reshape-reduces (the semantics of the reference's
    ``validate_sequence_xla``)."""
    row, pos, iswrite, obs, ssn_now, locked = (acc[i] for i in range(6))
    lane = torch.arange(k, dtype=torch.int32, device=acc.device).reshape(1, k)
    valid = (lane < a_len.reshape(n_txn, 1)).reshape(-1)
    w_pos = torch.where((iswrite != 0) & valid, pos, int(NO_WRITER))
    row_l = row.long()
    fw = torch.full((cap,), int(NO_WRITER), dtype=torch.int32, device=acc.device)
    fw.scatter_reduce_(0, row_l, w_pos, "amin", include_self=True)
    fw = fw[row_l]
    ok = (fw >= pos) & ((obs < 0) | (ssn_now == obs)) & (locked == 0)
    survive = (ok | ~valid).reshape(n_txn, k).all(dim=1)
    zero = torch.zeros((), dtype=torch.int32, device=acc.device)
    bases = torch.where(valid, ssn_now, zero).reshape(n_txn, k).amax(dim=1)
    return survive, bases


def validate_sequence(
    acc: torch.Tensor,     # (6, n_txn*k) int32: row, pos, iswrite, obs, ssn_now, locked
    a_len: torch.Tensor,   # (n_txn,) int32 true access count per txn (0 = padding)
    n_txn: int,            # txn bucket (rows of the dense layout)
    k: int,                # access bucket (lanes per txn)
    cap: int,              # row-capacity bucket (first-writer scatter width)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused validate→sequence round for the batched OCC executor
    (`repro_torch.db.batch.BatchOCC`, ``mode="kernel"``).

    The batch arrives as ONE stacked int32 block in a dense bucket-padded
    ``(n_txn, k)`` layout — every transaction's accesses padded to ``k``
    lanes.  Lanes beyond a transaction's true access count (``a_len``) are
    masked: they pass validation vacuously, contribute ``0`` to the base-SSN
    max, and never claim a first-writer slot.  Returns ``(survive, bases)``,
    bool and int32, both ``(n_txn,)``.

    On the card the first-writer table is tagged with an epoch that this
    function raises on the host before each launch (``_fw_scratch``).  A
    CUDA graph would replay its captured epoch, read earlier replays' words
    as this round's first writers and return a wrong ``survive``, so a call
    under stream capture raises ``RuntimeError``.
    """
    dev = _check_i32("validate_sequence", acc, a_len)
    if tuple(acc.shape) != (6, n_txn * k) or tuple(a_len.shape) != (n_txn,):
        raise ValueError(
            f"validate_sequence: acc {tuple(acc.shape)} / a_len "
            f"{tuple(a_len.shape)} do not match n_txn={n_txn}, k={k}"
        )
    if dev.type == "cpu":
        return validate_sequence_plain(acc, a_len, n_txn, k, cap)
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "validate_sequence: cannot be captured in a CUDA graph (its first-writer "
            "epoch is raised on the host per call, and a replay would reuse it)"
        )
    index = dev.index
    stream = cuda.current_stream(index)
    slot = (index, stream)
    # two allocations: one block with a bool view into it costs more host
    # time than both (tools/launch_variants.py)
    survive = acc.new_empty(n_txn, dtype=torch.bool)
    bases = acc.new_empty(n_txn)
    with _fw_lock:
        scratch = _fw_scratch.get(slot)
        if scratch is None or scratch[0].shape[0] < cap:
            scratch = _fw_scratch[slot] = [acc.new_zeros(max(cap, 1), dtype=torch.int64), 0]
        elif scratch[1] == _EPOCH_MAX:
            scratch[0].zero_()
            scratch[1] = 0
        scratch[1] += 1
        err = cuda.lib().repro_validate_sequence(
            acc.data_ptr(), a_len.data_ptr(), n_txn, k, cap, scratch[0].data_ptr(), scratch[1],
            survive.data_ptr(), bases.data_ptr(), index, stream,
        )
        if err != 0:
            _fw_scratch.pop(slot, None)   # the next call starts on fresh words
    if err != 0:
        cuda.check(err, "validate_sequence")
    cuda.count_launch("validate_sequence")
    return survive, bases
