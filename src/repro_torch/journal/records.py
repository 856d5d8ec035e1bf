"""Journal record encoding for training state.

A training step maps onto Poplar transactions exactly:

* each state **shard** (a tree leaf, optionally split into slices) is a
  *tuple* with its own SSN;
* writing a shard's bytes for step N is a **write-only transaction** (Qww):
  it is durable/committed as soon as its own lane's DSN covers it — no
  cross-lane coordination (the paper's central point);
* the **step marker** is a read-write transaction (Qwr) whose read set is
  every shard it must see durable: it commits only when ``ssn <= CSN``,
  i.e. when every lane has persisted everything the step depends on.  A
  committed marker == "step N is restorable", with no global barrier ever
  taken on the write path.

Record keys:
  ``{step:016d}/{path}#{slice}/{nslices}`` — shard payload
  ``STEP/{step:016d}``                     — step marker (value: metadata)

Payload: little-endian header (dtype name, ndim, dims) + raw array bytes,
byte for byte the reference's (``repro/journal/records.py``).  Arrays are
CPU ``torch.Tensor``s here.  bfloat16, which
numpy lacks, is written as its raw 2-byte words under the name
``bfloat16``, as the reference writes an ``ml_dtypes`` array, and read back
as a bfloat16 tensor.
"""

from __future__ import annotations

import struct
import warnings
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

_HDR = struct.Struct("<16sB")
_U32 = struct.Struct("<I")


def encode_array(t: torch.Tensor) -> bytes:
    if t.device.type != "cpu":
        raise ValueError(f"journal records take CPU tensors, not {t.device}")
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        name, a = "bfloat16", t.view(torch.int16).numpy()
    else:
        a = t.numpy()
        name = a.dtype.name
    parts = [_HDR.pack(name.encode().ljust(16, b"\0"), a.ndim)]
    for d in a.shape:
        parts.append(_U32.pack(d))
    parts.append(memoryview(a))          # the join is the payload's only copy
    return b"".join(parts)


def decode_array(buf, copy: bool = True) -> torch.Tensor:
    """The record's array as a CPU tensor.  ``copy=False`` returns a
    read-only view of ``buf``'s bytes (no copy; the caller must not write
    it)."""
    dt_raw, ndim = _HDR.unpack_from(buf, 0)
    name = dt_raw.rstrip(b"\0").decode()
    pos = _HDR.size
    shape = []
    for _ in range(ndim):
        (d,) = _U32.unpack_from(buf, pos)
        shape.append(d)
        pos += 4
    a = np.frombuffer(buf, dtype=np.int16 if name == "bfloat16" else np.dtype(name), offset=pos)
    a = a.reshape(shape)
    if copy:
        t = torch.from_numpy(a.copy())
    else:
        with warnings.catch_warnings():      # a read-only view, by request
            warnings.simplefilter("ignore", UserWarning)
            t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if name == "bfloat16" else t


def shard_key(step: int, path: str, slice_idx: int, n_slices: int) -> str:
    return f"{step:016d}/{path}#{slice_idx}/{n_slices}"


def marker_key(step: int) -> str:
    return f"STEP/{step:016d}"


def parse_key(key: str) -> Dict[str, Any]:
    if key.startswith("STEP/"):
        return {"kind": "marker", "step": int(key[5:])}
    step_s, rest = key.split("/", 1)
    path, sl = rest.rsplit("#", 1)
    idx, n = sl.split("/")
    return {"kind": "shard", "step": int(step_s), "path": path,
            "slice": int(idx), "n_slices": int(n)}


def split_slices(arr: torch.Tensor, n_slices: int) -> List[torch.Tensor]:
    """Split along the leading dim (or no-op for scalars / n=1), in
    ``np.array_split``'s sizes."""
    if n_slices <= 1 or arr.dim() == 0 or arr.shape[0] < n_slices:
        return [arr]
    return list(torch.tensor_split(arr, n_slices, dim=0))


def join_slices(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    if len(parts) == 1:
        return parts[0]
    return torch.cat(list(parts), dim=0)
