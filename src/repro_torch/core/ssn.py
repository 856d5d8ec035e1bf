"""Scalable Sequence Number allocation (paper §4.2, Algorithm 1).

The SSN of a transaction T with read set RS and write set WS, logging into
buffer L, is the smallest number that is

  (i)  larger than the SSN of every tuple in RS ∪ WS, and
  (ii) larger than the SSN of the log buffer L,

i.e. ``ssn(T) = max(max_{e∈RS∪WS} e.ssn, L.ssn) + 1``.  The new SSN is then
written back into L and into every tuple of WS (WAR is deliberately *not*
tracked: read-only tuples keep their SSN, so pure readers never delay
writers — this is the key difference from NVM-D's GSN).

Read-only transactions take no latch and consume no buffer slot:
``ssn(T) = base`` (Algorithm 1 lines 16–17).

The tuple side is duck-typed: anything with a mutable ``ssn`` attribute
works (DB tuple cells in `repro.db`, state shards in `repro.journal`).
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np

from .log_buffer import LogBuffer


def base_ssn(read_items: Iterable, write_items: Iterable) -> int:
    """max tuple-SSN over RS ∪ WS (Algorithm 1 lines 1–4)."""
    base = 0
    for e in read_items:
        if e.ssn > base:
            base = e.ssn
    for e in write_items:
        if e.ssn > base:
            base = e.ssn
    return base


def allocate(
    buffer: Optional[LogBuffer],
    read_items: Iterable,
    write_items: Iterable,
    record_len: int,
) -> Tuple[int, int, int]:
    """Run Algorithm 1 end-to-end for a transaction.

    Returns ``(ssn, offset, segment_index)``; for read-only transactions
    (empty write set) returns ``(base, -1, -1)`` without touching the buffer.

    NOTE: writing the SSN back into the write-set tuples (lines 13–15) is the
    caller's job, because under OCC (§4.4) it must happen in the write phase
    while the write locks are still held.
    """
    write_items = list(write_items)
    base = base_ssn(read_items, write_items)
    if not write_items:
        return base, -1, -1
    assert buffer is not None, "write transactions need a log buffer"
    ssn, offset, seg_idx = buffer.reserve(base, record_len)
    return ssn, offset, seg_idx


def writeback(ssn: int, write_items: Iterable) -> None:
    """Algorithm 1 lines 13–15: store the transaction's SSN into every
    written tuple."""
    for e in write_items:
        e.ssn = ssn


def base_ssn_global(ssn_arrays: Iterable[np.ndarray]) -> int:
    """Algorithm 1 lines 1–4 lifted across shards (`repro.shard`): the base
    of a cross-shard transaction is the max tuple SSN over its read and
    write sets on *every* participating shard.  Per-shard SSN spaces are
    independent, so this mixes spaces — deliberately: reserving from the
    mixed base on each participant pushes every participant's buffer SSN
    past every observed tuple SSN, which is exactly what makes the
    per-shard ``ssn <= CSN`` commit rule imply global RAW durability."""
    base = 0
    for arr in ssn_arrays:
        if len(arr):
            m = int(arr.max())
            if m > base:
                base = m
    return base


# --- batched Algorithm 1 (array-native forward path) -------------------------

def base_ssn_batch(acc_ssn: np.ndarray, acc_start: np.ndarray) -> np.ndarray:
    """Batched Algorithm 1 lines 1–4: per-transaction base SSN.

    ``acc_ssn`` holds the tuple SSNs of every access (RS ∪ WS), flattened
    transaction-major; ``acc_start`` is the ``(B+1,)`` prefix of per-txn
    access counts.  Returns the ``(B,)`` segment max (0 for a transaction
    with no accesses), i.e. ``base_i = max_{e ∈ RS_i ∪ WS_i} e.ssn``.
    """
    b = len(acc_start) - 1
    out = np.zeros(b, dtype=np.int64)
    nonempty = acc_start[:-1] < acc_start[1:]
    if acc_ssn.size and nonempty.any():
        # reduceat over only the nonempty segment starts: an empty segment
        # contributes no elements between two consecutive nonempty starts,
        # so the filtered boundaries still delimit the right slices
        out[nonempty] = np.maximum.reduceat(
            np.asarray(acc_ssn, dtype=np.int64), acc_start[:-1][nonempty]
        )
    return out


def chain_ssns(buffer_ssn: int, bases: np.ndarray) -> np.ndarray:
    """Vectorized Algorithm 1 lines 6–9 for a whole batch on one buffer.

    The scalar recurrence is ``s_i = max(base_i, s_{i-1}) + 1`` seeded with
    the buffer SSN; expanding it gives the closed form

        ``s_i = i + 1 + max(L.ssn, max_{j<=i} (base_j - j))``

    which is one subtraction, one running max, and one add — no serial loop.
    The caller stores ``s[-1]`` back into the buffer (done by
    :meth:`~repro.core.log_buffer.LogBuffer.reserve_batch` under its latch).
    """
    bases = np.asarray(bases, dtype=np.int64)
    idx = np.arange(len(bases), dtype=np.int64)
    return idx + 1 + np.maximum(int(buffer_ssn), np.maximum.accumulate(bases - idx))


def allocate_batch(
    buffer: LogBuffer, bases: np.ndarray, lengths: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Batched Algorithm 1 for write transactions mapped to one buffer.

    One latch acquisition reserves SSNs and slots for the whole batch
    (replacing N :func:`allocate` round-trips); returns ``(ssns, offsets,
    segment_index)``.  Read-only transactions never reach here — their SSN
    is just :func:`base_ssn_batch`'s output (Algorithm 1 lines 16–17).
    """
    return buffer.reserve_batch(bases, lengths)
