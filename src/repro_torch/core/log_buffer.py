"""Log buffers with decentralized SSN state (paper §4.1–§4.3).

Each LogBuffer owns:
  * ``ssn``    — SSN of the most recently cached record (Algorithm 1 state);
  * ``offset`` — logical, monotonically increasing allocation cursor;
  * ``dsn``    — durable SSN: largest SSN whose record is persistent;
  * a ring byte array of ``capacity`` bytes;
  * a :class:`~repro.core.segment.SegmentIndex` tracking buffer holes.

``reserve()`` implements the latched portion of Algorithm 1 (lines 6–12)
plus the worker half of Algorithm 2 (segment allocation/establishment).
``fill()`` is the memcpy done outside the latch; it completes the hole.

Workers block in ``reserve()`` when the ring is full (flushed space is
reclaimed by the logger) — this reproduces the paper's observation that
worker threads wait for buffer space once IO saturates (Fig. 8 "Log work").
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np

from .segment import SegmentIndex, CLOSED
from .storage import StorageDevice


class LogBuffer:
    def __init__(
        self,
        buffer_id: int,
        capacity: int = 30 * 1024 * 1024,
        io_unit: int = 16 * 1024,
        segment_ring: int = 256,
    ):
        self.id = buffer_id
        self.capacity = capacity
        self.io_unit = io_unit
        self.data = bytearray(capacity)

        # Algorithm 1 state
        self.ssn = 0
        self.offset = 0            # logical cursor (never wraps)
        self.dsn = 0

        self.flushed_offset = 0    # logical offset below which space is free
        self.latch = threading.Lock()        # the CAS latch of Algorithm 1
        self.space = threading.Condition(threading.Lock())
        # one logger owns a buffer in the paper; the flush lock makes manual
        # ticks (quiesce, tests) safe against the live logger thread
        self.flush_lock = threading.Lock()
        self.segindex = SegmentIndex(segment_ring)

        # perf counters
        self.reserve_waits = 0     # times a worker waited for space
        self.n_records = 0

    # ------------------------------------------------------------------ ---
    def reserve(
        self,
        base_ssn: int,
        length: int,
        timeout: float = 30.0,
        fixed_ssn: Optional[int] = None,
    ) -> Tuple[int, int, int]:
        """Allocate an SSN and a slot for a record of ``length`` bytes.

        Implements Algorithm 1 lines 6–12 under the buffer latch:
        ``T.ssn = max(base, L.ssn) + 1``;  ``L.ssn = T.ssn``;
        ``FETCH_ADD(L.offset, len)``, plus segment accounting.

        ``fixed_ssn`` (epoch-based engines): use the given sequence number
        verbatim — ``L.ssn = max(fixed_ssn, L.ssn)`` without the +1 — so the
        buffer SSN tracks epochs exactly.

        Returns ``(ssn, logical_offset, segment_index)``.
        """
        if length > self.capacity:
            raise ValueError(f"record of {length}B exceeds buffer capacity")
        while True:
            self._wait_space(length, timeout)
            with self.latch:
                if self.offset + length - self.flushed_offset > self.capacity:
                    continue  # lost the race; re-wait
                if fixed_ssn is not None:
                    ssn = max(fixed_ssn, self.ssn)
                    self.ssn = ssn
                else:
                    ssn = max(base_ssn, self.ssn) + 1
                    self.ssn = ssn
                offset = self.offset
                self.offset += length
                seg_idx = self.segindex.allocate(length)
                self.segindex.try_establish(self.ssn, self.offset, self.io_unit)
                self.n_records += 1
                return ssn, offset, seg_idx

    def _wait_space(self, nbytes: int, timeout: float) -> None:
        """Block until ``nbytes`` could fit (checked outside the latch to
        avoid holding it while blocked; the caller re-checks under the
        latch and re-waits if it lost the race)."""
        with self.space:
            waited = False
            while self.offset + nbytes - self.flushed_offset > self.capacity:
                waited = True
                if not self.space.wait(timeout):
                    raise TimeoutError("log buffer space wait timed out")
            if waited:
                self.reserve_waits += 1

    def reserve_batch(
        self,
        bases: np.ndarray,
        lengths: np.ndarray,
        timeout: float = 30.0,
    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Batched Algorithm 1: allocate SSNs and slots for a whole batch of
        records under a *single* latch acquisition.

        ``bases`` are the per-record base SSNs (in batch order — the order
        fixes the WAW chain), ``lengths`` the framed record lengths.  The SSN
        recurrence ``s_i = max(base_i, s_{i-1}) + 1`` is evaluated in closed
        form (:func:`repro.core.ssn.chain_ssns`) and the offsets are one
        prefix sum — replacing N ``reserve()`` lock round-trips with one.

        The whole batch is accounted to the generating segment (one bulk
        ``SegmentIndex.allocate``), so the reserved region is contiguous and
        a single :meth:`fill` of the concatenated records completes it.

        Returns ``(ssns, offsets, segment_index)``.
        """
        from .ssn import chain_ssns  # function-level: ssn.py imports this module

        n = len(bases)
        assert n > 0, "empty batch reservation"
        lengths = np.asarray(lengths, dtype=np.int64)
        total = int(lengths.sum())
        if total > self.capacity:
            raise ValueError(
                f"batch of {total}B exceeds buffer capacity {self.capacity}B; "
                "split the batch"
            )
        while True:
            self._wait_space(total, timeout)
            with self.latch:
                if self.offset + total - self.flushed_offset > self.capacity:
                    continue  # lost the race; re-wait
                ssns = chain_ssns(self.ssn, bases)
                offsets = self.offset + np.concatenate(
                    ([0], np.cumsum(lengths[:-1], dtype=np.int64))
                )
                self.ssn = int(ssns[-1])
                self.offset += total
                seg_idx = self.segindex.allocate(total)
                self.segindex.try_establish(self.ssn, self.offset, self.io_unit)
                self.n_records += n
                return ssns, offsets, seg_idx

    def fill(self, offset: int, seg_idx: int, record: bytes) -> None:
        """Copy the encoded record into the ring (outside the latch) and mark
        its bytes buffered, closing the hole."""
        pos = offset % self.capacity
        n = len(record)
        end = pos + n
        if end <= self.capacity:
            self.data[pos:end] = record
        else:
            first = self.capacity - pos
            self.data[pos:] = record[:first]
            self.data[: n - first] = record[first:]
        self.segindex.add_buffered(seg_idx, n)

    # --- logger side -------------------------------------------------------
    def force_establish(self) -> bool:
        """Timer-close the generating segment (logger as segment thread)."""
        with self.latch:
            return self.segindex.force_establish(self.ssn, self.offset)

    def flush_ready(self, device: StorageDevice) -> int:
        """Algorithm 2, AdvancingDSN: flush every ready segment in order,
        advancing the DSN.  Returns the number of segments flushed."""
        flushed = 0
        with self.flush_lock:
            while True:
                seg = self.segindex.flushable()
                if seg is None:
                    break
                start = seg.start_offset % self.capacity
                n = seg.allocated_bytes
                end = start + n
                if end <= self.capacity:
                    chunk = bytes(self.data[start:end])
                else:
                    chunk = bytes(self.data[start:]) + bytes(self.data[: end - self.capacity])
                device.write(chunk)
                self.dsn = seg.ssn
                with self.space:
                    self.flushed_offset += n
                    self.space.notify_all()
                self.segindex.pop_flushed()
                flushed += 1
        return flushed

    def pending_bytes(self) -> int:
        return self.offset - self.flushed_offset
