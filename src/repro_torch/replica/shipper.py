"""Parallel log shipping — the replication ingest side.

One :class:`LogShipper` tails one log device (or file) *independently*: there
is no cross-device merge and no shipping order between devices, exactly the
paper's point that partially constrained logs need no total order — the
consumer re-derives everything it needs from SSNs (`repro_torch.replica.applier`).

Shipping is incremental: each poll reads only the bytes past the shipper's
consumed offset (:meth:`~repro_torch.core.storage.StorageDevice.read_from`) and
decodes only the *complete* frames among them
(:func:`~repro_torch.core.txn.decode_columnar_stream`).  A torn trailing frame —
an append that has not fully landed, a partial flush, a length field running
past the end — is **retried, never decoded**: its bytes stay buffered in the
shipper and are re-framed once more bytes arrive.  This is the same
length+crc validation crash recovery uses to truncate a torn tail, applied
as a resumable stream, so shipped and recovered torn-tail semantics are
byte-identical.

The shipped unit is a :class:`~repro_torch.core.txn.ColumnarLog` chunk — the same
struct-of-arrays form recovery decodes — so the applier folds it with the
vectorized replay machinery without any re-decoding.
"""

from __future__ import annotations

import os
from typing import List, Optional, Protocol, Sequence

import time

from ..core.par import parallel_for
from ..core.txn import ColumnarLog, decode_columnar_stream
from ..trace.span import ST_SHIP, TRACER
from ..obs.metrics import REGISTRY


class TailSource(Protocol):
    """Anything tailable: exposes the durable byte stream incrementally."""

    def read_from(self, offset: int) -> bytes: ...
    def size(self) -> int: ...


class FileSource:
    """A plain append-only file as a :class:`TailSource` (journal lanes)."""

    def __init__(self, path: str):
        self.path = path

    def read_from(self, offset: int) -> bytes:
        with open(self.path, "rb") as f:
            f.seek(offset)
            return f.read()

    def size(self) -> int:
        return os.path.getsize(self.path)


class LogShipper:
    """Tails one log source; each :meth:`poll` ships the new complete frames.

    State:

    * ``consumed`` — bytes fully decoded into frames so far;
    * ``frontier`` — SSN of the newest shipped durable record: this device's
      replicated DSN frontier.  ``min`` over a device set's frontiers is the
      shipped prefix's RSNe — the replica's visibility watermark
      (`repro_torch.replica.replica.Replica.visible_ssn`);
    * the torn-tail remainder, buffered internally between polls.
    """

    def __init__(self, source: TailSource, device_id: int = 0):
        self.source = source
        self.device_id = device_id
        self.consumed = 0
        self.frontier = 0
        self.n_shipped = 0
        self.n_polls = 0
        self._tail = b""
        # shard id stamped on trace spans (set by the sharded replica)
        self.trace_shard = 0

    def poll(self) -> Optional[ColumnarLog]:
        """Ship the frames that became complete since the last poll.

        Returns None when nothing new decoded (no new bytes, or only a
        still-torn tail).  A corrupt/torn trailing frame is left in place
        and retried next poll — on a crashed primary it simply never
        completes, which is exactly recovery's truncation point.

        Raises :class:`~repro_torch.core.storage.TruncatedLogError` (from the
        source) when the read offset predates the source's truncation point
        — the bytes this tailer still needed were dropped by the log
        truncator, and the owner must :meth:`rebase` it from a checkpoint
        (`repro_torch.replica.replica.Replica` does this transparently).
        """
        self.n_polls += 1
        _trace = TRACER.enabled
        if _trace:
            _t0 = time.perf_counter()
        new = self.source.read_from(self.consumed + len(self._tail))
        buf = self._tail + new if self._tail else new
        if not buf:
            return None
        log, used = decode_columnar_stream(buf)
        self._tail = buf[used:]
        self.consumed += used
        if log.n_records == 0:
            return None
        self.frontier = max(self.frontier, log.last_ssn)
        self.n_shipped += log.n_records
        if _trace:
            TRACER.record(
                ST_SHIP, shard=self.trace_shard, device=self.device_id,
                txn_hi=log.last_ssn, t0=_t0, t1=time.perf_counter(),
                nbytes=used, n_txn=log.n_records,
            )
        if REGISTRY.enabled:
            REGISTRY.count("replica.ship_bytes", used)
            REGISTRY.count("replica.ship_records", log.n_records)
        return log

    def rebase(self, offset: int, ssn_floor: int) -> None:
        """Jump the tailer over a truncation hole: resume reading at
        ``offset`` (the source's truncation point) and raise the shipped
        frontier to ``ssn_floor`` (the source's ``truncated_ssn`` — every
        dropped record's SSN is at or below it).  Only sound when the owner
        has seeded the skipped records' effects from the checkpoint that
        anchored the truncation; the safe-point rule guarantees that image
        covers exactly what was dropped."""
        assert offset >= self.consumed, "rebase must move forward"
        self.consumed = offset
        self._tail = b""
        self.frontier = max(self.frontier, ssn_floor)

    def lag_bytes(self) -> int:
        """Durable bytes at the source not yet decoded (shipping backlog)."""
        return max(0, self.source.size() - self.consumed)


def ship_all(
    shippers: Sequence[LogShipper], parallel: bool = True
) -> List[Optional[ColumnarLog]]:
    """Poll every shipper — in parallel threads when ``parallel`` (devices
    are independent streams; this mirrors recovery's per-device decode
    threading)."""
    out: List[Optional[ColumnarLog]] = [None] * len(shippers)

    def _poll(i: int) -> None:
        out[i] = shippers[i].poll()

    parallel_for(len(shippers), _poll, parallel)
    return out
