"""Emulated storage devices for the Poplar engine.

The container has no PCIe SSDs or NVDIMMs, so devices are emulated with the
paper's own constants (§6.1):

* ``SSD``  — 1.2 GB/s peak sequential write, 21.5 µs latency per sequential
  16 KB block write.
* ``NVM``  — ~2x DRAM latency; modelled as a fixed per-persist latency of
  ~0.2 µs (the paper emulates it with a busy-wait loop calibrated from PMEP).

Every device supports two clock modes:

* ``real``    — writes go to a backing file (durable, used by recovery tests
  and the examples) and the emulated device time is *slept*, releasing the
  GIL so that multi-device IO concurrency is physically real even on 1 core.
* ``virtual`` — no sleeping; the device accumulates busy-time in a local
  virtual clock.  Benchmarks use this to derive device-bandwidth numbers
  (fig 6) deterministically.

Write calls are serialized per device (a device has one head); this models
the single logger-thread-per-device binding of the paper.

Log lifecycle (§5 applied to the devices): a device is a chain of immutable
**sealed segments** plus one active **tail**, all addressed by *logical*
offsets that never move — ``read_from``/``size`` and the whole SSN machinery
are oblivious to where a byte physically lives.  :meth:`StorageDevice.seal`
freezes the tail into a sealed segment (stamped with the SSN of its last
record, which the caller — the logger, who owns the DSN — supplies);
:meth:`StorageDevice.truncate_to_ssn` atomically drops the prefix of sealed
segments whose records all fall at or below a safe SSN (the checkpoint-
anchored point `repro.core.truncate.LogTruncator` computes).  A reader
asking for truncated bytes gets :class:`TruncatedLogError` — a hole is an
error, never silently empty — and recovers via checkpoint catch-up
(`repro.replica.replica.Replica`).  Path-backed devices persist the chain in
a ``<path>.segments.json`` manifest (written atomically) so a reopened
device knows its base offset and RSNe floor across a real crash.
"""

from __future__ import annotations

import bisect
import json
import os
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class TruncatedLogError(Exception):
    """A read asked for log bytes below the device's truncation point.

    Raised instead of returning a hole: the caller (a lagging log shipper, a
    stale journal tailer) must re-base from a checkpoint — the dropped bytes
    are, by the truncator's safe-point rule, fully covered by it.
    """

    def __init__(self, offset: int, base: int):
        super().__init__(
            f"log offset {offset} predates the truncation point {base}"
        )
        self.offset = offset
        self.base = base


@dataclass
class DeviceSpec:
    name: str
    bandwidth_bytes_per_s: float
    latency_s: float           # fixed per-write latency
    sync_granularity: int = 1  # min bytes accounted per write

    @staticmethod
    def ssd() -> "DeviceSpec":
        # §6.1: 1.2 GB/s sequential write, 21.5us for a 16KB block.
        # REPRO_SSD_BW rescales bandwidth: benchmarks on this 1-core container
        # shrink it (default 30 MB/s there) so the IO-bound regime the paper
        # measures is reached below the GIL-bound txn rate — variant *ratios*
        # are the reproduction target (DESIGN §9).
        bw = float(os.environ.get("REPRO_SSD_BW", 1.2e9))
        return DeviceSpec("ssd", bw, 21.5e-6)

    @staticmethod
    def nvm() -> "DeviceSpec":
        # §6.1: 2x DRAM latency; ~0.2us per persist barrier (mfence+clwb scale)
        return DeviceSpec("nvm", 20e9, 0.2e-6)

    @staticmethod
    def null() -> "DeviceSpec":
        return DeviceSpec("null", float("inf"), 0.0)

    def write_time(self, nbytes: int) -> float:
        if self.bandwidth_bytes_per_s == float("inf"):
            return self.latency_s
        return self.latency_s + nbytes / self.bandwidth_bytes_per_s


@dataclass
class LogSegment:
    """One immutable sealed segment of a device log.

    ``start``/``end`` are logical byte offsets (``end`` exclusive);
    ``last_ssn`` is the SSN of the newest record the segment holds — because
    per-device SSNs are monotone in flush order, ``last_ssn <= safe`` means
    *every* record in the segment is at or below ``safe``, which is the whole
    truncation decision.  Sealing happens at flushed record boundaries only,
    so a sealed segment always holds complete frames.
    """

    start: int
    end: int
    last_ssn: int
    path: Optional[str] = None            # backing file (path-backed devices)
    chunks: List[bytes] = field(default_factory=list)  # in-memory devices
    # crc32 of the segment's bytes, computed incrementally as the tail is
    # written and frozen at seal time.  Recovery verifies it with one
    # C-speed pass over the blob and can then skip per-frame crc checks in
    # the vectorized tile decode (`repro.core.fastdecode`); ``None`` (a
    # pre-crc manifest) falls back to per-frame verification.
    crc: Optional[int] = None

    @property
    def nbytes(self) -> int:
        return self.end - self.start

    def read(self) -> bytes:
        if self.path is not None:
            with open(self.path, "rb") as f:
                return f.read()
        return b"".join(self.chunks)


class StorageDevice:
    """An append-only log device with emulated timing.

    ``write(data)`` appends and *persists* ``data``; on return the data is
    durable (fsync semantics).  Timing is emulated per the DeviceSpec.
    """

    def __init__(
        self,
        spec: DeviceSpec,
        path: Optional[str] = None,
        clock: str = "real",
    ):
        self.spec = spec
        self.path = path
        self.clock = clock
        self._lock = threading.Lock()
        self.bytes_written = 0
        self.n_writes = 0
        self.busy_time = 0.0       # virtual busy time (seconds)
        # --- segment chain state ------------------------------------------
        self._sealed: List[LogSegment] = []
        self._tail_start = 0       # logical offset of the tail's first byte
        self._tail_bytes = 0       # bytes in the active tail
        # lifecycle watermarks, persisted in the manifest: the last SSN and
        # byte count ever dropped by truncation.  ``truncated_ssn`` is this
        # device's RSNe floor — with the whole log truncated away, the last
        # durable record's SSN is exactly the newest dropped segment's.
        self.truncated_ssn = 0
        self.truncated_bytes = 0
        self.n_seals = 0
        self.n_truncations = 0
        self._buf: List[bytes] = []  # in-memory tail chunks when no path
        self._buf_starts: List[int] = []  # logical start offset of each chunk
        self._tail_crc = 0         # running crc32 of the active tail's bytes
        if path is not None:
            self._load_manifest()
            self._fh = open(path, "ab")
            self._tail_bytes = os.path.getsize(path)
            if self._tail_bytes:
                # reopened with a pre-existing tail: rebuild the running crc
                # so a later seal() stamps the correct whole-segment value
                with open(path, "rb") as f:
                    self._tail_crc = zlib.crc32(f.read())
        else:
            self._fh = None

    # --- manifest (path-backed persistence of the segment chain) ----------
    def _manifest_path(self) -> str:
        return self.path + ".segments.json"

    def _load_manifest(self) -> None:
        try:
            with open(self._manifest_path()) as f:
                m = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return
        self._tail_start = m["tail_start"]
        self.truncated_ssn = m.get("truncated_ssn", 0)
        self.truncated_bytes = m.get("truncated_bytes", 0)
        self._sealed = [
            LogSegment(s["start"], s["end"], s["last_ssn"], path=s["path"],
                       crc=s.get("crc"))
            for s in m["sealed"]
        ]

    def _write_manifest(self) -> None:
        """Atomically publish the chain (sealed list + tail base).  Called
        under the device lock, on every seal/truncate.  Crash ordering: the
        manifest is renamed into place *before* sealed files are unlinked, so
        a crash can orphan a data file (harmless, rediscovery is manifest-
        driven) but never reference a missing one."""
        m = {
            "tail_start": self._tail_start,
            "truncated_ssn": self.truncated_ssn,
            "truncated_bytes": self.truncated_bytes,
            "sealed": [
                {"start": s.start, "end": s.end, "last_ssn": s.last_ssn,
                 "path": s.path, "crc": s.crc}
                for s in self._sealed
            ],
        }
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(m, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, self._manifest_path())

    # --- write path --------------------------------------------------------
    def write(self, data: bytes) -> None:
        """Durably append ``data``. Blocks for the emulated device time."""
        t = self.spec.write_time(len(data))
        with self._lock:
            if self._fh is not None:
                self._fh.write(data)
                self._fh.flush()
                os.fsync(self._fh.fileno())
            else:
                self._buf.append(data)
                self._buf_starts.append(self._tail_start + self._tail_bytes)
            self._tail_crc = zlib.crc32(data, self._tail_crc)
            self._tail_bytes += len(data)
            self.bytes_written += len(data)
            self.n_writes += 1
            self.busy_time += t
        if self.clock == "real" and t > 0:
            time.sleep(t)

    # --- lifecycle: sealing and truncation ---------------------------------
    def seal(self, last_ssn: int) -> Optional[LogSegment]:
        """Freeze the active tail into an immutable sealed segment.

        ``last_ssn`` must be the SSN of the newest record the tail holds —
        the caller is whoever owns the flush path (the logger's DSN, held
        consistent under the buffer's flush lock), because the device is
        byte-oriented and cannot know.  Must only be called at a record
        boundary (everything flushed so far is complete frames; the engine
        guarantees this by sealing right after ``flush_ready``).

        Logical offsets are untouched: the new tail starts where the sealed
        segment ends.  Returns the new segment, or None for an empty tail.
        """
        with self._lock:
            if self._tail_bytes == 0:
                return None
            start, end = self._tail_start, self._tail_start + self._tail_bytes
            crc = self._tail_crc
            if self.path is not None:
                seg_path = f"{self.path}.seg-{start:020d}"
                self._fh.close()
                os.rename(self.path, seg_path)
                seg = LogSegment(start, end, last_ssn, path=seg_path, crc=crc)
                self._sealed.append(seg)
                self._tail_start, self._tail_bytes = end, 0
                self._tail_crc = 0
                self._fh = open(self.path, "ab")
                self._write_manifest()
            else:
                seg = LogSegment(start, end, last_ssn, chunks=self._buf,
                                 crc=crc)
                self._sealed.append(seg)
                self._buf, self._buf_starts = [], []
                self._tail_start, self._tail_bytes = end, 0
                self._tail_crc = 0
            self.n_seals += 1
            return seg

    def truncate_to_ssn(
        self, safe_ssn: int, keep_from: Optional[int] = None
    ) -> Tuple[int, int]:
        """Atomically drop the prefix of sealed segments whose records are
        all at or below ``safe_ssn`` (monotone SSNs make that exactly
        ``last_ssn <= safe_ssn``).  ``keep_from`` optionally stops earlier —
        the sharded truncator uses it to pin a segment whose cross-shard
        records are not yet checkpoint-covered on every participant.

        Only whole sealed segments are ever dropped, never the tail, and
        only as a prefix — the retained log is always a contiguous,
        hole-free suffix.  Returns ``(segments_dropped, bytes_dropped)``.
        """
        with self._lock:
            n_drop = 0
            for i, seg in enumerate(self._sealed):
                if seg.last_ssn > safe_ssn:
                    break
                if keep_from is not None and i >= keep_from:
                    break
                n_drop = i + 1
            if n_drop == 0:
                return 0, 0
            dropped, self._sealed = self._sealed[:n_drop], self._sealed[n_drop:]
            nbytes = sum(s.nbytes for s in dropped)
            self.truncated_ssn = dropped[-1].last_ssn
            self.truncated_bytes += nbytes
            self.n_truncations += 1
            if self.path is not None:
                # manifest first: a crash mid-unlink leaves orphan files the
                # manifest no longer references, never dangling references
                self._write_manifest()
                for s in dropped:
                    try:
                        os.remove(s.path)
                    except OSError:
                        pass
            return n_drop, nbytes

    def base_offset(self) -> int:
        """Logical offset of the oldest retained byte (the truncation point)."""
        with self._lock:
            return self._base_locked()

    def _base_locked(self) -> int:
        return self._sealed[0].start if self._sealed else self._tail_start

    def segments(self) -> List[Tuple[int, int, int]]:
        """``(start, end, last_ssn)`` of every sealed segment (tail excluded)."""
        with self._lock:
            return [(s.start, s.end, s.last_ssn) for s in self._sealed]

    def read_sealed_blob(self, index: int) -> Optional[bytes]:
        """Bytes of the ``index``-th sealed segment, or None if the chain
        shrank (a concurrent truncation) — the lazy single-segment read the
        sharded truncator uses to inspect only droppable candidates."""
        with self._lock:
            if index >= len(self._sealed):
                return None
            return self._sealed[index].read()

    def tail_bytes(self) -> int:
        """Bytes in the active (unsealed) tail."""
        with self._lock:
            return self._tail_bytes

    def disk_bytes(self) -> int:
        """Bytes the device currently retains (sealed chain + tail) — the
        on-disk footprint truncation bounds."""
        with self._lock:
            return sum(s.nbytes for s in self._sealed) + self._tail_bytes

    # --- read path ---------------------------------------------------------
    def size(self) -> int:
        """Durable byte count (the log's logical append frontier).

        Computed entirely under the device lock from the internal offset
        accounting — stat-ing the backing file after releasing the lock
        raced a concurrent :meth:`write` and could report a frontier that
        includes a torn in-flight append.
        """
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
            return self._tail_start + self._tail_bytes

    def read_from(self, offset: int) -> bytes:
        """Durable bytes from ``offset`` to the current frontier.

        The incremental read primitive of log shipping
        (:class:`repro.replica.LogShipper`): a tailer calls this with its
        consumed offset and gets only the delta, so repeatedly polling a
        growing log is O(new bytes), not O(log) per poll (``read_all`` in a
        loop re-reads the whole image every time).

        Raises :class:`TruncatedLogError` when ``offset`` predates the
        truncation point — the caller's bytes are gone and it must re-base
        from a checkpoint.
        """
        # everything — sealed reads *and* the tail read — happens under the
        # device lock: a concurrent seal() renames the tail file and a
        # concurrent truncate_to_ssn() unlinks sealed files, so reading
        # after releasing the lock could splice the *new* (re-opened) tail's
        # bytes at the old logical offset or hit a vanished path.  Writes
        # already do their IO under this lock; readers are no different.
        with self._lock:
            base = self._base_locked()
            if offset < base:
                raise TruncatedLogError(offset, base)
            if self._fh is not None:
                self._fh.flush()
            parts: List[bytes] = []
            for seg in self._sealed:
                if seg.end <= offset:
                    continue
                data = seg.read()
                parts.append(data[max(0, offset - seg.start):])
            if self.path is None:
                if offset > self._tail_start:
                    i = bisect.bisect_right(self._buf_starts, offset) - 1
                    if i >= 0:
                        out = b"".join(self._buf[i:])
                        parts.append(out[offset - self._buf_starts[i]:])
                else:
                    parts.extend(self._buf)
            else:
                with open(self.path, "rb") as f:
                    f.seek(max(0, offset - self._tail_start))
                    parts.append(f.read())
            return b"".join(parts)

    def read_all(self) -> bytes:
        """Return the full retained durable image, i.e. everything from the
        truncation point on (recovery path)."""
        return self.read_from(self.base_offset())

    def read_segment_blobs(self) -> List[bytes]:
        """The retained log as per-segment byte blobs (sealed chain, then
        tail) — the unit of segment-parallel recovery decode.  Sealed
        segments hold complete frames, so each blob decodes independently
        and the decoded chunks concatenate in chain order."""
        with self._lock:           # see read_from for why IO stays inside
            if self._fh is not None:
                self._fh.flush()
            blobs = [s.read() for s in self._sealed]
            if self.path is None:
                blobs.append(b"".join(self._buf))
            else:
                with open(self.path, "rb") as f:
                    blobs.append(f.read())
            return blobs

    def read_segment_entries(
        self,
    ) -> List[Tuple[bytes, Optional[int], Optional[int]]]:
        """Like :meth:`read_segment_blobs` but pairing each blob with its
        seal-time crc32 and ``last_ssn`` (both ``None`` for the tail, which
        can be torn and has no seal stamp; crc also ``None`` for segments
        from pre-crc manifests).  The compiled recovery pipeline verifies a
        sealed blob with one ``zlib.crc32`` call — skipping the per-frame
        crc loop of the tile decode — and reads the device's durable SSN
        frontier off the seal stamps when the tail is empty."""
        with self._lock:           # see read_from for why IO stays inside
            if self._fh is not None:
                self._fh.flush()
            entries: List[Tuple[bytes, Optional[int], Optional[int]]] = [
                (s.read(), s.crc, s.last_ssn) for s in self._sealed
            ]
            if self.path is None:
                entries.append((b"".join(self._buf), None, None))
            else:
                with open(self.path, "rb") as f:
                    entries.append((f.read(), None, None))
            return entries

    def close(self) -> None:
        """Close the tail's append handle.  Under the device lock, like every
        reader: a log shipper polling from another thread checks ``_fh`` and
        flushes it inside the lock, so closing outside it could close the
        handle between that check and the flush (``flush of closed file``).
        Reads after a close go through ``path``."""
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    # --- stats -----------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        return {
            "bytes_written": self.bytes_written,
            "n_writes": self.n_writes,
            "busy_time_s": self.busy_time,
            "avg_write_bytes": self.bytes_written / max(1, self.n_writes),
            "n_sealed_segments": len(self._sealed),
            "truncated_bytes": self.truncated_bytes,
        }


def make_devices(
    n: int,
    kind: str = "ssd",
    directory: Optional[str] = None,
    clock: str = "real",
    prefix: str = "log",
) -> List[StorageDevice]:
    """Create ``n`` devices of ``kind`` ('ssd' | 'nvm' | 'null')."""
    spec = {"ssd": DeviceSpec.ssd, "nvm": DeviceSpec.nvm, "null": DeviceSpec.null}[kind]()
    if directory is not None:
        os.makedirs(directory, exist_ok=True)
    devs = []
    for i in range(n):
        path = os.path.join(directory, f"{prefix}_{i}.bin") if directory else None
        devs.append(StorageDevice(spec, path=path, clock=clock))
    return devs
