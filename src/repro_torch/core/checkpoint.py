"""Fuzzy checkpointing (paper §5).

* n checkpoint threads × m files each (n*m total checkpoint files; the paper
  sizes n*m to the CPU core count for recovery parallelism).
* Tuples are evenly partitioned; each thread walks its partition in key order
  writing ``(key, value, ssn)`` entries.
* Transactions keep running — the snapshot is *fuzzy*; with early lock
  release a thread may even observe dirty (pre-committed) data.  Validity
  rule: each thread records the max SSN it observed; the checkpoint is valid
  only once the CSN exceeds every thread's max (then everything observed was
  truly committed — or will be superseded during replay by the per-tuple SSN
  guard).
* The daemon records the CSN at checkpoint start as ``RSN`` (the log-replay
  starting point) and writes metadata only after completion, so a crash mid-
  checkpoint simply falls back to the previous checkpoint.

Checkpoint entry framing: ``[u32 klen][key][u32 vlen][value][u64 ssn]`` with
a trailing ``[u32 crc]`` per file.
"""

from __future__ import annotations

import json
import os
import re
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from .par import parallel_for

_META_RE = re.compile(r"^ckpt_(\d+)\.meta\.json$")

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


@dataclass
class CheckpointData:
    rsn: int
    data: Dict[bytes, Tuple[bytes, int]] = field(default_factory=dict)
    files: List[str] = field(default_factory=list)


def _encode_entries(entries: Iterable[Tuple[bytes, bytes, int]]) -> bytes:
    parts: List[bytes] = []
    for key, val, ssn in entries:
        parts.append(_U32.pack(len(key)))
        parts.append(key)
        parts.append(_U32.pack(len(val)))
        parts.append(val)
        parts.append(_U64.pack(ssn))
    body = b"".join(parts)
    return body + _U32.pack(zlib.crc32(body))


def _decode_entries(buf: bytes) -> List[Tuple[bytes, bytes, int]]:
    if len(buf) < 4:
        return []
    body, crc = buf[:-4], _U32.unpack(buf[-4:])[0]
    if zlib.crc32(body) != crc:
        return []  # incomplete/corrupt checkpoint file → invalid
    out = []
    pos = 0
    n = len(body)
    while pos < n:
        (klen,) = _U32.unpack_from(body, pos)
        pos += 4
        key = body[pos : pos + klen]
        pos += klen
        (vlen,) = _U32.unpack_from(body, pos)
        pos += 4
        val = body[pos : pos + vlen]
        pos += vlen
        (ssn,) = _U64.unpack_from(body, pos)
        pos += 8
        out.append((key, val, ssn))
    return out


class CheckpointDaemon:
    """Produces fuzzy checkpoints of a live tuple store.

    ``snapshot_iter`` must yield ``(key: bytes, value: bytes, ssn: int)`` for
    a key partition — it is called concurrently from n threads with disjoint
    partitions and must tolerate concurrent writers (per-tuple atomicity is
    the store's job).
    """

    def __init__(
        self,
        directory: str,
        n_threads: int = 2,
        m_files: int = 2,
        csn_fn: Optional[Callable[[], int]] = None,
    ):
        self.directory = directory
        self.n_threads = n_threads
        self.m_files = m_files
        self.csn_fn = csn_fn or (lambda: 0)
        os.makedirs(directory, exist_ok=True)

    def run_once(
        self,
        partitions: Sequence[Iterable[Tuple[bytes, bytes, int]]],
        validate_timeout: float = 30.0,
        epoch: Optional[int] = None,
    ) -> str:
        """Write one checkpoint; returns the metadata path.

        ``partitions`` — one iterable per checkpoint thread (len == n_threads).
        """
        assert len(partitions) == self.n_threads
        epoch = int(time.time() * 1000) if epoch is None else epoch
        rsn = self.csn_fn()
        max_observed = [0] * self.n_threads
        files: List[List[str]] = [[] for _ in range(self.n_threads)]

        def _worker(i: int) -> None:
            entries = list(partitions[i])
            for _, _, ssn in entries:
                if ssn > max_observed[i]:
                    max_observed[i] = ssn
            # split this thread's partition across m files
            chunks = [entries[j :: self.m_files] for j in range(self.m_files)]
            for j, chunk in enumerate(chunks):
                path = os.path.join(self.directory, f"ckpt_{epoch}_{i}_{j}.bin")
                with open(path, "wb") as f:
                    f.write(_encode_entries(chunk))
                    f.flush()
                    os.fsync(f.fileno())
                files[i].append(path)

        # parallel_for propagates worker exceptions after joining everyone:
        # a dead writer must abort the whole checkpoint *before* the metadata
        # publish below, or a partial file set gets blessed as valid
        try:
            parallel_for(self.n_threads, _worker, parallel=True)
        except BaseException:
            # best-effort cleanup of the partial epoch; never publish meta
            for fs in files:
                for p in fs:
                    try:
                        os.remove(p)
                    except OSError:
                        pass
            raise

        # ELR validity: wait until CSN passes every observed SSN
        needed = max(max_observed) if max_observed else 0
        deadline = time.monotonic() + validate_timeout
        while self.csn_fn() < needed:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"checkpoint validation timed out: csn={self.csn_fn()} < observed={needed}"
                )
            time.sleep(1e-4)

        meta = {
            "epoch": epoch,
            "rsn": rsn,
            "max_observed": needed,
            "files": [p for fs in files for p in fs],
        }
        meta_path = os.path.join(self.directory, f"ckpt_{epoch}.meta.json")
        tmp = meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, meta_path)  # atomic publish
        return meta_path


def load_latest_checkpoint_meta(directory: str) -> Optional[dict]:
    """Metadata of the newest complete checkpoint, or None.

    "Newest" means the largest *numeric* epoch: the filenames are
    ``ckpt_{epoch}.meta.json`` and a lexicographic sort would rank epoch
    ``999`` above ``1000`` (shorter string, bigger leading digit), making
    recovery replay from a stale RSN once epochs cross a digit boundary.

    This is also the cheap probe the log truncator polls (it needs the
    ``rsn``/``epoch`` watermarks, never the tuple image).
    """
    if not os.path.isdir(directory):
        return None
    epochs = []
    for p in os.listdir(directory):
        m = _META_RE.match(p)
        if m:
            epochs.append((int(m.group(1)), p))
    if not epochs:
        return None
    _, newest = max(epochs)
    with open(os.path.join(directory, newest)) as f:
        return json.load(f)


def load_latest_checkpoint(directory: str, parallel: bool = True) -> Optional[CheckpointData]:
    """Load the newest complete checkpoint (recovery stage 1)."""
    meta = load_latest_checkpoint_meta(directory)
    if meta is None:
        return None
    data: Dict[bytes, Tuple[bytes, int]] = {}
    lock = threading.Lock()

    def _load(path: str) -> None:
        try:
            with open(path, "rb") as f:
                entries = _decode_entries(f.read())
        except FileNotFoundError:
            entries = []
        with lock:
            for key, val, ssn in entries:
                cur = data.get(key)
                if cur is None or ssn > cur[1]:
                    data[key] = (val, ssn)

    files = meta["files"]
    parallel_for(len(files), lambda i: _load(files[i]), parallel)
    return CheckpointData(rsn=meta["rsn"], data=data, files=files)
