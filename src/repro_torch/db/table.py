"""In-memory tuple store (DBx1000 analogue).

Each tuple cell carries: value bytes, SSN (the per-tuple sequence number of
Algorithm 1), and a write lock with owner tracking (OCC validation needs
"locked by another transaction" visibility).  Locks are per-tuple and
non-blocking to acquire (``try_lock``), matching the validation-phase
primary-key-ordered locking of §4.4.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterable, Iterator, List, Optional, Tuple


class TupleCell:
    __slots__ = ("key", "value", "ssn", "_owner", "_lock")

    def __init__(self, key: str, value: bytes = b""):
        self.key = key
        self.value = value
        self.ssn = 0
        self._owner = 0          # tid holding the write lock (0 = free)
        self._lock = threading.Lock()

    def try_lock(self, tid: int) -> bool:
        if self._lock.acquire(blocking=False):
            self._owner = tid
            return True
        return False

    def lock(self, tid: int) -> None:
        self._lock.acquire()
        self._owner = tid

    def unlock(self, tid: int) -> None:
        assert self._owner == tid, f"unlock by non-owner {tid} != {self._owner}"
        self._owner = 0
        self._lock.release()

    def locked_by_other(self, tid: int) -> bool:
        return self._owner not in (0, tid)


class Table:
    """A flat key space of tuple cells (composite keys encode TPC-C tables).

    Sorted-key cache behaviour: :meth:`sorted_keys` materializes the sorted
    key list lazily and caches it; any :meth:`insert` of a *new* key
    invalidates the cache (value updates of existing keys do not), so range
    scans and checkpoint partitioning pay the sort only after the key space
    actually changes.  Under insert-heavy workloads interleaved with scans
    this re-sorts per new key — an index (e.g. a B-tree) would amortize
    that; for the fixed-format benchmark key spaces here the key set is
    static after load.
    """

    def __init__(self, name: str = "main"):
        self.name = name
        self._cells: Dict[str, TupleCell] = {}
        self._insert_lock = threading.Lock()
        self._sorted_cache: Optional[List[str]] = None

    def insert(self, key: str, value: bytes) -> TupleCell:
        with self._insert_lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = TupleCell(key, value)
                self._cells[key] = cell
                self._sorted_cache = None
            else:
                cell.value = value
            return cell

    def get(self, key: str) -> Optional[TupleCell]:
        return self._cells.get(key)

    def get_or_insert(self, key: str) -> TupleCell:
        cell = self._cells.get(key)
        if cell is None:
            return self.insert(key, b"")
        return cell

    def __len__(self) -> int:
        return len(self._cells)

    def __contains__(self, key: str) -> bool:
        return key in self._cells

    # --- checkpoint support (§5) -------------------------------------------
    def sorted_keys(self) -> List[str]:
        cache = self._sorted_cache
        if cache is None:
            cache = sorted(self._cells)
            self._sorted_cache = cache
        return cache

    def partitions(self, n: int) -> List[List[str]]:
        """Evenly divide the key space into n partitions (key order)."""
        keys = self.sorted_keys()
        size = (len(keys) + n - 1) // n
        return [keys[i * size : (i + 1) * size] for i in range(n)]

    def snapshot_partition(self, keys: Iterable[str]) -> Iterator[Tuple[bytes, bytes, int]]:
        """Fuzzy-scan a partition: yields (key, value, ssn) without any
        coordination with writers (per-tuple reads are atomic under GIL)."""
        for k in keys:
            cell = self._cells.get(k)
            if cell is not None:
                yield k.encode(), cell.value, cell.ssn

    def scan_range(self, start_key: str, length: int) -> List[TupleCell]:
        """Key-range scan of ``length`` tuples (hybrid YCSB workload).
        Uses lexicographic order over the materialized key list."""
        # note: for benchmark purposes keys are fixed-format so lexicographic
        # order == logical order; a real system would use an index.
        keys = self.sorted_keys()
        i = bisect.bisect_left(keys, start_key)
        return [self._cells[k] for k in keys[i : i + length]]
