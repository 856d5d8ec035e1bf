"""Dense columnar tuple store — the array-native twin of :class:`Table`.

Where :class:`~repro.db.table.Table` keeps one :class:`TupleCell` object per
key (with a per-tuple ``threading.Lock``), ``ArrayTable`` holds the same
state as struct-of-arrays over dense integer rows:

* ``ssn``        — int64 per-tuple sequence numbers (Algorithm 1 state);
* ``lock_owner`` — int64 write-lock owner tids (0 = free), maintained
  vectorized so batch validation can test/claim whole index arrays;
* ``values``     — object array of value bytes.

A ``key -> row`` dict maps the flat key space onto rows; rows are append
-only and never reused, so an index array gathered once stays valid for the
life of the table.  This is the substrate of the batched OCC executor
(`repro.db.batch`): validation, SSN base computation, and write-back are
all gathers/scatters over these columns — the per-tuple lock round-trips of
the scalar path collapse into a handful of array ops under one mutex.

The layout deliberately mirrors the columnar *log* layout
(:class:`~repro.core.txn.ColumnarLog`) that recovery decodes: the same
(key, value, ssn) triple flows from execution through logging to replay
without leaving array form.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .table import Table


class ArrayTable:
    """A flat key space over dense columnar rows (batched forward path)."""

    def __init__(self, capacity: int = 1024, name: str = "main"):
        self.name = name
        capacity = max(capacity, 1)
        self._index: Dict[str, int] = {}
        self._keys: List[str] = []
        self._keys_b: List[bytes] = []   # encoded key bytes (log framing)
        self.ssn = np.zeros(capacity, dtype=np.int64)
        self.lock_owner = np.zeros(capacity, dtype=np.int64)
        self.key_len = np.zeros(capacity, dtype=np.int64)  # len(encoded key)
        self.values = np.empty(capacity, dtype=object)
        # one mutex guards structural growth and the vectorized
        # claim/apply/release critical sections of the batch executor
        self.mutex = threading.Lock()

    # --- rows ----------------------------------------------------------------
    @property
    def n(self) -> int:
        return len(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def __contains__(self, key: str) -> bool:
        return key in self._index

    def _grow(self, need: int) -> None:
        cap = len(self.ssn)
        if need <= cap:
            return
        new_cap = max(need, cap * 2)
        for name in ("ssn", "lock_owner", "key_len", "values"):
            old = getattr(self, name)
            arr = np.zeros(new_cap, old.dtype) if old.dtype != object else np.empty(new_cap, object)
            arr[:cap] = old
            setattr(self, name, arr)

    def insert(self, key: str, value: bytes) -> int:
        """Upsert one key; returns its row (``Table.insert`` duck-type, so
        the YCSB/TPC-C loaders work unchanged against either store)."""
        with self.mutex:
            row = self._index.get(key)
            if row is None:
                row = self._insert_locked(key)
            self.values[row] = value
            return row

    def _insert_locked(self, key: str, kb: Optional[bytes] = None) -> int:
        row = len(self._keys)
        self._grow(row + 1)
        self._index[key] = row
        self._keys.append(key)
        kb = key.encode() if kb is None else kb
        self._keys_b.append(kb)
        self.key_len[row] = len(kb)
        self.values[row] = b""
        return row

    def rows_for(self, keys: Sequence[str]) -> np.ndarray:
        """Map keys to rows, inserting missing ones (batched
        ``get_or_insert``).  Returns an int64 index array."""
        index = self._index
        out = np.empty(len(keys), dtype=np.int64)
        missing: List[Tuple[int, str]] = []
        for i, k in enumerate(keys):
            row = index.get(k)
            if row is None:
                missing.append((i, k))
                out[i] = -1
            else:
                out[i] = row
        if missing:
            with self.mutex:
                for i, k in missing:
                    row = index.get(k)
                    out[i] = self._insert_locked(k) if row is None else row
        return out

    def rows_for_bytes(self, keys: Sequence[bytes]) -> np.ndarray:
        """Map exact key *bytes* to rows, inserting missing ones — the
        replica-apply entry (`repro.replica`), where keys arrive as decoded
        log bytes rather than workload strings.  The string index entry is
        the utf-8/surrogateescape decoding: for any key a workload wrote
        through the string API it equals that string exactly (``insert``
        frames keys as utf-8), so replica point reads find it, and the
        escape round-trip keeps the mapping injective for arbitrary bytes.
        :attr:`key_bytes_for`/:meth:`to_dict` keep the exact original
        bytes."""
        index = self._index
        out = np.empty(len(keys), dtype=np.int64)
        missing: List[Tuple[int, str, bytes]] = []
        for i, kb in enumerate(keys):
            k = kb.decode("utf-8", "surrogateescape")
            row = index.get(k)
            if row is None:
                missing.append((i, k, kb))
                out[i] = -1
            else:
                out[i] = row
        if missing:
            with self.mutex:
                for i, k, kb in missing:
                    row = index.get(k)
                    out[i] = self._insert_locked(k, kb) if row is None else row
        return out

    def upsert_bytes(
        self, keys: Sequence[bytes], vals: np.ndarray, ssns: np.ndarray
    ) -> None:
        """Guarded batch upsert by exact key bytes: each (key, value, ssn)
        lands iff its SSN strictly exceeds the row's current one (the
        last-writer-wins replay guard).  Row inserts and the fold happen
        under **one** :attr:`mutex` hold, so a concurrent reader can never
        observe a freshly-inserted phantom row (``b""``, ssn 0) or a torn
        (value, ssn) pair — this is the replica applier's fold primitive."""
        with self.mutex:
            rows = np.empty(len(keys), dtype=np.int64)
            fresh = np.zeros(len(keys), dtype=bool)
            index = self._index
            for i, kb in enumerate(keys):
                k = kb.decode("utf-8", "surrogateescape")
                row = index.get(k)
                if row is None:
                    rows[i] = self._insert_locked(k, kb)
                    fresh[i] = True
                else:
                    rows[i] = row
            # a freshly-inserted row always takes the write: its placeholder
            # (b"", ssn 0) would otherwise win the strict guard against an
            # ssn-0 upsert — exactly the shape of a full-image checkpoint
            # row for a key loaded before any logged write touched it
            upd = fresh | (ssns > self.ssn[rows])
            if upd.any():
                self.ssn[rows[upd]] = ssns[upd]
                self.values[rows[upd]] = vals[upd]

    def row_of(self, key: str) -> Optional[int]:
        return self._index.get(key)

    def key_of(self, row: int) -> str:
        return self._keys[row]

    def key_bytes_for(self, rows: Sequence[int]) -> List[bytes]:
        """Encoded key bytes for ``rows`` (log-record framing: the indexed
        batch pipeline encodes keys straight from this column)."""
        kb = self._keys_b
        return [kb[r] for r in rows]

    # --- point access (tests / drivers) -------------------------------------
    def get(self, key: str) -> Optional[Tuple[bytes, int]]:
        """(value, ssn) of ``key``, or None — the batch drivers' read hook."""
        row = self._index.get(key)
        if row is None:
            return None
        return self.values[row], int(self.ssn[row])

    def get_or_insert(self, key: str) -> Tuple[bytes, int]:
        row = self._index.get(key)
        if row is None:
            with self.mutex:
                row = self._index.get(key)
                if row is None:
                    row = self._insert_locked(key)
        return self.values[row], int(self.ssn[row])

    # --- vectorized locks (batch validation) ---------------------------------
    def locked_rows(self, rows: np.ndarray, owner: int = 0) -> np.ndarray:
        """Boolean mask of ``rows`` held by a *different* owner."""
        held = self.lock_owner[rows]
        return (held != 0) & (held != owner)

    def claim_rows(self, rows: np.ndarray, owner) -> None:
        """Take the write locks for ``rows`` — ``owner`` is a tid or a
        per-row tid array (caller holds :attr:`mutex` and has verified the
        rows free via :meth:`locked_rows`)."""
        self.lock_owner[rows] = owner

    def release_rows(self, rows: np.ndarray) -> None:
        self.lock_owner[rows] = 0

    # --- interop ------------------------------------------------------------
    @classmethod
    def from_table(cls, table: Table) -> "ArrayTable":
        """Columnarize a dict :class:`Table` (cells copied, locks reset)."""
        out = cls(capacity=max(len(table), 1), name=table.name)
        for key in table.sorted_keys():
            cell = table.get(key)
            row = out._insert_locked(key)
            out.values[row] = cell.value
            out.ssn[row] = cell.ssn
        return out

    @classmethod
    def from_arrays(
        cls,
        keys: Sequence[str],
        values: Sequence[bytes],
        ssn: Sequence[int],
        name: str = "main",
    ) -> "ArrayTable":
        """Build a table from row-aligned columns (row ``i`` holds
        ``keys[i]``, ``values[i]``, ``ssn[i]``; locks free) — the way a
        table's state crosses over from another store that keeps the same
        columns, so both start from one state."""
        n = len(keys)
        out = cls(capacity=max(n, 1), name=name)
        for key in keys:
            out._insert_locked(key)
        assert out.n == n, "duplicate keys in from_arrays"
        out.values[:n] = list(values)
        out.ssn[:n] = np.asarray(ssn, dtype=np.int64)
        return out

    def items(self) -> Iterator[Tuple[str, bytes, int]]:
        for key, row in self._index.items():
            yield key, self.values[row], int(self.ssn[row])

    def to_dict(self) -> Dict[bytes, Tuple[bytes, int]]:
        """``key_bytes -> (value, ssn)`` — the :class:`RecoveredState.data`
        shape, for direct comparison against a post-crash recovery."""
        return {
            self._keys_b[row]: (self.values[row], int(self.ssn[row]))
            for row in self._index.values()
        }
