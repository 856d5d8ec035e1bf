"""YCSB workloads (paper §6.2), scaled for this container.

* dataset: single table, primary key + 10 columns of 100 B each.
* write-only: each txn updates all 10 columns of one uniformly-random key.
* hybrid: each txn updates one column of one key + key-range scan of fixed
  length (the scan length controls the RAW/WAR dependency mix — Fig. 10).

The paper loads 10 M rows and runs 10 M txns; defaults here are scaled down
(100 K rows) since throughput *ratios* between logging variants are the
reproduction target (DESIGN §9).
"""

from __future__ import annotations

import random
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .batch import TxnSpec
from .occ import OCCWorker
from .table import Table

N_COLS = 10
COL_BYTES = 100


def key_of(i: int) -> str:
    return f"user{i:010d}"


class Zipfian:
    """YCSB-standard Zipfian key-index generator (Gray et al., "Quickly
    Generating Billion-Record Synthetic Databases"): item rank ``r`` is
    drawn with probability ∝ ``1 / r^theta`` over ``[0, n)``.  ``theta``
    0.99 is the YCSB default; 0 degenerates to uniform.

    The ``zeta(n)`` normalizer is the one O(n) cost, paid once at
    construction; draws are O(1).  :meth:`sample` is the vectorized batch
    twin (same closed form applied to a uniform array — used by the batch
    workload generators), :meth:`next` the scalar single-txn draw open-loop
    clients use.  Rank→item identity is left as-is (rank 0 = item 0): the
    serving-tier skew tests want a *known* hottest key, and callers that
    need scrambled placement can permute indices themselves.
    """

    def __init__(self, n: int, theta: float = 0.99, seed: int = 0):
        assert n >= 2 and 0.0 <= theta < 1.0, "need n >= 2, 0 <= theta < 1"
        self.n = n
        self.theta = theta
        self.rng = np.random.default_rng(seed)
        ranks = np.arange(1, n + 1, dtype=np.float64)
        self.zetan = float(np.sum(ranks ** -theta))
        self.zeta2 = 1.0 + 2.0 ** -theta
        self.alpha = 1.0 / (1.0 - theta)
        self.eta = (1.0 - (2.0 / n) ** (1.0 - theta)) / (
            1.0 - self.zeta2 / self.zetan
        )

    def sample(self, size: int) -> np.ndarray:
        """``size`` zipfian item indices in ``[0, n)`` (vectorized)."""
        u = self.rng.random(size)
        uz = u * self.zetan
        spread = self.n * (self.eta * u - self.eta + 1.0) ** self.alpha
        idx = np.where(
            uz < 1.0, 0, np.where(uz < self.zeta2, 1, spread.astype(np.int64))
        )
        return np.minimum(idx.astype(np.int64), self.n - 1)

    def next(self) -> int:
        return int(self.sample(1)[0])


def load(table, n_records: int = 100_000, seed: int = 7) -> None:
    """Populate ``table`` — any store with ``insert(key, value)``, i.e. the
    dict :class:`Table` or the columnar ``ArrayTable`` interchangeably."""
    rng = random.Random(seed)
    for i in range(n_records):
        table.insert(key_of(i), rng.randbytes(N_COLS * COL_BYTES))


class YCSBWriteOnly:
    """Write-only workload: update all columns of one tuple.

    ``theta > 0`` switches key selection from uniform to Zipfian skew
    (hot-key contention — the serving tier's retry-under-skew workload);
    0.0 keeps the original uniform draw, byte-compatible with old seeds.
    """

    def __init__(self, n_records: int, seed: int = 0, theta: float = 0.0):
        self.n_records = n_records
        self.rng = random.Random(seed)
        self._vrng = np.random.default_rng(seed)  # C-speed value payloads
        self.zipf = Zipfian(n_records, theta, seed=seed) if theta > 0 else None

    def _key_indices(self, n: int) -> np.ndarray:
        if self.zipf is not None:
            return self.zipf.sample(n)
        return self._vrng.integers(0, self.n_records, n)

    def next_txn(self, worker: OCCWorker):
        i = self.zipf.next() if self.zipf else self.rng.randrange(self.n_records)
        value = self.rng.randbytes(N_COLS * COL_BYTES)
        return worker.execute(reads=[], writes=[(key_of(i), value)])

    def next_batch(self, n: int) -> List[TxnSpec]:
        """``n`` write-only txn specs for the batched executor
        (`repro.db.batch.BatchOCC`).  Generation is itself batched: one
        value-blob draw sliced per txn, one vectorized key-index draw."""
        nbytes = N_COLS * COL_BYTES
        blob = self._vrng.bytes(n * nbytes)
        idx = self._key_indices(n)
        return [
            TxnSpec(writes=[(key_of(k), blob[i * nbytes : (i + 1) * nbytes])])
            for i, k in enumerate(idx.tolist())
        ]

    def next_specs(self, n: int) -> List[TxnSpec]:
        """Alias of :meth:`next_batch` under the serving-tier name: open-loop
        clients pre-draw ``n`` single-txn specs and submit them one at a
        time, so "a batch of specs" and "n client arrivals" are the same
        draw."""
        return self.next_batch(n)

    def next_batch_indexed(self, n: int):
        """The same batch as index arrays for ``BatchOCC.execute_indexed``:
        ``(rd_row, rd_start, wr_key_idx, wr_start, values, vlen)``.  Key
        indices equal ArrayTable rows when the table was populated by
        :func:`load` (keys inserted in index order)."""
        nbytes = N_COLS * COL_BYTES
        blob = self._vrng.bytes(n * nbytes)
        wr_row = self._vrng.integers(0, self.n_records, n)
        starts = np.arange(n + 1, dtype=np.int64)
        values = [blob[i * nbytes : (i + 1) * nbytes] for i in range(n)]
        vlen = np.full(n, nbytes, dtype=np.int64)
        return (np.empty(0, np.int64), np.zeros(n + 1, np.int64),
                wr_row.astype(np.int64), starts, values, vlen)


class RMWSpecFactory:
    """Read-modify-write specs for the serving tier's retry path.

    Each generated closure reads one (optionally Zipfian-hot) key, records
    the tuple SSN observed *at build time*, and writes a value derived from
    the read.  The executor validates the observed SSN, so a spec built
    before a conflicting winner commits loses validation — exactly the abort
    the scheduler's retry-with-backoff must absorb.  The scheduler re-invokes
    the closure on retry, which re-reads the now-current value/SSN, so a
    retried transaction eventually wins.
    """

    def __init__(
        self,
        table,
        n_records: int,
        seed: int = 0,
        theta: float = 0.99,
    ):
        self.table = table  # dict Table (cells) or ArrayTable ((value, ssn))
        self.n_records = n_records
        self.rng = random.Random(seed)
        self.zipf = Zipfian(n_records, theta, seed=seed) if theta > 0 else None

    def _observe(self, key: str) -> Tuple[bytes, int]:
        got = self.table.get_or_insert(key)
        if isinstance(got, tuple):
            return got
        return got.value, got.ssn

    def spec_fn(self):
        """One client transaction: a zero-arg closure over a freshly drawn
        key, usable as ``GroupCommitScheduler.submit(make_spec)`` — every
        invocation (first attempt and each retry) re-reads the key."""
        i = self.zipf.next() if self.zipf else self.rng.randrange(self.n_records)
        key = key_of(i)

        def build() -> TxnSpec:
            value, ssn = self._observe(key)
            head = bytes(b ^ 0xFF for b in value[:COL_BYTES])
            return TxnSpec(
                reads=[key],
                writes=[(key, head + value[COL_BYTES:])],
                observed=[ssn],
            )

        return build


class AdaptiveRMW:
    """Batched read-modify-write specs carrying command framing fields
    (adaptive logging, `repro.core.engine.AdaptivePolicy`).

    Two shapes, selected by ``op``:

    * ``"patch"`` — YCSB-style field update: read one wide tuple, overwrite
      the leading column, keep the tail.  Ships ``(OP_PATCH_PREFIX, new
      head)`` — ``COL_BYTES`` of param against ``N_COLS * COL_BYTES`` of
      tuple, the paper-motivating command-framing win;
    * ``"add_f64"`` — TPC-C-payment-style balance delta: the tuple is a
      little-endian float64 plus an opaque tail, the param the 8-byte delta
      (``OP_ADD_F64``).

    Each spec's write value is the exact post-image the registered op
    re-derives from ``(pre-image, param)`` — the executor applies the value,
    replay re-executes the command, and crash equivalence holds either way.
    Keys are drawn *without replacement per batch* so specs built against
    the same table snapshot never invalidate each other mid-batch.
    """

    def __init__(self, table, n_records: int, seed: int = 0,
                 op: str = "patch"):
        if op not in ("patch", "add_f64"):
            raise ValueError(f"unknown AdaptiveRMW op {op!r}")
        from ..core.command import OP_ADD_F64, OP_PATCH_PREFIX
        self.table = table
        self.n_records = n_records
        self.op = op
        self.op_id = OP_PATCH_PREFIX if op == "patch" else OP_ADD_F64
        self._rng = np.random.default_rng(seed)

    def next_batch(self, n: int) -> List[TxnSpec]:
        import struct as _struct
        n = min(n, self.n_records)
        idx = self._rng.choice(self.n_records, size=n, replace=False)
        specs: List[TxnSpec] = []
        for i in idx.tolist():
            key = key_of(i)
            value, ssn = self.table.get(key)
            if self.op == "patch":
                param = bytes(b ^ 0xFF for b in value[:COL_BYTES])
                new = param + value[COL_BYTES:]
            else:
                delta = float(self._rng.integers(1, 500)) / 100.0
                param = _struct.pack("<d", delta)
                old = _struct.unpack_from("<d", value)[0] if len(value) >= 8 else 0.0
                new = _struct.pack("<d", old + delta) + value[8:]
            specs.append(TxnSpec(
                reads=[key], writes=[(key, new)], observed=[ssn],
                cmd_op=self.op_id, cmd_params=[param],
            ))
        return specs


class YCSBHybrid:
    """Hybrid workload: one single-column write + a fixed-length scan."""

    def __init__(self, n_records: int, scan_length: int = 10, seed: int = 0):
        self.n_records = n_records
        self.scan_length = scan_length
        self.rng = random.Random(seed)

    def next_txn(self, worker: OCCWorker):
        wkey = key_of(self.rng.randrange(self.n_records))
        value = self.rng.randbytes(COL_BYTES)  # one column
        scans = []
        if self.scan_length > 0:
            start = key_of(self.rng.randrange(self.n_records))
            scans.append((start, self.scan_length))
        return worker.execute(reads=[], writes=[(wkey, value)], scans=scans)

    def next_batch(self, n: int) -> List[TxnSpec]:
        """Batched hybrid specs: the key-range scan expands to explicit point
        reads (YCSB keys are fixed-format, so logical order == key order —
        the same assumption ``Table.scan_range`` makes)."""
        rng = self.rng
        out: List[TxnSpec] = []
        for _ in range(n):
            wkey = key_of(rng.randrange(self.n_records))
            start = rng.randrange(self.n_records)
            reads = [
                key_of(j)
                for j in range(start, min(start + self.scan_length, self.n_records))
            ]
            out.append(TxnSpec(reads=reads, writes=[(wkey, rng.randbytes(COL_BYTES))]))
        return out
