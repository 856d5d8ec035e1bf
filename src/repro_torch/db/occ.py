"""Optimistic concurrency control with SSN commit timestamps (paper §4.4).

Three phases per transaction:

* **read** — no locks; read-set entries record (cell, observed ssn, value);
  writes buffered in a private write set.
* **validation** — lock the write set in primary-key order (fixed order =>
  deadlock-free, as in Silo/TicToc); validate the read set: abort if a tuple
  is locked by another transaction or its SSN changed; on success allocate
  the SSN via the logging engine (Algorithm 1) — the SSN doubles as the
  commit timestamp, replacing a centralized timestamp allocator.
* **write** — apply new values + the SSN to the tuples, release locks
  (early lock release: incoming readers may observe pre-committed data —
  recoverability guarantees they commit after us), publish the log record,
  enqueue for commit.

``execute`` returns the pre-committed Txn (durable commit happens when the
engine's commit protocol drains it) or None if aborted.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

from ..core import ssn as ssn_mod
from ..core.engine import LoggingEngine
from ..core.txn import Txn
from .table import Table, TupleCell

# default tid stripe width: tids are striped ``worker_id + 1 + k * stride``,
# so allocation is lock-free per worker and globally collision-free for any
# worker count below the stride — the global next_tid() lock of the original
# implementation would otherwise serialize the batched path
TID_STRIDE = 1024


class TidStripe:
    """Lock-free per-worker transaction-id allocation.

    Worker ``w`` draws from the arithmetic progression ``w + 1 + k*stride``
    (tid 0 is reserved for engine-internal records, e.g. heartbeats), so no
    two workers under the same stride can ever collide and no cross-worker
    lock is needed."""

    __slots__ = ("_next", "stride")

    def __init__(self, worker_id: int, stride: int = TID_STRIDE):
        assert 0 <= worker_id < stride, f"worker_id {worker_id} >= stride {stride}"
        self._next = worker_id + 1
        self.stride = stride

    def next(self) -> int:
        tid = self._next
        self._next += self.stride
        return tid


class OCCWorker:
    """One worker thread's OCC execution context."""

    def __init__(
        self,
        table: Table,
        engine: LoggingEngine,
        worker_id: int,
        tid_stride: int = TID_STRIDE,
    ):
        self.table = table
        self.engine = engine
        self.worker_id = worker_id
        self.tids = TidStripe(worker_id, tid_stride)
        engine.register_worker(worker_id)
        self.committed_submitted = 0
        self.aborts = 0

    # --- transaction execution ----------------------------------------------
    def execute(
        self,
        reads: Sequence[str],
        writes: Sequence[Tuple[str, bytes]],
        scans: Sequence[Tuple[str, int]] = (),
    ) -> Optional[Txn]:
        """Run one transaction; returns the pre-committed Txn or None on abort."""
        tid = self.tids.next()
        txn = Txn(tid=tid)
        txn.worker_id = self.worker_id  # type: ignore[attr-defined]
        txn.t_start = time.perf_counter()

        # --- read phase ---
        read_cells: List[Tuple[TupleCell, int]] = []
        for key in reads:
            cell = self.table.get_or_insert(key)
            read_cells.append((cell, cell.ssn))
        for start, length in scans:
            for cell in self.table.scan_range(start, length):
                read_cells.append((cell, cell.ssn))
        write_cells: List[Tuple[TupleCell, bytes]] = []
        for key, val in writes:
            cell = self.table.get_or_insert(key)
            write_cells.append((cell, val))

        # --- validation phase ---
        # lock write set in primary-key order (deadlock freedom)
        write_cells.sort(key=lambda cv: cv[0].key)
        locked: List[TupleCell] = []
        ok = True
        for cell, _ in write_cells:
            # bounded spin on try_lock: contention aborts rather than blocks
            acquired = False
            for _ in range(100):
                if cell.try_lock(tid):
                    acquired = True
                    break
            if not acquired:
                ok = False
                break
            locked.append(cell)
        if ok:
            for cell, seen_ssn in read_cells:
                if cell.locked_by_other(tid) or cell.ssn != seen_ssn:
                    ok = False
                    break
        if not ok:
            for cell in locked:
                cell.unlock(tid)
            self.aborts += 1
            txn.aborted = True
            return None

        # SSN allocation (Algorithm 1) — the commit timestamp
        txn.read_set = [(c.key, s) for c, s in read_cells]
        txn.write_set = [(c.key, v) for c, v in write_cells]
        self.engine.allocate(
            txn, [c for c, _ in read_cells], [c for c, _ in write_cells]
        )

        # --- write phase (with early lock release) ---
        for cell, val in write_cells:
            cell.value = val
        if txn.write_set:
            ssn_mod.writeback(txn.ssn, [c for c, _ in write_cells])
        for cell in locked:
            cell.unlock(tid)

        self.engine.publish(txn)
        self.committed_submitted += 1
        return txn

    def drain(self) -> int:
        return self.engine.drain(self.worker_id)
