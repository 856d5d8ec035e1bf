"""Commit protocol (paper §4.3).

Each worker owns two private commit queues:

* ``Qww`` — transactions with *only* write operations.  Committable as soon
  as their own record is durable: ``ssn <= DSN(buffer)``.
* ``Qwr`` — transactions with a read set (potential RAW dependencies, incl.
  read-only transactions).  Committable when ``ssn <= CSN`` where
  ``CSN = min over buffers of DSN`` — every RAW predecessor has a smaller
  SSN, hence is durable in *whichever* buffer holds it.

Queues are FIFO per worker and SSNs are monotone per buffer, so draining
from the head is exact (a blocked head implies a blocked tail for the same
watermark).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Deque, List, Optional, Sequence

from .log_buffer import LogBuffer
from .txn import Txn


class CommitQueues:
    """Per-worker Qww / Qwr pair."""

    def __init__(self, worker_id: int):
        self.worker_id = worker_id
        self.qww: Deque[Txn] = deque()
        self.qwr: Deque[Txn] = deque()
        # Queues are worker-private in the paper; a lock keeps them safe if a
        # separate committer thread drains them (engine option).
        self.lock = threading.Lock()

    def push(self, txn: Txn) -> None:
        with self.lock:
            if txn.write_only:
                self.qww.append(txn)
            else:
                self.qwr.append(txn)

    def push_batch(self, txns: Sequence[Txn]) -> None:
        """Enqueue a batch under one lock acquisition (batched forward path).
        ``txns`` must be in SSN order per queue, which holds for any slice of
        a batch allocated through ``reserve_batch`` (SSNs are monotone in
        batch order per buffer)."""
        with self.lock:
            for txn in txns:
                if txn.write_only:
                    self.qww.append(txn)
                else:
                    self.qwr.append(txn)

    def pending(self) -> int:
        with self.lock:
            return len(self.qww) + len(self.qwr)


class CommitProtocol:
    """Drains commit queues against the DSN/CSN watermarks."""

    def __init__(self, buffers: List[LogBuffer], on_commit: Optional[Callable[[Txn], None]] = None):
        self.buffers = buffers
        self.on_commit = on_commit
        self._csn = 0
        self._csn_lock = threading.Lock()

    # --- Algorithm 2, AdvancingCSN ----------------------------------------
    def advance_csn(self) -> int:
        csn = min(b.dsn for b in self.buffers) if self.buffers else 0
        with self._csn_lock:
            if csn > self._csn:
                self._csn = csn
            return self._csn

    @property
    def csn(self) -> int:
        return self._csn

    # --- commit stage -------------------------------------------------------
    def committable(self, ssn: int, has_reads: bool, buffer_id: int = -1) -> bool:
        """The watermark rule, factored out of :meth:`drain` so external
        coordinators (the sharded engine's cross-shard commit, which applies
        this same test *per participant shard*) share one definition:

        * write-only  — own-buffer durability: ``ssn <= DSN(buffer_id)``;
        * with reads  — global committability: ``ssn <= CSN`` (every RAW
          predecessor has a smaller SSN, hence is durable in whichever
          buffer holds it; read-only txns pass ``buffer_id=-1``).
        """
        if has_reads:
            return ssn <= self.advance_csn()
        return ssn <= self.buffers[buffer_id].dsn

    def _commit(self, txn: Txn) -> None:
        txn.committed = True
        txn.t_commit = time.perf_counter()
        if self.on_commit is not None:
            self.on_commit(txn)

    def drain(self, queues: CommitQueues) -> int:
        """Commit every currently-committable transaction for one worker
        (the :meth:`committable` rule, with the CSN hoisted out of the Qwr
        loop — it only grows during a drain).  Returns the number
        committed."""
        n = 0
        with queues.lock:
            # Qww: own-buffer durability only
            while queues.qww:
                txn = queues.qww[0]
                if txn.ssn <= self.buffers[txn.buffer_id].dsn:
                    queues.qww.popleft()
                    self._commit(txn)
                    n += 1
                else:
                    break
            # Qwr: global committability (CSN)
            csn = self.advance_csn()
            while queues.qwr:
                txn = queues.qwr[0]
                # read-only txns have buffer_id == -1 and commit purely on CSN
                if txn.ssn <= csn:
                    queues.qwr.popleft()
                    self._commit(txn)
                    n += 1
                else:
                    break
        return n
