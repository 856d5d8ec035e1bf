"""Open-loop group-commit scheduler: the OLTP serving front end.

Everything below the serving tier is a closed-loop driver calling
``execute_batch`` directly; this module models the million-client world the
paper's latency claims (§6, fig7) are about.  Async client sessions submit
*single* transactions; the scheduler coalesces arrivals into batches for
the array-native executor under a configurable latency budget (group
commit), applies admission control when the log or a shard saturates, and
retries validation losers with backoff (hot-key skew).  A client's commit
acknowledgment is released **only** once its record is durable *and*
committable under the Qww/Qwr watermark rule — the scheduler never acks a
transaction itself; it observes ``txn.committed``, which only
:meth:`repro_torch.core.commit.CommitProtocol.drain` (or the cross-shard sweep,
which applies the same ``committable()`` predicate per participant) can
set.  Ack = durable ∧ committable, end to end.

Batch cutting is **strict-FIFO and conflict-free**: a cut is the longest
queue prefix in which no two transactions touch a common key, stopped at
the first conflicting transaction (head-of-line) or at ``max_batch``.
Two consequences:

* within a cut every transaction wins validation round 1 (no intra-batch
  first-come-wins losses), so a group-commit round never silently reorders
  admitted work — commit order *is* admission order, per key and globally;
* the device logs are therefore *invariant under cut points*: for a
  conflict-free arrival schedule, any cut sequence produces byte-identical
  logs to one direct ``execute_batch`` of the same transactions, and for
  arbitrary schedules any two cut configurations produce byte-identical
  logs to each other.  The property tests pin both.

Two operating modes, mirroring the engine:

* **stepped** — :meth:`GroupCommitScheduler.step` advances one deterministic
  iteration: retry re-admission → batch cut → execute → flush (``tick``,
  optionally a chosen device subset) → drain → ack release.  No real
  clocks; time is the step counter.  Every scheduler decision is
  unit-testable and interleavings are reproducible.
* **threaded** — :meth:`start` runs the same loop against real clocks (the
  backend's logger threads flush on the group-commit timer; the scheduler
  loop cuts, drains, and releases acks).  Clients block on
  :meth:`Ticket.wait`.

Admission control is lossless-or-explicit: ``submit`` either admits (the
transaction is then *guaranteed* to terminate in ``ACKED`` or ``ABORTED``)
or returns ``REJECTED`` immediately — an explicit retry-later signal.
Saturation can never silently drop an admitted request: validation losers
re-enter the queue *ahead of* new admissions and exempt from the capacity
bound (re-admitting them through the bounded queue would drop them exactly
when the system is overloaded — the failure mode the overflow test pins).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple, Union

from ..db.batch import TxnSpec
from ..obs.metrics import REGISTRY
from ..trace.span import ST_ACK, ST_CUT, TRACER

# ticket lifecycle ----------------------------------------------------------
QUEUED = "queued"          # admitted, waiting for a batch cut
INFLIGHT = "inflight"      # executed (pre-committed), awaiting durable ack
RETRY_WAIT = "retry_wait"  # lost validation, backing off before re-queue
ACKED = "acked"            # durably committed, ack released to the client
ABORTED = "aborted"        # explicit abort after exhausting retries
REJECTED = "rejected"      # admission refused (queue full) — never queued

_TERMINAL = (ACKED, ABORTED, REJECTED)


@dataclass
class ServeConfig:
    """Scheduler knobs.  Step-denominated fields drive stepped mode,
    second-denominated ones threaded mode; both encode the same policy."""

    max_batch: int = 256              # cut size bound
    latency_budget_steps: int = 1     # stepped: cut when head has waited this
    latency_budget_s: float = 2e-3    # threaded: group-commit window
    queue_capacity: int = 4096        # admission bound (retries exempt)
    max_unacked: Optional[int] = None  # backpressure: stall cuts above this
    max_retries: int = 3              # attempts = 1 + max_retries
    backoff_steps: int = 1            # stepped retry backoff base (doubles)
    backoff_s: float = 5e-4           # threaded retry backoff base (doubles)
    max_rounds: int = 1               # rounds inside execute_batch (cuts are
    #                                   conflict-free, so 1 is exact)
    poll_s: float = 1e-4              # threaded loop idle poll


@dataclass
class Ticket:
    """One client transaction's journey through the serving tier."""

    client_id: int
    spec_fn: Callable[[], TxnSpec]   # regenerated per attempt (fresh reads)
    status: str = QUEUED
    spec: Optional[TxnSpec] = None   # the current attempt's materialized spec
    worker_id: int = -1              # assigned at admission, stable across retries
    attempts: int = 0
    txn: object = None               # Txn or XTxn once executed
    ssn: int = -1
    ack_seq: int = -1                # global ack order (release sequence)
    # timestamps: steps in stepped mode, perf_counter seconds in threaded
    t_submit: float = 0.0
    t_ack: float = 0.0
    _backoff_until: float = 0.0
    _event: Optional[threading.Event] = None

    @property
    def done(self) -> bool:
        return self.status in _TERMINAL

    def wait(self, timeout: Optional[float] = None) -> str:
        """Block until the ticket reaches a terminal status (threaded mode)."""
        if self._event is not None and not self.done:
            self._event.wait(timeout)
        return self.status

    def latency(self) -> float:
        """Commit latency: submission → ack release (steps or seconds)."""
        return self.t_ack - self.t_submit


def _keys_of(spec: TxnSpec) -> List[str]:
    return list(spec.reads) + [k for k, _ in spec.writes]


class GroupCommitScheduler:
    """Coalesces single-transaction submissions into group-commit batches.

    ``backend`` is a :class:`~repro_torch.serve.backend.SingleBackend` or
    :class:`~repro_torch.serve.backend.ShardedBackend`.  Construct, then either
    drive :meth:`step` deterministically or :meth:`start` the threaded loop.
    """

    def __init__(self, backend, cfg: Optional[ServeConfig] = None):
        self.backend = backend
        self.cfg = cfg or ServeConfig()
        self._lock = threading.Lock()
        self._queue: Deque[Ticket] = deque()
        self._n_admitted_queue = 0   # admission-counted entries (≤ capacity)
        self._inflight: List[Ticket] = []
        self._waiting: List[Ticket] = []   # backoff room
        self._admit_seq = 0          # round-robin worker assignment
        self._ack_seq = 0
        self.now_step = 0            # stepped-mode clock
        self._threaded = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # counters / instrumentation
        self.n_submitted = 0
        self.n_admitted = 0
        self.n_rejected = 0
        self.n_acked = 0
        self.n_aborted = 0
        self.n_retries = 0
        self.n_exec_errors = 0
        self.n_cuts = 0
        self.n_cut_txns = 0
        self.queue_samples: List[int] = []
        self._max_queue = 0
        self._max_unacked_seen = 0

    # --- client side --------------------------------------------------------
    def _now(self) -> float:
        return time.perf_counter() if self._threaded else float(self.now_step)

    def submit(
        self,
        spec: Optional[TxnSpec] = None,
        client_id: int = 0,
        make_spec: Optional[Callable[[], TxnSpec]] = None,
    ) -> Ticket:
        """Admit one transaction (or reject it, explicitly and immediately).

        Pass a static ``spec``, or ``make_spec`` for transactions whose spec
        must be regenerated per attempt (read-modify-write: observed SSNs
        and derived values go stale when a retry is needed, so each attempt
        re-reads).  The returned ticket terminates in exactly one of
        ``ACKED`` / ``ABORTED`` / ``REJECTED``.
        """
        assert (spec is None) != (make_spec is None), (
            "pass exactly one of spec / make_spec"
        )
        fn = make_spec if make_spec is not None else (lambda: spec)
        t = Ticket(client_id=client_id, spec_fn=fn)
        if self._threaded:
            t._event = threading.Event()
        with self._lock:
            self.n_submitted += 1
            if self._n_admitted_queue >= self.cfg.queue_capacity:
                t.status = REJECTED
                self.n_rejected += 1
                if REGISTRY.enabled:
                    REGISTRY.count("serve.rejected")
                if t._event is not None:
                    t._event.set()
                return t
            t.spec = t.spec_fn()
            t.attempts = 1
            t.worker_id = self._admit_seq % self.backend.n_workers
            self._admit_seq += 1
            t.t_submit = self._now()
            self._queue.append(t)
            self._n_admitted_queue += 1
            self.n_admitted += 1
            self._max_queue = max(self._max_queue, len(self._queue))
        return t

    # --- scheduler internals ------------------------------------------------
    def _requeue_ready_retries(self, now: float) -> None:
        """Move backoff-expired retries to the *front* of the queue, oldest
        first.  Retries are already admitted: they bypass the capacity bound
        and do not increment the admission count (lossless-or-explicit)."""
        if not self._waiting:
            return
        ready = [t for t in self._waiting if t._backoff_until <= now]
        if not ready:
            return
        self._waiting = [t for t in self._waiting if t._backoff_until > now]
        for t in sorted(ready, key=lambda t: t.t_submit, reverse=True):
            t.status = QUEUED
            self._queue.appendleft(t)

    def _cut_due(self, now: float) -> bool:
        if not self._queue:
            return False
        cap = self.cfg.max_unacked
        if cap is not None and len(self._inflight) >= cap:
            return False  # durability lag backpressure: stall the cutter
        if len(self._queue) >= self.cfg.max_batch:
            return True
        budget = (
            self.cfg.latency_budget_steps
            if not self._threaded
            else self.cfg.latency_budget_s
        )
        head = self._queue[0]
        wait_from = max(head.t_submit, head._backoff_until)
        return now - wait_from >= budget

    def _cut(self) -> List[Ticket]:
        """Longest conflict-free FIFO prefix of the queue, ≤ max_batch.
        Stops at the first transaction sharing any key with the cut so far —
        per-key *and* global commit order equal admission order, which makes
        the log bytes independent of where cuts land."""
        _trace = TRACER.enabled
        if _trace:
            _t0 = time.perf_counter()
        cut: List[Ticket] = []
        claimed: set = set()
        while self._queue and len(cut) < self.cfg.max_batch:
            t = self._queue[0]
            keys = _keys_of(t.spec)
            if any(k in claimed for k in keys):
                break
            claimed.update(keys)
            self._queue.popleft()
            self._n_admitted_queue -= 1
            cut.append(t)
        if _trace and cut:
            TRACER.record(
                ST_CUT, t0=_t0, t1=time.perf_counter(),
                n_txn=len(cut), aux=len(self._queue),
            )
        if REGISTRY.enabled:
            REGISTRY.gauge_set("serve.queue_depth", float(len(self._queue)))
            REGISTRY.count("serve.cut_txns", len(cut))
        return cut

    def _execute(self, cut: List[Ticket], now: float) -> None:
        outcome = self.backend.execute(  # slow path: outside the lock
            [t.spec for t in cut],
            worker_ids=[t.worker_id for t in cut],
            max_rounds=self.cfg.max_rounds,
        )
        with self._lock:
            self.n_cuts += 1
            self.n_cut_txns += len(cut)
            for i, txn in outcome.committed:
                t = cut[i]
                t.txn = txn
                t.ssn = self._ssn_of(txn)
                t.status = INFLIGHT
                self._inflight.append(t)
            self._max_unacked_seen = max(
                self._max_unacked_seen, len(self._inflight)
            )
            for i in outcome.aborted:
                t = cut[i]
                if t.attempts > self.cfg.max_retries:
                    t.status = ABORTED
                    self.n_aborted += 1
                    if REGISTRY.enabled:
                        REGISTRY.count("serve.aborted")
                    if t._event is not None:
                        t._event.set()
                    continue
                # retry with exponential backoff; the spec is regenerated at
                # re-queue time so observed SSNs / derived values are fresh
                self.n_retries += 1
                if REGISTRY.enabled:
                    REGISTRY.count("serve.retries")
                backoff = (
                    self.cfg.backoff_steps
                    if not self._threaded
                    else self.cfg.backoff_s
                ) * (1 << (t.attempts - 1))
                t.attempts += 1
                t.status = RETRY_WAIT
                t._backoff_until = now + backoff
                t.spec = t.spec_fn()
                self._waiting.append(t)

    def _abort_cut(self, cut: List[Ticket]) -> None:
        """Backend execution failed outright (engine error, not a validation
        loss): terminate the cut's still-pending tickets explicitly.  An
        admitted transaction must never be stranded in a non-terminal state —
        an explicit ABORTED is the honest outcome when the executor itself
        fails (lossless-or-explicit, applied to infrastructure faults)."""
        with self._lock:
            self.n_exec_errors += 1
            for t in cut:
                if not t.done and t.status != INFLIGHT:
                    t.status = ABORTED
                    self.n_aborted += 1
                    if t._event is not None:
                        t._event.set()

    @staticmethod
    def _ssn_of(txn) -> int:
        ssn = getattr(txn, "ssn", None)
        if ssn is not None:
            return int(ssn)
        # XTxn: order by the highest participant SSN (its commit point —
        # the last record that must become durable)
        return max(p.ssn for p in txn.parts)

    def _release_acks(self, now: float) -> int:
        """Release every in-flight transaction whose backend drain marked it
        durably committed, in SSN order (within one release round a RAW
        dependency always acks before its dependent — SSNs order them)."""
        _trace = TRACER.enabled
        if _trace:
            _t0 = time.perf_counter()
        ready = [t for t in self._inflight if t.txn.committed]
        if not ready:
            return 0
        ready.sort(key=lambda t: t.ssn)
        self._inflight = [t for t in self._inflight if not t.txn.committed]
        for t in ready:
            t.status = ACKED
            t.t_ack = now
            t.ack_seq = self._ack_seq
            self._ack_seq += 1
            self.n_acked += 1
            if t._event is not None:
                t._event.set()
        if _trace:
            TRACER.record(
                ST_ACK, txn_lo=ready[0].ssn, txn_hi=ready[-1].ssn,
                t0=_t0, t1=time.perf_counter(), n_txn=len(ready),
            )
        if REGISTRY.enabled:
            REGISTRY.count("serve.acked", len(ready))
            # units follow the scheduler clock: steps (stepped) or seconds
            REGISTRY.observe_many("serve.ack_latency",
                                  [t.latency() for t in ready])
        return len(ready)

    # --- stepped mode -------------------------------------------------------
    def step(self, tick_parts: Optional[Sequence[int]] = None) -> int:
        """One deterministic scheduler iteration:

        1. re-queue backoff-expired retries (ahead of new admissions);
        2. cut a batch if due (size, latency budget, backpressure);
        3. execute it (validate → sequence → publish, pre-commit);
        4. flush — one forced logger tick per buffer in ``tick_parts``
           (default: all; tests pass subsets to randomize DSN/CSN order);
        5. drain commit queues (the Qww/Qwr watermark rule runs here);
        6. release acks for durably committed transactions, in SSN order.

        Returns the number of acks released.  Wall clocks are never read;
        ``now_step`` is the clock.
        """
        assert not self._threaded, "step() is for stepped mode"
        self.now_step += 1
        now = float(self.now_step)
        with self._lock:
            self._requeue_ready_retries(now)
            if self._cut_due(now):
                cut = self._cut()
            else:
                cut = []
            self.queue_samples.append(len(self._queue))
        if cut:
            self._execute(cut, now)
        self.backend.tick(tick_parts)
        self.backend.drain()
        with self._lock:
            return self._release_acks(now)

    def run_until_drained(
        self, max_steps: int = 10_000, tick_parts: Optional[Sequence[int]] = None
    ) -> None:
        """Step until no admitted work remains in any room (test harness)."""
        for _ in range(max_steps):
            self.step(tick_parts)
            with self._lock:
                if not (self._queue or self._inflight or self._waiting):
                    return
        raise TimeoutError(
            f"scheduler not drained after {max_steps} steps: "
            f"queue={len(self._queue)} inflight={len(self._inflight)} "
            f"waiting={len(self._waiting)}"
        )

    # --- threaded mode ------------------------------------------------------
    def start(self) -> None:
        """Run threaded: backend logger threads + one scheduler loop thread.
        ``submit`` becomes thread-safe for any number of client threads."""
        self._threaded = True
        self._stop.clear()
        self.backend.start()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="serve-scheduler"
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            now = time.perf_counter()
            with self._lock:
                self._requeue_ready_retries(now)
                cut = self._cut() if self._cut_due(now) else []
                self.queue_samples.append(len(self._queue))
            if cut:
                try:
                    self._execute(cut, time.perf_counter())
                except Exception:
                    # the loop must survive an executor fault: strand no
                    # admitted ticket, keep serving the rest of the queue
                    self._abort_cut(cut)
            self.backend.drain()
            with self._lock:
                released = self._release_acks(time.perf_counter())
            if not cut and not released:
                time.sleep(self.cfg.poll_s)

    def stop(self, quiesce: bool = True, timeout: float = 30.0) -> None:
        """Stop the loop.  With ``quiesce`` the backend flushes and commits
        everything outstanding first and remaining acks are released —
        a clean shutdown.  ``quiesce=False`` models a crash: in-flight
        transactions stay un-acked (crash tests kill the engine right
        after)."""
        if quiesce:
            # let the live loop drain the rooms itself first
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                with self._lock:
                    idle = not (self._queue or self._inflight or self._waiting)
                if idle:
                    break
                time.sleep(self.cfg.poll_s)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if quiesce:
            # loop is dead now: final flush + drain + release race-free
            self.backend.quiesce(timeout=timeout)
            self.backend.drain()
            with self._lock:
                self._release_acks(time.perf_counter())
        self.backend.stop()

    # --- stats --------------------------------------------------------------
    def stats(self) -> Dict:
        with self._lock:
            qs = self.queue_samples
            return {
                "submitted": self.n_submitted,
                "admitted": self.n_admitted,
                "rejected": self.n_rejected,
                "acked": self.n_acked,
                "aborted": self.n_aborted,
                "retries": self.n_retries,
                "exec_errors": self.n_exec_errors,
                "cuts": self.n_cuts,
                "mean_cut": self.n_cut_txns / self.n_cuts if self.n_cuts else 0.0,
                "queue_depth": len(self._queue),
                "max_queue_depth": self._max_queue,
                "mean_queue_depth": sum(qs) / len(qs) if qs else 0.0,
                "max_unacked": self._max_unacked_seen,
                "backend_queue_depths": self.backend.queue_depths(),
                "saturated": self.backend.saturated(),
            }
