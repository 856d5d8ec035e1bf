"""Open-loop client sessions for the serving tier.

Closed-loop drivers (every benchmark before this tier) submit the next
transaction only after the previous one finishes, so measured latency can
never exceed service time — overload is invisible.  The open-loop driver
models independent clients: arrivals follow a Poisson process at a fixed
*offered* rate regardless of how the system is doing, and latency is
measured from the **scheduled** arrival time, so queueing delay (including
delay caused by the submitter itself falling behind) is charged to the
system, never silently dropped — the standard coordinated-omission fix.

``OpenLoopDriver`` drives a threaded :class:`GroupCommitScheduler`;
``run_stepped_schedule`` replays a deterministic arrival schedule against a
stepped one (the shape every serve test uses).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..db.batch import TxnSpec
from .scheduler import ABORTED, ACKED, REJECTED, GroupCommitScheduler, Ticket


@dataclass
class DriverReport:
    """Outcome of one open-loop run at a fixed offered load."""

    offered_per_s: float
    duration_s: float
    submitted: int
    acked: int
    rejected: int
    aborted: int
    latencies_ms: np.ndarray = field(default_factory=lambda: np.empty(0))

    @property
    def goodput_per_s(self) -> float:
        return self.acked / self.duration_s if self.duration_s else 0.0

    def pct_ms(self, q: float) -> float:
        if not len(self.latencies_ms):
            return float("nan")
        return float(np.percentile(self.latencies_ms, q))


class OpenLoopDriver:
    """Submit pre-generated specs at Poisson arrival times (threaded mode).

    ``specs`` are generated up front (vectorized workload draws) so the
    submission loop does no per-txn generation work; at high offered rates
    the loop catches up in bursts, which is exactly what a lagging load
    generator does — and scheduled-arrival latency accounting keeps the
    numbers honest when it happens.
    """

    def __init__(
        self,
        sched: GroupCommitScheduler,
        specs: Sequence[TxnSpec],
        rate_per_s: float,
        seed: int = 0,
    ):
        self.sched = sched
        self.specs = list(specs)
        self.rate = rate_per_s
        rng = np.random.default_rng(seed)
        gaps = rng.exponential(1.0 / rate_per_s, len(self.specs))
        self.offsets = np.cumsum(gaps)  # scheduled arrival offsets (s)

    def run(self, settle_timeout_s: float = 30.0) -> DriverReport:
        """Blocking: submit every spec at its scheduled time, then wait for
        all tickets to terminate (the scheduler must be started)."""
        t0 = time.perf_counter()
        tickets: List[Ticket] = []
        for i, spec in enumerate(self.specs):
            due = t0 + self.offsets[i]
            now = time.perf_counter()
            if now < due:
                time.sleep(due - now)
            tickets.append(self.sched.submit(spec, client_id=i))
        # settle: every admitted txn must reach ACKED or ABORTED
        deadline = time.perf_counter() + settle_timeout_s
        for t in tickets:
            t.wait(timeout=max(0.0, deadline - time.perf_counter()))
        # goodput denominator: submission window through the last released
        # ack — a straggler that never acks within the settle window must
        # not inflate the divisor for the work that did complete
        t_end = max(
            [t.t_ack for t in tickets if t.status == ACKED],
            default=time.perf_counter(),
        )
        duration = max(t_end, t0 + self.offsets[-1]) - t0
        lat = np.asarray(
            [
                (t.t_ack - (t0 + self.offsets[i])) * 1e3
                for i, t in enumerate(tickets)
                if t.status == ACKED
            ]
        )
        n_acked = sum(1 for t in tickets if t.status == ACKED)
        n_rej = sum(1 for t in tickets if t.status == REJECTED)
        n_ab = sum(1 for t in tickets if t.status == ABORTED)
        return DriverReport(
            offered_per_s=self.rate,
            duration_s=duration,
            submitted=len(tickets),
            acked=n_acked,
            rejected=n_rej,
            aborted=n_ab,
            latencies_ms=lat,
        )


def run_stepped_schedule(
    sched: GroupCommitScheduler,
    schedule: Sequence[Tuple[int, TxnSpec]],
    tick_parts_fn: Optional[Callable[[int], Optional[Sequence[int]]]] = None,
    max_steps: int = 10_000,
) -> List[Ticket]:
    """Replay a deterministic arrival schedule against a stepped scheduler.

    ``schedule`` is a list of ``(arrival_step, spec)`` pairs (any order;
    ties submit in list order).  Before each ``step()``, every spec whose
    arrival step has come is submitted.  ``tick_parts_fn(step)`` chooses
    which device subset flushes that step (None → all) — randomized
    interleaving tests drive DSN/CSN divergence through it.  Runs until all
    tickets are terminal; returns them in submission order.
    """
    by_step: Dict[int, List[Tuple[int, TxnSpec]]] = {}
    for i, (at, spec) in enumerate(schedule):
        by_step.setdefault(int(at), []).append((i, spec))
    tickets: List[Optional[Ticket]] = [None] * len(schedule)
    last_arrival = max(by_step) if by_step else 0
    for _ in range(max_steps):
        step = sched.now_step  # arrivals land before the step they're due
        for i, spec in by_step.pop(step, ()):
            tickets[i] = sched.submit(spec, client_id=i)
        sched.step(tick_parts_fn(step) if tick_parts_fn else None)
        if step >= last_arrival and all(
            t is not None and t.done for t in tickets
        ):
            return tickets  # type: ignore[return-value]
    raise TimeoutError("stepped schedule did not terminate")
