"""Near-zero-overhead structured stage tracer.

A process-local :class:`Tracer` records one row per pipeline-stage span —
``(stage, shard, device, batch_id, txn_span, t_start, t_end, bytes,
n_txn, aux)`` — into preallocated numpy ring buffers.  Hook points live in
the seven pipeline stages:

* ``BatchOCC`` validate / sequence / encode   (`repro.db.batch`)
* ``PoplarEngine`` publish + logger flush     (`repro.core.engine`)
* cross-shard prepare                         (`repro.shard.coordinator`)
* ``LogShipper`` ship + ``ReplicaApplier`` apply  (`repro.replica`)
* ``GroupCommitScheduler`` cut / ack          (`repro.serve.scheduler`)
* recovery decode / replay                    (`repro.core.recovery`)

Every hook is guarded by one attribute load on the module singleton::

    _trace = TRACER.enabled
    if _trace:
        _t0 = time.perf_counter()
    ... stage work ...
    if _trace:
        TRACER.record(ST_..., ...)

so the disabled tracer is a no-op: no allocation, no lock, no branch
beyond the bool test (pinned by ``tests/test_trace.py`` via a
``tracemalloc`` filter on this file).  When enabled, :meth:`Tracer.record`
claims a ring slot under a lock and writes ten scalar cells — a few
microseconds per *batch*-granular event, which is what keeps the measured
tracing overhead below the 3% budget (``BENCH_trace.json``).

``txn_span = (txn_lo, txn_hi)`` carries the SSN range a span covers (flush
spans: the DSN interval made durable; publish spans: the batch's SSN
range), which is what lets `repro.trace.dag` reconstruct durability edges
without any timestamps — the structural dump of two identical stepped runs
is byte-identical even though the wall-clock columns differ.
"""

from __future__ import annotations

import json
import threading
import warnings
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

# --- stage taxonomy ----------------------------------------------------------
ST_VALIDATE = 0    # BatchOCC: access gather + WW/RW/observed-SSN/lock masks
ST_SEQUENCE = 1    # BatchOCC: base-SSN segmented max + Txn bookkeeping
ST_ENCODE = 2      # BatchOCC: per-buffer reserve_batch + columnar framing
ST_PUBLISH = 3     # PoplarEngine.publish_batch: ring memcpy + queue pushes
ST_FLUSH = 4       # logger_tick: segment flushes to the device (IO)
ST_XPREPARE = 5    # CrossShardCoordinator.execute: one span per participant
ST_SHIP = 6        # LogShipper.poll: tail read + streaming columnar decode
ST_APPLY = 7       # ReplicaApplier.apply: vectorized fold into the table
ST_CUT = 8         # GroupCommitScheduler: batch cut + execute
ST_ACK = 9         # GroupCommitScheduler: durable ack release round
ST_RDECODE = 10    # recovery: per-(device, segment) columnar decode
ST_RREPLAY = 11    # recovery: last-writer-wins replay (or the fused pass)
ST_DRIVER = 12     # free-form driver work (benchmarks wrap workload gen)
ST_WRITEBACK = 13  # BatchOCC phase 2: table scatter under claimed locks

STAGE_NAMES = (
    "validate", "sequence", "encode", "publish", "flush", "xprepare",
    "ship", "apply", "cut", "ack", "rdecode", "rreplay", "driver",
    "writeback",
)

# stages that occupy a (GIL-serialized) CPU; ST_FLUSH occupies its device
CPU_STAGES = frozenset(
    (ST_VALIDATE, ST_SEQUENCE, ST_ENCODE, ST_PUBLISH, ST_XPREPARE,
     ST_SHIP, ST_APPLY, ST_CUT, ST_ACK, ST_RDECODE, ST_RREPLAY, ST_DRIVER,
     ST_WRITEBACK)
)

_COLUMNS = (
    ("stage", np.int16), ("shard", np.int32), ("device", np.int32),
    ("batch", np.int64), ("txn_lo", np.int64), ("txn_hi", np.int64),
    ("t0", np.float64), ("t1", np.float64),
    ("nbytes", np.int64), ("n_txn", np.int64), ("aux", np.int64),
)


class _Ctx(threading.local):
    """Ambient per-thread trace context: the executing batch id and shard,
    set by the batch executor so nested hooks (engine publish) can stamp
    their spans without threading ids through every call signature."""

    batch = -1
    shard = 0


@dataclass
class TraceDump:
    """An immutable snapshot of the tracer's rows, oldest first.

    Columns are plain numpy arrays aligned by row; ``dropped`` counts ring
    overwrites (rows lost to capacity).  ``structural_dict`` /
    ``canonical_bytes`` exclude the wall-clock columns, so two identical
    stepped runs serialize byte-identically (`tests/test_trace.py`).
    """

    stage: np.ndarray
    shard: np.ndarray
    device: np.ndarray
    batch: np.ndarray
    txn_lo: np.ndarray
    txn_hi: np.ndarray
    t0: np.ndarray
    t1: np.ndarray
    nbytes: np.ndarray
    n_txn: np.ndarray
    aux: np.ndarray
    dropped: int = 0

    @property
    def n(self) -> int:
        return len(self.stage)

    def duration(self) -> np.ndarray:
        return self.t1 - self.t0

    def makespan(self) -> float:
        """Wall time covered by the trace (first span start → last end)."""
        if not self.n:
            return 0.0
        return float(self.t1.max() - self.t0.min())

    def structural_dict(self) -> Dict:
        """Timestamp-free row dump (the deterministic part of a trace)."""
        return {
            "n": self.n,
            "dropped": self.dropped,
            "stage": self.stage.tolist(),
            "shard": self.shard.tolist(),
            "device": self.device.tolist(),
            "batch": self.batch.tolist(),
            "txn_lo": self.txn_lo.tolist(),
            "txn_hi": self.txn_hi.tolist(),
            "nbytes": self.nbytes.tolist(),
            "n_txn": self.n_txn.tolist(),
            "aux": self.aux.tolist(),
        }

    def to_dict(self) -> Dict:
        d = self.structural_dict()
        d["t0"] = self.t0.tolist()
        d["t1"] = self.t1.tolist()
        return d

    def save(self, path: str, extra: Optional[Dict] = None) -> None:
        """Write the dump as JSON; ``extra`` merges additional top-level
        keys (e.g. ``run_metadata()`` provenance stamps — ``from_dict``
        ignores keys it does not know, so stamped dumps stay loadable)."""
        d = self.to_dict()
        if extra:
            d.update(extra)
        with open(path, "w") as f:
            json.dump(d, f)
            f.write("\n")

    @classmethod
    def from_dict(cls, d: Dict) -> "TraceDump":
        n = d["n"]
        return cls(
            stage=np.asarray(d["stage"], np.int16),
            shard=np.asarray(d["shard"], np.int32),
            device=np.asarray(d["device"], np.int32),
            batch=np.asarray(d["batch"], np.int64),
            txn_lo=np.asarray(d["txn_lo"], np.int64),
            txn_hi=np.asarray(d["txn_hi"], np.int64),
            t0=np.asarray(d.get("t0", [0.0] * n), np.float64),
            t1=np.asarray(d.get("t1", [0.0] * n), np.float64),
            nbytes=np.asarray(d["nbytes"], np.int64),
            n_txn=np.asarray(d["n_txn"], np.int64),
            aux=np.asarray(d["aux"], np.int64),
            dropped=d.get("dropped", 0),
        )

    @classmethod
    def load(cls, path: str) -> "TraceDump":
        with open(path) as f:
            return cls.from_dict(json.load(f))


class Tracer:
    """Ring-buffer stage tracer.  One process-local instance (:data:`TRACER`)
    is shared by every hook; ``enabled`` is the single gate the hot paths
    test.  ``record`` is thread-safe (logger threads, shard threads and the
    scheduler loop all trace concurrently)."""

    def __init__(self, capacity: int = 1 << 16):
        self.enabled = False
        self._lock = threading.Lock()
        self.ctx = _Ctx()
        self._alloc(capacity)

    def _alloc(self, capacity: int) -> None:
        assert capacity > 0
        self.capacity = capacity
        for name, dt in _COLUMNS:
            setattr(self, f"_{name}", np.zeros(capacity, dt))
        self.n = 0
        self.dropped = 0
        self._batch_seq = 0

    def reset(self, capacity: Optional[int] = None) -> None:
        """Drop all recorded rows (and optionally resize the ring)."""
        with self._lock:
            self._alloc(capacity or self.capacity)

    def next_batch_id(self) -> int:
        """A process-unique batch id for one executor pass (monotone, reset
        with the tracer — stepped reruns see identical id sequences)."""
        with self._lock:
            self._batch_seq += 1
            return self._batch_seq

    def record(
        self,
        stage: int,
        shard: int = 0,
        device: int = -1,
        batch: int = -1,
        txn_lo: int = -1,
        txn_hi: int = -1,
        t0: float = 0.0,
        t1: float = 0.0,
        nbytes: int = 0,
        n_txn: int = 0,
        aux: int = 0,
    ) -> None:
        with self._lock:
            i = self.n % self.capacity
            if self.n >= self.capacity:
                self.dropped += 1
                # drops silently skew any cost model fit on the dump; keep
                # them visible in the online registry too (lazy import: the
                # obs package depends on trace, not vice versa)
                from ..obs.metrics import REGISTRY

                if REGISTRY.enabled:
                    REGISTRY.count("trace.ring_drops")
            self._stage[i] = stage
            self._shard[i] = shard
            self._device[i] = device
            self._batch[i] = batch
            self._txn_lo[i] = txn_lo
            self._txn_hi[i] = txn_hi
            self._t0[i] = t0
            self._t1[i] = t1
            self._nbytes[i] = nbytes
            self._n_txn[i] = n_txn
            self._aux[i] = aux
            self.n += 1

    def dump(self) -> TraceDump:
        """Snapshot the recorded rows oldest-first (ring order unwound).

        Warns when the ring wrapped: a dump with drops under-represents the
        oldest stages, so durations fit from it (``CostModel.fit``) are
        biased — re-trace with a larger ``enable(capacity=...)`` instead.
        """
        if self.dropped:
            warnings.warn(
                f"trace ring dropped {self.dropped} spans (capacity "
                f"{self.capacity}); the dump is a biased sample — re-trace "
                f"with a larger enable(capacity=...) before fitting",
                RuntimeWarning,
                stacklevel=2,
            )
        with self._lock:
            k = min(self.n, self.capacity)
            if self.n <= self.capacity:
                sel = slice(0, k)
                cols = {name: getattr(self, f"_{name}")[sel].copy()
                        for name, _ in _COLUMNS}
            else:
                head = self.n % self.capacity
                cols = {
                    name: np.concatenate(
                        [getattr(self, f"_{name}")[head:],
                         getattr(self, f"_{name}")[:head]]
                    )
                    for name, _ in _COLUMNS
                }
            return TraceDump(
                stage=cols["stage"], shard=cols["shard"],
                device=cols["device"], batch=cols["batch"],
                txn_lo=cols["txn_lo"], txn_hi=cols["txn_hi"],
                t0=cols["t0"], t1=cols["t1"], nbytes=cols["nbytes"],
                n_txn=cols["n_txn"], aux=cols["aux"], dropped=self.dropped,
            )


TRACER = Tracer()


def enable(capacity: int = 1 << 16) -> Tracer:
    """Arm the process tracer with a fresh ring of ``capacity`` rows."""
    TRACER.reset(capacity)
    TRACER.enabled = True
    return TRACER


def disable() -> TraceDump:
    """Disarm the tracer and return the final snapshot."""
    TRACER.enabled = False
    return TRACER.dump()
