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

The LLM path (serving, training, the MoE, the scans' and attention's
backwards) opens nested spans with :meth:`Tracer.span` instead, a context
manager that is one bool test when the tracer is off (pinned, with the
same filter, by ``tests/test_torch_llm_spans.py``).  Each span's row carries its stage,
its unit (a call or step index) in ``batch``, its layer in ``aux``, its
tokens in ``n_txn`` and the ring index of the span around it in
``parent`` (-1 for the OLTP rows).  On the card a span also records a CUDA
event pair on the current stream; :meth:`Tracer.collect`, after the
caller's own synchronise, turns the pairs into the ``dev_t0``/``dev_t1``
columns: seconds from the first event of the span's unit (NaN off the
card).  With ``enable(ranges=True)`` a span also opens a profiler range
``repro_torch.<stage>``.

One clock: rows are stamped with ``time.perf_counter()``, and
:func:`enable` takes the offset to the wall clock the CUDA profiler stamps
its host ranges with (``time.time_ns()``).  ``t + dump.clock_offset`` is a
row's time on the profiler's clock, in seconds since the epoch.

``txn_span = (txn_lo, txn_hi)`` carries the SSN range a span covers (flush
spans: the DSN interval made durable; publish spans: the batch's SSN
range), which is what lets `repro.trace.dag` reconstruct durability edges
without any timestamps — the structural dump of two identical stepped runs
is byte-identical even though the wall-clock columns differ.
"""

from __future__ import annotations

import json
import math
import threading
import time
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
# the LLM path's spans (Tracer.span)
ST_PREFILL = 14      # ServeEngine.generate: the prompt's prefill and first token
ST_DECODE_STEP = 15  # ServeEngine.generate: one decode step
ST_FORWARD = 16      # train step: the loss's forward, per microbatch
ST_BACKWARD = 17     # train step: torch.autograd.grad, per microbatch
ST_OPTIMIZER = 18    # train step: the AdamW update
ST_SCAN_BWD = 19     # the chunked scans' torch-op backward (autograd's thread)
ST_MOE_ROUTE = 20    # MoE: router, top-k and capacity positions
ST_MOE_DISPATCH = 21  # MoE: dispatch/combine and the gather product; the scatter product
ST_FLASH_BWD = 22     # attention's backward, kernel or torch ops (autograd's thread)

STAGE_NAMES = (
    "validate", "sequence", "encode", "publish", "flush", "xprepare",
    "ship", "apply", "cut", "ack", "rdecode", "rreplay", "driver",
    "writeback", "prefill", "decode_step", "forward", "backward",
    "optimizer", "scan_bwd", "moe_route", "moe_dispatch", "flash_bwd",
)
LLM_STAGES = frozenset(range(ST_PREFILL, ST_FLASH_BWD + 1))
RANGE_PREFIX = "repro_torch."

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
    ("parent", np.int64), ("dev_t0", np.float64), ("dev_t1", np.float64),
)
# the LLM spans' columns: written by ``to_dict`` only where a dump has a
# span row, so an OLTP dump keeps the reference's keys
_SPAN_COLUMNS = ("parent", "dev_t0", "dev_t1")


class _Ctx(threading.local):
    """Ambient per-thread trace context: the executing batch id and shard,
    set by the batch executor so nested hooks (engine publish) can stamp
    their spans without threading ids through every call signature."""

    batch = -1
    shard = 0

    def __init__(self):
        self.open = []      # this thread's open spans, innermost last


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
    parent: Optional[np.ndarray] = None
    dev_t0: Optional[np.ndarray] = None
    dev_t1: Optional[np.ndarray] = None
    clock_offset: float = 0.0

    def __post_init__(self):
        n = len(self.stage)
        if self.parent is None:
            self.parent = np.full(n, -1, np.int64)
        for name in ("dev_t0", "dev_t1"):
            if getattr(self, name) is None:
                setattr(self, name, np.full(n, np.nan))

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

    def has_spans(self) -> bool:
        return bool(np.isin(self.stage, list(LLM_STAGES)).any())

    def to_dict(self) -> Dict:
        d = self.structural_dict()
        d["t0"] = self.t0.tolist()
        d["t1"] = self.t1.tolist()
        if self.has_spans():
            d["parent"] = self.parent.tolist()
            # NaN is not JSON: a span off the card has None
            for name in ("dev_t0", "dev_t1"):
                d[name] = [None if math.isnan(v) else v for v in getattr(self, name).tolist()]
            d["clock_offset"] = self.clock_offset
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
            parent=np.asarray(d.get("parent", [-1] * n), np.int64),
            dev_t0=np.asarray([np.nan if v is None else v for v in d.get("dev_t0", [None] * n)],
                              np.float64),
            dev_t1=np.asarray([np.nan if v is None else v for v in d.get("dev_t1", [None] * n)],
                              np.float64),
            clock_offset=d.get("clock_offset", 0.0),
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
        self.ranges = False
        self.card = False        # whether spans time the card (set by enable())
        self.clock_offset = 0.0
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
        self._pending = []       # (row, unit, start event, end event) of ended spans
        self._unit_first = {}    # unit -> the start event of its first span
        self._innermost = None   # the span opened last and still open, on any thread

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
            i = self._claim()
            self._parent[i] = -1
            self._dev_t0[i] = self._dev_t1[i] = np.nan
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

    def _claim(self) -> int:
        """The next row's ring slot (under the lock)."""
        i = self.n % self.capacity
        if self.n >= self.capacity:
            self.dropped += 1
            # drops silently skew any cost model fit on the dump; keep
            # them visible in the online registry too (lazy import: the
            # obs package depends on trace, not vice versa)
            from ..obs.metrics import REGISTRY

            if REGISTRY.enabled:
                REGISTRY.count("trace.ring_drops")
        self.n += 1
        return i

    def span(self, stage: int, unit: Optional[int] = None, layer: Optional[int] = None,
             tokens: int = 0):
        """A context manager around one LLM stage: a ring row, with a CUDA
        event pair on the card and a profiler range when enabled with
        ``ranges=True``.  Off, it is one bool test and returns a shared
        no-op.  ``unit`` defaults to the enclosing span's (-1 outside any);
        ``layer`` to the span's place among the enclosing span's spans of
        its stage (-1 outside any).  The ``as`` target has ``layer`` and
        ``phase``, the outermost enclosing stage's name."""
        if not self.enabled:
            return _OFF
        return _Span(self, stage, unit, layer, tokens)

    def collect(self) -> None:
        """Put the CUDA event pairs of the spans ended so far into the
        device columns, as seconds from the first event of each span's
        unit, and fold the registry's device counters into its counters
        once no pair is left.  It never waits for the card: call it after
        the caller's own synchronise; a pair whose end has not completed
        stays pending."""
        with self._lock:
            pending, self._pending = self._pending, []
        left = []
        for seq, unit, start, end in pending:
            if not end.query():
                left.append((seq, unit, start, end))
                continue
            first = self._unit_first[unit]
            t0, t1 = first.elapsed_time(start) / 1e3, first.elapsed_time(end) / 1e3
            with self._lock:
                if seq >= self.n - self.capacity:      # not yet overwritten
                    i = seq % self.capacity
                    self._dev_t0[i], self._dev_t1[i] = t0, t1
        with self._lock:
            self._pending[:0] = left
        if not left:
            from ..obs.metrics import REGISTRY

            REGISTRY.fold_device()

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
            # a span's parent by its row in the dump (-1 where overwritten)
            parent = cols["parent"]
            parent = np.where(parent >= self.n - k, parent - (self.n - k), -1)
            return TraceDump(
                stage=cols["stage"], shard=cols["shard"],
                device=cols["device"], batch=cols["batch"],
                txn_lo=cols["txn_lo"], txn_hi=cols["txn_hi"],
                t0=cols["t0"], t1=cols["t1"], nbytes=cols["nbytes"],
                n_txn=cols["n_txn"], aux=cols["aux"], dropped=self.dropped,
                parent=parent, dev_t0=cols["dev_t0"], dev_t1=cols["dev_t1"],
                clock_offset=self.clock_offset,
            )


class _Off:
    """What :meth:`Tracer.span` returns while the tracer is off."""

    layer = -1
    phase = ""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """One open LLM span (see :meth:`Tracer.span`)."""

    __slots__ = ("tracer", "stage", "unit", "layer", "tokens", "phase", "seq", "outer", "kids",
                 "t0", "stream", "start", "range")

    def __init__(self, tracer, stage, unit, layer, tokens):
        self.tracer, self.stage, self.unit, self.layer, self.tokens = (
            tracer, stage, unit, layer, tokens)

    def __enter__(self):
        tr = self.tracer
        stack = tr.ctx.open
        # a thread with no span open (autograd's, running a backward the
        # caller waits in) nests under the span opened last on any thread
        outer = stack[-1] if stack else tr._innermost
        self.outer, self.kids = outer, {}
        if self.unit is None:
            self.unit = outer.unit if outer is not None else -1
        if self.layer is None:
            self.layer = -1
            if outer is not None:
                self.layer = outer.kids.get(self.stage, 0)
                outer.kids[self.stage] = self.layer + 1
        self.phase = outer.phase if outer is not None else STAGE_NAMES[self.stage]
        with tr._lock:
            self.seq = tr.n
            tr._claim()
        stack.append(self)
        tr._innermost = self
        self.range = None
        if tr.ranges:
            import torch

            self.range = torch.autograd.profiler.record_function(
                RANGE_PREFIX + STAGE_NAMES[self.stage])
            self.range.__enter__()
        self.t0 = time.perf_counter()
        self.start = None
        if tr.card:
            import torch

            self.stream = torch.cuda.current_stream()
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
            tr._unit_first.setdefault(self.unit, self.start)
        return self

    def __exit__(self, *exc):
        tr = self.tracer
        end = None
        if self.start is not None:
            import torch

            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
        # the range's bounds are stamped inside its enter and exit calls:
        # the host stamps go just after each, the closest they can be
        if self.range is not None:
            self.range.__exit__(None, None, None)
        t1 = time.perf_counter()
        stack = tr.ctx.open
        if stack and stack[-1] is self:
            stack.pop()
        tr._innermost = self.outer
        with tr._lock:
            if self.seq >= tr.n - tr.capacity:          # not yet overwritten
                i = self.seq % tr.capacity
                tr._stage[i] = self.stage
                tr._shard[i] = 0
                tr._device[i] = -1
                tr._batch[i] = self.unit
                tr._txn_lo[i] = tr._txn_hi[i] = -1
                tr._t0[i], tr._t1[i] = self.t0, t1
                tr._nbytes[i] = 0
                tr._n_txn[i] = self.tokens
                tr._aux[i] = self.layer
                tr._parent[i] = self.outer.seq if self.outer is not None else -1
                tr._dev_t0[i] = tr._dev_t1[i] = np.nan
                if end is not None:
                    tr._pending.append((self.seq, self.unit, self.start, end))
            full = len(tr._pending) >= tr.capacity
        if full:              # nobody collects: resolve what the card has done
            tr.collect()
        return False


def _on_card() -> bool:
    """Whether the process uses a CUDA device (spans then time the card)."""
    import torch

    return torch.cuda.is_available() and torch.cuda.is_initialized()


def clock_offset() -> float:
    """``time.time_ns()`` in seconds less ``time.perf_counter()``: what
    takes a ``perf_counter`` stamp onto the CUDA profiler's clock."""
    a = time.perf_counter()
    wall = time.time_ns()
    b = time.perf_counter()
    return wall / 1e9 - (a + b) / 2


TRACER = Tracer()


def enable(capacity: int = 1 << 16, ranges: bool = False) -> Tracer:
    """Arm the process tracer with a fresh ring of ``capacity`` rows; with
    ``ranges`` each LLM span also opens a profiler range."""
    TRACER.reset(capacity)
    TRACER.ranges = ranges
    TRACER.card = _on_card()
    TRACER.clock_offset = clock_offset()
    TRACER.enabled = True
    return TRACER


def disable() -> TraceDump:
    """Disarm the tracer, collect what the card has finished, and return
    the final snapshot."""
    TRACER.enabled = False
    TRACER.ranges = False
    TRACER.collect()
    return TRACER.dump()
