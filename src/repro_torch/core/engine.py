"""Poplar logging engine (paper §4) and the three-stage logging pipeline.

Stages (Fig. 2):
  * prepare    — worker allocates an SSN (Algorithm 1), reserves a slot in its
                 mapped log buffer, memcpys the record, pushes the txn into
                 its private Qww/Qwr;
  * persistence — logger threads (1:1 with buffers/devices) close segments on
                 the group-commit timer, flush ready segments, advance DSNs;
  * commit     — workers drain their queues against DSN (Qww) / CSN (Qwr).

The engine is usable in two modes:
  * threaded — ``start()`` spawns real logger threads (benchmarks, examples);
  * stepped  — tests call ``logger_tick(i)`` deterministically.

Worker → buffer mapping is many-to-one (``worker_id % n_buffers``).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence

from . import ssn as ssn_mod
from .commit import CommitProtocol, CommitQueues
from .log_buffer import LogBuffer
from .storage import StorageDevice, make_devices
from .txn import Txn
from ..trace.span import ST_FLUSH, ST_PUBLISH, TRACER
from ..obs.metrics import REGISTRY


@dataclass
class EngineConfig:
    n_buffers: int = 2
    buffer_capacity: int = 30 * 1024 * 1024   # 30 MB (paper §6.1)
    io_unit: int = 16 * 1024                  # 16 KB segment close threshold
    flush_interval: float = 5e-3              # 5 ms group commit (paper §6.1)
    segment_ring: int = 256
    device_kind: str = "ssd"                  # 'ssd' | 'nvm' | 'null'
    device_dir: Optional[str] = None          # None => in-memory durable image
    device_clock: str = "real"                # 'real' | 'virtual'
    logger_poll: float = 2e-4                 # logger idle poll
    # roll the device's active tail into an immutable sealed segment once it
    # exceeds this many bytes (the unit `core.truncate.LogTruncator` drops
    # and recovery decodes in parallel); None = seal only on truncator passes
    segment_bytes: Optional[int] = None

    @staticmethod
    def nvm(n_buffers: int = 2, device_dir: Optional[str] = None) -> "EngineConfig":
        # §6.1: NVM runs use 1 MB buffers, flush every 5ms or 1/10 full.
        return EngineConfig(
            n_buffers=n_buffers,
            buffer_capacity=1024 * 1024,
            io_unit=1024 * 1024 // 10,
            flush_interval=5e-3,
            device_kind="nvm",
            device_dir=device_dir,
        )


class LoggingEngine:
    """Interface shared by Poplar and the baseline variants."""

    name = "base"
    level = "?"

    def register_worker(self, worker_id: int) -> None:
        raise NotImplementedError

    def allocate(self, txn: Txn, read_items: Iterable, write_items: Sequence) -> int:
        """Prepare-stage entry: assign a sequence number + buffer slot."""
        raise NotImplementedError

    def publish(self, txn: Txn) -> None:
        """Finish the prepare stage: persist-or-buffer the encoded record and
        enqueue the txn for commit."""
        raise NotImplementedError

    def drain(self, worker_id: int) -> int:
        """Commit-stage: commit every committable txn of this worker."""
        raise NotImplementedError

    def start(self) -> None:  # pragma: no cover - trivial
        pass

    def stop(self) -> None:  # pragma: no cover - trivial
        pass

    def quiesce(self, worker_ids: Sequence[int], timeout: float = 30.0) -> None:
        """Flush + commit everything outstanding (shutdown / test barrier)."""
        raise NotImplementedError


class PoplarEngine(LoggingEngine):
    name = "poplar"
    level = "recoverability"

    def __init__(self, cfg: EngineConfig = EngineConfig(), devices: Optional[List[StorageDevice]] = None):
        self.cfg = cfg
        self.devices = devices or make_devices(
            cfg.n_buffers, cfg.device_kind, cfg.device_dir, cfg.device_clock
        )
        assert len(self.devices) == cfg.n_buffers
        self.buffers = [
            LogBuffer(i, cfg.buffer_capacity, cfg.io_unit, cfg.segment_ring)
            for i in range(cfg.n_buffers)
        ]
        self.commit = CommitProtocol(self.buffers)
        self.queues: Dict[int, CommitQueues] = {}
        self._last_force: List[float] = [time.perf_counter()] * cfg.n_buffers
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        # perf counters
        self.txn_logged = 0
        self.txn_committed = 0
        self._count_lock = threading.Lock()
        # shard id stamped on this engine's trace spans (`repro.shard.engine`
        # overwrites it on each shard's private engine)
        self._trace_shard = 0
        # metric names are interned per device so the armed flush hook does
        # no string formatting on the hot path
        self._obs_names = [
            (f"engine.flush_bytes.d{i}", f"engine.flush_txns.d{i}",
             f"engine.buffer_occupancy.d{i}")
            for i in range(cfg.n_buffers)
        ]

    # --- worker side --------------------------------------------------------
    def register_worker(self, worker_id: int) -> None:
        self.queues.setdefault(worker_id, CommitQueues(worker_id))

    def buffer_for(self, worker_id: int) -> LogBuffer:
        return self.buffers[worker_id % self.cfg.n_buffers]

    def allocate(self, txn: Txn, read_items: Iterable, write_items: Sequence) -> int:
        """Algorithm 1.  For write txns, reserves a slot; the caller must then
        write the SSN back into the write set (under its OCC locks) and call
        :meth:`publish`.

        ``txn.worker_id`` must be set (use :class:`Worker`, or set it
        directly); it determines the mapped log buffer.
        """
        worker_id = getattr(txn, "worker_id", txn.tid)
        buf = self.buffer_for(worker_id)
        txn.record = b""
        # estimate framed length analytically to reserve before encoding
        length = _framed_len(txn)
        s, off, seg = ssn_mod.allocate(buf if txn.write_set else None,
                                       read_items, write_items, length)
        txn.ssn = s
        if txn.write_set:
            txn.buffer_id = buf.id
            txn.offset = off
            txn._seg_idx = seg  # type: ignore[attr-defined]
        txn.t_precommit = time.perf_counter()
        return s

    def publish(self, txn: Txn) -> None:
        q = self.queues[getattr(txn, "worker_id", txn.tid)]
        if txn.write_set:
            record = txn.encode()
            assert len(record) == _framed_len(txn), (
                f"framed length drift: {len(record)} != {_framed_len(txn)}"
            )
            buf = self.buffers[txn.buffer_id]
            buf.fill(txn.offset, txn._seg_idx, record)  # type: ignore[attr-defined]
        with self._count_lock:
            self.txn_logged += 1
        q.push(txn)

    def publish_batch(
        self,
        txns: Sequence[Txn],
        blob: bytes = b"",
        buffer_id: int = -1,
        offset: int = 0,
        seg_idx: int = -1,
    ) -> None:
        """Batch twin of :meth:`publish` for the array-native forward path.

        ``txns`` is one batch slice whose write records were reserved
        contiguously on buffer ``buffer_id`` via
        :meth:`~repro.core.log_buffer.LogBuffer.reserve_batch` and
        pre-encoded (``core.txn.encode_batch``) into ``blob``; the region is
        completed with a single ring memcpy.  Read-only transactions (no
        blob) ride along and are only enqueued.  Commit-queue pushes are
        grouped per worker (one lock acquisition each).
        """
        _trace = TRACER.enabled
        if _trace:
            _t0 = time.perf_counter()
        if blob:
            self.buffers[buffer_id].fill(offset, seg_idx, blob)
        now = time.perf_counter()
        by_worker: Dict[int, List[Txn]] = {}
        for t in txns:
            t.t_precommit = now
            w = getattr(t, "worker_id", None)
            # no tid fallback here (unlike publish()): striped tids are
            # never registered worker ids, so failing fast beats a KeyError
            # deep inside the commit queues
            assert w is not None, "publish_batch requires txn.worker_id"
            by_worker.setdefault(w, []).append(t)
        for w, group in by_worker.items():
            self.queues[w].push_batch(group)
        with self._count_lock:
            self.txn_logged += len(txns)
        if _trace and txns:
            ssns = [t.ssn for t in txns]
            TRACER.record(
                ST_PUBLISH, shard=self._trace_shard, device=buffer_id,
                batch=TRACER.ctx.batch, txn_lo=min(ssns), txn_hi=max(ssns),
                t0=_t0, t1=time.perf_counter(), nbytes=len(blob),
                n_txn=len(txns),
            )

    # --- external-coordinator extension points -----------------------------
    # The sharded engine (`repro.shard`) logs cross-shard records through the
    # same buffers but tracks commit itself (its watermark rule spans several
    # engines), so the reserve and fill halves are exposed separately: the
    # coordinator must learn every participant's SSN before it can frame any
    # record (the xdep footer carries the full SSN vector).

    def reserve_record(self, txn: Txn, base_ssn: int, worker_id: int) -> int:
        """Latched half of Algorithm 1 for an externally-committed record:
        reserve an SSN + slot on ``worker_id``'s mapped buffer from ``base``
        (which may come from tuple state outside this engine).  The caller
        must finish with :meth:`fill_record` once ``txn`` is fully framed.
        Unlike :meth:`allocate`, a slot is reserved even for zero-write
        records (cross-shard read-participant markers must be durable)."""
        buf = self.buffer_for(worker_id)
        length = _framed_len(txn)
        s, off, seg = buf.reserve(base_ssn, length)
        txn.ssn = s
        txn.buffer_id = buf.id
        txn.offset = off
        txn._seg_idx = seg  # type: ignore[attr-defined]
        return s

    def fill_record(self, txn: Txn) -> None:
        """Memcpy half for :meth:`reserve_record` (no commit-queue push —
        the external coordinator owns the commit decision)."""
        record = txn.encode()
        assert len(record) == _framed_len(txn), (
            f"framed length drift: {len(record)} != {_framed_len(txn)}"
        )
        self.buffers[txn.buffer_id].fill(
            txn.offset, txn._seg_idx, record  # type: ignore[attr-defined]
        )
        txn.t_precommit = time.perf_counter()
        with self._count_lock:
            self.txn_logged += 1

    def drain(self, worker_id: int) -> int:
        # On NVM-class devices (sub-5us persist) a worker flushes its own
        # buffer inline before draining: the IO is cheaper than waiting for
        # the logger's scheduler slot (cf. NVM-D's worker-issued mfence; for
        # SSDs the logger thread keeps exclusive IO duty).  flush_lock makes
        # the concurrent tick safe.
        buf = self.buffer_for(worker_id)
        dev = self.devices[buf.id]
        if dev.spec.latency_s < 5e-6:
            self.logger_tick(buf.id)
        n = self.commit.drain(self.queues[worker_id])
        if n:
            with self._count_lock:
                self.txn_committed += n
        return n

    # --- logger side ----------------------------------------------------------
    def _emit_heartbeat(self, i: int, target_ssn: int) -> None:
        """Advance an idle buffer's durable frontier to the global SSN
        frontier by logging an empty (0-write) record carrying that SSN.

        The paper's CSN = min(DSN) assumes every buffer sees continuous
        traffic; an idle buffer would otherwise pin the CSN forever (liveness)
        *and* pin RSNe at recovery (its device's last durable SSN lags).  An
        empty record is sound: the buffer is fully flushed, so raising L.ssn
        monotonically and persisting it cannot order any real record
        incorrectly — subsequent allocations just start above the frontier.
        """
        buf = self.buffers[i]
        hb = Txn(tid=0)
        length = _framed_len(hb)
        s, off, seg = buf.reserve(0, length, fixed_ssn=target_ssn)
        hb.ssn = s
        buf.fill(off, seg, hb.encode())
        buf.force_establish()

    def logger_tick(self, i: int, now: Optional[float] = None, force: bool = False) -> int:
        """One iteration of logger thread ``i`` (Algorithm 2)."""
        now = time.perf_counter() if now is None else now
        buf = self.buffers[i]
        if force or now - self._last_force[i] >= self.cfg.flush_interval:
            # heartbeat an idle, fully-flushed buffer that lags the frontier
            if len(self.buffers) > 1 and buf.pending_bytes() == 0:
                frontier = max(b.ssn for b in self.buffers)
                if buf.dsn < frontier:
                    self._emit_heartbeat(i, frontier)
            buf.force_establish()
            self._last_force[i] = now
        _trace = TRACER.enabled
        _obs = REGISTRY.enabled
        if _trace or _obs:
            _dsn0 = buf.dsn
            _off0 = buf.flushed_offset
            _t0 = time.perf_counter()
        n = buf.flush_ready(self.devices[i])
        if _trace and n:
            TRACER.record(
                ST_FLUSH, shard=self._trace_shard, device=i,
                txn_lo=_dsn0, txn_hi=buf.dsn, t0=_t0,
                t1=time.perf_counter(), nbytes=buf.flushed_offset - _off0,
                n_txn=n, aux=n,
            )
        if _obs:
            names = self._obs_names[i]
            if n:
                REGISTRY.count(names[0], buf.flushed_offset - _off0)
                REGISTRY.count(names[1], n)
            REGISTRY.gauge_set(names[2], buf.pending_bytes() / buf.capacity)
        if n:
            self._last_force[i] = time.perf_counter()
            if self.cfg.segment_bytes:
                dev = self.devices[i]
                if dev.tail_bytes() >= self.cfg.segment_bytes:
                    # flush_lock keeps further flushes out between reading
                    # the DSN and renaming the tail, so the sealed segment's
                    # last_ssn stamp matches its bytes exactly
                    with buf.flush_lock:
                        dev.seal(buf.dsn)
        self.commit.advance_csn()
        return n

    def _logger_loop(self, i: int) -> None:
        while not self._stop.is_set():
            flushed = self.logger_tick(i)
            if flushed:
                # committer assist: a group-commit daemon acks transactions
                # as soon as the watermarks pass them (queues are locked, so
                # helping from the logger is safe); workers still drain too.
                for wid in list(self.queues.keys()):
                    self.drain(wid)
            else:
                time.sleep(self.cfg.logger_poll)

    def start(self) -> None:
        self._stop.clear()
        self._threads = [
            threading.Thread(target=self._logger_loop, args=(i,), daemon=True, name=f"logger-{i}")
            for i in range(self.cfg.n_buffers)
        ]
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10)
        self._threads = []

    def quiesce(self, worker_ids: Sequence[int], timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for i in range(self.cfg.n_buffers):
                self.logger_tick(i, force=True)
            pending = 0
            for w in worker_ids:
                self.drain(w)
                pending += self.queues[w].pending()
            if pending == 0 and all(b.pending_bytes() == 0 for b in self.buffers):
                return
            time.sleep(1e-4)
        raise TimeoutError("engine quiesce timed out")

    # --- stats -----------------------------------------------------------------
    def stats(self) -> Dict:
        return {
            "engine": self.name,
            "csn": self.commit.csn,
            "dsn": [b.dsn for b in self.buffers],
            "txn_logged": self.txn_logged,
            "txn_committed": self.txn_committed,
            "reserve_waits": sum(b.reserve_waits for b in self.buffers),
            "devices": [d.stats() for d in self.devices],
        }


def _framed_len(txn: Txn) -> int:
    # header (u32 len + u32 crc) + fixed payload (u64 ssn + u64 tid + u8 flags
    # + u32 n_writes) + per-write (u32 klen + key + u32 vlen + val)
    n = 8 + 21
    for key, val in txn.write_set:
        kb = key.encode() if isinstance(key, str) else bytes(key)
        n += 8 + len(kb) + len(val)
    if txn.cmd_op is not None:
        # command footer: u32 op + u32 n_deps + per dep (u32 klen + key + u64)
        n += 8
        for key, _ in txn.cmd_deps or []:
            kb = key.encode() if isinstance(key, str) else bytes(key)
            n += 12 + len(kb)
    if txn.xdep is not None:
        # cross-shard footer: u32 n_parts + per part (u32 shard + u64 ssn)
        n += 4 + 12 * len(txn.xdep)
    return n


class AdaptivePolicy:
    """Per-record command-vs-value framing choice (adaptive logging).

    A winner transaction may be *command-framed* — logging ``(op id, param)``
    per write plus the observed pre-image SSNs instead of full value
    payloads — iff every clause holds:

    * its spec names a registered op (``cmd_op in registry``);
    * it is shard-local (``xdep is None`` — a cross-shard record's deps live
      on other shards where this shard's recovery cannot re-execute them, so
      ``FLAG_XSHARD`` always ships values);
    * every written key carries an observed pre-image SSN (the spec read it:
      deps mirror the write chain one-to-one), so each dep is SSN-covered:
      deps at or below the latest checkpoint RSN are covered by the fuzzy
      checkpoint image (image version of any key ≥ any version < RSN), and
      deps above it live in log segments no sound safe point may drop (safe
      ≤ checkpoint RSN, see ``repro.core.truncate``);
    * a dep SSN of **0** — a key loaded into the table before any logged
      write touched it — is only covered when a checkpoint image exists
      (initial loads are in no log), so without one those records stay
      value-framed.

    ``force_value`` pins everything to value framing (the pure-value oracle
    of the crash-equivalence tests and the bench's value arm);
    ``force_command`` inverts the escape hatch for the bench's pure-command
    arm (records that *can't* be command-framed still fall back to value —
    the hatch is about eligibility, not a third wire format).

    ``refresh()`` re-probes the checkpoint directory for the latest RSN —
    the policy input that classifies each dep as image-covered vs
    log-covered (surfaced as metrics; the soundness argument above is why
    both classes stay replayable).
    """

    def __init__(
        self,
        checkpoint_dir: Optional[str] = None,
        registry=None,
        force_value: bool = False,
        force_command: bool = False,
    ):
        if registry is None:
            from .command import COMMANDS
            registry = COMMANDS
        self.registry = registry
        self.checkpoint_dir = checkpoint_dir
        self.force_value = force_value
        self.force_command = force_command
        self.checkpoint_rsn = 0
        # a full-image checkpoint exists — required cover for dep SSN 0
        # (keys loaded before any logged write; they are in no log segment)
        self.has_checkpoint = False

    def refresh(self) -> int:
        """Re-read the latest checkpoint RSN (0 when none exists)."""
        if self.checkpoint_dir is not None:
            from .checkpoint import load_latest_checkpoint_meta
            meta = load_latest_checkpoint_meta(self.checkpoint_dir)
            self.checkpoint_rsn = int(meta["rsn"]) if meta else 0
            self.has_checkpoint = meta is not None
        return self.checkpoint_rsn

    def eligible(self, cmd_op: Optional[int], deps: Sequence[int],
                 xshard: bool = False) -> bool:
        """May this record be command-framed?  ``deps`` is the per-written-key
        observed pre-image SSN (``-1`` for a key the spec did not read)."""
        if self.force_value:
            return False
        if cmd_op is None or cmd_op not in self.registry:
            return False  # forced-value hatch: unregistered op
        if xshard:
            return False  # forced-value hatch: FLAG_XSHARD ships values
        if not len(deps):
            return False  # nothing to re-execute
        for d in deps:
            if d < 0:
                return False  # blind write: no dep SSN — not covered
            if d == 0 and not self.has_checkpoint:
                return False  # initial load, in no log, no image covers it
        return True


class Worker:
    """Thin convenience handle binding a worker id to an engine.

    Drives the full per-transaction pipeline for callers that don't go
    through the OCC layer (e.g. direct logging benchmarks):

        w = Worker(engine, 3)
        w.run(txn, read_items, write_items)   # allocate + writeback + publish
        w.drain()
    """

    def __init__(self, engine: LoggingEngine, worker_id: int):
        self.engine = engine
        self.worker_id = worker_id
        engine.register_worker(worker_id)

    def run(self, txn: Txn, read_items: Sequence, write_items: Sequence) -> int:
        txn.worker_id = self.worker_id  # type: ignore[attr-defined]
        txn.t_start = txn.t_start or time.perf_counter()
        s = self.engine.allocate(txn, read_items, write_items)
        ssn_mod.writeback(s, write_items) if txn.write_set else None
        self.engine.publish(txn)
        return s

    def drain(self) -> int:
        return self.engine.drain(self.worker_id)
