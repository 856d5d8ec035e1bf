"""Baseline logging engines the paper compares against (§3.3, §6.1, Table 1).

* :class:`CentrEngine`  — ARIES-style centralized logging ("CENTR"): one log
  buffer, one device, total LSN order (``fetch_add``), sequential commit.
  Level: sequentiality.
* :class:`SiloEngine`   — epoch-based parallel logging ("SILO"): multiple
  buffers/devices, coarse-grained epochs (default 50 ms), epoch group commit.
  Level: epoch-based sequentiality.
* :class:`NvmDEngine`   — distributed NVM logging ("NVM-D", Wang & Johnson):
  GSN tracks RAW+WAW+WAR (readers update tuple SSNs too), worker threads
  persist records *synchronously* to their mapped device (no logger threads,
  no batching), rigorous commit in GSN order.  Level: rigorousness.

All variants expose the :class:`~repro_torch.core.engine.LoggingEngine` interface so
the OCC layer and the benchmarks are engine-agnostic.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence

from . import ssn as ssn_mod
from .commit import CommitQueues
from .engine import EngineConfig, LoggingEngine, PoplarEngine, _framed_len
from .log_buffer import LogBuffer
from .storage import StorageDevice, make_devices
from .txn import Txn


class CentrEngine(PoplarEngine):
    """Centralized ARIES-style logging.

    Reuses the Poplar machinery with n_buffers=1 but allocates the LSN with a
    pure fetch-add (ignores tuple SSNs → total order) and commits *both*
    queues against the single buffer's DSN, which with one sequential device
    is exactly LSN-order commit.
    """

    name = "centr"
    level = "sequentiality"

    def __init__(self, cfg: EngineConfig = EngineConfig(), devices: Optional[List[StorageDevice]] = None):
        cfg = EngineConfig(**{**cfg.__dict__, "n_buffers": 1})
        super().__init__(cfg, devices)

    def allocate(self, txn: Txn, read_items: Iterable, write_items: Sequence) -> int:
        worker_id = getattr(txn, "worker_id", txn.tid)
        buf = self.buffers[0]
        length = _framed_len(txn)
        if txn.write_set:
            # base=buf.ssn ⇒ ssn = buf.ssn + 1: a centralized fetch-add LSN.
            s, off, seg = buf.reserve(0, length)
            txn.ssn, txn.buffer_id, txn.offset = s, 0, off
            txn._seg_idx = seg  # type: ignore[attr-defined]
        else:
            # read-only txns still serialize behind the current LSN
            txn.ssn = buf.ssn
        txn.t_precommit = time.perf_counter()
        return txn.ssn

    def drain(self, worker_id: int) -> int:
        # Total-order commit: everything (incl. read-only) waits on the
        # single buffer's DSN.
        q = self.queues[worker_id]
        n = 0
        with q.lock:
            dsn = self.buffers[0].dsn
            for queue in (q.qww, q.qwr):
                while queue:
                    txn = queue[0]
                    if txn.ssn <= dsn:
                        queue.popleft()
                        txn.committed = True
                        txn.t_commit = time.perf_counter()
                        n += 1
                    else:
                        break
        if n:
            with self._count_lock:
                self.txn_committed += n
        return n


class SiloEngine(LoggingEngine):
    """Epoch-based parallel logging (Silo/SiloR).

    A global epoch advances every ``epoch_interval``.  A transaction's
    sequence number is its epoch; it commits once every buffer has durably
    persisted all records of epochs ≤ its own (epoch group commit).  The log
    insert path reuses the segment machinery for hole-free flushing.
    """

    name = "silo"
    level = "epoch-sequentiality"

    def __init__(
        self,
        cfg: EngineConfig = EngineConfig(),
        devices: Optional[List[StorageDevice]] = None,
        epoch_interval: float = 50e-3,  # paper §6.1: epoch increments every 50ms
    ):
        self.cfg = cfg
        self.epoch_interval = epoch_interval
        self.devices = devices or make_devices(
            cfg.n_buffers, cfg.device_kind, cfg.device_dir, cfg.device_clock
        )
        self.buffers = [
            LogBuffer(i, cfg.buffer_capacity, cfg.io_unit, cfg.segment_ring)
            for i in range(cfg.n_buffers)
        ]
        self.queues: Dict[int, CommitQueues] = {}
        self.epoch = 1
        self._epoch_lock = threading.Lock()
        # durable epoch per buffer: all records with epoch <= value are durable
        self.durable_epoch = [0] * cfg.n_buffers
        self._last_force = [time.perf_counter()] * cfg.n_buffers
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self.txn_logged = 0
        self.txn_committed = 0
        self._count_lock = threading.Lock()

    # --- epochs ------------------------------------------------------------
    def advance_epoch(self) -> int:
        with self._epoch_lock:
            self.epoch += 1
            return self.epoch

    def persistent_epoch(self) -> int:
        return min(self.durable_epoch)

    # --- worker side ---------------------------------------------------------
    def register_worker(self, worker_id: int) -> None:
        self.queues.setdefault(worker_id, CommitQueues(worker_id))

    def buffer_for(self, worker_id: int) -> LogBuffer:
        return self.buffers[worker_id % self.cfg.n_buffers]

    def allocate(self, txn: Txn, read_items: Iterable, write_items: Sequence) -> int:
        worker_id = getattr(txn, "worker_id", txn.tid)
        buf = self.buffer_for(worker_id)
        txn.ssn = self.epoch  # epoch is the sequence number
        if txn.write_set:
            length = _framed_len(txn)
            # Silo logs carry the epoch, not a fine-grained LSN; records
            # within an epoch are unordered. The buffer SSN tracks the epoch
            # exactly (monotone), so seg.ssn/DSN are epochs.
            s, off, seg = buf.reserve(0, length, fixed_ssn=txn.ssn)
            txn.buffer_id, txn.offset = buf.id, off
            txn._seg_idx = seg  # type: ignore[attr-defined]
            txn.ssn = s
        txn.t_precommit = time.perf_counter()
        return txn.ssn

    def publish(self, txn: Txn) -> None:
        q = self.queues[getattr(txn, "worker_id", txn.tid)]
        if txn.write_set:
            record = txn.encode()
            buf = self.buffers[txn.buffer_id]
            buf.fill(txn.offset, txn._seg_idx, record)  # type: ignore[attr-defined]
        with self._count_lock:
            self.txn_logged += 1
        q.push(txn)

    def drain(self, worker_id: int) -> int:
        q = self.queues[worker_id]
        buf = self.buffer_for(worker_id)
        if self.devices[buf.id].spec.latency_s < 5e-6:
            self.logger_tick(buf.id)  # NVM inline flush (see PoplarEngine.drain)
        pe = self.persistent_epoch()
        n = 0
        with q.lock:
            for queue in (q.qww, q.qwr):
                while queue:
                    txn = queue[0]
                    if txn.ssn <= pe:
                        queue.popleft()
                        txn.committed = True
                        txn.t_commit = time.perf_counter()
                        n += 1
                    else:
                        break
        if n:
            with self._count_lock:
                self.txn_committed += n
        return n

    # --- logger side -------------------------------------------------------------
    def logger_tick(self, i: int, now: Optional[float] = None, force: bool = False) -> int:
        now = time.perf_counter() if now is None else now
        buf = self.buffers[i]
        epoch_at_start = self.epoch
        if force or now - self._last_force[i] >= self.cfg.flush_interval:
            buf.force_establish()
            self._last_force[i] = now
        n = buf.flush_ready(self.devices[i])
        if n:
            self._last_force[i] = time.perf_counter()
        if buf.pending_bytes() == 0:
            # everything allocated before this tick is durable
            self.durable_epoch[i] = max(self.durable_epoch[i], epoch_at_start - 1)
        else:
            self.durable_epoch[i] = max(self.durable_epoch[i], buf.dsn - 1)
        return n

    def _logger_loop(self, i: int) -> None:
        while not self._stop.is_set():
            if self.logger_tick(i):
                for wid in list(self.queues.keys()):
                    self.drain(wid)  # committer assist (see PoplarEngine)
            else:
                time.sleep(self.cfg.logger_poll)

    def _epoch_loop(self) -> None:
        while not self._stop.is_set():
            time.sleep(self.epoch_interval)
            self.advance_epoch()

    def start(self) -> None:
        self._stop.clear()
        self._threads = [
            threading.Thread(target=self._logger_loop, args=(i,), daemon=True, name=f"silo-logger-{i}")
            for i in range(self.cfg.n_buffers)
        ]
        self._threads.append(threading.Thread(target=self._epoch_loop, daemon=True, name="silo-epoch"))
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
            self.advance_epoch()
            for i in range(self.cfg.n_buffers):
                self.buffers[i].force_establish()
                self.buffers[i].flush_ready(self.devices[i])
                self.logger_tick(i)
            pending = 0
            for w in worker_ids:
                self.drain(w)
                pending += self.queues[w].pending()
            if pending == 0 and all(b.pending_bytes() == 0 for b in self.buffers):
                return
            time.sleep(1e-4)
        raise TimeoutError("silo quiesce timed out")

    def stats(self) -> Dict:
        return {
            "engine": self.name,
            "epoch": self.epoch,
            "persistent_epoch": self.persistent_epoch(),
            "txn_logged": self.txn_logged,
            "txn_committed": self.txn_committed,
            "devices": [d.stats() for d in self.devices],
        }


class NvmDEngine(LoggingEngine):
    """Distributed GSN logging (NVM-D): rigorous, synchronous persistence.

    * GSN allocation updates the SSN of **every** accessed tuple (RS and WS):
      WAR is tracked, so allocation cost grows with the read-set size
      (reproduces Fig. 10's linear degradation with scan length).
    * ``publish`` writes the record synchronously to the worker's mapped
    device (the paper's port of NVM-D to SSDs: no batching, no loggers).
    * Commit is rigorous: a txn commits when its GSN ≤ the global durable
      watermark = min over devices of (all-smaller-GSNs-durable point).
    """

    name = "nvmd"
    level = "rigorousness"

    def __init__(
        self,
        n_workers: int,
        n_devices: int = 2,
        device_kind: str = "nvm",
        device_dir: Optional[str] = None,
        device_clock: str = "real",
        devices: Optional[List[StorageDevice]] = None,
    ):
        self.n_devices = n_devices
        self.devices = devices or make_devices(n_devices, device_kind, device_dir, device_clock)
        self.queues: Dict[int, CommitQueues] = {}
        # per-device GSN bookkeeping
        self._dev_lock = [threading.Lock() for _ in range(n_devices)]
        self._inflight: List[Dict[int, int]] = [dict() for _ in range(n_devices)]  # gsn -> count
        self._dev_max_gsn = [0] * n_devices  # max gsn ever allocated to device
        self._dev_durable = [0] * n_devices
        self.gsn_floor = 0
        # per-buffer(device) gsn state for allocation
        self._gsn = [0] * n_devices
        self._gsn_lock = [threading.Lock() for _ in range(n_devices)]
        self.txn_logged = 0
        self.txn_committed = 0
        self._count_lock = threading.Lock()

    def register_worker(self, worker_id: int) -> None:
        self.queues.setdefault(worker_id, CommitQueues(worker_id))

    def device_for(self, worker_id: int) -> int:
        return worker_id % self.n_devices

    def allocate(self, txn: Txn, read_items: Iterable, write_items: Sequence) -> int:
        worker_id = getattr(txn, "worker_id", txn.tid)
        d = self.device_for(worker_id)
        read_items = list(read_items)
        write_items = list(write_items)
        base = 0
        for e in read_items:
            base = max(base, e.ssn)
        for e in write_items:
            base = max(base, e.ssn)
        with self._gsn_lock[d]:
            gsn = max(base, self._gsn[d]) + 1
            self._gsn[d] = gsn
        # WAR tracking: *every* accessed tuple gets the new GSN (the cost the
        # paper's Fig. 10 measures). Writes get it via the caller's writeback;
        # reads are updated here.
        for e in read_items:
            if gsn > e.ssn:
                e.ssn = gsn
        txn.ssn = gsn
        txn.buffer_id = d
        with self._dev_lock[d]:
            self._inflight[d][gsn] = self._inflight[d].get(gsn, 0) + 1
            self._dev_max_gsn[d] = max(self._dev_max_gsn[d], gsn)
        txn.t_precommit = time.perf_counter()
        return gsn

    def publish(self, txn: Txn) -> None:
        d = txn.buffer_id
        if txn.write_set:
            record = txn.encode()
            # synchronous direct persistence (mfence / direct IO semantics)
            self.devices[d].write(record)
        with self._dev_lock[d]:
            cnt = self._inflight[d].get(txn.ssn, 0) - 1
            if cnt <= 0:
                self._inflight[d].pop(txn.ssn, None)
            else:
                self._inflight[d][txn.ssn] = cnt
        with self._count_lock:
            self.txn_logged += 1
        self.queues[getattr(txn, "worker_id", txn.tid)].push(txn)

    def _durable_watermark(self) -> int:
        # A device's durable point: every GSN below min(inflight) is safely on
        # the device (or was never routed there). With no inflight records the
        # device is caught up to the global max allocated GSN.
        global_max = max(self._dev_max_gsn) if self._dev_max_gsn else 0
        wm = None
        for d in range(self.n_devices):
            with self._dev_lock[d]:
                if self._inflight[d]:
                    dev_wm = min(self._inflight[d]) - 1
                else:
                    dev_wm = global_max
            wm = dev_wm if wm is None else min(wm, dev_wm)
        return wm or 0

    def drain(self, worker_id: int) -> int:
        q = self.queues[worker_id]
        wm = self._durable_watermark()
        n = 0
        with q.lock:
            for queue in (q.qww, q.qwr):
                while queue:
                    txn = queue[0]
                    if txn.ssn <= wm:
                        queue.popleft()
                        txn.committed = True
                        txn.t_commit = time.perf_counter()
                        n += 1
                    else:
                        break
        if n:
            with self._count_lock:
                self.txn_committed += n
        return n

    def quiesce(self, worker_ids: Sequence[int], timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            pending = 0
            for w in worker_ids:
                self.drain(w)
                pending += self.queues[w].pending()
            if pending == 0:
                return
            time.sleep(1e-4)
        raise TimeoutError("nvmd quiesce timed out")

    def stats(self) -> Dict:
        return {
            "engine": self.name,
            "watermark": self._durable_watermark(),
            "txn_logged": self.txn_logged,
            "txn_committed": self.txn_committed,
            "devices": [d.stats() for d in self.devices],
        }
