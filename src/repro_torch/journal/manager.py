"""PoplarCheckpointManager — barrier-free training-state durability.

Architecture (one process; on a pod, one manager per host with its local
lanes — the SSN/CSN algebra is identical since SSNs are decentralized):

  * n **lanes** = Poplar log buffers + logger threads + append-only files
    (one per storage target);
  * ``save(step, state)`` shards the state pytree, round-robins write-only
    shard transactions across lanes (Qww — commit on own-lane durability),
    then logs a step **marker** transaction whose read set covers every
    shard of the step (Qwr — commits at ``ssn <= CSN``);
  * saves run on a background thread (training never blocks on IO);
    ``last_committed_step()`` answers "what would survive a crash right
    now" and is exact, not heuristic;
  * a dead/slow lane freezes the CSN (markers stop committing — correct),
    while other lanes keep absorbing shard writes: the paper's straggler
    behaviour, for checkpoints.

Restore: `repro_torch.journal.restore.restore_latest` — parallel lane
decode, last-writer-wins per (step, shard), newest marker with ssn <= RSNe
wins.

The port of ``repro/journal/manager.py`` on the port's ``core.engine``: the
same lanes, slices, tids, shard transactions and step marker.  The state is
a nested tree of dicts (sorted keys), lists and tuples whose leaves are
tensors, numpy arrays or Python scalars; :func:`flatten_state` names each
leaf as ``jax.tree_util.keystr`` names its path, so a journal written by
either package restores under the other.  It copies every leaf to the
host on the caller's thread, as the reference's ``device_get`` does.  A
record larger than a lane's buffer raises ``ValueError`` (the buffer's own
check): size ``buffer_capacity`` and ``n_slices`` so the largest slice
fits.  After :meth:`PoplarCheckpointManager.crash` the save thread drops
the step it is logging at the next shard.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.engine import EngineConfig, PoplarEngine, Worker
from ..core.txn import Txn
from ..tree import keystr_items
from . import records


class _ShardCell:
    __slots__ = ("ssn",)

    def __init__(self):
        self.ssn = 0


def _host(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, (np.ndarray, np.generic, bool, int, float)):
        return torch.from_numpy(np.array(leaf))
    raise TypeError(f"flatten_state: unsupported leaf of type {type(leaf).__name__}")


def flatten_state(state) -> List[Tuple[str, torch.Tensor]]:
    """``(keystr path, CPU tensor copy)`` of every leaf, in the reference's
    flattening order.  Containers are dicts, lists and tuples; a leaf is a
    tensor, a numpy array or a Python scalar; anything else raises
    ``TypeError``."""
    return [(key, _host(leaf)) for key, leaf in keystr_items(state)]


@dataclass
class SaveHandle:
    step: int
    marker: Optional[Txn] = None
    done: threading.Event = field(default_factory=threading.Event)
    error: Optional[BaseException] = None

    def wait(self, timeout: float = 120.0) -> None:
        if not self.done.wait(timeout):
            raise TimeoutError(f"save of step {self.step} did not finish logging")
        if self.error is not None:
            raise self.error

    @property
    def committed(self) -> bool:
        return self.marker is not None and self.marker.committed


class PoplarCheckpointManager:
    def __init__(
        self,
        directory: str,
        n_lanes: int = 2,
        device_kind: str = "ssd",
        buffer_capacity: int = 8 * 1024 * 1024,
        io_unit: int = 256 * 1024,
        flush_interval: float = 2e-3,
        n_slices: int = 0,         # 0 => one slice per lane
    ):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.n_lanes = n_lanes
        self.n_slices = n_slices or n_lanes
        cfg = EngineConfig(
            n_buffers=n_lanes,
            buffer_capacity=buffer_capacity,
            io_unit=io_unit,
            flush_interval=flush_interval,
            device_kind=device_kind,
            device_dir=directory,
        )
        self.engine = PoplarEngine(cfg)
        self.workers = [Worker(self.engine, i) for i in range(n_lanes)]
        self.cells: Dict[str, _ShardCell] = {}
        self._marker_cell = _ShardCell()
        self._queue: "queue.Queue[Optional[Tuple[int, Any, dict, SaveHandle]]]" = queue.Queue()
        self._stop = threading.Event()
        self._last_committed = -1
        self._markers: List[Txn] = []
        self.engine.start()
        self._thread = threading.Thread(target=self._save_loop, daemon=True, name="poplar-ckpt")
        self._thread.start()

    # --- public API -----------------------------------------------------------
    def save(self, step: int, state, metadata: Optional[dict] = None) -> SaveHandle:
        """Asynchronously journal one step's state.  Never blocks on IO."""
        handle = SaveHandle(step=step)
        # the copy to the host on the caller thread (state is consistent at
        # call time — the fuzzy-checkpoint analogue is taking it without a
        # barrier)
        flat = flatten_state(state)
        self._queue.put((step, flat, metadata or {}, handle))
        return handle

    def last_committed_step(self) -> int:
        """Largest step whose marker is durably committed (crash-survivable)."""
        for w in self.workers:
            w.drain()
        for t in self._markers:
            if t.committed:
                meta = getattr(t, "_step", None)
                if meta is not None and meta > self._last_committed:
                    self._last_committed = meta
        return self._last_committed

    def wait_for_commit(self, step: int, timeout: float = 120.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.last_committed_step() >= step:
                return
            time.sleep(1e-3)
        raise TimeoutError(f"step {step} not committed within {timeout}s")

    def close(self, quiesce: bool = True) -> None:
        self._queue.put(None)
        self._thread.join(timeout=60)
        if quiesce:
            self.engine.quiesce(range(self.n_lanes), timeout=60)
        self.engine.stop()
        for d in self.engine.devices:
            d.close()

    def crash(self) -> None:
        """Abandon everything in memory (tests/demos): stop loggers without
        flushing — whatever already hit the devices is the durable image."""
        self._stop.set()
        self._queue.put(None)
        self.engine.stop()
        for d in self.engine.devices:
            d.close()

    # --- save worker -----------------------------------------------------------
    def _save_loop(self) -> None:
        while not self._stop.is_set():
            item = self._queue.get()
            if item is None:
                return
            step, flat, metadata, handle = item
            try:
                self._log_step(step, flat, metadata, handle)
            except BaseException as e:  # noqa: BLE001 - surfaced via handle
                handle.error = e
            finally:
                handle.done.set()

    def _log_step(self, step: int, flat, metadata: dict, handle: SaveHandle) -> None:
        touched: List[_ShardCell] = []
        lane = 0
        for path, arr in flat:
            for idx, piece in enumerate(records.split_slices(arr, self.n_slices)):
                if self._stop.is_set():
                    raise RuntimeError(f"save of step {step} abandoned by a crash")
                n = self.n_slices if arr.dim() and arr.shape[0] >= self.n_slices else 1
                key = records.shard_key(step, path, idx, n)
                cell = self.cells.setdefault(f"{path}#{idx}", _ShardCell())
                txn = Txn(tid=hash(key) & 0x7FFFFFFF,
                          write_set=[(key, records.encode_array(piece))])
                self.workers[lane % self.n_lanes].run(txn, [], [cell])
                touched.append(cell)
                lane += 1
        # step marker: RAW-depends on every shard cell of this step
        meta = dict(metadata)
        meta["step"] = step
        marker = Txn(
            tid=(step << 20) | 0xFFFFF,
            read_set=[("shard", c.ssn) for c in touched],
            write_set=[(records.marker_key(step), json.dumps(meta).encode())],
        )
        self.workers[step % self.n_lanes].run(marker, touched, [self._marker_cell])
        marker._step = step  # type: ignore[attr-defined]
        self._markers.append(marker)
        handle.marker = marker
