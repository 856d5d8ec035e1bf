"""Parallel journal restore + elastic resharding (§5 adapted).

Restore pipeline:
  1. decode every lane's log concurrently (framed records, torn tails cut);
  2. ``RSNe = min over lanes of last durable SSN`` — the crash-time CSN;
  3. restorable steps = markers with ``ssn <= RSNe`` (a marker is a Qwr
     transaction: committed only if its whole read set was durable);
  4. pick the newest restorable step; gather its shard records (write-only
     records are valid regardless of RSNe — exactly the paper's ww rule);
  5. reassemble slices per path (slice count at save time need not match the
     restore-side topology — elastic resharding: the records are logical-
     slice addressed, never device addressed).

Lane count at restore is discovered from the directory, so you can restore
a 4-lane journal on a host configured with 2 lanes (or vice versa).

The default path decodes lanes columnar (:class:`~repro_torch.core.txn.ColumnarLog`
— the same decode the vectorized crash recovery uses) and resolves the
per-slice last-writer-wins with sorted numpy reductions.  Besides skipping
per-record Python objects, this selects the winning slice *before* decoding
any array payload, so superseded shard versions are never deserialized —
the scalar scan (``columnar=False``, kept as the oracle) decodes every
shard record it visits.

The port of ``repro/journal/restore.py`` on the port's ``core.recovery``,
``core.txn`` and ``replica.shipper``.  Restored arrays are CPU tensors.  A
slice is decoded as a view of its record's bytes and the slices of a path
are joined into one new tensor, so the winning step's bytes are copied
once; a path of one slice is copied on its own.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.par import parallel_for
from ..core.recovery import compute_rsne
from ..core.txn import ColumnarLog, LogRecord, decode_columnar, decode_records
from ..tree import keystr_items, tree_unflatten_like
from . import records


def _lane_files(directory: str) -> List[str]:
    if not os.path.isdir(directory):
        return []
    return sorted(
        os.path.join(directory, f)
        for f in os.listdir(directory)
        if f.startswith("log_") and f.endswith(".bin")
    )


def _load_files(files: List[str], decode, parallel: bool) -> List:
    """Decode every lane file concurrently with ``decode(bytes)``."""
    out: List = [None] * len(files)

    def _load(i: int) -> None:
        with open(files[i], "rb") as f:
            out[i] = decode(f.read())

    parallel_for(len(files), _load, parallel)
    return out


class JournalTails:
    """Incremental lane cache carried across :func:`restore_latest` calls.


    Without it, every restore probe re-reads and re-decodes each full lane
    file — O(n²) read+decode bytes over a training run that probes the
    journal repeatedly (or a test that restores after every step).  With a
    ``JournalTails`` instance passed back in on each call, each lane keeps a
    :class:`~repro_torch.replica.shipper.LogShipper` (the replication tailer over
    a plain :class:`~repro_torch.replica.shipper.FileSource`): a probe reads only
    the new bytes past the consumed offset and decodes only the new
    complete frames (torn tails retried, not decoded).  New chunks are
    spliced onto the accumulated columnar log with
    :meth:`ColumnarLog.concat` — an array copy of the accumulated columns,
    paid only on probes that actually saw new bytes (a no-news probe
    returns the cached log untouched); the per-record decode work is what
    stays strictly incremental.
    """

    def __init__(self):
        self._shippers: Dict[str, "object"] = {}
        self._logs: Dict[str, ColumnarLog] = {}
        self._locks: Dict[str, threading.Lock] = {}
        self._lock = threading.Lock()

    def lane(self, path: str) -> ColumnarLog:
        """Refresh one lane and return its accumulated columnar log.

        Thread-safe per lane: the poll and the splice run under a per-path
        lock (a shipper's consumed offset must advance exactly once per new
        byte range), while distinct lanes still refresh concurrently — the
        parallel restore fan-out touches one path per thread.
        """
        from ..replica.shipper import FileSource as _FS, LogShipper

        with self._lock:
            sh = self._shippers.get(path)
            if sh is None:
                sh = self._shippers[path] = LogShipper(_FS(path))
                self._locks[path] = threading.Lock()
            lane_lock = self._locks[path]
        with lane_lock:
            new = sh.poll()
            if new is not None:
                cur = self._logs.get(path)
                self._logs[path] = (
                    new if cur is None else ColumnarLog.concat([cur, new])
                )
            return self._logs.get(path) or decode_columnar(b"")

    def min_frontier(self) -> int:
        """Min over lanes of the tailed SSN frontier — this tailer's
        consumed-through point for a
        :class:`~repro_torch.core.truncate.FrontierRegistry` (a registered journal
        tailer keeps the truncator from dropping lane records it has not
        decoded yet; an *unregistered* one that falls behind re-probes from
        scratch, which the lifecycle docs call out as the slow path)."""
        with self._lock:
            shippers = list(self._shippers.values())
        if not shippers:
            return 0
        return min(sh.frontier for sh in shippers)


def load_lanes(directory: str, parallel: bool = True) -> List[List[LogRecord]]:
    return _load_files(_lane_files(directory), decode_records, parallel)


def load_lanes_columnar(
    directory: str, parallel: bool = True, tails: Optional[JournalTails] = None
) -> List[ColumnarLog]:
    """Columnar twin of :func:`load_lanes` (same decode as crash recovery).

    ``tails`` (a :class:`JournalTails` the caller carries across calls)
    switches to incremental reads: only bytes appended since the previous
    call are read and decoded.
    """
    files = _lane_files(directory)
    if tails is None:
        return _load_files(files, decode_columnar, parallel)
    out: List[ColumnarLog] = [None] * len(files)  # type: ignore[list-item]

    def _load(i: int) -> None:
        out[i] = tails.lane(files[i])

    parallel_for(len(files), _load, parallel)
    return out


def _restore_latest_columnar(
    directory: str, parallel: bool, tails: Optional[JournalTails] = None
) -> Optional[Tuple[int, Dict[str, torch.Tensor], dict]]:
    lanes = load_lanes_columnar(directory, parallel=parallel, tails=tails)
    if not lanes:
        return None
    rsne = compute_rsne(lanes)

    # flatten lane-major (== the scalar scan order, so SSN ties resolve the
    # same way: first-seen wins under the strict > guard)
    keys: List[str] = []
    vals: List[bytes] = []
    ssn_parts: List[np.ndarray] = []
    for lane in lanes:
        keys.extend(k.decode() for k in lane.keys)
        vals.extend(lane.values)
        ssn_parts.append(lane.wr_ssn)
    n = len(keys)
    if n == 0:
        return None
    ssn = np.concatenate(ssn_parts)

    # parse every key once into parallel columns
    is_marker = np.zeros(n, bool)
    valid = np.zeros(n, bool)
    steps = np.zeros(n, np.int64)
    slices = np.zeros(n, np.int64)
    nslices = np.zeros(n, np.int64)
    path_ids = np.zeros(n, np.int64)
    path_of_id: List[str] = []
    pid_lookup: Dict[str, int] = {}
    for i, k in enumerate(keys):
        if not k:
            continue
        info = records.parse_key(k)
        valid[i] = True
        steps[i] = info["step"]
        if info["kind"] == "marker":
            is_marker[i] = True
        else:
            slices[i] = info["slice"]
            nslices[i] = info["n_slices"]
            pid = pid_lookup.setdefault(info["path"], len(path_of_id))
            if pid == len(path_of_id):
                path_of_id.append(info["path"])
            path_ids[i] = pid

    # markers carry RAW deps: only durable-committable ones count
    mmask = valid & is_marker & (ssn <= rsne)
    if not mmask.any():
        return None
    step = int(steps[mmask].max())
    cand = np.flatnonzero(mmask & (steps == step))
    w = int(cand[np.argmax(ssn[cand])])      # max SSN, ties -> first seen
    meta = json.loads(vals[w].decode()) if vals[w] else {}

    # shard writes are write-only txns (durable => committed): per
    # (path, slice) segment keep the max-SSN version, ties -> first seen
    sub = np.flatnonzero(valid & ~is_marker & (steps == step))
    state: Dict[str, torch.Tensor] = {}
    if sub.size:
        order = sub[np.lexsort((-sub, ssn[sub], slices[sub], path_ids[sub]))]
        pid_s = path_ids[order]
        sl_s = slices[order]
        boundary = np.empty(order.size, dtype=bool)
        boundary[:-1] = (pid_s[1:] != pid_s[:-1]) | (sl_s[1:] != sl_s[:-1])
        boundary[-1] = True
        winners = order[boundary]            # (pid, slice)-sorted
        for pid in np.unique(path_ids[winners]):
            ws = winners[path_ids[winners] == pid]
            path = path_of_id[int(pid)]
            n_slices = int(nslices[ws[0]])
            if ws.size != n_slices:
                raise RuntimeError(
                    f"step {step} marker committed but shard {path} has "
                    f"{ws.size}/{n_slices} slices — journal corruption"
                )
            # only the winning slices are ever deserialized
            parts = [records.decode_array(vals[int(i)], copy=ws.size == 1) for i in ws]
            state[path] = records.join_slices(parts)
    return step, state, meta


def restore_latest(
    directory: str, parallel: bool = True, columnar: bool = True,
    tails: Optional[JournalTails] = None,
) -> Optional[Tuple[int, Dict[str, torch.Tensor], dict]]:
    """Returns (step, {path: array}, metadata) or None if nothing restorable.

    ``columnar=True`` (default) uses the vectorized lane decode + sorted
    last-writer-wins; ``columnar=False`` runs the original per-record scan
    (correctness oracle — both produce identical results).  ``tails`` (a
    :class:`JournalTails` carried across calls, columnar only) makes
    repeated restores incremental: each call reads and decodes only the
    bytes appended since the last one.
    """
    if columnar:
        return _restore_latest_columnar(directory, parallel, tails=tails)
    lanes = load_lanes(directory, parallel=parallel)
    if not lanes:
        return None
    rsne = compute_rsne(lanes)

    markers: Dict[int, Tuple[int, dict]] = {}        # step -> (ssn, meta)
    shards: Dict[Tuple[int, str], Dict[int, Tuple[int, torch.Tensor, int]]] = {}

    def _scan(recs: List[LogRecord]) -> None:
        for rec in recs:
            for key, val in rec.writes:
                if not key:
                    continue
                info = records.parse_key(key.decode())
                if info["kind"] == "marker":
                    # markers carry RAW deps: only durable-committable ones count
                    if rec.ssn <= rsne:
                        meta = json.loads(val.decode()) if val else {}
                        cur = markers.get(info["step"])
                        if cur is None or rec.ssn > cur[0]:
                            markers[info["step"]] = (rec.ssn, meta)
                else:
                    # shard writes are write-only txns: durable => committed
                    k = (info["step"], info["path"])
                    slot = shards.setdefault(k, {})
                    cur = slot.get(info["slice"])
                    if cur is None or rec.ssn > cur[0]:
                        slot[info["slice"]] = (rec.ssn, records.decode_array(val, copy=False),
                                               info["n_slices"])

    lock = threading.Lock()
    if parallel and len(lanes) > 1:
        def _worker(recs):
            # array decoding dominates; the merge itself is cheap under GIL
            with lock:
                _scan(recs)

        ts = [threading.Thread(target=_worker, args=(recs,)) for recs in lanes]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    else:
        for recs in lanes:
            _scan(recs)

    if not markers:
        return None
    step = max(markers)
    ssn, meta = markers[step]

    state: Dict[str, torch.Tensor] = {}
    for (s, path), slot in shards.items():
        if s != step:
            continue
        n_slices = next(iter(slot.values()))[2]
        if len(slot) != n_slices:
            raise RuntimeError(
                f"step {step} marker committed but shard {path} has "
                f"{len(slot)}/{n_slices} slices — journal corruption"
            )
        parts = [slot[i][1] for i in range(n_slices)]
        state[path] = parts[0].clone() if n_slices == 1 else records.join_slices(parts)
    return step, state, meta


def to_pytree(state: Dict[str, torch.Tensor], like) -> Any:
    """Map restored {path: tensor} back onto a tree of ``like``'s structure
    (the restore side moves the tensors to its own device)."""
    leaves = []
    for key, leaf in keystr_items(like):
        if key not in state:
            raise KeyError(f"restored journal is missing {key}")
        arr = state[key]
        want = tuple(leaf.shape) if hasattr(leaf, "shape") else None
        if want is not None and tuple(arr.shape) != want:
            raise ValueError(f"{key}: journal shape {tuple(arr.shape)} != expected {want}")
        leaves.append(arr)
    return tree_unflatten_like(like, leaves)
