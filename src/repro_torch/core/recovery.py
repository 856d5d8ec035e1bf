"""Crash recovery (paper §5).

Two stages:

1. **Checkpoint recovery** — load the newest *valid* checkpoint; its metadata
   carries ``RSNs`` (the CSN at checkpoint start), the starting point for log
   replay.

2. **Log recovery** — decode every device's log in parallel; compute
   ``RSNe = min over devices of (SSN of the most recently durable record)``
   — i.e. the crash-time CSN, since per-buffer SSNs are monotone in flush
   order.  Replay with **last-writer-wins** (Thomas write rule, per-tuple
   SSN guard):

   * records with RAW potential (``has_reads``) are applied only if
     ``ssn <= RSNe`` (their commit required CSN ≥ ssn);
   * write-only (WAW-only) records are applied whenever durable, regardless
     of RSNe (§5: they committed on their own buffer's DSN alone).

   A device with *no* durable record pins RSNe to 0: its DSN never advanced,
   so no RAW-dependent transaction can have committed.

Replay across devices is order-free thanks to the per-tuple SSN guard, so it
vectorizes: the default path decodes each log into columnar arrays
(:class:`~repro.core.txn.ColumnarLog`), concatenates all durable-committed
writes with the checkpoint image, and resolves last-writer-wins in one
segment-sorted SSN reduction (sort by key, take the max-SSN entry per key
segment) instead of a per-record guarded dict walk.  Three replay modes:

* ``mode="kernel"``     (default) — the fused pipeline: vectorized tile
  decode (`repro_torch.core.fastdecode`, seal-crc verified) feeding the
  fused hash-slot scatter-max scan
  (:func:`repro_torch.kernels.ops.fused_replay_scan` — the hand-written
  CUDA kernel on ``device="cuda"``, its plain PyTorch version on
  ``device="cpu"``), sealed tiles prefetch-decoded while the previous tile
  replays; anything out of profile falls back to the batched path with the
  scatter-max kernel apply;
* ``mode="vectorized"`` — the batched numpy reduction;
* ``mode="scalar"``     — the original per-record replay, kept as the
  correctness oracle (tested equivalent on randomized logs).

All modes produce identical :class:`RecoveredState` contents, including the
``rsns``/``rsne`` watermarks and skipped-uncommitted counts.  Every kernel
launch happens on the calling thread's current CUDA stream; the decode
worker threads touch no device.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .checkpoint import CheckpointData, load_latest_checkpoint
from .fastdecode import FastTile, decode_fast_tile
from .par import parallel_for
from .storage import StorageDevice
from .txn import (
    ColumnarLog,
    LogRecord,
    decode_columnar,
    decode_columnar_stream,
    decode_records,
)
from ..kernels.bucketing import bucket, checked_i32, fits_i32, stack_i32
from ..kernels.ops import kernel_device
from ..obs.metrics import REGISTRY
from ..trace.span import ST_RDECODE, ST_RREPLAY, TRACER

#: forensics verdict string for a command record whose pre-image is neither
#: in the retained log nor covered by the checkpoint image (see
#: ``repro.obs.forensics``)
REASON_CMD_DEP = "command-dep-unreplayable"
REASON_CMD_OP = "command-op-unknown"


class CommandReplayError(RuntimeError):
    """A command-framed record cannot be re-executed: its operator is not
    registered in this process, or its observed pre-image SSN points at
    state that was truncated away without checkpoint coverage.  A sound
    pipeline never raises this — the adaptive policy only command-frames
    records whose dependencies are covered, and the truncators refuse safe
    points that would strand a retained command's pre-image — so recovery
    fails loudly instead of guessing a value."""

    def __init__(self, msg: str, reason: str = REASON_CMD_DEP) -> None:
        super().__init__(msg)
        self.reason = reason


@dataclass
class RecoveryReport:
    """Structured account of one recovery pass — what was decoded, what
    replayed, and what each §5 rule dropped — consumed by
    ``repro.obs.forensics`` and logged by ``benchmarks/table23_recovery.py``.

    ``segments`` holds one row per decoded (device, segment) blob:
    ``{"device", "segment", "bytes", "records", "seconds"}`` (empty for the
    scalar and fused modes, which do not decode per-segment).
    """

    mode: str = "kernel"
    fused: bool = False               # the kernel tiled pipeline engaged
    n_devices: int = 0
    rsns: int = 0
    rsne: int = 0
    n_decoded: int = 0                # records decoded from retained logs
    n_replayed: int = 0
    n_dropped_above_rsne: int = 0     # HAS_READS records with ssn > RSNe
    n_dropped_not_durable_all: int = 0  # cross-shard cut drops (sharded only)
    checkpoint_keys: int = 0
    decode_s: float = 0.0
    replay_s: float = 0.0
    segments: List[Dict] = field(default_factory=list)

    def to_dict(self) -> Dict:
        return {
            "mode": self.mode,
            "fused": self.fused,
            "n_devices": self.n_devices,
            "rsns": self.rsns,
            "rsne": self.rsne,
            "n_decoded": self.n_decoded,
            "n_replayed": self.n_replayed,
            "n_dropped_above_rsne": self.n_dropped_above_rsne,
            "n_dropped_not_durable_all": self.n_dropped_not_durable_all,
            "checkpoint_keys": self.checkpoint_keys,
            "decode_s": self.decode_s,
            "replay_s": self.replay_s,
            "segments": list(self.segments),
        }


@dataclass
class RecoveredState:
    """Recovered database image: key -> (value, ssn)."""

    data: Dict[bytes, Tuple[bytes, int]] = field(default_factory=dict)
    rsns: int = 0
    rsne: int = 0
    n_replayed: int = 0
    n_skipped_uncommitted: int = 0
    report: Optional[RecoveryReport] = None

    def get(self, key: bytes) -> Optional[bytes]:
        v = self.data.get(key)
        return v[0] if v is not None else None

    def ssn_of(self, key: bytes) -> int:
        v = self.data.get(key)
        return v[1] if v is not None else 0


def compute_rsne(
    device_records: Sequence[Union[Sequence[LogRecord], ColumnarLog]],
    floors: Optional[Sequence[int]] = None,
) -> int:
    """min over devices of the most recently durable record's SSN.

    Accepts either row-decoded logs (``List[LogRecord]``) or columnar logs.

    ``floors`` (aligned with ``device_records``) carries each device's
    truncation floor (:attr:`~repro.core.storage.StorageDevice.truncated_ssn`):
    a device whose retained suffix is empty because *everything* durable was
    truncated away did advance its DSN to the newest dropped segment's last
    SSN — without the floor it would pin RSNe to 0 and recovery would skip
    every committed Qwr record on the other devices.  (A truncated device
    with a non-empty suffix needs no correction: its newest record is still
    its true frontier.)
    """
    rsne = None
    for i, recs in enumerate(device_records):
        if isinstance(recs, ColumnarLog):
            last = recs.last_ssn
        else:
            last = recs[-1].ssn if recs else 0
        if floors is not None:
            last = max(last, floors[i])
        rsne = last if rsne is None else min(rsne, last)
    return rsne or 0


def device_ssn_floors(devices: Sequence[StorageDevice]) -> List[int]:
    """Per-device truncation floors for :func:`compute_rsne` (0 for devices
    that were never truncated, or device-likes without the attribute)."""
    return [int(getattr(d, "truncated_ssn", 0)) for d in devices]


# --- scalar replay (correctness oracle) --------------------------------------

def _apply(state: RecoveredState, rec: LogRecord, lock: Optional[threading.Lock]) -> None:
    for key, val in rec.writes:
        if lock:
            with lock:
                cur = state.data.get(key)
                if cur is None or rec.ssn > cur[1]:
                    state.data[key] = (val, rec.ssn)
        else:
            cur = state.data.get(key)
            if cur is None or rec.ssn > cur[1]:
                state.data[key] = (val, rec.ssn)


def _replay_scalar(
    state: RecoveredState,
    device_records: Sequence[List[LogRecord]],
    rsne: int,
    parallel: bool,
) -> None:
    """Per-record guarded replay — one thread per device when ``parallel``."""
    lock = threading.Lock() if parallel else None

    def _replay(recs: List[LogRecord]) -> Tuple[int, int]:
        applied = skipped = 0
        for rec in recs:
            if rec.ssn <= state.rsns and not rec.write_only:
                # already reflected by the checkpoint (and guard makes replay
                # idempotent anyway) — skip as an optimization
                pass
            if rec.write_only or rec.ssn <= rsne:
                # command records need their pre-image, so they cannot join
                # the order-free guarded walk: counted here, re-executed in
                # SSN order after every value record has landed
                if not rec.is_command:
                    _apply(state, rec, lock)
                applied += 1
            else:
                skipped += 1  # durable but provably uncommitted RAW-dependent
        return applied, skipped

    results: List[Tuple[int, int]] = [(0, 0)] * len(device_records)

    def _worker(i: int) -> None:
        results[i] = _replay(device_records[i])

    parallel_for(len(device_records), _worker, parallel)

    state.n_replayed = sum(r[0] for r in results)
    state.n_skipped_uncommitted = sum(r[1] for r in results)

    cmds = [
        rec
        for recs in device_records
        for rec in recs
        if rec.is_command and (rec.write_only or rec.ssn <= rsne)
    ]
    if cmds:
        cmds.sort(key=lambda r: r.ssn)
        depth, applied = _apply_command_records(state.data, cmds)
        if REGISTRY.enabled:
            REGISTRY.gauge_max("adaptive.replay.cmd_depth", depth)
            REGISTRY.count("adaptive.replay.commands", applied)


# --- command re-execution (adaptive logging) ---------------------------------
#
# Command-framed records (FLAG_COMMAND) carry op parameters, not values, so
# they cannot join the order-free last-writer-wins reduction: each one needs
# its key's pre-image.  OCC validation gives the ordering theorem that keeps
# this cheap: a committed command at SSN ``s`` observed its pre-image at SSN
# ``d`` and *no committed writer of that key exists in (d, s)*.  So after the
# value pass produces each key's value base (checkpoint image or last value
# winner at SSN ``V``), the surviving commands on a key are exactly a suffix
# chain above ``V``: commands with ``s <= V`` are superseded (Thomas rule),
# and the rest apply in per-key SSN order, each one's pre-image being the
# running entry.  Execution is batched per dependency level — level ``l`` is
# the ``l``-th command above its key's base — so independent keys re-execute
# together and only true chains serialize.

def _exec_command_write(
    data: Dict[bytes, Tuple[bytes, int]],
    key: bytes,
    ssn: int,
    op_id: int,
    dep: int,
    param: bytes,
    registry,
    dep_lookup=None,
) -> bool:
    """Apply one command write against the running image under the §5 guard.
    Returns False when the command is superseded by a newer entry; raises
    :class:`CommandReplayError` when the pre-image is missing (``dep``
    points below the current entry and nothing covers it)."""
    cur = data.get(key)
    if dep_lookup is not None and (cur is None or cur[1] < dep):
        # the round's reduction may hold an *older* entry than the external
        # store (a late chunk shipping a superseded write after the dep was
        # already folded) — take whichever is newer
        ext = dep_lookup(key)
        if ext is not None and (cur is None or ext[1] > cur[1]):
            cur = ext
    if cur is not None and ssn <= cur[1]:
        return False                   # superseded by a later (value) winner
    if op_id not in registry:
        raise CommandReplayError(
            f"command record ssn={ssn} key={key!r} uses unregistered op "
            f"{op_id}", reason=REASON_CMD_OP,
        )
    if cur is None or cur[1] < dep:
        have = "nothing" if cur is None else f"ssn {cur[1]}"
        raise CommandReplayError(
            f"command record ssn={ssn} key={key!r} depends on pre-image "
            f"ssn {dep} but recovery holds {have} — dependency truncated "
            f"away without checkpoint coverage", reason=REASON_CMD_DEP,
        )
    data[key] = (registry.get(op_id).fn(cur[0], param), ssn)
    return True


def _apply_command_records(
    data: Dict[bytes, Tuple[bytes, int]],
    recs: Sequence[LogRecord],
    dep_lookup=None,
) -> Tuple[int, int]:
    """Scalar-oracle command pass: re-execute committed command records in
    global SSN order (which embeds every per-key chain order).  ``recs``
    must already be filtered by the §5 guard and sorted by SSN.

    Returns ``(max chain depth, writes applied)``.
    """
    from .command import COMMANDS

    chain: Dict[bytes, int] = {}
    depth = applied = 0
    for rec in recs:
        deps = rec.cmd_deps or []
        if len(deps) != len(rec.writes):
            raise CommandReplayError(
                f"command record ssn={rec.ssn} carries {len(deps)} deps for "
                f"{len(rec.writes)} writes — footer does not mirror the "
                f"write chain", reason=REASON_CMD_DEP,
            )
        for (key, param), (_dkey, dssn) in zip(rec.writes, deps):
            lvl = chain.get(key, 0) + 1
            chain[key] = lvl
            depth = max(depth, lvl)
            if _exec_command_write(
                data, key, rec.ssn, rec.cmd_op, dssn, param, COMMANDS,
                dep_lookup,
            ):
                applied += 1
    return depth, applied


def _command_dep_per_write(log: ColumnarLog) -> np.ndarray:
    """Scatter a columnar log's command dep SSNs onto per-write lanes
    (``-1`` for value-record lanes).  The encoder invariant — dep footers
    mirror the write chain one-to-one — is validated here because replay is
    the first consumer that needs the positional alignment."""
    nw = log.n_writes.astype(np.int64)
    cd = np.diff(log.cmd_dep_start)
    if not np.array_equal(cd, nw[log.cmd_rec]):
        raise CommandReplayError(
            "command dep footers do not mirror their write chains",
            reason=REASON_CMD_DEP,
        )
    dep = np.full(len(log.wr_rec), -1, np.int64)
    total = int(cd.sum())
    if total:
        wr_off = np.zeros(log.n_records + 1, np.int64)
        np.cumsum(nw, out=wr_off[1:])
        cum = np.zeros(len(cd) + 1, np.int64)
        np.cumsum(cd, out=cum[1:])
        lane = (
            np.repeat(wr_off[log.cmd_rec], cd)
            + np.arange(total, dtype=np.int64)
            - np.repeat(cum[:-1], cd)
        )
        dep[lane] = log.cmd_dep_ssn
    return dep


def _apply_commands_vectorized(
    data: Dict[bytes, Tuple[bytes, int]],
    keys: List[bytes],
    ssn: np.ndarray,
    op: np.ndarray,
    dep: np.ndarray,
    params: np.ndarray,
    dep_lookup=None,
) -> Tuple[int, int]:
    """Dependency-level-batched command re-execution over flattened command
    write lanes (the vectorized twin of :func:`_apply_command_records`).

    Lanes lexsort by (key, SSN); each lane's *level* is its rank within its
    key segment.  Level ``l`` lanes touch distinct keys, so they re-execute
    as one batch; the loop over levels serializes only true per-key chains.
    Returns ``(max chain depth, writes applied)``.
    """
    from .command import COMMANDS

    n = len(keys)
    kf = ColumnarLog.encode_keys_fixed(keys, [len(k) for k in keys])
    order = np.lexsort((ssn, kf))
    k_s = kf[order]
    gb = np.empty(n, dtype=bool)
    gb[0] = True
    gb[1:] = k_s[1:] != k_s[:-1]
    starts = np.flatnonzero(gb)
    seg_len = np.diff(np.append(starts, n))
    level = np.arange(n, dtype=np.int64) - np.repeat(starts, seg_len)
    depth = int(seg_len.max())
    ssn_l = ssn.tolist()
    op_l = op.tolist()
    dep_l = dep.tolist()
    applied = 0
    for lvl in range(depth):
        for j in order[np.flatnonzero(level == lvl)].tolist():
            if _exec_command_write(
                data, keys[j], ssn_l[j], op_l[j], dep_l[j], params[j],
                COMMANDS, dep_lookup,
            ):
                applied += 1
    return depth, applied


# --- vectorized replay (batched last-writer-wins) ----------------------------

def committed_mask(log: ColumnarLog, rsne: int) -> np.ndarray:
    """Per-record §5 commit guard: write-only (Qww) records replay whenever
    durable; HAS_READS (Qwr) records only with ``ssn <= RSNe``."""
    return ~log.has_reads | (log.ssn <= rsne)


def _key_words(key_mat: np.ndarray) -> np.ndarray:
    """Reinterpret a fixed-width 'S' key array as (n, width/8) int64 words
    (zero-copy when the width is already a multiple of 8, as the columnar
    decode guarantees; pads otherwise)."""
    n = len(key_mat)
    width = max(key_mat.dtype.itemsize, 1)
    if width % 8 == 0:
        return key_mat.view("<i8").reshape(n, width // 8)
    wpad = -(-width // 8) * 8
    u8 = np.zeros((n, wpad), np.uint8)
    u8[:, : key_mat.dtype.itemsize] = key_mat.view(np.uint8).reshape(n, -1)
    return u8.view("<i8")


def _hash_words(words: np.ndarray) -> np.ndarray:
    """Vectorized 64-bit mixing hash over key words.

    Equal keys always hash equal; the (astronomically rare) converse failure
    — two distinct keys colliding — is *detected* by the caller's word-level
    group check and falls back to the exact sort, so the hash only ever
    affects speed, never results.
    """
    mult = np.uint64(0x9E3779B97F4A7C15)        # golden-ratio odd constant
    acc = np.uint64(0x632BE59BD9B4E019)
    uw = words.view(np.uint64)
    with np.errstate(over="ignore"):
        h = np.full(len(words), np.uint64(0x9AFB33C1), dtype=np.uint64)
        for j in range(words.shape[1]):
            acc = acc * mult + np.uint64(1)
            h += uw[:, j] * (acc | np.uint64(1))
            h ^= h >> np.uint64(29)
    return h.view(np.int64)


def _group_winners(
    key_mat: np.ndarray, ssn_arr: np.ndarray, pos_arr: np.ndarray,
    want_inv: bool = False,
) -> Tuple[np.ndarray, Optional[np.ndarray], int]:
    """Segment-sorted last-writer-wins reduction.

    Entries are grouped by exact key identity (the sentinel-terminated
    fixed-width encoding of :meth:`ColumnarLog.encode_keys_fixed`), and each
    key segment reduces to the entry with the max SSN — SSN ties going to
    the *smallest* position, i.e. first in replay order, which reproduces
    the scalar guard's strict ``>`` (the checkpoint image sits at position
    -1 and therefore wins its ties).

    Fast path: segments come from a single int64 argsort of a 64-bit key
    hash, and the (ssn, -pos) argmax per segment from one
    ``np.maximum.reduceat`` over a packed ``ssn << shift | ~pos`` composite.
    If the packing ranges don't fit, or the word-level check finds more
    distinct keys than hash groups (a hash collision), it falls back to one
    exact multi-column lexsort — identical semantics either way.

    Returns ``(winners, inv, n_groups)``: the winning entry index per group
    (in group order), each entry's dense group id (``None`` unless
    ``want_inv`` — only the kernel apply needs it), and the group count.
    """
    n = len(key_mat)

    avail = 62 - max(int(ssn_arr.max()), 1).bit_length() if n else 0
    if n and avail > 1 and int(pos_arr.max()) + 2 < 1 << avail:
        # composite: bigger SSN sorts higher, then smaller position
        v = (ssn_arr << avail) + ((1 << avail) - 2 - pos_arr)
        words = _key_words(key_mat)
        h = _hash_words(words)
        order = np.argsort(h)
        h_s = h[order]
        gb = np.empty(n, dtype=bool)
        gb[0] = True
        np.not_equal(h_s[1:], h_s[:-1], out=gb[1:])
        # exact word boundaries: a superset of the hash boundaries, strictly
        # larger only under a hash collision
        w_s = words[order]
        exact = np.empty(n, dtype=bool)
        exact[0] = True
        np.not_equal(w_s[1:, 0], w_s[:-1, 0], out=exact[1:])
        for j in range(1, words.shape[1]):
            exact[1:] |= w_s[1:, j] != w_s[:-1, j]
        if int(gb.sum()) == int(exact.sum()):
            gid = np.cumsum(gb) - 1
            v_s = v[order]
            seg_max = np.maximum.reduceat(v_s, np.flatnonzero(gb))
            winners = order[v_s == seg_max[gid]]   # v is unique: one per group
            inv = None
            if want_inv:
                inv = np.empty(n, dtype=np.int64)
                inv[order] = gid
            return winners, inv, int(gid[-1]) + 1
        # hash collision: fall through to the exact sort

    order = np.lexsort((-pos_arr, ssn_arr, key_mat))
    k_s = key_mat[order]
    gb = np.empty(n, dtype=bool)
    gb[0] = True
    gb[1:] = k_s[1:] != k_s[:-1]
    gid = np.cumsum(gb) - 1
    boundary = np.empty(n, dtype=bool)
    boundary[:-1] = gb[1:]
    boundary[-1] = True
    inv = None
    if want_inv:
        inv = np.empty(n, dtype=np.int64)
        inv[order] = gid
    return order[boundary], inv, int(gid[-1]) + 1


def replay_columnar(
    logs: Sequence[ColumnarLog],
    rsne: int,
    base: Optional[Dict[bytes, Tuple[bytes, int]]] = None,
    use_kernel: bool = False,
    record_mask: Optional[Sequence[Optional[np.ndarray]]] = None,
    dep_lookup=None,
    device="cuda",
) -> Tuple[Dict[bytes, Tuple[bytes, int]], int, int]:
    """Batched last-writer-wins replay over columnar device logs.

    ``base`` is the checkpoint image (key -> (value, ssn)); its entries join
    the reduction at position -1 so they win SSN ties against log writes,
    exactly like the scalar path's strict ``ssn > image.ssn`` guard.

    With ``use_kernel=True`` the guarded apply against the image runs through
    the SSN scatter-max kernel on ``device`` instead of the numpy reduction
    (its plain PyTorch version on ``device="cpu"``).

    ``record_mask`` (aligned with ``logs``; entries may be None) injects an
    extra per-record commit decision ANDed with the local §5 guard — the
    extension point sharded recovery uses to drop cross-shard records that
    are not durable on every participant (`repro.shard.recovery`).

    Command-framed records (adaptive logging) are masked out of the value
    reduction and re-executed afterwards in dependency-level batches against
    the reduced image — see the command re-execution section above.
    ``dep_lookup`` resolves a command pre-image that is in none of ``logs``
    or ``base`` (``key -> (value, ssn) | None``) — the replica applier
    passes its live table here, because chunks already applied in earlier
    polls hold the pre-images of later command records.

    Returns ``(data, n_replayed, n_skipped_uncommitted)``.
    """
    base = base or {}
    n_replayed = 0
    n_skipped = 0
    n_base = len(base)
    dev = kernel_device(device) if use_kernel else None

    # command write lanes, deferred past the value reduction
    cmd_keys: List[bytes] = []
    cmd_parts: List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = []

    def _finish(
        data: Dict[bytes, Tuple[bytes, int]]
    ) -> Tuple[Dict[bytes, Tuple[bytes, int]], int, int]:
        if cmd_keys:
            depth, applied = _apply_commands_vectorized(
                data,
                cmd_keys,
                np.concatenate([p[0] for p in cmd_parts]),
                np.concatenate([p[1] for p in cmd_parts]),
                np.concatenate([p[2] for p in cmd_parts]),
                np.concatenate([p[3] for p in cmd_parts]),
                dep_lookup,
            )
            if REGISTRY.enabled:
                REGISTRY.gauge_max("adaptive.replay.cmd_depth", depth)
                REGISTRY.count("adaptive.replay.commands", applied)
        return data, n_replayed, n_skipped

    # surviving writes, columnar across sources: exact key identity (the
    # sentinel-terminated fixed-width encoding), SSN, value payload (object
    # array — only the winners' payloads are ever touched again)
    base_keys = list(base.keys())
    key_mats: List[np.ndarray] = [
        ColumnarLog.encode_keys_fixed(base_keys, [len(k) for k in base_keys])
    ]
    ssn_parts: List[np.ndarray] = [
        np.fromiter((s for _, s in base.values()), dtype=np.int64, count=n_base)
    ]
    val_parts: List[np.ndarray] = [
        np.fromiter((v for v, _ in base.values()), dtype=object, count=n_base)
    ]

    for li, log in enumerate(logs):
        ok = committed_mask(log, rsne)
        if record_mask is not None and record_mask[li] is not None:
            ok = ok & record_mask[li]
        n_ok = int(np.count_nonzero(ok))
        n_replayed += n_ok
        n_skipped += log.n_records - n_ok
        if not len(log.wr_rec):
            continue
        vals = log.values_obj
        wmask = ok[log.wr_rec]
        if log.n_command:
            wcmd = log.cmd_mask[log.wr_rec]
            sel = np.flatnonzero(wmask & wcmd)
            if len(sel):
                dep_w = _command_dep_per_write(log)
                cmd_keys.extend(k[:-1] for k in log.keys_fixed[sel].tolist())
                cmd_parts.append((
                    log.wr_ssn[sel],
                    log.cmd_op_col[log.wr_rec[sel]],
                    dep_w[sel],
                    vals[sel],       # the op param rides the value slot
                ))
            wmask = wmask & ~wcmd
        if wmask.all():
            key_mats.append(log.keys_fixed)
            ssn_parts.append(log.wr_ssn)
            val_parts.append(vals)
        else:
            key_mats.append(log.keys_fixed[wmask])
            ssn_parts.append(log.wr_ssn[wmask])
            val_parts.append(vals[wmask])

    n_total = sum(len(p) for p in ssn_parts)
    if n_total == 0:
        return _finish({})

    # common width, kept a multiple of 8 so the int64 word view is zero-copy
    width = -(-max(1, max(m.dtype.itemsize for m in key_mats)) // 8) * 8
    key_mat = np.concatenate([m.astype(f"S{width}", copy=False) for m in key_mats])
    ssn_arr = np.concatenate(ssn_parts)
    val_arr = np.concatenate(val_parts)
    pos_arr = np.empty(n_total, dtype=np.int64)
    pos_arr[:n_base] = -1                       # checkpoint wins SSN ties
    pos_arr[n_base:] = np.arange(n_total - n_base)

    winners, inv, n_slots = _group_winners(
        key_mat, ssn_arr, pos_arr, want_inv=use_kernel
    )

    # 'S' items come back NUL-stripped: dropping the final byte (the \x01
    # terminator) recovers the exact original key
    win_keys = key_mat[winners].tolist()

    if use_kernel and n_total > n_base and not (
        fits_i32(ssn_arr) and n_total - n_base < 2**31 and n_slots < 2**31
    ):
        # outside the kernel's int32 range (checkpoint or log SSNs, the
        # write count, or the slot count): the numpy reduction below is
        # equivalent — fall back
        use_kernel = False

    if not use_kernel or n_total == n_base:
        data = {}
        for k, v, s in zip(
            win_keys, val_arr[winners].tolist(), ssn_arr[winners].tolist()
        ):
            data[k[:-1]] = (v, s)
        return _finish(data)

    # --- kernel path: dense key ids + SSN-guarded scatter-max apply ----------
    # both dims bucket-padded (slots to S with empty-slot identities, lanes
    # to N with overflow-slot lanes) so streaming callers — which poll this
    # with a different chunk size every round — reuse a bounded set of
    # launch shapes
    from ..kernels.ops import fused_replay_apply
    from ..kernels.scatter_max import NO_POS

    s_pad = bucket(n_slots)
    image = np.empty((2, s_pad), np.int32)
    image[0] = -1
    image[1] = NO_POS
    base_slots = inv[:n_base]
    image[0, base_slots] = checked_i32(ssn_arr[:n_base], "checkpoint SSNs")
    image[1, base_slots] = -1
    base_idx_of_slot = np.full(n_slots, -1, np.int64)
    base_idx_of_slot[base_slots] = np.arange(n_base)

    scan = stack_i32(
        [inv[n_base:], ssn_arr[n_base:], pos_arr[n_base:]],
        bucket(n_total - n_base), fills=(s_pad, -1, int(NO_POS)),
    )
    out_ssn, out_pos = fused_replay_apply(
        torch.from_numpy(image).to(dev), torch.from_numpy(scan).to(dev)
    )
    out_ssn = out_ssn.cpu().numpy()[:n_slots]
    out_pos = out_pos.cpu().numpy()[:n_slots]

    # winners[g] is a member of group g: use it for the exact key bytes
    data = {}
    for g, (p, s) in enumerate(zip(out_pos.tolist(), out_ssn.tolist())):
        if p == NO_POS:
            continue
        idx = int(base_idx_of_slot[g]) if p < 0 else n_base + p
        data[win_keys[g][:-1]] = (val_arr[idx], s)
    return _finish(data)


# --- fused kernel replay (tile decode -> hash-slot scan -> merge) -------------

# below this lane count the device round-trip (dispatch + transfer) costs more
# than the numpy reduction it replaces; tiles this small reduce on the host
_FUSED_MIN_LANES = 1024


def _fused_tile_winners(
    tile: FastTile, rsne: int, device="cuda"
) -> Tuple[np.ndarray, int, int]:
    """Per-key last-writer-wins winners among one tile's committed write
    lanes, via the hash-slot scan on ``device`` (:func:`repro_torch.kernels.
    ops.fused_replay_scan`).

    Device side: every lane scatters ``(hash-slot, ssn, pos)`` into a
    power-of-two slot table under the ``(max ssn, then min pos)`` lattice —
    one bucket-padded int32 transfer, one scatter kernel.  Host side: the
    winning lane of each slot is recovered by value-matching, then the two
    ways hashing can mislead are repaired *exactly*:

    * **slot spill** — distinct keys sharing a slot (expected at ~1/2 load
      factor): every lane whose 64-bit key hash differs from its slot
      winner's was suppressed by a different key; those lanes re-reduce
      through the exact :func:`_group_winners` (a key's lanes are either all
      owner-hash or all spilled, so each side sees complete key groups);
    * **hash collision** — distinct keys with equal 64-bit hashes
      (astronomically rare): detected by word-comparing same-hash lanes
      against their slot winner, and the whole tile falls back to the exact
      reduction.

    Returns ``(winner lane indices, n_replayed, n_skipped)`` — lane indices
    into the tile's write-lane arrays, records counted per the §5 guard.
    """
    ok = tile.committed_mask(rsne)
    n_rep = int(np.count_nonzero(ok))
    n_skip = tile.n_records - n_rep
    n_lanes = len(tile.wr_rec)
    if n_lanes == 0:
        return np.empty(0, np.int64), n_rep, n_skip
    if n_rep == tile.n_records:
        lanes = np.arange(n_lanes, dtype=np.int64)
        keys, ssn = tile.keys_fixed, tile.wr_ssn
    else:
        lanes = np.flatnonzero(ok[tile.wr_rec])
        keys, ssn = tile.keys_fixed[lanes], tile.wr_ssn[lanes]
    n = len(lanes)
    if n == 0:
        return lanes, n_rep, n_skip
    pos = np.arange(n, dtype=np.int64)
    if n < _FUSED_MIN_LANES or not fits_i32(ssn):
        w, _, _ = _group_winners(keys, ssn, pos)
        return lanes[w], n_rep, n_skip

    from ..kernels.ops import fused_replay_scan
    from ..kernels.scatter_max import NO_POS

    words = _key_words(keys)
    h = _hash_words(words)
    n_slots = 2 * bucket(n)            # ~1/2 load factor keeps spills rare
    slot = (h.view(np.uint64) & np.uint64(n_slots - 1)).view(np.int64)
    scan = stack_i32([slot, ssn, pos], bucket(n),
                     fills=(n_slots, -1, int(NO_POS)))
    dev = kernel_device(device)
    out_ssn, out_pos = fused_replay_scan(
        torch.from_numpy(scan).to(dev), n_slots=n_slots
    )
    out_ssn = out_ssn.cpu().numpy().astype(np.int64)
    out_pos = out_pos.cpu().numpy().astype(np.int64)

    win_idx = np.flatnonzero((ssn == out_ssn[slot]) & (pos == out_pos[slot]))
    owner_of_slot = np.empty(n_slots, np.int64)
    owner_of_slot[slot[win_idx]] = win_idx
    owner = owner_of_slot[slot]        # each lane's slot-winning lane
    same_h = h == h[owner]
    if bool((same_h & ~(words == words[owner]).all(axis=1)).any()):
        # true 64-bit hash collision: two distinct keys merged into one
        # hash group — resolve the whole tile exactly
        w, _, _ = _group_winners(keys, ssn, pos)
        return lanes[w], n_rep, n_skip
    spill = np.flatnonzero(~same_h)
    if len(spill):
        w_sp, _, _ = _group_winners(keys[spill], ssn[spill], pos[spill])
        win_idx = np.concatenate([win_idx, spill[w_sp]])
    return lanes[win_idx], n_rep, n_skip


def _apply_tile_winners(
    data: Dict[bytes, Tuple[bytes, int]], tile: FastTile, lanes: np.ndarray
) -> None:
    """Merge one tile's per-key winners into the running image under the
    strict-`>` SSN guard (the scalar rule: the image — which starts as the
    checkpoint — wins ties; cross-tile same-key ties cannot happen because
    per-key SSNs strictly increase).  Values materialize lazily here, only
    for lanes that won their tile."""
    if not len(lanes):
        return
    keys = tile.keys_fixed[lanes].tolist()
    ssns = tile.wr_ssn[lanes].tolist()
    for k, s, v in zip(keys, ssns, tile.values_for(lanes)):
        key = k[:-1]                  # drop the \x01 terminator
        cur = data.get(key)
        if cur is None or s > cur[1]:
            data[key] = (v, s)


def _recover_fused(
    state: RecoveredState,
    devices: Sequence[StorageDevice],
    floors: Sequence[int],
    parallel: bool,
    device="cuda",
) -> bool:
    """The fused recovery pipeline (``mode="kernel"``).

    Stage order is dictated by the §5 guard: the **tails** decode first —
    each device's durable SSN frontier pins RSNe, and an empty tail reads
    its frontier off the newest seal stamp in the manifest — then the sealed
    tiles stream through decode→scan→merge, prefetch-decoded on worker
    threads (seal-crc verified, per-frame crc skipped) while the calling
    thread runs the previous tile's fused scan (on its own current stream)
    and merge.  Sealed segments end at
    record boundaries, so tiles are independent and the merge is order-free.

    Returns False — leaving ``state.data`` untouched — when anything is out
    of profile (a device without a segment chain, XSHARD records, a sealed
    blob that decodes short): the caller redoes recovery on the generic
    columnar path, which handles all of those, with identical semantics.
    """
    if not all(hasattr(d, "read_segment_entries") for d in devices):
        return False
    per_dev = [d.read_segment_entries() for d in devices]

    tail_tiles: List[FastTile] = []
    for ents in per_dev:
        t = decode_fast_tile(ents[-1][0])
        if t is None:
            return False
        tail_tiles.append(t)
    rsne = None
    for ents, tt, floor in zip(per_dev, tail_tiles, floors):
        if tt.n_records:
            last = tt.last_ssn
        elif len(ents) > 1:
            last = int(ents[-2][2])   # newest sealed segment's seal stamp
        else:
            last = 0
        last = max(last, floor)
        rsne = last if rsne is None else min(rsne, last)
    state.rsne = rsne or 0

    sealed = [ents[i][:2] for ents in per_dev for i in range(len(ents) - 1)]
    data: Dict[bytes, Tuple[bytes, int]] = dict(state.data)
    n_rep = n_skip = 0

    def _decode(ent: Tuple[bytes, Optional[int]]):
        return decode_fast_tile(ent[0], crc=ent[1]), len(ent[0])

    ex = None
    if parallel and len(sealed) > 1:
        from concurrent.futures import ThreadPoolExecutor
        ex = ThreadPoolExecutor(max_workers=2)
        tiles_iter = ex.map(_decode, sealed)
    else:
        tiles_iter = map(_decode, sealed)
    try:
        for tile, blob_len in tiles_iter:
            if tile is None or tile.consumed < blob_len:
                return False          # out of profile / short sealed blob
            lanes, r, s = _fused_tile_winners(tile, state.rsne, device)
            _apply_tile_winners(data, tile, lanes)
            n_rep += r
            n_skip += s
    finally:
        if ex is not None:
            ex.shutdown(wait=False)
    for tt in tail_tiles:
        lanes, r, s = _fused_tile_winners(tt, state.rsne, device)
        _apply_tile_winners(data, tt, lanes)
        n_rep += r
        n_skip += s
    state.data = data
    state.n_replayed = n_rep
    state.n_skipped_uncommitted = n_skip
    return True


# --- top-level recovery -------------------------------------------------------

def _load_per_device(devices: Sequence[StorageDevice], decode, parallel: bool) -> List:
    out: List = [None] * len(devices)

    def _load(i: int) -> None:
        out[i] = decode(devices[i].read_all())

    parallel_for(len(devices), _load, parallel)
    return out


def load_columnar_segmented(
    devices: Sequence[StorageDevice], parallel: bool,
    segments: Optional[List[Dict]] = None,
) -> List[ColumnarLog]:
    """Segment-parallel columnar decode: every (device, segment) pair decodes
    on its own thread and the chunks splice back per device in chain order.

    Sealed segments end at record boundaries, so each blob is an independent
    framed stream; only the tail blob can carry a torn frame, and it is the
    last chunk, so per-segment truncation semantics equal whole-log decode.
    Devices without a segment chain (journal lanes, test doubles) fall back
    to one blob via ``read_all``.

    ``segments``, when given, is extended with one per-(device, segment)
    timing row (the :class:`RecoveryReport` decode breakdown).
    """
    blobs: List[List[bytes]] = [
        d.read_segment_blobs() if hasattr(d, "read_segment_blobs")
        else [d.read_all()]
        for d in devices
    ]
    flat = [(di, si) for di, bs in enumerate(blobs) for si in range(len(bs))]
    decoded: List[Optional[Tuple[ColumnarLog, int]]] = [None] * len(flat)
    seg_s = [0.0] * len(flat)

    def _decode(j: int) -> None:
        di, si = flat[j]
        t0 = time.perf_counter()
        decoded[j] = decode_columnar_stream(blobs[di][si])
        seg_s[j] = time.perf_counter() - t0

    parallel_for(len(flat), _decode, parallel)

    if segments is not None:
        for j, (di, si) in enumerate(flat):
            segments.append({
                "device": di, "segment": si,
                "bytes": len(blobs[di][si]),
                "records": decoded[j][0].n_records,
                "seconds": seg_s[j],
            })

    out: List[ColumnarLog] = []
    j = 0
    for bs in blobs:
        chunk = decoded[j : j + len(bs)]
        j += len(bs)
        # a blob that did not fully decode ends this device's stream: a
        # whole-log decode would stop at that frame too (only the final,
        # tail blob can legitimately end torn)
        keep: List[ColumnarLog] = []
        for (log, consumed), blob in zip(chunk, bs):
            keep.append(log)
            if consumed < len(blob):
                break
        out.append(keep[0] if len(keep) == 1 else ColumnarLog.concat(keep))
    return out


def recover(
    devices: Sequence[StorageDevice],
    checkpoint_dir: Optional[str] = None,
    parallel: bool = True,
    mode: str = "kernel",
    device="cuda",
) -> RecoveredState:
    """Restore a consistent state from checkpoint files + device logs.

    ``mode`` selects the replay engine: ``"kernel"`` (default, the fused
    tile pipeline with the scatter-max kernel on ``device``),
    ``"vectorized"`` (batched numpy last-writer-wins), or ``"scalar"`` (the
    per-record oracle).  Kernel mode on ``device="cuda"`` raises when no
    CUDA device is present; ``device="cpu"`` runs the kernels' plain
    PyTorch versions.  All modes are equivalent; ``parallel`` controls
    decode threading — the vectorized
    paths decode per (device, sealed segment) pair, so a long-lived
    segmented log fans decode wider than one thread per device — and, for
    the scalar mode, per-device replay threading.

    Truncated logs (see `repro.core.truncate.LogTruncator`) recover from
    ``(checkpoint image, retained log suffix)``: pass the ``checkpoint_dir``
    the truncator was anchored to — its image covers everything the dropped
    segments held, and fully-truncated devices contribute their persisted
    ``truncated_ssn`` floor to RSNe instead of pinning it to 0.
    """
    if mode not in ("vectorized", "kernel", "scalar"):
        raise ValueError(f"unknown recovery mode {mode!r}")
    dev = kernel_device(device) if mode == "kernel" else None
    state = RecoveredState()
    report = state.report = RecoveryReport(mode=mode, n_devices=len(devices))

    # --- stage 1: checkpoint recovery -------------------------------------
    ckpt: Optional[CheckpointData] = None
    if checkpoint_dir is not None:
        ckpt = load_latest_checkpoint(checkpoint_dir, parallel=parallel)
    if ckpt is not None:
        state.rsns = ckpt.rsn
        state.data.update(ckpt.data)
        report.rsns = ckpt.rsn
        report.checkpoint_keys = len(ckpt.data)

    def _finalize() -> RecoveredState:
        report.rsne = state.rsne
        report.n_replayed = state.n_replayed
        report.n_dropped_above_rsne = state.n_skipped_uncommitted
        return state

    # --- stage 2: log recovery --------------------------------------------
    floors = device_ssn_floors(devices)
    _trace = TRACER.enabled
    if mode == "scalar":
        _t0 = time.perf_counter()
        device_records = _load_per_device(devices, decode_records, parallel)
        state.rsne = compute_rsne(device_records, floors=floors)
        _t1 = time.perf_counter()
        report.decode_s = _t1 - _t0
        report.n_decoded = sum(len(r) for r in device_records)
        if _trace:
            TRACER.record(
                ST_RDECODE, device=len(devices), t0=_t0, t1=_t1,
                n_txn=report.n_decoded,
            )
        _replay_scalar(state, device_records, state.rsne, parallel)
        report.replay_s = time.perf_counter() - _t1
        if _trace:
            TRACER.record(
                ST_RREPLAY, txn_hi=state.rsne, t0=_t1,
                t1=_t1 + report.replay_s, n_txn=state.n_replayed,
            )
        return _finalize()

    if mode == "kernel":
        _t0 = time.perf_counter()
        if _recover_fused(state, devices, floors, parallel, dev):
            report.fused = True
            # one tiled decode→scan→merge sweep: decode and replay are
            # pipelined, so the wall time is attributed to replay
            report.replay_s = time.perf_counter() - _t0
            report.n_decoded = state.n_replayed + state.n_skipped_uncommitted
            if _trace:
                # (aux=1 marks the fused engine)
                TRACER.record(
                    ST_RREPLAY, txn_hi=state.rsne, t0=_t0,
                    t1=_t0 + report.replay_s, n_txn=state.n_replayed, aux=1,
                )
            return _finalize()

    _t0 = time.perf_counter()
    logs: List[ColumnarLog] = load_columnar_segmented(
        devices, parallel, segments=report.segments
    )
    state.rsne = compute_rsne(logs, floors=floors)
    _t1 = time.perf_counter()
    report.decode_s = _t1 - _t0
    report.n_decoded = sum(lg.n_records for lg in logs)
    if _trace:
        TRACER.record(
            ST_RDECODE, device=len(devices), t0=_t0, t1=_t1,
            nbytes=sum(d.durable_bytes() for d in devices
                       if hasattr(d, "durable_bytes")),
            n_txn=report.n_decoded,
        )
    data, n_replayed, n_skipped = replay_columnar(
        logs, state.rsne, base=state.data or None,
        use_kernel=(mode == "kernel"), device=dev,
    )
    state.data = data
    state.n_replayed = n_replayed
    state.n_skipped_uncommitted = n_skipped
    report.replay_s = time.perf_counter() - _t1
    if _trace:
        TRACER.record(
            ST_RREPLAY, txn_hi=state.rsne, t0=_t1,
            t1=_t1 + report.replay_s, n_txn=n_replayed, aux=n_skipped,
        )
    return _finalize()
