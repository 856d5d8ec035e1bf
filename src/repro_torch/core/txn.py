"""Transaction objects and log-record framing for the Poplar engine.

The paper (§2) assumes each transaction produces a single log record holding
all of its writes.  A record here is framed as::

    [u32 length][u32 crc32-of-payload][payload]
    payload := [u64 ssn][u64 tid][u8 flags][u32 n_writes]
               n_writes * ([u32 key_len][key bytes][u32 val_len][val bytes])

``flags`` bit 0: HAS_READS — the transaction had a read set, i.e. it was
committed through the Qwr / CSN path and carries potential RAW dependencies.
Write-only (Qww) records may be replayed past RSNe during recovery (§5);
records with HAS_READS may not.

``flags`` bit 1: XSHARD — the record belongs to a cross-shard transaction
(`repro.shard`).  The payload then carries a dependency footer after the
writes::

    footer := [u32 n_parts] n_parts * ([u32 shard_id][u64 ssn])

listing every participating shard and the SSN the transaction holds there —
the explicit cross-shard WAW/RAW dependency edge.  The transaction's global
id (gtid) is the record's ``tid``, identical on every participant, so
sharded recovery can resolve a consistent cut: a cross-shard transaction is
replayed iff a record with its gtid is durable on *all* participants (see
``repro.shard.recovery``).

``flags`` bit 2: COMMAND — the record is *command-framed* (adaptive logging,
ROADMAP item 2): the per-write value slot carries the op's *parameter*
instead of the new tuple image, and the payload carries a command footer
after the write chain::

    cmd_footer := [u32 op_id][u32 n_deps]
                  n_deps * ([u32 key_len][key bytes][u64 observed_ssn])

``op_id`` names a deterministic operator in ``repro.core.command.COMMANDS``
(``new_value = op(old_value, param)``); the dep entries record, for each
written key, the SSN of the pre-image the transaction observed — the RAW
edge recovery must satisfy before re-executing the command.  The engine's
adaptive policy only emits command frames whose deps mirror the write chain
one-to-one (``n_deps == n_writes``, same keys, same order).  COMMAND and
XSHARD are mutually exclusive by policy (cross-shard records always carry
values); a frame with both bits set is treated as malformed.

The length+crc framing makes torn tail writes detectable: recovery truncates
the log at the first bad frame, which is exactly the paper's "buffer hole"
semantics at the device level.  Every decoder in this module walks frames
through one shared parser (:func:`_parse_frame`), so torn/corrupt/malformed
semantics cannot drift between the scalar, columnar, and streaming paths.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

FLAG_HAS_READS = 0x01
FLAG_XSHARD = 0x02
FLAG_COMMAND = 0x04

_HDR = struct.Struct("<II")           # length, crc32
_PAYLOAD_FIXED = struct.Struct("<QQBI")  # ssn, tid, flags, n_writes
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_XPART = struct.Struct("<IQ")         # shard_id, ssn (xdep footer entry)
_CMD_FIXED = struct.Struct("<II")     # op_id, n_deps (command footer prefix)


@dataclass
class Txn:
    """A transaction as seen by the logging subsystem."""

    tid: int
    # read set: list of (key, ssn observed at read time)
    read_set: List[Tuple[Any, int]] = field(default_factory=list)
    # write set: list of (key, new value bytes)
    write_set: List[Tuple[Any, bytes]] = field(default_factory=list)

    # Filled in by the engine:
    ssn: int = -1
    buffer_id: int = -1
    offset: int = -1          # logical offset of the record in its log buffer
    record: bytes = b""

    # cross-shard dependency edge (repro.shard): every participant shard and
    # the SSN this transaction holds there; None for single-shard records
    xdep: Optional[List[Tuple[int, int]]] = None

    # command framing (adaptive logging): when ``cmd_op`` is set the record
    # is emitted as FLAG_COMMAND — write_set values are op *params*, and
    # ``cmd_deps`` lists (key, observed pre-image ssn), mirroring write_set
    # order.  Mutually exclusive with ``xdep``.
    cmd_op: Optional[int] = None
    cmd_deps: Optional[List[Tuple[Any, int]]] = None

    # lifecycle timestamps (perf accounting)
    t_start: float = 0.0
    t_precommit: float = 0.0  # SSN allocated + record buffered ("pre-committed")
    t_commit: float = 0.0     # durably committed
    committed: bool = False
    aborted: bool = False

    @property
    def has_reads(self) -> bool:
        return bool(self.read_set)

    @property
    def write_only(self) -> bool:
        return not self.read_set

    def encode(self) -> bytes:
        """Serialize this transaction into a single framed log record."""
        flags = FLAG_HAS_READS if self.has_reads else 0
        if self.xdep is not None:
            flags |= FLAG_XSHARD
        if self.cmd_op is not None:
            if self.xdep is not None:
                raise ValueError("COMMAND and XSHARD are mutually exclusive")
            flags |= FLAG_COMMAND
        parts = [
            _PAYLOAD_FIXED.pack(self.ssn, self.tid, flags, len(self.write_set))
        ]
        for key, val in self.write_set:
            kb = key.encode() if isinstance(key, str) else bytes(key)
            parts.append(_U32.pack(len(kb)))
            parts.append(kb)
            parts.append(_U32.pack(len(val)))
            parts.append(val)
        if self.cmd_op is not None:
            deps = self.cmd_deps or []
            parts.append(_CMD_FIXED.pack(self.cmd_op, len(deps)))
            for key, dssn in deps:
                kb = key.encode() if isinstance(key, str) else bytes(key)
                parts.append(_U32.pack(len(kb)))
                parts.append(kb)
                parts.append(_U64.pack(dssn))
        if self.xdep is not None:
            parts.append(_U32.pack(len(self.xdep)))
            for shard_id, ssn in self.xdep:
                parts.append(_XPART.pack(shard_id, ssn))
        payload = b"".join(parts)
        self.record = _HDR.pack(len(payload), zlib.crc32(payload)) + payload
        return self.record


# the frame prefix of a record as an unaligned structured dtype: exactly
# _HDR ("<II") followed by _PAYLOAD_FIXED ("<QQBI"), 29 bytes
_FRAME_DTYPE = np.dtype(
    {
        "names": ["len", "crc", "ssn", "tid", "flags", "nw"],
        "formats": ["<u4", "<u4", "<u8", "<u8", "u1", "<u4"],
        "offsets": [0, 4, 8, 16, 24, 25],
        "itemsize": _HDR.size + _PAYLOAD_FIXED.size,
    }
)


def _scatter_ranges(starts: np.ndarray, width: int) -> np.ndarray:
    """Flat indices of ``n`` byte ranges ``[starts[i], starts[i]+width)``."""
    return (starts[:, None] + np.arange(width, dtype=np.int64)).ravel()


def encode_batch(txns: Sequence["Txn"]) -> Tuple[bytes, np.ndarray]:
    """Encode a batch of transactions into one contiguous framed blob —
    byte-identical to ``b"".join(t.encode() for t in txns)``, i.e. exactly
    the stream :func:`decode_columnar` reads back during recovery.

    The encode is columnar: every fixed-width field (frame headers, payload
    fixed parts, per-write key/value length prefixes) is computed as a numpy
    column and scattered into the output buffer in one fancy-index per
    column; the only per-item Python left is one memcpy per key/value blob
    and one ``zlib.crc32`` per record.  This is the encode half of the
    batched forward path: the caller reserves a contiguous region via
    :meth:`~repro.core.log_buffer.LogBuffer.reserve_batch` and fills it with
    the returned blob in one ring memcpy.

    Returns ``(blob, framed_lengths)``; ``framed_lengths[i]`` matches what
    ``Txn.encode`` would report for ``txns[i]``.
    """
    n = len(txns)
    if n == 0:
        return b"", np.empty(0, dtype=np.int64)

    kbs: List[bytes] = []
    vals: List[bytes] = []
    nw_l: List[int] = []
    ssn_l: List[int] = []
    tid_l: List[int] = []
    flag_l: List[int] = []
    op_l: List[int] = []
    dep_l: List[int] = []
    any_cmd = False
    for t in txns:
        nw_l.append(len(t.write_set))
        ssn_l.append(t.ssn)
        tid_l.append(t.tid)
        fl = FLAG_HAS_READS if t.read_set else 0
        if t.cmd_op is not None:
            fl |= FLAG_COMMAND
            any_cmd = True
            op_l.append(t.cmd_op)
            deps = t.cmd_deps or []
            if len(deps) != len(t.write_set):
                raise ValueError("cmd_deps must mirror write_set")
            dep_l.extend(d for _, d in deps)
        else:
            op_l.append(0)
            dep_l.extend(0 for _ in t.write_set)
        flag_l.append(fl)
        for key, val in t.write_set:
            kbs.append(key.encode() if isinstance(key, str) else bytes(key))
            vals.append(val)
    return encode_batch_columns(
        np.asarray(ssn_l, dtype=np.int64),
        np.asarray(tid_l, dtype=np.int64),
        np.asarray(flag_l, dtype=np.uint8),
        np.asarray(nw_l, dtype=np.int64),
        kbs,
        vals,
        cmd_op=np.asarray(op_l, dtype=np.int64) if any_cmd else None,
        cmd_dep_ssn=np.asarray(dep_l, dtype=np.int64) if any_cmd else None,
    )


def encode_batch_columns(
    ssn: np.ndarray,                 # (n,) per-record SSN
    tid: np.ndarray,                 # (n,) per-record tid
    flags: np.ndarray,               # (n,) uint8 flags (FLAG_HAS_READS)
    nw: np.ndarray,                  # (n,) writes per record
    kbs: Sequence[bytes],            # flattened key bytes, record-major
    vals: Sequence[bytes],           # flattened value bytes, record-major
    klen: Optional[np.ndarray] = None,
    vlen: Optional[np.ndarray] = None,
    cmd_op: Optional[np.ndarray] = None,
    cmd_dep_ssn: Optional[np.ndarray] = None,
) -> Tuple[bytes, np.ndarray]:
    """Columnar core of :func:`encode_batch`: frame a batch straight from
    arrays — the fully array-native entry used by the indexed batch pipeline
    (`repro.db.batch.BatchOCC.execute_indexed`), where keys/lengths come
    from the table's columns instead of per-``Txn`` objects.

    Mixed command/value batches: records whose ``flags`` carry
    ``FLAG_COMMAND`` gain the command footer.  ``cmd_op`` is the per-record
    op id and ``cmd_dep_ssn`` the per-*write* observed pre-image SSN (both
    only read where the owning record is command-framed); dep keys mirror
    the write chain, the policy invariant the footer format encodes."""
    n = len(ssn)
    if n == 0:
        return b"", np.empty(0, dtype=np.int64)
    frame = _FRAME_DTYPE.itemsize
    if klen is None:
        klen = np.fromiter(map(len, kbs), np.int64, len(kbs))
    if vlen is None:
        vlen = np.fromiter(map(len, vals), np.int64, len(vals))
    wlen = 8 + klen + vlen                       # framed bytes per write

    wstart = np.zeros(n + 1, dtype=np.int64)     # per-txn write-slice prefix
    np.cumsum(nw, out=wstart[1:])
    wcs = np.zeros(len(kbs) + 1, dtype=np.int64)
    np.cumsum(wlen, out=wcs[1:])
    chain = wcs[wstart[1:]] - wcs[wstart[:-1]]   # write-chain bytes per record
    is_cmd = (np.asarray(flags, dtype=np.uint8) & FLAG_COMMAND) != 0
    if is_cmd.any():
        if cmd_op is None or cmd_dep_ssn is None:
            raise ValueError("FLAG_COMMAND records need cmd_op/cmd_dep_ssn")
        kcs = np.zeros(len(kbs) + 1, dtype=np.int64)
        np.cumsum(klen, out=kcs[1:])
        rec_kbytes = kcs[wstart[1:]] - kcs[wstart[:-1]]
        foot = np.where(is_cmd, _CMD_FIXED.size + 12 * nw + rec_kbytes, 0)
    else:
        foot = 0
    plen = _PAYLOAD_FIXED.size + chain + foot
    lengths = _HDR.size + plen
    rec_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=rec_off[1:])
    out = np.zeros(int(rec_off[-1]), dtype=np.uint8)

    # frame prefixes (len/ssn/tid/flags/nw; crc patched after the blobs land)
    hdr = np.zeros(n, dtype=_FRAME_DTYPE)
    hdr["len"] = plen
    hdr["ssn"] = np.asarray(ssn, dtype=np.int64).view(np.uint64)
    hdr["tid"] = np.asarray(tid, dtype=np.int64).view(np.uint64)
    hdr["flags"] = flags
    hdr["nw"] = nw
    out[_scatter_ranges(rec_off[:-1], frame)] = hdr.view(np.uint8)

    if len(kbs):
        # absolute offset of each write's framed region
        intra = wcs[:-1] - np.repeat(wcs[wstart[:-1]], nw)
        woff = np.repeat(rec_off[:-1] + frame, nw) + intra
        out[_scatter_ranges(woff, 4)] = (
            klen.astype("<u4").view(np.uint8).reshape(-1, 4).ravel()
        )
        voff = woff + 4 + klen
        out[_scatter_ranges(voff, 4)] = (
            vlen.astype("<u4").view(np.uint8).reshape(-1, 4).ravel()
        )
        mv = memoryview(out)
        for o, ln, kb in zip((woff + 4).tolist(), klen.tolist(), kbs):
            mv[o : o + ln] = kb
        for o, ln, vb in zip((voff + 4).tolist(), vlen.tolist(), vals):
            mv[o : o + ln] = vb

    if is_cmd.any():
        # command footers: [u32 op][u32 n_deps] then one keyed dep per write
        cidx = np.flatnonzero(is_cmd)
        foot_off = rec_off[:-1] + frame + chain
        out[_scatter_ranges(foot_off[cidx], 4)] = (
            np.asarray(cmd_op, dtype=np.int64)[cidx]
            .astype("<u4").view(np.uint8).reshape(-1, 4).ravel()
        )
        out[_scatter_ranges(foot_off[cidx] + 4, 4)] = (
            nw[cidx].astype("<u4").view(np.uint8).reshape(-1, 4).ravel()
        )
        wmask = np.repeat(is_cmd, nw)
        if wmask.any():
            dlen = 12 + klen                     # framed bytes per dep entry
            dcs = np.zeros(len(kbs) + 1, dtype=np.int64)
            np.cumsum(dlen, out=dcs[1:])
            intra_dep = dcs[:-1] - np.repeat(dcs[wstart[:-1]], nw)
            dep_off = np.repeat(foot_off + _CMD_FIXED.size, nw) + intra_dep
            sel = np.flatnonzero(wmask)
            out[_scatter_ranges(dep_off[sel], 4)] = (
                klen[sel].astype("<u4").view(np.uint8).reshape(-1, 4).ravel()
            )
            mv = memoryview(out)
            offs = (dep_off + 4).tolist()
            lns = klen.tolist()
            for j in sel.tolist():
                mv[offs[j] : offs[j] + lns[j]] = kbs[j]
            ssn_off = dep_off + 4 + klen
            out[_scatter_ranges(ssn_off[sel], 8)] = (
                np.asarray(cmd_dep_ssn, dtype=np.int64)[sel]
                .astype("<u8").view(np.uint8).reshape(-1, 8).ravel()
            )

    # per-record CRC over the payload bytes, patched into the header column
    mv = memoryview(out)
    crc32 = zlib.crc32
    crcs = np.fromiter(
        (
            crc32(mv[p : p + ln])
            for p, ln in zip((rec_off[:-1] + _HDR.size).tolist(), plen.tolist())
        ),
        np.uint32,
        n,
    )
    out[_scatter_ranges(rec_off[:-1] + 4, 4)] = (
        crcs.astype("<u4").view(np.uint8).reshape(-1, 4).ravel()
    )
    return out.tobytes(), lengths


@dataclass
class LogRecord:
    """A decoded log record (recovery side)."""

    ssn: int
    tid: int
    has_reads: bool
    writes: List[Tuple[bytes, bytes]]
    # cross-shard dependency edge: [(shard_id, ssn), ...] over every
    # participant; None for single-shard records.  The gtid is ``tid``.
    xdep: Optional[List[Tuple[int, int]]] = None
    # command framing: op id + [(dep key, observed pre-image ssn), ...];
    # both None for value records.  When set, ``writes`` carries params.
    cmd_op: Optional[int] = None
    cmd_deps: Optional[List[Tuple[bytes, int]]] = None

    @property
    def write_only(self) -> bool:
        return not self.has_reads

    @property
    def is_command(self) -> bool:
        return self.cmd_op is not None


class Frame:
    """One fully parsed, validated log frame — the unit every decoder in
    this module consumes (see :func:`_parse_frame`)."""

    __slots__ = ("ssn", "tid", "flags", "n_writes", "keys", "vals", "klens",
                 "xdep", "cmd_op", "cmd_deps", "end")

    def __init__(self, ssn, tid, flags, n_writes, keys, vals, klens,
                 xdep, cmd_op, cmd_deps, end):
        self.ssn = ssn
        self.tid = tid
        self.flags = flags
        self.n_writes = n_writes
        self.keys = keys
        self.vals = vals
        self.klens = klens
        self.xdep = xdep
        self.cmd_op = cmd_op
        self.cmd_deps = cmd_deps
        self.end = end


def _parse_frame(buf: bytes, off: int, n: int) -> Optional[Frame]:
    """Parse and validate the frame starting at ``off``; ``None`` if it is
    torn (runs past ``n``), crc-corrupt, or malformed (write chain or footer
    out of bounds, COMMAND+XSHARD).  This is the *single* frame walk shared
    by :func:`decode_records` and :func:`decode_columnar_stream`, so the
    stop-at-first-bad-frame semantics are identical by construction."""
    if off + _HDR.size > n:
        return None
    length, crc = _HDR.unpack_from(buf, off)
    start = off + _HDR.size
    end = start + length
    if end > n:
        return None  # torn tail write
    payload = buf[start:end]
    if zlib.crc32(payload) != crc:
        return None  # corrupt frame: stop (holes never precede valid frames
        # on a device because segments flush sequentially)
    ssn, tid, flags, n_writes = _PAYLOAD_FIXED.unpack_from(payload, 0)
    pos = _PAYLOAD_FIXED.size
    keys: List[bytes] = []
    vals: List[bytes] = []
    klens: List[int] = []
    for _ in range(n_writes):
        if pos + 4 > length:
            return None
        (klen,) = _U32.unpack_from(payload, pos)
        pos += 4
        if pos + klen + 4 > length:
            return None
        key = payload[pos : pos + klen]
        pos += klen
        (vlen,) = _U32.unpack_from(payload, pos)
        pos += 4
        if pos + vlen > length:
            return None
        val = payload[pos : pos + vlen]
        pos += vlen
        keys.append(key)
        vals.append(val)
        klens.append(klen)
    cmd_op: Optional[int] = None
    cmd_deps: Optional[List[Tuple[bytes, int]]] = None
    if flags & FLAG_COMMAND:
        if flags & FLAG_XSHARD:
            return None  # the classes are exclusive; both bits == malformed
        if pos + _CMD_FIXED.size > length:
            return None
        cmd_op, n_deps = _CMD_FIXED.unpack_from(payload, pos)
        pos += _CMD_FIXED.size
        cmd_deps = []
        for _ in range(n_deps):
            if pos + 4 > length:
                return None
            (dklen,) = _U32.unpack_from(payload, pos)
            pos += 4
            if pos + dklen + 8 > length:
                return None
            dkey = payload[pos : pos + dklen]
            pos += dklen
            (dssn,) = _U64.unpack_from(payload, pos)
            pos += 8
            cmd_deps.append((dkey, dssn))
    xdep: Optional[List[Tuple[int, int]]] = None
    if flags & FLAG_XSHARD:
        xdep, pos = _decode_xdep(payload, pos, length)
        if xdep is None:
            return None
    return Frame(ssn, tid, flags, n_writes, keys, vals, klens,
                 xdep, cmd_op, cmd_deps, end)


def decode_records(buf: bytes) -> List[LogRecord]:
    """Decode a byte stream of framed records, truncating at the first torn
    or corrupt frame (paper §5: only fully durable records participate)."""
    out: List[LogRecord] = []
    off = 0
    n = len(buf)
    while True:
        fr = _parse_frame(buf, off, n)
        if fr is None:
            break
        out.append(
            LogRecord(
                ssn=fr.ssn,
                tid=fr.tid,
                has_reads=bool(fr.flags & FLAG_HAS_READS),
                writes=list(zip(fr.keys, fr.vals)),
                xdep=fr.xdep,
                cmd_op=fr.cmd_op,
                cmd_deps=fr.cmd_deps,
            )
        )
        off = fr.end
    return out


def _decode_xdep(
    payload: bytes, pos: int, length: int
) -> Tuple[Optional[List[Tuple[int, int]]], int]:
    """Parse the XSHARD dependency footer; ``(None, pos)`` on a bounds error
    (torn frame — the caller stops decoding, like any other malformed frame)."""
    if pos + 4 > length:
        return None, pos
    (n_parts,) = _U32.unpack_from(payload, pos)
    pos += 4
    if pos + n_parts * _XPART.size > length:
        return None, pos
    parts: List[Tuple[int, int]] = []
    for _ in range(n_parts):
        shard_id, ssn = _XPART.unpack_from(payload, pos)
        pos += _XPART.size
        parts.append((shard_id, ssn))
    return parts, pos


@dataclass
class ColumnarLog:
    """A decoded device log in columnar (struct-of-arrays) form.

    Per-record columns (length ``n_records``):

    * ``ssn``       — int64, monotone within one device log (flush order);
    * ``tid``       — int64;
    * ``has_reads`` — bool; write-only (Qww) records have ``has_reads=False``
      and may be replayed past RSNe, HAS_READS (Qwr) records may not;
    * ``n_writes``  — int32 writes carried by each record.

    Per-write columns (length ``n_writes.sum()``), flattened record-major so
    write ``j`` belongs to record ``wr_rec[j]``:

    * ``wr_rec``  — int64 owning-record index;
    * ``wr_klen`` — int64 true key length in bytes;
    * ``keys_fixed`` — the keys in a fixed-width numpy ``'S'`` array holding
      ``key + b"\\x01"`` NUL-padded to a multiple of 8 (so replay can
      reinterpret it as int64 words without copying).  The ``\\x01``
      terminator makes the padded cell an *exact*, self-delimiting key
      identity — raw NUL padding alone would make ``b"a"`` and ``b"a\\0"``
      compare equal under 'S' semantics.  Recover the original bytes by
      stripping trailing NULs and dropping the final byte (decode it with
      :meth:`fixed_to_key`);
    * ``keys`` / ``values`` — the raw bytes (variable length, Python lists;
      replay touches these only to materialize the winning entries).

    This is the decode format of the batched replay path: recovery never
    materializes per-record Python objects, it reduces these arrays directly
    (see :func:`repro.core.recovery.replay_columnar`).
    """

    ssn: np.ndarray
    tid: np.ndarray
    has_reads: np.ndarray
    n_writes: np.ndarray
    wr_rec: np.ndarray
    wr_klen: np.ndarray
    keys_fixed: np.ndarray
    keys: List[bytes]
    values: List[bytes]
    _values_obj: Optional[np.ndarray] = None
    # cross-shard dependency columns (``None`` when the log carries no
    # XSHARD records — the common case, and the shape every pre-shard
    # constructor produces).  ``x_rec[i]`` is the owning record index of the
    # i-th cross-shard record, ``xp_start`` the ``(len(x_rec)+1,)`` prefix
    # delimiting its participant slice of ``xp_shard``/``xp_ssn``.  The gtid
    # of ``x_rec[i]`` is ``tid[x_rec[i]]``.
    x_rec: Optional[np.ndarray] = None
    xp_start: Optional[np.ndarray] = None
    xp_shard: Optional[np.ndarray] = None
    xp_ssn: Optional[np.ndarray] = None
    # command columns (``None`` when the log carries no COMMAND records).
    # ``cmd_rec[i]`` is the owning record index of the i-th command record,
    # ``cmd_op[i]`` its registry op id, ``cmd_dep_start`` the
    # ``(len(cmd_rec)+1,)`` prefix delimiting its dep slice of
    # ``cmd_dep_key``/``cmd_dep_ssn`` (dep keys mirror the record's write
    # chain; the SSN is the observed pre-image version).  For command
    # records the ``values`` entries are op *params*, not tuple images.
    cmd_rec: Optional[np.ndarray] = None
    cmd_op: Optional[np.ndarray] = None
    cmd_dep_start: Optional[np.ndarray] = None
    cmd_dep_key: Optional[List[bytes]] = None
    cmd_dep_ssn: Optional[np.ndarray] = None

    @property
    def n_records(self) -> int:
        return len(self.ssn)

    @property
    def n_command(self) -> int:
        return 0 if self.cmd_rec is None else len(self.cmd_rec)

    @property
    def cmd_mask(self) -> np.ndarray:
        """Per-record bool: is record i command-framed?"""
        m = np.zeros(self.n_records, dtype=bool)
        if self.cmd_rec is not None:
            m[self.cmd_rec] = True
        return m

    @property
    def cmd_op_col(self) -> np.ndarray:
        """Per-record op id (-1 for value records)."""
        col = np.full(self.n_records, -1, dtype=np.int64)
        if self.cmd_rec is not None:
            col[self.cmd_rec] = self.cmd_op
        return col

    @staticmethod
    def encode_keys_fixed(keys: Sequence[bytes], klens: Sequence[int]) -> np.ndarray:
        """Build the sentinel-terminated fixed-width key array (see class
        docstring) for ``keys`` with known lengths ``klens``."""
        if not len(keys):
            return np.empty(0, dtype="S8")
        width = -(-(max(klens) + 1) // 8) * 8
        arr = np.asarray(keys, dtype=f"S{width}")
        u8 = arr.view(np.uint8).reshape(len(arr), width)
        u8[np.arange(len(arr)), np.asarray(klens)] = 1
        return arr

    @staticmethod
    def fixed_to_key(cell: bytes) -> bytes:
        """Invert the ``keys_fixed`` encoding for one (NUL-stripped) cell."""
        return cell[:-1]

    @property
    def values_obj(self) -> np.ndarray:
        """The values as an object ndarray (cached) — lets replay gather the
        winning payloads with one fancy-index instead of per-item list ops."""
        if self._values_obj is None:
            self._values_obj = np.fromiter(self.values, dtype=object, count=len(self.values))
        return self._values_obj

    @property
    def last_ssn(self) -> int:
        """SSN of the most recently durable record (device DSN frontier)."""
        return int(self.ssn[-1]) if len(self.ssn) else 0

    @property
    def wr_ssn(self) -> np.ndarray:
        """Per-write SSN (gathered from the owning record)."""
        return self.ssn[self.wr_rec]

    @property
    def wr_has_reads(self) -> np.ndarray:
        return self.has_reads[self.wr_rec]

    @property
    def n_xshard(self) -> int:
        return 0 if self.x_rec is None else len(self.x_rec)

    @staticmethod
    def concat(parts: Sequence["ColumnarLog"]) -> "ColumnarLog":
        """Concatenate decoded chunks of one log stream in arrival order —
        equivalent to decoding the concatenated bytes (incremental tailers
        decode only new frames and splice the chunks with this)."""
        parts = [p for p in parts if p.n_records]
        if not parts:
            return decode_columnar(b"")
        if len(parts) == 1:
            return parts[0]
        rec_off = np.cumsum([0] + [p.n_records for p in parts])
        keys: List[bytes] = []
        values: List[bytes] = []
        klens: List[int] = []
        x_rec: List[np.ndarray] = []
        xp_shard: List[np.ndarray] = []
        xp_ssn: List[np.ndarray] = []
        xp_start_parts: List[np.ndarray] = []
        xp_off = 0
        c_rec: List[np.ndarray] = []
        c_op: List[np.ndarray] = []
        c_dep_key: List[bytes] = []
        c_dep_ssn: List[np.ndarray] = []
        c_start_parts: List[np.ndarray] = []
        c_off = 0
        for i, p in enumerate(parts):
            keys.extend(p.keys)
            values.extend(p.values)
            klens.extend(p.wr_klen.tolist())
            if p.x_rec is not None:
                x_rec.append(p.x_rec + rec_off[i])
                xp_shard.append(p.xp_shard)
                xp_ssn.append(p.xp_ssn)
                xp_start_parts.append(p.xp_start[1:] + xp_off)
                xp_off += int(p.xp_start[-1])
            if p.cmd_rec is not None:
                c_rec.append(p.cmd_rec + rec_off[i])
                c_op.append(p.cmd_op)
                c_dep_key.extend(p.cmd_dep_key)
                c_dep_ssn.append(p.cmd_dep_ssn)
                c_start_parts.append(p.cmd_dep_start[1:] + c_off)
                c_off += int(p.cmd_dep_start[-1])
        has_x = bool(x_rec)
        has_c = bool(c_rec)
        return ColumnarLog(
            ssn=np.concatenate([p.ssn for p in parts]),
            tid=np.concatenate([p.tid for p in parts]),
            has_reads=np.concatenate([p.has_reads for p in parts]),
            n_writes=np.concatenate([p.n_writes for p in parts]),
            wr_rec=np.concatenate(
                [p.wr_rec + rec_off[i] for i, p in enumerate(parts)]
            ),
            wr_klen=np.asarray(klens, dtype=np.int64),
            keys_fixed=ColumnarLog.encode_keys_fixed(keys, klens),
            keys=keys,
            values=values,
            x_rec=np.concatenate(x_rec) if has_x else None,
            xp_start=np.concatenate([np.zeros(1, np.int64)] + xp_start_parts)
            if has_x else None,
            xp_shard=np.concatenate(xp_shard) if has_x else None,
            xp_ssn=np.concatenate(xp_ssn) if has_x else None,
            cmd_rec=np.concatenate(c_rec) if has_c else None,
            cmd_op=np.concatenate(c_op) if has_c else None,
            cmd_dep_start=np.concatenate(
                [np.zeros(1, np.int64)] + c_start_parts
            ) if has_c else None,
            cmd_dep_key=c_dep_key if has_c else None,
            cmd_dep_ssn=np.concatenate(c_dep_ssn) if has_c else None,
        )

    def to_records(self) -> List[LogRecord]:
        """Round-trip back to row objects (tests / scalar-oracle interop)."""
        xdeps: Dict[int, List[Tuple[int, int]]] = {}
        if self.x_rec is not None:
            for i, rec in enumerate(self.x_rec.tolist()):
                lo, hi = int(self.xp_start[i]), int(self.xp_start[i + 1])
                xdeps[rec] = list(
                    zip(self.xp_shard[lo:hi].tolist(), self.xp_ssn[lo:hi].tolist())
                )
        cmds: Dict[int, Tuple[int, List[Tuple[bytes, int]]]] = {}
        if self.cmd_rec is not None:
            for i, rec in enumerate(self.cmd_rec.tolist()):
                lo, hi = int(self.cmd_dep_start[i]), int(self.cmd_dep_start[i + 1])
                cmds[rec] = (
                    int(self.cmd_op[i]),
                    list(zip(self.cmd_dep_key[lo:hi],
                             self.cmd_dep_ssn[lo:hi].tolist())),
                )
        out: List[LogRecord] = []
        w = 0
        for i in range(self.n_records):
            nw = int(self.n_writes[i])
            op, deps = cmds.get(i, (None, None))
            out.append(
                LogRecord(
                    ssn=int(self.ssn[i]),
                    tid=int(self.tid[i]),
                    has_reads=bool(self.has_reads[i]),
                    writes=list(zip(self.keys[w : w + nw], self.values[w : w + nw])),
                    xdep=xdeps.get(i),
                    cmd_op=op,
                    cmd_deps=deps,
                )
            )
            w += nw
        return out


def decode_columnar(buf: bytes) -> ColumnarLog:
    """Columnar twin of :func:`decode_records`: one pass over the framed
    stream, truncating at the first torn or corrupt frame, emitting arrays
    instead of ``LogRecord`` objects.

    Same validation as the scalar decoder (length + crc32 per frame, bounds
    checks on every write) so torn-tail semantics are byte-identical.
    """
    return decode_columnar_stream(buf)[0]


def decode_columnar_stream(buf: bytes) -> Tuple[ColumnarLog, int]:
    """Incremental-framing variant of :func:`decode_columnar`: returns
    ``(log, consumed)`` where ``consumed`` is the byte offset of the first
    frame that did not decode — torn (runs past the end of ``buf``), corrupt
    (crc mismatch), or truncated mid-payload.

    This is the streaming contract of log shipping
    (`repro.replica.LogShipper`): on a *live* log a bad trailing frame just
    means the writer's append has not fully landed yet, so the tailer keeps
    the bytes from ``consumed`` on and retries once more bytes arrive — it
    never decodes a partial record.  A crash-recovery caller discards the
    remainder instead; both behaviours share this one decoder, so shipped
    and recovered torn-tail semantics are byte-identical.
    """
    ssns: List[int] = []
    tids: List[int] = []
    flags_l: List[bool] = []
    nw_l: List[int] = []
    wr_rec: List[int] = []
    klens: List[int] = []
    keys: List[bytes] = []
    values: List[bytes] = []
    x_rec: List[int] = []
    xp_shard: List[int] = []
    xp_ssn: List[int] = []
    xp_start: List[int] = [0]
    cmd_rec: List[int] = []
    cmd_op: List[int] = []
    cmd_dep_key: List[bytes] = []
    cmd_dep_ssn: List[int] = []
    cmd_dep_start: List[int] = [0]

    off = 0
    n = len(buf)
    rec_i = 0
    while True:
        fr = _parse_frame(buf, off, n)
        if fr is None:
            break  # torn, corrupt, or malformed: stop at the frame boundary
        keys.extend(fr.keys)
        values.extend(fr.vals)
        klens.extend(fr.klens)
        wr_rec.extend([rec_i] * fr.n_writes)
        if fr.xdep is not None:
            x_rec.append(rec_i)
            for shard_id, pssn in fr.xdep:
                xp_shard.append(shard_id)
                xp_ssn.append(pssn)
            xp_start.append(len(xp_shard))
        if fr.cmd_op is not None:
            cmd_rec.append(rec_i)
            cmd_op.append(fr.cmd_op)
            for dkey, dssn in fr.cmd_deps:
                cmd_dep_key.append(dkey)
                cmd_dep_ssn.append(dssn)
            cmd_dep_start.append(len(cmd_dep_key))
        ssns.append(fr.ssn)
        tids.append(fr.tid)
        flags_l.append(bool(fr.flags & FLAG_HAS_READS))
        nw_l.append(fr.n_writes)
        rec_i += 1
        off = fr.end

    return _columnar_from_lists(
        ssns, tids, flags_l, nw_l, wr_rec, klens, keys, values,
        x_rec, xp_start, xp_shard, xp_ssn,
        cmd_rec, cmd_op, cmd_dep_start, cmd_dep_key, cmd_dep_ssn,
    ), off


def _columnar_from_lists(
    ssns, tids, flags_l, nw_l, wr_rec, klens, keys, values,
    x_rec, xp_start, xp_shard, xp_ssn,
    cmd_rec=None, cmd_op=None, cmd_dep_start=None,
    cmd_dep_key=None, cmd_dep_ssn=None,
) -> ColumnarLog:
    has_cmd = bool(cmd_rec)
    return ColumnarLog(
        ssn=np.asarray(ssns, dtype=np.int64),
        tid=np.asarray(tids, dtype=np.int64),
        has_reads=np.asarray(flags_l, dtype=bool),
        n_writes=np.asarray(nw_l, dtype=np.int32),
        wr_rec=np.asarray(wr_rec, dtype=np.int64),
        wr_klen=np.asarray(klens, dtype=np.int64),
        keys_fixed=ColumnarLog.encode_keys_fixed(keys, klens),
        keys=keys,
        values=values,
        x_rec=np.asarray(x_rec, dtype=np.int64) if x_rec else None,
        xp_start=np.asarray(xp_start, dtype=np.int64) if x_rec else None,
        xp_shard=np.asarray(xp_shard, dtype=np.int64) if x_rec else None,
        xp_ssn=np.asarray(xp_ssn, dtype=np.int64) if x_rec else None,
        cmd_rec=np.asarray(cmd_rec, dtype=np.int64) if has_cmd else None,
        cmd_op=np.asarray(cmd_op, dtype=np.int64) if has_cmd else None,
        cmd_dep_start=np.asarray(cmd_dep_start, dtype=np.int64)
        if has_cmd else None,
        cmd_dep_key=list(cmd_dep_key) if has_cmd else None,
        cmd_dep_ssn=np.asarray(cmd_dep_ssn, dtype=np.int64)
        if has_cmd else None,
    )


def gather_u32(u8: np.ndarray, off: np.ndarray) -> np.ndarray:
    """Little-endian u32 values at arbitrary byte offsets of a uint8 view —
    the unaligned-field gather of the vectorized frame scan (int64 out)."""
    o = off.astype(np.int64, copy=False)
    return (
        u8[o].astype(np.int64)
        | u8[o + 1].astype(np.int64) << 8
        | u8[o + 2].astype(np.int64) << 16
        | u8[o + 3].astype(np.int64) << 24
    )


def gather_u64(u8: np.ndarray, off: np.ndarray) -> np.ndarray:
    """Little-endian u64 gather (int64 out — engine SSNs/tids are < 2^63)."""
    o = off.astype(np.int64, copy=False)
    acc = u8[o].astype(np.int64)
    for j in range(1, 8):
        acc |= u8[o + j].astype(np.int64) << (8 * j)
    return acc


def frame_scan(
    buf: bytes, skip_crc: bool = False
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Vectorized framing scan: offsets and payload lengths of every intact
    frame of ``buf``, truncated at the first torn or crc-corrupt frame —
    byte-identical boundaries to the scalar walk in
    :func:`decode_columnar_stream`, without per-record struct unpacking.

    The offset chase is run-speculative: consecutive records of one log
    buffer overwhelmingly share a framed length (fixed-size workloads
    produce exactly one run), so the scan guesses that frame ``i+1`` repeats
    frame ``i``'s length, verifies the whole run with one strided gather,
    and only falls back to stepping on a length change.  CRC validation is
    one C-speed ``zlib.crc32`` per frame over a zero-copy memoryview;
    ``skip_crc`` elides it entirely when the caller has already verified the
    blob wholesale against its seal-time segment crc (the manifest field a
    sealed segment carries — a whole-blob match implies every frame crc
    matches, since the frame crcs are part of the covered bytes).

    Returns ``(rec_off, plen, consumed)``: frame start offsets, payload
    lengths, and the byte offset of the first frame that did not decode.
    """
    u8 = np.frombuffer(buf, dtype=np.uint8)
    n = len(buf)
    hdr = _HDR.size
    parts: List[np.ndarray] = []
    off = 0
    while off + hdr <= n:
        (length,) = _U32.unpack_from(buf, off)
        stride = hdr + length
        if off + stride > n:
            break  # torn tail write
        max_run = (n - off) // stride
        if max_run <= 2:
            parts.append(np.asarray([off], dtype=np.int64))
            off += stride
            continue
        cand = off + np.arange(max_run, dtype=np.int64) * stride
        neq = gather_u32(u8, cand) != length
        run = int(np.argmax(neq)) if neq.any() else max_run
        parts.append(cand[:run])
        off += run * stride
    if not parts:
        return np.empty(0, np.int64), np.empty(0, np.int64), off
    rec_off = np.concatenate(parts)
    plen = gather_u32(u8, rec_off)
    if skip_crc:
        return rec_off, plen, off
    stored_crc = gather_u32(u8, rec_off + 4)
    mv = memoryview(buf)
    crc32 = zlib.crc32
    calc = np.fromiter(
        (
            crc32(mv[p : p + ln])
            for p, ln in zip((rec_off + hdr).tolist(), plen.tolist())
        ),
        np.int64,
        len(rec_off),
    )
    bad = np.flatnonzero(calc != stored_crc)
    if len(bad):
        good = int(bad[0])
        return rec_off[:good], plen[:good], int(rec_off[good])
    return rec_off, plen, off


def record_size(n_writes: int, key_bytes: int, val_bytes: int) -> int:
    """Size of a framed record for napkin math in benchmarks."""
    return _HDR.size + _PAYLOAD_FIXED.size + n_writes * (8 + key_bytes + val_bytes)
