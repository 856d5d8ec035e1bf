"""Vectorized sealed-segment tile decode — the feed of the compiled replay.

``decode_columnar_stream`` walks frames one ``struct.unpack`` at a time and
dominates recovery wall time (the replay reduction is an order of magnitude
cheaper than the decode that feeds it).  This module decodes a segment blob
almost entirely with array ops:

* frame boundaries + crc truncation come from :func:`repro.core.txn.frame_scan`
  (run-speculative strided scan, one C-speed crc per frame);
* fixed payload fields (ssn/tid/flags/n_writes) are unaligned byte-plane
  gathers;
* per-write (klen, key, vlen, val) chains resolve in ``max(n_writes)``
  vectorized rounds — one round per write ordinal, each advancing every
  record's write cursor at once — with the same bounds checks (and the same
  tolerance quirks) as the scalar walk, so truncation at a malformed frame
  is byte-identical;
* key identities build straight into the fixed-width ``keys_fixed`` matrix
  (one 2-D byte gather), and **values stay lazy**: a :class:`FastTile`
  records ``(offset, length)`` per write and materializes bytes only for
  the lanes replay actually wins — the value-gather half of the fused
  replay kernel.

Tiles with exotic shapes (XSHARD footers, pathological write counts) return
``None`` and the caller falls back to the scalar-equivalent columnar decode;
the fast path is an optimization, never a semantics fork.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .txn import (
    _HDR,
    _PAYLOAD_FIXED,
    FLAG_COMMAND,
    FLAG_HAS_READS,
    FLAG_XSHARD,
    frame_scan,
    gather_u32,
    gather_u64,
)

# a frame advertising more writes than this falls back to the scalar walk
# (the engine never frames anywhere near it; this bounds the round loop)
MAX_FAST_WRITES = 64


@dataclass
class FastTile:
    """One decoded segment blob in replay-ready form.

    Same per-record/per-write columns replay consumes from a
    :class:`~repro.core.txn.ColumnarLog`, minus materialized key/value
    bytes: ``keys_fixed`` carries exact key identity, and values resolve on
    demand from ``(val_off, val_len)`` into the source blob.
    """

    buf: bytes
    ssn: np.ndarray          # (n_records,) int64
    has_reads: np.ndarray    # (n_records,) bool
    wr_rec: np.ndarray       # (n_writes,) int64 owning record index
    keys_fixed: np.ndarray   # (n_writes,) 'S' fixed-width key identity
    val_off: np.ndarray      # (n_writes,) int64 byte offset into buf
    val_len: np.ndarray      # (n_writes,) int64
    consumed: int            # first undecodable byte offset (torn/corrupt)

    @property
    def n_records(self) -> int:
        return len(self.ssn)

    @property
    def last_ssn(self) -> int:
        return int(self.ssn[-1]) if len(self.ssn) else 0

    @property
    def wr_ssn(self) -> np.ndarray:
        return self.ssn[self.wr_rec]

    def committed_mask(self, rsne: int) -> np.ndarray:
        """Per-record §5 commit guard (Qww always, Qwr iff ssn ≤ RSNe)."""
        return ~self.has_reads | (self.ssn <= rsne)

    def values_for(self, idx: np.ndarray) -> List[bytes]:
        """Materialize the value payloads of the given write lanes."""
        buf = self.buf
        return [
            buf[o : o + ln]
            for o, ln in zip(self.val_off[idx].tolist(), self.val_len[idx].tolist())
        ]


def _keys_fixed_from_buf(
    u8: np.ndarray, koff: np.ndarray, klen: np.ndarray
) -> np.ndarray:
    """Build the sentinel-terminated fixed-width key matrix straight from
    the blob bytes (matches ``ColumnarLog.encode_keys_fixed``: key +
    ``\\x01`` terminator, NUL-padded to a multiple of 8)."""
    w = len(koff)
    if w == 0:
        return np.empty(0, dtype="S8")
    width = -(-(int(klen.max()) + 1) // 8) * 8
    # one (W, width) gather, clipped to stay in-bounds; lanes past each key's
    # true length are zeroed, then the terminator lands per lane
    idx = koff[:, None] + np.arange(width, dtype=np.int64)[None, :]
    mat = u8[np.minimum(idx, len(u8) - 1)]
    mat[np.arange(width)[None, :] >= klen[:, None]] = 0
    mat[np.arange(w), klen] = 1
    return np.ascontiguousarray(mat).view(f"S{width}").reshape(w)


def decode_fast_tile(buf: bytes, crc: Optional[int] = None) -> Optional[FastTile]:
    """Vectorized twin of :func:`~repro.core.txn.decode_columnar_stream` for
    the replay pipeline; ``None`` when the blob needs the scalar-equivalent
    walk (XSHARD footers / out-of-profile write counts).

    ``crc`` is the blob's seal-time segment crc32 when the caller has one
    (sealed segments via ``StorageDevice.read_segment_entries``): a single
    whole-blob ``zlib.crc32`` match covers every frame crc inside, so the
    per-frame verification loop is skipped; a mismatch — or no crc, e.g.
    the torn-able tail — keeps the frame-by-frame truncation semantics.
    """
    trusted = crc is not None and zlib.crc32(buf) == crc
    rec_off, plen, consumed = frame_scan(buf, skip_crc=trusted)
    n = len(rec_off)
    u8 = np.frombuffer(buf, dtype=np.uint8)
    if n == 0:
        return FastTile(
            buf=buf,
            ssn=np.empty(0, np.int64),
            has_reads=np.empty(0, bool),
            wr_rec=np.empty(0, np.int64),
            keys_fixed=np.empty(0, dtype="S8"),
            val_off=np.empty(0, np.int64),
            val_len=np.empty(0, np.int64),
            consumed=consumed,
        )

    pay = rec_off + _HDR.size
    ssn = gather_u64(u8, pay)
    flags = u8[pay + 16].astype(np.int64)      # after u64 ssn + u64 tid
    nw = gather_u32(u8, pay + 17)
    if (
        (flags & FLAG_XSHARD).any()
        or (flags & FLAG_COMMAND).any()
        or (nw > MAX_FAST_WRITES).any()
    ):
        return None

    end = pay + plen                 # payload end per record
    total = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(nw, out=total[1:])
    n_writes = int(total[-1])
    wr_rec = np.empty(n_writes, np.int64)
    koff = np.empty(n_writes, np.int64)
    klen = np.empty(n_writes, np.int64)
    voff = np.empty(n_writes, np.int64)
    vlen = np.empty(n_writes, np.int64)

    # resolve the variable-length write chains: round j advances the cursor
    # of every record that still owes a j-th write.  Bounds checks mirror the
    # scalar walk exactly (checked before each u32 length read; key/value
    # slices clip at the payload end), so the first malformed record — and
    # everything after it, like the scalar truncation — is dropped.
    cursor = pay + _PAYLOAD_FIXED.size
    good = n
    safe = len(u8) - 4 if len(u8) >= 4 else 0
    for j in range(int(nw.max()) if n else 0):
        act = np.flatnonzero(nw > j)
        if not len(act):
            break
        cur = cursor[act]
        rec_end = end[act]
        ok = cur + 4 <= rec_end
        kl = gather_u32(u8, np.minimum(cur, safe))
        ko = cur + 4
        cur2 = ko + kl
        ok &= cur2 + 4 <= rec_end
        vl = gather_u32(u8, np.minimum(cur2, safe))
        vo = cur2 + 4
        bad = np.flatnonzero(~ok)
        if len(bad):
            good = min(good, int(act[bad[0]]))
        slot = total[act] + j
        wr_rec[slot] = act
        koff[slot] = ko
        klen[slot] = np.minimum(kl, np.maximum(rec_end - ko, 0))
        voff[slot] = vo
        vlen[slot] = np.minimum(vl, np.maximum(rec_end - vo, 0))
        cursor[act] = vo + vl

    if good < n:
        consumed = int(rec_off[good])
        n = good
        ssn = ssn[:n]
        flags = flags[:n]
        w_keep = int(total[n])
        wr_rec = wr_rec[:w_keep]
        koff, klen = koff[:w_keep], klen[:w_keep]
        voff, vlen = voff[:w_keep], vlen[:w_keep]

    return FastTile(
        buf=buf,
        ssn=ssn,
        has_reads=(flags & FLAG_HAS_READS) != 0,
        wr_rec=wr_rec,
        keys_fixed=_keys_fixed_from_buf(u8, koff, klen),
        val_off=voff,
        val_len=vlen,
        consumed=consumed,
    )
