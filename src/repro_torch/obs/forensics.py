"""Post-crash forensics: a per-gtid verdict on what recovery kept and why.

``explain_recovery`` (and its sharded twin) re-decodes the surviving device
logs with the *same* machinery ``recover()`` uses — ``decode_columnar_stream``
for torn-tail framing, ``compute_rsne`` with truncation floors, and for the
sharded case the consistent-cut resolver from `repro_torch.shard.recovery` — and
renders, for every gtid it can see, **kept or dropped plus the §5 rule that
decided it**:

* ``replayed``                          — durable and committed (write-only,
  or ``ssn <= RSNe``);
* ``above-rsne``                        — durable but RAW-carrying with
  ``ssn > RSNe``: provably unacknowledged, dropped;
* ``not-durable-on-all-participants``   — cross-shard record missing on at
  least one participant, dropped by the consistent cut;
* ``below-truncation-floor``            — dropped from the retained log, but
  every missing/failing copy sits at or below its shard's checkpoint RSN or
  truncation floor: the checkpoint image already carries its effects;
* ``torn-tail``                         — a partially flushed frame past the
  last decodable record (gtid recovered best-effort from the torn bytes);
* ``command-dep-unreplayable``          — a command-framed record (adaptive
  logging) whose observed pre-image SSN is neither in the retained log nor
  covered by the checkpoint image: ``recover()`` refuses to re-execute it
  (``CommandReplayError``) rather than guess a value.  A sound pipeline —
  adaptive policy framing plus the truncators' command-dep pin — never
  produces this verdict; seeing it means the log and checkpoint were
  manipulated out of band.

Because the verdicts come from the same cut, ``verify_bytes(state)`` can
replay *only* the kept gtids over the checkpoint image and demand byte
equality with what ``recover()``/``recover_sharded()`` actually produced —
the acceptance check the crash tests enforce.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.checkpoint import load_latest_checkpoint
from ..core.recovery import compute_rsne, device_ssn_floors, replay_columnar
from ..core.txn import ColumnarLog, decode_columnar_stream
from ..shard.recovery import _collect_cut_columnar, resolve_cut

RULE_REPLAYED = "replayed"
RULE_ABOVE_RSNE = "above-rsne"
RULE_NOT_DURABLE = "not-durable-on-all-participants"
RULE_BELOW_FLOOR = "below-truncation-floor"
RULE_TORN_TAIL = "torn-tail"
RULE_CMD_DEP = "command-dep-unreplayable"

# a torn tail needs the 8-byte frame header plus the leading (ssn, tid)
# qwords of the payload for a best-effort gtid parse
_TORN_MIN = 8 + 16
_NO_RSNE = int(np.iinfo(np.int64).max) // 2   # bypass the §5 guard in verify


@dataclass
class GtidVerdict:
    """One transaction's fate through recovery."""

    gtid: int
    kept: bool
    rule: str
    ssn: Dict[int, int]          # per-shard SSN ({0: ssn} for single-engine)
    has_reads: bool = False
    detail: str = ""

    def to_dict(self) -> Dict:
        return {
            "gtid": self.gtid, "kept": self.kept, "rule": self.rule,
            "ssn": {str(k): v for k, v in self.ssn.items()},
            "has_reads": self.has_reads, "detail": self.detail,
        }


@dataclass
class RecoveryExplanation:
    """All verdicts plus the watermarks they were judged against."""

    verdicts: Dict[int, GtidVerdict] = field(default_factory=dict)
    rsne: List[int] = field(default_factory=list)      # per shard
    rsns: List[int] = field(default_factory=list)      # per-shard ckpt RSN
    n_shards: int = 1
    torn: List[Dict] = field(default_factory=list)     # torn-tail sightings
    flight: Optional[Dict] = None                      # crash-context summary
    # decode products, retained so verify_bytes can replay the verdicts
    _shard_logs: List[List[ColumnarLog]] = field(
        default_factory=list, repr=False)
    _ckpt_data: List[Optional[Dict]] = field(default_factory=list, repr=False)

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for v in self.verdicts.values():
            out[v.rule] = out.get(v.rule, 0) + 1
        return out

    def to_dict(self) -> Dict:
        return {
            "n_shards": self.n_shards,
            "rsne": list(self.rsne),
            "rsns": list(self.rsns),
            "counts": self.counts(),
            "torn": list(self.torn),
            "flight": self.flight,
            "verdicts": [
                self.verdicts[g].to_dict() for g in sorted(self.verdicts)
            ],
        }

    def render(self) -> str:
        """Human-readable account, one line per gtid."""
        lines = [
            f"recovery forensics: {self.n_shards} shard(s), "
            f"RSNe={self.rsne}, checkpoint RSNs={self.rsns}"
        ]
        if self.flight:
            lines.append(
                f"crash context: {self.flight.get('reason', '?')} "
                f"(pid {self.flight.get('pid', '?')}, "
                f"t_unix {self.flight.get('t_unix', '?')})"
            )
        for g in sorted(self.verdicts):
            v = self.verdicts[g]
            fate = "KEPT " if v.kept else "DROP "
            ssn = ",".join(f"{q}:{s}" for q, s in sorted(v.ssn.items()))
            tail = f" — {v.detail}" if v.detail else ""
            lines.append(
                f"  gtid {g:>8}  {fate} {v.rule:<34} "
                f"ssn[{ssn}]{' R' if v.has_reads else '  '}{tail}"
            )
        kept = sum(1 for v in self.verdicts.values() if v.kept)
        by_rule = " ".join(
            f"{k}={n}" for k, n in sorted(self.counts().items()))
        lines.append(
            f"kept {kept}/{len(self.verdicts)} gtids ({by_rule})")
        return "\n".join(lines)

    # --- byte agreement with the recovery being explained ------------------
    def verify_bytes(self, state) -> Tuple[bool, List]:
        """Replay *only* the verdict-kept gtids over the checkpoint image and
        compare byte-for-byte with what recovery produced.  ``state`` is the
        :class:`~repro_torch.core.recovery.RecoveredState` (single shard) or
        :class:`~repro_torch.shard.recovery.ShardedRecoveredState`.

        Returns ``(agrees, mismatched_keys)``.
        """
        shard_states = state.shards if hasattr(state, "shards") else [state]
        assert len(shard_states) == len(self._shard_logs)
        bad: List = []
        for p, logs in enumerate(self._shard_logs):
            masks = [
                np.fromiter(
                    (self.verdicts[int(t)].kept for t in log.tid.tolist()),
                    dtype=bool, count=log.n_records,
                )
                for log in logs
            ]
            data, _, _ = replay_columnar(
                logs, _NO_RSNE, base=self._ckpt_data[p], record_mask=masks,
            )
            got = shard_states[p].data
            for k in set(data) | set(got):
                if data.get(k) != got.get(k):
                    bad.append((p, k, data.get(k), got.get(k)))
        return (not bad), bad


# --- decode helpers -----------------------------------------------------------

def _decode_device(d) -> Tuple[ColumnarLog, bytes]:
    """One device's surviving log + any torn-tail bytes past the last whole
    frame (segment-chained devices decode per sealed blob, like recovery)."""
    blobs = (
        d.read_segment_blobs() if hasattr(d, "read_segment_blobs")
        else [d.read_all()]
    )
    parts: List[ColumnarLog] = []
    torn = b""
    for blob in blobs:
        log, used = decode_columnar_stream(blob)
        parts.append(log)
        if used < len(blob):
            torn = blob[used:]
            break
    return parts[0] if len(parts) == 1 else ColumnarLog.concat(parts), torn


def _torn_fields(torn: bytes) -> Optional[Tuple[int, int]]:
    """Best-effort ``(ssn, gtid)`` from a torn frame (needs the header and
    the first 16 payload bytes to have hit the device)."""
    if len(torn) < _TORN_MIN:
        return None
    ssn, tid = struct.unpack_from("<QQ", torn, 8)
    return int(ssn), int(tid)


def _load_flight(flight) -> Optional[Dict]:
    if flight is None:
        return None
    if isinstance(flight, str):
        from .flight import load_flight
        flight = load_flight(flight)
    return {k: flight.get(k) for k in ("reason", "pid", "t_unix")}


def _ckpt(checkpoint_dir: Optional[str]) -> Tuple[Optional[Dict], int]:
    if checkpoint_dir is None:
        return None, 0
    ck = load_latest_checkpoint(checkpoint_dir, parallel=False)
    if ck is None:
        return None, 0
    return dict(ck.data), ck.rsn


def _local_verdict(
    shard: int, ssn: int, gtid: int, has_reads: bool, rsne: int, rsns: int,
) -> GtidVerdict:
    """The single-edge §5 rule: write-only replays whenever durable;
    RAW-carrying only with ``ssn <= RSNe``."""
    kept = (not has_reads) or ssn <= rsne
    if kept:
        rule, detail = RULE_REPLAYED, (
            "write-only: durable ⇒ committed" if not has_reads
            else f"ssn {ssn} <= RSNe {rsne}"
        )
    elif ssn <= rsns:
        rule = RULE_BELOW_FLOOR
        detail = (
            f"dropped from the log (ssn {ssn} > RSNe {rsne}) but the "
            f"checkpoint (RSNs {rsns}) already carries its effects"
        )
    else:
        rule = RULE_ABOVE_RSNE
        detail = f"has_reads and ssn {ssn} > RSNe {rsne}: never acknowledged"
    return GtidVerdict(gtid, kept, rule, {shard: ssn}, has_reads, detail)


def _command_dep_verdicts(
    ex: RecoveryExplanation,
    logs: Sequence[ColumnarLog],
    rsns: int,
    has_ckpt: bool,
) -> None:
    """Downgrade kept command records whose pre-image recovery cannot
    reach: a dep is replayable iff the checkpoint image covers it
    (``dep <= RSNs``, full-image checkpoints) or the dep's write is itself a
    kept record in the retained logs.  Anything else would make
    ``recover()`` raise ``CommandReplayError`` — surfaced here as the
    ``command-dep-unreplayable`` verdict."""
    if not any(log.n_command for log in logs):
        return
    # fixpoint: dropping one command strands any later command chained on
    # its write, so re-scan until no verdict flips (chains are short)
    changed = True
    while changed:
        changed = False
        written = set()
        for log in logs:
            if not len(log.wr_rec):
                continue
            kept = np.fromiter(
                (ex.verdicts[int(t)].kept for t in log.tid.tolist()),
                dtype=bool, count=log.n_records,
            )
            for j in np.flatnonzero(kept[log.wr_rec]).tolist():
                written.add((log.keys[j], int(log.wr_ssn[j])))
        for log in logs:
            if not log.n_command:
                continue
            for i, r in enumerate(log.cmd_rec.tolist()):
                v = ex.verdicts.get(int(log.tid[r]))
                if v is None or not v.kept:
                    continue
                lo, hi = (
                    int(log.cmd_dep_start[i]), int(log.cmd_dep_start[i + 1])
                )
                for dk, ds in zip(
                    log.cmd_dep_key[lo:hi], log.cmd_dep_ssn[lo:hi].tolist()
                ):
                    if (has_ckpt and ds <= rsns) or (dk, ds) in written:
                        continue
                    v.kept = False
                    v.rule = RULE_CMD_DEP
                    v.detail = (
                        f"command dep (key {dk!r}, ssn {ds}) is neither in "
                        f"the retained log nor covered by the checkpoint "
                        f"image (RSNs {rsns}): recovery refuses to re-execute"
                    )
                    changed = True
                    break


def _add_torn(ex: RecoveryExplanation, shard: int, dev: int, torn: bytes):
    if not torn:
        return
    row: Dict = {"shard": shard, "device": dev, "bytes": len(torn)}
    fields = _torn_fields(torn)
    if fields is not None:
        ssn, gtid = fields
        row["gtid"] = gtid
        ex.verdicts[gtid] = GtidVerdict(
            gtid, False, RULE_TORN_TAIL, {shard: ssn},
            detail=f"partial frame ({len(torn)} bytes) on device {dev}: "
                   "flush interrupted mid-record, never acknowledged",
        )
    ex.torn.append(row)


# --- entry points -------------------------------------------------------------

def explain_recovery(
    devices: Sequence,
    checkpoint_dir: Optional[str] = None,
    flight=None,
) -> RecoveryExplanation:
    """Per-gtid verdicts for a single-engine recovery over ``devices``.

    ``flight`` is an optional ``*.flight.json`` path (or loaded dict) whose
    crash context is folded into the rendering.
    """
    decoded = [_decode_device(d) for d in devices]
    logs = [log for log, _ in decoded]
    rsne = compute_rsne(logs, floors=device_ssn_floors(devices))
    ckpt_data, rsns = _ckpt(checkpoint_dir)

    ex = RecoveryExplanation(
        rsne=[rsne], rsns=[rsns], n_shards=1,
        flight=_load_flight(flight),
        _shard_logs=[logs], _ckpt_data=[ckpt_data],
    )
    for log in logs:
        for g, s, hr in zip(
            log.tid.tolist(), log.ssn.tolist(), log.has_reads.tolist()
        ):
            ex.verdicts[int(g)] = _local_verdict(
                0, int(s), int(g), bool(hr), rsne, rsns)
    _command_dep_verdicts(ex, logs, rsns, has_ckpt=ckpt_data is not None)
    for dev, (_, torn) in enumerate(decoded):
        _add_torn(ex, 0, dev, torn)
    return ex


def explain_recovery_sharded(
    shard_devices: Sequence[Sequence],
    checkpoint_dirs: Optional[Sequence[Optional[str]]] = None,
    flight=None,
) -> RecoveryExplanation:
    """Per-gtid verdicts for a sharded recovery, cross-shard records judged
    by the same consistent cut ``recover_sharded`` resolves."""
    n = len(shard_devices)
    decoded = [[_decode_device(d) for d in devs] for devs in shard_devices]
    shard_logs = [[log for log, _ in row] for row in decoded]
    rsne = [
        compute_rsne(logs, floors=device_ssn_floors(shard_devices[p]))
        for p, logs in enumerate(shard_logs)
    ]
    ckpt = [
        _ckpt(checkpoint_dirs[p] if checkpoint_dirs is not None else None)
        for p in range(n)
    ]
    rsns = [r for _, r in ckpt]
    # a fully truncated device also floors what "durable" can mean locally
    floor = [
        max([rsns[p]] + device_ssn_floors(shard_devices[p]))
        for p in range(n)
    ]

    durable, info = _collect_cut_columnar(shard_logs)
    keep = resolve_cut(durable, info, rsne)

    ex = RecoveryExplanation(
        rsne=rsne, rsns=rsns, n_shards=n,
        flight=_load_flight(flight),
        _shard_logs=shard_logs, _ckpt_data=[d for d, _ in ckpt],
    )

    # shard-local records: the single-edge rule
    for p, logs in enumerate(shard_logs):
        for log in logs:
            xset = (
                set(log.x_rec.tolist()) if log.x_rec is not None else set()
            )
            for i, (g, s, hr) in enumerate(zip(
                log.tid.tolist(), log.ssn.tolist(), log.has_reads.tolist()
            )):
                if i in xset:
                    continue
                ex.verdicts[int(g)] = _local_verdict(
                    p, int(s), int(g), bool(hr), rsne[p], rsns[p])

    # cross-shard records: the consistent cut's decision, explained
    for g, (parts, hr) in info.items():
        ssn_map = {int(q): int(s) for q, s in parts}
        kept = keep[g]
        if kept:
            rule = RULE_REPLAYED
            detail = (
                f"durable on all {len(parts)} participants"
                + ("" if not hr else " and ssn <= RSNe on every edge")
            )
        else:
            missing = [q for q, _ in parts if q not in durable.get(g, ())]
            if missing:
                if all(ssn_map[q] <= floor[q] for q in missing):
                    rule = RULE_BELOW_FLOOR
                    detail = (
                        f"missing on shard(s) {missing} but at/below their "
                        "truncation floors: the checkpoint carries it there"
                    )
                else:
                    rule = RULE_NOT_DURABLE
                    detail = (
                        f"no durable record on shard(s) {missing}: the "
                        "global commit never completed"
                    )
            else:
                failing = [
                    q for q, s in ssn_map.items() if s > rsne[q]]
                rule = RULE_ABOVE_RSNE
                detail = (
                    f"has_reads and ssn > RSNe on shard(s) {failing}: "
                    "never acknowledged"
                )
        ex.verdicts[int(g)] = GtidVerdict(
            int(g), kept, rule, ssn_map, bool(hr), detail)

    # command deps are shard-local (the policy value-frames x-records), so
    # each shard's coverage check sees only its own logs and checkpoint
    for p, logs in enumerate(shard_logs):
        _command_dep_verdicts(
            ex, logs, rsns[p], has_ckpt=ckpt[p][0] is not None
        )

    for p, row in enumerate(decoded):
        for dev, (_, torn) in enumerate(row):
            _add_torn(ex, p, dev, torn)
    return ex
