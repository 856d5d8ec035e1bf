"""Dependency-DAG construction over a stage trace, with critical-path
extraction and per-stage/per-resource time attribution.

Nodes are the trace's spans (plus zero-duration virtual *xcommit* join
nodes, one per cross-shard gtid).  Edges encode the pipeline's real
ordering constraints, derived **only** from structural columns — record
order, SSN spans, cumulative byte counts — never from timestamps, so the
DAG of two identical stepped runs is byte-identical
(:meth:`TraceDAG.canonical_bytes`) even though the wall clocks differ:

* **intra-batch chain** — validate → sequence → encode → publish within one
  batch id;
* **exec-lane chain** — CPU-stage spans of one shard are serialized in
  record order (one executor/driver thread per shard; the GIL makes this
  near-exact on the 1-core bench box);
* **device FIFO** — flush spans of one ``(shard, device)`` in record order
  (a device has one head);
* **durability (Qww) edges** — a publish span depends on nothing, but the
  first flush span whose DSN interval covers the publish's SSN range
  depends on it (the record must be buffered before it can flush);
* **ship edges** — a ship span depends on the earliest flush span whose
  cumulative durable bytes reach the ship's cumulative consumed bytes,
  plus ship-FIFO order per device;
* **apply edges** — an apply span depends on every ship span since the
  shard's previous apply, plus the previous apply (the applier folds
  chunks in poll order);
* **durable-on-all (``FLAG_XSHARD``) joins** — per gtid, a virtual xcommit
  node depends on each participant's xprepare span *and* the flush span
  covering that participant's record SSN: the cross-shard commit point;
* **commit (Qwr / CSN) edges** — an ack-release span depends on, for every
  device lane, the first flush whose DSN reaches the acked SSN (the
  CSN = min-DSN join the scheduler's ack rule evaluates).

Critical path: walking back from the last-finishing span, always to the
predecessor that finished latest, partitions the trace's wall window
exactly into per-stage busy time plus ``wait`` (idle/untraced) — the
attribution therefore always sums to the makespan, and the per-stage
shares explain *which* stage bounds throughput (`benchmarks/fig_trace.py`
uses this on the noisy cross-shard cells).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .span import (
    CPU_STAGES,
    STAGE_NAMES,
    ST_ACK,
    ST_APPLY,
    ST_CUT,
    ST_DRIVER,
    ST_ENCODE,
    ST_FLUSH,
    ST_PUBLISH,
    ST_RDECODE,
    ST_RREPLAY,
    ST_SEQUENCE,
    ST_SHIP,
    ST_VALIDATE,
    ST_WRITEBACK,
    ST_XPREPARE,
    TraceDump,
)

# stage id of the virtual cross-shard commit join node
ST_XCOMMIT = -2

_PIPELINE = (ST_VALIDATE, ST_SEQUENCE, ST_ENCODE, ST_PUBLISH, ST_WRITEBACK)
_EXEC_LANE = frozenset(
    (ST_DRIVER, ST_VALIDATE, ST_SEQUENCE, ST_ENCODE, ST_PUBLISH,
     ST_XPREPARE, ST_CUT, ST_ACK, ST_RDECODE, ST_RREPLAY, ST_WRITEBACK)
)


def stage_name(s: int) -> str:
    return "xcommit" if s == ST_XCOMMIT else STAGE_NAMES[s]


@dataclass
class TraceDAG:
    """The dependency DAG over one trace dump.

    ``preds[i]`` lists the node indices ``i`` depends on.  Nodes
    ``[0, dump.n)`` are the trace rows; nodes past that are virtual
    xcommit joins whose structural identity lives in ``virtual`` as
    ``(gtid, sorted participant shard list)``.
    """

    dump: TraceDump
    preds: List[List[int]]
    virtual: List[Tuple[int, Tuple[int, ...]]] = field(default_factory=list)

    @property
    def n_nodes(self) -> int:
        return self.dump.n + len(self.virtual)

    def node_stage(self, i: int) -> int:
        return int(self.dump.stage[i]) if i < self.dump.n else ST_XCOMMIT

    def node_duration(self, i: int) -> float:
        if i >= self.dump.n:
            return 0.0
        return float(self.dump.t1[i] - self.dump.t0[i])

    def node_times(self) -> Tuple[np.ndarray, np.ndarray]:
        """(t0, t1) per node; virtual joins inherit max predecessor t1."""
        n = self.dump.n
        t0 = np.zeros(self.n_nodes)
        t1 = np.zeros(self.n_nodes)
        t0[:n] = self.dump.t0
        t1[:n] = self.dump.t1
        for v in range(n, self.n_nodes):
            hi = max((t1[p] for p in self.preds[v]), default=0.0)
            t0[v] = t1[v] = hi
        return t0, t1

    # --- determinism ---------------------------------------------------------
    def structural_dict(self) -> Dict:
        d = self.dump.structural_dict()
        d["edges"] = sorted(
            (p, i) for i, ps in enumerate(self.preds) for p in ps
        )
        d["virtual"] = [[g, list(parts)] for g, parts in self.virtual]
        return d

    def canonical_bytes(self) -> bytes:
        """Timestamp-free canonical serialization: two identical stepped
        runs produce byte-identical output (the determinism contract)."""
        return json.dumps(
            self.structural_dict(), sort_keys=True, separators=(",", ":")
        ).encode()

    def fingerprint(self) -> str:
        return hashlib.sha256(self.canonical_bytes()).hexdigest()

    # --- attribution ---------------------------------------------------------
    def stage_totals(self) -> Dict[str, float]:
        """Total busy seconds per stage (not path-restricted)."""
        out: Dict[str, float] = {}
        dur = self.dump.duration()
        for s in np.unique(self.dump.stage).tolist():
            out[stage_name(int(s))] = float(dur[self.dump.stage == s].sum())
        return out

    def resource_busy(self) -> Dict[str, float]:
        """Busy seconds per resource: one ``cpu`` pool (all CPU stages) and
        one ``dev<shard>.<device>`` per flush lane — the utilization view
        that says which side of the IO roof a run sits on."""
        d = self.dump
        dur = d.duration()
        cpu_mask = np.isin(d.stage, list(CPU_STAGES))
        out = {"cpu": float(dur[cpu_mask].sum())}
        fl = np.flatnonzero(d.stage == ST_FLUSH)
        for i in fl.tolist():
            key = f"dev{d.shard[i]}.{d.device[i]}"
            out[key] = out.get(key, 0.0) + float(dur[i])
        return out


def _chain(preds: List[List[int]], idxs: Sequence[int]) -> None:
    for a, b in zip(idxs, idxs[1:]):
        preds[b].append(a)


def build_dag(dump: TraceDump) -> TraceDAG:
    """Build the dependency DAG from a trace dump (see module docstring for
    the edge semantics)."""
    n = dump.n
    preds: List[List[int]] = [[] for _ in range(n)]
    st = dump.stage

    # intra-batch pipeline chains
    by_batch: Dict[int, List[int]] = {}
    for i in np.flatnonzero(np.isin(st, _PIPELINE)).tolist():
        b = int(dump.batch[i])
        if b >= 0:
            by_batch.setdefault(b, []).append(i)
    for idxs in by_batch.values():
        _chain(preds, idxs)

    # exec-lane serialization per shard (record order)
    lanes: Dict[int, List[int]] = {}
    for i in np.flatnonzero(np.isin(st, list(_EXEC_LANE))).tolist():
        lanes.setdefault(int(dump.shard[i]), []).append(i)
    for idxs in lanes.values():
        _chain(preds, idxs)

    # flush FIFO per (shard, device) + publish -> covering flush
    flush_lanes: Dict[Tuple[int, int], List[int]] = {}
    for i in np.flatnonzero(st == ST_FLUSH).tolist():
        flush_lanes.setdefault(
            (int(dump.shard[i]), int(dump.device[i])), []
        ).append(i)
    for idxs in flush_lanes.values():
        _chain(preds, idxs)

    for i in np.flatnonzero(
        (st == ST_PUBLISH) & (dump.device >= 0) & (dump.nbytes > 0)
    ).tolist():
        lane = flush_lanes.get((int(dump.shard[i]), int(dump.device[i])))
        if not lane:
            continue
        need = int(dump.txn_hi[i])
        for f in lane:
            if f > i and int(dump.txn_hi[f]) >= need:
                preds[f].append(i)
                break

    # flush -> ship (cumulative bytes) + ship FIFO
    ship_lanes: Dict[Tuple[int, int], List[int]] = {}
    for i in np.flatnonzero(st == ST_SHIP).tolist():
        ship_lanes.setdefault(
            (int(dump.shard[i]), int(dump.device[i])), []
        ).append(i)
    for key, idxs in ship_lanes.items():
        _chain(preds, idxs)
        flane = flush_lanes.get(key, [])
        fcum = np.cumsum([int(dump.nbytes[f]) for f in flane])
        scum = 0
        fj = 0
        for i in idxs:
            scum += int(dump.nbytes[i])
            while fj < len(flane) and fcum[fj] < scum:
                fj += 1
            if fj < len(flane):
                preds[i].append(flane[fj])

    # ship* -> apply (per shard, since the previous apply) + apply chain
    apply_by_shard: Dict[int, List[int]] = {}
    for i in np.flatnonzero(st == ST_APPLY).tolist():
        apply_by_shard.setdefault(int(dump.shard[i]), []).append(i)
    for shard, applies in apply_by_shard.items():
        _chain(preds, applies)
        ships = sorted(
            i for (sh, _), idxs in ship_lanes.items() if sh == shard
            for i in idxs
        )
        lo = 0
        for a in applies:
            for s in ships[lo:]:
                if s > a:
                    break
                preds[a].append(s)
                lo += 1

    # ack <- commit (CSN) joins: first flush on every lane reaching the SSN
    for i in np.flatnonzero((st == ST_ACK) & (dump.txn_hi >= 0)).tolist():
        need = int(dump.txn_hi[i])
        for lane in flush_lanes.values():
            for f in lane:
                if int(dump.txn_hi[f]) >= need:
                    if f != i:
                        preds[i].append(f)
                    break

    # durable-on-all joins: one virtual xcommit node per gtid
    virtual: List[Tuple[int, Tuple[int, ...]]] = []
    xprep: Dict[int, List[int]] = {}
    for i in np.flatnonzero(st == ST_XPREPARE).tolist():
        xprep.setdefault(int(dump.batch[i]), []).append(i)
    for gtid in sorted(xprep):
        members = xprep[gtid]
        vp: List[int] = list(members)
        for m in members:
            lane = flush_lanes.get((int(dump.shard[m]), int(dump.device[m])))
            if lane:
                need = int(dump.txn_hi[m])
                for f in lane:
                    if int(dump.txn_hi[f]) >= need:
                        vp.append(f)
                        break
        preds.append(sorted(set(vp)))
        virtual.append(
            (gtid, tuple(sorted(int(dump.shard[m]) for m in members)))
        )

    return TraceDAG(dump=dump, preds=preds, virtual=virtual)


def critical_path(
    dag: TraceDAG, end: Optional[int] = None
) -> Tuple[List[int], Dict[str, float]]:
    """Extract the critical path and its exact time attribution.

    Walks back from ``end`` (default: the last-finishing real span), at each
    node to the predecessor that finished latest.  The wall window
    ``[trace start, end]`` is partitioned exactly: every slice is attributed
    either to a stage on the path or to ``wait`` (idle / untraced time), so
    ``sum(attribution.values()) == t_end - trace_t0`` by construction.

    Returns ``(path node indices, {stage or 'wait': seconds})``.
    """
    d = dag.dump
    if d.n == 0:
        return [], {}
    t0, t1 = dag.node_times()
    if end is None:
        end = int(np.argmax(t1[: d.n]))
    t_min = float(d.t0.min())

    path: List[int] = []
    attr: Dict[str, float] = {}
    cursor = float(t1[end])
    v: Optional[int] = end
    seen = set()
    while v is not None and v not in seen:
        seen.add(v)
        path.append(v)
        seg_lo = float(t0[v])
        seg_hi = min(float(t1[v]), cursor)
        if seg_hi > seg_lo:
            key = stage_name(dag.node_stage(v))
            attr[key] = attr.get(key, 0.0) + (seg_hi - seg_lo)
        cursor = min(cursor, seg_lo)
        ps = dag.preds[v]
        if not ps:
            break
        p = max(ps, key=lambda q: (t1[q], q))
        gap = cursor - float(t1[p])
        if gap > 0:
            attr["wait"] = attr.get("wait", 0.0) + gap
            cursor = float(t1[p])
        v = p
    head = cursor - t_min
    if head > 0:
        attr["wait"] = attr.get("wait", 0.0) + head
    path.reverse()
    return path, attr
