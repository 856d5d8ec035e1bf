"""Discrete-event replay simulation over the trace DAG.

Two entry points:

* :func:`simulate_dag` replays a *recorded* DAG — every span keeps its
  measured duration, but execution order is re-derived by a greedy list
  scheduler over explicit resources (a CPU pool for the GIL-serialized
  stages, one server per ``(shard, device)`` flush lane).  On the same
  config it reproduces the measured makespan (the fidelity contract in
  ``tests/test_trace_sim.py``); with a different resource multiplicity or
  scaled durations it answers "what if".

* :func:`simulate` builds a *synthetic* DAG for a hypothetical
  :class:`SimConfig` — shards × devices × batch size × device bandwidth ×
  cross-shard ratio — using per-stage costs from a :class:`CostModel`
  fitted on real traces, and predicts txn/s plus p50/p99 commit latency
  without running the engine.  This is what `repro_torch.trace.tune.autotune`
  sweeps and what ``benchmarks/fig_trace.py`` gates against measurement.

Known non-modeled effects (documented, not bugs): GIL hand-off churn
between logger/shard threads, allocator noise, and lock convoy on the
table mutex — the model treats CPU stages as one FIFO pool, which is why
predictions are gated at 25% drift rather than treated as exact.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .dag import TraceDAG, stage_name
from .span import (
    CPU_STAGES,
    ST_DRIVER,
    ST_ENCODE,
    ST_FLUSH,
    ST_PUBLISH,
    ST_SEQUENCE,
    ST_VALIDATE,
    ST_WRITEBACK,
    ST_XPREPARE,
    TraceDump,
)

_MIN_COST = 1e-9


# --- cost model --------------------------------------------------------------
@dataclass
class CostModel:
    """Per-stage linear time models fitted from a trace.

    Stage cost is ``t = a + b * n_txn + c * nbytes`` (all coefficients
    clamped non-negative, intercept re-centred so the mean is preserved);
    the flush stage instead fits the device model ``t = lat + nbytes / bw``
    so simulated configs can swap the bandwidth term out.
    """

    coef: Dict[int, Tuple[float, float, float]] = field(default_factory=dict)
    dev_lat: float = 0.0
    dev_bw: float = 1.2e9
    # untraced per-txn residual (GIL churn, allocator, routing) measured as
    # the gap between a traced run's wall clock and its own replay — see
    # `calibrate_pad`; charged on the driver lane by `simulate`
    pad_per_txn: float = 0.0

    @classmethod
    def fit(cls, dump: TraceDump) -> "CostModel":
        m = cls()
        dur = dump.duration()
        for s in np.unique(dump.stage).tolist():
            s = int(s)
            sel = dump.stage == s
            y = dur[sel]
            n = dump.n_txn[sel].astype(np.float64)
            b = dump.nbytes[sel].astype(np.float64)
            if s == ST_FLUSH:
                lat, inv_bw = _fit_nonneg(np.c_[np.ones_like(b), b], y)
                m.dev_lat = lat
                if inv_bw > 0:
                    m.dev_bw = 1.0 / inv_bw
                continue
            a, bn, cb = _fit_nonneg(np.c_[np.ones_like(n), n, b], y)
            m.coef[s] = (a, bn, cb)
        return m

    def stage_cost(self, stage: int, n_txn: int, nbytes: int) -> float:
        a, bn, cb = self.coef.get(stage, (0.0, 0.0, 0.0))
        return max(_MIN_COST, a + bn * n_txn + cb * nbytes)

    def flush_cost(self, nbytes: int, bw: Optional[float] = None) -> float:
        return max(
            _MIN_COST, self.dev_lat + nbytes / max(bw or self.dev_bw, 1.0)
        )

    def calibrate_pad(
        self,
        measured_txn_s: float,
        cfg: "SimConfig",
        profile: Optional["WorkloadProfile"] = None,
    ) -> float:
        """Fit ``pad_per_txn`` so the simulated per-txn time on the
        calibration config matches the measured one.  The residual is real
        work the hooks don't cover (spec routing, numpy temporaries, GIL
        hand-offs); folding it in per-txn keeps every *other* config an
        honest extrapolation while zeroing out a systematic bias."""
        self.pad_per_txn = 0.0
        if measured_txn_s <= 0:
            return 0.0
        # fixed-point: each step adds the remaining per-txn shortfall; on
        # an IO-bound config extra driver time only partly extends the
        # makespan, so the closed-form one-shot would overshoot downstream
        # — the iteration under-corrects monotonically instead
        for _ in range(12):
            pred = simulate(self, cfg, profile)
            if pred.txn_s <= 0:
                break
            err = 1.0 / measured_txn_s - 1.0 / pred.txn_s
            if err <= 0 and self.pad_per_txn == 0.0:
                break                       # already at/below measurement
            self.pad_per_txn = max(0.0, self.pad_per_txn + err)
            if abs(err) * measured_txn_s < 0.01:
                break
        return self.pad_per_txn

    def merge_stage(self, other: "CostModel", stage: int) -> None:
        """Copy one stage's fitted coefficients from another model (e.g.
        graft the cross-shard prepare cost, which only a sharded trace can
        observe, onto a single-shard calibration fit)."""
        if stage in other.coef:
            self.coef[stage] = other.coef[stage]


def _fit_nonneg(X: np.ndarray, y: np.ndarray) -> Tuple[float, ...]:
    """Least-squares fit with coefficients clamped non-negative and the
    intercept re-centred to preserve the sample mean (robust against the
    tiny, collinear samples short traces produce)."""
    k = X.shape[1]
    if len(y) == 0:
        return tuple([0.0] * k)
    if len(y) < k:
        return (float(np.mean(y)),) + tuple([0.0] * (k - 1))
    beta, *_ = np.linalg.lstsq(X, y, rcond=None)
    beta = np.maximum(beta, 0.0)
    slope_mean = float(X[:, 1:].mean(axis=0) @ beta[1:]) if k > 1 else 0.0
    beta[0] = max(0.0, float(np.mean(y)) - slope_mean)
    return tuple(float(v) for v in beta)


# --- workload profile --------------------------------------------------------
@dataclass
class WorkloadProfile:
    """Workload shape extracted from a trace: what one batch looks like."""

    bytes_per_txn: float = 64.0
    txn_per_batch: float = 256.0
    reads_fraction: float = 0.0

    @classmethod
    def from_dump(cls, dump: TraceDump) -> "WorkloadProfile":
        pub = dump.stage == ST_PUBLISH
        n = float(dump.n_txn[pub].sum())
        b = float(dump.nbytes[pub].sum())
        val = dump.stage == ST_VALIDATE
        counts = dump.n_txn[val]
        return cls(
            bytes_per_txn=(b / n) if n else 64.0,
            txn_per_batch=float(np.median(counts)) if counts.size else 256.0,
            reads_fraction=0.0,
        )


# --- configs / results -------------------------------------------------------
@dataclass
class SimConfig:
    """The hypothetical deployment a simulation answers for."""

    shards: int = 1
    devices: int = 1
    batch_size: int = 256
    n_txn: int = 20_000
    device_bw: Optional[float] = None   # bytes/s; None = fitted value
    cross_ratio: float = 0.0            # fraction of txns cross-shard
    n_cpu: int = 1                      # GIL => 1 on the bench box
    io_unit: int = 1 << 18              # bytes accumulated per flush span


@dataclass
class SimResult:
    makespan: float
    txn_s: float
    p50_commit: float
    p99_commit: float
    stage_busy: Dict[str, float] = field(default_factory=dict)

    def to_dict(self) -> Dict:
        return {
            "makespan_s": self.makespan,
            "txn_s": self.txn_s,
            "p50_commit_s": self.p50_commit,
            "p99_commit_s": self.p99_commit,
            "stage_busy": self.stage_busy,
        }


# --- discrete-event core -----------------------------------------------------
def _list_schedule(
    preds: Sequence[Sequence[int]],
    dur: Sequence[float],
    resource: Sequence[Optional[str]],
    servers: Dict[str, int],
) -> np.ndarray:
    """Greedy list scheduler: nodes start when all predecessors finished
    AND a server of their resource frees up (FIFO by ready time).  A
    ``None`` resource means no contention (virtual joins).  Returns the
    finish time per node."""
    n = len(preds)
    succs: List[List[int]] = [[] for _ in range(n)]
    indeg = [0] * n
    for i, ps in enumerate(preds):
        indeg[i] = len(ps)
        for p in ps:
            succs[p].append(i)
    ready = [0.0] * n
    finish = np.zeros(n)
    pools: Dict[str, List[float]] = {
        k: [0.0] * max(1, c) for k, c in servers.items()
    }
    heap = [(0.0, i) for i in range(n) if indeg[i] == 0]
    heapq.heapify(heap)
    done = 0
    while heap:
        t, i = heapq.heappop(heap)
        r = resource[i]
        if r is None:
            start = t
        else:
            pool = pools.setdefault(r, [0.0])
            j = int(np.argmin(pool))
            start = max(t, pool[j])
            pool[j] = start + dur[i]
        finish[i] = start + dur[i]
        done += 1
        for s in succs[i]:
            if ready[s] < finish[i]:
                ready[s] = finish[i]
            indeg[s] -= 1
            if indeg[s] == 0:
                heapq.heappush(heap, (ready[s], s))
    if done != n:
        raise ValueError(f"trace DAG has a cycle ({n - done} nodes unreached)")
    return finish


def simulate_dag(
    dag: TraceDAG,
    n_cpu: int = 1,
    duration_scale: Optional[Dict[int, float]] = None,
) -> SimResult:
    """Replay a recorded DAG's spans on explicit resources.

    ``duration_scale`` maps stage id → multiplier (e.g. ``{ST_FLUSH: 2.0}``
    asks "what if the device were half as fast").
    """
    d = dag.dump
    nn = dag.n_nodes
    dur = [0.0] * nn
    resource: List[Optional[str]] = [None] * nn
    for i in range(d.n):
        s = int(d.stage[i])
        t = float(d.t1[i] - d.t0[i])
        if duration_scale and s in duration_scale:
            t *= duration_scale[s]
        dur[i] = max(t, 0.0)
        if s == ST_FLUSH:
            resource[i] = f"dev{d.shard[i]}.{d.device[i]}"
        elif s in CPU_STAGES:
            resource[i] = "cpu"
    servers = {"cpu": n_cpu}
    finish = _list_schedule(dag.preds, dur, resource, servers)
    makespan = float(finish.max()) if nn else 0.0
    n_txn = int(d.n_txn[d.stage == ST_PUBLISH].sum())
    busy: Dict[str, float] = {}
    for i in range(d.n):
        k = stage_name(int(d.stage[i]))
        busy[k] = busy.get(k, 0.0) + dur[i]
    # commit latency proxy: publish finish -> covering flush finish
    lat = _dag_commit_latencies(dag, finish, dur)
    return SimResult(
        makespan=makespan,
        txn_s=(n_txn / makespan) if makespan > 0 else 0.0,
        p50_commit=float(np.percentile(lat, 50)) if lat else 0.0,
        p99_commit=float(np.percentile(lat, 99)) if lat else 0.0,
        stage_busy=busy,
    )


def _dag_commit_latencies(
    dag: TraceDAG, finish: np.ndarray, dur: Sequence[float]
) -> List[float]:
    """Per-publish commit latency: publish start -> finish of the flush
    that made its SSN range durable (the Qww rule, per device lane)."""
    d = dag.dump
    pub = np.flatnonzero(
        (d.stage == ST_PUBLISH) & (d.device >= 0) & (d.nbytes > 0)
    )
    # flush successors were wired by build_dag: find them via preds
    cover: Dict[int, float] = {}
    for f in np.flatnonzero(d.stage == ST_FLUSH).tolist():
        for p in dag.preds[f]:
            if p not in cover or finish[f] < cover[p]:
                cover[p] = float(finish[f])
    out = []
    for i in pub.tolist():
        if i in cover:
            start = float(finish[i]) - float(dur[i])
            out.append(max(0.0, cover[i] - start))
    return out


# --- synthetic what-if simulation -------------------------------------------
def simulate(
    model: CostModel,
    cfg: SimConfig,
    profile: Optional[WorkloadProfile] = None,
) -> SimResult:
    """Predict throughput and commit latency for ``cfg`` by generating a
    synthetic batch pipeline DAG and list-scheduling it with fitted costs.

    The generator mirrors ``ShardedEngine.execute_batch``: the driver
    thread submits global batches of ``batch_size``; the router splits
    each into per-shard sub-batches (validate → sequence → encode/publish,
    bytes striped over ``devices``) run *serially* on the driver lane,
    then a ``cross_ratio`` fraction of the batch's transactions pays the
    per-txn coordinator prepare (one xprepare cost each, serialized —
    this, not bandwidth, is why cross-shard cells crater).  Each device
    lane accumulates bytes and emits a flush span per ``io_unit``; commit
    latency of a publish is publish start → covering flush finish.
    """
    profile = profile or WorkloadProfile()
    bpt = profile.bytes_per_txn
    batch = max(1, int(cfg.batch_size))
    n_batches = max(1, -(-cfg.n_txn // batch))
    bw = cfg.device_bw or model.dev_bw
    n_cross = int(round(batch * cfg.cross_ratio)) if cfg.shards > 1 else 0
    n_single = batch - n_cross
    share = n_single // max(1, cfg.shards)

    preds: List[List[int]] = []
    dur: List[float] = []
    resource: List[Optional[str]] = []
    stage_of: List[int] = []

    def add(stage: int, res: Optional[str], t: float,
            ps: Sequence[int]) -> int:
        preds.append(list(ps))
        dur.append(t)
        resource.append(res)
        stage_of.append(stage)
        return len(dur) - 1

    # per-(shard, device) pending bytes and the publishes awaiting a flush
    pend_bytes = {(s, v): 0 for s in range(cfg.shards)
                  for v in range(cfg.devices)}
    pend_pubs: Dict[Tuple[int, int], List[int]] = {
        k: [] for k in pend_bytes
    }
    last_flush: Dict[Tuple[int, int], int] = {}
    covering: Dict[int, int] = {}       # publish node -> flush node

    def emit_flush(key: Tuple[int, int]) -> None:
        nb = pend_bytes[key]
        if nb <= 0:
            return
        ps = list(pend_pubs[key])
        if key in last_flush:
            ps.append(last_flush[key])
        f = add(ST_FLUSH, f"dev{key[0]}.{key[1]}",
                model.flush_cost(nb, bw), ps)
        for p in pend_pubs[key]:
            covering[p] = f
        last_flush[key] = f
        pend_bytes[key] = 0
        pend_pubs[key] = []

    chain: List[int] = []               # the driver thread's serial lane
    for bi in range(n_batches):
        # leading driver half (workload gen) + the untraced per-txn residual
        lead = batch * model.pad_per_txn
        if ST_DRIVER in model.coef:
            lead += model.stage_cost(ST_DRIVER, batch, 0)
        if lead > 0:
            chain = [add(ST_DRIVER, "cpu", lead, chain)]
        for s in range(cfg.shards):
            if share <= 0:
                break
            nb_total = int(share * bpt)
            v = add(ST_VALIDATE, "cpu",
                    model.stage_cost(ST_VALIDATE, share, nb_total), chain)
            q = add(ST_SEQUENCE, "cpu",
                    model.stage_cost(ST_SEQUENCE, share, nb_total), [v])
            tail = q
            d_share = max(1, share // cfg.devices)
            nb_share = max(1, nb_total // cfg.devices)
            for dvi in range(cfg.devices):
                e = add(ST_ENCODE, "cpu",
                        model.stage_cost(ST_ENCODE, d_share, nb_share),
                        [tail])
                p = add(ST_PUBLISH, "cpu",
                        model.stage_cost(ST_PUBLISH, d_share, nb_share), [e])
                tail = p
                key = (s, dvi)
                pend_bytes[key] += nb_share
                pend_pubs[key].append(p)
                if pend_bytes[key] >= cfg.io_unit:
                    emit_flush(key)
            if ST_WRITEBACK in model.coef:
                tail = add(ST_WRITEBACK, "cpu",
                           model.stage_cost(ST_WRITEBACK, share, 0), [tail])
            chain = [tail]
        if n_cross:
            # the coordinator prepares each cross txn one at a time on the
            # driver thread: n_cross serialized per-txn costs, records
            # split across both participants' device lanes
            xp = add(ST_XPREPARE, "cpu",
                     n_cross * model.stage_cost(ST_XPREPARE, 1, int(bpt)),
                     chain)
            xb = int(n_cross * bpt) // cfg.shards
            for s in range(cfg.shards):
                key = (s, bi % cfg.devices)
                pend_bytes[key] += xb
                pend_pubs[key].append(xp)
                if pend_bytes[key] >= cfg.io_unit:
                    emit_flush(key)
            chain = [xp]
        if ST_DRIVER in model.coef:
            # trailing driver half: drain + ack sweep after the batch
            chain = [add(ST_DRIVER, "cpu",
                         model.stage_cost(ST_DRIVER, 0, 0), chain)]
    for key in pend_bytes:
        emit_flush(key)

    finish = _list_schedule(preds, dur, resource, {"cpu": cfg.n_cpu})
    makespan = float(finish.max()) if len(dur) else 0.0

    # commit latency: publish finish -> covering flush finish
    lats: List[float] = []
    for p, f in covering.items():
        if stage_of[p] == ST_PUBLISH:
            lats.append(max(0.0, float(finish[f] - finish[p])) + dur[p])
    busy: Dict[str, float] = {}
    for i, s in enumerate(stage_of):
        k = stage_name(s)
        busy[k] = busy.get(k, 0.0) + dur[i]
    n_done = n_batches * batch
    return SimResult(
        makespan=makespan,
        txn_s=(n_done / makespan) if makespan > 0 else 0.0,
        p50_commit=float(np.percentile(lats, 50)) if lats else 0.0,
        p99_commit=float(np.percentile(lats, 99)) if lats else 0.0,
        stage_busy=busy,
    )
