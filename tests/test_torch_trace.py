"""The port's trace DAG, replay simulator and autotuner against the
reference's.

* The same stepped serve run (single engine, and two shards with
  cross-shard specs) traced in each package gives the same structural dump
  and byte-identical ``TraceDAG.canonical_bytes()``; two identical runs of
  the port give identical bytes too.
* On one recorded dump, both packages' ``build_dag``, ``critical_path``,
  ``simulate_dag``, ``CostModel.fit``, ``WorkloadProfile.from_dump``,
  ``simulate``, ``calibrate_pad`` and ``autotune`` give identical results
  (the dump's wall-clock columns are data here, so nothing is compared to a
  clock).
* On a sharded serve trace, and on a single-shard one whose keys repeat
  across cuts, both packages build the same cyclic DAG, and
  ``simulate_dag`` raises in both (a fault of the reference that the port
  keeps, ROADMAP Queue C); with distinct keys the single-shard DAG replays.
* The list scheduler's unit cases of ``tests/test_trace_sim.py``.
"""

import numpy as np
import pytest

import repro.core as jcore
import repro.db.batch as jbatch
import repro.serve as jserve
import repro.shard as jshard
import repro.trace as jtrace
import repro.trace.sim as jsim
import repro_torch.core as tcore
import repro_torch.db.batch as tbatch
import repro_torch.serve as tserve
import repro_torch.shard as tshard
import repro_torch.trace as ttrace
import repro_torch.trace.sim as tsim
from repro_torch.db.ycsb import key_of
from repro_torch.trace import (
    ST_ACK,
    ST_CUT,
    ST_FLUSH,
    ST_PUBLISH,
    ST_VALIDATE,
    ST_XPREPARE,
    TraceDump,
)

PKGS = {"ref": (jcore, jbatch, jserve, jshard, jtrace, jsim),
        "port": (tcore, tbatch, tserve, tshard, ttrace, tsim)}


@pytest.fixture(autouse=True)
def _disarm():
    yield
    for pkg in PKGS:
        tracer = PKGS[pkg][4].TRACER
        tracer.enabled = False
        tracer.reset()


def _traced_serve_run(pkg, path, sharded=False):
    """One deterministic stepped serve run, traced end to end."""
    core, batch, serve, shard, trace, _ = PKGS[pkg]
    ecfg = core.EngineConfig(n_buffers=2, device_kind="ssd", device_dir=str(path),
                             device_clock="virtual", flush_interval=60.0)
    kw = {"device": "cpu"} if pkg == "port" else {}
    if sharded:
        be = serve.ShardedBackend(shard.ShardedEngine(shard.ShardedConfig(
            n_shards=2, n_workers=2, device_dir=str(path), engine=ecfg, mode="vectorized",
            **kw)))
    else:
        be = serve.SingleBackend.make("vectorized", n_workers=2, cfg=ecfg)
    sched = serve.GroupCommitScheduler(be, serve.ServeConfig(max_batch=16))
    trace.enable()
    try:
        for i in range(64):
            writes = [(key_of(i % 40), bytes([i % 251]))]
            if sharded and i % 10 == 0:       # 10% cross-shard (two shards' keys)
                writes.append((key_of(100 + i), b"x"))
            sched.submit(batch.TxnSpec(writes=writes))
            if i % 4 == 3:
                sched.step(tick_parts=None if i % 8 else [0])
        sched.run_until_drained()
    finally:
        dump = trace.disable()
    return dump


@pytest.mark.parametrize("sharded", [False, True])
def test_serve_run_dag_matches_reference(sharded, tmp_path):
    dumps = {pkg: _traced_serve_run(pkg, tmp_path / pkg, sharded) for pkg in PKGS}
    assert dumps["port"].n > 0
    assert dumps["port"].structural_dict() == dumps["ref"].structural_dict()
    dags = {pkg: PKGS[pkg][4].build_dag(dumps[pkg]) for pkg in PKGS}
    assert dags["port"].canonical_bytes() == dags["ref"].canonical_bytes()
    assert dags["port"].fingerprint() == dags["ref"].fingerprint()
    stages = set(dumps["port"].stage.tolist())
    assert {ST_VALIDATE, ST_PUBLISH, ST_FLUSH, ST_CUT, ST_ACK} <= stages
    if sharded:
        assert ST_XPREPARE in stages and dags["port"].virtual


def test_two_identical_port_runs_give_identical_bytes(tmp_path):
    d1 = _traced_serve_run("port", tmp_path / "r1", sharded=True)
    d2 = _traced_serve_run("port", tmp_path / "r2", sharded=True)
    g1, g2 = ttrace.build_dag(d1), ttrace.build_dag(d2)
    assert g1.canonical_bytes() == g2.canonical_bytes()


def _same_dump(tmp_path, sharded):
    """One recorded dump (the reference's serve run) in both packages'
    ``TraceDump``."""
    d = _traced_serve_run("ref", tmp_path, sharded).to_dict()
    return {"ref": jtrace.TraceDump.from_dict(d), "port": TraceDump.from_dict(d)}


def _sim_view(r):
    return r.to_dict()


def test_dag_analysis_and_replay_match_reference(tmp_path):
    dumps = _same_dump(tmp_path, sharded=False)
    out = {}
    for pkg, dump in dumps.items():
        trace = PKGS[pkg][4]
        dag = trace.build_dag(dump)
        path, attr = trace.critical_path(dag)
        out[pkg] = (dag.canonical_bytes(), dag.preds, dag.virtual, path, attr,
                    dag.stage_totals(), dag.resource_busy(),
                    [t.tolist() for t in dag.node_times()],
                    _sim_view(trace.simulate_dag(dag)),
                    _sim_view(trace.simulate_dag(dag, n_cpu=2, duration_scale={ST_FLUSH: 2.0})))
        assert sum(attr.values()) == pytest.approx(dump.makespan(), rel=1e-9)
    assert out["port"] == out["ref"]


def test_sharded_serve_dag_cycle_is_the_references(tmp_path):
    """On a sharded serve trace, ``build_dag`` joins each ack span to the
    first flush on *every* shard's lanes whose SSN reaches the ack's, though
    SSNs are per shard: an ack then waits for a later flush of another
    shard, which waits (through the exec lane) for the ack.  Both packages
    build the same cyclic DAG, ``simulate_dag`` raises in both, and the
    critical path still partitions the makespan (ROADMAP Queue C)."""
    dumps = _same_dump(tmp_path, sharded=True)
    out = {}
    for pkg, dump in dumps.items():
        trace = PKGS[pkg][4]
        dag = trace.build_dag(dump)
        with pytest.raises(ValueError, match="cycle"):
            trace.simulate_dag(dag)
        path, attr = trace.critical_path(dag)
        assert sum(attr.values()) == pytest.approx(dump.makespan(), rel=1e-9)
        out[pkg] = (dag.canonical_bytes(), path, attr, dag.stage_totals())
    assert out["port"] == out["ref"]


def _traced_single_shard_keys_run(pkg, path, distinct):
    """A stepped single-shard serve run of 64 one-byte writes, cut at 16,
    over keys drawn from 128 with repeats, or 64 distinct keys."""
    core, batch, serve, _, trace, _ = PKGS[pkg]
    ecfg = core.EngineConfig(n_buffers=2, device_kind="ssd", device_dir=str(path),
                             device_clock="virtual", flush_interval=60.0)
    be = serve.SingleBackend.make("vectorized", n_workers=2, cfg=ecfg)
    rng = np.random.default_rng(0)
    keys = rng.permutation(128)[:64] if distinct else rng.integers(0, 128, 64)
    sched = serve.GroupCommitScheduler(be, serve.ServeConfig(max_batch=16))
    trace.enable()
    try:
        for i, k in enumerate(keys):
            sched.submit(batch.TxnSpec(writes=[(key_of(int(k)), bytes([i % 251]))]))
            if i % 16 == 15:
                sched.step()
        sched.run_until_drained()
    finally:
        dump = trace.disable()
    return dump


@pytest.mark.parametrize("distinct", [False, True])
def test_single_shard_serve_dag_cycle_on_repeated_keys_is_the_references(distinct, tmp_path):
    """A single-shard serve trace whose keys repeat across cuts is cyclic
    too: an ack joins the first flush on *every* device lane whose SSN
    reaches the ack's, and a device that held no record of that SSN reaches
    it only in a later flush, whose publish follows the ack on the exec
    lane.  With distinct keys every SSN is reached at once and the DAG
    replays.  Both packages agree either way (ROADMAP Queue C)."""
    out = {}
    for pkg in PKGS:
        dump = _traced_single_shard_keys_run(pkg, tmp_path / pkg, distinct)
        trace = PKGS[pkg][4]
        dag = trace.build_dag(dump)
        path, attr = trace.critical_path(dag)
        assert sum(attr.values()) == pytest.approx(dump.makespan(), rel=1e-9)
        if distinct:
            replay = _sim_view(trace.simulate_dag(dag))
            assert replay["makespan_s"] > 0
        else:
            with pytest.raises(ValueError, match="cycle") as e:
                trace.simulate_dag(dag)
            replay = str(e.value)
        out[pkg] = (dump.structural_dict(), dag.canonical_bytes(), path,
                    replay if not distinct else None)
    assert out["port"] == out["ref"]


def test_cost_model_simulate_and_autotune_match_reference(tmp_path):
    dumps = _same_dump(tmp_path, sharded=True)
    out = {}
    for pkg, dump in dumps.items():
        trace = PKGS[pkg][4]
        model = trace.CostModel.fit(dump)
        prof = trace.WorkloadProfile.from_dump(dump)
        cfgs = [trace.SimConfig(shards=s, devices=d, batch_size=b, n_txn=4096, cross_ratio=x)
                for s, d, b, x in ((1, 1, 256, 0.0), (2, 2, 128, 0.1), (4, 1, 512, 0.3))]
        sims = [_sim_view(trace.simulate(model, c, prof)) for c in cfgs]
        pad = model.calibrate_pad(sims[1]["txn_s"] * 0.7, cfgs[1], prof)
        tune = trace.autotune(model, prof, n_txn=4096, shards=2, batch_grid=(64, 256, 1024),
                              device_grid=(1, 2), cross_ratio=0.1)
        tight = trace.autotune(model, prof, n_txn=4096, batch_grid=(64, 1024), device_grid=(1,),
                               p99_budget=1e-12)
        out[pkg] = (model.coef, model.dev_lat, model.dev_bw, vars(prof), sims, pad,
                    tune.to_dict(), tight.to_dict())
    assert out["port"] == out["ref"]
    assert len(out["port"][6]["table"]) == 6


def test_list_schedule_unit_cases():
    sched = tsim._list_schedule
    assert sorted(sched([[], [], []], [1.0] * 3, ["cpu"] * 3, {"cpu": 1}).tolist()) == \
        [1.0, 2.0, 3.0]
    assert sched([[], [], []], [1.0] * 3, ["cpu"] * 3, {"cpu": 3}).tolist() == [1.0] * 3
    assert sched([[], [0], [1], [2]], [1.0, 2.0, 0.0, 1.0], ["cpu", "cpu", None, "cpu"],
                 {"cpu": 1}).tolist() == [1.0, 3.0, 3.0, 4.0]
    with pytest.raises(ValueError, match="cycle"):
        sched([[1], [0]], [1.0, 1.0], ["cpu", "cpu"], {"cpu": 1})
    rng = np.random.default_rng(4)
    preds = [sorted(set(rng.integers(0, i, rng.integers(0, 3)).tolist())) if i else []
             for i in range(200)]
    dur = rng.random(200).tolist()
    res = [None if i % 7 == 0 else ("cpu" if i % 3 else f"dev{i % 2}") for i in range(200)]
    assert sched(preds, dur, res, {"cpu": 2}).tolist() == \
        jsim._list_schedule(preds, dur, res, {"cpu": 2}).tolist()
