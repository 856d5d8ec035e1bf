"""The port's serving tier (``repro_torch.serve``) against the reference's,
exactly, and the port's own group-commit properties.

* **Cross-package.**  The same seeded stepped schedules go through the
  reference's ``SingleBackend`` (``vectorized``, ``scalar``, and
  ``pallas`` on two seeds) and the port's (``vectorized``, ``kernel`` on
  ``device="cpu"`` with the fused round forced and with its default
  decline rule, ``scalar``), and through both packages' ``ShardedBackend``
  with cross-shard specs: byte-identical device logs, the same SSNs, the
  same ack order, the same ``stats()`` and the same final state.  Each
  package recovers the other's serve-written device files to the same
  state.  A Zipf-hot read-modify-write schedule holds retries, backoff and
  aborts to the reference's.
* **The port's own properties** (``tests/test_serve_property.py``'s P1 and
  P2): a conflict-free schedule through the serve path equals one direct
  ``execute_batch``, and any two cut configurations of an arbitrary
  schedule give the same logs, state, SSNs and ack order; as seeded trials
  and as a hypothesis property.
* **Scheduler behaviours** of ``tests/test_serve_scheduler.py``: the cut
  triggers, the watermark ack gate, explicit ``REJECTED``, the retry's
  capacity exemption, backpressure, cross-shard acks, and, in both
  packages, an executor fault in the threaded loop that aborts its cut and
  strands no ticket.
* **Both crash scenarios** of ``tests/test_serve_crash.py`` on the port,
  with the acked-write oracle, recovered in all three of its modes and by
  the reference.
"""

import os
import random
import tempfile
import time
from collections import Counter
from pathlib import Path

import pytest
from hypothesis import given, settings, strategies as st

import repro.core as jcore
import repro.db.batch as jbatch
import repro.db.ycsb as jycsb
import repro.serve as jserve
import repro.shard as jshard
import repro_torch.core as tcore
import repro_torch.db.batch as tbatch
import repro_torch.db.ycsb as tycsb
import repro_torch.serve as tserve
import repro_torch.shard as tshard
from repro_torch.db.batch import TxnSpec
from repro_torch.db.ycsb import key_of
from repro_torch.serve import (
    ABORTED,
    ACKED,
    INFLIGHT,
    REJECTED,
    GroupCommitScheduler,
    ServeConfig,
    ShardedBackend,
    SingleBackend,
    run_stepped_schedule,
)

PKGS = {"ref": (jcore, jbatch, jycsb, jserve, jshard),
        "port": (tcore, tbatch, tycsb, tserve, tshard)}
# name -> (package, backend mode, fused_min_lanes or None for the default)
SINGLE = {
    "ref-vectorized": ("ref", "vectorized", None),
    "ref-scalar": ("ref", "scalar", None),
    "ref-pallas": ("ref", "pallas", 0),
    "port-vectorized": ("port", "vectorized", None),
    "port-kernel": ("port", "kernel", 0),          # the fused round, plain version
    "port-kernel-seg": ("port", "kernel", None),   # declined: seg_reduce, plain version
    "port-scalar": ("port", "scalar", None),
}
SHARDED = {
    "ref-vectorized": ("ref", "vectorized", None),
    "port-vectorized": ("port", "vectorized", None),
    "port-kernel": ("port", "kernel", 0),
}
RECOVER_MODES = {"ref": ("vectorized", "scalar"), "port": ("kernel", "vectorized", "scalar")}
READ_POOL = 20


def _ecfg(pkg, path, n_buffers=1):
    """Stepped engines: virtual-clock SSDs and a flush interval no step
    reaches, so only ``tick`` flushes (both packages alike)."""
    return PKGS[pkg][0].EngineConfig(n_buffers=n_buffers, device_kind="ssd",
                                     device_dir=str(path), device_clock="virtual",
                                     flush_interval=60.0)


def _single(name, path, n_workers=2, n_buffers=1, preload=True):
    pkg, mode, min_lanes = SINGLE[name]
    serve = PKGS[pkg][3]
    kw = {"device": "cpu"} if pkg == "port" and mode == "kernel" else {}
    be = serve.SingleBackend.make(mode, n_workers=n_workers,
                                  cfg=_ecfg(pkg, path, n_buffers), **kw)
    if min_lanes is not None:
        be.occ.fused_min_lanes = min_lanes
    if preload:
        for i in range(READ_POOL):
            be.table.insert(key_of(i), f"seed{i}".encode())
    return be


def _sharded(name, path, n_shards=2, n_workers=2):
    pkg, mode, min_lanes = SHARDED[name]
    core, _, _, serve, shard = PKGS[pkg]
    kw = {"device": "cpu"} if pkg == "port" else {}
    be = serve.ShardedBackend(shard.ShardedEngine(shard.ShardedConfig(
        n_shards=n_shards, n_workers=n_workers, mode=mode, device_dir=str(path),
        engine=_ecfg(pkg, path), **kw)))
    if min_lanes is not None:
        for sh in be.eng.shards:
            sh.occ.fused_min_lanes = min_lanes
    for i in range(READ_POOL):
        be.eng.insert(key_of(i), f"seed{i}".encode())
    return be


def _specs(pkg, raw):
    spec = PKGS[pkg][1].TxnSpec
    return [spec(reads=list(r), writes=list(w)) for r, w in raw]


def _serve(pkg, be, raw, gaps, max_batch, budget, tick_parts=None):
    serve = PKGS[pkg][3]
    sched = serve.GroupCommitScheduler(be, serve.ServeConfig(
        max_batch=max_batch, latency_budget_steps=budget, queue_capacity=10**6))
    at, schedule = 0, []
    for spec, gap in zip(_specs(pkg, raw), gaps):
        at += gap
        schedule.append((at, spec))
    trng = random.Random(len(raw))
    tickets = serve.run_stepped_schedule(
        sched, schedule,
        tick_parts_fn=(lambda step: trng.choice(tick_parts)) if tick_parts else None)
    return sched, tickets


def _devices(be):
    devs = be.eng.devices if hasattr(be, "eng") else [be.engine.devices]
    for ds in devs:
        for d in ds:
            d.close()
    return devs


def _state(be):
    """key bytes -> (value, ssn) of an ``ArrayTable``, a scalar ``Table`` or
    a sharded engine."""
    if hasattr(be, "eng"):
        return be.eng.to_dict()
    if hasattr(be.table, "to_dict"):
        return be.table.to_dict()
    return {k.encode(): (be.table.get(k).value, be.table.get(k).ssn)
            for k in be.table.sorted_keys()}


def _view(be, sched, tickets):
    """Everything a run must agree on: ticket fates, SSNs and ack order,
    ``stats()``, the final state and every device's bytes."""
    data = _state(be)
    return ([(t.status, t.ssn, t.ack_seq, t.attempts) for t in tickets], sched.stats(), data,
            [[d.read_all() for d in ds] for ds in _devices(be)])


def _reopen(pkg, devs):
    core = PKGS[pkg][0]
    return [[core.StorageDevice(core.DeviceSpec.ssd(), path=d.path, clock="virtual") for d in ds]
            for ds in devs]


def _recover(pkg, devs, mode, sharded):
    kw = {"device": "cpu"} if mode == "kernel" else {}
    if sharded:
        st = PKGS[pkg][4].recover_sharded(devs, parallel=False, mode=mode, **kw)
        return (st.n_cross_seen, st.n_cross_dropped,
                [(s.data, s.rsne, s.n_replayed, s.n_skipped_uncommitted) for s in st.shards])
    st = PKGS[pkg][0].recover(devs[0], parallel=False, mode=mode, **kw)
    return st.data, st.rsne, st.n_replayed, st.n_skipped_uncommitted


def _assert_cross_recovery(backends, sharded=False):
    """Every package recovers every run's device files, in each of its
    modes, to the state the reference's vectorized mode gives its own."""
    want = _recover("ref", _reopen("ref", _devices(backends["ref-vectorized"])), "vectorized",
                    sharded)
    for be in backends.values():
        for pkg in PKGS:
            devs = _reopen(pkg, _devices(be))
            for mode in RECOVER_MODES[pkg]:
                assert _recover(pkg, devs, mode, sharded) == want, (pkg, mode)
    return want


def _hot_schedule(rng, n, n_hot=6, cross=False):
    """Writes collide on a few hot keys (the cutter splits at conflicts),
    reads come from the preloaded pool."""
    raw = []
    for _ in range(n):
        wkeys = rng.sample(range(READ_POOL, READ_POOL + n_hot), rng.randrange(1, 3 if not cross else 4))
        raw.append(([key_of(j) for j in rng.sample(range(READ_POOL), rng.randrange(0, 3))],
                    [(key_of(k), rng.randbytes(rng.randrange(1, 40))) for k in wkeys]))
    return raw


# --- cross-package: the same schedules, the same bytes ---------------------------

@pytest.mark.parametrize("seed", range(4))
def test_single_serve_matches_reference(seed, tmp_path):
    """Hot-key schedules on two log buffers with random partial flushes: every
    executor of both packages gives the same fates, SSNs, ack order,
    ``stats()``, state and device bytes; cross-recovery both ways."""
    rng = random.Random(seed)
    n = rng.randrange(12, 40)
    raw = _hot_schedule(rng, n)
    gaps = [rng.randrange(0, 3) for _ in range(n)]
    max_batch, budget = rng.choice([2, 3, 8, 64]), rng.choice([1, 2])
    n_workers = rng.choice([1, 2, 3])
    names = [k for k in SINGLE if k != "ref-pallas"]
    backends, views = {}, {}
    for name in names:
        be = backends[name] = _single(name, tmp_path / name, n_workers, n_buffers=2)
        sched, tickets = _serve(SINGLE[name][0], be, raw, gaps, max_batch, budget,
                                tick_parts=[None, None, [0], [1], []])
        assert all(t.status == ACKED for t in tickets), name
        views[name] = _view(be, sched, tickets)
    for name in names:
        assert views[name] == views["ref-vectorized"], name
    _assert_cross_recovery(backends)


@pytest.mark.parametrize("seed", range(2))
def test_single_serve_matches_reference_pallas(seed, tmp_path):
    """The reference's ``pallas`` executor (its compiled fused round) against
    the port's ``kernel`` one (the fused round's plain version), both forced
    to fuse every round, on a conflict-free schedule with reads."""
    rng = random.Random(50 + seed)
    n = rng.randrange(8, 24)
    raw = [([key_of(j) for j in rng.sample(range(READ_POOL), rng.randrange(0, 3))],
            [(key_of(1000 + i), rng.randbytes(rng.randrange(1, 40)))]) for i in range(n)]
    gaps = [rng.randrange(0, 3) for _ in range(n)]
    views, backends = {}, {}
    for name in ("ref-pallas", "port-kernel", "ref-vectorized"):
        be = backends[name] = _single(name, tmp_path / name)
        sched, tickets = _serve(SINGLE[name][0], be, raw, gaps, rng.choice([2, 4, 64]), 1)
        views[name] = _view(be, sched, tickets)
    assert views["port-kernel"] == views["ref-pallas"] == views["ref-vectorized"]
    _assert_cross_recovery(backends)


@pytest.mark.parametrize("seed", range(3))
def test_sharded_serve_matches_reference(seed, tmp_path):
    """Two shards, single- and cross-shard specs: per-shard bytes
    (``FLAG_XSHARD`` records included), SSNs, ack order and ``stats()`` of
    both packages' ``ShardedBackend``s agree; cross-recovery both ways."""
    rng = random.Random(200 + seed)
    n = rng.randrange(10, 30)
    raw = _hot_schedule(rng, n, n_hot=8, cross=True)
    gaps = [rng.randrange(0, 3) for _ in range(n)]
    max_batch = rng.choice([2, 4, 16])
    backends, views = {}, {}
    for name in SHARDED:
        be = backends[name] = _sharded(name, tmp_path / name)
        sched, tickets = _serve(SHARDED[name][0], be, raw, gaps, max_batch, 1,
                                tick_parts=[None, None, [0], [1]])
        assert all(t.status == ACKED for t in tickets), name
        views[name] = _view(be, sched, tickets)
    assert any(len(t.txn.parts) > 1 for t in tickets if hasattr(t.txn, "parts")), \
        "no cross-shard transaction"
    for name in SHARDED:
        assert views[name] == views["ref-vectorized"], name
    _assert_cross_recovery(backends, sharded=True)


@pytest.mark.parametrize("seed", range(2))
def test_rmw_retries_match_reference(seed, tmp_path):
    """Zipf-hot read-modify-write clients (specs regenerated per attempt):
    the same retries, attempts, aborts and bytes in both packages."""
    views = {}
    for name in ("ref-vectorized", "port-kernel", "port-scalar", "ref-scalar"):
        pkg = SINGLE[name][0]
        _, _, ycsb, serve, _ = PKGS[pkg]
        be = _single(name, tmp_path / name, preload=False)
        ycsb.load(be.table, 8, seed=7)
        fac = ycsb.RMWSpecFactory(be.table, 8, seed=11 + seed, theta=0.9)
        sched = serve.GroupCommitScheduler(be, serve.ServeConfig(
            max_batch=8, latency_budget_steps=1, max_retries=2, backoff_steps=1,
            queue_capacity=10**6))
        tickets = [sched.submit(make_spec=fac.spec_fn(), client_id=i) for i in range(40)]
        sched.run_until_drained(max_steps=5000)
        views[name] = _view(be, sched, tickets)
    st = views["ref-vectorized"][1]
    assert st["retries"] > 0 and st["acked"] + st["aborted"] == 40
    for name in views:
        assert views[name] == views["ref-vectorized"], name


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_executor_fault_strands_no_ticket(pkg, tmp_path):
    """Threaded loop: a cut whose executor raises ends ABORTED and counted in
    ``exec_errors``; the loop keeps serving and later tickets ack."""
    core, batch, _, serve, _ = PKGS[pkg]
    kw = {"device": "cpu"} if pkg == "port" else {}
    be = serve.SingleBackend.make("vectorized", n_workers=2, cfg=core.EngineConfig(
        n_buffers=1, device_kind="null", device_dir=str(tmp_path), device_clock="virtual",
        flush_interval=1e-3, logger_poll=1e-4), **kw)
    execute, calls = be.execute, []

    def failing_once(specs, **kwargs):
        calls.append(len(specs))
        if len(calls) == 1:
            raise RuntimeError("injected executor fault")
        return execute(specs, **kwargs)

    be.execute = failing_once
    sched = serve.GroupCommitScheduler(be, serve.ServeConfig(
        latency_budget_s=5e-3, max_batch=8, queue_capacity=10**6))
    sched.start()
    try:
        first = [sched.submit(batch.TxnSpec(writes=[(key_of(i), b"a")])) for i in range(4)]
        for t in first:
            assert t.wait(timeout=30) in (ABORTED, ACKED)
        later = [sched.submit(batch.TxnSpec(writes=[(key_of(100 + i), b"b")])) for i in range(6)]
        for t in later:
            assert t.wait(timeout=30) == ACKED
    finally:
        sched.stop(quiesce=True)
    st = sched.stats()
    assert st["exec_errors"] == 1
    n_first_aborted = calls[0]
    assert [t.status for t in first[:n_first_aborted]] == [ABORTED] * n_first_aborted
    assert all(t.done for t in first + later)
    assert st["aborted"] == n_first_aborted and st["acked"] == 10 - n_first_aborted


# --- the port's own properties (P1 and P2) ---------------------------------------

def _mk(mode, path, n_workers):
    name = {"vectorized": "port-vectorized", "kernel": "port-kernel",
            "kernel-seg": "port-kernel-seg", "scalar": "port-scalar"}[mode]
    return _single(name, path, n_workers)


def _settle_direct(be, res, max_steps=200):
    for _ in range(max_steps):
        be.tick()
        be.drain()
        if all(t.committed for t in res.committed):
            return
    raise TimeoutError("direct batch did not settle")


def _check_equivalence(mode, base_dir, specs_raw, gaps, max_batch, budget, n_workers):
    """P1: serve path vs one direct execute_batch — bytes, state, SSNs."""
    be_s = _mk(mode, base_dir / "serve", n_workers)
    be_d = _mk(mode, base_dir / "direct", n_workers)
    sched, tickets = _serve("port", be_s, specs_raw, gaps, max_batch, budget)
    assert all(t.status == ACKED for t in tickets)
    assert [t.ack_seq for t in tickets] == list(range(len(tickets)))
    res = be_d.occ.execute_batch(_specs("port", specs_raw), max_rounds=1)
    assert not res.aborted and list(res.committed_idx) == list(range(len(specs_raw)))
    _settle_direct(be_d, res)
    assert [t.ssn for t in tickets] == [t.ssn for t in res.committed]
    assert _state(be_s) == _state(be_d)
    assert [d.read_all() for ds in _devices(be_s) for d in ds] == \
        [d.read_all() for ds in _devices(be_d) for d in ds]


def _conflict_free(rng, n):
    return [([key_of(j) for j in rng.sample(range(READ_POOL), rng.randrange(0, 3))],
             [(key_of(1000 + i), rng.randbytes(rng.randrange(1, 40)))]) for i in range(n)]


@pytest.mark.parametrize("mode,seed", [("vectorized", s) for s in range(4)]
                         + [("kernel", s) for s in range(3)]
                         + [("kernel-seg", s) for s in range(2)]
                         + [("scalar", s) for s in range(3)])
def test_equivalence_serve_vs_direct(mode, seed, tmp_path):
    rng = random.Random(seed)
    n = rng.randrange(1, 22)
    _check_equivalence(mode, tmp_path, _conflict_free(rng, n),
                       [rng.randrange(0, 3) for _ in range(n)],
                       max_batch=rng.choice([1, 2, 3, 8, 64]), budget=rng.choice([1, 2]),
                       n_workers=rng.choice([1, 2, 3]))


@pytest.mark.parametrize("seed", range(3))
def test_equivalence_sharded_serve_vs_direct(seed, tmp_path):
    rng = random.Random(seed)
    n = rng.randrange(1, 20)
    raw = [([], [(key_of(1000 + i), rng.randbytes(rng.randrange(1, 32)))]) for i in range(n)]
    gaps = [rng.randrange(0, 3) for _ in range(n)]
    # one worker per shard: each shard's executor stripes its sub-batch from
    # worker 0, so only then are tids independent of where cuts land
    be_s = _sharded("port-kernel", tmp_path / "s", n_workers=1)
    be_d = _sharded("port-kernel", tmp_path / "d", n_workers=1)
    _, tickets = _serve("port", be_s, raw, gaps, rng.choice([1, 2, 4, 16]), 1)
    assert all(t.status == ACKED for t in tickets)
    res = be_d.eng.execute_batch(_specs("port", raw))
    assert not res.aborted and not res.cross
    for _ in range(200):
        be_d.tick()
        be_d.drain()
        if all(t.committed for t in res.committed):
            break
    assert be_s.eng.to_dict() == be_d.eng.to_dict()
    assert [d.read_all() for ds in _devices(be_s) for d in ds] == \
        [d.read_all() for ds in _devices(be_d) for d in ds]


def _check_cut_invariance(mode, base_dir, raw, cfgs, n_workers):
    views = []
    for tag, (gaps, max_batch, budget) in zip("ab", cfgs):
        be = _mk(mode, base_dir / tag, n_workers)
        sched, tickets = _serve("port", be, raw, gaps, max_batch, budget)
        assert all(t.status == ACKED for t in tickets)
        views.append(([(t.ssn, t.ack_seq) for t in tickets], _state(be),
                      [d.read_all() for ds in _devices(be) for d in ds]))
    assert views[0] == views[1]


@pytest.mark.parametrize("seed", range(6))
def test_cut_invariance(seed, tmp_path):
    rng = random.Random(100 + seed)
    n = rng.randrange(2, 24)
    raw = _hot_schedule(rng, n)
    cfgs = [([rng.randrange(0, 3) for _ in range(n)], rng.choice([1, 2, 4, 64]), rng.choice([1, 2])),
            ([rng.randrange(0, 3) for _ in range(n)], rng.choice([1, 3, 8, 64]), rng.choice([1, 3]))]
    _check_cut_invariance(("vectorized", "kernel", "scalar")[seed % 3], tmp_path, raw, cfgs,
                          n_workers=rng.choice([1, 2]))


_SCHEDULE_ST = st.lists(
    st.tuples(st.lists(st.integers(0, READ_POOL - 1), max_size=2, unique=True),
              st.integers(0, 2), st.integers(1, 24)),
    min_size=1, max_size=16)


@settings(max_examples=20, deadline=None)
@given(sched=_SCHEDULE_ST, max_batch=st.sampled_from([1, 2, 4, 8]), budget=st.integers(1, 2),
       mode=st.sampled_from(["vectorized", "kernel", "scalar"]), n_workers=st.integers(1, 3))
def test_equivalence_hypothesis(sched, max_batch, budget, mode, n_workers):
    raw = [([key_of(j) for j in reads], [(key_of(1000 + i), bytes([i % 251] * vlen))])
           for i, (reads, _, vlen) in enumerate(sched)]
    with tempfile.TemporaryDirectory() as d:
        _check_equivalence(mode, Path(d), raw, [g for _, g, _ in sched], max_batch, budget,
                           n_workers)


# --- scheduler behaviours ---------------------------------------------------------

def _backend(tmp_path, n_workers=2, n_buffers=1):
    return _single("port-kernel-seg", tmp_path, n_workers, n_buffers, preload=False)


def _wspec(i, val=b"v"):
    return TxnSpec(writes=[(key_of(1000 + i), val)])


def test_cut_on_max_batch_and_latency_budget(tmp_path):
    sched = GroupCommitScheduler(_backend(tmp_path / "a"),
                                 ServeConfig(max_batch=4, latency_budget_steps=10**6))
    tickets = [sched.submit(_wspec(i)) for i in range(10)]
    sched.step()
    assert sched.n_cuts == 1 and [t.status for t in tickets[:4]] == [ACKED] * 4
    sched.step()
    sched.step()     # 2 left, below max_batch, budget out of reach: they wait
    assert sched.n_cuts == 2 and sched.stats()["queue_depth"] == 2
    sched.cfg.latency_budget_steps = 1
    sched.run_until_drained()
    assert all(t.status == ACKED for t in tickets)

    sched = GroupCommitScheduler(_backend(tmp_path / "b"),
                                 ServeConfig(max_batch=64, latency_budget_steps=3))
    t = sched.submit(_wspec(0))
    sched.step()
    sched.step()
    assert t.status != ACKED and sched.n_cuts == 0
    sched.step()
    assert sched.n_cuts == 1 and t.status == ACKED and t.latency() == 3.0


def test_cut_head_of_line_fifo(tmp_path):
    sched = GroupCommitScheduler(_backend(tmp_path), ServeConfig(max_batch=64))
    a = sched.submit(TxnSpec(writes=[(key_of(1), b"a")]))
    b = sched.submit(TxnSpec(writes=[(key_of(1), b"b")]))
    c = sched.submit(TxnSpec(writes=[(key_of(2), b"c")]))
    sched.step()
    assert sched.n_cut_txns == 1 and a.status == ACKED
    assert b.status != ACKED and c.status != ACKED
    sched.run_until_drained()
    assert [a.ack_seq, b.ack_seq, c.ack_seq] == [0, 1, 2]
    assert sched.backend.table.get(key_of(1))[0] == b"b"


def test_ack_gated_on_watermarks_partial_ticks(tmp_path):
    be = _backend(tmp_path, n_workers=2, n_buffers=2)
    sched = GroupCommitScheduler(be, ServeConfig(max_batch=8))
    w = sched.submit(TxnSpec(writes=[(key_of(1), b"w")]))
    r = sched.submit(TxnSpec(reads=[key_of(1)], writes=[(key_of(2), b"r")]))
    sched.step(tick_parts=[1])
    sched.step(tick_parts=[1])
    assert w.status == INFLIGHT and r.status == INFLIGHT
    sched.step()
    assert w.status == ACKED and r.status == INFLIGHT
    sched.step()
    assert r.status == ACKED and w.ack_seq < r.ack_seq


def test_admission_overflow_explicit_reject(tmp_path):
    sched = GroupCommitScheduler(_backend(tmp_path),
                                 ServeConfig(max_batch=2, queue_capacity=4))
    tickets = [sched.submit(_wspec(i)) for i in range(12)]
    assert [t.status for t in tickets[4:]] == [REJECTED] * 8
    sched.run_until_drained()
    assert Counter(t.status for t in tickets) == {ACKED: 4, REJECTED: 8}
    assert sched.n_admitted + sched.n_rejected == sched.n_submitted
    t = sched.submit(_wspec(99))
    sched.run_until_drained()
    assert t.status == ACKED


def test_retry_is_capacity_exempt(tmp_path):
    """A validation loser re-enters at the front of a queue that new
    arrivals filled to capacity, and acks before them."""
    be = _backend(tmp_path)
    tycsb.load(be.table, 4, seed=7)
    sched = GroupCommitScheduler(be, ServeConfig(max_batch=8, queue_capacity=2,
                                                 backoff_steps=1, max_retries=3))
    k = key_of(0)

    def rmw():
        val, ssn = be.table.get_or_insert(k)
        return TxnSpec(reads=[k], writes=[(k, val[:8] + b"!")], observed=[ssn])

    t1, t2 = sched.submit(make_spec=rmw), sched.submit(make_spec=rmw)
    sched.step()
    sched.step()     # t2's observed SSN is stale: it backs off
    assert t1.status == ACKED and sched.n_retries == 1 and t2.attempts == 2
    f1, f2, f3 = (sched.submit(_wspec(i)) for i in range(3))
    assert REJECTED not in (f1.status, f2.status) and f3.status == REJECTED
    sched.run_until_drained()
    assert t2.status == ACKED and t2.attempts == 2
    assert t2.ack_seq < f1.ack_seq < f2.ack_seq
    assert be.table.get(k)[0][:9].endswith(b"!")


def test_backoff_doubles_then_aborts(tmp_path):
    """A transaction that always loses waits 2, 4, then 8 steps before its
    retries and ends ABORTED after 1 + max_retries attempts."""
    be = _backend(tmp_path)
    tycsb.load(be.table, 1, seed=7)
    k = key_of(0)
    sched = GroupCommitScheduler(be, ServeConfig(max_batch=8, backoff_steps=2, max_retries=3))
    t = sched.submit(make_spec=lambda: TxnSpec(reads=[k], writes=[(k, b"x")], observed=[10**6]))
    waits = []
    while not t.done:
        attempts = t.attempts
        sched.step()
        if t.attempts != attempts:
            waits.append(t._backoff_until - sched.now_step)
        assert sched.now_step < 100
    assert waits == [2, 4, 8]
    assert t.status == ABORTED and t.attempts == 4 and sched.stats()["aborted"] == 1


def test_backpressure_max_unacked(tmp_path):
    sched = GroupCommitScheduler(_backend(tmp_path),
                                 ServeConfig(max_batch=2, max_unacked=2))
    tickets = [sched.submit(_wspec(i)) for i in range(6)]
    for _ in range(5):
        sched.step(tick_parts=[])
    st = sched.stats()
    assert st["max_unacked"] == 2 and st["queue_depth"] == 4
    sched.run_until_drained()
    assert all(t.status == ACKED for t in tickets) and sched.stats()["max_unacked"] == 2


def test_sharded_cross_shard_acks_after_sweep(tmp_path):
    be = ShardedBackend.make(n_shards=2, n_buffers=1, n_workers=2, device="cpu",
                             device_kind="null", device_dir=str(tmp_path))
    sched = GroupCommitScheduler(be, ServeConfig(max_batch=8))
    keys = [key_of(i) for i in range(40)]
    s0 = [k for k in keys if be.eng.shard_of(k) == 0]
    s1 = [k for k in keys if be.eng.shard_of(k) == 1]
    singles = [sched.submit(TxnSpec(writes=[(k, b"s-" + k.encode())])) for k in s0[:3] + s1[:3]]
    cross = sched.submit(TxnSpec(writes=[(s0[5], b"x0"), (s1[5], b"x1")]))
    sched.run_until_drained()
    assert all(t.status == ACKED for t in singles + [cross])
    assert cross.txn.committed and len(cross.txn.parts) == 2
    assert cross.ssn == max(p.ssn for p in cross.txn.parts)
    data = be.eng.to_dict()
    assert data[s0[5].encode()][0] == b"x0" and data[s1[5].encode()][0] == b"x1"
    assert len(sched.stats()["backend_queue_depths"]) == 2


def test_threaded_start_stop_quiesces(tmp_path):
    be = SingleBackend.make("kernel", n_workers=2, device="cpu", cfg=tcore.EngineConfig(
        n_buffers=2, device_kind="null", device_dir=str(tmp_path), device_clock="virtual",
        flush_interval=1e-3, logger_poll=1e-4))
    sched = GroupCommitScheduler(be, ServeConfig(latency_budget_s=1e-3, queue_capacity=10**6))
    sched.start()
    tickets = [sched.submit(_wspec(i), client_id=i) for i in range(50)]
    sched.stop(quiesce=True)
    assert all(t.status == ACKED for t in tickets)
    st = sched.stats()
    assert st["acked"] == 50 and st["exec_errors"] == 0 and sched._thread is None


# --- crashes under serving load ---------------------------------------------------

def _torn_record(key, cut=7):
    t = tcore.Txn(tid=777777, write_set=[(key, b"TORN-VALUE-NEVER-COMMITTED")])
    t.ssn = 1 << 40
    return t.encode()[:-cut]


def _check_acked(data, acked, unacked):
    for v, _ in data.values():
        assert v != b"TORN-VALUE-NEVER-COMMITTED" and not v.startswith(b"lost-")
    for t in acked:
        for k, v in t.spec.writes:
            assert data[k.encode()][0] == v, k
    for t in unacked:
        for k, v in t.spec.writes:
            got = data.get(k.encode())
            assert got is None or got[0] == v


def test_open_loop_kill_torn_tail(tmp_path):
    cfg = tcore.EngineConfig(n_buffers=2, device_kind="ssd", device_dir=str(tmp_path),
                             device_clock="real", flush_interval=1e-3, logger_poll=1e-4)
    be = SingleBackend.make("kernel", n_workers=2, cfg=cfg, device="cpu")
    sched = GroupCommitScheduler(be, ServeConfig(latency_budget_s=5e-4, queue_capacity=10**6))
    sched.start()
    tickets = []
    try:
        for i in range(120):
            tickets.append(sched.submit(TxnSpec(writes=[(key_of(2000 + i), b"val-%d" % i)]),
                                        client_id=i))
            time.sleep(2e-4)
    finally:
        sched.stop(quiesce=False)
    acked = [t for t in tickets if t.status == ACKED]
    assert acked, "no transaction acked before the kill"
    be.occ.execute_batch([TxnSpec(writes=[(key_of(9000 + i), b"lost-%d" % i)]) for i in range(4)])
    for d in be.engine.devices:
        d.close()
    with open(os.path.join(str(tmp_path), "log_0.bin"), "ab") as f:
        f.write(_torn_record(key_of(2000)))
    states = {mode: _recover("port", [be.engine.devices], mode, False)
              for mode in RECOVER_MODES["port"]}
    states["ref"] = _recover("ref", _reopen("ref", [be.engine.devices]), "vectorized", False)
    assert all(s == states["kernel"] for s in states.values())
    _check_acked(states["kernel"][0], acked, [t for t in tickets if t.status != ACKED])
    for t in acked:
        assert states["kernel"][0][t.spec.writes[0][0].encode()][1] == t.ssn


def test_stepped_sharded_kill_torn_tail(tmp_path):
    be = ShardedBackend.make(n_shards=2, n_buffers=1, n_workers=2, device="cpu",
                             device_kind="ssd", device_clock="virtual", device_dir=str(tmp_path))
    sched = GroupCommitScheduler(be, ServeConfig(max_batch=4))
    keys = [key_of(3000 + i) for i in range(30)]
    tickets = [sched.submit(TxnSpec(writes=[(k, b"s-" + k.encode())])) for k in keys]
    xk = [next(k for k in (key_of(4000 + i) for i in range(40)) if be.eng.shard_of(k) == s)
          for s in (0, 1)]
    tickets.append(sched.submit(TxnSpec(writes=[(xk[0], b"x0"), (xk[1], b"x1")])))
    for _ in range(4):
        sched.step()
    for _ in range(3):
        sched.step(tick_parts=[0])
    acked = [t for t in tickets if t.status == ACKED]
    unacked = [t for t in tickets if t.status != ACKED]
    assert acked and unacked, "want a genuine mid-drain kill"
    devs = _devices(be)
    s1 = next(k for k in keys if be.eng.shard_of(k) == 1)
    with open(os.path.join(str(tmp_path), "shard1", "log_0.bin"), "ab") as f:
        f.write(_torn_record(s1))
    states = {mode: tshard.recover_sharded(devs, parallel=False, mode=mode,
                                           **({"device": "cpu"} if mode == "kernel" else {}))
              for mode in RECOVER_MODES["port"]}
    ref = jshard.recover_sharded(_reopen("ref", devs), parallel=False)
    assert all(s.data == ref.data for s in states.values())
    _check_acked(states["kernel"].data, acked, unacked)
