"""The port's baseline engines, constraint-level checkers and TPC-C against
the reference's, exactly.

* Each engine (``CentrEngine``, ``SiloEngine``, ``NvmDEngine`` and
  ``PoplarEngine`` beside them) is fed one stepped stream of transactions —
  the same reads, writes, flush ticks, epoch advances and drains in both
  packages — and must hand out the same SSNs (LSNs, epochs, GSNs), commit the
  same transactions and write byte-identical device logs, which recover to
  the same image under either package in every mode.
* ``levels`` gives the same verdicts and violation strings on the Figure 1
  scenarios of ``tests/test_levels_property.py``, on random histories and on
  each engine's own history.
* TPC-C: both packages load the same table and generate the same specs from
  one seed; batches through both ``BatchOCC``s (the reference's
  ``vectorized`` and fused ``pallas``, the port's ``vectorized`` and
  ``kernel`` on ``device="cpu"``) give the same winners, tids, SSNs, tables
  and log bytes, and the logs recover under the other package.
* Two faults of the reference that the port keeps are pinned in both
  packages: baselines that commit what recovery skips above RSNe, and SILO's
  epoch ties, whose recovered value depends on the order of the devices.
"""

import random

import pytest

import repro.core as jcore
import repro.core.levels as jlevels
import repro.db as jdb
import repro.db.tpcc as jtpcc
import repro_torch.core as tcore
import repro_torch.core.levels as tlevels
import repro_torch.db as tdb
import repro_torch.db.tpcc as ttpcc
from repro_torch.core.storage import DeviceSpec, StorageDevice

PKGS = {"ref": (jcore, jdb, jtpcc, jlevels), "port": (tcore, tdb, ttpcc, tlevels)}
KEYS = [f"k{i}" for i in range(12)]
N_WORKERS = 4

# (reference mode, port mode) pairs recovered on both packages' logs
RECOVER_MODES = [("scalar", "scalar"), ("vectorized", "vectorized"), ("pallas", "kernel")]


def _recover(pkg, devices, mode, parallel=True):
    core = PKGS[pkg][0]
    kw = {"device": "cpu"} if mode == "kernel" else {}
    return core.recover(devices, parallel=parallel, mode=mode, **kw)


def _state(st):
    return st.data, st.rsns, st.rsne, st.n_replayed, st.n_skipped_uncommitted


def _port_devices(blobs):
    """In-memory port devices holding ``blobs`` (the other package's logs)."""
    out = []
    for blob in blobs:
        d = StorageDevice(DeviceSpec.null(), clock="virtual")
        d.write(blob)
        out.append(d)
    return out


# --- baseline engines: one stepped stream -------------------------------------

def _engine(pkg, kind):
    core = PKGS[pkg][0]
    # an effectively infinite flush interval keeps heartbeats and timed
    # forces out of the stream: every flush is an explicit tick below
    cfg = core.EngineConfig(n_buffers=2, device_kind="null", device_clock="virtual",
                            flush_interval=60.0)
    if kind == "centr":
        return core.CentrEngine(cfg)
    if kind == "silo":
        return core.SiloEngine(cfg, epoch_interval=3600)    # epochs advanced by hand
    if kind == "nvmd":
        return core.NvmDEngine(n_workers=N_WORKERS, n_devices=2, device_kind="null",
                               device_clock="virtual")
    return core.PoplarEngine(cfg)


class _Cell:
    __slots__ = ("ssn",)

    def __init__(self):
        self.ssn = 0


def _run_stream(pkg, kind, seed, n_txn=60):
    """Drive one engine through the seeded stream; returns the engine, the
    transactions, the tuple cells, the operation trace and the commit order."""
    core = PKGS[pkg][0]
    levels = PKGS[pkg][3]
    eng = _engine(pkg, kind)
    workers = [core.Worker(eng, i) for i in range(N_WORKERS)]
    cells = {k: _Cell() for k in KEYS}
    rng = random.Random(seed)
    txns, ops, commit_order = [], [], []
    seq = 0

    def drain():
        for w in workers:
            w.drain()
        for t in txns:
            if t.committed and t.tid not in commit_order:
                commit_order.append(t.tid)

    for i in range(n_txn):
        wid = rng.randrange(N_WORKERS)
        reads = rng.sample(KEYS, rng.randrange(0, 3))
        writes = rng.sample(KEYS, rng.randrange(0, 3))
        t = core.Txn(tid=100 + i)
        t.read_set = [(k, cells[k].ssn) for k in reads]
        t.write_set = [(k, f"{i}:{k}".encode() * rng.randrange(1, 4)) for k in writes]
        workers[wid].run(t, [cells[k] for k in reads], [cells[k] for k in writes])
        txns.append(t)
        for k in reads:
            ops.append(levels.Op(t.tid, "r", k, seq))
            seq += 1
        for k in writes:
            ops.append(levels.Op(t.tid, "w", k, seq))
            seq += 1
        step = rng.randrange(4)
        if kind == "silo" and rng.random() < 0.3:
            eng.advance_epoch()
        if step and kind != "nvmd":
            for b in ([0], [1], [0, 1])[step - 1]:
                if b < len(eng.buffers):
                    eng.logger_tick(b, force=True)
        drain()
    eng.quiesce(range(N_WORKERS))
    drain()
    for d in eng.devices:
        d.close()
    return eng, txns, cells, ops, commit_order


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("kind", ["centr", "silo", "nvmd", "poplar"])
def test_baseline_engine_logs_match_reference(kind, seed):
    ref = _run_stream("ref", kind, seed)
    port = _run_stream("port", kind, seed)
    (jeng, jtxns, jcells, _, jorder), (teng, ttxns, tcells, _, torder) = ref, port
    assert [(t.tid, t.ssn, t.buffer_id, t.committed) for t in jtxns] == \
        [(t.tid, t.ssn, t.buffer_id, t.committed) for t in ttxns]
    assert all(t.committed for t in ttxns)
    assert jorder == torder
    assert {k: c.ssn for k, c in jcells.items()} == {k: c.ssn for k, c in tcells.items()}
    assert jeng.txn_logged == teng.txn_logged and jeng.txn_committed == teng.txn_committed
    jlogs = [d.read_all() for d in jeng.devices]
    tlogs = [d.read_all() for d in teng.devices]
    assert tlogs == jlogs and any(tlogs)
    if kind == "silo":
        assert jeng.epoch == teng.epoch and jeng.durable_epoch == teng.durable_epoch
        assert len({t.ssn for t in ttxns}) > 1          # the stream spans epochs

    # the logs recover to the same image under both packages, every mode,
    # the port reading the reference's bytes and its own; SILO's epoch ties
    # make the scalar mode's parallel replay depend on thread order, so its
    # devices replay in order (test_silo_epoch_ties_recover_in_device_order)
    par = kind != "silo"
    for jmode, tmode in RECOVER_MODES:
        want = _state(_recover("ref", jeng.devices, jmode, par))
        assert want[0]
        assert _state(_recover("port", teng.devices, tmode, par)) == want, (jmode, tmode)
        assert _state(_recover("port", _port_devices(jlogs), tmode, par)) == want, \
            (jmode, tmode)


@pytest.mark.parametrize("kind", ["centr", "silo", "nvmd", "poplar"])
def test_levels_verdicts_on_engine_histories_match(kind):
    """Each engine's history (SSNs, commit order, derived dependencies) gets
    the same verdict strings from both packages' checkers."""
    verdicts = {}
    for pkg in PKGS:
        levels = PKGS[pkg][3]
        _, txns, _, ops, order = _run_stream(pkg, kind, seed=3)
        deps = levels.derive_deps(ops)
        seqs = {tid: i for i, tid in enumerate(order)}
        infos = {t.tid: levels.TxnInfo(t.tid, t.ssn, seqs.get(t.tid), deps.get(t.tid, []))
                 for t in txns}
        verdicts[pkg] = [
            [str(x) for x in fn(infos)]
            for fn in (levels.check_recoverability, levels.check_rigorousness,
                       levels.check_sequentiality)
        ]
    assert verdicts["port"] == verdicts["ref"]


# --- levels: Figure 1 scenarios and random histories ---------------------------

# (tid, ssn, commit_seq, deps as (pred, kind name)) — the eight scenarios of
# Figure 1 and the sequentiality case, as in tests/test_levels_property.py
FIG1 = [
    [(1, 1, 0, []), (2, 2, 1, [(1, "RAW")])],
    [(1, 5, 0, []), (2, 3, 1, [(1, "RAW")])],
    [(1, 5, 1, []), (2, 3, 0, [(1, "RAW")])],
    [(2, 1, 0, []), (3, 2, 1, [(2, "WAW")])],
    [(2, 4, 0, []), (3, 2, 1, [(2, "WAW")])],
    [(2, 1, 1, []), (3, 2, 0, [(2, "WAW")])],
    [(2, 1, 0, []), (4, 2, 1, [(2, "WAR")])],
    [(2, 3, 1, []), (4, 1, 0, [(2, "WAR")])],
    [(1, 1, 0, []), (2, 3, 1, []), (3, 2, 2, [])],
]


def _infos(levels, rows):
    return {tid: levels.TxnInfo(tid, ssn, cseq, [(p, levels.Dep[k]) for p, k in deps])
            for tid, ssn, cseq, deps in rows}


def _verdicts(levels, rows):
    infos = _infos(levels, rows)
    return [fn(infos) for fn in (levels.check_recoverability, levels.check_rigorousness,
                                 levels.check_sequentiality)]


@pytest.mark.parametrize("case", range(len(FIG1)))
def test_levels_figure1_scenarios_match(case):
    assert _verdicts(tlevels, FIG1[case]) == _verdicts(jlevels, FIG1[case])


def _random_history(seed):
    rng = random.Random(seed)
    n = rng.randrange(2, 14)
    ops, seq = [], 0
    for _ in range(rng.randrange(1, 40)):
        ops.append((rng.randrange(n), rng.choice("rw"), rng.choice("abcde"), seq))
        seq += 1
    order = list(range(n))
    rng.shuffle(order)
    rows = [(tid, rng.randrange(1, 20), order[tid] if rng.random() < 0.8 else None)
            for tid in range(n)]
    return ops, rows


@pytest.mark.parametrize("seed", range(6))
def test_levels_random_histories_match(seed):
    ops, rows = _random_history(seed)
    out = {}
    for name, levels in (("ref", jlevels), ("port", tlevels)):
        deps = levels.derive_deps([levels.Op(*o) for o in ops])
        flat = {tid: [(p, k.name) for p, k in d] for tid, d in deps.items()}
        full = [(tid, ssn, cseq, flat.get(tid, [])) for tid, ssn, cseq in rows]
        out[name] = (flat, _verdicts(levels, full))
    assert out["port"] == out["ref"]


# --- TPC-C ---------------------------------------------------------------------

TPCC_W = 2
# name -> (package, mode, fused_min_lanes); the first is the yardstick
TPCC_EXECUTORS = {
    "ref-vectorized": ("ref", "vectorized", None),
    "ref-pallas-fused": ("ref", "pallas", 0),
    "port-vectorized": ("port", "vectorized", None),
    "port-kernel-fused": ("port", "kernel", 0),
}


def test_tpcc_load_and_specs_match():
    """Both packages load the same rows and draw the same Payment/NewOrder
    specs from one seed, over the dict table and the columnar one."""
    tabs = {}
    for pkg in PKGS:
        db, tpcc = PKGS[pkg][1], PKGS[pkg][2]
        tab, arr = db.Table(), db.ArrayTable()
        tpcc.load(tab, warehouses=TPCC_W, seed=11)
        tpcc.load(arr, warehouses=TPCC_W, seed=11)
        gen, agen = tpcc.TPCC(tab, TPCC_W, seed=4), tpcc.TPCC(arr, TPCC_W, seed=4)
        specs = [gen.next_spec() for _ in range(40)]
        specs += agen.next_batch(40, lookup=arr.get_or_insert)
        tabs[pkg] = (arr.to_dict(), arr.n,
                     [(s.reads, s.writes, s.observed) for s in specs])
    assert tabs["port"] == tabs["ref"]
    assert tabs["port"][1] == ttpcc.ITEMS + TPCC_W * (
        1 + ttpcc.DISTRICTS * (1 + ttpcc.CUSTOMERS) + ttpcc.ITEMS)


def _tpcc_executor(name, path):
    pkg, mode, min_lanes = TPCC_EXECUTORS[name]
    core, db, tpcc, _ = PKGS[pkg]
    path.mkdir()
    eng = core.PoplarEngine(core.EngineConfig(
        n_buffers=2, device_kind="null", device_dir=str(path), device_clock="virtual",
        flush_interval=60.0))
    tab = db.ArrayTable()
    tpcc.load(tab, warehouses=TPCC_W, seed=11)
    kw = {"device": "cpu"} if mode == "kernel" else {}
    occ = db.BatchOCC(tab, eng, n_workers=N_WORKERS, mode=mode, **kw)
    if min_lanes is not None:
        occ.fused_min_lanes = min_lanes
    return occ, tpcc.TPCC(tab, TPCC_W, seed=9)


def test_tpcc_batches_match_reference(tmp_path):
    execs = {name: _tpcc_executor(name, tmp_path / name) for name in TPCC_EXECUTORS}
    n_committed = 0
    for step in range(3):
        results, specs = {}, {}
        for name, (occ, gen) in execs.items():
            # each executor draws from its own generator over its own table:
            # losers are regenerated from the values the winners left
            batch = gen.next_batch(300, lookup=occ.table.get_or_insert)
            specs[name] = [(s.reads, s.writes, s.observed) for s in batch]
            results[name] = occ.execute_batch(batch, max_rounds=3)
            occ.drain()
        want = results["ref-vectorized"]
        assert want.committed and want.aborted          # TPC-C's hot rows contend
        n_committed += len(want.committed)
        for name, got in results.items():
            assert specs[name] == specs["ref-vectorized"], (name, step)
            assert got.committed_idx == want.committed_idx, (name, step)
            assert got.aborted == want.aborted and got.rounds == want.rounds, (name, step)
            assert [(t.tid, t.ssn, t.worker_id, t.write_set) for t in got.committed] == \
                [(t.tid, t.ssn, t.worker_id, t.write_set) for t in want.committed], (name, step)
    assert n_committed > 20

    logs = {}
    for name, (occ, _) in execs.items():
        occ.engine.quiesce(range(N_WORKERS))
        for d in occ.engine.devices:
            d.close()
        logs[name] = [d.read_all() for d in occ.engine.devices]
        assert occ.table.to_dict() == execs["ref-vectorized"][0].table.to_dict(), name
        assert logs[name] == logs["ref-vectorized"], name

    # cross-recovery: the port recovers the reference's logs and vice versa
    jdevs = execs["ref-vectorized"][0].engine.devices
    tdevs = execs["port-kernel-fused"][0].engine.devices
    want = _state(_recover("ref", jdevs, "vectorized"))
    assert len(want[0]) > 0
    for _, tmode in RECOVER_MODES:
        assert _state(_recover("port", jdevs, tmode)) == want, tmode
        assert _state(_recover("port", tdevs, tmode)) == want, tmode
    assert _state(_recover("ref", tdevs, "pallas")) == want


# --- a fault of the reference, kept: committed baseline txns above RSNe ------------

def _above_rsne_case(pkg, kind):
    """The smallest stream found in which a baseline commits a transaction
    with reads that ``recover`` does not replay: its SSN lies above RSNe, the
    minimum over devices of each device's newest SSN, because the other device
    saw no later record (the baselines emit no heartbeats)."""
    core = PKGS[pkg][0]
    cells = {k: _Cell() for k in ("a", "b")}
    if kind == "silo":
        eng = core.SiloEngine(core.EngineConfig(n_buffers=2, device_kind="null",
                                                device_clock="virtual", flush_interval=60.0),
                              epoch_interval=3600)
        w0, w1 = core.Worker(eng, 0), core.Worker(eng, 1)
        w1.run(core.Txn(tid=1, write_set=[("a", b"1")]), [], [cells["a"]])      # epoch 1, device 1
        eng.advance_epoch()
    else:
        eng = core.NvmDEngine(n_workers=2, n_devices=2, device_kind="null",
                              device_clock="virtual")
        w0, w1 = core.Worker(eng, 0), core.Worker(eng, 1)
        w1.run(core.Txn(tid=1, write_set=[("a", b"1")]), [], [cells["a"]])      # GSN 1, device 1
        w0.run(core.Txn(tid=2, write_set=[("b", b"2")]), [], [cells["b"]])      # GSN 1, device 0
    t = core.Txn(tid=3, read_set=[("a", cells["a"].ssn)], write_set=[("b", b"3")])
    w0.run(t, [cells["a"]], [cells["b"]])                                       # device 0, reads a
    eng.quiesce([0, 1])
    st = core.recover(eng.devices, mode="vectorized")
    return t.committed, t.ssn, st.rsne, st.data.get(b"b"), st.n_skipped_uncommitted



@pytest.mark.parametrize("kind", ["silo", "nvmd"])
def test_baseline_commit_above_rsne_is_the_references(kind):
    """SILO and NVM-D commit a transaction with reads that recovery then
    skips: both packages commit it, skip it and recover the same image."""
    ref, port = _above_rsne_case("ref", kind), _above_rsne_case("port", kind)
    assert port == ref
    committed, ssn, rsne, b_value, skipped = port
    assert committed and ssn > rsne and skipped == 1
    assert b_value != (b"3", ssn)


# --- a fault of the reference, kept: SILO's epoch ties ---------------------------

@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_silo_epoch_ties_recover_in_device_order(pkg):
    """SILO's SSN is its epoch, so two writes of one key in one epoch tie.
    Every recovery mode keeps the tied record of the first device it replays,
    not the later commit: in device order the first write, in reverse order
    the second.  The scalar mode's parallel replay, one thread per device,
    keeps whichever thread came first."""
    core = PKGS[pkg][0]
    eng = core.SiloEngine(core.EngineConfig(n_buffers=2, device_kind="null",
                                            device_clock="virtual", flush_interval=60.0),
                          epoch_interval=3600)
    cell = _Cell()
    first = core.Txn(tid=1, write_set=[("x", b"A")])
    core.Worker(eng, 0).run(first, [], [cell])                       # device 0
    second = core.Txn(tid=2, write_set=[("x", b"B")])
    core.Worker(eng, 1).run(second, [], [cell])                      # device 1
    eng.advance_epoch()
    eng.quiesce([0, 1])
    assert first.committed and second.committed
    assert (first.ssn, second.ssn, first.buffer_id, second.buffer_id) == (1, 1, 0, 1)
    for mode in (("scalar", "vectorized", "pallas") if pkg == "ref"
                 else ("scalar", "vectorized", "kernel")):
        assert _recover(pkg, eng.devices, mode, False).data[b"x"] == (b"A", 1), mode
        assert _recover(pkg, eng.devices[::-1], mode, False).data[b"x"] == (b"B", 1), mode
