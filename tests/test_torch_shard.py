"""The port's sharded engine and sharded recovery against the reference's,
exactly.

* ``Router.shard_of`` and ``split`` agree on random keys and specs.
* The same batches through both packages' ``ShardedEngine``s (the
  reference's ``vectorized``, the port's ``kernel`` on ``device="cpu"`` with
  the fused round forced, and its ``vectorized``) give the same winners,
  tids, SSNs and cross-shard gtids, and byte-identical per-shard logs,
  ``FLAG_XSHARD`` records included.
* The three cut cases and the crash-point property of
  ``tests/test_sharded_recovery.py`` run in both packages; every
  ``recover_sharded`` mode of both (the reference's ``scalar``,
  ``vectorized`` and ``pallas``, the port's ``scalar``, ``vectorized`` and
  ``kernel`` on the CPU) gives the same ``ShardedRecoveredState``, and each
  package recovers the other's device files to it.
"""

import random

import pytest

import repro.db as jdb
import repro.shard as jshard
import repro_torch.db as tdb
import repro_torch.shard as tshard
from repro.core.storage import DeviceSpec as JDeviceSpec
from repro.core.storage import StorageDevice as JStorageDevice
from repro_torch.core.storage import DeviceSpec, StorageDevice

# name -> (package, engine mode, fused_min_lanes)
ENGINES = {
    "ref": ("ref", "vectorized", None),
    "port-kernel": ("port", "kernel", 0),
    "port-vectorized": ("port", "vectorized", None),
}
PKG = {"ref": (jdb, jshard, JStorageDevice, JDeviceSpec),
       "port": (tdb, tshard, StorageDevice, DeviceSpec)}
RECOVER_MODES = {"ref": ("scalar", "vectorized", "pallas"),
                 "port": ("scalar", "vectorized", "kernel")}


def _mk(name, path, **kw):
    pkg, mode, min_lanes = ENGINES[name]
    shard = PKG[pkg][1]
    cfg = dict(n_shards=2, n_buffers=1, n_workers=2, device_kind="ssd",
               device_clock="virtual", device_dir=str(path), mode=mode)
    if pkg == "port" and mode == "kernel":
        cfg["device"] = "cpu"
    cfg.update(kw)
    eng = shard.ShardedEngine(shard.ShardedConfig(**cfg))
    if min_lanes is not None:
        for sh in eng.shards:
            sh.occ.fused_min_lanes = min_lanes
    return eng


def _specs(pkg, raw):
    """``raw`` = [(reads, writes)] as one package's ``TxnSpec``s."""
    spec = PKG[pkg][0].TxnSpec
    return [spec(reads=list(r), writes=list(w)) for r, w in raw]


def _recover(pkg, shard_devices, mode):
    kw = {"device": "cpu"} if mode == "kernel" else {}
    return PKG[pkg][1].recover_sharded(shard_devices, parallel=False, mode=mode, **kw)


def _state(st):
    return (st.n_cross_seen, st.n_cross_dropped,
            [(s.data, s.rsns, s.rsne, s.n_replayed, s.n_skipped_uncommitted)
             for s in st.shards])


def _reopen(pkg, eng):
    """``pkg``'s devices opened on the files another package's engine wrote."""
    _, _, dev_cls, spec_cls = PKG[pkg]
    return [[dev_cls(spec_cls.ssd(), path=d.path, clock="virtual") for d in devs]
            for devs in eng.devices]


def _assert_recoveries_agree(engines):
    """Every mode of both packages, on every engine's own devices and on the
    other package's files, gives the first engine's vectorized state."""
    for devs in engines.values():
        for d in (d for ds in devs.devices for d in ds):
            d.close()
    want = _state(_recover("ref", engines["ref"].devices, "vectorized"))
    for name, eng in engines.items():
        pkg = ENGINES[name][0]
        other = "port" if pkg == "ref" else "ref"
        for mode in RECOVER_MODES[pkg]:
            assert _state(_recover(pkg, eng.devices, mode)) == want, (name, mode)
        for mode in RECOVER_MODES[other]:
            assert _state(_recover(other, _reopen(other, eng), mode)) == want, (name, mode)
    return want


def _keys_by_shard(eng, n):
    out = [[] for _ in range(eng.cfg.n_shards)]
    for i in range(n):
        k = f"user{i:010d}"
        out[eng.shard_of(k)].append(k)
    return out


# --- router --------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 7])
def test_router_matches_reference(n_shards):
    rng = random.Random(n_shards)
    keys = [f"user{rng.randrange(10 ** 9):010d}" for _ in range(300)] + ["", "W:1", "ü"]
    jr, tr = jshard.Router(n_shards), tshard.Router(n_shards)
    assert [tr.shard_of(k) for k in keys] == [jr.shard_of(k) for k in keys]
    raw = [(rng.sample(keys, rng.randrange(0, 3)),
            [(k, b"v") for k in rng.sample(keys, rng.randrange(1, 4))]) for _ in range(80)]
    jper, jcross = jr.split(_specs("ref", raw))
    tper, tcross = tr.split(_specs("port", raw))
    assert {p: [(i, s.reads, s.writes) for i, s in v] for p, v in tper.items()} == \
        {p: [(i, s.reads, s.writes) for i, s in v] for p, v in jper.items()}
    assert [(i, s.reads, sh) for i, s, sh in tcross] == [(i, s.reads, sh) for i, s, sh in jcross]
    assert n_shards == 1 or tcross


# --- sharded batches: results and per-shard logs --------------------------------

def _random_batches(rng, keys, n_batches):
    """``tests/test_sharded_recovery.py``'s batches: keys unique within a
    batch, repeated across batches; 2-key specs may span shards."""
    out = []
    for _ in range(n_batches):
        ks = rng.sample(keys, rng.randrange(4, min(12, len(keys))))
        raw = []
        while ks:
            nw = rng.choice([1, 1, 2])
            grp, ks = ks[:nw], ks[nw:]
            reads = [grp[0]] if rng.random() < 0.3 else []
            raw.append((reads, [(k, f"{k}@{rng.randrange(1 << 20)}".encode()) for k in grp]))
        out.append(raw)
    return out


def _result(res):
    return (res.committed_idx, sorted(res.aborted), res.cross_idx,
            [(t.tid, t.ssn, t.worker_id, t.write_set) for t in res.committed],
            [(x.gtid, x.has_reads, [(p.shard, p.ssn, p.buffer_id) for p in x.parts])
             for x in res.cross])


@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_batches_match_reference(tmp_path, n_shards):
    engines = {name: _mk(name, tmp_path / name, n_shards=n_shards, n_buffers=2)
               for name in ENGINES}
    rng = random.Random(7 + n_shards)
    keys = [f"user{i:010d}" for i in range(40)]
    for eng in engines.values():
        for k in keys[:20]:
            eng.insert(k, b"init")
    n_cross = 0
    for raw in _random_batches(rng, keys, 6):
        out = {}
        for name, eng in engines.items():
            res = eng.execute_batch(_specs(ENGINES[name][0], raw))
            eng.tick(force=True)
            eng.drain()
            out[name] = _result(res)
        for name in engines:
            assert out[name] == out["ref"], name
        n_cross += len(out["ref"][2])
    assert n_cross > 0
    for eng in engines.values():
        eng.quiesce()
    stats = {name: (eng.stats()["cross_committed"], eng.stats()["txn_committed"])
             for name, eng in engines.items()}
    assert len(set(stats.values())) == 1
    for name, eng in engines.items():
        assert eng.to_dict() == engines["ref"].to_dict(), name
        for p, devs in enumerate(eng.devices):
            assert [d.read_all() for d in devs] == \
                [d.read_all() for d in engines["ref"].devices[p]], (name, p)
    state = _assert_recoveries_agree(engines)
    assert state[0] == n_cross and state[1] == 0


# --- the three cut cases --------------------------------------------------------

def _cut_keeps_fully_durable(eng, ks, specs):
    res = eng.execute_batch(specs([([], [(ks[0][0], b"X0"), (ks[1][0], b"X1")])]))
    assert len(res.cross) == 1
    eng.tick(force=True)     # durable on both shards; never swept


def _cut_drops_partially_durable(eng, ks, specs):
    eng.insert(ks[0][0], b"old0")
    eng.insert(ks[1][0], b"old1")
    eng.execute_batch(specs([([], [(ks[0][1], b"solo")])]))
    res = eng.execute_batch(specs([([], [(ks[0][0], b"X0"), (ks[1][0], b"X1")])]))
    assert len(res.cross) == 1
    for i in range(len(eng.shards[0].engine.buffers)):   # only shard 0 flushes
        eng.shards[0].engine.logger_tick(i, force=True)
    eng.drain()


def _raw_cross_needs_rsne(eng, ks, specs):
    eng.insert(ks[0][0], b"old0")
    res = eng.execute_batch(specs([([ks[1][0]], [(ks[0][0], b"X0"), (ks[1][1], b"X1")])]))
    for part in res.cross[0].parts:     # the sibling buffers stay behind
        sh = eng.shards[part.shard]
        sh.engine.buffers[part.buffer_id].force_establish()
        sh.engine.buffers[part.buffer_id].flush_ready(sh.engine.devices[part.buffer_id])


CUT_CASES = {
    "keeps_fully_durable": (_cut_keeps_fully_durable, {}, (1, 0)),
    "drops_partially_durable": (_cut_drops_partially_durable, {}, (1, 1)),
    "raw_cross_needs_rsne": (_raw_cross_needs_rsne, {"n_buffers": 2}, (1, 1)),
}


@pytest.mark.parametrize("case", sorted(CUT_CASES))
def test_cut_cases_match_reference(tmp_path, case):
    fn, kw, (seen, dropped) = CUT_CASES[case]
    engines = {name: _mk(name, tmp_path / name, **kw) for name in ENGINES}
    for name, eng in engines.items():
        fn(eng, _keys_by_shard(eng, 40), lambda raw, p=ENGINES[name][0]: _specs(p, raw))
    state = _assert_recoveries_agree(engines)
    assert state[:2] == (seen, dropped)


# --- crash-at-arbitrary-point property ------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_sharded_crash_point_property_matches_reference(tmp_path, seed):
    """``tests/test_sharded_recovery.py::test_sharded_crash_recovery_property``
    run in both packages from one seed: the same acknowledged transactions,
    the same crash image in every mode, and after a full quiesce the same
    image again, equal to the live sharded state."""
    rng = random.Random(100 + seed)
    n_shards, n_buffers = rng.choice([2, 3]), rng.choice([1, 2])
    batches = _random_batches(rng, [f"user{i:010d}" for i in range(16)], 5)
    crash_after = rng.randrange(0, len(batches) + 1)
    engines = {name: _mk(name, tmp_path / name, n_shards=n_shards, n_buffers=n_buffers)
               for name in ENGINES}
    acked = {}
    for name, eng in engines.items():
        for i in range(8):
            eng.insert(f"user{i:010d}", b"init")
        acked[name] = []
        for bi, raw in enumerate(batches):
            res = eng.execute_batch(_specs(ENGINES[name][0], raw))
            if bi < crash_after:
                eng.tick(force=True)
                eng.tick(force=True)
                eng.drain()
                acked[name] += [t.tid for t in res.committed if t.committed]
                acked[name] += [x.gtid for x in res.cross if x.committed]
    assert all(a == acked["ref"] for a in acked.values())
    crash_state = {name: [[d.read_all() for d in ds] for ds in eng.devices]
                   for name, eng in engines.items()}
    assert all(c == crash_state["ref"] for c in crash_state.values())

    # the crash image, in every mode and across packages (reopened files)
    want = {}
    for name, eng in engines.items():
        pkg = ENGINES[name][0]
        for mode in RECOVER_MODES[pkg]:
            want.setdefault("crash", _state(_recover(pkg, eng.devices, mode)))
            assert _state(_recover(pkg, eng.devices, mode)) == want["crash"], (name, mode)

    for eng in engines.values():
        eng.quiesce()
    full = _assert_recoveries_agree(engines)
    live = engines["port-kernel"].to_dict()
    merged = {}
    for shard_data in full[2]:
        merged.update(shard_data[0])
    assert all(live[k] == v for k, v in merged.items())
