"""The port's replicas against the reference's recovery, exactly.

Both packages' primaries run one seeded stream (random reads and writes,
random partial flushes, a crash without quiescing); each is followed live by
its own package's replica, polled mid-stream.  Then:

* the port's ``Replica.promote()`` equals ``recover()`` of either package —
  data with SSNs, RSNs, RSNe, replayed and skipped counts — in each of the
  port's apply modes (``kernel`` on ``device="cpu"``, ``vectorized``,
  ``scalar``), and equals the reference replica's ``promote()``;
* a port replica reopened on the reference's files (and seeded from the
  reference's checkpoint) promotes to the same state;
* ``ShardedReplica.promote()`` equals ``recover_sharded`` of either package,
  cross-shard cut statistics included;
* a torn trailing frame is retried by the port's shipper and never decoded,
  and every apply mode still promotes to recovery's state.
"""

import os
import random

import pytest

import repro.core as jcore
import repro.db as jdb
import repro.replica as jreplica
import repro.shard as jshard
import repro_torch.core as tcore
import repro_torch.db as tdb
import repro_torch.replica as treplica
import repro_torch.shard as tshard

PKG = {"ref": (jcore, jdb, jshard, jreplica), "port": (tcore, tdb, tshard, treplica)}
PORT_MODES = ("kernel", "vectorized", "scalar")
REF_MODES = ("vectorized", "pallas", "scalar")
KEYS = [f"k{i}" for i in range(10)]


def _kw(mode):
    return {"device": "cpu"} if mode == "kernel" else {}


def _state(st):
    return st.data, st.rsns, st.rsne, st.n_replayed, st.n_skipped_uncommitted


def _sharded_state(st):
    return st.n_cross_seen, st.n_cross_dropped, [_state(s) for s in st.shards]


def _recover(pkg, devices, mode, ckpt=None):
    return PKG[pkg][0].recover(devices, checkpoint_dir=ckpt, parallel=False, mode=mode,
                               **_kw(mode))


class _Cell:
    __slots__ = ("ssn",)

    def __init__(self):
        self.ssn = 0


def _drive_primary(pkg, engine, seed, n_txns, replica=None, workers=None, cells=None):
    """``tests/test_replica.py``'s random mixed workload with random partial
    flushes, polling ``replica`` mid-stream (watermark monotone, no
    HAS_READS record applied above it)."""
    core = PKG[pkg][0]
    rng, poll_rng = random.Random(seed), random.Random(seed + 1000)
    wm_prev = 0
    for i in range(n_txns):
        reads = rng.sample(KEYS, rng.randrange(0, 3))
        writes = rng.sample(KEYS, rng.randrange(0, 3))
        t = core.Txn(tid=1000 + i, read_set=[(k, cells[k].ssn) for k in reads],
                     write_set=[(k, f"{i}/{k}".encode()) for k in writes])
        workers[rng.randrange(len(workers))].run(
            t, [cells[k] for k in reads], [cells[k] for k in writes])
        if rng.random() < 0.4:
            for b in range(len(engine.buffers)):
                if rng.random() < 0.6:
                    engine.logger_tick(b, force=True)
        if replica is not None and poll_rng.random() < 0.4:
            replica.poll()
            wm = replica.visible_ssn()
            assert wm >= wm_prev and replica.applier.max_qwr_applied <= wm
            wm_prev = wm


def _primary(pkg, path, n_buffers, kind="null"):
    core = PKG[pkg][0]
    eng = core.PoplarEngine(core.EngineConfig(n_buffers=n_buffers, device_kind=kind,
                                              device_dir=str(path), device_clock="virtual",
                                              flush_interval=60.0))
    return eng, [core.Worker(eng, i) for i in range(n_buffers * 2)], \
        {k: _Cell() for k in KEYS}


def _reopen(pkg, devices):
    core = PKG[pkg][0]
    return [core.StorageDevice(core.DeviceSpec.null(), path=d.path, clock="virtual")
            for d in devices]


@pytest.mark.parametrize("mode", PORT_MODES)
@pytest.mark.parametrize("seed", [0, 1])
def test_promote_equals_recover_of_either_package(mode, seed, tmp_path):
    n_buffers = random.Random(seed).choice([1, 2, 3])
    runs = {}
    for pkg, rmode in (("ref", "vectorized"), ("port", mode)):
        eng, workers, cells = _primary(pkg, tmp_path / pkg, n_buffers)
        rep = PKG[pkg][3].Replica(eng.devices, mode=rmode, parallel=False, **_kw(rmode))
        _drive_primary(pkg, eng, seed, 80, rep, workers, cells)
        for d in eng.devices:
            d.close()
        runs[pkg] = (eng, rep.promote(), rep)
    (jeng, jst, _), (teng, tst, trep) = runs["ref"], runs["port"]
    assert [d.read_all() for d in teng.devices] == [d.read_all() for d in jeng.devices]
    want = _state(jst)
    assert want[0] and all(s.n_polls > 1 for s in trep.shippers)
    assert _state(tst) == want
    for m in REF_MODES:
        assert _state(_recover("ref", jeng.devices, m)) == want, m
    for m in PORT_MODES:
        assert _state(_recover("port", teng.devices, m)) == want, m
    # a port replica started afterwards on the reference's files
    late = treplica.Replica(_reopen("port", jeng.devices), mode=mode, parallel=False,
                            **_kw(mode))
    assert _state(late.promote()) == want


@pytest.mark.parametrize("mode", PORT_MODES)
def test_checkpoint_catchup_from_reference_checkpoint(mode, tmp_path):
    """A port replica seeded from the reference's fuzzy checkpoint and shipped
    the reference's log promotes to checkpoint+log recovery of both."""
    eng, workers, cells = _primary("ref", tmp_path / "dev", 2)
    _drive_primary("ref", eng, 3, 40, workers=workers, cells=cells)
    eng.quiesce(range(2))
    for b in range(2):
        eng.logger_tick(b, force=True)
    ck_dir = str(tmp_path / "ckpt")
    ck = jcore.CheckpointDaemon(ck_dir, n_threads=1, m_files=2,
                                csn_fn=eng.commit.advance_csn)
    ck.run_once([iter([(k.encode(), f"ck/{k}".encode(), cells[k].ssn) for k in KEYS])],
                validate_timeout=5.0, epoch=1)
    _drive_primary("ref", eng, 4, 40, workers=workers, cells=cells)
    for d in eng.devices:
        d.close()
    want = _state(_recover("ref", eng.devices, "vectorized", ck_dir))
    rep = treplica.Replica(_reopen("port", eng.devices), checkpoint_dir=ck_dir, mode=mode,
                           parallel=False, **_kw(mode))
    assert _state(rep.promote()) == want
    assert _state(_recover("port", _reopen("port", eng.devices), mode, ck_dir)) == want


def _drive_sharded(pkg, eng, rep, seed, rounds, keys, by_shard):
    spec = PKG[pkg][1].TxnSpec
    rng, poll_rng = random.Random(seed), random.Random(seed + 1000)
    for r in range(rounds):
        specs = [spec(writes=[(k, f"{k}r{r}".encode())]) for k in keys]
        specs.append(spec(writes=[(by_shard[0][0], f"x0r{r}".encode()),
                                  (by_shard[1][0], f"x1r{r}".encode())]))
        specs.append(spec(reads=[by_shard[0][1]], writes=[(by_shard[1][1], f"xr{r}".encode())]))
        eng.execute_batch(specs)
        for sh in eng.shards:
            for i in range(len(sh.engine.buffers)):
                if rng.random() < 0.7:
                    sh.engine.logger_tick(i, force=True)
        eng.drain()
        if poll_rng.random() < 0.7:
            rep.poll()


@pytest.mark.parametrize("mode", PORT_MODES)
def test_sharded_promote_equals_recover_sharded_of_either_package(mode, tmp_path):
    runs = {}
    for pkg, rmode in (("ref", "vectorized"), ("port", mode)):
        core, shard = PKG[pkg][0], PKG[pkg][2]
        kw = {"mode": "vectorized"} if pkg == "ref" else {"mode": "kernel", "device": "cpu"}
        # null devices flush inline on drain() once the flush interval has
        # passed: an effectively infinite one leaves only the forced ticks,
        # so both packages flush at the same points
        eng = shard.ShardedEngine(shard.ShardedConfig(
            n_shards=2, n_workers=2, device_dir=str(tmp_path / pkg), **kw,
            engine=core.EngineConfig(n_buffers=2, device_kind="null", device_clock="virtual",
                                     flush_interval=60.0)))
        keys = [f"user{i:06d}" for i in range(20)]
        by_shard = [[], []]
        for k in keys:
            by_shard[eng.shard_of(k)].append(k)
        rep = PKG[pkg][3].ShardedReplica(eng.devices, mode=rmode, parallel=False, **_kw(rmode))
        _drive_sharded(pkg, eng, rep, 11, 6, keys, by_shard)
        for devs in eng.devices:        # crash without quiescing
            for d in devs:
                d.close()
        runs[pkg] = (eng, rep.promote(), rep, keys)
    (jeng, jst, _, keys), (teng, tst, trep, _) = runs["ref"], runs["port"]
    want = _sharded_state(jst)
    assert want[0] > 0
    assert _sharded_state(tst) == want
    for m in REF_MODES:
        assert _sharded_state(jshard.recover_sharded(jeng.devices, parallel=False,
                                                     mode=m)) == want, m
    for m in PORT_MODES:
        got = tshard.recover_sharded(teng.devices, parallel=False, mode=m, **_kw(m))
        assert _sharded_state(got) == want, m
        reopened = [_reopen("port", devs) for devs in jeng.devices]
        got = tshard.recover_sharded(reopened, parallel=False, mode=m, **_kw(m))
        assert _sharded_state(got) == want, m
    merged = tst.data
    for k in keys:
        assert trep.read(k) == merged.get(k.encode())


@pytest.mark.parametrize("mode", PORT_MODES)
def test_torn_tail_is_retried_never_decoded(mode, tmp_path):
    eng, workers, cells = _primary("port", tmp_path, 2, kind="ssd")
    _drive_primary("port", eng, 5, 30, workers=workers, cells=cells)
    eng.quiesce(range(2))
    for d in eng.devices:
        d.close()
    torn = tcore.Txn(tid=777, write_set=[("k0", b"TORN-NEVER-COMMITTED")])
    torn.ssn = 1 << 40
    with open(os.path.join(str(tmp_path), "log_0.bin"), "ab") as f:
        f.write(torn.encode()[:-7])

    rep = treplica.Replica(eng.devices, mode=mode, parallel=False, **_kw(mode))
    rep.poll()
    consumed = rep.shippers[0].consumed
    rep.poll()                     # the torn tail is retried, not consumed
    assert rep.shippers[0].consumed == consumed
    assert consumed < os.path.getsize(os.path.join(str(tmp_path), "log_0.bin"))
    st = _state(rep.promote())
    assert st == _state(_recover("ref", _reopen("ref", eng.devices), "vectorized"))
    assert st == _state(_recover("port", eng.devices, "scalar"))
    assert all(v != b"TORN-NEVER-COMMITTED" for v, _ in st[0].values())
