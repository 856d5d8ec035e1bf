"""The port's log truncation against the reference's, exactly.

Both packages run the same checkpoint → truncate → crash scenario as
``tests/test_truncation.py::test_truncated_recovery_equals_oracle`` (crash at
the truncation, mid-stream with a torn frame, after a full flush), each with
its own engine, OCC workers, checkpoint daemon and ``LogTruncator``.  The
passes must drop the same segments and bytes at the same safe point, leave
the same ``truncated_ssn``, base offsets and retained bytes, and recover to
the same image as the never-truncated oracle in every mode.  Each package
then reopens the other's truncated device files and recovers them with the
other's checkpoint, to the same image.

The command-dep pin (adaptive logging) is held the same way: on logs that
carry command records, ``retained_command_dep_floor`` and the segment it
pins agree for a grid of safe points, and a pinned ``truncate_to_ssn``
keeps the same prefix.  The consumer-frontier cap of ``FrontierRegistry``
stalls and releases both truncators alike.
"""

import os
import random

import pytest

import repro.core as jcore
import repro.core.truncate as jtruncate
import repro.db as jdb
import repro.db.ycsb as jycsb
import repro.journal as jjournal
import repro_torch.core as tcore
import repro_torch.core.truncate as ttruncate
import repro_torch.db as tdb
import repro_torch.db.ycsb as tycsb
import repro_torch.journal as tjournal
from repro.core.engine import AdaptivePolicy as JAdaptivePolicy
from repro_torch.core.engine import AdaptivePolicy

PKGS = {"ref": (jcore, jdb, jtruncate), "port": (tcore, tdb, ttruncate)}
RECOVER_MODES = {"ref": ("scalar", "vectorized", "pallas"),
                 "port": ("scalar", "vectorized", "kernel")}


def _recover(pkg, devices, ckpt_dir, mode):
    core = PKGS[pkg][0]
    kw = {"device": "cpu"} if mode == "kernel" else {}
    st = core.recover(devices, checkpoint_dir=ckpt_dir, parallel=False, mode=mode, **kw)
    return st.data, st.rsns, st.rsne


def _engine_csn_fn(engine):
    def csn_fn():
        for i in range(len(engine.buffers)):
            engine.logger_tick(i, force=True)
        return engine.commit.advance_csn()

    return csn_fn


def _run_phase(workers, keys, rng, n, tag):
    for i in range(n):
        w = workers[i % len(workers)]
        wk = rng.sample(keys, rng.randrange(1, 3))
        rk = rng.sample(keys, rng.randrange(0, 2))   # some Qwr records
        w.execute(reads=rk, writes=[(k, f"{tag}{i}:{k}".encode()) for k in wk])


def _checkpoint(core, engine, table, ckpt_dir, epoch):
    daemon = core.CheckpointDaemon(ckpt_dir, n_threads=2, m_files=2,
                                   csn_fn=_engine_csn_fn(engine))
    entries = sorted(
        (k.encode(), table.get(k).value, table.get(k).ssn)
        for k in table.sorted_keys() if table.get(k).ssn > 0
    )
    daemon.run_once([entries[0::2], entries[1::2]], epoch=epoch)


def _oracle_devices(core, pre_bytes, devices):
    """In-memory devices holding what each device would contain had nothing
    been truncated: the captured prefix plus the retained suffix past it."""
    out = []
    for pre, d in zip(pre_bytes, devices):
        base = d.base_offset()
        full = pre + d.read_from(base)[len(pre) - base:]
        od = core.StorageDevice(core.DeviceSpec.null(), clock="virtual")
        od.write(full)
        out.append(od)
    return out


def _scenario(pkg, root, crash):
    """``tests/test_truncation.py``'s single-engine crash-at-truncation run in
    one package; returns what the truncation and the crash left."""
    core, db, truncate = PKGS[pkg]
    dev_dir, ckpt_dir = str(root / "devs"), str(root / "ckpt")
    engine = core.PoplarEngine(core.EngineConfig(
        n_buffers=2, device_kind="ssd", device_dir=dev_dir,
        device_clock="virtual", segment_bytes=256,
    ))
    table = db.Table()
    workers = [db.OCCWorker(table, engine, i) for i in range(2)]
    rng = random.Random(23)
    keys = [f"k{i}" for i in range(25)]
    _run_phase(workers, keys, rng, 40, "a")
    engine.quiesce(range(2))
    _checkpoint(core, engine, table, ckpt_dir, epoch=1)
    _run_phase(workers, keys, rng, 30, "b")
    engine.quiesce(range(2))

    pre = [d.read_from(0) for d in engine.devices]
    stats = truncate.LogTruncator(engine, ckpt_dir).run_once()
    if crash != "at_truncation":
        _run_phase(workers, keys, rng, 30, "c")
        if crash == "flushed":
            engine.quiesce(range(2))
        else:
            engine.logger_tick(0, force=True)   # buffer 1 dies unflushed
    for d in engine.devices:
        d.close()
    if crash == "mid_stream":                   # torn frame lands on device 0
        with open(os.path.join(dev_dir, "log_0.bin"), "ab") as f:
            f.write(b"\xff" * 11)
    oracle = _oracle_devices(core, pre, engine.devices)
    if crash == "mid_stream":
        oracle[0].write(b"\xff" * 11)
    return engine, stats, ckpt_dir, dev_dir, oracle


def _device_view(d):
    base = d.base_offset()
    return (base, d.truncated_ssn, d.truncated_bytes, d.segments(), d.size(),
            d.read_from(base))


def _stats_view(s):
    return (s.epoch, s.safe_ssn, s.segments_sealed, s.segments_dropped,
            s.bytes_dropped, s.per_device)


def _reopen(pkg, dev_dir, n):
    core = PKGS[pkg][0]
    return [core.StorageDevice(core.DeviceSpec.ssd(), path=os.path.join(dev_dir, f"log_{i}.bin"),
                               clock="virtual") for i in range(n)]


@pytest.mark.parametrize("crash", ["at_truncation", "mid_stream", "flushed"])
def test_truncated_recovery_matches_reference(tmp_path, crash):
    runs = {pkg: _scenario(pkg, tmp_path / pkg, crash) for pkg in PKGS}
    (jeng, jstats, jckpt, jdir, joracle), (teng, tstats, tckpt, tdir, toracle) = \
        runs["ref"], runs["port"]

    # the same pass: same safe point, same segments and bytes dropped
    assert _stats_view(tstats) == _stats_view(jstats)
    assert tstats.bytes_dropped > 0 and tstats.safe_ssn > 0
    assert [_device_view(d) for d in teng.devices] == [_device_view(d) for d in jeng.devices]
    assert all(d.base_offset() > 0 for d in teng.devices)

    want = _recover("ref", joracle, jckpt, "vectorized")
    assert want[0]
    assert _recover("port", toracle, tckpt, "vectorized") == want
    for pkg, devs, ckpt in (("ref", jeng.devices, jckpt), ("port", teng.devices, tckpt)):
        for mode in RECOVER_MODES[pkg]:
            assert _recover(pkg, devs, ckpt, mode) == want, (pkg, mode)

    # each package reopens the other's truncated files (manifest and all)
    # and recovers them against the other's checkpoint
    for mode in RECOVER_MODES["port"]:
        assert _recover("port", _reopen("port", jdir, 2), jckpt, mode) == want, mode
    for mode in RECOVER_MODES["ref"]:
        assert _recover("ref", _reopen("ref", tdir, 2), tckpt, mode) == want, mode


def test_consumer_frontier_caps_both_truncators(tmp_path):
    """A lagging registered consumer stalls the pass at safe point 0 in both
    packages; unregistering it releases the same drop."""
    out = {}
    for pkg in PKGS:
        core, db, truncate = PKGS[pkg]
        root = tmp_path / pkg
        engine = core.PoplarEngine(core.EngineConfig(
            n_buffers=2, device_kind="ssd", device_dir=str(root / "devs"),
            device_clock="virtual"))
        table = db.Table()
        workers = [db.OCCWorker(table, engine, i) for i in range(2)]
        _run_phase(workers, [f"k{i}" for i in range(10)], random.Random(3), 30, "a")
        engine.quiesce(range(2))
        ckpt_dir = str(root / "ckpt")
        _checkpoint(core, engine, table, ckpt_dir, epoch=1)
        registry = truncate.FrontierRegistry()
        registry.register("lagging-consumer", lambda: 0)
        tr = truncate.LogTruncator(engine, ckpt_dir, registry=registry)
        stalled = _stats_view(tr.run_once())
        stall = tr.stall_ssn()
        registry.unregister("lagging-consumer")
        out[pkg] = (stalled, stall, _stats_view(tr.run_once()),
                    [_device_view(d) for d in engine.devices])
    assert out["port"] == out["ref"]
    assert out["port"][0][1] == 0 and out["port"][0][4] == 0
    assert out["port"][1] > 0 and out["port"][2][4] > 0


def _seal(engine):
    for buf, dev in zip(engine.buffers, engine.devices):
        with buf.flush_lock:
            dev.seal(buf.dsn)


def test_journal_tailer_frontier_caps_both_truncators(tmp_path):
    """A registered journal tailer (a ``JournalTails`` over the engine's log
    files, probed after the first phase only) caps the pass at its
    frontier, below the checkpoint's RSN, in both packages alike: only the
    segments at or below the frontier go.  Unregistered, the next pass
    drops up to the RSN."""
    out = {}
    for pkg in PKGS:
        core, db, truncate = PKGS[pkg]
        journal = jjournal if pkg == "ref" else tjournal
        root = tmp_path / pkg
        engine = core.PoplarEngine(core.EngineConfig(
            n_buffers=2, device_kind="ssd", device_dir=str(root / "devs"),
            device_clock="virtual"))
        table = db.Table()
        workers = [db.OCCWorker(table, engine, i) for i in range(2)]
        rng, keys = random.Random(5), [f"k{i}" for i in range(20)]
        _run_phase(workers, keys, rng, 30, "a")
        engine.quiesce(range(2))
        tails = journal.JournalTails()
        for d in engine.devices:
            tails.lane(d.path)
        frontier = tails.min_frontier()
        _seal(engine)                       # phase a is each device's first segment
        _run_phase(workers, keys, rng, 30, "b")
        engine.quiesce(range(2))
        ckpt_dir = str(root / "ckpt")
        _checkpoint(core, engine, table, ckpt_dir, epoch=1)
        registry = truncate.FrontierRegistry()
        registry.register_journal("journal", tails)
        tr = truncate.LogTruncator(engine, ckpt_dir, registry=registry)
        capped, stall = _stats_view(tr.run_once()), tr.stall_ssn()
        registry.unregister("journal")
        out[pkg] = (frontier, capped, stall, _stats_view(tr.run_once()),
                    [_device_view(d) for d in engine.devices])
    assert out["port"] == out["ref"]
    frontier, capped, stall, released, _ = out["port"]
    assert frontier > 0 and capped[1] == frontier and stall > 0
    assert capped[4] > 0 and released[1] == frontier + stall and released[4] > 0


# --- the command-dep pin -------------------------------------------------------

def _adaptive_logs(pkg, root):
    """Path-backed segmented logs with command records: YCSB loads, a
    checkpoint, then read-modify-write batches under an ``AdaptivePolicy``
    (command framing for the RMWs whose deps the image or log covers)."""
    core, db, _ = PKGS[pkg]
    ycsb = jycsb if pkg == "ref" else tycsb
    engine = core.PoplarEngine(core.EngineConfig(
        n_buffers=2, device_kind="ssd", device_dir=str(root / "devs"),
        device_clock="virtual", segment_bytes=512, flush_interval=60.0))
    table = db.ArrayTable()
    ycsb.load(table, 120, seed=7)
    ckpt_dir = str(root / "ckpt")
    policy = (JAdaptivePolicy if pkg == "ref" else AdaptivePolicy)(checkpoint_dir=ckpt_dir)
    kw = {"mode": "vectorized"} if pkg == "ref" else {"mode": "kernel", "device": "cpu"}
    occ = db.BatchOCC(table, engine, n_workers=2, policy=policy, **kw)
    occ.execute_batch(ycsb.YCSBWriteOnly(120, seed=1).next_batch(100), max_rounds=3)
    occ.drain()
    engine.quiesce(range(2))
    daemon = core.CheckpointDaemon(ckpt_dir, n_threads=1, m_files=1,
                                   csn_fn=_engine_csn_fn(engine))
    daemon.run_once([[(k.encode(), v, s) for k, v, s in table.items() if s > 0]], epoch=1)
    policy.refresh()
    for step in range(4):
        occ.execute_batch(ycsb.AdaptiveRMW(table, 120, seed=10 + step).next_batch(60),
                          max_rounds=3)
        occ.drain()
        for i in range(len(engine.buffers)):
            engine.logger_tick(i, force=True)
        # seal each batch into its own segment
        for buf, dev in zip(engine.buffers, engine.devices):
            with buf.flush_lock:
                dev.seal(buf.dsn)
    engine.quiesce(range(2))
    return engine, ckpt_dir


def test_command_dep_pin_matches_reference(tmp_path):
    runs = {pkg: _adaptive_logs(pkg, tmp_path / pkg) for pkg in PKGS}
    jeng, teng = runs["ref"][0], runs["port"][0]
    assert [d.read_all() for d in teng.devices] == [d.read_all() for d in jeng.devices]
    rsn = jcore.load_latest_checkpoint_meta(runs["ref"][1])["rsn"]
    assert tcore.load_latest_checkpoint_meta(runs["port"][1])["rsn"] == rsn
    last = max(s for d in teng.devices for _, _, s in d.segments())
    pinned = 0
    for safe in sorted({0, rsn // 2, rsn, (rsn + last) // 2, last, None} - {None}) + [None]:
        for ckpt_rsn in (0, rsn // 2, rsn):
            jf = jtruncate.retained_command_dep_floor(jeng.devices, safe, ckpt_rsn)
            tf = ttruncate.retained_command_dep_floor(teng.devices, safe, ckpt_rsn)
            assert tf == jf, (safe, ckpt_rsn)
            kf = [ttruncate._keep_from_floor(d, tf) for d in teng.devices]
            assert kf == [jtruncate._keep_from_floor(d, jf) for d in jeng.devices]
            pinned += tf is not None
    assert pinned > 0                      # the logs do carry log-covered commands

    # a pinned truncation keeps the same prefix on both packages' devices
    floor = ttruncate.retained_command_dep_floor(teng.devices, last, 0)
    for jd, td in zip(jeng.devices, teng.devices):
        kf = ttruncate._keep_from_floor(td, floor)
        assert td.truncate_to_ssn(last, keep_from=kf) == \
            jd.truncate_to_ssn(last, keep_from=jtruncate._keep_from_floor(jd, floor))
        assert _device_view(td) == _device_view(jd)

    # and both truncators' passes agree on what is left
    out = {}
    for pkg, (eng, ckpt_dir) in runs.items():
        stats = PKGS[pkg][2].LogTruncator(eng, ckpt_dir).run_once()
        out[pkg] = (_stats_view(stats), [_device_view(d) for d in eng.devices])
    assert out["port"] == out["ref"]
