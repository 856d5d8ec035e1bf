"""The port's health monitors, flight recorder and recovery forensics against
the reference's.

* **Forensics.**  On the same device files and checkpoints, both packages'
  ``explain_recovery`` / ``explain_recovery_sharded`` give identical
  ``to_dict()`` documents (every gtid's verdict, rule, SSNs and detail, the
  watermarks, the torn-tail sightings and the flight summary), and each
  package's ``verify_bytes`` holds the verdicts to its own recovery.  The
  logs cover all six rules: a killed engine with a record above RSNe and a
  torn tail; a sharded cut with half-committed cross-shard records below and
  above a shard's checkpoint floor; a truncated log with its checkpoint; and
  hand-framed records whose command dependencies the checkpoint or the log
  does, or does not, cover.
* **Flight.**  A dump written by either package loads under the other's
  ``load_flight`` with the same keys, including one written by a SIGTERM
  handler in a child process.
* **Health.**  The four monitor tests of ``tests/test_obs.py``, and a
  ``SaturationMonitor`` over the port's scheduler.
"""

import json
import os
import random
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

import repro.core as jcore
import repro.obs.flight as jflight
import repro.obs.forensics as jforensics
import repro.shard as jshard
import repro_torch.core as tcore
import repro_torch.core.truncate as ttruncate
import repro_torch.db as tdb
import repro_torch.obs.flight as tflight
import repro_torch.obs.forensics as tforensics
import repro_torch.shard as tshard
from repro.obs import REGISTRY as JREGISTRY
from repro_torch.core.command import OP_PATCH_PREFIX
from repro_torch.obs import REGISTRY, enable
from repro_torch.obs.health import (
    CRIT,
    WARN,
    HealthMonitor,
    ReplicaLagMonitor,
    SaturationMonitor,
    TruncationStallMonitor,
)

ROOT = Path(__file__).resolve().parents[1]
PKGS = {"ref": (jcore, jshard, jforensics, jflight), "port": (tcore, tshard, tforensics, tflight)}
RECOVER_MODES = {"ref": ("vectorized", "scalar"), "port": ("kernel", "vectorized", "scalar")}
TORN = b"TORN-NEVER-COMMITTED"


@pytest.fixture(autouse=True)
def _disarm():
    yield
    for reg in (REGISTRY, JREGISTRY):
        reg.enabled = False
        reg.reset()


def _record(tid, ssn, key, val, reads=False, xdep=None, cmd_dep=None) -> bytes:
    t = tcore.Txn(tid=tid, write_set=[(key, val)], read_set=[("dep", 0)] if reads else [],
                  xdep=xdep)
    if cmd_dep is not None:
        t.cmd_op, t.cmd_deps = OP_PATCH_PREFIX, [cmd_dep]
    t.ssn = ssn
    return t.encode()


def _append(path, *blobs):
    with open(path, "ab") as f:
        for b in blobs:
            f.write(b)


def _devs(pkg, paths):
    core = PKGS[pkg][0]
    return [core.StorageDevice(core.DeviceSpec.ssd(), path=str(p), clock="virtual") for p in paths]


def _recover(pkg, devs, ckpt, mode, sharded):
    kw = {"device": "cpu"} if mode == "kernel" else {}
    if sharded:
        return PKGS[pkg][1].recover_sharded(devs, checkpoint_dirs=ckpt, parallel=False, mode=mode,
                                            **kw)
    return PKGS[pkg][0].recover(devs, checkpoint_dir=ckpt, parallel=False, mode=mode, **kw)


def _explain_both(paths, ckpt=None, flight=None, sharded=False, replayable=True):
    """Both packages explain the same files: identical documents, and each
    package's verdicts byte-agree with each of its recovery modes."""
    docs = {}
    for pkg in PKGS:
        fx = PKGS[pkg][2]
        if sharded:
            devs = [_devs(pkg, ps) for ps in paths]
            ex = fx.explain_recovery_sharded(devs, checkpoint_dirs=ckpt, flight=flight)
        else:
            devs = _devs(pkg, paths)
            ex = fx.explain_recovery(devs, checkpoint_dir=ckpt, flight=flight)
        docs[pkg] = ex.to_dict()
        json.dumps(docs[pkg])
        assert ex.render()
        if replayable:
            for mode in RECOVER_MODES[pkg]:
                agrees, bad = ex.verify_bytes(_recover(pkg, devs, ckpt, mode, sharded))
                assert agrees, (pkg, mode, bad[:5])
    assert docs["port"] == docs["ref"]
    return docs["port"]


def _rules(doc):
    return {v["rule"] for v in doc["verdicts"]}


# --- forensics --------------------------------------------------------------------

def test_killed_engine_verdicts_match_reference(tmp_path):
    """The reference's single-shard kill: committed records, a HAS_READS
    record durable on one device above RSNe, a torn frame, and the crash
    context of a flight dump."""
    dev_dir = tmp_path / "devs"
    engine = tcore.PoplarEngine(tcore.EngineConfig(
        n_buffers=2, device_kind="ssd", device_dir=str(dev_dir), device_clock="virtual",
        flush_interval=60.0))
    enable()
    workers = [tcore.Worker(engine, i) for i in range(2)]
    cells = {f"k{i}": type("Cell", (), {"ssn": 0})() for i in range(30)}
    for i in range(60):
        key = f"k{i % 30}"
        t = tcore.Txn(tid=1000 + i, write_set=[(key, f"v{i}".encode())],
                      read_set=[(key, cells[key].ssn)] if i % 4 == 0 else [])
        workers[i % 2].run(t, [], [cells[key]])
        if i % 7 == 0:
            engine.logger_tick(i % 2, force=True)
    for b in range(2):
        engine.logger_tick(b, force=True)
    for i in range(5):       # buffered after the last flush: lost in the kill
        t = tcore.Txn(tid=5000 + i, write_set=[(f"k{i}", f"lost{i}".encode())])
        workers[i % 2].run(t, [], [cells[f"k{i}"]])
    flight = tflight.FlightRecorder(str(tmp_path / "crash")).dump("kill:mid-stream")
    for d in engine.devices:
        d.close()
    _append(dev_dir / "log_0.bin", _record(888888, 1 << 39, "k0", b"ABOVE-RSNE", reads=True),
            _record(777777, 1 << 40, "k0", TORN)[:-7])
    doc = _explain_both([dev_dir / "log_0.bin", dev_dir / "log_1.bin"], flight=flight)
    assert _rules(doc) == {"replayed", "above-rsne", "torn-tail"}
    assert doc["flight"]["reason"] == "kill:mid-stream"
    assert all(5000 + i not in {v["gtid"] for v in doc["verdicts"]} for i in range(5))


def _shard_checkpoint(eng, dirs):
    for p, sh in enumerate(eng.shards):
        entries = sorted((k, v, s) for k, (v, s) in sh.table.to_dict().items() if s > 0)

        def csn_fn(engine=sh.engine):
            for i in range(len(engine.buffers)):
                engine.logger_tick(i, force=True)
            return engine.commit.advance_csn()

        tcore.CheckpointDaemon(dirs[p], n_threads=1, m_files=1, csn_fn=csn_fn).run_once(
            [entries], epoch=1)


def test_sharded_cut_verdicts_match_reference(tmp_path):
    """Two shards with cross-shard batches, a checkpoint of each shard, more
    batches, then a crash tail: a cross-shard record durable on shard 0 only
    whose shard-1 SSN lies at or below shard 1's checkpoint floor, one above
    it, and a torn frame on shard 1."""
    eng = tshard.ShardedEngine(tshard.ShardedConfig(
        n_shards=2, n_workers=2, mode="kernel", device="cpu", device_dir=str(tmp_path / "devs"),
        engine=tcore.EngineConfig(n_buffers=1, device_kind="ssd", device_clock="virtual",
                                  flush_interval=60.0)))
    keys = [f"user{i:010d}" for i in range(24)]
    by_shard = [[k for k in keys if eng.shard_of(k) == s] for s in (0, 1)]
    ckpt = [str(tmp_path / f"ckpt{p}") for p in range(2)]
    for d in ckpt:
        os.makedirs(d)
    for r in range(4):
        specs = [tdb.TxnSpec(writes=[(k, f"{k}r{r}".encode())]) for k in keys]
        specs.append(tdb.TxnSpec(writes=[(by_shard[0][0], f"x0r{r}".encode()),
                                         (by_shard[1][0], f"x1r{r}".encode())],
                                 reads=[by_shard[0][1]] if r % 2 else []))
        res = eng.execute_batch(specs)
        assert not res.aborted and res.cross
        eng.tick(force=True)
        eng.drain()
        if r == 1:
            _shard_checkpoint(eng, ckpt)
    floor1 = tcore.load_latest_checkpoint(ckpt[1]).rsn
    assert floor1 > 0
    for devs in eng.devices:
        for d in devs:
            d.close()
    s0, s1 = tmp_path / "devs" / "shard0", tmp_path / "devs" / "shard1"
    _append(s0 / "log_0.bin",
            _record(999998, floor1, by_shard[0][2], b"X-FLOOR", xdep=[(0, 1 << 38), (1, floor1)]),
            _record(999999, 1 << 39, by_shard[0][2], b"X-NEVER", xdep=[(0, 1 << 39), (1, 1 << 39)]))
    _append(s1 / "log_0.bin", _record(777777, 1 << 40, by_shard[1][0], TORN)[:-7])
    doc = _explain_both([[s0 / "log_0.bin"], [s1 / "log_0.bin"]], ckpt=ckpt, sharded=True)
    verdicts = {v["gtid"]: v for v in doc["verdicts"]}
    assert verdicts[999998]["rule"] == "below-truncation-floor"
    assert verdicts[999999]["rule"] == "not-durable-on-all-participants"
    assert verdicts[777777]["rule"] == "torn-tail"
    assert any(len(v["ssn"]) == 2 and v["kept"] for v in doc["verdicts"])


def test_truncated_log_verdicts_match_reference(tmp_path):
    """A checkpoint, a ``LogTruncator`` pass that drops sealed segments, more
    traffic with one buffer dying unflushed and a torn frame: the verdicts
    over the retained suffix and the checkpoint agree."""
    dev_dir, ckpt_dir = tmp_path / "devs", str(tmp_path / "ckpt")
    engine = tcore.PoplarEngine(tcore.EngineConfig(
        n_buffers=2, device_kind="ssd", device_dir=str(dev_dir), device_clock="virtual",
        segment_bytes=256, flush_interval=60.0))
    table = tdb.Table()
    workers = [tdb.OCCWorker(table, engine, i) for i in range(2)]
    rng = random.Random(23)
    keys = [f"k{i}" for i in range(25)]

    def phase(n, tag):
        for i in range(n):
            wk, rk = rng.sample(keys, rng.randrange(1, 3)), rng.sample(keys, rng.randrange(0, 2))
            workers[i % 2].execute(reads=rk, writes=[(k, f"{tag}{i}:{k}".encode()) for k in wk])

    def csn_fn():
        for i in range(2):
            engine.logger_tick(i, force=True)
        return engine.commit.advance_csn()

    phase(40, "a")
    engine.quiesce(range(2))
    entries = sorted((k.encode(), table.get(k).value, table.get(k).ssn)
                     for k in table.sorted_keys() if table.get(k).ssn > 0)
    tcore.CheckpointDaemon(ckpt_dir, n_threads=2, m_files=2, csn_fn=csn_fn).run_once(
        [entries[0::2], entries[1::2]], epoch=1)
    phase(30, "b")
    engine.quiesce(range(2))
    stats = ttruncate.LogTruncator(engine, ckpt_dir).run_once()
    assert stats.segments_dropped > 0
    phase(30, "c")
    engine.logger_tick(0, force=True)     # buffer 1 dies unflushed
    for d in engine.devices:
        d.close()
    _append(dev_dir / "log_0.bin", _record(777777, 1 << 40, "k0", TORN)[:-7])
    doc = _explain_both([dev_dir / "log_0.bin", dev_dir / "log_1.bin"], ckpt=ckpt_dir)
    assert doc["rsns"][0] > 0 and "torn-tail" in _rules(doc)


def _crafted(tmp_path, uncovered):
    """Hand-framed records on two devices (RSNe 4) over a checkpoint with
    RSN 6: write-only and low-SSN reads replay, reads at SSN 5 fall below
    the checkpoint floor, reads at SSN 7 lie above RSNe, and two command
    records whose dependencies the checkpoint (key c at SSN 5) and the log
    (key e at SSN 8) cover; with ``uncovered`` a third depends on a write
    that neither holds."""
    d0, d1, ckpt = tmp_path / "log_0.bin", tmp_path / "log_1.bin", str(tmp_path / "ckpt")
    os.makedirs(ckpt)
    tcore.CheckpointDaemon(ckpt, n_threads=1, m_files=1, csn_fn=lambda: 6).run_once(
        [[(b"a", b"ck-a", 3), (b"c", b"ck-c-value", 5)]], epoch=1)
    blobs0 = [_record(11, 1, "a", b"v1"), _record(13, 3, "r", b"v3", reads=True),
              _record(15, 5, "b", b"v5", reads=True), _record(17, 7, "b", b"v7", reads=True),
              _record(18, 8, "e", b"e-value-8"), _record(19, 9, "c", b"NEW", cmd_dep=("c", 5)),
              _record(20, 10, "e", b"PATCH", cmd_dep=("e", 8))]
    if uncovered:
        blobs0.append(_record(21, 11, "h", b"H", cmd_dep=("h", 7)))
    _append(d0, *blobs0)
    _append(d1, _record(12, 2, "f", b"v2"), _record(14, 4, "g", b"v4"),
            _record(777777, 1 << 40, "g", TORN)[:-7])
    return [d0, d1], ckpt


def test_crafted_verdicts_match_reference(tmp_path):
    paths, ckpt = _crafted(tmp_path, uncovered=False)
    doc = _explain_both(paths, ckpt=ckpt)
    rule = {v["gtid"]: v["rule"] for v in doc["verdicts"]}
    assert doc["rsne"] == [4] and doc["rsns"] == [6]
    assert (rule[13], rule[15], rule[17], rule[19], rule[20], rule[777777]) == (
        "replayed", "below-truncation-floor", "above-rsne", "replayed", "replayed", "torn-tail")
    st = _recover("port", _devs("port", paths), ckpt, "kernel", False)
    assert st.data[b"c"][0] == b"NEWc-value" and st.data[b"e"][0] == b"PATCHue-8"


def test_unreplayable_command_dep_matches_reference(tmp_path):
    """A command whose pre-image neither the log nor the checkpoint holds:
    both packages name it ``command-dep-unreplayable`` and both recoveries
    refuse to re-execute it."""
    paths, ckpt = _crafted(tmp_path, uncovered=True)
    doc = _explain_both(paths, ckpt=ckpt, replayable=False)
    rule = {v["gtid"]: v["rule"] for v in doc["verdicts"]}
    assert rule[21] == "command-dep-unreplayable" and rule[20] == "replayed"
    assert len(_rules(doc)) == 5
    for pkg in PKGS:
        core = PKGS[pkg][0]
        err = core.recovery.CommandReplayError
        for mode in RECOVER_MODES[pkg]:
            with pytest.raises(err):
                _recover(pkg, _devs(pkg, paths), ckpt, mode, False)


# --- flight recorder --------------------------------------------------------------

@pytest.mark.parametrize("writer", ["ref", "port"])
def test_flight_dump_loads_under_both(writer, tmp_path):
    reg = enable() if writer == "port" else __import__("repro.obs", fromlist=["enable"]).enable()
    reg.count("unit.events", 3)
    reg.observe("unit.lat", 0.25)
    rec = PKGS[writer][3].FlightRecorder(str(tmp_path / "run"),
                                         extra_fn=lambda: {"stats": {"acked": 7}})
    path = rec.dump("unit-test")
    assert path.endswith(".flight.json") and not any(p.name.count(".tmp.") for p in
                                                     tmp_path.iterdir())
    docs = {pkg: PKGS[pkg][3].load_flight(path) for pkg in PKGS}
    assert docs["ref"] == docs["port"]
    d = docs["ref"]
    assert set(d) == {"schema", "reason", "t_unix", "pid", "metrics", "trace", "extra"}
    assert (d["schema"], d["reason"], d["pid"]) == (1, "unit-test", os.getpid())
    assert d["metrics"]["counters"]["unit.events"] == 3
    assert d["metrics"]["sketches"]["unit.lat"]["count"] == 1
    assert d["extra"] == {"stats": {"acked": 7}}
    other = "ref" if writer == "port" else "port"
    twin = PKGS[other][3].FlightRecorder(str(tmp_path / "twin")).snapshot("unit-test")
    assert set(twin) == set(d) - {"extra"}
    assert set(twin["trace"]) == set(d["trace"]) and set(twin["metrics"]) == set(d["metrics"])


def test_port_flight_sigterm_dump_loads_under_reference(tmp_path):
    target = tmp_path / "crash"
    child = textwrap.dedent(f"""
        import time
        from repro_torch.obs import REGISTRY, enable
        from repro_torch.obs.flight import FlightRecorder
        enable()
        REGISTRY.count("child.alive")
        FlightRecorder({str(target)!r}).install()
        print("READY", flush=True)
        time.sleep(30)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-c", child], stdout=subprocess.PIPE, env=env,
                            text=True)
    try:
        assert proc.stdout.readline().strip() == "READY"
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode != 0
    d = jflight.load_flight(str(target) + ".flight.json")
    assert d["reason"] == "signal:SIGTERM" and d["pid"] == proc.pid
    assert d["metrics"]["counters"]["child.alive"] == 1


# --- health monitors --------------------------------------------------------------

class _FakeReplica:
    def __init__(self, frontier=100, visible=90, backlog=0, stalled_s=0.0):
        self._frontier, self._visible, self._backlog = frontier, visible, backlog
        self._w_advance_t = time.monotonic() - stalled_s

    def shipped_frontiers(self):
        return [self._frontier]

    def visible_ssn(self):
        return self._visible

    def lag_bytes(self):
        return self._backlog


class _FakeRegistry:
    def frontiers(self):
        return {"ckpt": 5}


class _FakeTruncator:
    def __init__(self, pin=0):
        self.pin = pin
        self.registry = _FakeRegistry()

    def stall_ssn(self):
        return self.pin


class _FakeBackend:
    def __init__(self, sat=False):
        self._sat = sat

    def saturated(self):
        return self._sat

    def queue_depths(self):
        return [3, 4]


class _FakeScheduler:
    def __init__(self):
        self.n_rejected = 0
        self.backend = _FakeBackend()


def test_replica_lag_monitor_thresholds():
    evs = ReplicaLagMonitor(_FakeReplica(frontier=100, visible=90), max_lag_ssn=5).check()
    assert len(evs) == 1 and evs[0].severity == CRIT
    assert evs[0].kind == "replica_lag" and evs[0].value == 10.0
    assert not ReplicaLagMonitor(_FakeReplica(frontier=100, visible=98), max_lag_ssn=5).check()
    m2 = ReplicaLagMonitor(_FakeReplica(frontier=5, visible=5, backlog=1 << 20, stalled_s=10.0),
                           max_lag_s=1.0, max_backlog_bytes=1024)
    assert [(e.severity, e.kind) for e in m2.check()] == [(WARN, "replica_lag")] * 2


def test_truncation_stall_monitor_requires_sustained_pin():
    tr = _FakeTruncator(pin=7)
    m = TruncationStallMonitor(tr, sustain=2)
    assert m.check() == []
    evs = m.check()
    assert len(evs) == 1 and evs[0].severity == CRIT and "ckpt" in evs[0].message
    tr.pin = 0
    assert m.check() == []
    tr.pin = 7
    assert m.check() == []


def test_saturation_monitor_sustained_rejects():
    sched = _FakeScheduler()
    m = SaturationMonitor(sched, sustain=2)
    assert m.check() == []
    sched.n_rejected = 3
    assert m.check() == []
    sched.n_rejected = 9
    evs = m.check()
    assert len(evs) == 1 and evs[0].severity == CRIT
    sched.backend._sat = True
    assert [e.severity for e in m.check()] == [WARN]


def test_health_monitor_aggregates_and_mirrors_counters():
    events = []
    hm = HealthMonitor([TruncationStallMonitor(_FakeTruncator(pin=3), sustain=1)],
                       on_event=events.append)
    enable()
    evs = hm.poll()
    assert len(evs) == 1 and events == evs and list(hm.history) == evs
    assert REGISTRY.counter_value("health.events.truncation_stall") == 1
    assert evs[0].to_dict()["kind"] == "truncation_stall"


def test_health_monitor_threaded_start_stop():
    hm = HealthMonitor([TruncationStallMonitor(_FakeTruncator(pin=1), sustain=1)])
    hm.start(poll_interval=1e-3)
    deadline = time.monotonic() + 5.0
    while hm.n_polls < 3 and time.monotonic() < deadline:
        time.sleep(1e-3)
    hm.stop()
    assert hm.n_polls >= 3 and hm._thread is None
    assert any(e.kind == "truncation_stall" for e in hm.history)


def test_saturation_monitor_over_the_port_scheduler(tmp_path):
    """Sustained admission rejects on a real stepped scheduler raise a CRIT
    event; a poll with no new reject resets the streak."""
    from repro_torch.serve import GroupCommitScheduler, ServeConfig, SingleBackend

    be = SingleBackend.make("kernel", n_workers=2, device="cpu", cfg=tcore.EngineConfig(
        n_buffers=1, device_kind="null", device_dir=str(tmp_path), device_clock="virtual",
        flush_interval=60.0))
    sched = GroupCommitScheduler(be, ServeConfig(max_batch=2, queue_capacity=2,
                                                 latency_budget_steps=10**6))
    hm = HealthMonitor([SaturationMonitor(sched, sustain=2)])
    got = []
    for i in range(3):
        for j in range(3):
            sched.submit(tdb.TxnSpec(writes=[(f"k{i}-{j}", b"v")]))
        got.append([e.severity for e in hm.poll()])
    assert got == [[], [CRIT], [CRIT]]
    assert sched.n_rejected == 7
    assert hm.poll() == []
