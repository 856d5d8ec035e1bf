"""The port's batched forward path against the reference's, exactly.

The same spec streams go through ``repro.db.batch.BatchOCC`` (``vectorized``,
and ``pallas`` with ``fused_min_lanes=0`` so the fused round runs) and
through the port's ``BatchOCC`` (``vectorized``, and ``kernel`` on
``device="cpu"`` in fused and in declined rounds).  All executors start
from one table (the port's through ``ArrayTable.from_arrays``) and must give
the same winners, tids, SSNs and aborts, the same final table, and
byte-identical device logs.  Streams: YCSB write-only (spec and indexed
entries), YCSB hybrid (RAW dependencies through the 10-key scan), and
read-modify-write with driver-observed SSNs, each with and without an
``AdaptivePolicy``.
"""

import numpy as np
import pytest

from repro.core import EngineConfig as JEngineConfig
from repro.core import PoplarEngine as JPoplarEngine
from repro.core.engine import AdaptivePolicy as JAdaptivePolicy
from repro.db import ArrayTable as JArrayTable
from repro.db import BatchOCC as JBatchOCC
from repro.db import TxnSpec as JTxnSpec
from repro.db import ycsb as jycsb
from repro_torch.core import EngineConfig, PoplarEngine
from repro_torch.core.engine import AdaptivePolicy
from repro_torch.db import ArrayTable, BatchOCC, TxnSpec
from repro_torch.db import ycsb
from repro_torch.obs import metrics as tmetrics

N_RECORDS = 200
N_BUFFERS = 2
N_WORKERS = 4

# name -> (package, mode, fused_min_lanes); the first is the yardstick
EXECUTORS = {
    "ref-vectorized": ("ref", "vectorized", None),
    "ref-pallas-fused": ("ref", "pallas", 0),
    "port-vectorized": ("port", "vectorized", None),
    "port-kernel-fused": ("port", "kernel", 0),
    "port-kernel-declined": ("port", "kernel", 1 << 30),
}


def _engine(pkg, path):
    path.mkdir()
    # flush_interval is explicit and effectively infinite (see
    # test_batch_occ.py): heartbeats stay out of the SSN chains, so every
    # engine sequences identically; quiesce() force-ticks at the end
    if pkg == "ref":
        return JPoplarEngine(JEngineConfig(
            n_buffers=N_BUFFERS, device_kind="null", device_dir=str(path),
            flush_interval=60.0))
    return PoplarEngine(EngineConfig(
        n_buffers=N_BUFFERS, device_kind="null", device_dir=str(path),
        flush_interval=60.0, device_clock="virtual", logger_poll=1e-5))


def _executors(tmp_path, with_policy):
    src = JArrayTable()
    jycsb.load(src, N_RECORDS, seed=7)
    n = src.n
    out = {}
    for name, (pkg, mode, min_lanes) in EXECUTORS.items():
        eng = _engine(pkg, tmp_path / name)
        if pkg == "ref":
            tab = JArrayTable()
            jycsb.load(tab, N_RECORDS, seed=7)
            occ = JBatchOCC(tab, eng, n_workers=N_WORKERS, mode=mode,
                            policy=JAdaptivePolicy() if with_policy else None)
        else:
            tab = ArrayTable.from_arrays(src._keys, src.values[:n], src.ssn[:n])
            kw = {"device": "cpu"} if mode == "kernel" else {}
            occ = BatchOCC(tab, eng, n_workers=N_WORKERS, mode=mode,
                           policy=AdaptivePolicy() if with_policy else None, **kw)
        if min_lanes is not None:
            occ.fused_min_lanes = min_lanes
        out[name] = occ
    return out


def _as_ref(specs):
    return [JTxnSpec(reads=s.reads, writes=s.writes, observed=s.observed,
                     cmd_op=s.cmd_op, cmd_params=s.cmd_params) for s in specs]


def _step_specs(stream, step, table):
    """One batch of the stream as port specs."""
    if stream == "hybrid":
        return ycsb.YCSBHybrid(N_RECORDS, scan_length=10, seed=step).next_batch(150)
    if stream == "write_only" or step == 0:
        return ycsb.YCSBWriteOnly(N_RECORDS, seed=step).next_batch(120)
    # read-modify-write over the keys written so far, some observations stale
    specs = ycsb.AdaptiveRMW(table, N_RECORDS, seed=step).next_batch(90)
    for i in range(0, len(specs), 9):
        specs[i].observed = [specs[i].observed[0] + 1]
    return specs


def _run(occ, specs, indexed):
    if indexed is not None:
        return occ.execute_indexed(*indexed[:5], wr_vlen=indexed[5], max_rounds=3)
    if isinstance(occ, JBatchOCC):
        specs = _as_ref(specs)
    return occ.execute_batch(specs, max_rounds=3)


@pytest.mark.parametrize("with_policy", [False, True])
@pytest.mark.parametrize("stream", ["write_only", "hybrid", "rmw"])
def test_port_batches_equal_reference(stream, with_policy, tmp_path):
    execs = _executors(tmp_path, with_policy)
    reg = tmetrics.enable()
    fused = {name: 0.0 for name in execs}
    declined = {name: 0.0 for name in execs}
    try:
        for step in range(4):
            table = execs["port-vectorized"].table
            specs = _step_specs(stream, step, table)
            indexed = None
            if stream == "write_only" and step % 2:
                indexed = ycsb.YCSBWriteOnly(N_RECORDS, seed=50 + step) \
                    .next_batch_indexed(120)
            results = {}
            for name, occ in execs.items():
                f0 = reg.counter_value("occ.fused.rounds")
                d0 = reg.counter_value("occ.fused.decline.small_batch")
                results[name] = _run(occ, specs, indexed)
                fused[name] += reg.counter_value("occ.fused.rounds") - f0
                declined[name] += (
                    reg.counter_value("occ.fused.decline.small_batch") - d0)
                occ.drain()
            want = results["ref-vectorized"]
            assert want.committed
            for name, got in results.items():
                assert got.committed_idx == want.committed_idx, (name, step)
                assert got.aborted == want.aborted, (name, step)
                assert got.rounds == want.rounds, (name, step)
                for tw, tg in zip(want.committed, got.committed):
                    assert (tw.tid, tw.ssn, tw.worker_id) == (
                        tg.tid, tg.ssn, tg.worker_id), (name, step)
                    assert tw.read_set == tg.read_set, (name, step)
                    assert tw.write_set == tg.write_set, (name, step)
                    assert tw.cmd_op == tg.cmd_op, (name, step)
        n_command = reg.counter_value("adaptive.policy.command")
    finally:
        tmetrics.disable()
    assert execs["ref-vectorized"].aborts > 0
    # command framing happens exactly where the policy allows it
    assert (n_command > 0) == (with_policy and stream == "rmw")

    # the kernel executors really took the round they claim
    assert fused["port-kernel-fused"] > 0 and declined["port-kernel-fused"] == 0
    assert declined["port-kernel-declined"] > 0
    assert fused["port-kernel-declined"] == 0

    tables = {name: occ.table.to_dict() for name, occ in execs.items()}
    logs = {}
    for name, occ in execs.items():
        occ.engine.quiesce(range(N_WORKERS))
        for d in occ.engine.devices:
            d.close()
        logs[name] = [d.read_all() for d in occ.engine.devices]
    for name in execs:
        assert tables[name] == tables["ref-vectorized"], name
        assert logs[name] == logs["ref-vectorized"], name
    assert any(logs["ref-vectorized"])


def test_from_arrays_carries_the_state():
    src = JArrayTable()
    jycsb.load(src, 50, seed=3)
    src.ssn[:50] = np.arange(50) * 3
    tab = ArrayTable.from_arrays(src._keys, src.values[:50], src.ssn[:50])
    assert tab.to_dict() == src.to_dict()
    assert tab.n == 50 and not tab.lock_owner[:50].any()
    assert list(tab.key_len[:50]) == list(src.key_len[:50])
    assert tab.rows_for([jycsb.key_of(7)]).tolist() == [7]


def test_kernel_mode_on_cpu_needs_no_card(tmp_path):
    """``device="cpu"`` runs the plain versions whether or not a card is
    present; the default device is the card."""
    tab = ArrayTable.from_arrays([ycsb.key_of(0)], [b"x"], [0])
    eng = _engine("port", tmp_path / "e")
    occ = BatchOCC(tab, eng, n_workers=1, mode="kernel", device="cpu")
    occ.fused_min_lanes = 0
    res = occ.execute_batch([TxnSpec(writes=[(ycsb.key_of(0), b"y")])])
    assert len(res.committed) == 1 and tab.get(ycsb.key_of(0))[0] == b"y"
    assert occ.device.type == "cpu"
    assert BatchOCC(tab, eng, mode="vectorized").device is None
