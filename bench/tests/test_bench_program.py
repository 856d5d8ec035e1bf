"""The readers of the program's spans and counters (``bench/program.py``)
on a synthetic trace, against the values counted by hand."""

from types import SimpleNamespace

import numpy as np
import pytest

from bench import program, run
from bench.tests.test_bench_spec import ROOT, SPEC
from repro_torch.trace.span import STAGE_NAMES, TraceDump

NEW = {
    "fwd_ms.train": "program_span", "bwd_ms.train": "program_span",
    "scan_bwd_ms.train": "program_span", "moe_dispatch_ms.prefill": "program_span",
    "moe_dispatch_ms.decode": "program_span", "moe_drop_pct.prefill": "program_counter",
    "moe_drop_pct.decode": "program_counter", "tpot_p95_ms.decode": "program_span",
    "decode_host_ms.decode": "program_span",
}


def _dump(rows):
    """A dump of ``(stage, unit, parent, host t0, t1, device t0, t1)`` rows."""
    cols = list(zip(*rows))
    n = len(rows)
    z = np.zeros(n, np.int64)
    return TraceDump(
        stage=np.array([STAGE_NAMES.index(s) for s in cols[0]], np.int16),
        shard=z.astype(np.int32),
        device=z.astype(np.int32) - 1, batch=np.array(cols[1], np.int64), txn_lo=z - 1,
        txn_hi=z - 1, t0=np.array(cols[3]), t1=np.array(cols[4]), nbytes=z, n_txn=z, aux=z - 1,
        parent=np.array(cols[2], np.int64), dev_t0=np.array(cols[5], float),
        dev_t1=np.array(cols[6], float))


class _Raw:
    """A raw profiler event (``kineto_results.events()``'s interface)."""

    def __init__(self, name, device, corr, linked, thread, start, end):
        from torch.autograd import DeviceType

        self._v = (name, DeviceType.CUDA if device else DeviceType.CPU, corr, linked, thread,
                   start, end)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def correlation_id(self):
        return self._v[2]

    def linked_correlation_id(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def start_ns(self):
        return self._v[5]

    def end_ns(self):
        return self._v[6]


class _Host:
    """Builds raw events: ranges and operations on host threads, each
    operation launching device work of given microseconds."""

    def __init__(self):
        self.events, self.corr, self.t = [], 0, 0

    def range(self, name, thread, body):
        self.corr += 1
        start, c = self.t, self.corr
        self.t += 10
        body()
        self.t += 10
        self.events.append(_Raw("repro_torch." + name, False, c, 0, thread, start, self.t))

    def op(self, thread, *device_us, name="aten::mm"):
        self.corr += 1
        self.events.append(_Raw(name, False, self.corr, 0, thread, self.t, self.t + 5))
        for us in device_us:
            self.events.append(_Raw("kernel", True, 0, self.corr, 0, 0, int(us * 1e3)))
        self.t += 10


def _ranged(host, units):
    return program.Ranged(*program.chains(host.events), units)


def _trace(dump=None, counters=None, units=(), ranged=None):
    return SimpleNamespace(program=program.Program(ranged, dump, counters or {}, list(units)))


def _read(name, trace):
    return run.reader(ROOT, name).read(trace)


def test_train_readers_by_hand():
    # two steps: forward 0.5 and 0.25 s on the device, backward 1.0 and 1.5 s
    dump = _dump([
        ("forward", 7, -1, 10.0, 10.1, 0.0, 0.5), ("backward", 7, -1, 10.1, 10.2, 0.5, 1.5),
        ("scan_bwd", 7, 1, 10.15, 10.16, 0.7, 0.8), ("optimizer", 7, -1, 10.2, 10.3, 1.5, 1.6),
        ("forward", 8, -1, 11.0, 11.1, 0.0, 0.25), ("backward", 8, -1, 11.1, 11.2, 0.25, 1.75),
    ])
    h = _Host()
    # the backward's range on the main thread parents nothing; the scan's, on
    # autograd's thread (2), parents the kernels launched there
    h.range("backward", 1, lambda: h.op(1))
    h.op(2, 5000.0)
    h.range("scan_bwd", 2, lambda: (h.op(2, 300.0, 100.0), h.op(2, name="aten::view")))
    h.op(2, 7.0)
    tr = _trace(dump, units=[{"seconds": 1.0}] * 2, ranged=_ranged(h, [{}] * 2))
    assert _read("fwd_ms.train", tr) == pytest.approx(1e3 * (0.5 + 0.25) / 2)
    assert _read("bwd_ms.train", tr) == pytest.approx(1e3 * (1.0 + 1.5) / 2)
    assert _read("scan_bwd_ms.train", tr) == pytest.approx(400e-3 / 2)


def test_moe_readers_by_hand():
    h = _Host()

    def moe(us):
        h.range("moe_route", 1, lambda: h.op(1, us))
        h.range("moe_dispatch", 1, lambda: h.range("inner", 1, lambda: h.op(1, 2 * us)))
        h.op(1, 1000.0)                                           # the expert GEMMs
        h.range("moe_dispatch", 1, lambda: h.op(1, us))

    h.range("prefill", 1, lambda: moe(10.0))
    for _ in range(3):
        h.range("decode_step", 1, lambda: moe(1.0))
    h.events.append(_Raw("flash_fwd_kernel<64>", True, 0, 0, 0, 0, 9000))   # linked to nothing
    counters = {"llm.moe.slots_routed.prefill": 4096.0, "llm.moe.slots_dropped.prefill": 775.0,
                "llm.moe.slots_routed.decode_step": 400.0, "llm.moe.slots_dropped.decode_step": 3.0}
    tr = _trace(counters=counters, ranged=_ranged(h, [{"decode_steps": 3}]))
    # prefill: every range counts (one call); decode: those inside decode steps, a step
    assert _read("moe_dispatch_ms.prefill", tr) == pytest.approx((40.0 + 3 * 4.0) * 1e-3)
    assert _read("moe_dispatch_ms.decode", tr) == pytest.approx(3 * 4.0 * 1e-3 / 3)
    assert _read("moe_drop_pct.prefill", tr) == pytest.approx(100 * 775 / 4096)
    assert _read("moe_drop_pct.decode", tr) == pytest.approx(100 * 3 / 400)
    by_chain, seen = program.chains(h.events)
    assert by_chain[()] == pytest.approx(9e-6)
    assert by_chain[("prefill",)] == pytest.approx(1000e-6)
    assert by_chain[("decode_step",)] == pytest.approx(3 * 1000e-6)
    assert by_chain[("decode_step", "moe_dispatch", "inner")] == pytest.approx(3 * 2e-6)
    assert seen == {"prefill", "decode_step", "moe_route", "moe_dispatch", "inner"}
    assert program.kernels_ms(tr, ("scan_bwd",)) is None        # never ran


def test_decode_readers_by_hand():
    rows = []
    for unit, base in ((1, 0.0), (2, 100.0)):
        p = len(rows)
        rows.append(("prefill", unit, -1, base, base + 0.2, 0.0, 0.3))
        rows.append(("moe_route", unit, p, base, base + 0.1, 0.0, 0.1))
        end = 0.3
        for i in range(20):
            rows.append(("decode_step", unit, -1, base + 1 + i, base + 1 + i + 0.001 * (i + 1),
                         end, end + 0.01 * (i + 1)))
            end += 0.01 * (i + 1)
    tr = _trace(_dump(rows))
    gaps = [10.0 * (i + 1) for i in range(20)] * 2                # ms between token ends
    assert _read("tpot_p95_ms.decode", tr) == pytest.approx(np.percentile(gaps, 95))
    host = [1.0 * (i + 1) for i in range(20)] * 2
    assert _read("decode_host_ms.decode", tr) == pytest.approx(np.median(host))


def test_readers_give_nothing_without_the_programs_passes():
    empty = SimpleNamespace(program=None)
    for name in NEW:
        assert _read(name, empty) is None


def test_state_is_the_drivers_one_live_state():
    class State:
        pass

    trace = SimpleNamespace(ctx=SimpleNamespace(driver=SimpleNamespace(State=State)))
    assert program._state(trace) is None
    one = State()
    assert program._state(trace) is one
    two = State()
    assert program._state(trace) is None                      # which one is not known
    del one, two


def test_the_new_metrics_are_declared_after_the_old_ones():
    # the nine as one run in their order; what is appended after them passes
    per_layer = [m["name"] for m in SPEC["per_layer"]]
    i = per_layer.index("fwd_ms.train")
    assert per_layer[i:i + len(NEW)] == list(NEW)
    for m in SPEC["per_layer"][i:i + len(NEW)]:
        assert m["source"] == NEW[m["name"]] and m["better"] == "lower"
        assert run.reader_path(ROOT, m["name"]).name == m["name"] + ".py"
