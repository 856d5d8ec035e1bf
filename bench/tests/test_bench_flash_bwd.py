"""The readers of attention's backward span and counters
(``attn_bwd_ms.train``, ``flash_bwd_kernel_pct.train``) on a synthetic
trace, against the values counted by hand."""

import pytest

from bench.tests.test_bench_program import _dump, _read, _trace
from repro_torch.trace import span


def test_flash_bwd_readers_by_hand():
    # two steps: three attention backwards each under the step's backward span
    rows = []
    for unit, base in ((7, 0.0), (8, 10.0)):
        b = len(rows)
        rows.append(("backward", unit, -1, base, base + 1, base, base + 1.0))
        for i, ms in enumerate((20.0, 30.0, 25.0)):
            t = base + 0.1 * (i + 1)
            rows.append(("flash_bwd", unit, b, t, t + 0.01, t, t + ms / 1e3))
    counters = {"llm.attn.bwd_calls": 6.0, "llm.attn.bwd_kernel": 6.0, "llm.moe.slots_routed.x": 1}
    tr = _trace(_dump(rows), counters, units=[{}] * 2)
    assert _read("attn_bwd_ms.train", tr) == pytest.approx((20 + 30 + 25) * 2 / 2)
    assert _read("flash_bwd_kernel_pct.train", tr) == pytest.approx(100.0)
    half = _trace(_dump(rows), {"llm.attn.bwd_calls": 6.0, "llm.attn.bwd_kernel": 3.0},
                  units=[{}] * 2)
    assert _read("flash_bwd_kernel_pct.train", half) == pytest.approx(50.0)
    assert _read("flash_bwd_kernel_pct.train", _trace(_dump(rows), {"llm.attn.bwd_calls": 6.0},
                                                      units=[{}] * 2)) == 0.0


def test_flash_bwd_readers_give_nothing_where_nothing_ran(monkeypatch):
    rows = [("backward", 1, -1, 0.0, 1.0, 0.0, 1.0)]
    tr = _trace(_dump(rows), {}, units=[{}])
    assert _read("attn_bwd_ms.train", tr) is None                 # no flash_bwd span
    assert _read("flash_bwd_kernel_pct.train", tr) is None         # no backward counted
    for name in ("attn_bwd_ms.train", "flash_bwd_kernel_pct.train"):
        assert _read(name, _trace(None)) is None                   # no unit traced
    # a program without the stage (the tree before it): nothing, and no raise
    monkeypatch.setattr(span, "STAGE_NAMES", tuple(n for n in span.STAGE_NAMES
                                                   if n != "flash_bwd"))
    assert _read("attn_bwd_ms.train", tr) is None


def test_flash_bwd_readers_give_nothing_without_the_programs_passes():
    from types import SimpleNamespace

    empty = SimpleNamespace(program=None)
    for name in ("attn_bwd_ms.train", "flash_bwd_kernel_pct.train"):
        assert _read(name, empty) is None
