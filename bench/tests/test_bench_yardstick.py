"""The benchmark's frozen counts at each cell's shapes, against numbers
worked out by hand, and against the program's own arithmetic today."""

import json
from pathlib import Path

import pytest

from bench import readers
from bench import yardstick as ys
from bench.reference import plain_lm

ROOT = Path(__file__).resolve().parents[2]


def _cfg(name):
    return json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())


def test_attention_pairs_by_hand():
    assert ys.attention_pairs(2048, 2048, None) == 2048 * 2049 // 2
    # window 1024: rows 0..1023 see i + 1 keys, the rest 1024
    assert ys.attention_pairs(2048, 2048, 1024) == 1024 * 1025 // 2 + 1024 * 1024
    assert ys.attention_pairs(4096, 4096, 1024) == 1024 * 1025 // 2 + 3072 * 1024
    assert ys.attention_pairs(4, 6, None, causal=False) == 24


def test_flash_and_scan_cost_by_hand():
    # hymba's training layer: B 8, 25 / 5 heads of 64, S = T = 2048, window 1024, bf16,
    # the log-sum-exp written for the backward
    pairs = 1024 * 1025 // 2 + 1024 * 1024
    f, b = ys.flash_cost(8, 25, 5, 2048, 2048, 64, 2, True, 1024, True)
    assert f == 4 * 64 * 8 * 25 * pairs
    assert b == 2 * (2 * 8 * 25 * 2048 * 64 + 2 * 8 * 5 * 2048 * 64) + 4 * 8 * 25 * 2048
    # mixtral's prefill layer: B 8, 48 / 8 heads of 128, S = T = 2048, causal
    f, b = ys.flash_cost(8, 48, 8, 2048, 2048, 128, 2, True, None, False)
    assert f == 4 * 128 * 8 * 48 * (2048 * 2049 // 2)
    assert b == 2 * (2 * 8 * 48 * 2048 * 128 + 2 * 8 * 8 * 2048 * 128)
    # hymba's scan: 50 heads of 64, state 16, float32
    f, b = ys.scan_cost(8, 50, 2048, 64, 16, 4)
    assert f == 5 * 8 * 50 * 2048 * 64 * 16
    assert b == 2 * 4 * 8 * 50 * 2048 * 64 + 2 * 4 * 8 * 50 * 2048 + 2 * 4 * 8 * 2048 * 16 + 4 * 8 * 50 * 64 * 16


def test_flash_bwd_cost_by_hand():
    # hymba's training layer: B 8, 25 / 5 heads of 64, S = T = 2048, bf16; 10·D flops a pair
    for window, pairs, ms in ((1024, 1024 * 1025 // 2 + 1024 * 1024, 0.2036),
                              (None, 2048 * 2049 // 2, 0.2716)):
        f, b = ys.flash_bwd_cost(8, 25, 5, 2048, 2048, 64, 2, True, window)
        assert f == 10 * 64 * 8 * 25 * pairs
        # q, do, dq at 25 heads; k, v, dk, dv at 5; the float32 log-sum-exp
        assert b == 2 * (3 * 8 * 25 * 2048 * 64 + 4 * 8 * 5 * 2048 * 64) + 4 * 8 * 25 * 2048
        assert 1e3 * ys.least_s(f, b) == pytest.approx(ms, abs=5e-5)       # bound by flops
        assert f / ys.PEAK_BF16 > b / ys.HBM_BYTES_PER_S
    # a step: 29 windowed and 3 full layers
    step = sum(ys.least_s(*ys.flash_bwd_cost(8, 25, 5, 2048, 2048, 64, 2, True, w))
               for w in [1024] * 29 + [None] * 3)
    assert 1e3 * step == pytest.approx(6.72, abs=5e-3)


def test_copies_match_the_programs_arithmetic_today():
    torch = pytest.importorskip("torch")
    from repro_torch.kernels import flash_attention, ssm_scan

    for s, w in ((2048, 1024), (2048, None), (4096, 1024)):
        assert ys.attention_pairs(s, s, w) == flash_attention.attention_pairs(s, s, w)
    q = torch.empty(2, 4, 32, 16, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 2, 32, 16, dtype=torch.bfloat16, device="meta")
    assert ys.flash_cost(2, 4, 2, 32, 32, 16, 2, True, 8, True) == \
        flash_attention.op_cost(q, k, k, True, 8, None, True)
    lse = torch.empty(2, 4, 32, device="meta")
    for w in (8, None):
        assert ys.flash_bwd_cost(2, 4, 2, 32, 32, 16, 2, True, w) == \
            flash_attention.op_cost_bwd(q, k, k, lse, q, w)
    x = torch.empty(2, 4, 32, 8, device="meta")
    dt = torch.empty(2, 4, 32, device="meta")
    bm = torch.empty(2, 32, 5, device="meta")
    assert ys.scan_cost(2, 4, 32, 8, 5, 4) == ssm_scan.op_cost(x, dt, dt, bm, bm)


def test_hymba_train_step_flops_by_hand():
    cfg = _cfg("hymba-1.5b")
    plist = plain_lm.param_list(cfg)
    d, f, v = 1600, 5504, 32001
    per_layer = (d * 1600 + 2 * d * 320 + 1600 * d      # q, k, v, o
                 + 3 * d * f                            # SwiGLU
                 + 2 * d * 3200 + d * 50 + 2 * d * 16 + 3200 * d)   # in, gate, dt, B, C, out
    n = 32 * per_layer + d * v                          # the head; no input embedding
    assert ys.product_params(cfg, plist) == n
    pairs = 3 * (2048 * 2049 // 2) + 29 * (1024 * 1025 // 2 + 1024 * 1024)
    assert ys.train_step_flops(cfg, plist, 8, 2048) == 6 * n * 8 * 2048 + 12 * 25 * 64 * pairs * 8


def test_mixtral_prefill_and_decode_bounds_by_hand():
    cfg = _cfg("mixtral-8x22b")
    plist = plain_lm.param_list(cfg)
    d, f, v = 6144, 16384, 32768
    attn = d * 6144 + 2 * d * 1024 + 6144 * d
    active = 8 * (attn + d * 8 + 2 * 3 * d * f)
    assert ys.product_params(cfg, plist) == active + d * v
    weights = 2 * (8 * (attn + 8 * 3 * d * f) + d * v) + 4 * 8 * (d * 8 + 2 * d) + 4 * d
    assert ys.weight_bytes(plist) == weights
    pairs = 8 * (2048 * 2049 // 2)
    flops = 2 * active * 8 * 2048 + 2 * d * v * 8 + 4 * 48 * 128 * pairs * 8
    nbytes = weights + 2 * 8 * 2048 * d + 8 * 2 * 8 * 2048 * 8 * 128 * 2
    assert ys.prefill_least_s(cfg, plist, 8, 2048) == pytest.approx(
        max(flops / ys.PEAK_BF16, nbytes / ys.HBM_BYTES_PER_S), rel=1e-12)
    # decode at position 300, cache 512: 300 cached keys plus the new one a layer
    slots = 8 * 301
    flops = 2 * (active + d * v) * 64 + 4 * 48 * 128 * slots * 64
    nbytes = weights + 2 * 64 * d + 2 * 64 * slots * 8 * 128 * 2
    assert ys.decode_step_least_s(cfg, plist, 64, 300, 512) == pytest.approx(
        max(flops / ys.PEAK_BF16, nbytes / ys.HBM_BYTES_PER_S), rel=1e-12)
    assert nbytes / ys.HBM_BYTES_PER_S > flops / ys.PEAK_BF16     # decode is bound by bytes


class _Ev:
    def __init__(self, name, us):
        self.name = name
        self.time_range = type("R", (), {"elapsed_us": lambda _self: us})()


def _trace(names_us, calls):
    from bench import tracing

    tr = tracing.Trace.__new__(tracing.Trace)
    tr.device = [_Ev(n, us) for n, us in names_us]
    tr.costs = {readers.FLASH_FWD[0]: calls, readers.FLASH_BWD[0]: calls,
                readers.SCAN_FWD[0]: calls}
    return tr


def test_roofline_reads_its_kernels_by_name():
    flash = "void (anonymous namespace)::flash_fwd_wgmma_kernel<64>(CUtensorMap_st, WgmmaArgs)"
    other = "void at::native::vectorized_elementwise_kernel<4>(int)"
    calls = [(4e9, 1e6, ys.PEAK_BF16)] * 2                 # 4.04 us each, flops-bound
    tr = _trace([(flash, 10.0), (flash, 10.0), (other, 500.0)], calls)
    assert readers.roofline_pct(tr, readers.FLASH_FWD) == pytest.approx(
        100 * 2 * (4e9 / ys.PEAK_BF16) / 20e-6)
    # the scan's three kernels, each once a call
    scan = ["(anonymous namespace)::ssm_chunked_state_kernel(SsmArgs)",
            "(anonymous namespace)::ssm_chunked_pass_kernel(SsmArgs, int)",
            "(anonymous namespace)::ssm_chunked_out_kernel(SsmArgs)"]
    tr = _trace([(n, 5.0) for n in scan] * 2, calls)
    assert readers.roofline_pct(tr, readers.SCAN_FWD) == pytest.approx(
        100 * 2 * (4e9 / ys.PEAK_BF16) / 30e-6)
    # the backward's two kernels, each once a call; the forward's are not its own
    bwd = ["void (anonymous namespace)::flash_bwd_dq_kernel(BwdArgs)",
           "void (anonymous namespace)::flash_bwd_dkdv_kernel(BwdArgs)"]
    tr = _trace([(n, us) for n in bwd for us in (30.0, 20.0)] + [(flash, 10.0)] * 2, calls)
    assert readers.roofline_pct(tr, readers.FLASH_BWD) == pytest.approx(
        100 * 2 * (4e9 / ys.PEAK_BF16) / 100e-6)
    assert readers.roofline_pct(tr, readers.FLASH_FWD) == pytest.approx(
        100 * 2 * (4e9 / ys.PEAK_BF16) / 20e-6)


@pytest.mark.parametrize("launches,calls", [(3, 2), (1, 2), (0, 2), (2, 0)],
                         ids=["more", "fewer", "none", "no-calls"])
def test_roofline_reads_nothing_where_launches_are_not_the_calls(launches, calls):
    flash = "flash_fwd_kernel<64>(FlashArgs)"
    tr = _trace([(flash, 10.0)] * launches, [(4e9, 1e6, ys.PEAK_BF16)] * calls)
    assert readers.roofline_pct(tr, readers.FLASH_FWD) is None
    # the backward: its dq kernel launched ``launches`` times, its dk/dv kernel once a call
    tr = _trace([("flash_bwd_dq_kernel(BwdArgs)", 10.0)] * launches
                + [("flash_bwd_dkdv_kernel(BwdArgs)", 10.0)] * calls,
                [(4e9, 1e6, ys.PEAK_BF16)] * calls)
    assert readers.roofline_pct(tr, readers.FLASH_BWD) is None
