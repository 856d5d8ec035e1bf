"""What the per-layer metrics of ``bench/metrics/`` share: the ranges and
their bounds, and the readings of a :class:`~bench.tracing.Trace`.  A
reading that finds nothing to read returns None, and the harness leaves
the metric out."""

from __future__ import annotations

from bench import yardstick as ys

ATTN_MODULE = "repro_torch.models.attention"


def _flash_cost(q, k, v, *, causal=True, window=None, softcap=None, return_lse=False):
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    flops, nbytes = ys.flash_cost(b, hq, hkv, s, t, d, q.element_size(), causal, window,
                                  return_lse)
    return flops, nbytes, ys.PEAK_BF16 if q.element_size() == 2 else ys.PEAK_FP32


def _flash_bwd_cost(q, k, v, lse, do, *, causal=True, window=None):
    # the backward kernel takes bfloat16 alone
    b, hq, s, d = q.shape
    flops, nbytes = ys.flash_bwd_cost(b, hq, k.shape[1], s, k.shape[2], d, q.element_size(), causal,
                                      window)
    return flops, nbytes, ys.PEAK_BF16


def _scan_cost(x, dt, decay, bmat, cmat):
    b, h, s, p = x.shape
    flops, nbytes = ys.scan_cost(b, h, s, p, bmat.shape[-1], x.element_size())
    return flops, nbytes, ys.PEAK_FP32


FLASH_FWD = ("bench.flash_fwd", ATTN_MODULE, "flash_attention_fwd", _flash_cost)
FLASH_BWD = ("bench.flash_bwd", ATTN_MODULE, "flash_attention_bwd", _flash_bwd_cost)
ATTN_BWD = ("bench.attn_bwd", ATTN_MODULE, "_flash_bwd", None)
SCAN_FWD = ("bench.scan_fwd", "repro_torch.models.ssm", "ssm_scan_chunked", _scan_cost)
MOE = ("bench.moe", "repro_torch.models.lm", "moe_fwd", None)
OPTIMIZER = ("bench.optimizer", "repro_torch.optim.adamw", "update", None)
DECODE = ("bench.decode", "repro_torch.models.api", "Model.decode_step", None)

# the device kernels of a hand-written wrapper's call, by name (frozen from
# ``kernels/csrc/flash_attention.cu``, ``flash_attention_bwd.cu`` and
# ``ssm_scan.cu``), and how many distinct kernels a call launches, each once
KERNELS = {
    FLASH_FWD[0]: (r"\bflash_fwd_(wgmma_)?kernel<", 1),
    FLASH_BWD[0]: (r"\bflash_bwd_(dq|dkdv)_kernel\b", 2),
    SCAN_FWD[0]: (r"\bssm_chunked_(state|pass|out)_kernel\b", 3),
}


def roofline_pct(trace, rng):
    """Sum of the calls' least times over the device time of their kernels
    (by name, from the device-only pass, which runs the same units), in %.
    Nothing where the wrapper's kernels were not each launched once a call
    (one missing, or launched another number of times than it was called):
    the names then do not stand for the calls."""
    name = rng[0]
    calls = trace.costs.get(name) or []
    pattern, per_call = KERNELS[name]
    dev, launches = trace.kernels_named(pattern)
    if (not calls or dev <= 0 or len(launches) != per_call
            or any(n != len(calls) for n in launches.values())):
        return None
    return 100.0 * sum(ys.least_s(f, b, peak) for f, b, peak in calls) / dev


def ms_per_unit(trace, rng, within=None, per=None):
    """Device ms under the range, per traced unit (or per ``per``)."""
    dev = trace.device_s_under(rng[0], within=within)
    n = per if per is not None else len(trace.ranged_units)
    if dev is None or not n:
        return None
    return 1e3 * dev / n


def idle_pct(trace):
    if trace.busy_s <= 0 or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def decode_steps(trace) -> int:
    return sum(u.get("decode_steps", 0) for u in trace.ranged_units)
