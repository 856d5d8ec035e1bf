"""The step's model flops (6·N·tokens, N without the input embedding, plus
12·Hq·D per unmasked pair and row) over 989 TFLOP/s times the traced
steps' time, in %."""
from bench import yardstick as ys

RANGES = ()


def read(trace):
    ctx, units = trace.ctx, trace.units
    secs = sum(u["seconds"] for u in units)
    if not units or secs <= 0:
        return None
    t = ctx.traffic
    flops = ys.train_step_flops(ctx.cfg, ctx.plist, t["batch"], t["seq"])
    return 100.0 * flops * len(units) / (ys.PEAK_BF16 * secs)
