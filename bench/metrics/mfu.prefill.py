"""Each prefill call's least time on the chip (model flops at 989 TFLOP/s
or the bytes it must move at 3.35 TB/s, whichever is longer) over its
measured time, host to host, summed over the traced calls, in %."""
from bench import yardstick as ys

RANGES = ()


def read(trace):
    ctx, units = trace.ctx, trace.units
    secs = sum(u["seconds"] for u in units)
    if not units or secs <= 0:
        return None
    t = ctx.traffic
    least = ys.prefill_least_s(ctx.cfg, ctx.plist, t["batch"], t["prompt"])
    return 100.0 * least * len(units) / secs
