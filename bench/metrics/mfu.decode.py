"""Each decode step's least time on the chip (the weights read once and
the cached keys and values read once, or its flops, whichever is longer)
over the measured decode time of the traced calls, in %."""
from bench import yardstick as ys

RANGES = ()


def read(trace):
    ctx, units = trace.ctx, trace.units
    secs = sum(u["decode_s"] for u in units)
    if not units or secs <= 0:
        return None
    t = ctx.traffic
    least = sum(ys.decode_step_least_s(ctx.cfg, ctx.plist, t["batch"], t["prompt"] + i,
                                       t["cache_len"])
                for u in units for i in range(u["decode_steps"]))
    return 100.0 * least / secs
