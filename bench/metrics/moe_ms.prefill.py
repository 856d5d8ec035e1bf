"""Device ms a prefill call of the kernels under the MoE
(``moe_fwd`` as ``repro_torch.models.lm`` calls it)."""
from bench.readers import MOE, ms_per_unit

RANGES = (MOE,)


def read(trace):
    return ms_per_unit(trace, MOE)
