"""Device ms a decode step of the kernels under the MoE (``moe_fwd`` as
``repro_torch.models.lm`` calls it) inside ``Model.decode_step``."""
from bench.readers import DECODE, MOE, decode_steps, ms_per_unit

RANGES = (MOE, DECODE)


def read(trace):
    return ms_per_unit(trace, MOE, within=DECODE[0], per=decode_steps(trace))
