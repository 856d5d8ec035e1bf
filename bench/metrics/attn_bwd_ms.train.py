"""Device ms a step of the kernels under attention's torch-op backward
(``repro_torch.models.attention._flash_bwd``)."""
from bench.readers import ATTN_BWD, ms_per_unit

RANGES = (ATTN_BWD,)


def read(trace):
    return ms_per_unit(trace, ATTN_BWD)
