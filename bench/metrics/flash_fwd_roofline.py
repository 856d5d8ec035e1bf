"""Flash forward's share of its roofline: the calls' least times (4·D flops
a pair at 989 TFLOP/s, or q, k, v read and the output written once at
3.35 TB/s) over the device time of the flash forward kernels, in %.  The
calls are those of ``flash_attention_fwd`` as ``repro_torch.models.attention``
calls it."""
from bench.readers import FLASH_FWD, roofline_pct

RANGES = (FLASH_FWD,)


def read(trace):
    return roofline_pct(trace, FLASH_FWD)
