"""Flash backward's share of its roofline: the calls' least times (10·D
flops a pair at 989 TFLOP/s, or q, k, v, do and the log-sum-exp read and
dq, dk and dv written once at 3.35 TB/s) over the device time of the
backward's two kernels, in %.  The calls are those of
``flash_attention_bwd`` as ``repro_torch.models.attention`` calls it."""
from bench.readers import FLASH_BWD, roofline_pct

RANGES = (FLASH_BWD,)


def read(trace):
    return roofline_pct(trace, FLASH_BWD)
