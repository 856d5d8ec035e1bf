"""The chunked scan's share of its roofline: the calls' least times (5·P·N
flops a step and head at 67 TFLOP/s, or its inputs read and outputs
written once at 3.35 TB/s) over the device time of the scan's three
kernels, in %.  The calls are those of ``ssm_scan_chunked`` as
``repro_torch.models.ssm`` calls it."""
from bench.readers import SCAN_FWD, roofline_pct

RANGES = (SCAN_FWD,)


def read(trace):
    return roofline_pct(trace, SCAN_FWD)
