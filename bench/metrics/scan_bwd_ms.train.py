"""Device ms a step of the kernels under the scan's torch-op backward: the
program's ``repro_torch.scan_bwd`` ranges (``models/ssm.py``,
``chunk_scan_grads``, opened on autograd's thread, which launches the
kernels), in the ranged pass of ``bench/program.py``."""
from bench import program

RANGES = ()


def read(trace):
    return program.kernels_ms(trace, ("scan_bwd",))
