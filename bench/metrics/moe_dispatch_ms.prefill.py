"""Device ms a prefill call of the MoE's routing and its one-hot dispatch
and combine, expert GEMMs left out: the kernels under the program's
``repro_torch.moe_route`` and ``repro_torch.moe_dispatch`` ranges
(``models/ffn.py``), in the ranged pass of ``bench/program.py``."""
from bench import program

RANGES = ()


def read(trace):
    return program.kernels_ms(trace, ("moe_route", "moe_dispatch"))
