"""Device ms a decode step of the MoE's routing and its one-hot dispatch
and combine, expert GEMMs left out: the kernels under the program's
``repro_torch.moe_route`` and ``repro_torch.moe_dispatch`` ranges inside
``repro_torch.decode_step`` (``models/ffn.py``, ``models/serve_llm.py``),
in the ranged pass of ``bench/program.py``."""
from bench import program

RANGES = ()


def read(trace):
    p = program.of(trace)
    if p is None or p.ranged is None:
        return None
    steps = sum(u.get("decode_steps", 0) for u in p.ranged.units)
    return program.kernels_ms(trace, ("moe_route", "moe_dispatch"), within="decode_step",
                              per=steps)
