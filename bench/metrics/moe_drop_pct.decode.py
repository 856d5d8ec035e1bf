"""The MoE's dropped (token, slot) pairs over those routed in the decode
steps (``models/ffn.py``'s counters ``llm.moe.slots_dropped.decode_step``
and ``llm.moe.slots_routed.decode_step``), over the span pass of
``bench/program.py``, in %."""
from bench import program

RANGES = ()


def read(trace):
    return program.drop_pct(trace, "decode_step")
