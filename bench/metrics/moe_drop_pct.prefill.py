"""The MoE's dropped (token, slot) pairs over those routed in prefill
(``models/ffn.py``'s counters ``llm.moe.slots_dropped.prefill`` and
``llm.moe.slots_routed.prefill``), over the span pass of
``bench/program.py``, in %."""
from bench import program

RANGES = ()


def read(trace):
    return program.drop_pct(trace, "prefill")
