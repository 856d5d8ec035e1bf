"""The share of attention's backwards that ran the hand-written kernel:
``models/attention.py``'s counters ``llm.attn.bwd_kernel`` over
``llm.attn.bwd_calls``, over the span pass of ``bench/program.py``, in %.
Nothing where the program counts no backward."""
from bench import program

RANGES = ()


def read(trace):
    p = program.of(trace)
    if p is None:
        return None
    calls = p.counters.get("llm.attn.bwd_calls", 0)
    if calls <= 0:
        return None
    return 100.0 * p.counters.get("llm.attn.bwd_kernel", 0) / calls
