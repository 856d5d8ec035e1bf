"""Time per output token: the 95th percentile of the device ms between
consecutive ends of a call's ``prefill`` and ``decode_step`` spans
(``models/serve_llm.py``; each end is a CUDA event), over the span pass
of ``bench/program.py``."""
import numpy as np

from bench import program

RANGES = ()


def read(trace):
    gaps = program.token_intervals_ms(trace)
    return None if gaps is None else float(np.percentile(gaps, 95))
