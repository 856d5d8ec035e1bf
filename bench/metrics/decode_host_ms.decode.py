"""Host ms of a decode step's enqueue: the median of the ``decode_step``
spans' host stamps (``models/serve_llm.py``), over the span pass of
``bench/program.py``.  Near the step's device time, the host paces
decode."""
import numpy as np

from bench import program

RANGES = ()


def read(trace):
    ms = program.host_ms(trace, "decode_step")
    return None if ms is None else float(np.median(ms))
