"""Device ms a step of the training backward: each ``backward`` span's
CUDA event pair (``train/step.py``, around ``torch.autograd.grad``; the
backward's kernels run on autograd's thread, which no main-thread range
parents), summed over a step's microbatches, in the span pass of
``bench/program.py``."""
from bench import program

RANGES = ()


def read(trace):
    return program.device_ms_per_unit(trace, "backward")
