"""Device ms a step of the training forward: each ``forward`` span's CUDA
event pair (``train/step.py``, around ``model.train_loss``), summed over a
step's microbatches, in the span pass of ``bench/program.py``."""
from bench import program

RANGES = ()


def read(trace):
    return program.device_ms_per_unit(trace, "forward")
