"""Device ms a step of attention's backward: each ``flash_bwd`` span's CUDA
event pair (``models/attention.py``, ``_Flash.backward``, opened on
autograd's thread around the backward kernel or its torch-op twin
``_flash_bwd``; an event pair sees the kernel's driver-API launches, which
no profiler range parents), summed over a step, in the span pass of
``bench/program.py``.  Nothing where the program has no ``flash_bwd`` stage."""
from bench import program

RANGES = ()


def read(trace):
    from repro_torch.trace import span

    if "flash_bwd" not in span.STAGE_NAMES:
        return None
    return program.device_ms_per_unit(trace, "flash_bwd")
