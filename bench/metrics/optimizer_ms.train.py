"""Device ms a step of the kernels under the AdamW update
(``repro_torch.optim.adamw.update``, as ``train/step.py`` reaches it)."""
from bench.readers import OPTIMIZER, ms_per_unit

RANGES = (OPTIMIZER,)


def read(trace):
    return ms_per_unit(trace, OPTIMIZER)
