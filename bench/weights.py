"""The weights of a cell, made from ``--seed`` on the device.

:func:`fill` writes every weight of a reference's ``param_list`` into
tensors the caller holds: the program's own parameters, or the reference's
copies after the program has gone.  Both sides get the same values: the
normal draws are taken in bfloat16, the type they are served in, a few
calls of up to ``CHUNK`` elements each, from one generator on the device.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

CHUNK = 1 << 30
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def std(shape, scale: float) -> float:
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return scale / math.sqrt(max(1, fan_in))


@torch.no_grad()
def fill(targets: Dict[str, torch.Tensor], plist, seed: int) -> None:
    """Fill ``targets`` (name -> tensor of the listed shape and dtype) from
    ``seed``; every name of ``plist`` must be there, and no other."""
    names = [p[0] for p in plist]
    if set(names) != set(targets) or len(names) != len(targets):
        extra = sorted(set(targets) - set(names))[:5]
        missing = sorted(set(names) - set(targets))[:5]
        raise ValueError(f"weights: not in the reference {extra}, not in the target {missing}")
    device = next(iter(targets.values())).device
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    for name, shape, dt, _, _ in plist:
        t = targets[name]
        if tuple(t.shape) != tuple(shape) or t.dtype != DTYPES[dt]:
            raise ValueError(f"weights: {name} is {tuple(t.shape)} {t.dtype}, "
                             f"the reference has {tuple(shape)} {dt}")
    normal = [p for p in plist if p[3] == "normal"]
    i = 0
    while i < len(normal):
        j, total = i, 0
        while j < len(normal) and (j == i or total + math.prod(normal[j][1]) <= CHUNK):
            total += math.prod(normal[j][1])
            j += 1
        buf = torch.randn(total, generator=gen, device=device, dtype=torch.bfloat16)
        off = 0
        for name, shape, _, _, scale in normal[i:j]:
            n = math.prod(shape)
            targets[name].copy_(buf[off:off + n].view(shape) * std(shape, scale))
            off += n
        del buf
        i = j
    decay = [p for p in plist if p[3] == "decay"]
    if decay:
        u = torch.rand(sum(math.prod(p[1]) for p in decay), generator=gen, device=device)
        off = 0
        for name, shape, _, _, _ in decay:
            n = math.prod(shape)
            targets[name].copy_(-0.5 - u[off:off + n].view(shape))
            off += n
    for name, _, _, init, _ in plist:
        if init == "ones":
            targets[name].fill_(1.0)
        elif init == "zeros":
            targets[name].zero_()


def allocate(plist, device) -> Dict[str, torch.Tensor]:
    return {name: torch.empty(shape, dtype=DTYPES[dt], device=device)
            for name, shape, dt, _, _ in plist}
