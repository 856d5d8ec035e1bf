"""GPipe-style microbatch pipeline over a mesh axis (default: "pod").

The counterpart of ``repro/parallel/pipeline.py``.  Layers are partitioned
into S = |axis| stages and microbatches streamed through with one hop per
tick (one transfer of one activation tensor per microbatch per boundary).
Bubble fraction: (S-1)/(M+S-1) for M microbatches.

:func:`gpipe_apply` keeps the reference's schedule-transparent form: a
Python loop over T = M+S-1 ticks, each one ``stage_fn`` on the rank's own
stage and one hop to the next stage (``batch_isend_irecv`` on the axis's
process group).  Every send is counted in :data:`HOPS` per boundary
``(s, s+1)``, where the reference's test counts the collective-permutes in
its compiled HLO: each boundary carries T.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable

import torch
import torch.distributed as dist

from ..tree import tree_leaves, tree_map

HOPS: Counter = Counter()     # (stage, stage + 1) -> sends this process made


def reset_hops() -> None:
    HOPS.clear()


def gpipe_apply(stage_fn: Callable, stage_params, microbatches: torch.Tensor, mesh,
                axis: str = "pod") -> torch.Tensor:
    """Run microbatches through S pipeline stages; returns (M, mb, ...) on
    every rank.

    ``stage_params``: a tree whose every leaf is stacked (S, ...) by stage,
    the same on every rank (the rank applies its own slice ``p[idx]``);
    ``microbatches``: (M, mb, ...), the same on every rank.  Every stage
    maps an (mb, ...) tensor to one of the same shape and dtype."""
    dim = list(mesh.mesh_dim_names).index(axis)
    n_stages = mesh.size(dim)
    group = mesh.get_group(axis)
    idx = mesh.get_local_rank(axis)
    n_micro = microbatches.shape[0]
    local = tree_map(lambda p: p[idx], stage_params)
    xs = microbatches
    buf = torch.zeros_like(xs[0])
    ys = torch.zeros_like(xs)
    for t in range(n_micro + n_stages - 1):
        feed = xs[t] if t < n_micro else torch.zeros_like(xs[0])
        out = stage_fn(local, feed if idx == 0 else buf)
        m = t - (n_stages - 1)
        if idx == n_stages - 1 and 0 <= m < n_micro:
            ys[m] = out
        ops = []
        if idx < n_stages - 1:
            ops.append(dist.P2POp(dist.isend, out.contiguous(),
                                  dist.get_global_rank(group, idx + 1), group))
            HOPS[(idx, idx + 1)] += 1
        if idx > 0:
            buf = torch.empty_like(out)
            ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, idx - 1), group))
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
    # deliver the last stage's collected outputs to every rank
    if idx != n_stages - 1:
        ys.zero_()
    dist.all_reduce(ys, group=group)
    return ys


def sequential_reference(stage_fn: Callable, stage_params, microbatches: torch.Tensor) -> torch.Tensor:
    """Oracle: fold every stage over every microbatch sequentially."""
    n_stages = tree_leaves(stage_params)[0].shape[0]
    outs = []
    for m in range(microbatches.shape[0]):
        x = microbatches[m]
        for s in range(n_stages):
            x = stage_fn(tree_map(lambda p: p[s], stage_params), x)
        outs.append(x)
    return torch.stack(outs)
