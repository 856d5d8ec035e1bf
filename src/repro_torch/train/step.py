"""Training step builder: loss, gradients and AdamW, with optional
microbatch gradient accumulation (``accum_steps``) and optional int8
gradient compression (``compress_grads``).

The counterpart of ``repro/train/step.py``.  ``make_train_step`` returns
``step(params, opt_state, batch) -> (params, opt_state, metrics)`` over
the reference's parameter tree (``to_reference(model, device)``); the
gradients are taken with ``torch.autograd.grad`` of the model's
``train_loss`` with respect to that tree's leaves.  Accumulation sums the
microbatches' gradients in float32 and casts their mean to bfloat16, as
the reference does.  With the tracer on, a step is one unit: a
``forward`` and a ``backward`` span a microbatch, then an ``optimizer``
span.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..models.api import Model
from ..optim import adamw
from ..parallel import compression
from ..trace.span import ST_BACKWARD, ST_FORWARD, ST_OPTIMIZER, TRACER
from ..tree import tree_leaves, tree_map, tree_unflatten_like


def loss_and_grads(model: Model, params, batch: Dict[str, torch.Tensor], unit: int = -1):
    """``(loss, grads)``: the model's ``train_loss`` of ``batch`` and its
    gradients with respect to the leaves of ``params``, as a tree of
    ``params``' structure.  ``unit``: the traced step's."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    tokens = batch["tokens"].numel()
    with torch.enable_grad():
        with TRACER.span(ST_FORWARD, unit=unit, tokens=tokens):
            loss = model.train_loss(live, batch)
        with TRACER.span(ST_BACKWARD, unit=unit, tokens=tokens):
            grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten_like(params, list(grads))


def mean_loss_and_grads(model: Model, params, batch: Dict[str, torch.Tensor],
                        accum_steps: int = 1, unit: int = -1):
    """:func:`loss_and_grads` of ``batch``, or with ``accum_steps`` > 1 the
    mean over that many microbatches (each leading-batch leaf split into
    equal parts, in order) of their losses and gradients, summed in float32:
    a float32 loss and float32 gradients."""
    if accum_steps == 1:
        return loss_and_grads(model, params, batch, unit)

    def _split(x):
        b = x.shape[0]
        if b % accum_steps:
            raise ValueError(f"a batch of {b} rows does not split into {accum_steps} microbatches")
        return x.reshape(accum_steps, b // accum_steps, *x.shape[1:])

    micro = {k: _split(v) for k, v in batch.items()}
    gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    loss_sum = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
    for i in range(accum_steps):
        loss, grads = loss_and_grads(model, params, {k: v[i] for k, v in micro.items()}, unit)
        gsum = tree_map(lambda a, g: a + g.float(), gsum, grads)
        loss_sum = loss_sum + loss
    return loss_sum / accum_steps, tree_map(lambda g: g / accum_steps, gsum)


def make_train_step(
    model: Model,
    opt_cfg: adamw.AdamWConfig,
    accum_steps: int = 1,
    compress_grads: bool = False,
):
    def step(params, opt_state, batch: Dict[str, torch.Tensor]):
        unit = TRACER.next_batch_id() if TRACER.enabled else -1
        loss, grads = mean_loss_and_grads(model, params, batch, accum_steps, unit)
        if accum_steps > 1:      # the reference casts the microbatches' mean
            grads = tree_map(lambda g: g.to(torch.bfloat16), grads)

        if compress_grads:
            grads = compression.fake_quantize_tree(grads)

        with TRACER.span(ST_OPTIMIZER, unit=unit):
            params, opt_state, metrics = adamw.update(grads, opt_state, params, opt_cfg)
        metrics = {**metrics, "loss": loss}
        return params, opt_state, metrics

    return step
