"""The numbers that decide ``correct``, and their limits.

Training (by leaf of the optimizer's tree, the reference's per-layer
weights stacked as the program stacks them):

* ``loss_gap``: the largest ``|L - L_ref| / |L_ref|`` over the checked steps;
* ``grad_gap``: the largest gap of the first gradient's norms,
  ``|n - n_ref| / max(n_ref, median leaf's n_ref)``;
* ``raw_gap``: the same before clipping (the clip's one factor taken out
  of every leaf), ``norm_gap`` the gap of the global norms;
* ``cos_gap``: the largest ``1 - cosine`` of the first gradient, the
  optimizer's first moment against the reference's;
* ``update_gap``: the largest gap of the parameters' change after the
  checked steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (the others move by round-off alone).

Each ``*_gap`` but the loss's has its median leaf beside it (``*_gap_med``).

Serving (by request of the sampled calls): ``gap_max``, the widest gap by
which a served token's reference logit lies below the reference's best at
its position; ``gap_mean``, ``off_first`` (the share of served tokens
that are not the reference's first choice) and ``rank_max``; each
request's largest first-token logit error, over the requests as
``logit_err_max``, ``logit_err_p90`` and ``logit_err_med``; and
``first_not_argmax``, the first tokens that are not the first choice of the
logits the engine served them from.

A cell's limits are ``bench/limits/<cell>.json``: ``{"limits": {name:
limit}}``.  A run is correct where every limited number is finite and at
most its limit.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

GRAD_FLOOR = 1e-3


def lr_at(o, step: int) -> float:
    """The learning rate of step ``step`` (1-based): linear warm-up, then
    cosine decay, as the configured schedule states."""
    warm = min(step / max(1, o["warmup_steps"]), 1.0)
    prog = min(max((step - o["warmup_steps"]) / max(1, o["total_steps"] - o["warmup_steps"]), 0.0),
               1.0)
    return o["lr"] * warm * 0.5 * (1.0 + math.cos(math.pi * prog))


def _stack(per_layer: Dict[str, float], layers) -> Dict[str, float]:
    return {leaf: math.sqrt(sum(per_layer[n] ** 2 for n in names)) for leaf, names in layers.items()}


def _gaps(prog, ref, leaves, top: int = 3):
    """Each leaf's ``|n - n_ref| / max(n_ref, median leaf's n_ref)``: the
    ``top`` worst leaves with their gaps, worst first, and the median
    leaf's gap."""
    med = statistics.median(ref[n] for n in leaves)
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in leaves}
    worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return worst, statistics.median(gaps.values())


def train_numbers(prog, ref, layers, clip: float, cos=None):
    ref_grad, ref_delta = _stack(ref["grad"], layers), _stack(ref["delta"], layers)
    rel = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]
    grad_top, grad_med = _gaps(prog["grad"], ref_grad, list(layers))
    # before clipping: the clip's one factor taken out of every leaf
    unclip = lambda g, gn: {n: v / min(1.0, clip / max(gn, 1e-30)) for n, v in g.items()}
    raw_top, raw_med = _gaps(unclip(prog["grad"], prog["grad_norm"]),
                             unclip(ref_grad, ref["grad_norm"]), list(layers))
    med = statistics.median(ref_grad.values())
    moving = [n for n in layers if ref_grad[n] >= GRAD_FLOOR * med]
    update_top, update_med = _gaps(prog["delta"], ref_delta, moving)
    numbers = {"loss_gap": max(rel), "loss_gap1": rel[0], "grad_gap": grad_top[0][1],
               "grad_gap_med": grad_med, "raw_gap": raw_top[0][1], "raw_gap_med": raw_med,
               "norm_gap": abs(prog["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"],
               "update_gap": update_top[0][1], "update_gap_med": update_med}
    if cos:
        off = {n: 1.0 - c for n, c in cos.items()}
        numbers["cos_gap"] = max(off.values())
        numbers["cos_gap_med"] = statistics.median(off.values())
    detail = {"grad_worst": grad_top, "raw_worst": raw_top, "update_worst": update_top,
              "still": sorted(set(layers) - set(moving)),
              "loss": prog["loss"], "loss_ref": ref["loss"],
              "grad_norm": prog.get("grad_norm"), "grad_norm_ref": ref.get("grad_norm")}
    return numbers, detail


def decide(numbers: Dict[str, float], limits: Dict[str, float]):
    """``(correct, [(name, value, limit)])``: every limited number finite
    and within its limit; a cell without limits is not correct."""
    rows = [(n, numbers[n], limits.get(n)) for n in numbers]
    ok = bool(limits) and all(
        n in numbers and math.isfinite(numbers[n]) and numbers[n] <= lim for n, lim in limits.items())
    return ok, rows
