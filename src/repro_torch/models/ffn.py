"""Feed-forward blocks: gated MLP (llama-style), gelu MLP (whisper), and
top-k MoE with grouped capacity dispatch (mixtral / grok).

MoE dispatch, as in the reference (``repro/models/ffn.py``): the tokens of
the whole batch are flattened and cut into groups of ``group_size`` (a
padded last group is masked); within a group, top-k routing builds
dispatch and combine tensors of shape ``(G, g, E, C)`` with per-group
capacity ``C = max(ceil(g * k * cf / E), k)``.  A slot past its expert's
capacity is dropped, slot 0 of every token before slot 1 of any (the t5x
convention).  The reference computes the MoE outside any Pallas kernel;
the port's is plain torch einsums and matmuls in the reference's order and
dtypes (router logits, probabilities and gates in float32, the SiLU in
float32, the products in the activations' dtype).

With the tracer on, a call opens a ``moe_route`` span and two
``moe_dispatch`` spans (building the dispatch and combine tensors with the
gather product; the scatter product), the expert GEMMs between them, and
adds its routed and dropped (token, slot) pairs to the registry's
``llm.moe.slots_routed.<phase>`` and ``llm.moe.slots_dropped.<phase>``,
``<phase>`` the outermost span around it (``prefill``, ``decode_step``,
``forward``).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..obs.metrics import REGISTRY
from ..trace.span import ST_MOE_DISPATCH, ST_MOE_ROUTE, TRACER
from .common import ParamSpec, dense_spec


# --- dense MLPs -------------------------------------------------------------

def mlp_spec(d: int, f: int, style: str = "swiglu") -> Dict[str, ParamSpec]:
    if style == "gelu2":
        return {
            "w_in": dense_spec(d, f, ("embed", "mlp")),
            "b_in": ParamSpec((f,), ("mlp",), torch.bfloat16, "zeros"),
            "w_out": dense_spec(f, d, ("mlp", "embed")),
            "b_out": ParamSpec((d,), (None,), torch.bfloat16, "zeros"),
        }
    return {
        "w_gate": dense_spec(d, f, ("embed", "mlp")),
        "w_up": dense_spec(d, f, ("embed", "mlp")),
        "w_down": dense_spec(f, d, ("mlp", "embed")),
    }


def mlp_fwd(p: nn.Module, x: torch.Tensor, style: str = "swiglu") -> torch.Tensor:
    """The activation runs in float32 and is cast back before the gate
    product, as in the reference (jax.nn.gelu is the tanh form)."""
    if style == "gelu2":
        h = x @ p.w_in + p.b_in
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        return h @ p.w_out + p.b_out
    g = x @ p.w_gate
    u = x @ p.w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ p.w_down


# --- MoE ---------------------------------------------------------------------

def moe_spec(d: int, f: int, n_experts: int) -> Dict[str, ParamSpec]:
    return {
        "router": ParamSpec((d, n_experts), ("embed", None), torch.float32),
        "w_gate": ParamSpec((n_experts, d, f), ("expert", "embed", "mlp")),
        "w_up": ParamSpec((n_experts, d, f), ("expert", "embed", "mlp")),
        "w_down": ParamSpec((n_experts, f, d), ("expert", "mlp", "embed")),
    }


class Route(NamedTuple):
    """One call's routing, per group ``G`` and token ``g`` of the group."""
    top_p: torch.Tensor         # (G, g, k) float32 gates, renormalised
    top_i: torch.Tensor         # (G, g, k) the chosen experts, best first
    pos: torch.Tensor           # (G, g, k) each slot's place in its expert's queue
    keep: torch.Tensor          # (G, g, k) bool: within capacity and a real token
    capacity: int


def moe_route(router: torch.Tensor, xg: torch.Tensor, valid: torch.Tensor, *, n_experts: int,
              top_k: int, capacity_factor: float) -> Route:
    """Top-k routing of the grouped tokens ``xg`` (G, g, d) with the
    reference's float32 router, renormalisation and slot-major capacity
    positions."""
    g = xg.shape[1]
    logits = torch.einsum("Gsd,de->Gse", xg.float(), router)
    probs = torch.softmax(logits, dim=-1)                              # (G, g, E)
    # jax.lax.top_k breaks ties by the lower index; torch.topk promises no
    # order, and every pad token ties all experts (uniform probabilities):
    # a stable descending sort keeps the reference's order
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :top_k], top_i[..., :top_k]              # (G, g, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)  # renorm (mixtral)
    capacity = max(int(math.ceil(g * top_k * capacity_factor / n_experts)), top_k)
    # position of each (slot, token) within its expert: an exclusive cumsum
    # over the slot-major order, slot 0 of all tokens before slot 1
    oh = F.one_hot(top_i, n_experts)                                   # (G, g, k, E) int64
    slot_major = oh.transpose(1, 2).reshape(oh.shape[0], top_k * g, n_experts)
    pos = torch.cumsum(slot_major, dim=1) - slot_major
    pos = pos.reshape(oh.shape[0], top_k, g, n_experts).transpose(1, 2)  # (G, g, k, E)
    pos_of_slot = torch.sum(pos * oh, dim=-1)                          # (G, g, k)
    keep = (pos_of_slot < capacity) & valid[..., None]
    return Route(top_p, top_i, pos_of_slot, keep, capacity)


def moe_fwd(
    p: nn.Module,
    x: torch.Tensor,
    *,
    n_experts: int,
    top_k: int,
    capacity_factor: float,
    group_size: int,
) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  Top-k routing with capacity dropping."""
    b, s, d = x.shape
    tokens = b * s
    g = min(group_size, tokens)
    pad = (-tokens) % g
    flat = x.reshape(tokens, d)
    if pad:
        flat = F.pad(flat, (0, 0, 0, pad))
    n_groups = (tokens + pad) // g
    xg = flat.reshape(n_groups, g, d)
    valid = (torch.arange(tokens + pad, device=x.device) < tokens).reshape(n_groups, g)
    with TRACER.span(ST_MOE_ROUTE, tokens=tokens) as span:
        r = moe_route(p.router, xg, valid, n_experts=n_experts, top_k=top_k,
                      capacity_factor=capacity_factor)
    if TRACER.enabled:     # a kept slot is a routed one: the rest are dropped
        routed = valid.sum() * top_k
        REGISTRY.add_device(f"llm.moe.slots_routed.{span.phase}", routed)
        REGISTRY.add_device(f"llm.moe.slots_dropped.{span.phase}", routed - r.keep.sum())

    # dispatch (G, g, E, C); combine: the same with the gates folded in.  A
    # dropped slot (pos >= C) has an all-zero row of the position one-hot,
    # as jax.nn.one_hot gives (F.one_hot would raise)
    with TRACER.span(ST_MOE_DISPATCH, layer=span.layer, tokens=tokens):
        oh = F.one_hot(r.top_i, n_experts)                             # (G, g, k, E)
        pos_oh = (r.pos[..., None] == torch.arange(r.capacity, device=x.device)).to(x.dtype)
        disp = torch.einsum("GskE,GskC->GsEC", oh.to(x.dtype) * r.keep[..., None].to(x.dtype),
                            pos_oh)
        comb = torch.einsum("GskE,GskC->GsEC",
                            (oh.float() * (r.top_p * r.keep)[..., None]).to(x.dtype), pos_oh)
        expert_in = torch.einsum("GsEC,Gsd->GECd", disp, xg)           # gather as a product

    gate = torch.einsum("GECd,Edf->GECf", expert_in, p.w_gate)
    up = torch.einsum("GECd,Edf->GECf", expert_in, p.w_up)
    h = F.silu(gate.float()).to(x.dtype) * up
    expert_out = torch.einsum("GECf,Efd->GECd", h, p.w_down)
    with TRACER.span(ST_MOE_DISPATCH, layer=span.layer, tokens=tokens):
        out = torch.einsum("GsEC,GECd->Gsd", comb, expert_out)         # scatter as a product
    out = out.reshape(tokens + pad, d)
    if pad:
        out = out[:tokens]
    return out.reshape(b, s, d)
