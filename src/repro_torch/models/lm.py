"""Decoder-only LM assembly (dense, moe, hybrid, rwkv and vlm families).

Layers are organized into **groups**, contiguous runs of identical blocks
(``layer_groups``), exactly as in the reference (``repro/models/lm.py``):
hymba's few full-attention layers between sliding-window runs make several
groups.  The reference scans each group over stacked parameters; here each
layer is a :class:`Block` module holding its own parameters and the groups
are a Python loop.  Decode caches keep the reference's per-group layout:
one dict per group of tensors stacked over its layers.

Three entry points: ``train_loss(batch, params)``, ``prefill(batch,
cache_len)`` and ``decode_step(caches, tokens, pos)``.  Every group's
prefill ring has capacity ``cache_len``, filled from the last
``cache_len`` tokens (the reference's layout, ring divergence included:
see ROADMAP Queue C).  The current token's k/v is
appended logically during the decode attention, then written at slot
``pos % W``; the port writes that slot, and the SSM state, into the caches
in place.  An rwkv group keeps no ring: its cache is the constant-size
decode state (both token shifts and the wkv state), also updated in place.

A moe block (mixtral, grok) is a dense block whose MLP is
:func:`~repro_torch.models.ffn.moe_fwd`; its cache is the dense one's.  A
vlm (llava) prepends the batch's ``vision_embeds`` to the token embeddings
in prefill and training, so positions run over the patches first; the loss
masks the patches out and the labels are left-padded to match.

``train_loss`` runs the blocks of every family without caches (the rwkv
block from the zero state), each under the reference's
rematerialisation policy (``remat_policy``: ``"none"``, the
default, recomputes every block in the backward; ``"dots"`` keeps the
weight products; ``"full"`` keeps everything), and the loss through
:func:`chunked_xent`.  It takes either the model's own parameters or a
tree in the reference's layout (stacked groups), which is what the train
step and the optimizer work on.  Attention, the scan and wkv6 run their
kernels forward and their torch-op backwards (``attention._Flash``,
``ssm._SsmScan``, ``rwkv._Wkv6``).

The reference's ``constrain`` sharding hints pin activation shardings for
its compiler; the port's counterpart is ``parallel/axes.py``, and the model
calls none: the sharded step (``parallel/sharding.py``) gathers the weights
and computes on plain tensors.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from ..configs.base import ArchConfig
from . import rwkv as rwkv_mod
from . import ssm as ssm_mod
from .attention import attend, decode_attend
from .common import (ParamSpec, ParamTree, apply_norm, apply_rope, dense_spec, iter_leaves,
                     norm_spec, stack_specs)
from .ffn import mlp_fwd, mlp_spec, moe_fwd, moe_spec


@dataclasses.dataclass(frozen=True)
class GroupDef:
    kind: str                 # 'dense' | 'moe' | 'hymba' | 'rwkv'
    n_layers: int
    window: Optional[int]     # sliding window (None = full attention)


def layer_groups(cfg: ArchConfig) -> List[GroupDef]:
    if cfg.rwkv is not None:
        return [GroupDef("rwkv", cfg.n_layers, None)]
    kind = "hymba" if cfg.ssm is not None else ("moe" if cfg.moe is not None else "dense")
    if cfg.sliding_window is None or not cfg.full_attn_layers:
        return [GroupDef(kind, cfg.n_layers, cfg.sliding_window)]
    groups: List[GroupDef] = []
    full = sorted(set(cfg.full_attn_layers))
    prev = 0
    for fi in full:
        if fi > prev:
            groups.append(GroupDef(kind, fi - prev, cfg.sliding_window))
        groups.append(GroupDef(kind, 1, None))
        prev = fi + 1
    if prev < cfg.n_layers:
        groups.append(GroupDef(kind, cfg.n_layers - prev, cfg.sliding_window))
    return groups


# --- per-block specs ----------------------------------------------------------

def attn_spec(cfg: ArchConfig) -> Dict[str, Any]:
    d, hd = cfg.d_model, cfg.hd
    spec = {
        "wq": dense_spec(d, cfg.n_heads * hd, ("embed", "heads")),
        "wk": dense_spec(d, cfg.n_kv_heads * hd, ("embed", "kv_heads")),
        "wv": dense_spec(d, cfg.n_kv_heads * hd, ("embed", "kv_heads")),
        "wo": dense_spec(cfg.n_heads * hd, d, ("heads", "embed")),
    }
    if cfg.qkv_bias:
        spec["bq"] = ParamSpec((cfg.n_heads * hd,), ("heads",), torch.bfloat16, "zeros")
        spec["bk"] = ParamSpec((cfg.n_kv_heads * hd,), ("kv_heads",), torch.bfloat16, "zeros")
        spec["bv"] = ParamSpec((cfg.n_kv_heads * hd,), ("kv_heads",), torch.bfloat16, "zeros")
    return spec


def block_spec(cfg: ArchConfig, kind: str) -> Dict[str, Any]:
    d = cfg.d_model
    if kind == "rwkv":
        r = cfg.rwkv
        s = rwkv_mod.rwkv_spec(d, cfg.d_ff, r.n_heads, r.head_dim, r.decay_lora)
        return {"ln1": norm_spec(cfg, d), "time": s["time"], "ln2": norm_spec(cfg, d),
                "channel": s["channel"]}
    spec: Dict[str, Any] = {"ln1": norm_spec(cfg, d), "attn": attn_spec(cfg), "ln2": norm_spec(cfg, d)}
    if kind == "moe":
        spec["moe"] = moe_spec(d, cfg.d_ff, cfg.moe.n_experts)
    else:
        spec["mlp"] = mlp_spec(d, cfg.d_ff, style=cfg.mlp_style)
    if kind == "hymba":
        s = cfg.ssm
        spec["ssm"] = ssm_mod.ssm_spec(d, s.n_heads, s.head_dim, s.state_dim, s.conv_width)
        spec["attn_branch_norm"] = norm_spec(cfg, d)
        spec["ssm_branch_norm"] = norm_spec(cfg, d)
    return spec


def top_spec(cfg: ArchConfig) -> Dict[str, Any]:
    """The parameters outside the blocks."""
    d = cfg.d_model
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed")),
        "final_norm": norm_spec(cfg, d),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = dense_spec(d, cfg.vocab, ("embed", "vocab"))
    return specs


def param_specs(cfg: ArchConfig) -> Dict[str, Any]:
    """The reference's parameter tree: ``groups`` holds one spec dict per
    group with every leaf stacked over the group's layers."""
    specs = top_spec(cfg)
    specs["groups"] = [stack_specs(block_spec(cfg, g.kind), g.n_layers)
                       for g in layer_groups(cfg)]
    return specs


# --- attention plumbing ----------------------------------------------------------

def _qkv(cfg: ArchConfig, p: nn.Module, x: torch.Tensor, positions: torch.Tensor):
    b, s, d = x.shape
    hd = cfg.hd
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_prefill(cfg: ArchConfig, p, x, positions, window, cache_len):
    q, k, v = _qkv(cfg, p, x, positions)
    out = attend(q, k, v, causal=True, window=window, logit_softcap=cfg.attn_softcap)
    b, s = q.shape[:2]
    y = out.reshape(b, s, -1) @ p.wo
    return y, {"k": ring(k, cache_len), "v": ring(v, cache_len)}


def ring(t: torch.Tensor, cache_len: int) -> torch.Tensor:
    """A ring cache of capacity ``cache_len`` from the last ``cache_len``
    positions of ``t`` (B, S, H, D), in slots 0..cache_len-1 (the
    reference's layout), zero-padded when S is shorter."""
    s = t.shape[1]
    if s >= cache_len:
        return t[:, -cache_len:].contiguous()
    return F.pad(t, (0, 0, 0, 0, 0, cache_len - s))


def _attn_decode(cfg: ArchConfig, p, x, cache, pos: int, window):
    """x: (B,1,d); cache k/v: (B,W,Kh,hd), written at slot pos % W in place;
    pos: absolute position."""
    b = x.shape[0]
    w = cache["k"].shape[1]
    dev = x.device
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=dev)
    q, k, v = _qkv(cfg, p, x, positions)
    k_all = torch.cat([cache["k"], k], dim=1)
    v_all = torch.cat([cache["v"], v], dim=1)
    # slot i (if occupied) holds absolute position pos-1 - ((pos-1-i) mod W);
    # the sliding window also drops slots with pos - that >= window
    idx = torch.arange(w, device=dev)
    valid = idx < min(pos, w)
    if window is not None:
        slot_pos = pos - 1 - torch.remainder(pos - 1 - idx, w)
        valid = valid & (pos - slot_pos < window)
    valid = torch.cat([valid, torch.ones(1, dtype=torch.bool, device=dev)])  # the current token
    out = decode_attend(q, k_all, v_all, valid, logit_softcap=cfg.attn_softcap)
    y = out.reshape(b, 1, -1) @ p.wo
    slot = pos % w
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    return y


def ffn(cfg: ArchConfig, kind: str, p, x: torch.Tensor) -> torch.Tensor:
    """The block's feed-forward on the already normed ``x``: the MoE for a
    moe block, the MLP otherwise."""
    if kind == "moe":
        m = cfg.moe
        return moe_fwd(p.moe, x, n_experts=m.n_experts, top_k=m.top_k,
                       capacity_factor=m.capacity_factor, group_size=m.group_size)
    return mlp_fwd(p.mlp, x, style=cfg.mlp_style)


# --- blocks --------------------------------------------------------------------

class Block(ParamTree):
    """One decoder layer: its parameters (``ln1``, ``attn``, ``ln2``,
    ``mlp`` (``moe`` for a moe block), and for hymba ``ssm`` and the two branch norms; for rwkv
    ``ln1``, ``time``, ``ln2``, ``channel``) and its prefill and decode
    passes."""

    def __init__(self, cfg: ArchConfig, g: GroupDef, device, dtype):
        super().__init__(block_spec(cfg, g.kind), device, dtype)
        self.cfg, self.kind, self.window = cfg, g.kind, g.window

    def _ffn(self, x):
        return ffn(self.cfg, self.kind, self, apply_norm(self.cfg, self.ln2, x))

    def _mix(self, a, m):
        cfg = self.cfg
        return 0.5 * (apply_norm(cfg, self.attn_branch_norm, a)
                      + apply_norm(cfg, self.ssm_branch_norm, m))

    def _rwkv(self, x, cache: Optional[Dict[str, torch.Tensor]]):
        """The rwkv layer from the zero state (``cache=None``, a prefill) or
        from ``cache``.  Returns (x, the new decode state)."""
        cfg, r = self.cfg, self.cfg.rwkv
        xn = apply_norm(cfg, self.ln1, x)
        y, att_x, wkv = rwkv_mod.time_mix(self.time, xn, cache, r.n_heads, r.head_dim)
        x = x + y
        xn2 = apply_norm(cfg, self.ln2, x)
        prev = xn2.new_zeros(xn2.shape[0], xn2.shape[2]) if cache is None else cache["ffn_x"]
        y, ffn_x = rwkv_mod.channel_mix(self.channel, xn2, prev)
        return x + y, {"att_x": att_x, "ffn_x": ffn_x, "wkv": wkv}

    def prefill(self, x, positions, cache_len: int):
        if self.kind == "rwkv":
            return self._rwkv(x, None)
        cfg = self.cfg
        xn = apply_norm(cfg, self.ln1, x)
        a, cache = _attn_prefill(cfg, self.attn, xn, positions, self.window, cache_len)
        if self.kind == "hymba":
            s = cfg.ssm
            m, ssm_st = ssm_mod.ssm_scan(self.ssm, xn, None, s.n_heads, s.head_dim, s.state_dim)
            x = x + self._mix(a, m)
            cache = {**cache, **ssm_st}
        else:
            x = x + a
        return x + self._ffn(x), cache

    def decode(self, x, cache: Dict[str, torch.Tensor], pos: int):
        """``cache`` holds this layer's views into the group's stacked
        caches; they are updated in place."""
        if self.kind == "rwkv":
            x, new = self._rwkv(x, cache)
            for k, t in new.items():
                cache[k].copy_(t)
            return x
        cfg = self.cfg
        xn = apply_norm(cfg, self.ln1, x)
        a = _attn_decode(cfg, self.attn, xn, cache, pos, self.window)
        if self.kind == "hymba":
            s = cfg.ssm
            m, ssm_st = ssm_mod.ssm_step(self.ssm, xn, {"conv": cache["conv"], "ssm": cache["ssm"]},
                                         s.n_heads, s.head_dim, s.state_dim)
            cache["conv"].copy_(ssm_st["conv"])
            cache["ssm"].copy_(ssm_st["ssm"])
            x = x + self._mix(a, m)
        else:
            x = x + a
        return x + self._ffn(x)


# --- training -------------------------------------------------------------------

class _Tree:
    """Attribute access over a nested dict of tensors, so one layer's slice
    of a stacked reference tree reads like a :class:`Block`
    (``p.attn.wq``)."""

    __slots__ = ("_d",)

    def __init__(self, d: Dict[str, Any]):
        self._d = d

    def __getattr__(self, name):
        try:
            v = self._d[name]
        except KeyError:
            raise AttributeError(name) from None
        return _Tree(v) if isinstance(v, dict) else v


def block_train(cfg: ArchConfig, kind: str, window: Optional[int], p, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """One layer of ``kind`` without a cache (the reference's block
    ``fwd``); ``p`` is a :class:`Block` or one layer of a reference tree."""
    if kind == "rwkv":
        r = cfg.rwkv
        y, _, _ = rwkv_mod.time_mix(p.time, apply_norm(cfg, p.ln1, x), None, r.n_heads, r.head_dim)
        x = x + y
        xn2 = apply_norm(cfg, p.ln2, x)
        y, _ = rwkv_mod.channel_mix(p.channel, xn2, xn2.new_zeros(xn2.shape[0], xn2.shape[2]))
        return x + y
    xn = apply_norm(cfg, p.ln1, x)
    q, k, v = _qkv(cfg, p.attn, xn, positions)
    out = attend(q, k, v, causal=True, window=window, logit_softcap=cfg.attn_softcap)
    b, s = q.shape[:2]
    a = out.reshape(b, s, -1) @ p.attn.wo
    if kind == "hymba":
        sc = cfg.ssm
        m, _ = ssm_mod.ssm_scan(p.ssm, xn, None, sc.n_heads, sc.head_dim, sc.state_dim)
        a = 0.5 * (apply_norm(cfg, p.attn_branch_norm, a) + apply_norm(cfg, p.ssm_branch_norm, m))
    x = x + a
    return x + ffn(cfg, kind, p, apply_norm(cfg, p.ln2, x))


def _xent(logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """(sum of the token losses, their count) in float32: the log-sum-exp
    about the detached row max, minus the label's logit (a gather, where
    the reference contracts with a one-hot; the picked value is the same)."""
    lg = logits.float()
    m = lg.amax(dim=-1, keepdim=True).detach()
    lse = m[..., 0] + torch.log(torch.sum(torch.exp(lg - m), dim=-1))
    lab = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    nll = lse - lab
    if mask is not None:
        return (nll * mask).sum(), mask.sum()
    return nll.sum(), torch.tensor(float(nll.numel()), device=nll.device)


def chunked_xent(x: torch.Tensor, unembed_w: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None, chunk: int = 1024) -> torch.Tensor:
    """Sequence-chunked unembed and cross entropy: each chunk's (B, c, V)
    logits exist only inside its checkpoint and are recomputed in the
    backward, so the (B, S, V) logits never do.  As in the reference, a
    sequence that ``chunk`` does not divide, or that is no longer than it,
    takes one unchunked pass."""
    b, s, d = x.shape
    if s % chunk != 0 or s <= chunk:
        total, count = _xent(x @ unembed_w, labels, mask)
        return total / torch.clamp(count, min=1.0)

    def body(x_c, w, lab_c, m_c):
        return _xent(x_c @ w, lab_c, m_c)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, chunk):
        m_c = (mask[:, i:i + chunk] if mask is not None
               else torch.ones((b, chunk), dtype=torch.float32, device=x.device))
        t, c = ckpt.checkpoint(body, x[:, i:i + chunk], unembed_w, labels[:, i:i + chunk], m_c,
                               use_reentrant=False)
        total, count = total + t, count + c
    return total / torch.clamp(count, min=1.0)


def _save_products(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of plain matrix products (the
    weight products, the reference's dots with no batch dims) and
    recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


REMAT_POLICIES = ("none", "dots", "full")


def remat(policy: str, fn):
    """``fn`` under the reference's rematerialisation policy."""
    if policy == "none":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        ctx = functools.partial(ckpt.create_selective_checkpoint_contexts, _save_products)
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False, context_fn=ctx)
    if policy == "full":     # no rematerialisation
        return fn
    raise ValueError(f"unknown remat_policy {policy!r}; one of {REMAT_POLICIES}")


def unstack_group(group: Dict[str, Any], n_layers: int) -> List[_Tree]:
    """One :class:`_Tree` per layer over a group's stacked leaves (views by
    ``unbind``, whose backward stacks the layers' gradients in one op)."""
    layers: List[Dict[str, Any]] = [{} for _ in range(n_layers)]
    for name, leaf in iter_leaves(group):
        *path, last = name.split(".")
        for i, piece in enumerate(leaf.unbind(0)):
            node = layers[i]
            for part in path:
                node = node.setdefault(part, {})
            node[last] = piece
    return [_Tree(layer) for layer in layers]


# --- cache specs ------------------------------------------------------------------

def group_cache_spec(cfg: ArchConfig, g: GroupDef, batch: int, cache_len: int) -> Dict[str, ParamSpec]:
    """Stacked (over layers) decode-cache shapes + logical axes, as the
    reference declares them (its prefill fills every group's ring at
    ``cache_len``); a moe group's cache is the dense one's."""
    L = g.n_layers
    if g.kind == "rwkv":
        r = cfg.rwkv
        return {
            "att_x": ParamSpec((L, batch, cfg.d_model), ("layers", "batch", "embed"),
                               torch.bfloat16, "zeros"),
            "ffn_x": ParamSpec((L, batch, cfg.d_model), ("layers", "batch", "embed"),
                               torch.bfloat16, "zeros"),
            "wkv": ParamSpec((L, batch, r.n_heads, r.head_dim, r.head_dim),
                             ("layers", "batch", "heads", None, None), torch.float32, "zeros"),
        }
    w = cache_len if g.window is None else min(g.window, cache_len)
    spec = {
        "k": ParamSpec((L, batch, w, cfg.n_kv_heads, cfg.hd),
                       ("layers", "batch", "kv_seq", "kv_heads", "head_dim"), torch.bfloat16, "zeros"),
        "v": ParamSpec((L, batch, w, cfg.n_kv_heads, cfg.hd),
                       ("layers", "batch", "kv_seq", "kv_heads", "head_dim"), torch.bfloat16, "zeros"),
    }
    if g.kind == "hymba":
        s = cfg.ssm
        di = s.n_heads * s.head_dim
        spec["conv"] = ParamSpec((L, batch, s.conv_width - 1, di),
                                 ("layers", "batch", None, "heads"), torch.bfloat16, "zeros")
        spec["ssm"] = ParamSpec((L, batch, s.n_heads, s.head_dim, s.state_dim),
                                ("layers", "batch", "heads", "head_dim", None), torch.float32, "zeros")
    return spec


def cache_specs(cfg: ArchConfig, batch: int, cache_len: int) -> List[Dict[str, ParamSpec]]:
    return [group_cache_spec(cfg, g, batch, cache_len) for g in layer_groups(cfg)]


# --- model assembly --------------------------------------------------------------

class LM(ParamTree):
    """Decoder-only LM: ``embed``, ``final_norm``, ``unembed`` (unless
    tied) and one :class:`Block` per layer in ``blocks``."""

    def __init__(self, cfg: ArchConfig, device, dtype: torch.dtype, remat_policy: str = "none"):
        super().__init__(top_spec(cfg), device, dtype)
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {remat_policy!r}; one of {REMAT_POLICIES}")
        self.cfg = cfg
        self.remat_policy = remat_policy
        self.groups = layer_groups(cfg)
        self.blocks = nn.ModuleList(
            Block(cfg, g, device, dtype) for g in self.groups for _ in range(g.n_layers))

    def param_specs(self):
        return param_specs(self.cfg)

    def cache_specs(self, batch: int, cache_len: int):
        return cache_specs(self.cfg, batch, cache_len)

    def stacks(self):
        """``(key, blocks)`` per stacked leaf group of the reference's tree:
        ``("groups", g)`` holds group g's blocks."""
        return [(("groups", i), blocks) for i, (_, blocks) in enumerate(self._group_blocks())]

    def _group_blocks(self):
        j = 0
        for g in self.groups:
            yield g, self.blocks[j:j + g.n_layers]
            j += g.n_layers

    def _unembed(self, x):
        x = apply_norm(self.cfg, self.final_norm, x)
        w = self.embed.t() if self.cfg.tie_embeddings else self.unembed
        return x @ w

    def train_loss(self, batch: Dict[str, torch.Tensor], params: Optional[Dict[str, Any]] = None):
        """The mean token cross entropy of ``batch`` (``tokens`` and
        ``labels``, (B, S); a vlm also ``vision_embeds``, (B, P, d)) as a
        float32 scalar.  ``params``: a tree in the reference's layout
        (:func:`~repro_torch.models.weights.to_reference` on the model's
        device), or None for the model's own parameters."""
        cfg = self.cfg
        if params is None:
            top, layers = self, [blocks for _, blocks in self._group_blocks()]
        else:
            top = _Tree(params)
            layers = [unstack_group(gp, g.n_layers) for g, gp in zip(self.groups, params["groups"])]
        tokens, labels = batch["tokens"], batch["labels"]
        x = top.embed[tokens.long()]
        mask = None
        if cfg.vlm is not None:
            ve = batch["vision_embeds"].to(x.dtype)
            x = torch.cat([ve, x], dim=1)
            mask = torch.cat([torch.zeros(ve.shape[:2], dtype=torch.float32, device=x.device),
                              torch.ones(tokens.shape, dtype=torch.float32, device=x.device)], dim=1)
            labels = F.pad(labels, (x.shape[1] - labels.shape[1], 0))
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        for g, group in zip(self.groups, layers):
            fn = remat(self.remat_policy, functools.partial(block_train, cfg, g.kind, g.window))
            for p in group:
                x = fn(p, x, positions)
        x = apply_norm(cfg, top.final_norm, x)
        w = top.embed.t() if cfg.tie_embeddings else top.unembed
        return chunked_xent(x, w, labels, mask)

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], cache_len: int) -> Tuple[torch.Tensor, List[Dict]]:
        """``batch["tokens"]``: (B, S) (a vlm's ``vision_embeds``, (B, P, d),
        go first) -> (last-position logits (B, 1, V), caches)."""
        x = self.embed[batch["tokens"].long()]
        if self.cfg.vlm is not None:
            x = torch.cat([batch["vision_embeds"].to(x.dtype), x], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        caches = []
        for _, blocks in self._group_blocks():
            per_layer = []
            for blk in blocks:
                x, c = blk.prefill(x, positions, cache_len)
                per_layer.append(c)
            caches.append({k: torch.stack([c[k] for c in per_layer]) for k in per_layer[0]})
        return self._unembed(x[:, -1:, :]), caches

    @torch.no_grad()
    def decode_step(self, caches: List[Dict], tokens: torch.Tensor, pos: int):
        """tokens: (B, 1); pos: absolute position.  Returns (logits (B, 1,
        V), caches): the caches passed in, updated in place."""
        x = self.embed[tokens.long()]
        for (_, blocks), cache in zip(self._group_blocks(), caches):
            for i, blk in enumerate(blocks):
                x = blk.decode(x, {k: t[i] for k, t in cache.items()}, int(pos))
        return self._unembed(x), caches
