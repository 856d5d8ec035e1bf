"""Whisper-style encoder-decoder backbone (the audio frontend is a stub: the
batch supplies precomputed frame embeddings ``frame_embeds`` (B, F,
d_model); the conv1d + mel frontend is out of scope, as in the reference).

Encoder: bidirectional pre-LN blocks (LayerNorm and the gelu MLP), no
positions (the reference folds them into the stub embeddings).  Decoder:
causal self-attention with RoPE, cross-attention over the encoder output,
and the MLP.  The port of ``repro/models/encdec.py``; as in
:mod:`~repro_torch.models.lm`, each layer is a module holding its own
parameters (``enc_blocks``, ``dec_blocks``) and the reference's scans over
stacked layers are Python loops.  The frame embeddings are cast to the
model's dtype (the reference computes with them as given).

Encoder attention and cross-attention go through
:func:`~repro_torch.models.attention.attend_bidir` (the flash kernel with
``causal=False`` on the card), the decoder's self-attention through
:func:`~repro_torch.models.attention.attend`; in training both run
``attention._Flash``.  Decode caches, per decoder layer and stacked over
the layers: the self-attention ring (``k``, ``v``, capacity ``cache_len``)
and the cross-attention K/V (``xk``, ``xv``) that prefill computes once
from the encoder output.  A decode step attends over the ring and the new
token's k/v, then writes them at slot ``pos % cache_len`` in place.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..configs.base import ArchConfig
from .attention import attend, attend_bidir, decode_attend
from .common import ParamSpec, ParamTree, apply_norm, apply_rope, dense_spec, norm_spec, stack_specs
from .ffn import mlp_fwd, mlp_spec
from .lm import REMAT_POLICIES, _Tree, attn_spec, chunked_xent, remat, ring, unstack_group


def _enc_block_spec(cfg: ArchConfig) -> Dict[str, Any]:
    return {
        "ln1": norm_spec(cfg, cfg.d_model),
        "attn": attn_spec(cfg),
        "ln2": norm_spec(cfg, cfg.d_model),
        "mlp": mlp_spec(cfg.d_model, cfg.d_ff, style="gelu2"),
    }


def _dec_block_spec(cfg: ArchConfig) -> Dict[str, Any]:
    return {
        "ln1": norm_spec(cfg, cfg.d_model),
        "self_attn": attn_spec(cfg),
        "ln_x": norm_spec(cfg, cfg.d_model),
        "cross_attn": attn_spec(cfg),
        "ln2": norm_spec(cfg, cfg.d_model),
        "mlp": mlp_spec(cfg.d_model, cfg.d_ff, style="gelu2"),
    }


def top_spec(cfg: ArchConfig) -> Dict[str, Any]:
    """The parameters outside the blocks."""
    return {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed")),
        "enc_norm": norm_spec(cfg, cfg.d_model),
        "final_norm": norm_spec(cfg, cfg.d_model),
        "unembed": dense_spec(cfg.d_model, cfg.vocab, ("embed", "vocab")),
    }


def param_specs(cfg: ArchConfig) -> Dict[str, Any]:
    assert cfg.enc_dec is not None
    specs = top_spec(cfg)
    specs["enc"] = stack_specs(_enc_block_spec(cfg), cfg.enc_dec.enc_layers)
    specs["dec"] = stack_specs(_dec_block_spec(cfg), cfg.n_layers)
    return specs


def _proj_qkv(cfg: ArchConfig, p, xq, xkv, positions_q=None, positions_kv=None):
    b, s, _ = xq.shape
    t = xkv.shape[1]
    hd = cfg.hd
    q = (xq @ p.wq).reshape(b, s, cfg.n_heads, hd)
    k = (xkv @ p.wk).reshape(b, t, cfg.n_kv_heads, hd)
    v = (xkv @ p.wv).reshape(b, t, cfg.n_kv_heads, hd)
    if positions_q is not None:
        q = apply_rope(q, positions_q, cfg.rope_theta)
    if positions_kv is not None:
        k = apply_rope(k, positions_kv, cfg.rope_theta)
    return q, k, v


def _out(p, a: torch.Tensor) -> torch.Tensor:
    b, s = a.shape[:2]
    return a.reshape(b, s, -1) @ p.wo


def enc_block(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    xn = apply_norm(cfg, p.ln1, x)
    q, k, v = _proj_qkv(cfg, p.attn, xn, xn)
    x = x + _out(p.attn, attend_bidir(q, k, v))
    return x + mlp_fwd(p.mlp, apply_norm(cfg, p.ln2, x), style="gelu2")


def dec_block(cfg: ArchConfig, p, x: torch.Tensor, enc_out: torch.Tensor, positions: torch.Tensor):
    """One decoder layer over the whole sequence (the reference's
    ``_dec_block_full``); returns x and the layer's self-attention k, v and
    cross-attention k, v (prefill's caches)."""
    xn = apply_norm(cfg, p.ln1, x)
    q, k, v = _proj_qkv(cfg, p.self_attn, xn, xn, positions, positions)
    x = x + _out(p.self_attn, attend(q, k, v, causal=True))
    xn = apply_norm(cfg, p.ln_x, x)
    qc, kc, vc = _proj_qkv(cfg, p.cross_attn, xn, enc_out)
    x = x + _out(p.cross_attn, attend_bidir(qc, kc, vc))
    return x + mlp_fwd(p.mlp, apply_norm(cfg, p.ln2, x), style="gelu2"), (k, v, kc, vc)


def _dec_block_train(cfg, p, x, enc_out, positions):
    return dec_block(cfg, p, x, enc_out, positions)[0]


class EncDecLM(ParamTree):
    """Encoder-decoder LM: ``embed``, ``enc_norm``, ``final_norm``,
    ``unembed``, and one parameter module per layer in ``enc_blocks`` and
    ``dec_blocks``."""

    def __init__(self, cfg: ArchConfig, device, dtype: torch.dtype, remat_policy: str = "none"):
        assert cfg.enc_dec is not None
        super().__init__(top_spec(cfg), device, dtype)
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {remat_policy!r}; one of {REMAT_POLICIES}")
        self.cfg = cfg
        self.remat_policy = remat_policy
        self.enc_blocks = nn.ModuleList(ParamTree(_enc_block_spec(cfg), device, dtype)
                                        for _ in range(cfg.enc_dec.enc_layers))
        self.dec_blocks = nn.ModuleList(ParamTree(_dec_block_spec(cfg), device, dtype)
                                        for _ in range(cfg.n_layers))

    def param_specs(self):
        return param_specs(self.cfg)

    def stacks(self):
        """``(key, blocks)`` per stacked leaf group of the reference's tree."""
        return [(("enc",), self.enc_blocks), (("dec",), self.dec_blocks)]

    def _remat(self, fn):
        """The reference's rule for this model: every block recomputed in
        the backward unless the policy is ``"full"`` (so ``"dots"`` is
        ``"none"`` here)."""
        return remat("full" if self.remat_policy == "full" else "none", fn)

    def encode(self, frame_embeds: torch.Tensor, top=None, layers=None) -> torch.Tensor:
        """The encoder over (B, F, d) frame embeddings; ``top`` and
        ``layers``: a reference tree's top and its unstacked encoder layers
        (training), or None for the model's own parameters."""
        top = self if top is None else top
        layers = self.enc_blocks if layers is None else layers
        fn = self._remat(functools.partial(enc_block, self.cfg))
        x = frame_embeds
        for p in layers:
            x = fn(p, x)
        return apply_norm(self.cfg, top.enc_norm, x)

    def train_loss(self, batch: Dict[str, torch.Tensor], params: Optional[Dict[str, Any]] = None):
        """The mean token cross entropy of ``batch`` (``frame_embeds``,
        (B, F, d); ``tokens`` and ``labels``, (B, S)) as a float32 scalar;
        ``params`` as for :meth:`~repro_torch.models.lm.LM.train_loss`."""
        cfg = self.cfg
        if params is None:
            top, enc, dec = self, self.enc_blocks, self.dec_blocks
        else:
            top = _Tree(params)
            enc = unstack_group(params["enc"], cfg.enc_dec.enc_layers)
            dec = unstack_group(params["dec"], cfg.n_layers)
        enc_out = self.encode(batch["frame_embeds"].to(top.embed.dtype), top, enc)
        x = top.embed[batch["tokens"].long()]
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        fn = self._remat(functools.partial(_dec_block_train, cfg))
        for p in dec:
            x = fn(p, x, enc_out, positions)
        x = apply_norm(cfg, top.final_norm, x)
        return chunked_xent(x, top.unembed, batch["labels"])

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(self.cfg, self.final_norm, x) @ self.unembed

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], cache_len: int):
        """Encode the audio and run the decoder over ``batch["tokens"]``
        (B, S) -> (last-position logits (B, 1, V), caches)."""
        enc_out = self.encode(batch["frame_embeds"].to(self.embed.dtype))
        x = self.embed[batch["tokens"].long()]
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        per_layer = []
        for p in self.dec_blocks:
            x, (k, v, kc, vc) = dec_block(self.cfg, p, x, enc_out, positions)
            per_layer.append({"k": ring(k, cache_len), "v": ring(v, cache_len), "xk": kc, "xv": vc})
        caches = {k: torch.stack([c[k] for c in per_layer]) for k in per_layer[0]}
        return self._logits(x[:, -1:, :]), caches

    @torch.no_grad()
    def decode_step(self, caches: Dict[str, torch.Tensor], tokens: torch.Tensor, pos: int):
        """tokens: (B, 1); pos: absolute position.  Returns (logits (B, 1,
        V), caches): the caches passed in, their rings updated in place."""
        cfg = self.cfg
        pos = int(pos)
        x = self.embed[tokens.long()]
        b, dev = x.shape[0], x.device
        positions = torch.full((b, 1), pos, dtype=torch.int32, device=dev)
        w = caches["k"].shape[2]
        # the ring's first min(pos, W) slots, then the new token (the
        # reference's decode_attend(cur_len=min(pos, W), tail_valid=1))
        valid = torch.cat([torch.arange(w, device=dev) < min(pos, w),
                           torch.ones(1, dtype=torch.bool, device=dev)])
        every = torch.ones(caches["xk"].shape[2], dtype=torch.bool, device=dev)
        for i, p in enumerate(self.dec_blocks):
            ck, cv = caches["k"][i], caches["v"][i]
            xn = apply_norm(cfg, p.ln1, x)
            q, k, v = _proj_qkv(cfg, p.self_attn, xn, xn, positions, positions)
            a = decode_attend(q, torch.cat([ck, k], dim=1), torch.cat([cv, v], dim=1), valid)
            x = x + _out(p.self_attn, a)
            xn = apply_norm(cfg, p.ln_x, x)
            qc = (xn @ p.cross_attn.wq).reshape(b, 1, cfg.n_heads, cfg.hd)
            x = x + _out(p.cross_attn, decode_attend(qc, caches["xk"][i], caches["xv"][i], every))
            x = x + mlp_fwd(p.mlp, apply_norm(cfg, p.ln2, x), style="gelu2")
            ck[:, pos % w] = k[:, 0]
            cv[:, pos % w] = v[:, 0]
        return self._logits(x), caches

    def cache_specs(self, batch: int, cache_len: int) -> Dict[str, ParamSpec]:
        return cache_specs(self.cfg, batch, cache_len)


def cache_specs(cfg: ArchConfig, batch: int, cache_len: int) -> Dict[str, ParamSpec]:
    """Stacked (over the decoder's layers) decode-cache shapes + logical
    axes: the self-attention ring and the cross-attention K/V."""
    L, F = cfg.n_layers, cfg.enc_dec.enc_seq
    ring_axes = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    cross_axes = ("layers", "batch", None, "kv_heads", "head_dim")
    ring_shape = (L, batch, cache_len, cfg.n_kv_heads, cfg.hd)
    cross_shape = (L, batch, F, cfg.n_kv_heads, cfg.hd)
    return {
        "k": ParamSpec(ring_shape, ring_axes, torch.bfloat16, "zeros"),
        "v": ParamSpec(ring_shape, ring_axes, torch.bfloat16, "zeros"),
        "xk": ParamSpec(cross_shape, cross_axes, torch.bfloat16, "zeros"),
        "xv": ParamSpec(cross_shape, cross_axes, torch.bfloat16, "zeros"),
    }
