"""Unified model API: ``build_model(cfg, device=..., dtype=...)`` -> a
:class:`Model` with

    param_specs()                  -> ParamSpec tree (the reference's layout)
    init(generator)                -> fills the parameters, returns the model
    train_loss(params, batch)      -> float32 scalar loss
    trainable(flag)                -> the model's own parameters require grad
    prefill(batch, cache_len)      -> (last_logits, caches)
    decode_step(caches, tokens, pos) -> (logits, caches)
    cache_specs(batch, cache_len)  -> ParamSpec tree for decode caches

The parameters live in the model's modules (``model.lm``), not in a tree
passed to every call as in the reference.  ``train_loss`` takes either
such a tree (the reference's layout, as
:func:`~repro_torch.models.weights.to_reference` gives it, on the model's
device: what the train step differentiates) or ``None`` for the model's own
parameters, which :meth:`Model.trainable` lets take gradients.  ``device`` defaults to
``"cuda"``: without a card the model must be built with ``device="cpu"``,
or building raises.  ``dtype`` is the type of every weight the reference
declares as bfloat16 (the default); ``torch.float32`` makes every
parameter float32.

Every family of ``configs/registry.py`` builds, serves and trains:
``dense``, ``moe`` (mixtral, grok), ``hybrid`` (hymba), ``rwkv`` (rwkv6)
and ``vlm`` (llava) as :class:`~repro_torch.models.lm.LM`, ``enc_dec``
(whisper) as :class:`~repro_torch.models.encdec.EncDecLM`.  ``prefill`` and
``train_loss`` take the whole batch: ``tokens`` (and ``labels``), a vlm's
``vision_embeds`` (B, P, d) and an encoder-decoder's ``frame_embeds`` (B,
F, d): :func:`draw_extras` draws them as the reference's serve CLI does.
:func:`attention_calls` counts a forward's attention calls, each one launch
of the flash kernel on the card.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..kernels.ops import kernel_device
from .common import init_params
from .encdec import EncDecLM
from .lm import LM


class Model:
    def __init__(self, lm: Union[LM, EncDecLM], cfg: ArchConfig):
        self.lm = lm
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return self.lm.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.lm.embed.dtype

    def param_specs(self):
        return self.lm.param_specs()

    def init(self, generator: torch.Generator) -> "Model":
        init_params(self.lm, generator)
        return self

    def cast(self, dtype: torch.dtype) -> "Model":
        """A copy of this model whose bfloat16-declared weights are held in
        ``dtype`` (float32: every parameter float32)."""
        other = build_model(self.cfg, device=self.device, dtype=dtype,
                            remat_policy=self.lm.remat_policy)
        other.lm.load_state_dict(self.lm.state_dict())
        return other

    def trainable(self, flag: bool = True) -> "Model":
        """Let the model's own parameters take gradients (they are built
        with ``requires_grad=False``: serving never needs them)."""
        self.lm.requires_grad_(flag)
        return self

    def train_loss(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.lm.train_loss(batch, params)

    def prefill(self, batch: Dict[str, torch.Tensor], cache_len: int):
        return self.lm.prefill(batch, cache_len)

    def decode_step(self, caches, tokens: torch.Tensor, pos: int):
        return self.lm.decode_step(caches, tokens, pos)

    def cache_specs(self, batch: int, cache_len: int):
        return self.lm.cache_specs(batch, cache_len)


def build_model(cfg: ArchConfig, *, device="cuda", dtype: torch.dtype = torch.bfloat16,
                remat_policy: str = "none") -> Model:
    dev = kernel_device(device)
    impl = EncDecLM if cfg.enc_dec is not None else LM
    return Model(impl(cfg, dev, dtype, remat_policy), cfg)


def attention_calls(cfg: ArchConfig) -> int:
    """Attention calls in one forward of ``cfg``'s model (a prefill, or a
    training forward or its recompute), each one flash kernel launch on the
    card: one per layer, none in rwkv's attention-free blocks, and for an
    encoder-decoder one per encoder layer and two per decoder layer (its
    causal self-attention and its cross-attention)."""
    if cfg.rwkv is not None:
        return 0
    if cfg.enc_dec is not None:
        return cfg.enc_dec.enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


def draw_extras(cfg: ArchConfig, rng: np.random.Generator, batch: int) -> Dict[str, np.ndarray]:
    """The inputs besides the tokens, drawn from ``rng`` in the order and at
    the scale of the reference's serve CLI: a vlm's ``vision_embeds`` (B, P,
    d), then an encoder-decoder's ``frame_embeds`` (B, F, d), N(0, 0.02), as
    float32 arrays (empty for the other families)."""
    out = {}
    if cfg.vlm is not None:
        out["vision_embeds"] = rng.normal(0, 0.02, (batch, cfg.vlm.n_patches, cfg.d_model))
    if cfg.enc_dec is not None:
        out["frame_embeds"] = rng.normal(0, 0.02, (batch, cfg.enc_dec.enc_seq, cfg.d_model))
    return {k: v.astype(np.float32) for k, v in out.items()}
