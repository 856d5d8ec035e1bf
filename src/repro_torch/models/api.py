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

Families ported so far, each serving and training: ``dense``, ``hybrid``
(hymba) and ``rwkv`` (rwkv6).  The ``moe``, ``enc_dec`` (whisper) and
``vlm`` (llava) families raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ArchConfig
from ..kernels.ops import kernel_device
from .common import init_params
from .lm import LM, param_specs


class Model:
    def __init__(self, lm: LM, cfg: ArchConfig):
        self.lm = lm
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return self.lm.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.lm.embed.dtype

    def param_specs(self):
        return param_specs(self.cfg)

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
        return self.lm.prefill(batch["tokens"], cache_len)

    def decode_step(self, caches, tokens: torch.Tensor, pos: int):
        return self.lm.decode_step(caches, tokens, pos)

    def cache_specs(self, batch: int, cache_len: int):
        return self.lm.cache_specs(batch, cache_len)


def build_model(cfg: ArchConfig, *, device="cuda", dtype: torch.dtype = torch.bfloat16,
                remat_policy: str = "none") -> Model:
    for family, present in (("moe", cfg.moe), ("enc_dec", cfg.enc_dec), ("vlm", cfg.vlm)):
        if present is not None:
            raise NotImplementedError(
                f"{cfg.name}: the {family} family is not ported yet")
    dev = kernel_device(device)
    return Model(LM(cfg, dev, dtype, remat_policy), cfg)
