"""Architecture registry + per-(arch, shape) input specs.

The config files are plain data, so the port keeps its own copy of all of
them; :func:`repro_torch.models.api.build_model` builds every one.
``input_specs(cfg, shape)`` returns :class:`TensorSpec` stand-ins (shape and
dtype, nothing allocated) for every model input of the shape's phase;
``make_inputs`` materializes real tensors from the same specs, drawn from
numpy as the reference draws them, so both packages give the same arrays.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .base import ArchConfig, ShapeConfig

_MODULES = {
    "hymba-1.5b": "hymba_1_5b",
    "mixtral-8x22b": "mixtral_8x22b",
    "grok-1-314b": "grok_1_314b",
    "qwen2-1.5b": "qwen2_1_5b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "stablelm-12b": "stablelm_12b",
    "deepseek-7b": "deepseek_7b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "whisper-medium": "whisper_medium",
    "rwkv6-7b": "rwkv6_7b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.CONFIG


def cell_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Is this (arch x shape) cell runnable? (long_500k needs bounded state)"""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "long_500k requires sub-quadratic attention state; "
            f"{cfg.name} is pure full-attention (see DESIGN §Arch-applicability)"
        )
    return True, ""


def _text_seq(cfg: ArchConfig, shape: ShapeConfig) -> int:
    """Token count of the text part (vlm reserves patches out of seq_len)."""
    if cfg.vlm is not None and shape.phase in ("train", "prefill"):
        return shape.seq_len - cfg.vlm.n_patches
    return shape.seq_len


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A model input's shape and dtype, with nothing allocated (the
    reference's ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, TensorSpec]:
    """TensorSpec stand-ins for every model input of this phase."""
    b = shape.global_batch
    st = _text_seq(cfg, shape)
    i32 = torch.int32
    bf16 = torch.bfloat16
    if shape.phase == "decode":
        # one new token against a cache of shape.seq_len
        return {"tokens": TensorSpec((b, 1), i32), "pos": TensorSpec((), i32)}
    specs: Dict[str, TensorSpec] = {"tokens": TensorSpec((b, st), i32)}
    if shape.phase == "train":
        specs["labels"] = TensorSpec((b, st), i32)
    if cfg.vlm is not None:
        specs["vision_embeds"] = TensorSpec((b, cfg.vlm.n_patches, cfg.d_model), bf16)
    if cfg.enc_dec is not None:
        specs["frame_embeds"] = TensorSpec((b, cfg.enc_dec.enc_seq, cfg.d_model), bf16)
    return specs


def make_inputs(cfg: ArchConfig, shape: ShapeConfig, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Real tensors matching input_specs, on ``device``, drawn from
    ``np.random.default_rng(seed)`` in the reference's order.  The normal
    draws are float64; they are rounded to bfloat16 through float32, as the
    reference's ``jnp.asarray(..., jnp.bfloat16)`` does (JAX makes a
    float64 array float32 first)."""
    rng = np.random.default_rng(seed)
    out: Dict[str, Any] = {}
    for k, s in input_specs(cfg, shape).items():
        if k == "pos":
            arr = torch.tensor(shape.seq_len - 1, dtype=torch.int32)
        elif s.dtype == torch.int32:
            hi = cfg.vocab if k in ("tokens", "labels") else max(1, shape.seq_len)
            arr = torch.from_numpy(rng.integers(0, hi, s.shape).astype(np.int32))
        else:
            arr = torch.from_numpy(rng.normal(0, 0.02, s.shape).astype(np.float32)).to(s.dtype)
        out[k] = arr.to(device)
    return out
