"""Architecture registry: every arch the reference knows, by name.

The config files are plain data, so the port keeps its own copy of all of
them; :func:`repro_torch.models.api.build_model` builds every one.  The reference's ``input_specs``/``make_inputs`` build
abstract JAX shapes for its dry runs and have no counterpart here.
"""

from __future__ import annotations

import importlib
from .base import ArchConfig

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

