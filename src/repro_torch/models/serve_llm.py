"""Batched LLM serving engine: prefill + greedy decode against ring caches.

``ServeEngine.generate`` runs a batch of prompts through one prefill and
decodes tokens step by step, greedily (``argmax``, the first index on
ties, as ``jnp.argmax``).  The batch goes to prefill whole: a vlm's
``vision_embeds`` come before the prompt, so decode positions start after
both; an encoder-decoder's ``frame_embeds`` feed its encoder.  Times are
host clocks around work that ends in ``torch.cuda.synchronize()`` on the
card (the reference's ``block_until_ready``).  With the tracer on, a call
is one unit: a ``prefill`` span, then one ``decode_step`` span a step.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from ..trace.span import ST_DECODE_STEP, ST_PREFILL, TRACER
from .api import Model


@dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, max_new)
    prefill_s: float
    decode_s: float
    tokens_per_s: float


class ServeEngine:
    def __init__(self, model: Model, cache_len: int = 512):
        self.model = model
        self.cache_len = cache_len

    def _sync(self) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    def generate(self, batch: Dict[str, torch.Tensor], max_new: int = 16) -> GenerationResult:
        tokens = batch["tokens"]
        b, prompt_len = tokens.shape
        unit = TRACER.next_batch_id() if TRACER.enabled else -1
        t0 = time.perf_counter()
        with TRACER.span(ST_PREFILL, unit=unit, tokens=b * prompt_len):
            logits, cache = self.model.prefill(batch, self.cache_len)
            next_tok = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
        self._sync()
        t1 = time.perf_counter()

        out = [next_tok]
        # absolute positions count the vlm prefix
        pos = prompt_len
        if self.model.cfg.vlm is not None and "vision_embeds" in batch:
            pos += batch["vision_embeds"].shape[1]
        for i in range(max_new - 1):
            with TRACER.span(ST_DECODE_STEP, unit=unit, tokens=b):
                logits, cache = self.model.decode_step(cache, next_tok, pos + i)
                next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
            out.append(next_tok)
        self._sync()
        t2 = time.perf_counter()
        toks = torch.cat(out, dim=1).cpu().numpy()
        return GenerationResult(
            tokens=toks,
            prefill_s=t1 - t0,
            decode_s=t2 - t1,
            tokens_per_s=b * max_new / max(t2 - t1, 1e-9),
        )
