"""Deterministic synthetic token pipeline with a resumable cursor.

The stream is a seeded PRNG over the vocab with a light Markov flavour (so
the LM loss actually decreases); ``cursor`` is the number of batches already
emitted.  The cursor is part of the journaled train state: restart resumes
the stream exactly where the crashed run stopped — no repeated or skipped
batches (exactly-once data semantics via the Poplar journal).

A copy of ``repro/data/pipeline.py``: numpy only, so both packages give the
same batches for the same cursor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 1234


class TokenPipeline:
    def __init__(self, cfg: DataConfig, cursor: int = 0):
        self.cfg = cfg
        self.cursor = int(cursor)

    def _batch_at(self, idx: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 20) ^ idx)
        # markov-ish stream: tokens correlate with their predecessor
        base = rng.integers(0, cfg.vocab, (cfg.batch, cfg.seq_len + 1), dtype=np.int64)
        carry = np.cumsum(base, axis=1) % cfg.vocab
        keep = rng.random((cfg.batch, cfg.seq_len + 1)) < 0.7
        stream = np.where(keep, carry, base).astype(np.int32)
        return {"tokens": stream[:, :-1], "labels": stream[:, 1:]}

    def next_batch(self) -> Dict[str, np.ndarray]:
        b = self._batch_at(self.cursor)
        self.cursor += 1
        return b

    def state(self) -> Dict[str, np.ndarray]:
        return {"cursor": np.asarray(self.cursor, np.int64)}

    @staticmethod
    def restore(cfg: DataConfig, state: Dict[str, np.ndarray]) -> "TokenPipeline":
        return TokenPipeline(cfg, cursor=int(state["cursor"]))
