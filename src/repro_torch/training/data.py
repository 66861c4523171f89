"""Deterministic, resumable synthetic data pipeline.

The port's own copy of ``repro/training/data.py`` (pure numpy), so its
batches equal the reference's bit for bit. Every batch is addressable by (seed, step): restart/elastic-rescale resumes
bit-exactly from the checkpointed step with no pipeline state beyond one
integer. Sequences are Zipf-distributed token ids with a simple Markov blend
so the LM loss actually decreases.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


class SyntheticLMData:
    """Index-based pipeline: ``batch_at(step)`` is a pure function."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # fixed per-seed Markov successor table (makes data learnable)
        rng = np.random.default_rng(cfg.seed)
        self._succ = rng.integers(0, cfg.vocab_size,
                                  size=(cfg.vocab_size,), dtype=np.int32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        draw = rng.zipf(c.zipf_a, size=(c.global_batch, c.seq_len))
        base = (draw % (c.vocab_size - 1)).astype(np.int32)
        tokens = np.empty_like(base)
        tokens[:, 0] = base[:, 0]
        # 75% Markov successor / 25% noise: learnable bigram structure
        use_succ = rng.random((c.global_batch, c.seq_len)) < 0.75
        for t in range(1, c.seq_len):
            tokens[:, t] = np.where(use_succ[:, t],
                                    self._succ[tokens[:, t - 1]], base[:, t])
        return {"tokens": tokens}

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1
