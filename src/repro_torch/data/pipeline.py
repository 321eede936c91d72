"""Deterministic synthetic token pipeline: shardable, resumable.  The
port's own copy of the reference's numpy-only ``repro/data/pipeline.py``:
the same ``(seed, step)`` yields bitwise the same batch in both packages.

The cursor (step index) is part of the task context — resuming a preempted
training task replays exactly the batches it would have seen (bitwise
deterministic from (seed, step)), which is what makes preempt/resume
equivalence testable end-to-end.

Data is synthesized as a mixture of Zipf-distributed "documents" with
repeated motifs so the LM loss actually decreases (pure uniform noise would
plateau immediately and hide training bugs).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    vocab_size: int = 512
    seq_len: int = 128
    global_batch: int = 8
    motif_len: int = 16
    n_motifs: int = 64


class SyntheticTokens:
    """Stateless batch generator: ``batch(step)`` is a pure function."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # motif bank: short token sequences that repeat (learnable structure)
        zipf = 1.0 / np.arange(1, cfg.vocab_size + 1)
        self._probs = (zipf / zipf.sum()).astype(np.float64)
        self._motifs = rng.choice(
            cfg.vocab_size, size=(cfg.n_motifs, cfg.motif_len),
            p=self._probs).astype(np.int32)

    def batch(self, step: int) -> dict:
        """Deterministic batch for a global step (numpy, host-side)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        n_chunks = -(-cfg.seq_len // cfg.motif_len)
        midx = rng.integers(0, cfg.n_motifs,
                            size=(cfg.global_batch, n_chunks))
        toks = self._motifs[midx].reshape(cfg.global_batch, -1)[:, :cfg.seq_len]
        # sprinkle noise so the task is not trivially memorizable
        noise = rng.random(toks.shape) < 0.05
        rand = rng.integers(0, cfg.vocab_size, size=toks.shape)
        toks = np.where(noise, rand, toks).astype(np.int32)
        labels = np.roll(toks, -1, axis=1).astype(np.int32)
        labels[:, -1] = -1
        return {"tokens": toks, "labels": labels}

    def batches(self, start_step: int, n: int):
        for s in range(start_step, start_step + n):
            yield s, self.batch(s)


def for_model(cfg: ModelConfig, shape: ShapeConfig, seed: int = 1234,
              reduced_batch: Optional[int] = None,
              reduced_seq: Optional[int] = None) -> SyntheticTokens:
    return SyntheticTokens(DataConfig(
        seed=seed,
        vocab_size=cfg.vocab_size,
        seq_len=reduced_seq or shape.seq_len,
        global_batch=reduced_batch or shape.global_batch,
    ))
