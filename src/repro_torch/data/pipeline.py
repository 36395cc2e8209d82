"""Host-side synthetic data (counterpart of part of ``repro.data.pipeline``).

A pipeline is a pure function of (seed, step) -> batch of numpy arrays,
so a run that restarts at step S sees the batches it would have seen.
The prefetching ``DataPipeline`` of the JAX package is not ported yet.
"""
from __future__ import annotations

import numpy as np


def lm_synthetic_batch(vocab_size: int, batch: int, seq_len: int):
    """A (seed, step) -> {tokens, targets} generator for an LM, numpy only,
    the same numbers as JAX's: blockwise-repetitive tokens (a learnable
    bigram structure) with 5 % of them replaced at random."""

    def make(seed: int, step: int):
        rng = np.random.default_rng(np.uint64(seed) * np.uint64(1_000_003) + np.uint64(step))
        base = rng.integers(0, vocab_size, size=(batch, seq_len // 4 + 2))
        tokens = np.repeat(base, 4, axis=1)[:, :seq_len + 1]
        noise = rng.random((batch, seq_len + 1)) < 0.05
        tokens = np.where(noise, rng.integers(0, vocab_size, tokens.shape), tokens)
        return {
            "tokens": tokens[:, :-1].astype(np.int32),
            "targets": tokens[:, 1:].astype(np.int32),
        }

    return make
