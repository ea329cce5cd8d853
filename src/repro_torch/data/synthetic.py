"""Synthetic language-model data with LEARNABLE structure.

A first-order Markov chain over the vocabulary with a sparse transition
matrix: each token has `branching` plausible successors. Cross-entropy of a
perfect model is log(branching) << log(vocab), so training-loss descent is a
meaningful signal in integration tests and the train example.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np


class SyntheticLM:
    def __init__(self, vocab: int, branching: int = 4, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        self.branching = branching
        # successor table: (vocab, branching)
        self.table = rng.integers(0, vocab, size=(vocab, branching))

    def sample_doc(self, length: int, rng: np.random.Generator) -> np.ndarray:
        out = np.empty(length, np.int64)
        tok = int(rng.integers(self.vocab))
        for i in range(length):
            out[i] = tok
            tok = int(self.table[tok, int(rng.integers(self.branching))])
        return out

    def optimal_ce(self) -> float:
        return float(np.log(self.branching))


def synthetic_batches(vocab: int, batch: int, seq_len: int,
                      branching: int = 4, seed: int = 0,
                      num_batches: Optional[int] = None) -> Iterator[Dict]:
    """Yields {tokens (B,S), targets (B,S)} numpy batches."""
    lm = SyntheticLM(vocab, branching, seed)
    rng = np.random.default_rng(seed + 1)
    i = 0
    while num_batches is None or i < num_batches:
        docs = np.stack([lm.sample_doc(seq_len + 1, rng)
                         for _ in range(batch)])
        yield {"tokens": docs[:, :-1].astype(np.int32),
               "targets": docs[:, 1:].astype(np.int32)}
        i += 1
