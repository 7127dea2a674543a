"""Synthetic LM data: a fixed random Markov chain over the vocabulary (the
port's copy of ``repro/data/tokens.py``; numpy only, so the same seed gives
the reference's batches).

Structured enough that cross-entropy falls during training, deterministic
given the seed, and cheap at any batch size.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class MarkovCorpus:
    vocab: int
    branching: int = 4       # out-degree of the transition graph
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._succ = rng.integers(0, self.vocab, size=(self.vocab, self.branching))
        # skewed transition probabilities (zipf-ish)
        p = 1.0 / np.arange(1, self.branching + 1)
        self._p = p / p.sum()

    def sample(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, batch)
        for t in range(seq):
            choice = rng.choice(self.branching, size=batch, p=self._p)
            toks[:, t + 1] = self._succ[toks[:, t], choice]
        return toks

    def batches(self, batch: int, seq: int, seed: int = 1) -> Iterator[dict]:
        rng = np.random.default_rng(seed)
        while True:
            toks = self.sample(rng, batch, seq)
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


__all__ = ["MarkovCorpus"]
