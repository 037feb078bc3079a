"""Deterministic synthetic data pipeline (NumPy only; the JAX reference's
``repro/data/synthetic.py``, kept as the port's own copy).

Token streams come from a fixed-seed Zipf-ish sampler (realistic rank-
frequency marginals so CE trajectories look like language, not uniform
noise).  The federated partitioner splits a stream into non-IID client
shards by Dirichlet mixing over topic components — the standard FL benchmark
construction (used by the FEMNIST-style experiments in §5).

The generators are drawn in the reference's order, so a batch and a client
mix equal the reference's bit for bit; the arrays are NumPy, and the caller
moves them to its device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2
    n_topics: int = 8

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        base = ranks ** (-self.zipf_a)
        # per-topic reweighting: each topic boosts a random band of tokens
        self._topic_probs = []
        for t in range(self.n_topics):
            boost = np.ones(self.vocab)
            lo = rng.integers(0, self.vocab)
            hi = min(self.vocab, lo + self.vocab // self.n_topics)
            boost[lo:hi] *= 8.0
            p = base * boost
            self._topic_probs.append(p / p.sum())

    def batch(self, batch_size: int, *, topic_mix: np.ndarray = None,
              seed: int = 0) -> Dict[str, np.ndarray]:
        """Returns {"tokens", "labels"} of shape (B, T) — labels are the
        next-token shift of tokens (teacher forcing)."""
        rng = np.random.default_rng((self.seed, seed))
        mix = (np.full(self.n_topics, 1.0 / self.n_topics)
               if topic_mix is None else topic_mix)
        toks = np.empty((batch_size, self.seq_len + 1), np.int32)
        topics = rng.choice(self.n_topics, size=batch_size, p=mix)
        for i, t in enumerate(topics):
            toks[i] = rng.choice(self.vocab, size=self.seq_len + 1,
                                 p=self._topic_probs[t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def dirichlet_client_mixes(n_clients: int, n_topics: int, alpha: float = 0.3,
                           seed: int = 0) -> np.ndarray:
    """Non-IID: each client's topic distribution ~ Dirichlet(alpha)."""
    rng = np.random.default_rng(seed)
    return rng.dirichlet(np.full(n_topics, alpha), size=n_clients)
