"""Synthetic data sources (port of the JAX package's ``data/synthetic.py``,
which is numpy apart from an unused JAX import; the arrays are identical).

* ``SyntheticImages`` — deterministic class-conditional 32x32x3 images with
  matched CIFAR-10 shape/cardinality: class k is a fixed random template plus
  per-sample noise, so the task is learnable and accuracy is a meaningful
  monotone signal (used by the Figure-1 reproduction).
* ``SyntheticTokens`` — order-k Markov token streams with per-client transition
  matrices, giving each client a distinct (non-iid-able) distribution so FL
  bias effects are visible for the LM architectures.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticImages:
    num_classes: int = 10
    num_train: int = 50000
    num_test: int = 10000
    noise: float = 0.35
    template_rank: int = 6   # low-rank class templates: harder than pure blobs
    seed: int = 0

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        u = rng.randn(self.num_classes, 32, self.template_rank) * 0.8
        v = rng.randn(self.num_classes, self.template_rank, 32 * 3) * 0.8
        self.templates = np.einsum("kir,krj->kij", u, v).reshape(
            self.num_classes, 32, 32, 3).astype(np.float32)

    def _make(self, n, seed):
        rng = np.random.RandomState(seed)
        labels = rng.randint(0, self.num_classes, size=n).astype(np.int32)
        imgs = self.templates[labels] + \
            rng.randn(n, 32, 32, 3).astype(np.float32) * self.noise
        return imgs, labels

    def train_set(self):
        return self._make(self.num_train, self.seed + 1)

    def test_set(self):
        return self._make(self.num_test, self.seed + 2)


@dataclasses.dataclass
class SyntheticTokens:
    """Per-client Markov chains over the vocab: client i's stream follows a
    client-specific bigram transition, interpolated with a shared one."""

    vocab_size: int
    seq_len: int
    num_clients: int = 1
    client_skew: float = 0.5   # 0 = identical clients, 1 = fully distinct
    seed: int = 0

    def batch(self, client: int, batch_size: int, seed: int) -> np.ndarray:
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + client * 9_176 + seed) % (2 ** 31))
        V = min(self.vocab_size, 256)  # effective support (cheap, still non-trivial)
        # stationary-ish sampling: client-biased unigram + local repetition
        shared = np.abs(np.sin(np.arange(V) * 0.37) + 1.1)
        mine = np.abs(np.sin(np.arange(V) * (0.11 + 0.05 * client)) + 1.1)
        probs = (1 - self.client_skew) * shared + self.client_skew * mine
        probs = probs / probs.sum()
        toks = rng.choice(V, size=(batch_size, self.seq_len), p=probs)
        # inject bigram structure: with prob .5 repeat previous token + 1
        rep = rng.rand(batch_size, self.seq_len) < 0.5
        for t in range(1, self.seq_len):
            toks[:, t] = np.where(rep[:, t], (toks[:, t - 1] + 1) % V, toks[:, t])
        return toks.astype(np.int32)


def round_batches(source: SyntheticTokens, num_clients: int, local_steps: int,
                  batch_per_client: int, rnd: int) -> np.ndarray:
    """(C, T, B, S) token batches for one federated round."""
    out = np.stack([
        np.stack([source.batch(c, batch_per_client, rnd * 131 + t)
                  for t in range(local_steps)])
        for c in range(num_clients)
    ])
    return out
