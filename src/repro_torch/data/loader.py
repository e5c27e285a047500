"""Per-client minibatch streams over partitioned arrays (host-side pipeline;
port of the JAX package's `data/loader.py`, numpy as there)."""
from __future__ import annotations

import numpy as np


class FederatedLoader:
    """Samples (C, T, B, ...) round batches from per-client shards.

    Deterministic given (seed, round): every worker can regenerate the same
    round batches — matches the stateless-scheduling philosophy of the core.
    """

    def __init__(self, arrays: dict[str, np.ndarray], shards: list[np.ndarray],
                 batch_size: int, local_steps: int, seed: int = 0):
        self.arrays = arrays
        self.shards = shards
        self.batch_size = batch_size
        self.local_steps = local_steps
        self.seed = seed

    @property
    def num_clients(self) -> int:
        return len(self.shards)

    def round_batch(self, rnd: int) -> dict[str, np.ndarray]:
        """dict of (C, T, B, ...) arrays for global round ``rnd``."""
        out = {k: [] for k in self.arrays}
        for c, shard in enumerate(self.shards):
            rng = np.random.RandomState(
                (self.seed * 1_000_003 + rnd * 8_191 + c) % (2 ** 31))
            idx = rng.choice(shard, size=(self.local_steps, self.batch_size),
                             replace=True)
            for k, arr in self.arrays.items():
                out[k].append(arr[idx])
        return {k: np.stack(v) for k, v in out.items()}
