"""Federated dataset partitioning (port of the JAX package's
`data/partition.py`, numpy as there).

* ``iid_partition`` — the paper's §V setup: shuffle and split evenly.
* ``dirichlet_partition`` — standard non-iid label-skew partition
  (Dir(alpha) over class proportions per client), for ablations beyond the
  paper's iid experiment.
"""
from __future__ import annotations

import numpy as np


def iid_partition(labels: np.ndarray, num_clients: int, seed: int = 0
                  ) -> list[np.ndarray]:
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(labels))
    return [np.sort(s) for s in np.array_split(idx, num_clients)]


def dirichlet_partition(labels: np.ndarray, num_clients: int,
                        alpha: float = 0.5, seed: int = 0,
                        min_per_client: int = 2) -> list[np.ndarray]:
    rng = np.random.RandomState(seed)
    classes = np.unique(labels)
    shards: list[list[int]] = [[] for _ in range(num_clients)]
    for c in classes:
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * num_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for shard, part in zip(shards, np.split(idx, cuts)):
            shard.extend(part.tolist())
    # guarantee a minimum per client (steal from the largest)
    sizes = [len(s) for s in shards]
    order = np.argsort(sizes)
    for i in order:
        while len(shards[i]) < min_per_client:
            donor = max(range(num_clients), key=lambda j: len(shards[j]))
            shards[i].append(shards[donor].pop())
    return [np.sort(np.asarray(s)) for s in shards]


def client_weights(shards: list[np.ndarray]) -> np.ndarray:
    """p_i = D_i / D (paper eq. 3-4)."""
    sizes = np.asarray([len(s) for s in shards], np.float64)
    return (sizes / sizes.sum()).astype(np.float32)
