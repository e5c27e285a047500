"""Non-iid label skew ablation (twin of the JAX package's
``examples/noniid_ablation.py``).

The paper's §V uses an iid partition; under non-iid data the bias of the
greedy benchmark should worsen (frequent-energy clients drag the model
toward their label mixture), widening Algorithm 1's margin.  This
measures the gap as a function of the Dirichlet alpha of the partition:
16 clients with cycles (1, 4, 8, 16), a 3072-64-10 MLP trained with Adam
through ``core.simulate`` on the synthetic CIFAR-shaped set (noise 4.0),
iid and Dirichlet alpha in {1.0, 0.2}, sustainable against greedy.  Prints
each alpha's accuracies, test losses, loss gap and seconds.

  python -m repro_torch.launch.noniid_ablation                 # the card
  python -m repro_torch.launch.noniid_ablation --device cpu --rounds 4

The MLP's initial weights are the example's: ``jax.random.normal`` of the
seed's key (``prng.normal``, ulp-close to it).

Differences from the example: ``--device`` is new; ``--out`` writes the
table only when given (the example writes under ``benchmarks/results``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import FedConfig, simulate
from repro_torch.data import (FederatedLoader, SyntheticImages,
                              client_weights, dirichlet_partition,
                              iid_partition)
from repro_torch.device import resolve_device
from repro_torch.optim import adam

ALPHAS = (None, 1.0, 0.2)
POLICIES = ("sustainable", "greedy")


def mlp_init(key, d_in: int = 32 * 32 * 3, hidden: int = 64,
             classes: int = 10, device="cpu") -> dict:
    """The example's MLP: He-normal weights from ``key``'s split, zero
    biases."""
    k1, k2 = prng.split(key)
    return {k: v.to(device) for k, v in {
        "w1": prng.normal(k1, (d_in, hidden)) * (2 / d_in) ** 0.5,
        "b1": torch.zeros(hidden),
        "w2": prng.normal(k2, (hidden, classes)) * (2 / hidden) ** 0.5,
        "b2": torch.zeros(classes)}.items()}


def mlp_apply(params, x):
    h = torch.relu(x.reshape(x.shape[0], -1) @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def loss_fn(params, batch, rng):
    logits = mlp_apply(params, batch["images"])
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, batch["labels"][:, None], -1)[:, 0]
    return torch.mean(logz - gold)


def run(alpha, policy: str, rounds: int, C: int = 16, T: int = 5,
        batch: int = 8, seed: int = 0, noise: float = 4.0,
        device="cuda") -> tuple[float, float]:
    """One (alpha, policy) cell, as the example's ``run``: (test accuracy,
    test loss).  ``alpha=None`` is the iid partition."""
    dev = resolve_device(device)
    data = SyntheticImages(num_train=1500, num_test=1000, seed=seed,
                           noise=noise)
    xtr, ytr = data.train_set()
    xte, yte = data.test_set()
    if alpha is None:
        shards = iid_partition(ytr, C, seed)
    else:
        shards = dirichlet_partition(ytr, C, alpha, seed,
                                     min_per_client=batch)
    loader = FederatedLoader({"images": xtr, "labels": ytr}, shards, batch, T,
                             seed)
    p = client_weights(shards)
    E = np.asarray([(1, 4, 8, 16)[i % 4] for i in range(C)], np.int32)
    fed = FedConfig(num_clients=C, local_steps=T, policy=policy, seed=seed)

    def batch_fn(r, i):
        b = loader.round_batch(r)
        return {"images": torch.from_numpy(b["images"][i]).to(dev),
                "labels": torch.from_numpy(
                    b["labels"][i].astype(np.int64)).to(dev)}

    res = simulate(loss_fn, adam(1e-3), fed,
                   mlp_init(prng.PRNGKey(seed), device=dev), batch_fn, p, E,
                   rounds, prng.PRNGKey(seed))
    test = {"images": torch.from_numpy(xte).to(dev),
            "labels": torch.from_numpy(yte.astype(np.int64)).to(dev)}
    with torch.no_grad():
        pred = torch.argmax(mlp_apply(res.params, test["images"]), -1)
        acc = float(torch.mean((pred == test["labels"]).float()))
        tl = float(loss_fn(res.params, test, None))
    return acc, tl


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None,
                    help="write the table here as JSON")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    table = {}
    for alpha in ALPHAS:
        name = "iid" if alpha is None else f"dir({alpha})"
        t0 = time.perf_counter()
        res = {pol: run(alpha, pol, args.rounds, device=args.device)
               for pol in POLICIES}
        wall = time.perf_counter() - t0
        gap = res["greedy"][1] - res["sustainable"][1]   # > 0: greedy worse
        table[name] = {"alg1_acc": res["sustainable"][0],
                       "greedy_acc": res["greedy"][0],
                       "alg1_loss": res["sustainable"][1],
                       "greedy_loss": res["greedy"][1],
                       "loss_gap": gap, "seconds": wall}
        print(f"{name:10s} alg1 acc={res['sustainable'][0]:.3f} "
              f"loss={res['sustainable'][1]:.3f} | greedy "
              f"acc={res['greedy'][0]:.3f} loss={res['greedy'][1]:.3f} | "
              f"loss_gap={gap:+.3f} ({wall:.2f} s)", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(table, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
