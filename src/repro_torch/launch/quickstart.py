"""Quickstart: sustainable federated learning on a language model (twin of
the JAX package's ``examples/quickstart.py``).

Trains a reduced granite-3-2b (dense GQA LM, the smoke config) across 8
energy-harvesting clients with the paper's Algorithm 1 (stochastic
energy-aware scheduling + E_i-scaled aggregation) on synthetic per-client
token streams, through the faithful participants-only driver
``core.simulate``.  Prints the loss of every round, its first and last
values and the number of params; exits 1 unless the loss fell.

  python -m repro_torch.launch.quickstart                  # the card
  python -m repro_torch.launch.quickstart --device cpu --rounds 2

Differences from the example: ``--device`` and ``--rounds`` are new.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs import get_smoke_config
from repro_torch.core import EnergyProfile, FedConfig, Policy, simulate
from repro_torch.data import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.optim import adam

CLIENTS, LOCAL_STEPS, ROUNDS = 8, 5, 12


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- setup: model, clients, energy profile -----------------------------
    cfg = get_smoke_config("granite-3-2b")
    model = get_model(cfg)
    E = np.asarray(EnergyProfile(CLIENTS, (1, 2, 4, 8)).cycles())
    p = np.ones(CLIENTS) / CLIENTS                          # data weights
    source = SyntheticTokens(cfg.vocab_size, seq_len=64, num_clients=CLIENTS,
                             client_skew=0.7)
    fed = FedConfig(num_clients=CLIENTS, local_steps=LOCAL_STEPS,
                    policy=Policy.SUSTAINABLE)              # the paper's Alg. 1

    def loss_fn(params, batch, rng):
        return model.loss_fn(params, batch)

    def batch_fn(rnd, client):      # (T, B, S) minibatches for one client
        toks = np.stack([source.batch(client, 4, rnd * 131 + t)
                         for t in range(LOCAL_STEPS)])
        return {"tokens": torch.from_numpy(toks.astype(np.int64)).to(dev)}

    # --- run Algorithm 1 ----------------------------------------------------
    w0 = model.init_params(torch.Generator(dev).manual_seed(0))
    res = simulate(loss_fn, adam(1e-3), fed, w0, batch_fn, p, E, args.rounds,
                   prng.PRNGKey(0), verbose=True)

    losses = [h["loss"] for h in res.history if "loss" in h]
    print(f"\nloss: {losses[0]:.3f} -> {losses[-1]:.3f} over {args.rounds} "
          f"rounds ({model.num_params(res.params):,} params, "
          f"policy={fed.policy}, device={dev})")
    if not losses[-1] < losses[0]:
        print("error: the loss did not fall", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
