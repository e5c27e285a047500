"""Federated training of a ~100M-parameter dense LM (twin of the JAX
package's ``examples/train_100m.py``).

granite-3-2b reduced to 8 layers at d_model 512 (8 heads, 4 KV heads of
64, d_ff 2048) with its full 49,155-token vocabulary, in float32: 8
clients with cycles (1, 2, 4, 8) under Algorithm 1 through the
participants-only driver ``core.simulate`` (Adam, lr 3e-4), on synthetic
per-client Markov token streams (client skew 0.5), with a held-out eval
ten times a run.  Ends with ``save_checkpoint`` of the final params (a
model file in the reference's layout: the reference's
``load_checkpoint(PATH, like=params)`` reads it) and a JSON log.

  python -m repro_torch.launch.train_100m --rounds 20              # the card
  python -m repro_torch.launch.train_100m --device cpu --smoke --rounds 2

``--smoke`` narrows the model to 2 layers at d_model 64 (the vocabulary
stays) for a quick pass on the CPU.

Differences from the example: ``--device`` and ``--smoke`` are new;
``--ckpt`` and ``--log`` default to the working directory (the example
writes under ``benchmarks/results``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch import prng
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core import EnergyProfile, FedConfig, simulate
from repro_torch.data import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.optim import adam

WIDTHS = dict(num_layers=8, d_model=512, num_heads=8, num_kv_heads=4,
              head_dim=64, d_ff=2048)
SMOKE_WIDTHS = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                    head_dim=16, d_ff=128)


def config(smoke: bool = False):
    """granite-3-2b cut to ~100M params (``smoke``: ~6M), float32."""
    return dataclasses.replace(get_config("granite-3-2b"),
                               **(SMOKE_WIDTHS if smoke else WIDTHS),
                               dtype="float32", remat=False)


def run(rounds: int = 300, clients: int = 8, local_steps: int = 5,
        batch: int = 2, seq: int = 256, lr: float = 3e-4,
        policy: str = "sustainable", seed: int = 0, smoke: bool = False,
        device="cuda", verbose: bool = True) -> dict:
    """The example's run: {"cfg", "model", "result" (`SimResult`),
    "params" (count), "wall_s", "evals" [(round, eval loss)]}."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config(smoke)
    model = get_model(cfg)
    w = model.init_params(torch.Generator(dev).manual_seed(seed))
    n = model.num_params(w)
    if verbose:
        print(f"model: {cfg.name}-100m {n:,} params ({cfg.num_layers}L "
              f"d{cfg.d_model} vocab {cfg.vocab_size})", flush=True)
    C, T = clients, local_steps
    E = np.asarray(EnergyProfile(C, (1, 2, 4, 8)).cycles())
    p = np.ones(C) / C
    fed = FedConfig(num_clients=C, local_steps=T, policy=policy, seed=seed)
    source = SyntheticTokens(cfg.vocab_size, seq, C, client_skew=0.5,
                             seed=seed)
    held_out = {"tokens": torch.from_numpy(
        source.batch(0, 8, 999_999).astype(np.int64)).to(dev)}

    def loss_fn(params, b, rng):
        return model.loss_fn(params, b)

    def eval_fn(params):
        with torch.no_grad():
            return {"eval_loss": float(model.loss_fn(params, held_out))}

    def batch_fn(rnd, i):
        toks = np.stack([source.batch(i, batch, rnd * 131 + t)
                         for t in range(T)])
        return {"tokens": torch.from_numpy(toks.astype(np.int64)).to(dev)}

    t0 = time.perf_counter()
    res = simulate(loss_fn, adam(lr), fed, w, batch_fn, p, E, rounds,
                   prng.PRNGKey(seed), eval_fn=eval_fn,
                   eval_every=max(1, rounds // 10), verbose=verbose)
    wall = time.perf_counter() - t0
    evals = [(h["round"], h["eval_loss"]) for h in res.history
             if "eval_loss" in h]
    return {"cfg": cfg, "model": model, "result": res, "params": n,
            "wall_s": wall, "evals": evals}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--local-steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--policy", default="sustainable")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="2 layers at d_model 64 (CPU-runnable)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ckpt", default="train_100m.msgpack")
    ap.add_argument("--log", default="train_100m.json")
    a = ap.parse_args(argv)
    out = run(a.rounds, a.clients, a.local_steps, a.batch, a.seq, a.lr,
              a.policy, a.seed, smoke=a.smoke, device=a.device)
    evals, wall = out["evals"], out["wall_s"]
    print(f"eval loss {evals[0][1]:.3f} -> {evals[-1][1]:.3f} in {a.rounds} "
          f"rounds ({wall / 60:.1f} min)")
    save_checkpoint(a.ckpt, out["result"].params, step=a.rounds,
                    metadata={"arch": "granite-100m", "policy": a.policy})
    os.makedirs(os.path.dirname(os.path.abspath(a.log)), exist_ok=True)
    with open(a.log, "w") as f:
        json.dump({"params": out["params"], "rounds": a.rounds,
                   "wall_s": wall, "history": out["result"].history}, f,
                  indent=1)
    print(f"checkpoint -> {a.ckpt}\nlog -> {a.log}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
