"""Figure 1 of the paper: test accuracy against global rounds for Algorithm 1,
the two energy-agnostic benchmarks and unconstrained FedAvg (port of the
JAX package's ``benchmarks/fig1.py``, through the port's ``simulate``).

Setup as in §V: N=40 clients in 4 equal energy groups with (tau_0..tau_3)
= (1, 5, 10, 20), T=5 local steps, client Adam, iid partition, the McMahan
CNN, and CIFAR-10 replaced by the deterministic synthetic class-conditional
image set (matched shape and cardinality).

  python -m repro_torch.launch.fig1 --rounds 120                 # card
  python -m repro_torch.launch.fig1 --rounds 4 --clients 8 --device cpu

``--out`` writes the curves as JSON (nothing is written without it).
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.core import EnergyProfile, FedConfig, simulate
from repro_torch.data import (FederatedLoader, SyntheticImages,
                              client_weights, iid_partition)
from repro_torch.device import resolve_device
from repro_torch.launch.train import disable_tf32
from repro_torch.models import get_model
from repro_torch.optim import adam

POLICIES = ["sustainable", "greedy", "wait_all", "always"]
LABELS = {"sustainable": "Algorithm 1", "greedy": "Benchmark 1 (greedy)",
          "wait_all": "Benchmark 2 (wait-all)", "always": "FedAvg (no limit)"}


def make_eval(model, images, labels, batch: int = 256, device="cuda"):
    """eval_fn(params) -> {test_acc, test_loss} over the whole test set."""
    dev = resolve_device(device)
    images = torch.from_numpy(np.asarray(images)).to(dev)
    labels = torch.from_numpy(np.asarray(labels)).to(dev).long()

    def eval_fn(params):
        correct, nll = 0, 0.0
        with torch.no_grad():
            for i in range(0, len(labels), batch):
                x, y = images[i:i + batch], labels[i:i + batch]
                logits, _ = model.forward(params, {"images": x})
                gold = logits.gather(-1, y[:, None])[:, 0]
                correct += int((logits.argmax(-1) == y).sum())
                nll += float((torch.logsumexp(logits, -1) - gold).sum())
        return {"test_acc": correct / len(labels),
                "test_loss": nll / len(labels)}

    return eval_fn


def run_fig1(num_clients=40, taus=(1, 5, 10, 20), local_steps=5, batch=24,
             rounds=120, lr=1e-3, num_train=20000, num_test=2000, seed=0,
             eval_every=10, policies=POLICIES, verbose=True, out_json="",
             noise=3.0, device="cuda"):
    dev = resolve_device(device)
    if dev.type == "cuda":
        disable_tf32()
    model = get_model(get_config("cifar-cnn"))
    data = SyntheticImages(num_train=num_train, num_test=num_test, seed=seed,
                           noise=noise)
    xtr, ytr = data.train_set()
    xte, yte = data.test_set()
    shards = iid_partition(ytr, num_clients, seed)  # §V: iid, even split
    loader = FederatedLoader({"images": xtr, "labels": ytr}, shards, batch,
                             local_steps, seed)
    p = client_weights(shards)
    E = EnergyProfile(num_clients, tuple(taus)).cycles().numpy()
    eval_fn = make_eval(model, xte, yte, device=dev)

    def loss(params, b, rng):
        return model.loss_fn(params, b)

    def batch_fn(r, i):
        b = loader.round_batch(r)
        return {k: torch.from_numpy(v[i]).to(dev) for k, v in b.items()}

    results = {}
    for policy in policies:
        fed = FedConfig(num_clients=num_clients, local_steps=local_steps,
                        policy=policy, seed=seed)
        w0 = model.init_params(torch.Generator(dev).manual_seed(seed))
        t0 = time.time()
        res = simulate(loss, adam(lr), fed, w0, batch_fn, p, E, rounds,
                       prng.PRNGKey(seed), eval_fn=eval_fn,
                       eval_every=eval_every, verbose=verbose)
        xs, accs = res.curve("test_acc")
        _, losses_ = res.curve("test_loss")
        results[policy] = {
            "label": LABELS[policy],
            "rounds": xs.tolist(),
            "test_acc": accs.tolist(),
            "test_loss": losses_.tolist(),
            "participants": [h["participants"] for h in res.history],
            "final_acc": float(accs[-1]) if len(accs) else float("nan"),
            "final_loss": float(losses_[-1]) if len(losses_) else float("nan"),
            "wall_s": round(time.time() - t0, 1),
        }
        if verbose:
            print(f"== {LABELS[policy]}: final acc "
                  f"{results[policy]['final_acc']:.3f} "
                  f"({results[policy]['wall_s']}s)", flush=True)
    if out_json:
        os.makedirs(os.path.dirname(os.path.abspath(out_json)), exist_ok=True)
        with open(out_json, "w") as f:
            json.dump({"config": {
                "num_clients": num_clients, "taus": list(taus),
                "local_steps": local_steps, "batch": batch, "rounds": rounds,
                "num_train": num_train, "seed": seed,
                "device": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu")},
                "results": results}, f, indent=1)
    return results


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=120)
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--clients", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policies", default=",".join(POLICIES))
    ap.add_argument("--out", default="")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    run_fig1(num_clients=a.clients, rounds=a.rounds, batch=a.batch,
             seed=a.seed, policies=a.policies.split(","), out_json=a.out,
             device=a.device)


if __name__ == "__main__":
    main()
