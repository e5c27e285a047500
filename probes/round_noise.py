#!/usr/bin/env python3
"""How far two float32 evaluations of one training round lie apart when
they start from the same params, on the card and on the CPU.

    python3 probes/round_noise.py [--seed N] [--rounds 5]
        [--policy sustainable] [--optimizer adam] [--lr 1e-3] [--out PATH]
        [--device cuda] [--clients 40] [--batch 24]

Runs ``repro_torch.launch.train``'s run at the paper's §V size (N=40,
taus (1, 5, 10, 20), T=5, batch 24; ``--device cpu --clients 4 --batch
8`` for a quick run) on the card for ``--rounds`` rounds.
From the card's params before each round r it runs round r again:

* on the CPU (the plain path), as ``chip_smoke.py`` does;
* on the card through ``core.replay_round`` (the same computation, with
  every local step's max-pool and ReLU decisions read out), which must
  equal the card's round bitwise;
* on the CPU through ``replay_round`` with the card's decisions of the
  same step and client, in float32 and in float64.

It also prints how many params of each pair lie farther apart than
1e-6 + 1e-5 |w| (``over``).  ``--moved`` adds the rounds from params
moved by one float32 ulp in a random direction, on the CPU and on the
card: a second float32 evaluation that differs by rounding only.

For each pair it prints the round's loss difference (relative), the 90%
quantile of |d| / (1 + |w|) over the params and the largest |d|: how far
two float32 evaluations of a round, and each from float64, lie apart.
Prints a JSON record last (also to ``--out``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

import torch                                                    # noqa: E402

from repro_torch.core import replay_round                       # noqa: E402
from repro_torch.models import cnn                              # noqa: E402
from repro_torch.launch import train                            # noqa: E402
from repro_torch.tree import tree_leaves, tree_map              # noqa: E402


def replayed(run, w, r, routes=None, dtype=None):
    """Round r of ``run`` from ``w`` through ``core.replay_round``: (new
    params, loss, each step's decisions)."""
    w_new, m, seen = replay_round(cnn.loss_and_decisions, run.optimizer,
                                  run.fed, w, run.batch_fn(r), run.p, run.E,
                                  r, routes=routes, dtype=dtype)
    return w_new, float(m["loss"]), seen


def nudge(tree, gen):
    """Every element moved one float32 ulp up or down at random."""
    def one(t):
        up = torch.rand(t.shape, generator=gen) < 0.5
        far = torch.where(up, torch.tensor(float("inf")),
                          torch.tensor(float("-inf")))
        return torch.nextafter(t.cpu(), far).to(t.device)
    return tree_map(one, tree)


def compare(a, b, loss_a, loss_b):
    d = torch.cat([(x.cpu().double() - y.cpu().double()).abs().reshape(-1)
                   for x, y in zip(tree_leaves(a), tree_leaves(b))])
    w = torch.cat([y.cpu().double().abs().reshape(-1)
                   for y in tree_leaves(b)])
    return {"loss_rel": abs(loss_a - loss_b) / max(abs(loss_b), 1e-30),
            "q90": torch.quantile(d / (1 + w), 0.9).item(),
            "max": d.max().item(),
            "over_sgd_tol": int((d > 1e-6 + 1e-5 * w).sum())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--policy", default="sustainable")
    ap.add_argument("--optimizer", default="adam")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--clients", type=int, default=40)
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--moved", action="store_true",
                    help="also the rounds from params moved by one ulp")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    kw = dict(policy=args.policy, optimizer=args.optimizer, lr=args.lr,
              seed=args.seed, clients=args.clients, local_steps=5,
              batch=args.batch, taus=(1, 5, 10, 20))
    card = train.make_run(device=args.device, **kw)
    cpu = train.make_run(device="cpu", **kw)
    gen = torch.Generator().manual_seed(args.seed)
    to_cpu = lambda tree: tree_map(lambda t: t.cpu(), tree)
    w, rows = card.params, []
    t0 = time.perf_counter()
    for r in range(args.rounds):
        w_next, m = train.train_round(card, w, r)
        c, mc = train.train_round(cpu, to_cpu(w), r)
        s_card, l_card, routes = replayed(card, w, r)
        s_cpu, l_cpu, _ = replayed(cpu, to_cpu(w), r, routes)
        s_64, l_64, _ = replayed(cpu, to_cpu(w), r, routes, torch.float64)
        same = all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(s_card), tree_leaves(w_next)))
        row = {"round": r, "loss": m["loss"],
               "participants": m["participants"],
               "replay_equals_card": same,
               "card_vs_cpu": compare(w_next, c, m["loss"], mc["loss"]),
               "cpu_replay_vs_card": compare(s_cpu, s_card, l_cpu, l_card),
               "card_vs_f64_replay": compare(s_card, s_64, l_card, l_64),
               "cpu_replay_vs_f64_replay": compare(s_cpu, s_64, l_cpu,
                                                   l_64)}
        if args.moved:
            moved = nudge(w, gen)
            c2, mc2 = train.train_round(cpu, to_cpu(moved), r)
            g2, mg2 = train.train_round(card, moved, r)
            row["cpu_moved_vs_cpu"] = compare(c2, c, mc2["loss"], mc["loss"])
            row["card_moved_vs_card"] = compare(g2, w_next, mg2["loss"],
                                                m["loss"])
        rows.append(row)
        print(f"{args.policy} {args.optimizer} round {r} (loss "
              f"{m['loss']:.4f}, {m['participants']:.0f} participants): "
              + "; ".join(f"{k} loss {v['loss_rel']:.2e} q90 {v['q90']:.2e}"
                          f" max {v['max']:.2e} over {v['over_sgd_tol']}"
                          for k, v in row.items()
                          if isinstance(v, dict))
              + f"; replay_round on the card equals its round bitwise: "
              f"{same}", flush=True)
        w = w_next
    record = {"config": kw, "rows": rows,
              "seconds": time.perf_counter() - t0}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps({"seconds": record["seconds"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
