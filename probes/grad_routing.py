#!/usr/bin/env python3
"""Where one local step's CNN gradients on the card part from float64.

    python3 probes/grad_routing.py [--seed N] [--device cuda|cpu]
        [--clients 40] [--batch 24] [--conv model|cudnn|cudnn-off]
        [--rounds 3] [--out PATH]

Takes the first local step of ``repro_torch.launch.train``'s run (the
paper's §V setup by default: N=40 clients, batch 24, taus (1, 5, 10, 20),
params from ``--seed`` on the device) and computes every client's
gradient of the CIFAR CNN's loss:

* ``f32 vmap`` / ``f32 loop``: float32 on ``--device``, mapped over the
  clients as ``parallel_round`` maps them (``torch.func.vmap``), and one
  client at a time without it;
* ``cpu f32 vmap``: float32 on the CPU, mapped;
* ``f64 vmap``: float64 on ``--device``, mapped;
* the reference: float64 on the CPU, one client at a time.

Each is held against the reference per client (max |error| over the
leaf's largest reference gradient).  The forward's discrete decisions
(which element each 2x2 max-pool window routes its gradient to, and the
sign of every ReLU input) are read from the same call and compared with
the reference's: each decision that differs is listed with the float64
gap behind it (how far apart the two candidates are in float64,
relative to the larger).  Last, each float32 gradient is held against a
float64 CPU replay that takes that run's own decisions: if the decisions
explain the whole difference, this replay agrees to float32 rounding.

``--conv`` swaps the model's convolution (``models.cnn.conv_same``,
im2col + matmul) for ``F.conv2d`` on cuDNN or with cuDNN off, everywhere
in the process; ``--rounds`` first times that many ``train_round`` calls
of the run (after one warm-up) on the host clock.

Prints one line per comparison and, last, a JSON record (also written to
``--out``).  Exits 1 when a float64 run on ``--device`` disagrees with
the float64 CPU reference beyond 1e-10 (a fault of the batched path that
does not depend on rounding), when a float32 run stays more than 1e-4
from its own replay (a difference the decisions do not explain), or when
``models.cnn.loss_and_decisions`` (the loss with its decisions exposed,
which the replay uses) differs from the model's loss.
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
import torch.nn.functional as F                                 # noqa: E402
from torch.func import grad, vmap                               # noqa: E402

from repro_torch.models import cnn                              # noqa: E402

F64_TOL = 1e-10
REPLAY_TOL = 1e-4
CONVS = {"model": None,
         "cudnn": lambda x, w, b: F.conv2d(x, w, b, padding=w.shape[-1] // 2),
         "cudnn-off": lambda x, w, b: F.conv2d(x, w, b,
                                               padding=w.shape[-1] // 2)}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def grads_and_route(params, batch, device, dtype, mapped, route=None):
    """Per-client gradients (leaves (C, ...)) and pre-activations, as float64
    on the CPU."""
    C = batch["labels"].shape[0]
    p = _map(params, lambda t: t.to(device, dtype))
    imgs = batch["images"].to(device, dtype)
    labels = batch["labels"].to(device)
    r = None if route is None else [z.to(device, dtype) for z in route]

    def one(w, x, y, *rr):
        return cnn.loss_and_decisions(w, {"images": x, "labels": y},
                                      rr or None)

    g_fn = grad(one, has_aux=True)
    if mapped:
        stack = _map(p, lambda t: t[None].expand((C,) + t.shape).contiguous())
        g, aux = vmap(g_fn)(stack, imgs, labels, *(r or []))
    else:
        outs = [g_fn(p, imgs[c], labels[c], *[z[c] for z in (r or [])])
                for c in range(C)]
        g = {n: {l: torch.stack([o[0][n][l] for o in outs]) for l in p[n]}
             for n in p}
        aux = tuple(torch.stack([o[1][i] for o in outs]) for i in range(4))
    to64 = lambda t: t.detach().to("cpu", torch.float64)
    return _map(g, to64), [to64(z) for z in aux]


def per_client_error(g, ref):
    """{leaf: [max |g - ref| / max |ref| for each client]}."""
    out = {}
    for n in ref:
        for l in ref[n]:
            scale = ref[n][l].abs().max().clamp_min(1e-30)
            d = (g[n][l] - ref[n][l]).abs().reshape(ref[n][l].shape[0], -1)
            out[f"{n}.{l}"] = (d.max(1).values / scale).tolist()
    return out


def decision_changes(route, ref_route):
    """Every decision of ``route`` that differs from ``ref_route``'s, with
    the float64 gap between the two candidates relative to the larger."""
    names = ("pool1", "pool2", "relu fc1", "relu fc2")
    out = []
    for i, name in enumerate(names):
        a, r = route[i], ref_route[i]
        if i < 2:       # the window's routed element (only where it is > 0)
            wa, wr = cnn._windows(F.relu(a)), cnn._windows(F.relu(r))
            ia, ir = wa.argmax(-1), wr.argmax(-1)
            top = wr.max(-1).values
            diff = (ia != ir) & (top > 0)
            va = torch.gather(wr, -1, ia[..., None])[..., 0]
            gap = (top - va) / top.clamp_min(1e-30)
        else:
            diff = (a > 0) != (r > 0)
            gap = r.abs() / r.abs().amax(dim=-1, keepdim=True)
        for pos in diff.nonzero().tolist():
            out.append({"site": name, "client": pos[0],
                        "position": pos[1:],
                        "f64_gap": gap[tuple(pos)].item()})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--clients", type=int, default=40)
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--out", default="")
    ap.add_argument("--conv", default="model", choices=list(CONVS),
                    help="the convolution: the model's (im2col + matmul), "
                         "F.conv2d on cuDNN, or F.conv2d with cuDNN off")
    ap.add_argument("--rounds", type=int, default=3,
                    help="training rounds to time (after one warm-up)")
    args = ap.parse_args(argv)
    if CONVS[args.conv] is not None:
        cnn.conv_same = CONVS[args.conv]
    torch.backends.cudnn.enabled = args.conv != "cudnn-off"

    from repro_torch.launch import train
    run = train.make_run(clients=args.clients, local_steps=5,
                         batch=args.batch, taus=(1, 5, 10, 20), lr=1e-3,
                         seed=args.seed, device=args.device)
    dev = run.device
    batch = {k: v[:, 0].cpu() for k, v in run.batch_fn(0).items()}
    params = _map(run.params, lambda t: t.cpu())

    # the loss with its decisions exposed is the model's loss, bit for bit
    g_model = vmap(grad(lambda w, x: run.model.loss_fn(w, x)))(
        _map(params, lambda t: t.to(dev)[None].expand(
            (args.clients,) + t.shape).contiguous()),
        {k: v.to(dev) for k, v in batch.items()})
    g_mine, _ = grads_and_route(params, batch, dev, torch.float32, True)
    same = all(torch.equal(g_model[n][l].cpu().double(), g_mine[n][l])
               for n in g_mine for l in g_mine[n])
    print(f"cnn.loss_and_decisions equals the model's loss_fn under vmap "
          f"bitwise: {same}", flush=True)

    ref, ref_route = grads_and_route(params, batch, "cpu", torch.float64,
                                     False)
    runs = {
        f"{dev.type} f32 vmap": (dev, torch.float32, True),
        f"{dev.type} f32 loop": (dev, torch.float32, False),
        "cpu f32 vmap": ("cpu", torch.float32, True),
        f"{dev.type} f64 vmap": (dev, torch.float64, True),
    }
    record, ok = {"decisions_loss_equals_model": same, "conv": args.conv,
                  "runs": {}}, same
    if args.rounds:
        w, ms = train.train_round(run, run.params, 0)[0], []   # warm-up
        for r in range(args.rounds):
            t0 = time.perf_counter()
            w, _ = train.train_round(run, w, r)
            ms.append((time.perf_counter() - t0) * 1e3)
        record["round_ms"] = ms
        print(f"conv {args.conv}: train_round on {dev.type} (N="
              f"{args.clients}, T=5, batch {args.batch}, Adam), ms on the "
              f"host clock: " + ", ".join(f"{t:.1f}" for t in ms), flush=True)
    for label, (d, dt, mapped) in runs.items():
        g, route = grads_and_route(params, batch, d, dt, mapped)
        err = per_client_error(g, ref)
        changes = decision_changes(route, ref_route)
        rec = {"max_error": {k: max(v) for k, v in err.items()},
               "worst_client": {k: max(range(len(v)), key=v.__getitem__)
                                for k, v in err.items()},
               "clients_over_1e-4": {k: [c for c, e in enumerate(v)
                                         if e > 1e-4] for k, v in err.items()},
               "decisions_changed": changes}
        if dt == torch.float32:
            replay, _ = grads_and_route(params, batch, "cpu", torch.float64,
                                        False, route=route)
            rerr = per_client_error(g, replay)
            rec["replay_max_error"] = {k: max(v) for k, v in rerr.items()}
            ok &= max(rec["replay_max_error"].values()) <= REPLAY_TOL
        else:
            ok &= max(rec["max_error"].values()) <= F64_TOL
        record["runs"][label] = rec
        print(f"{label}: vs float64 " + ", ".join(
            f"{k} {v:.2e} (client {rec['worst_client'][k]})"
            for k, v in rec["max_error"].items() if k.endswith(".w")),
            flush=True)
        print(f"  decisions differing from float64: {len(changes)}"
              + "".join(f"\n    {c['site']} client {c['client']} at "
                        f"{c['position']}: float64 gap {c['f64_gap']:.2e}"
                        for c in changes[:20]), flush=True)
        if "replay_max_error" in rec:
            print(f"  vs a float64 replay of its own decisions: " + ", ".join(
                f"{k} {v:.2e}" for k, v in rec["replay_max_error"].items()
                if k.endswith(".w")), flush=True)
    record["ok"] = bool(ok)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps({k: v for k, v in record.items() if k != "runs"}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
