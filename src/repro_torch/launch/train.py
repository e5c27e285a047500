"""Federated training launcher (port of the JAX package's
``launch/train.py``).

Trains any registered architecture the port trains, with any of the
paper's four schedules, through the client-stacked round engine
(``core.round.parallel_round``): every client's local steps at once
(``torch.func.vmap``), then the server's aggregation on the ``fused_agg``
kernel (one launch a dtype a round).

* LMs (``dense``, ``moe``, ``vlm``, ``ssm``; the default is the
  reference's, granite-3-2b): per-client synthetic Markov token streams
  (``data.SyntheticTokens``, ``--seq`` tokens a row), the reference's
  ``token_batch_fn``; a VLM batch carries zero ``vision_embeds``.  The
  local update runs on the plain attention and scan paths (``loss_fn``'s
  ``impl="ref"``): the kernels have no backward.  ``--smoke`` takes the
  reduced smoke config.
* ``--arch cifar-cnn``: the paper's CNN (1,702,794 parameters, float32),
  on the deterministic synthetic CIFAR-shaped image set split iid.

Prints each round's loss, participants, wall time and client-steps/s
(clients x local steps per second of the round) and the fused_agg launch
count, 0 on the CPU.  On the card, TF32 is turned off for matmuls and
convolutions (cuDNN defaults to it for float32), so a float32 run
computes in float32 as the reference does; the CNN's convolutions are
float32 matmuls (``models.cnn.conv_same``).

  python -m repro_torch.launch.train --arch granite-3-2b --smoke   # card
  python -m repro_torch.launch.train --smoke --device cpu --rounds 2
  python -m repro_torch.launch.train --arch cifar-cnn --rounds 3 --device cpu

Differences from the reference's launcher: ``--device`` chooses the card
or the CPU, and checkpointing and observability (``--ckpt``,
``--checkpoint-dir``, ``--resume``, ``--checkpoint-every``, ``--obs-dir``;
``ROADMAP.md`` Queue 1 items 22-24) are not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import EnergyProfile, FedConfig, parallel_round
from repro_torch.data import (FederatedLoader, SyntheticImages,
                              SyntheticTokens, iid_partition)
from repro_torch.device import resolve_device
from repro_torch.kernels import fused_agg
from repro_torch.models import Model, get_model
from repro_torch.optim import Optimizer, OptimizerConfig, make_optimizer

def disable_tf32() -> None:
    """Float32 matmuls and cuDNN convolutions in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_off() -> bool:
    return not (torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32)


@dataclasses.dataclass
class TrainRun:
    """Everything one training run needs, on one device."""

    model: Model
    fed: FedConfig
    optimizer: Optimizer
    params: dict
    batch_fn: Callable[[int], dict]      # round -> (C, T, B, ...) tensors
    p: torch.Tensor                      # (C,) data weights, on the device
    E: torch.Tensor                      # (C,) renewal cycles, on the host
    rng: torch.Tensor                    # prng key of the run
    device: torch.device

    def loss_fn(self, params, batch, key):
        return self.model.loss_fn(params, batch)


def token_batch_fn(cfg, source: SyntheticTokens, C: int, T: int, bc: int,
                   device) -> Callable[[int], dict]:
    """Round r -> {tokens (C, T, bc, S)} from ``source`` (client c's step t
    reads ``source.batch(c, bc, 131 r + t)``, as the reference does); a VLM
    batch adds zero ``vision_embeds`` (C, T, bc, vision_tokens, d)."""
    def fn(rnd):
        toks = np.stack([
            np.stack([source.batch(c, bc, rnd * 131 + t) for t in range(T)])
            for c in range(C)])
        batch = {"tokens": torch.from_numpy(toks.astype(np.int64)).to(device)}
        if cfg.family == "vlm":
            batch["vision_embeds"] = torch.zeros(
                (C, T, bc, cfg.vision_tokens, cfg.d_model),
                dtype=getattr(torch, cfg.dtype), device=device)
        return batch
    return fn


def make_run(arch: str = "cifar-cnn", clients: int = 8, local_steps: int = 5,
             batch: int = 4, taus: tuple[int, ...] = (1, 2, 4, 8),
             policy: str = "sustainable", optimizer: str = "adam",
             lr: float = 1e-3, seed: int = 0, device: Any = "cuda",
             smoke: bool = False, seq: int = 64, cfg=None) -> TrainRun:
    """A run of ``arch`` (its smoke config with ``smoke``; ``cfg``, if
    given, in place of both) on ``device``: params drawn from ``seed`` on
    that device, data weights p = 1/C, cycles from ``taus`` round-robin.
    An LM reads ``seq``-token rows.  On the card this turns TF32 off
    (``disable_tf32``).  Raises NotImplementedError for a family the port
    does not train yet."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        disable_tf32()
    if cfg is None:
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
    model = get_model(cfg)
    if cfg.family == "cnn":
        data = SyntheticImages(num_train=2000, num_test=512, seed=seed)
        imgs, labels = data.train_set()
        loader = FederatedLoader({"images": imgs, "labels": labels},
                                 iid_partition(labels, clients, seed), batch,
                                 local_steps, seed)

        def batch_fn(r):
            return {k: torch.from_numpy(v).to(dev)
                    for k, v in loader.round_batch(r).items()}
    else:
        source = SyntheticTokens(cfg.vocab_size, seq, clients, seed=seed)
        batch_fn = token_batch_fn(cfg, source, clients, local_steps, batch,
                                  dev)

    return TrainRun(
        model=model,
        fed=FedConfig(num_clients=clients, local_steps=local_steps,
                      policy=policy, seed=seed),
        optimizer=make_optimizer(OptimizerConfig(name=optimizer, lr=lr)),
        params=model.init_params(torch.Generator(dev).manual_seed(seed)),
        batch_fn=batch_fn,
        p=torch.full((clients,), 1.0 / clients, dtype=torch.float32,
                     device=dev),
        E=EnergyProfile(clients, tuple(taus)).cycles(),
        rng=prng.PRNGKey(seed), device=dev)


def train_round(run: TrainRun, w, r: int):
    """Round ``r`` from global model ``w``: (new model, metrics as
    floats).  The metrics are read on the host, so the round has ended on
    the device when this returns."""
    w, m = parallel_round(run.loss_fn, run.optimizer, run.fed, w,
                          run.batch_fn(r), run.p, run.E, r,
                          prng.fold_in(run.rng, r))
    return w, {k: float(v) for k, v in m.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-runnable)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--policy", default="sustainable",
                    choices=["sustainable", "greedy", "wait_all", "always"])
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--local-steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64,
                    help="tokens a row (LM archs)")
    ap.add_argument("--taus", default="1,2,4,8",
                    help="energy renewal cycles, assigned round-robin")
    ap.add_argument("--optimizer", default="adam",
                    choices=["adam", "sgd", "sgd_momentum"])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log", default="",
                    help="write the per-round history here as JSON")
    args = ap.parse_args(argv)

    taus = tuple(int(x) for x in args.taus.split(","))
    try:
        run = make_run(args.arch, args.clients, args.local_steps, args.batch,
                       taus, args.policy, args.optimizer, args.lr, args.seed,
                       device=args.device, smoke=args.smoke, seq=args.seq)
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if run.device.type == "cuda":
        where = torch.cuda.get_device_name(run.device)
        tf32 = "off" if tf32_off() else "on"
    else:
        where, tf32 = "cpu", "n/a"
    C, T = args.clients, args.local_steps
    print(f"arch={run.model.cfg.name} family={run.model.cfg.family} "
          f"params={run.model.num_params(run.params):,} clients={C} T={T} "
          f"batch={args.batch} policy={args.policy} E={run.E.tolist()} "
          f"device={where} tf32={tf32}", flush=True)

    launches0 = fused_agg.fused_agg_cuda.launches
    w, history = run.params, []
    for r in range(args.rounds):
        t0 = time.perf_counter()
        w, m = train_round(run, w, r)
        dt = time.perf_counter() - t0
        rec = {"round": r, **m, "round_ms": dt * 1e3,
               "client_steps_per_s": C * T / dt}
        history.append(rec)
        if r % max(1, args.rounds // 10) == 0 or r == args.rounds - 1:
            print(f"round {r:4d} loss={rec['loss']:.4f} "
                  f"participants={rec['participants']:.0f} "
                  f"{rec['round_ms']:.1f} ms "
                  f"({rec['client_steps_per_s']:.1f} client-steps/s)",
                  flush=True)
    steady = history[1:] or history
    round_ms = float(np.mean([h["round_ms"] for h in steady]))
    print(f"mean round {round_ms:.1f} ms = {C * T / round_ms * 1e3:.1f} "
          f"client-steps/s over rounds {steady[0]['round']}.."
          f"{steady[-1]['round']} (round 0 includes the kernel build and "
          f"warm-up); fused_agg kernel launches "
          f"{fused_agg.fused_agg_cuda.launches - launches0}")
    if args.log:
        with open(args.log, "w") as f:
            json.dump(history, f, indent=1)
    print(f"final loss {history[-1]['loss']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
