"""Federated training launcher (port of the JAX package's
``launch/train.py``).

Trains any registered architecture the port trains, with any of the
paper's four schedules, through the client-stacked round engine
(``core.round.parallel_round``): every client's local steps at once
(``torch.func.vmap``), then the server's aggregation on the ``fused_agg``
kernel (one launch a dtype a round).

* LMs (``dense``, ``moe``, ``vlm``, ``ssm``, ``hybrid``, ``encdec``; the
  default is the reference's, granite-3-2b): per-client synthetic Markov
  token streams (``data.SyntheticTokens``, ``--seq`` tokens a row), the
  reference's ``token_batch_fn``; a VLM batch carries zero
  ``vision_embeds``, an encoder-decoder batch random ``frames``.  The
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
  python -m repro_torch.launch.train --smoke --obs-dir runs/train

``--obs-dir`` streams the run into a JSONL event log: the manifest, then a
``train_round`` span and a ``round`` event a round (the round's metrics
are read on the host inside the span, so it covers the device's work).

``--checkpoint-dir DIR`` saves a run checkpoint (the params, the round and
the loss / participants history; `repro_torch.checkpoint.resume`) every
``--checkpoint-every`` rounds and after the last; ``--resume`` continues
from the newest intact one, and re-attaches ``--obs-dir`` with a
``resume`` event.  A round's batches and keys derive from its absolute
index, so a resumed run equals an uninterrupted one (bitwise on the CPU).
``--ckpt PATH`` writes the final params as a model file in the
reference's layout (the CNN's conv weights HWIO), which the reference's
``load_checkpoint(PATH, like=params)`` reads.

  python -m repro_torch.launch.train --arch cifar-cnn --device cpu \\
      --rounds 6 --checkpoint-dir runs/ck --checkpoint-every 3 --ckpt w.msgpack

Differences from the reference's launcher: ``--device`` chooses the card
or the CPU; ``--layers K`` cuts the configuration to K layers (its widths
stay); the run checkpoint's config hash covers the whole model
configuration, not only its name.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import convert, prng
from repro_torch.checkpoint import resume as resume_lib
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import EnergyProfile, FedConfig, parallel_round
from repro_torch.data import (FederatedLoader, SyntheticImages,
                              SyntheticTokens, iid_partition)
from repro_torch.device import resolve_device
from repro_torch.kernels import fused_agg
from repro_torch.models import Model, get_model
from repro_torch.optim import Optimizer, OptimizerConfig, make_optimizer
from repro_torch.tree import tree_map

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
    batch adds zero ``vision_embeds`` (C, T, bc, vision_tokens, d), an
    encoder-decoder batch ``frames`` (C, T, bc, encoder_seq, d), standard
    normals from ``numpy.random.RandomState(r)`` as the reference draws
    them."""
    def fn(rnd):
        toks = np.stack([
            np.stack([source.batch(c, bc, rnd * 131 + t) for t in range(T)])
            for c in range(C)])
        batch = {"tokens": torch.from_numpy(toks.astype(np.int64)).to(device)}
        if cfg.family == "vlm":
            batch["vision_embeds"] = torch.zeros(
                (C, T, bc, cfg.vision_tokens, cfg.d_model),
                dtype=getattr(torch, cfg.dtype), device=device)
        if cfg.family == "encdec":
            frames = np.random.RandomState(rnd).randn(
                C, T, bc, cfg.encoder_seq, cfg.d_model)
            batch["frames"] = torch.from_numpy(frames).to(
                getattr(torch, cfg.dtype)).to(device)
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
    (``disable_tf32``)."""
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


def model_file_tree(run: TrainRun, w):
    """The params ``w`` in the reference's layout, for a model file that the
    reference's ``load_checkpoint(like=params)`` reads: the CNN's conv
    weights HWIO (``convert.cnn_params_to_numpy``); an LM's nest as it
    is."""
    if run.model.cfg.family == "cnn":
        return convert.cnn_params_to_numpy(w)
    return w


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-runnable)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers (depth only)")
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
    ap.add_argument("--ckpt", default="",
                    help="write the final params here as a model file in "
                         "the reference's layout")
    ap.add_argument("--log", default="",
                    help="write the per-round history here as JSON")
    ap.add_argument("--checkpoint-dir", default="",
                    help="save a resumable run checkpoint (params + round + "
                         "history, retained-last-k rotation) into this "
                         "directory every --checkpoint-every rounds")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest intact checkpoint in "
                         "--checkpoint-dir (per-round RNG and batches "
                         "derive from the absolute round index)")
    ap.add_argument("--checkpoint-every", type=int, default=5)
    ap.add_argument("--obs-dir", default="",
                    help="stream the run (manifest, a round event and a "
                         "train_round span a round) to this directory")
    args = ap.parse_args(argv)
    if args.resume and not args.checkpoint_dir:
        raise SystemExit("--resume requires --checkpoint-dir")

    taus = tuple(int(x) for x in args.taus.split(","))
    cfg = None
    if args.layers:
        cfg = dataclasses.replace(
            get_smoke_config(args.arch) if args.smoke
            else get_config(args.arch), num_layers=args.layers)
    run = make_run(args.arch, args.clients, args.local_steps, args.batch,
                   taus, args.policy, args.optimizer, args.lr, args.seed,
                   device=args.device, smoke=args.smoke, seq=args.seq,
                   cfg=cfg)
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

    w, history, start = run.params, [], 0
    ckptr, cfg_hash = None, None
    if args.checkpoint_dir:
        from repro_torch.obs.events import pytree_hash
        ckptr = resume_lib.as_checkpointer(args.checkpoint_dir)
        cfg_hash = pytree_hash(("train", run.model.cfg, run.fed,
                                args.optimizer, args.lr, T, args.batch,
                                args.seq, taus))
        if args.resume:
            rc = resume_lib.restore_run(ckptr, kind="train", state_like=w,
                                        config_hash=cfg_hash, seed=args.seed)
            if rc is not None:
                w = tree_map(lambda t: t.to(run.device), rc.state)
                start = rc.round_offset
                history = [{"round": i, "loss": float(l),
                            "participants": float(p)}
                           for i, (l, p) in enumerate(
                               zip(rc.stats["loss"],
                                   rc.stats["participants"]))]
                print(f"resumed from round {start} ({ckptr.path(start)})",
                      flush=True)

    obs = None
    if args.obs_dir:
        from repro_torch.kernels import ops
        from repro_torch.obs import Obs
        obs = Obs(args.obs_dir)
        if start:
            # re-attach to the run's event stream: a resume event, never a
            # second manifest (DESIGN.md §13.4)
            obs.event("resume", run_kind="train", round=start,
                      horizon=args.rounds, config_hash=cfg_hash,
                      checkpoint_dir=args.checkpoint_dir)
        else:
            obs.write_manifest("train", config=run.fed, seed=args.seed,
                               backend=ops.backend(run.device),
                               num_clients=C, horizon=args.rounds,
                               device=run.device, arch=run.model.cfg.name,
                               family=run.model.cfg.family,
                               params=int(run.model.num_params(run.params)),
                               policy=args.policy, local_steps=T,
                               optimizer=args.optimizer, lr=args.lr)

    launches0 = fused_agg.fused_agg_cuda.launches
    timed = []
    for r in range(start, args.rounds):
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            if obs is not None:
                stack.enter_context(obs.span("train_round"))
            w, m = train_round(run, w, r)
        dt = time.perf_counter() - t0
        rec = {"round": r, **m, "round_ms": dt * 1e3,
               "client_steps_per_s": C * T / dt}
        history.append(rec)
        timed.append(rec)
        if obs is not None:
            obs.event("round", scan="train", **rec)
        if ckptr is not None and ((r + 1) % max(1, args.checkpoint_every)
                                  == 0 or r == args.rounds - 1):
            resume_lib.save_run(
                ckptr, kind="train", round_offset=r + 1, state=w,
                stats={"loss": np.asarray([h["loss"] for h in history]),
                       "participants": np.asarray(
                           [h["participants"] for h in history])},
                config_hash=cfg_hash, seed=args.seed)
        if r % max(1, args.rounds // 10) == 0 or r == args.rounds - 1:
            print(f"round {r:4d} loss={rec['loss']:.4f} "
                  f"participants={rec['participants']:.0f} "
                  f"{rec['round_ms']:.1f} ms "
                  f"({rec['client_steps_per_s']:.1f} client-steps/s)",
                  flush=True)
    if timed:
        steady = timed[1:] or timed
        round_ms = float(np.mean([h["round_ms"] for h in steady]))
        print(f"mean round {round_ms:.1f} ms = {C * T / round_ms * 1e3:.1f} "
              f"client-steps/s over rounds {steady[0]['round']}.."
              f"{steady[-1]['round']} (the first round of a process "
              f"includes the kernel build and warm-up); fused_agg kernel "
              f"launches {fused_agg.fused_agg_cuda.launches - launches0}")
    if args.ckpt:
        save_checkpoint(args.ckpt, model_file_tree(run, w), step=args.rounds,
                        metadata={"arch": run.model.cfg.name,
                                  "policy": args.policy})
        print("checkpoint ->", args.ckpt)
    if args.log:
        with open(args.log, "w") as f:
            json.dump(history, f, indent=1)
    if obs is not None:
        obs.close()
        print("obs events ->", obs.log.path)
    if history:
        print(f"final loss {history[-1]['loss']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
