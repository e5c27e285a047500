"""Fleet-scale energy scenario sweep (twin of the JAX package's
``examples/energy_fleet.py``): 200,000 solar-harvesting clients.

Compares the battery-gated scheduling policies (Algorithm 1's sustainable
slot draw, greedy, threshold 1.5) under a day/night solar harvest (the
Markov twin, or with ``--trace`` the bundled day profiles replayed) with a
compound-Poisson ambient-RF side channel.  The whole fleet (battery
charge, process state, telemetry) lives on the device, and each round runs
the per-client draws and then one ``fleet_step`` kernel launch.  Prints
the policy table, the rounds/s and client-rounds/s of each run and the
kernel's launch count; then a short closed-loop training run
(`core.simulate(..., energy=EnergyLoop(...))`) whose masks come from
realised harvests.

  python -m repro_torch.launch.fleet                       # the card
  python -m repro_torch.launch.fleet --trace --obs-dir runs/fleet
  python -m repro_torch.launch.fleet --device cpu --clients 2000 --rounds 10
  torchrun --nproc-per-node K -m repro_torch.launch.fleet  # K cards

Under ``torchrun`` (``WORLD_SIZE`` above 1) the client axis is sharded over
the ranks (a one-dimensional ``("data",)`` mesh; NCCL, each rank on
``cuda:LOCAL_RANK``, or gloo with ``--device cpu``), as the example does
when JAX sees more than one device; rank 0 prints, and the launch counts
are its own.  The closed loop runs on each rank alone.  ``--obs-dir``
streams the three policy runs into one event log (rank 0's).  The
checkpoint flags (``--checkpoint-dir``, ``--resume``) are accepted as the
example accepts them: its runs are open-loop, so none is checkpointed
(``launch.battery_control`` checkpoints a controlled fleet), and
``--resume`` without ``--checkpoint-dir`` exits.

Differences from the example: ``--backend`` has no counterpart;
``--rounds`` and ``--device`` are new.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import EnergyProfile, FedConfig, Policy, simulate
from repro_torch.device import resolve_device
from repro_torch.dist import sharding
from repro_torch.energy.arrivals import (CompoundPoisson, MarkovSolar, Scaled,
                                         Sum)
from repro_torch.energy.battery import BatteryConfig
from repro_torch.energy.fleet import EnergyLoop, FleetConfig, simulate_fleet
from repro_torch.kernels import fleet_step
from repro_torch.launch import scenario as scen
from repro_torch.optim import sgd

POLICIES = ((Policy.SUSTAINABLE, 1.0), (Policy.GREEDY, 1.0),
            (Policy.THRESHOLD, 1.5))
BATTERY = BatteryConfig(capacity=2.5, leak=0.02, init_charge=0.5)


def scenario(n: int, seed: int, device, trace: bool = False,
             trace_path: str | None = None) -> tuple:
    """The example's fleet: a day/night solar panel at a mean of 0.45 J a
    round (the Markov twin with day mean 0.9 J and stay 0.92, or with
    ``trace`` the bundled solar profiles replayed) scaled by a per-client
    gain U(0.5, 2) drawn from ``np.random.RandomState(seed)``, plus a
    compound-Poisson RF scavenger (rate 0.1, mean 0.3 J); the paper's §V
    cycles E.  Returns (process, battery, E)."""
    rs = np.random.RandomState(seed)
    process = Sum((
        Scaled.create(scen.solar_harvest(n, trace=trace, seed=seed,
                                         trace_path=trace_path,
                                         day_mean=0.9, p_stay=0.92,
                                         device=device),
                      gain=rs.uniform(0.5, 2.0, n).astype(np.float32)),
        CompoundPoisson.create(n, rate=0.1, mean_amount=0.3, device=device),
    ))
    return process, BATTERY, EnergyProfile(n).cycles(device)


def run_policy(process, E, n: int, rounds: int, policy, threshold: float,
               seed: int, hist: bool, device, **kw):
    """One policy's run: (FleetResult, wall seconds, fleet_step launches).
    The wall clock ends after the stats are on the host."""
    cfg = FleetConfig(num_clients=n, policy=policy, threshold=threshold,
                      seed=seed)
    launches0 = fleet_step.fleet_step_cuda.launches
    t0 = time.perf_counter()
    res = simulate_fleet(process, BATTERY, 1.0, cfg, rounds, E=E, hist=hist,
                         device=device, **kw)
    wall = time.perf_counter() - t0
    return res, wall, fleet_step.fleet_step_cuda.launches - launches0


def closed_loop(seed: int, device, rounds: int = 20):
    """The example's closed-loop training run: 8 clients, threshold policy,
    masks from a Markov solar harvest through an `EnergyLoop`, a quadratic
    loss pulling each client's scalar towards its own target."""
    C = 8
    loop = EnergyLoop(MarkovSolar.create(C, day_mean=0.8),
                      BatteryConfig(capacity=3.0, leak=0.01), 1.0,
                      device=device)
    b = torch.linspace(-1.0, 1.0, C, device=loop.device)

    def loss(params, batch, rng):
        return 0.5 * torch.sum((params["w"] - b[batch["client"]]) ** 2)

    def batch_fn(rnd, i):
        return {"client": torch.full((2,), i, dtype=torch.long,
                                     device=loop.device)}

    fed = FedConfig(num_clients=C, local_steps=2, policy=Policy.THRESHOLD,
                    seed=seed)
    return simulate(loss, sgd(0.2), fed,
                    {"w": torch.zeros((), device=loop.device)}, batch_fn,
                    np.ones(C) / C, np.ones(C, np.int32), rounds,
                    prng.PRNGKey(seed), energy=loop)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=200_000)
    ap.add_argument("--rounds", type=int, default=150)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hist", action="store_true",
                    help="fixed-bin histograms of per-client state of "
                         "charge, spend and the depletion streak")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    scen.add_scenario_flags(ap)
    args = ap.parse_args(argv)
    scen.checkpoint_args(args)
    device = resolve_device(args.device)
    mesh, device = sharding.mesh_from_env(args.device)
    say = print if sharding.is_lead(mesh) else (lambda *a, **k: None)
    N, R = args.clients, args.rounds
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    process, _, E = scenario(N, args.seed, device, args.trace,
                             args.trace_path)
    obs = scen.make_obs(args, mesh)
    if mesh is not None:
        say(f"sharding the client axis over {mesh.size()} ranks")
    say(f"fleet: N={N:,} clients, {R} rounds, "
        f"{scen.scenario_name(args.trace)} solar + RF harvest, "
        f"seed={args.seed}, device={where}\n")
    say(f"{'policy':>12} {'part%':>7} {'spent J':>10} {'wasted J':>10} "
        f"{'leaked J':>9} {'depleted%':>9} {'rounds/s':>9} "
        f"{'client-rounds/s':>15} {'launches':>8}")
    for policy, thr in POLICIES:
        res, wall, launches = run_policy(process, E, N, R, policy, thr,
                                         args.seed, args.hist, device,
                                         mesh=mesh, obs=obs)
        s = res.stats
        say(f"{policy.value:>12} {100 * res.participation_rate.mean():7.2f} "
            f"{s['consumed'].sum():10.0f} {s['overflowed'].sum():10.0f} "
            f"{s['leaked'].sum():9.0f} {100 * s['frac_depleted'].mean():9.2f}"
            f" {R / wall:9.2f} {N * R / wall:15.4g} {launches:8d}",
            flush=True)
    say("(rounds/s and client-rounds/s: host clock around each run, the "
        "first run's includes the kernel build; launches: fleet_step "
        "kernel launches, 0 on the CPU)")

    say("\nclosed-loop training (8 clients, threshold policy):")
    res = closed_loop(args.seed, device)
    for h in res.history[::5]:
        say(f"  round {h['round']:2d}: participants={h['participants']} "
            f"mean_charge={h['energy_mean_charge']:.2f} "
            f"loss={h.get('loss', float('nan')):.4f}")
    if obs is not None:
        obs.close()
        say(f"\nobs events -> {obs.log.path}  (python -m "
            f"repro_torch.obs.report summary {args.obs_dir})")
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
