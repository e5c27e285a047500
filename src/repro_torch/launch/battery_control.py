"""Battery-aware server control under a solar drought (twin of the JAX
package's ``examples/battery_control.py``).

The paper's server is energy-blind: it fixes the round cadence ``T`` and the
per-group renewal cycles ``E`` up front.  This puts a 50,000-client solar
fleet through a drought (days of 2.5 rounds, nights of 20) for 200 rounds
and compares that static schedule with the closed-loop `ServerController`
(`energy.control`: hysteresis + AIMD on ``T`` and per-group ``E``, an
update every 10 rounds), which reads the fleet's telemetry — depleted
fraction, wasted overflow, realised participation.  Each round is one
``fleet_step`` kernel launch on the card (its plain version on the CPU).

  python -m repro_torch.launch.battery_control                 # the card
  python -m repro_torch.launch.battery_control --device cpu --clients 2000 --rounds 40
  python -m repro_torch.launch.battery_control --checkpoint-dir runs/bc
  python -m repro_torch.launch.battery_control --checkpoint-dir runs/bc --resume

``--checkpoint-dir DIR`` checkpoints the controlled run at its chunk
boundaries and ``--resume`` picks an interrupted run back up, bitwise
(DESIGN.md §13).  ``--hist`` adds the in-run histograms and prints the
controlled run's state-of-charge and drought-streak distributions;
``--depletion-signal p95`` makes the rules act on the period's worst
rounds.  Under ``torchrun`` (``WORLD_SIZE`` above 1) the client axis is
sharded over the ranks, as the example shards it over JAX's devices;
rank 0 prints and writes the checkpoints.

Differences from the example: ``--clients``, ``--rounds`` and
``--device`` are new.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.core import EnergyProfile, Policy
from repro_torch.device import resolve_device
from repro_torch.dist import sharding
from repro_torch.energy import (BatteryConfig, ControlBounds, DeviceCostModel,
                                FleetConfig, MarkovSolar, ServerController,
                                run_controlled, simulate_fleet)
from repro_torch.energy.control import BudgetRule, CadenceRule
from repro_torch.kernels import fleet_step
from repro_torch.launch import scenario as scen

N, ROUNDS, CONTROL_EVERY = 50_000, 200, 10
BATTERY = BatteryConfig(capacity=6.0, leak=0.01, init_charge=1.0)
# rounds are priced by the cost model, so the controller's T moves joules
COST = DeviceCostModel(joules_per_step=0.3, joules_per_upload=0.25,
                       joules_per_download=0.25)


def scenario(n: int, device) -> tuple:
    """The drought fleet: (process, FleetConfig, EnergyProfile).  Markov
    solar with a day stay of 0.6 and a night stay of 0.95 (expected day
    2.5 rounds, night 20), day mean 0.9 J; sustainable, T0 = 5, seed 0."""
    process = MarkovSolar.create(n, p_stay_day=0.6, p_stay_night=0.95,
                                 day_mean=0.9, device=device)
    cfg = FleetConfig(num_clients=n, policy=Policy.SUSTAINABLE, seed=0,
                      local_steps=5)
    return process, cfg, EnergyProfile(n)


def controller(n: int, profile: EnergyProfile,
               signal: str = "mean") -> ServerController:
    """The example's controller: T0 = 5, the profile's taus as the groups'
    cycles, `CadenceRule` then `BudgetRule` on ``signal``, T in [1, 10], E
    in [1, 64]."""
    return ServerController(
        T0=5, E0=profile.taus, groups=np.arange(n) % len(profile.taus),
        rules=(CadenceRule(signal=signal), BudgetRule(signal=signal)),
        bounds=ControlBounds(t_min=1, t_max=10, e_min=1, e_max=64))


def controlled(n: int = N, rounds: int = ROUNDS, *, device="cuda",
               signal: str = "mean", hist: bool = False, mesh=None,
               control_every: int = CONTROL_EVERY, **ckpt):
    """The controlled run: (FleetResult, controller).  ``ckpt`` passes
    ``checkpoint=`` / ``resume=`` / ``checkpoint_every=`` on to
    `run_controlled`."""
    process, cfg, profile = scenario(n, device)
    return run_controlled(process, BATTERY, COST, cfg, rounds,
                          controller(n, profile, signal),
                          control_every=control_every, mesh=mesh, hist=hist,
                          device=device, **ckpt)


def static(n: int = N, rounds: int = ROUNDS, *, device="cuda", mesh=None):
    """The energy-blind schedule: one `simulate_fleet` run at T0 and the
    profile's cycles."""
    process, cfg, profile = scenario(n, device)
    return simulate_fleet(process, BATTERY, COST, cfg, rounds,
                          E=profile.cycles(device), mesh=mesh, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=N)
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--hist", action="store_true",
                    help="in-run histograms of state of charge, spend and "
                         "the depletion streak; prints the controlled run's "
                         "distributions")
    ap.add_argument("--depletion-signal", choices=("mean", "p95"),
                    default="mean",
                    help="the depletion statistic the rules act on: the "
                         "period mean (default) or the p95 over its rounds")
    scen.add_checkpoint_flags(ap)
    args = ap.parse_args(argv)
    ckpt = scen.checkpoint_args(args)
    resolve_device(args.device)
    mesh, device = sharding.mesh_from_env(args.device)
    say = print if sharding.is_lead(mesh) else (lambda *a, **k: None)
    n, R = args.clients, args.rounds
    if mesh is not None:
        say(f"sharding the client axis over {mesh.size()} ranks\n")
    say(f"fleet: N={n:,}, {R} rounds of solar drought (T0=5 -> "
        f"{COST.round_cost(5):.1f} J/round)\n")

    launches0 = fleet_step.fleet_step_cuda.launches
    t0 = time.perf_counter()
    base = static(n, R, device=device, mesh=mesh)
    t1 = time.perf_counter()
    res, ctrl = controlled(n, R, device=device, signal=args.depletion_signal,
                           hist=args.hist, mesh=mesh, **ckpt)
    t2 = time.perf_counter()
    launches = fleet_step.fleet_step_cuda.launches - launches0

    say(f"{'':>12} {'part%':>7} {'depleted%':>9} {'spent J':>10} "
        f"{'wasted J':>10}")
    for name, r in (("static", base), ("controlled", res)):
        s = r.stats
        say(f"{name:>12} {100 * r.participation_rate.mean():7.2f} "
            f"{100 * s['frac_depleted'].mean():9.2f} "
            f"{s['consumed'].sum():10.0f} {s['overflowed'].sum():10.0f}")

    say("\ncontroller trajectory (per control period):")
    say("  T      :", [t["T"] for t in ctrl.trace])
    say("  E mean :", [round(t["E_mean"], 1) for t in ctrl.trace])
    say("  depl%  :", [round(100 * t["telemetry"].frac_depleted, 1)
                       for t in ctrl.trace])
    gain = (res.participation_rate.mean()
            / max(base.participation_rate.mean(), 1e-9) - 1)
    say(f"\nparticipation gain vs static schedule: {100 * gain:+.1f}%")

    if args.hist:
        from repro_torch.obs.hist import (SPECS_BY_NAME,
                                          quantiles_from_counts, sparkline)
        say("\ndistributional telemetry (controlled run, whole horizon):")
        for name in ("hist_soc", "hist_streak"):
            spec = SPECS_BY_NAME[name]
            counts = np.asarray(res.stats[name]).reshape(
                -1, spec.bins).sum(0)
            q = quantiles_from_counts(counts, spec)
            say(f"  {spec.buf:>10} [{spec.lo:g},{spec.hi:g}) "
                f"|{sparkline(counts)}|  p50={q['p50']:g} "
                f"p95={q['p95']:g} p99={q['p99']:g}")
    say(f"\nwall: static {t1 - t0:.2f} s, controlled {t2 - t1:.2f} s (host "
        f"clock, the first run's includes the kernel build); fleet_step "
        f"kernel launches {launches} (0 on the CPU)")
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
