"""Battery-gated serving under a solar day/night harvest and diurnal query
traffic (twin of the JAX package's ``examples/serve_fleet.py``).

A solar-harvesting fleet (100,000 clients by default) answers
time-zone-scattered diurnal query traffic while a federated training load
competes for the same batteries, under three admission strategies:

* ``agnostic`` — serve every request at full length;
* ``gated`` — `BatteryGated` admission with margins 2.0 / 1.5;
* ``controlled`` — the gated policy with the closed-loop `AdmissionRule`
  (`energy.control.ServerController`) adapting the admission scale every
  24 epochs (a day).

Each epoch runs the per-client draws and then one launch of the
``fleet_step`` kernel's serve program.  Prints the example's table, the
controller's trajectory, epochs/s and client-epochs/s of each run and the
kernel's launch count (0 on the CPU)::

  python -m repro_torch.launch.serve_fleet                 # the card
  python -m repro_torch.launch.serve_fleet --trace --obs-dir runs/serve
  python -m repro_torch.launch.serve_fleet --device cpu --clients 2000 --epochs 24
  torchrun --nproc-per-node K -m repro_torch.launch.serve_fleet   # K cards

Under ``torchrun`` (``WORLD_SIZE`` above 1) the client axis is sharded over
the ranks (a one-dimensional ``("data",)`` mesh; NCCL, each rank on
``cuda:LOCAL_RANK``, or gloo with ``--device cpu``), as the example does
when JAX sees more than one device; rank 0 prints, and the launch counts
are its own.  ``--trace`` replays the bundled solar and request-log day
profiles (``--trace-path`` a table of your own) in place of the synthetic
twins; ``--obs-dir`` streams the controlled run into an event log (rank
0's); ``--checkpoint-dir DIR`` checkpoints the controlled run at its
chunk boundaries and ``--resume`` picks an interrupted run back up,
bitwise (rank 0 writes, every rank reads).

Differences from the example: ``--microbench ARCH`` prices requests from
the port's own `engine_microbench` (default ``mamba2-1.3b``, as the
example's) and exits 1 for an architecture with no decode path;
``--backend`` has no counterpart; ``--epochs`` and ``--device`` are new.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist import sharding
from repro_torch.energy.battery import BatteryConfig
from repro_torch.energy.control import (AdmissionRule, ControlBounds,
                                        ServerController)
from repro_torch.energy.costs import DecodeCostModel
from repro_torch.kernels import fleet_step
from repro_torch.launch import scenario as scen
from repro_torch.serve import (BatteryGated, EnergyAgnostic, QoSSpec,
                               ServeConfig, TrainLoad, run_serve_controlled,
                               simulate_serve)

RUNS = ("agnostic", "gated", "controlled")
BATTERY = BatteryConfig(capacity=8.0, leak=0.01, init_charge=2.0)
QOS = QoSSpec(prompt_tokens=128.0, full_decode_tokens=256.0,
              short_decode_tokens=32.0)
TRAIN_J = 0.2            # joules per training round, every ~4 epochs
CONTROL_EVERY = 24       # epochs per control period (a day)


def scenario(n: int, device, trace: bool = False, seed: int = 0,
             trace_path: str | None = None) -> tuple:
    """The example's fleet: traffic at a mean of one request an epoch
    (``DiurnalPoisson``, swing 0.9, phase ``arange(N) % 24``, or with
    ``trace`` the bundled request-log profiles replayed), a solar harvest
    at a mean of 1.5 J an epoch (``MarkovSolar``, stay 0.9, day mean 3.0 J,
    or the bundled solar profiles replayed), a ~100M-parameter model's
    analytic request cost and a 0.2 J training round every 4 epochs.
    ``seed`` and ``trace_path`` feed the replays' client assignment and
    table.  Returns (traffic, harvest, cost, train)."""
    traffic = scen.assistant_traffic(n, trace=trace, seed=seed,
                                     trace_path=trace_path, base=1.0,
                                     device=device)
    harvest = scen.solar_harvest(n, trace=trace, seed=seed,
                                 trace_path=trace_path, day_mean=3.0,
                                 device=device)
    train = TrainLoad.create(np.full(n, 4), TRAIN_J, device=device)
    return traffic, harvest, DecodeCostModel.from_params(1e8), train


def controller() -> ServerController:
    return ServerController(T0=5, E0=4, rules=(AdmissionRule(),),
                            bounds=ControlBounds())


def run(name: str, traffic, harvest, cost, train, n: int, epochs: int,
        seed: int, device, hist: bool = False, **kw):
    """One of the three runs: (ServeResult, controller or None, wall
    seconds, serve-program launches).  The wall clock ends after the stats
    are on the host."""
    cfg = ServeConfig(num_clients=n, seed=seed)
    launches0 = fleet_step.serve_step_cuda.launches
    ctrl = None
    t0 = time.perf_counter()
    if name == "controlled":
        res, ctrl = run_serve_controlled(
            traffic, harvest, BATTERY, cost, QOS,
            BatteryGated.create(n, device=device), cfg, epochs, controller(),
            train_cost=TRAIN_J, control_every=CONTROL_EVERY, hist=hist,
            device=device, **kw)
    else:
        policy = (EnergyAgnostic() if name == "agnostic"
                  else BatteryGated.create(n, hi=2.0, lo=1.5, device=device))
        res = simulate_serve(traffic, harvest, BATTERY, cost, QOS, policy,
                             cfg, epochs, train=train, hist=hist,
                             device=device, **kw)
    wall = time.perf_counter() - t0
    return res, ctrl, wall, fleet_step.serve_step_cuda.launches - launches0


def microbench_cost(arch: str, device) -> DecodeCostModel:
    """Requests priced from the port's decode-engine microbenchmark of
    ``arch``'s smoke configuration; raises NotImplementedError for an
    architecture with no decode path."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.serve import engine_microbench, measured_cost

    mcfg = get_smoke_config(arch)
    model = get_model(mcfg)
    if model.decode_step is None:
        raise NotImplementedError(f"--microbench {arch}: family "
                                  f"{mcfg.family!r} has no decode path")
    gen = torch.Generator(device=device).manual_seed(0)
    rec = engine_microbench(model, model.init_params(gen), device=device)
    print(f"microbench pricing ({mcfg.name}, {rec['device_watts']:.1f} W "
          f"nominal on {rec['device']}): decode "
          f"{rec['joules_per_decode_token_measured']:.2e} J/tok measured vs "
          f"{rec['joules_per_decode_token_analytic']:.2e} analytic\n")
    return measured_cost(rec)


def table_row(name: str, res, n: int) -> str:
    s = res.stats
    off = max(s["offered"].sum(), 1e-9)
    return (f"{name:>12} "
            f"{100 * (s['served_full'].sum() + s['served_short'].sum()) / off:8.2f} "
            f"{100 * s['served_short'].sum() / off:6.2f} "
            f"{100 * s['shed'].sum() / off:6.2f} "
            f"{100 * s['deadline_missed'].sum() / off:6.2f} "
            f"{100 * s['frac_depleted'].mean():6.2f} "
            f"{100 * s['participants'].mean() / n:7.2f} "
            f"{res.joules_per_token:8.4f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=100_000)
    ap.add_argument("--epochs", type=int, default=192)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hist", action="store_true",
                    help="fixed-bin histograms of per-client state of "
                         "charge, spend and the depletion streak (the "
                         "controlled run)")
    ap.add_argument("--microbench", metavar="ARCH", nargs="?",
                    const="mamba2-1.3b", default=None,
                    help="price requests from the port's measured "
                         "decode-engine stage timings on this smoke arch")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    scen.add_scenario_flags(ap)
    args = ap.parse_args(argv)
    ckpt_kw = scen.checkpoint_args(args)
    device = resolve_device(args.device)
    mesh, device = sharding.mesh_from_env(args.device)
    say = print if sharding.is_lead(mesh) else (lambda *a, **k: None)
    N, E = args.clients, args.epochs
    traffic, harvest, cost, train = scenario(N, device, args.trace,
                                             args.seed, args.trace_path)
    if args.microbench:
        try:
            cost = microbench_cost(args.microbench, device)
        except NotImplementedError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    if mesh is not None:
        say(f"sharding the client axis over {mesh.size()} ranks")
    full_j = float(QOS.request_cost(cost))
    short_j = float(QOS.request_cost(cost, degraded=True))
    say(f"fleet: N={N:,}, {E} epochs, {scen.scenario_name(args.trace)} "
        f"scenario, seed={args.seed}, device={where}; request="
        f"{full_j:.2f} J full / "
        f"{short_j:.2f} J degraded; training round={TRAIN_J} J every ~4 "
        f"epochs\n")
    runs, ctrl, speed = {}, None, {}
    obs = scen.make_obs(args, mesh)
    for name in RUNS:
        kw = dict(obs=obs, **ckpt_kw) if name == "controlled" else {}
        res, c, wall, launches = run(name, traffic, harvest, cost, train, N,
                                     E, args.seed, device,
                                     hist=args.hist and name == "controlled",
                                     mesh=mesh, **kw)
        runs[name] = res
        ctrl = c or ctrl
        speed[name] = (wall, launches)
    if obs is not None:
        obs.close()
        say(f"obs events (controlled run) -> {obs.log.path}  (python -m "
            f"repro_torch.obs.report summary {args.obs_dir})\n")

    say(f"{'':>12} {'served%':>8} {'degr%':>6} {'shed%':>6} {'miss%':>6} "
        f"{'depl%':>6} {'train%':>7} {'J/tok':>8}")
    for name, res in runs.items():
        say(table_row(name, res, N))

    say("\nadmission-controller trajectory (per day):")
    say("  admit :", [round(t["admit"], 2) for t in ctrl.trace])
    say("  shed% :", [round(100 * t["telemetry"].shed_rate, 1)
                      for t in ctrl.trace])
    say("  depl% :", [round(100 * t["telemetry"].frac_depleted, 1)
                      for t in ctrl.trace])

    say(f"\n{'run':>12} {'epochs/s':>9} {'client-epochs/s':>16} "
        f"{'launches':>8}")
    for name, (wall, launches) in speed.items():
        say(f"{name:>12} {E / wall:9.2f} {N * E / wall:16.4g} "
            f"{launches:8d}")
    say("(host clock around each run, the first run's includes the kernel "
        "build; launches: serve-program launches of the fleet_step "
        "kernel, 0 on the CPU)")

    agn, gated = runs["agnostic"].stats, runs["gated"].stats
    un_a = ((agn["shed"].sum() + agn["deadline_missed"].sum())
            / max(agn["offered"].sum(), 1e-9))
    un_g = ((gated["shed"].sum() + gated["deadline_missed"].sum())
            / max(gated["offered"].sum(), 1e-9))
    say(f"\nunanswered requests: {100 * un_a:.1f}% (agnostic) -> "
        f"{100 * un_g:.1f}% (gated), depletion "
        f"{100 * agn['frac_depleted'].mean():.1f}% -> "
        f"{100 * gated['frac_depleted'].mean():.1f}%")
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
