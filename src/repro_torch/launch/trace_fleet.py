"""Trace-driven evaluation: replayed day profiles against their fitted
synthetic twins (twin of the JAX package's ``examples/trace_fleet.py``).

1. **Replay** — `TraceHarvest` over the bundled NSRDB-style solar profiles
   (season x cloud regimes, rescaled to 1.5 J an epoch) and `TraceTraffic`
   over the request-log profiles (weekday / weekend / launch spike,
   rescaled to one request an epoch), each client assigned a profile, a
   time-zone phase and a gain through the per-client RNG.
2. **Fit** — `fit_markov_solar` / `fit_diurnal_poisson` on sample paths of
   phase-aligned replays (256 clients x 240 epochs: one local time, so the
   pooled fit keeps the diurnal harmonic each client sees); the twins then
   scatter their own time zones.
3. **Compare** — `run_serve_controlled` (battery-gated admission and the
   closed-loop `AdmissionRule`, control every 24 epochs) under the trace
   pair and under the twins: the same fleet, batteries and controller, so
   the gap is what the synthetic family cannot express.  Both runs stream
   into one event log with ``--obs-dir`` (one manifest, then a ``phase``
   event); ``--checkpoint-dir DIR`` checkpoints each run into its own
   subdirectory (``DIR/trace``, ``DIR/twin``) and ``--resume`` picks them
   back up, bitwise.

Each epoch is one launch of the ``fleet_step`` kernel's serve program on
the card (its plain version on the CPU)::

  python -m repro_torch.launch.trace_fleet                 # the card
  python -m repro_torch.launch.trace_fleet --device cpu --clients 2000 --epochs 48
  python -m repro_torch.launch.trace_fleet --trace-path my.csv --obs-dir runs/t

Differences from the example: ``--backend`` has no counterpart;
``--device`` is new.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.energy.costs import DecodeCostModel
from repro_torch.launch import scenario as scen
from repro_torch.launch import serve_fleet
from repro_torch.serve.traffic import DiurnalPoisson
from repro_torch.traces import (TraceHarvest, TraceTraffic,
                                fit_diurnal_poisson, fit_markov_solar,
                                load_trace, request_profile_table, rescale,
                                sample_paths, solar_profile_table)

FIT_N, FIT_R = 256, 240


def tables(trace_path: str | None = None) -> tuple:
    """(solar, request) profile tables at 1.5 J and one request an epoch;
    ``trace_path`` replaces the solar one, as in the example."""
    solar = rescale(load_trace(trace_path) if trace_path
                    else solar_profile_table(), 1.5)
    return solar, rescale(request_profile_table(), 1.0)


def fit_twins(solar, request, n: int, seed: int, device) -> dict:
    """The synthetic twins of the replay, fitted on sample paths of
    phase-aligned replays of FIT_N clients over FIT_R epochs:
    {"solar": MarkovSolar, "diurnal": DiurnalPoisson, "aligned": the
    one-client DiurnalPoisson fit, "fit_s": seconds}."""
    t0 = time.perf_counter()
    zero = np.zeros(FIT_N, np.int32)
    fit_h = TraceHarvest.create(solar, FIT_N, seed=seed, phase=zero,
                                gain_jitter=scen.GAIN_JITTER, device=device)
    fit_t = TraceTraffic.create(request, FIT_N, seed=seed, phase=zero,
                                gain_jitter=scen.GAIN_JITTER, device=device)
    twin_solar = fit_markov_solar(sample_paths(fit_h, FIT_R, seed=seed), n,
                                  device=device)
    aligned = fit_diurnal_poisson(sample_paths(fit_t, FIT_R, seed=seed), 1)
    twin_diurnal = DiurnalPoisson.create(
        n, base=float(aligned.base[0]), swing=float(aligned.swing[0]),
        phase=float(aligned.phase[0]) + np.arange(n) % 24, device=device)
    return {"solar": twin_solar, "diurnal": twin_diurnal, "aligned": aligned,
            "fit_s": time.perf_counter() - t0}


def compare(pairs: dict, n: int, epochs: int, seed: int, device, obs=None,
            hist: bool = False, checkpoint=None) -> dict:
    """`launch.serve_fleet`'s controlled run (its battery, QoS, 0.2 J
    training load and admission controller every 24 epochs) under each
    (harvest, traffic) pair: {name: (ServeResult, controller, wall
    seconds, serve-program launches)}.  ``checkpoint`` is `scen.
    checkpoint_args`' function of a run's name (each run checkpoints into
    its own subdirectory)."""
    cost = DecodeCostModel.from_params(1e8)
    return {name: serve_fleet.run(
        "controlled", traffic, harvest, cost, None, n, epochs, seed, device,
        hist=hist, obs=obs, **(checkpoint(name) if checkpoint else {}))
        for name, (harvest, traffic) in pairs.items()}


def table_row(name: str, res, ctrl) -> str:
    s = res.stats
    off = max(s["offered"].sum(), 1e-9)
    return (f"{name:>10} "
            f"{100 * (s['served_full'].sum() + s['served_short'].sum()) / off:8.2f} "
            f"{100 * s['shed'].sum() / off:6.2f} "
            f"{100 * s['deadline_missed'].sum() / off:6.2f} "
            f"{100 * s['frac_depleted'].mean():6.2f} "
            f"{res.joules_per_token:8.4f} {ctrl.state.admit:10.2f}")


def run(device, clients: int = 50_000, epochs: int = 192, seed: int = 0,
        trace_path: str | None = None, obs=None, hist: bool = False,
        say=print, checkpoint=None) -> dict:
    """The whole evaluation, printed through ``say``: {"twins": fit_twins's
    dict, "runs": compare's dict, "replay": (harvest, traffic)}.
    ``checkpoint`` as in `compare`."""
    device = resolve_device(device)
    N = clients
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    solar, request = tables(trace_path)
    harvest = TraceHarvest.create(solar, N, seed=seed,
                                  gain_jitter=scen.GAIN_JITTER, device=device)
    traffic = TraceTraffic.create(request, N, seed=seed,
                                  gain_jitter=scen.GAIN_JITTER, device=device)
    twins = fit_twins(solar, request, N, seed, device)
    ts, al = twins["solar"], twins["aligned"]
    say(f"calibrated twins (fit on {FIT_N} clients x {FIT_R} epochs of "
        f"replay, {twins['fit_s']:.2f} s, device={where}):")
    say(f"  MarkovSolar:    p_stay_day={float(ts.p_stay_day[0]):.3f} "
        f"p_stay_night={float(ts.p_stay_night[0]):.3f} "
        f"day_mean={float(ts.day_mean[0]):.3f} J "
        f"night_mean={float(ts.night_mean[0]):.3f} J")
    say(f"  DiurnalPoisson: base={float(al.base[0]):.3f} "
        f"swing={float(al.swing[0]):.3f} phase={float(al.phase[0]):.1f} h "
        f"(time zones re-scattered)\n")

    say(f"controlled serving, N={N:,}, {epochs} epochs "
        f"(battery-gated admission + AdmissionRule):")
    say(f"{'':>10} {'served%':>8} {'shed%':>6} {'miss%':>6} {'depl%':>6} "
        f"{'J/tok':>8} {'admit(end)':>10}")
    runs = compare({"trace": (harvest, traffic),
                    "twin": (twins["solar"], twins["diurnal"])}, N, epochs,
                   seed, device, obs=obs, hist=hist, checkpoint=checkpoint)
    for name, (res, ctrl, _, _) in runs.items():
        say(table_row(name, res, ctrl))

    tr, tw = runs["trace"][0].stats, runs["twin"][0].stats
    say("\nwhat calibration cannot flatten (per-epoch extremes over the "
        "run):")
    say(f"  depletion p95: {np.percentile(tr['frac_depleted'], 95):.3f} "
        f"trace vs {np.percentile(tw['frac_depleted'], 95):.3f} twin "
        f"(consecutive-overcast droughts)")
    say(f"  offered  p99: {np.percentile(tr['offered'], 99):.0f} trace vs "
        f"{np.percentile(tw['offered'], 99):.0f} twin (launch-day spike)")
    say(f"\n{'run':>10} {'epochs/s':>9} {'client-epochs/s':>16} "
        f"{'launches':>8}")
    for name, (_, _, wall, launches) in runs.items():
        say(f"{name:>10} {epochs / wall:9.2f} {N * epochs / wall:16.4g} "
            f"{launches:8d}")
    say("(host clock around each controlled run; launches: serve-program "
        "launches of the fleet_step kernel, 0 on the CPU)")
    return {"twins": twins, "runs": runs, "replay": (harvest, traffic)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--clients", type=int, default=50_000)
    ap.add_argument("--epochs", type=int, default=192)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the client assignment and the simulators")
    ap.add_argument("--trace-path", default=None,
                    help="a .npy/.csv solar profile table in place of the "
                         "bundled one: fit the twins to your measurements")
    ap.add_argument("--obs-dir", default=None,
                    help="stream both controlled runs into one event log in "
                         "this directory")
    ap.add_argument("--hist", action="store_true",
                    help="fixed-bin histograms of per-client state of "
                         "charge, spend and the depletion streak")
    scen.add_checkpoint_flags(ap)
    args = ap.parse_args(argv)
    scen.checkpoint_args(args)
    resolve_device(args.device)
    obs = scen.make_obs(args)
    run(args.device, args.clients, args.epochs, args.seed, args.trace_path,
        obs=obs, hist=args.hist,
        checkpoint=lambda name: scen.checkpoint_args(args, run=name))
    if obs is not None:
        obs.close()
        print(f"\nobs events -> {obs.log.path}  (python -m "
              f"repro_torch.obs.report summary {args.obs_dir})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
