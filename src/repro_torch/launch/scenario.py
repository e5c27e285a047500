"""Scenario plumbing shared by the fleet launchers (twin of the JAX
package's ``examples/_cli.py``).

`launch.fleet`, `launch.serve_fleet` and `launch.trace_fleet` pick their
harvest and traffic processes here, so each exposes the same ``--trace`` /
``--synthetic`` pair (with ``--trace-path`` and ``--obs-dir``), and a
trace run is directly comparable to its synthetic twin: the same scale
(mean joules, mean requests per epoch) and seeds, a different shape of
the arrival law.  ``--checkpoint-dir`` / ``--resume`` (`checkpoint_args`)
make a launcher's controlled runs preemption-safe.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from repro_torch.dist import sharding
from repro_torch.energy.arrivals import MarkovSolar
from repro_torch.serve.traffic import DiurnalPoisson
from repro_torch.traces import (TraceHarvest, TraceTraffic, load_trace,
                                request_profile_table, rescale,
                                solar_profile_table)

GAIN_JITTER = 0.3


def add_scenario_flags(parser: argparse.ArgumentParser
                       ) -> argparse.ArgumentParser:
    """``--trace`` / ``--synthetic`` (mutually exclusive), ``--trace-path``,
    ``--obs-dir``, ``--checkpoint-dir`` and ``--resume``."""
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--trace", action="store_true",
                      help="replay the bundled NSRDB-style solar and "
                           "request-log day profiles (repro_torch.traces)")
    mode.add_argument("--synthetic", action="store_true",
                      help="synthetic processes (the default; the trace "
                           "runs' twins)")
    parser.add_argument("--trace-path", default=None,
                        help="a .npy/.csv profile table in place of the "
                             "bundled ones (with --trace)")
    parser.add_argument("--obs-dir", default=None,
                        help="stream the run as a JSONL event log into this "
                             "directory; read it with `python -m "
                             "repro_torch.obs.report summary DIR`")
    add_checkpoint_flags(parser)
    return parser


def add_checkpoint_flags(parser: argparse.ArgumentParser
                         ) -> argparse.ArgumentParser:
    """``--checkpoint-dir`` and ``--resume``, read by `checkpoint_args`."""
    parser.add_argument("--checkpoint-dir", default=None,
                        help="save chunk-boundary run checkpoints of the "
                             "controlled run into this directory (retained-"
                             "last-k rotation + MANIFEST.json, "
                             "repro_torch.checkpoint.resume)")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the newest intact checkpoint in "
                             "--checkpoint-dir (bitwise the uninterrupted "
                             "run)")
    return parser


def checkpoint_args(args, run: str | None = None) -> dict:
    """``checkpoint=`` / ``resume=`` for a controlled run from the
    ``--checkpoint-dir`` / ``--resume`` flags; exits when ``--resume`` has
    no directory.  ``run`` names a subdirectory for a launcher that drives
    several controlled runs (each has its own config hash and round
    offset, so they cannot share one directory)."""
    d = getattr(args, "checkpoint_dir", None)
    if not d:
        if getattr(args, "resume", False):
            raise SystemExit("--resume requires --checkpoint-dir")
        return {}
    return {"checkpoint": os.path.join(d, run) if run else d,
            "resume": args.resume}


def make_obs(args, mesh=None):
    """An `repro_torch.obs.Obs` on ``--obs-dir`` (on the printing rank only
    under a mesh), else None: the un-instrumented run."""
    if not getattr(args, "obs_dir", None) or not sharding.is_lead(mesh):
        return None
    from repro_torch.obs import Obs
    return Obs(args.obs_dir)


def _table(trace_path, bundled) -> np.ndarray:
    return load_trace(trace_path) if trace_path else bundled()


def solar_harvest(n: int, *, trace: bool, seed: int = 0,
                  trace_path: str | None = None, day_mean: float = 1.0,
                  p_stay: float = 0.9, device=None):
    """Day/night solar harvest at a mean of ``day_mean / 2`` J a round:
    `TraceHarvest` over the bundled season x cloud profiles (rescaled to
    that mean, gain jitter 0.3) with ``trace``, else its `MarkovSolar`
    twin."""
    if trace:
        return TraceHarvest.create(
            rescale(_table(trace_path, solar_profile_table), day_mean / 2.0),
            n, seed=seed, gain_jitter=GAIN_JITTER, device=device)
    return MarkovSolar.create(n, p_stay_day=p_stay, p_stay_night=p_stay,
                              day_mean=day_mean, device=device)


def assistant_traffic(n: int, *, trace: bool, seed: int = 0,
                      trace_path: str | None = None, base: float = 1.0,
                      device=None):
    """Diurnal query traffic at a mean of ``base`` requests an epoch:
    `TraceTraffic` over the bundled weekday / weekend / launch request
    profiles with ``trace``, else its `DiurnalPoisson` twin (time zones
    scattered over the day either way)."""
    if trace:
        return TraceTraffic.create(
            rescale(_table(trace_path, request_profile_table), base), n,
            seed=seed, gain_jitter=GAIN_JITTER, device=device)
    return DiurnalPoisson.create(n, base=base, swing=0.9,
                                 phase=np.arange(n) % 24, device=device)


def scenario_name(trace: bool) -> str:
    return "trace replay" if trace else "synthetic"
