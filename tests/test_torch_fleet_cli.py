"""``python -m repro_torch.launch.fleet``: the twin of
``examples/energy_fleet.py`` runs on the CPU when asked (its policy table
agrees with the reference's ``simulate_fleet`` on the same scenario),
refuses to run without a card otherwise, and replays the bundled day
profiles under ``--trace`` into an event log that ``report summary``
reads."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.fleet",
                           *args], capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=300)


def test_fleet_cli_runs_on_cpu_and_matches_the_reference():
    n, R = 2000, 10
    out = _run("--device", "cpu", "--clients", str(n), "--rounds", str(R),
               "--hist")
    assert out.returncode == 0, out.stderr
    assert f"N={n:,} clients, {R} rounds" in out.stdout
    assert "device=cpu" in out.stdout
    rows = {line.split()[0]: line.split() for line in out.stdout.splitlines()
            if line.split() and line.split()[0] in (
                "sustainable", "greedy", "threshold")}
    assert set(rows) == {"sustainable", "greedy", "threshold"}
    for r in rows.values():
        assert r[-1] == "0"                     # no kernel launch on the CPU
        assert float(r[6]) > 0 and float(r[7]) > 0
    assert "closed-loop training (8 clients, threshold policy):" in out.stdout
    assert out.stdout.count("mean_charge=") == 4

    from repro.core import EnergyProfile
    from repro.energy import (BatteryConfig, CompoundPoisson, FleetConfig,
                              MarkovSolar, Scaled, Sum, simulate_fleet)
    rs = np.random.RandomState(0)
    process = Sum((Scaled.create(
        MarkovSolar.create(n, p_stay_day=0.92, p_stay_night=0.92,
                           day_mean=0.9),
        gain=rs.uniform(0.5, 2.0, n).astype(np.float32)),
        CompoundPoisson.create(n, rate=0.1, mean_amount=0.3)))
    bat = BatteryConfig(capacity=2.5, leak=0.02, init_charge=0.5)
    E = np.asarray(EnergyProfile(n).cycles())
    for policy, thr in (("sustainable", 1.0), ("greedy", 1.0),
                        ("threshold", 1.5)):
        res = simulate_fleet(process, bat, 1.0,
                             FleetConfig(num_clients=n, policy=policy,
                                         threshold=thr), R, E=E)
        got = [float(x) for x in rows[policy][1:6]]
        s = res.stats
        want = [100 * res.participation_rate.mean(), s["consumed"].sum(),
                s["overflowed"].sum(), s["leaked"].sum(),
                100 * s["frac_depleted"].mean()]
        # printed to 2 decimals (%) and to the joule
        np.testing.assert_allclose(got, want, atol=1.0, err_msg=policy)


def test_fleet_cli_without_card_exits_nonzero_with_clear_message():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    out = _run("--rounds", "1", "--clients", "10")
    assert out.returncode == 1
    assert "torch.cuda.is_available() is False" in out.stderr
    assert "--device cpu" in out.stderr
    assert "client-rounds/s" not in out.stdout


def test_fleet_cli_refuses_trace_naming_the_roadmap_item(tmp_path):
    """``--trace`` (refused until the traces were ported) replays the
    bundled solar profiles; with ``--obs-dir`` the three policy runs land in
    one event log, which ``report summary`` reads."""
    n, R = 300, 4
    out = _run("--device", "cpu", "--trace", "--clients", str(n),
               "--rounds", str(R))
    assert out.returncode == 0, out.stderr
    assert "trace replay solar + RF harvest" in out.stdout
    rows = [line.split() for line in out.stdout.splitlines()
            if line.split()[:1] in (["sustainable"], ["greedy"],
                                     ["threshold"])]
    assert len(rows) == 3 and all(r[-1] == "0" for r in rows)
    obs_dir = tmp_path / "obs"
    out = _run("--device", "cpu", "--trace", "--clients", str(n),
               "--rounds", str(R), "--obs-dir", str(obs_dir))
    assert out.returncode == 0, out.stderr
    assert f"obs events -> {obs_dir / 'events.jsonl'}" in out.stdout
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    rep = subprocess.run([sys.executable, "-m", "repro_torch.obs.report",
                          "summary", str(obs_dir)], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert rep.returncode == 0, rep.stderr
    assert "[fleet]" in rep.stdout and "torch=" in rep.stdout
    assert f"fleet: rounds 0..{R - 1} ({3 * R} emitted)" in rep.stdout
