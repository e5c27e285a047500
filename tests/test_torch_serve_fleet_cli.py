"""``python -m repro_torch.launch.serve_fleet``: the twin of
``examples/serve_fleet.py`` runs on the CPU when asked (its table agrees
with the reference's ``simulate_serve`` / ``run_serve_controlled`` on the
same scenario, to the printed precision allowing for the scenario's
ulp-close draws), refuses to run without a card otherwise, and refuses
``--trace`` and an architecture the port does not serve."""
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
    return subprocess.run([sys.executable, "-m",
                           "repro_torch.launch.serve_fleet", *args],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=300)


def test_serve_fleet_cli_runs_on_cpu_and_matches_the_reference():
    n, E = 2000, 48
    out = _run("--device", "cpu", "--clients", str(n), "--epochs", str(E),
               "--hist")
    assert out.returncode == 0, out.stderr
    assert f"N={n:,}, {E} epochs" in out.stdout and "device=cpu" in out.stdout
    assert "request=0.77 J full / 0.32 J degraded" in out.stdout
    lines = [line.split() for line in out.stdout.splitlines() if line.split()]
    table = {r[0]: r for r in lines if r[0] in ("agnostic", "gated",
                                                "controlled") and len(r) == 8}
    speed = {r[0]: r for r in lines if r[0] in table and len(r) == 4}
    assert set(table) == set(speed) == {"agnostic", "gated", "controlled"}
    for r in speed.values():
        assert r[-1] == "0"                     # no kernel launch on the CPU
        assert float(r[1]) > 0 and float(r[2]) > 0
    assert "admission-controller trajectory (per day):" in out.stdout
    assert "unanswered requests:" in out.stdout

    from repro.energy import (AdmissionRule, BatteryConfig, ControlBounds,
                              DecodeCostModel, MarkovSolar, ServerController)
    from repro.serve import (BatteryGated, DiurnalPoisson, EnergyAgnostic,
                             QoSSpec, ServeConfig, TrainLoad,
                             run_serve_controlled, simulate_serve)
    traffic = DiurnalPoisson.create(n, base=1.0, swing=0.9,
                                    phase=np.arange(n) % 24)
    harvest = MarkovSolar.create(n, p_stay_day=0.9, p_stay_night=0.9,
                                 day_mean=3.0)
    args = (traffic, harvest,
            BatteryConfig(capacity=8.0, leak=0.01, init_charge=2.0),
            DecodeCostModel.from_params(1e8), QoSSpec(128.0, 256.0, 32.0))
    cfg = ServeConfig(num_clients=n, seed=0)
    train = TrainLoad.create(np.full(n, 4), 0.2)
    ctrl = ServerController(T0=5, E0=4, rules=(AdmissionRule(),),
                            bounds=ControlBounds())
    runs = {
        "agnostic": simulate_serve(*args, EnergyAgnostic(), cfg, E,
                                   train=train),
        "gated": simulate_serve(*args, BatteryGated.create(n, hi=2.0, lo=1.5),
                                cfg, E, train=train),
        "controlled": run_serve_controlled(
            *args, BatteryGated.create(n), cfg, E, ctrl, train_cost=0.2,
            control_every=24, hist=True)[0]}
    for name, res in runs.items():
        s = res.stats
        off = s["offered"].sum()
        want = [100 * (s["served_full"].sum() + s["served_short"].sum()) / off,
                100 * s["served_short"].sum() / off, 100 * s["shed"].sum() / off,
                100 * s["deadline_missed"].sum() / off,
                100 * s["frac_depleted"].mean(),
                100 * s["participants"].mean() / n, res.joules_per_token]
        got = [float(x) for x in table[name][1:]]
        np.testing.assert_allclose(got[:6], want[:6], atol=0.1, err_msg=name)
        np.testing.assert_allclose(got[6], want[6], atol=2e-4, err_msg=name)
    admits = [round(t["admit"], 2) for t in ctrl.trace]
    assert f"  admit : {admits}" in out.stdout


def test_serve_fleet_cli_without_card_exits_nonzero_with_clear_message():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    out = _run("--epochs", "1", "--clients", "10")
    assert out.returncode == 1
    assert "torch.cuda.is_available() is False" in out.stderr
    assert "--device cpu" in out.stderr
    assert "client-epochs/s" not in out.stdout


def test_serve_fleet_cli_refuses_trace_and_unported_archs():
    out = _run("--device", "cpu", "--trace")
    assert out.returncode == 1
    assert "Queue 1 item 21" in out.stderr
    out = _run("--device", "cpu", "--clients", "10", "--epochs", "1",
               "--microbench", "recurrentgemma-2b")
    assert out.returncode == 1
    assert "Queue 1 item 20b" in out.stderr and "'hybrid'" in out.stderr
    out = _run("--device", "cpu", "--clients", "10", "--epochs", "1",
               "--microbench", "cifar-cnn")
    assert out.returncode == 1
    assert "no decode path" in out.stderr and "'ssm'" in out.stderr


def test_serve_fleet_cli_prices_from_the_mamba2_microbench():
    """``--microbench`` with no argument means mamba2-1.3b, as in the
    example: requests are priced from the port's own engine microbenchmark
    of its smoke config."""
    out = _run("--device", "cpu", "--clients", "10", "--epochs", "2",
               "--microbench")
    assert out.returncode == 0, out.stderr
    assert "microbench pricing (mamba2-1.3b" in out.stdout
    assert "on cpu)" in out.stdout
    assert "client-epochs/s" in out.stdout
