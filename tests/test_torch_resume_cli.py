"""The launchers' checkpoint flags and the three example twins of the
resume slice, on the CPU:

* ``launch.train --checkpoint-dir / --resume`` on the CNN: rounds 0-3,
  then a resume to round 6, bitwise the 6 uninterrupted rounds; the
  ``--ckpt`` model file loads in the reference with ``like=``; the obs
  stream gets a ``resume`` event, not a second manifest;
* ``--resume`` without ``--checkpoint-dir`` exits, for every launcher;
* ``launch.serve_fleet`` and ``launch.trace_fleet`` (one subdirectory a
  run) checkpoint their controlled runs and resume them to the same table;
* ``launch.battery_control``, ``launch.noniid_ablation`` and
  ``launch.train_100m`` against their examples' scenarios and functions.
"""
import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import load_checkpoint
from repro_torch.launch import (battery_control, fleet, noniid_ablation,
                                serve_fleet, trace_fleet, train, train_100m)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CNN = ["--arch", "cifar-cnn", "--device", "cpu", "--clients", "4",
       "--local-steps", "2", "--batch", "2"]


def _same_trees(a, b):
    from repro_torch.checkpoint.ckpt import tree_flatten
    la, lb = tree_flatten(a), tree_flatten(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_train_resume_is_bitwise_and_model_file_loads_in_reference(
        tmp_path, capsys):
    from repro.checkpoint import load_checkpoint as jload
    from repro.configs import get_config
    from repro.models import get_model
    from repro_torch.obs import load_events

    d, od = str(tmp_path / "ck"), str(tmp_path / "obs")
    resumed, whole = str(tmp_path / "b.msgpack"), str(tmp_path / "c.msgpack")
    log = tmp_path / "log.json"
    assert train.main(CNN + ["--rounds", "3", "--checkpoint-dir", d,
                             "--checkpoint-every", "3", "--obs-dir", od]) == 0
    assert train.main(CNN + ["--rounds", "6", "--checkpoint-dir", d,
                             "--resume", "--ckpt", resumed, "--obs-dir", od,
                             "--log", str(log)]) == 0
    assert "resumed from round 3" in capsys.readouterr().out
    assert train.main(CNN + ["--rounds", "6", "--ckpt", whole]) == 0
    a, step, meta = load_checkpoint(resumed)
    b, _, _ = load_checkpoint(whole)
    assert step == 6 and meta == {"arch": "cifar-cnn",
                                  "policy": "sustainable"}
    _same_trees(a, b)
    assert [h["round"] for h in json.loads(log.read_text())] == list(range(6))
    kinds = [e["kind"] for e in load_events(os.path.join(od,
                                                         "events.jsonl"))]
    assert kinds.count("manifest") == 1 and kinds.count("resume") == 1
    assert kinds.count("round") == 6

    model = get_model(get_config("cifar-cnn"))
    like = jax.tree.map(np.asarray, model.init_params(jax.random.PRNGKey(0)))
    got, _, _ = jload(whole, like=like)
    _same_trees(jax.tree.map(lambda x: torch.from_numpy(np.array(x)), got),
                b)
    assert b["conv1"]["w"].shape == like["conv1"]["w"].shape   # HWIO


@pytest.mark.parametrize("module,argv", [
    (train, CNN + ["--rounds", "1"]),
    (fleet, ["--device", "cpu", "--clients", "10", "--rounds", "1"]),
    (serve_fleet, ["--device", "cpu", "--clients", "10", "--epochs", "1"]),
    (trace_fleet, ["--device", "cpu", "--clients", "10", "--epochs", "1"]),
    (battery_control, ["--device", "cpu", "--clients", "10", "--rounds",
                       "1"])],
    ids=["train", "fleet", "serve_fleet", "trace_fleet", "battery_control"])
def test_resume_without_checkpoint_dir_exits(module, argv, capsys):
    with pytest.raises(SystemExit, match="--resume requires --checkpoint-dir"):
        module.main(argv + ["--resume"])
    assert capsys.readouterr().out == ""


def _table(out: str, names) -> list:
    return [line for line in out.splitlines()
            if line.split() and line.split()[0] in names]


def test_serve_fleet_and_trace_fleet_checkpoint_their_controlled_runs(
        tmp_path, capsys):
    d = tmp_path / "serve"
    argv = ["--device", "cpu", "--clients", "200", "--epochs", "48",
            "--checkpoint-dir", str(d)]
    assert serve_fleet.main(argv) == 0
    first = _table(capsys.readouterr().out, ("controlled", "admit", "shed%"))
    assert os.listdir(d) and "ckpt-00000048.msgpack" in os.listdir(d)
    assert serve_fleet.main(argv + ["--resume"]) == 0
    assert _table(capsys.readouterr().out,
                  ("controlled", "admit", "shed%"))[:3] == first[:3]

    d = tmp_path / "trace"
    argv = ["--device", "cpu", "--clients", "64", "--epochs", "48",
            "--checkpoint-dir", str(d)]
    assert trace_fleet.main(argv) == 0
    first = _table(capsys.readouterr().out, ("trace", "twin"))
    assert sorted(os.listdir(d)) == ["trace", "twin"]
    for run in ("trace", "twin"):
        assert "ckpt-00000048.msgpack" in os.listdir(d / run)
    assert trace_fleet.main(argv + ["--resume"]) == 0
    again = _table(capsys.readouterr().out, ("trace", "twin"))
    assert again[:2] == first[:2]          # the table; wall clocks differ


def test_battery_control_twin_matches_example_scenario(tmp_path, capsys):
    """The example's drought fleet and controller at N = 600, 40 rounds:
    the static and controlled runs against the reference's (Markov solar
    draws ulp-close: stats to 1e-5, the knob trajectory equal), and the
    CLI's table the same when resumed from its final checkpoint."""
    from repro.core import EnergyProfile as JProfile
    from repro.energy import (BatteryConfig, ControlBounds, DeviceCostModel,
                              FleetConfig, MarkovSolar, ServerController,
                              run_controlled, simulate_fleet)
    from repro.energy.control import BudgetRule, CadenceRule
    n, R = 600, 40
    proc = MarkovSolar.create(n, p_stay_day=0.6, p_stay_night=0.95,
                              day_mean=0.9)
    bat = BatteryConfig(capacity=6.0, leak=0.01, init_charge=1.0)
    cost = DeviceCostModel(joules_per_step=0.3, joules_per_upload=0.25,
                           joules_per_download=0.25)
    cfg = FleetConfig(num_clients=n, policy="sustainable", seed=0,
                      local_steps=5)
    prof = JProfile(n)
    jstatic = simulate_fleet(proc, bat, cost, cfg, R,
                             E=np.asarray(prof.cycles()))
    jres, jctl = run_controlled(
        proc, bat, cost, cfg, R, ServerController(
            T0=5, E0=prof.taus, groups=np.arange(n) % len(prof.taus),
            rules=(CadenceRule(), BudgetRule()),
            bounds=ControlBounds(t_min=1, t_max=10, e_min=1, e_max=64)),
        control_every=10)
    tstatic = battery_control.static(n, R, device="cpu")
    tres, tctl = battery_control.controlled(n, R, device="cpu")
    for got, want in ((tstatic, jstatic), (tres, jres)):
        for k in want.stats:
            np.testing.assert_allclose(got.stats[k], want.stats[k],
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    assert [(t["T"], t["E_mean"]) for t in tctl.trace] == [
        (t["T"], t["E_mean"]) for t in jctl.trace]

    argv = ["--device", "cpu", "--clients", str(n), "--rounds", str(R),
            "--hist", "--checkpoint-dir", str(tmp_path / "bc")]
    assert battery_control.main(argv) == 0
    first = capsys.readouterr().out
    assert battery_control.main(argv + ["--resume"]) == 0
    again = capsys.readouterr().out
    keep = ("static", "controlled", "T", "E", "depl%", "participation",
            "soc", "streak_out")
    assert _table(again, keep) == _table(first, keep)
    assert "p95=" in first


@pytest.mark.parametrize("alpha", [None, 0.2], ids=["iid", "dir0.2"])
@pytest.mark.parametrize("policy", ["sustainable", "greedy"])
def test_noniid_twin_matches_example(alpha, policy):
    """The example's ``run`` and the twin's on the same cell, 2 rounds:
    the MLP's initial weights are ulp-close (``prng.normal``), so the test
    accuracy within 3 of 1000 samples and the loss within 1e-4."""
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import noniid_ablation as example
    finally:
        sys.path.pop(0)
    want = example.run(alpha, policy, 2)
    got = noniid_ablation.run(alpha, policy, 2, device="cpu")
    assert abs(got[0] - want[0]) <= 0.003
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4)


def test_noniid_cli_writes_its_table(tmp_path, capsys):
    out = tmp_path / "t.json"
    assert noniid_ablation.main(["--device", "cpu", "--rounds", "1",
                                 "--out", str(out)]) == 0
    table = json.loads(out.read_text())
    assert sorted(table) == ["dir(0.2)", "dir(1.0)", "iid"]
    for row in table.values():
        assert 0.0 <= row["alg1_acc"] <= 1.0 and row["seconds"] > 0
    assert capsys.readouterr().out.count("loss_gap=") == 3


def test_train_100m_twin_model_file_loads_in_reference(tmp_path):
    """The twin at its smoke width for one round: the final params'
    ``--ckpt`` loads in the reference with ``like=`` the reference model's
    params of the same configuration, and the log holds the eval loss."""
    from repro.checkpoint import load_checkpoint as jload
    from repro.configs import get_config
    from repro.models import get_model
    ck, log = tmp_path / "m.msgpack", tmp_path / "m.json"
    assert train_100m.main(["--device", "cpu", "--smoke", "--rounds", "1",
                            "--ckpt", str(ck), "--log", str(log)]) == 0
    cfg = dataclasses.replace(get_config("granite-3-2b"),
                              **train_100m.SMOKE_WIDTHS, dtype="float32",
                              remat=False)
    model = get_model(cfg)
    shapes = jax.eval_shape(lambda: model.init_params(
        jax.random.PRNGKey(0)))
    like = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    got, step, meta = jload(str(ck), like=like)
    assert step == 1 and meta["arch"] == "granite-100m"
    mine, _, _ = load_checkpoint(str(ck))
    assert np.isfinite(np.asarray(got["embed"]["tok"])).all()
    assert torch.equal(mine["embed"]["tok"],
                       torch.from_numpy(np.array(got["embed"]["tok"])))
    hist = json.loads(log.read_text())["history"]
    assert np.isfinite(hist[-1]["eval_loss"])
