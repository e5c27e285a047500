"""``python -m repro_torch.launch.train`` and ``repro_torch.launch.fig1``:
they run on the CPU when asked, refuse to run without a card otherwise,
and refuse the architectures whose training is not ported."""
import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(module, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=300)


@pytest.mark.parametrize("policy", ["sustainable", "wait_all"])
def test_train_cli_runs_on_cpu(policy, tmp_path):
    log = tmp_path / "history.json"
    out = _run("repro_torch.launch.train", "--device", "cpu", "--policy",
               policy, "--clients", "4", "--rounds", "3", "--local-steps",
               "2", "--batch", "2", "--log", str(log))
    assert out.returncode == 0, out.stderr
    assert "arch=cifar-cnn family=cnn params=1,702,794 clients=4 T=2" in (
        out.stdout)
    assert "device=cpu" in out.stdout
    assert out.stdout.count("client-steps/s") >= 4
    assert "fused_agg kernel launches 0" in out.stdout
    history = json.loads(log.read_text())
    assert [h["round"] for h in history] == [0, 1, 2]
    for h in history:
        assert h["round_ms"] > 0 and h["client_steps_per_s"] > 0
    if policy == "wait_all":          # E_max = 8: rounds 1, 2 are no-ops
        assert [h["participants"] for h in history] == [4.0, 0.0, 0.0]


def test_train_cli_without_card_exits_nonzero_with_clear_message():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    out = _run("repro_torch.launch.train", "--rounds", "1")
    assert out.returncode == 1
    assert "torch.cuda.is_available() is False" in out.stderr
    assert "--device cpu" in out.stderr
    assert "client-steps/s" not in out.stdout


def test_train_cli_rejects_lm_arch():
    out = _run("repro_torch.launch.train", "--device", "cpu", "--arch",
               "granite-3-2b")
    assert out.returncode == 1
    assert "Queue 1 item 10" in out.stderr


def test_fig1_cli_runs_on_cpu(tmp_path):
    path = tmp_path / "fig1.json"
    out = _run("repro_torch.launch.fig1", "--device", "cpu", "--rounds", "2",
               "--clients", "4", "--batch", "2", "--policies",
               "sustainable,greedy", "--out", str(path))
    assert out.returncode == 0, out.stderr
    assert "== Algorithm 1: final acc" in out.stdout
    res = json.loads(path.read_text())["results"]
    assert set(res) == {"sustainable", "greedy"}
    for r in res.values():
        assert 0.0 <= r["final_acc"] <= 1.0 and r["rounds"] == [1]
