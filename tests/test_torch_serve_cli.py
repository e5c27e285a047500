"""``python -m repro_torch.launch.serve``: runs on the CPU when asked, and
refuses to run without a card otherwise."""
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *args], capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=300)


@pytest.mark.parametrize("path", [[], ["--single-stream"]])
def test_cli_serves_on_cpu(path):
    out = _run("--device", "cpu", "--arch", "granite-3-2b", "--smoke",
               "--batch", "3", "--gen", "4", "--prompt-len", "9", *path)
    assert out.returncode == 0, out.stderr
    assert "arch=granite-3-2b batch=3 prompt=9 generated=4" in out.stdout
    assert "device=cpu" in out.stdout
    assert "tok/s (warm)" in out.stdout
    assert out.stdout.count("J/token") == 2      # analytic + measured
    assert "measured microbench on cpu" in out.stdout


def test_cli_without_card_exits_nonzero_with_clear_message():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    out = _run("--arch", "granite-3-2b", "--smoke")
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    out = _run("--smoke")                          # the default arch
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert "--device cpu" in out.stderr
    assert "tok/s" not in out.stdout


def test_cli_rejects_unported_family():
    out = _run("--device", "cpu", "--arch", "recurrentgemma-2b", "--smoke")
    assert out.returncode != 0
    assert "not ported yet" in out.stderr
    assert "Queue 1 item 20" in out.stderr


def test_cli_serves_mamba2_by_default_on_cpu():
    """The default architecture is the reference's, mamba2-1.3b: prompt
    length 32 takes the chunked scan (its plain version on the CPU, so no
    kernel launch), 9 the per-step recurrence."""
    for prompt_len in ("32", "9"):
        out = _run("--device", "cpu", "--smoke", "--batch", "3", "--gen",
                   "4", "--prompt-len", prompt_len)
        assert out.returncode == 0, out.stderr
        assert (f"arch=mamba2-1.3b batch=3 prompt={prompt_len} generated=4"
                in out.stdout)
        assert "device=cpu" in out.stdout
        assert "kernel launches (both passes): flash_attention 0, " \
               "ssd_scan 0" in out.stdout
        assert "measured microbench on cpu" in out.stdout
