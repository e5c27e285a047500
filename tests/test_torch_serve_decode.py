"""``python -m repro_torch.launch.serve_decode``: the five families' smoke
configs through `generate` with the reference's cache shapes, then the
staggered engine, token-identical to single-stream, on the CPU."""
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
    return subprocess.run([sys.executable, "-m",
                           "repro_torch.launch.serve_decode", *args],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=300)


def test_serve_decode_runs_every_family_and_the_engine_on_cpu():
    out = _run("--device", "cpu")
    assert out.returncode == 0, out.stderr
    for arch, family, shape in (
            ("mamba2-1.3b", "ssm", "cache_len=33 ring=False"),
            ("granite-3-2b", "dense", "cache_len=33 ring=False"),
            ("mixtral-8x7b", "moe", "cache_len=64 ring=True"),
            ("recurrentgemma-2b", "hybrid", "cache_len=32 ring=True"),
            ("whisper-tiny", "encdec", "cache_len=33 ring=False")):
        assert f"{arch:20s} [{family:7s}] {shape} generated" in out.stdout
    assert "engine[mamba2-1.3b] slots=3, 5 staggered requests" in out.stdout
    assert out.stdout.count("== single-stream") == 5
    assert "MISMATCH" not in out.stdout


def test_serve_decode_without_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    out = _run()
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
