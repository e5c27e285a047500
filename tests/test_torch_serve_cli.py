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


def _generated(arch, batch, prompt_len, gen, seed=0):
    """Row 0 of the launcher's workload through the single-stream
    `generate`, in process: the same seeded params and prompts."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import (_decode_shape, _make_prompt,
                                          generate, seeded_generators)
    from repro_torch.models import get_model
    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    g_params, g_prompt, _ = seeded_generators(seed, torch.device("cpu"))
    params = model.init_params(g_params)
    prompt = _make_prompt(cfg, g_prompt, batch, prompt_len)
    cache_len, ring, window = _decode_shape(cfg, prompt_len, gen)
    return generate(model, params, prompt, gen, cache_len, ring=ring,
                    window=window, device="cpu")[0].numpy()


def test_cli_rejects_unported_family():
    """recurrentgemma-2b (family ``hybrid``, unported until ROADMAP.md
    Queue 1 item 20b) now serves: prompts of 40 tokens past its smoke
    config's 32-token local window, through the engine's ring cache; row
    0's tokens equal the single-stream `generate`'s, and the measured
    microbenchmark runs."""
    out = _run("--device", "cpu", "--arch", "recurrentgemma-2b", "--smoke",
               "--batch", "3", "--gen", "6", "--prompt-len", "40")
    assert out.returncode == 0, out.stderr
    assert ("arch=recurrentgemma-2b batch=3 prompt=40 generated=6"
            in out.stdout)
    assert "kernel launches (both passes): flash_attention 0" in out.stdout
    assert "measured microbench on cpu" in out.stdout
    want = _generated("recurrentgemma-2b", 3, 40, 6)
    assert f"tokens[0]: {want}" in out.stdout


def test_cli_serves_whisper_on_cpu():
    """whisper-tiny (family ``encdec``): each prompt carries its frames
    through ``Request.extras``; row 0's tokens equal the single-stream
    `generate`'s, and the measured microbenchmark runs."""
    out = _run("--device", "cpu", "--arch", "whisper-tiny", "--smoke",
               "--batch", "3", "--gen", "6", "--prompt-len", "12")
    assert out.returncode == 0, out.stderr
    assert "arch=whisper-tiny batch=3 prompt=12 generated=6" in out.stdout
    assert "kernel launches (both passes): flash_attention 0" in out.stdout
    assert "measured microbench on cpu" in out.stdout
    want = _generated("whisper-tiny", 3, 12, 6)
    assert f"tokens[0]: {want}" in out.stdout


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b",
                                  "internvl2-76b"])
def test_cli_serves_moe_and_vlm_on_cpu(arch):
    """The MoE family (mixtral with its ring cache: prompts past the
    smoke config's 64-token window) and the VLM backbone, whose prompts
    carry vision embeddings through ``Request.extras``."""
    plen = "70" if arch == "mixtral-8x7b" else "12"
    out = _run("--device", "cpu", "--arch", arch, "--smoke", "--batch", "3",
               "--gen", "4", "--prompt-len", plen, "--skip-microbench")
    assert out.returncode == 0, out.stderr
    assert f"arch={arch} batch=3 prompt={plen} generated=4" in out.stdout
    assert "kernel launches (both passes): flash_attention 0" in out.stdout


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
