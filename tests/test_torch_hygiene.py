"""The port stands alone: no module of ``repro_torch`` and nothing in
``chip_smoke.py`` or ``probes/`` imports JAX, the JAX package or msgpack
(the machine with the card has no msgpack: the port carries its own
codec), and the package calls no library attention or aggregation
kernel."""
import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack")


def _port_files(ext=(".py",)):
    out = []
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(ext)]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            # module names handed to importlib (e.g. the config registry)
            name = node.value.split(".")[0]
            if name in FORBIDDEN and node.value.replace(".", "").isidentifier():
                roots.add(name)
    return roots


def test_package_has_modules():
    names = {os.path.relpath(p, PKG) for p in _port_files((".py", ".cu"))}
    for need in ("device.py", "convert.py", "kernels/flash_attention.py",
                 "kernels/build.py", "models/transformer.py",
                 "serve/engine.py", "launch/serve.py", "prng.py",
                 "kernels/fused_agg.py", "models/cnn.py",
                 "core/scheduling.py", "core/aggregation.py",
                 "core/round.py", "core/simulate.py", "optim/optimizers.py",
                 "data/synthetic.py", "launch/train.py", "launch/fig1.py",
                 "obs/hist.py", "dist/collectives.py", "dist/sharding.py",
                 "energy/battery.py",
                 "energy/arrivals.py", "energy/costs.py",
                 "energy/step_ops.py", "energy/fleet.py",
                 "kernels/fleet_step.py", "launch/fleet.py",
                 "serve/qos.py", "serve/admission.py", "serve/traffic.py",
                 "serve/fleet_serve.py", "energy/control.py",
                 "kernels/csrc/serve_step.cu", "launch/serve_fleet.py",
                 "models/ssm.py", "kernels/ssd_scan.py",
                 "kernels/csrc/ssd_scan.cu", "models/moe.py",
                 "launch/quickstart.py", "models/rglru.py",
                 "models/encdec.py", "launch/serve_decode.py",
                 "traces/profiles.py", "traces/replay.py", "traces/fit.py",
                 "obs/events.py", "obs/metrics.py", "obs/profile.py",
                 "obs/report.py", "launch/scenario.py",
                 "launch/trace_fleet.py", "checkpoint/_msgpack.py",
                 "checkpoint/ckpt.py", "checkpoint/resume.py",
                 "launch/battery_control.py", "launch/train_100m.py",
                 "launch/noniid_ablation.py", "launch/steps.py",
                 "launch/dryrun.py", "launch/mesh.py", "models/remat.py"):
        assert need in names


def _probe_files():
    d = os.path.join(REPO, "probes")
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith(".py"))


@pytest.mark.parametrize("path", _port_files() + [
    os.path.join(REPO, "chip_smoke.py")] + _probe_files(),
    ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path} imports {sorted(bad)}"


def test_package_calls_no_library_attention():
    for path in _port_files():
        assert "scaled_dot_product_attention" not in open(path).read(), path


def test_package_calls_no_library_aggregation():
    """The server's aggregation runs on the port's own ``fused_agg``
    kernel; ``chip_smoke.py`` times ``torch.addmv`` as its yardstick only."""
    for path in _port_files():
        assert "addmv" not in open(path).read(), path


def test_dryrun_cli_record_reads_in_both_packages(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on the 16 x 16 layout
    (whisper-tiny, train_4k, one local step) writes a record that the
    port's and the JAX package's ``from_dryrun`` read alike."""
    import dataclasses
    import json
    import subprocess
    import sys

    from repro.energy import costs as jcosts
    from repro_torch.energy import costs as tcosts

    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "train_4k", "--mesh", "single",
         "--local-steps", "1", "--device", "cpu", "--no-calibrate",
         "--out", str(tmp_path)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OK   whisper-tiny__train_4k__single" in proc.stdout
    rec = json.load(open(tmp_path / "whisper-tiny__train_4k__single.json"))
    assert rec["partitioned"] is False and rec["multi_pod"] is False
    assert rec["mesh"] == "16x16 (data,model)"
    assert rec["step_meta"]["client_groups"] == 16
    assert rec["memory"]["argument_bytes_per_device"] > 0
    ours, theirs = tcosts.from_dryrun(rec, 1), jcosts.from_dryrun(rec, 1)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.joules_per_step > 0
