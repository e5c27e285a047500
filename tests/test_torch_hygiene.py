"""The port stands alone: no module of ``repro_torch`` and nothing in
``chip_smoke.py`` or ``probes/`` imports JAX or the JAX package, and the package calls no
library attention or aggregation kernel."""
import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")


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
                 "launch/quickstart.py"):
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
