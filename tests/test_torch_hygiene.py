"""The port stands alone: no module of ``repro_torch`` and nothing in
``chip_smoke.py`` imports JAX or the JAX package, and the package calls no
library attention kernel."""
import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    out = []
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
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
    names = {os.path.relpath(p, PKG) for p in _port_files()}
    for need in ("device.py", "convert.py", "kernels/flash_attention.py",
                 "kernels/build.py", "models/transformer.py",
                 "serve/engine.py", "launch/serve.py"):
        assert need in names


@pytest.mark.parametrize("path", _port_files() + [
    os.path.join(REPO, "chip_smoke.py")],
    ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path} imports {sorted(bad)}"


def test_package_calls_no_library_attention():
    for path in _port_files():
        assert "scaled_dot_product_attention" not in open(path).read(), path
