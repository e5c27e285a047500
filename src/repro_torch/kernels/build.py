"""Build the port's CUDA kernels at first use: ``nvcc`` -> shared library with
a plain C interface -> ``ctypes``.

Every library is compiled from the sources under ``kernels/csrc`` only, for
``sm_90a`` (Hopper; ``wgmma``/``setmaxnreg`` need the ``a``), into
``kernels/_build/<name>-<hash>/`` where the hash covers the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or header
is rebuilt and an unchanged one is reused.  That
directory is listed in ``.gitignore``.  Nothing here runs at import time:
the CPU tests import every module, and this machine may have no ``nvcc``.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or the default
    toolkit location.  Raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels are built on the machine with the "
                       "card")


def library_path(name: str) -> Path:
    """Where library ``name`` (from ``csrc/<name>.cu``) lives once built,
    keyed on a hash of its source, the shared headers and the compiler
    flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build(name: str) -> float | None:
    """Compile ``csrc/<name>.cu`` unless it is built already; returns the
    seconds ``nvcc`` took, or None if nothing was compiled.  Raises with the
    compiler's output if the build fails.  The ``-Xptxas -v`` report
    (registers, shared memory, spills) is kept beside the library as
    ``ptxas.log``."""
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(CSRC / f"{name}.cu")],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA kernel build failed: nvcc {name} (exit "
                           f"{proc.returncode})\n{log}")
    (out.parent / "ptxas.log").write_text(log)
    os.replace(tmp, out)            # atomic: a reader never sees a part
    return time.perf_counter() - t0


def build_all(names) -> dict:
    """Build several libraries at once, one ``nvcc`` process each, all
    started together; returns {name: seconds or None} as ``build``."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        futures = {name: pool.submit(build, name) for name in names}
        return {name: f.result() for name, f in futures.items()}


def ptxas_log(name: str) -> str:
    log = library_path(name).parent / "ptxas.log"
    return log.read_text() if log.exists() else ""


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, building it first if needed."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))
