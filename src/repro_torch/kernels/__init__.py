"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.

<name>.py = the kernel's wrapper + its plain version; csrc/<name>.cu = the
CUDA source; build.py = nvcc -> shared library -> ctypes at first use;
ops.py = device dispatch; ref.py = naive oracles.  Nothing is built when a
module is imported.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
