"""Meshes of the port (port of the JAX package's ``launch/mesh.py``) and
the H100 constants the dry run's roofline prices against.

* ``PRODUCTION_TOPOLOGY`` — the reference's production layouts, axis by
  axis: 16 x 16 ("data", "model") and 2 x 16 x 16 ("pod", "data",
  "model").  They are layouts only: the specs of `dist.sharding` are held
  against the reference's on them (``production_spec_mesh``).
* ``SpecMesh`` — a device-free mesh (axis name -> size) that the spec
  functions read.
* ``make_local_mesh`` — a ``DeviceMesh`` ("data", "model") over the ranks
  of the process group there is, or ``None`` for a single process: the
  card alone, a 1 x 1 layout.
* ``make_production_mesh`` — the production layout as a ``DeviceMesh``;
  it raises unless the world holds that many ranks.

The rates below are NVIDIA's published data-sheet figures for one H100
SXM at its 700 W limit (spec values, not measurements of this port):
dense bf16 tensor-core FLOP/s, HBM bytes/s, and NVLink bytes/s in each
direction.
"""
from __future__ import annotations

import torch.distributed as dist

# the reference's production layouts, axis name -> size
PRODUCTION_TOPOLOGY = {
    False: {"data": 16, "model": 16},                # 16 x 16 = 256
    True: {"pod": 2, "data": 16, "model": 16},       # 2 x 16 x 16 = 512
}

# H100 SXM data-sheet rates (spec, per card, 700 W)
PEAK_FLOPS_BF16 = 989e12     # FLOP/s, dense bf16 on the tensor cores
PEAK_FLOPS_FP32 = 67e12      # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12             # B/s
NVLINK_BW = 450e9            # B/s, each direction


class SpecMesh:
    """A device-free mesh: axis name -> size.  `dist.sharding`'s spec
    functions read only ``shape`` and ``axis_names``, so a layout can be
    computed and checked on a machine without its ranks."""

    def __init__(self, shape: dict[str, int]):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)

    def __repr__(self) -> str:
        return f"SpecMesh({self.shape})"


def production_spec_mesh(*, multi_pod: bool = False) -> SpecMesh:
    """The production layout as a ``SpecMesh`` (no ranks needed)."""
    return SpecMesh(PRODUCTION_TOPOLOGY[multi_pod])


def card_spec_mesh() -> SpecMesh:
    """The card alone: a 1 x 1 ("data", "model") layout."""
    return SpecMesh({"data": 1, "model": 1})


def _device_mesh(device_type: str, sizes: dict[str, int]):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(sizes.values()),
                            mesh_dim_names=tuple(sizes))


def make_local_mesh(model: int = 1, device_type: str = "cuda"):
    """A ``DeviceMesh`` ("data", "model") over every rank of the default
    process group, ``model`` ranks a model group; ``None`` without an
    initialised group of more than one rank (the card alone)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    world = dist.get_world_size()
    if model < 1 or world % model:
        raise ValueError(f"model={model} does not divide the world of "
                         f"{world} ranks")
    return _device_mesh(device_type, {"data": world // model,
                                      "model": model})


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production layout as a ``DeviceMesh``; raises unless the
    default process group holds exactly that many ranks."""
    sizes = PRODUCTION_TOPOLOGY[multi_pod]
    need = 1
    for n in sizes.values():
        need *= n
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        raise RuntimeError(f"the production mesh {sizes} needs {need} "
                           f"ranks; the process group holds {have}")
    return _device_mesh(device_type, sizes)
