"""The fleet's client axis sharded over ranks (port of the fleet part of
the JAX package's ``dist/sharding.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh``: one process a
rank, each holding its slab of clients on its own device.  (The
reference's mesh is one process over many devices; it has no counterpart
here.)  The client axis is sharded over every dim of the mesh but
``"model"`` (`data_axes`), flattened in mesh order on a mesh with
several, and every other leaf of a fleet tree is replicated: the
reference's ``fleet_spec`` / ``fleet_specs``.  The caller pads the fleet
to a multiple of the data-axis product (`energy.fleet.simulate_fleet`);
a width that does not divide raises, and nothing falls back to
replication.

Rank r of the data group holds clients ``[r * n_local, (r + 1) *
n_local)`` (`slab`), and `gather_clients` puts the slabs back together in
that order.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.energy.arrivals import map_clients

PyTree = Any

MODEL_AXIS = "model"


def check_mesh(mesh) -> DeviceMesh:
    """``mesh`` if it is a named ``DeviceMesh``; raises ValueError
    otherwise."""
    if not isinstance(mesh, DeviceMesh):
        raise ValueError(f"mesh must be a torch.distributed.device_mesh."
                         f"DeviceMesh (one process a rank), got "
                         f"{type(mesh).__name__}")
    if mesh.mesh_dim_names is None:
        raise ValueError("mesh needs mesh_dim_names: the client axis is "
                         "sharded over every dim but 'model'")
    return mesh


def data_axes(mesh) -> tuple[str, ...]:
    """Every dim name of the mesh but ``"model"``, in mesh order."""
    names = check_mesh(mesh).mesh_dim_names
    axes = tuple(a for a in names if a != MODEL_AXIS)
    if not axes:
        raise ValueError(f"mesh {names} has no data axis to shard the "
                         f"client axis over")
    return axes


def mesh_axis_size(mesh, axes) -> int:
    """Product of the named mesh dims' sizes (a name, None or a
    sequence)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    names = check_mesh(mesh).mesh_dim_names
    n = 1
    for a in axes:
        n *= mesh.size(names.index(a))
    return n


def data_group(mesh):
    """The process group over the mesh's data axes (``(pod, data)``
    flattened on a mesh with both; the mesh keeps the flattened group it
    makes the first time): the ranks that hold the slabs of one fleet."""
    axes = data_axes(mesh)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def slab(n_pad: int, mesh) -> tuple[int, int]:
    """``(first, n_local)``: the clients of a padded fleet of ``n_pad`` that
    this rank holds.  Raises where ``n_pad`` does not divide the data-axis
    product."""
    world = mesh_axis_size(mesh, data_axes(mesh))
    if n_pad % world:
        raise ValueError(f"the padded fleet width {n_pad} does not divide "
                         f"the mesh's data-axis product {world}; pad it "
                         f"to a multiple (simulate_fleet does)")
    n_local = n_pad // world
    return dist.get_rank(data_group(mesh)) * n_local, n_local


def shard_fleet(tree: PyTree, n_pad: int, mesh, device) -> PyTree:
    """A fleet tree on this rank: every tensor with a leading client dim of
    ``n_pad`` sliced to the rank's slab, every other one (and a replay's
    table, whatever its shape: `map_clients`) replicated; all moved to
    ``device``."""
    first, n_local = slab(n_pad, mesh)

    def leaf(x):
        if x.dim() and x.shape[0] == n_pad:
            x = x[first:first + n_local]
        return x.to(device)

    return map_clients(tree, leaf, lambda x: x.to(device))


def gather_clients(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """The whole fleet's tensor from every rank's slab along ``dim``, on
    every rank, on ``x``'s device.  Through host memory unless the group
    is NCCL's (gloo's all-gather may not take CUDA tensors)."""
    group = data_group(mesh)
    world = dist.get_world_size(group)
    if world == 1:
        return x
    on_card = dist.get_backend(group) == "nccl"
    src = (x if on_card else x.cpu()).contiguous()
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def gather_fleet(tree: PyTree, n_local: int, mesh) -> PyTree:
    """`gather_clients` on every tensor of a fleet tree whose leading dim
    is the slab's ``n_local``; other leaves are kept."""
    return map_clients(tree, lambda x: gather_clients(x, mesh)
                       if x.dim() and x.shape[0] == n_local else x)


def check_device(mesh, device: torch.device) -> None:
    """Raise unless the mesh's device type is the fleet's."""
    if check_mesh(mesh).device_type != device.type:
        raise ValueError(f"the mesh is on {mesh.device_type!r}, the fleet on "
                         f"{device.type!r}: pass device= to match the mesh")


def mesh_from_env(device: str = "cuda", timeout_s: float = 600.0):
    """``(mesh, device)`` for a launcher.  Under ``torchrun`` (``WORLD_SIZE``
    above 1 in the environment) it initialises the default process group
    from the environment (NCCL for ``"cuda"``, each rank on
    ``cuda:LOCAL_RANK``; gloo for ``"cpu"``), with ``timeout_s`` on every
    collective, and returns a one-dimensional ``("data",)`` mesh over all
    ranks.  Otherwise it returns ``(None, device)`` and touches nothing."""
    import datetime
    import os

    world = int(os.environ.get("WORLD_SIZE", "1"))
    dev = torch.device(device)
    if world <= 1:
        return None, dev
    from torch.distributed.device_mesh import init_device_mesh

    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            timeout=datetime.timedelta(seconds=timeout_s))
    return init_device_mesh(dev.type, (world,),
                            mesh_dim_names=("data",)), dev


def is_lead(mesh) -> bool:
    """True on the rank that prints: rank 0, or the only process."""
    return mesh is None or dist.get_rank() == 0
