"""Sharding rules and placement (port of the JAX package's
``dist/sharding.py``): the model half (parameters, batches, caches, the
client-stacked state of a parallel round) and the fleet half (the fleet's
client axis over ranks).

**Meshes.**  The spec functions read only axis names and sizes, so they
take any mesh-shaped object: a ``launch.mesh.SpecMesh`` (axis name ->
size, no ranks) or a ``torch.distributed.device_mesh.DeviceMesh`` (read
through ``mesh_dim_names`` and ``size``).  The fleet functions and the
placement side need a ``DeviceMesh``: one process a rank.  The ``model``
axis is tensor parallelism; every other axis (``data``, and ``pod`` ahead
of it) is data / client parallelism, reported by `data_axes` in mesh
order.

**Specs** (the reference's rules, unchanged).  A spec is a `P`: one entry
a tensor dim, each ``None``, an axis name or a tuple of names
(major-to-minor).  A mesh axis is placed on a dim only if its size divides
the dim; otherwise the rule falls through to the next candidate and
finally to replication.  FSDP prepends the data axes onto the first free
divisible dim, or onto the model-sharded dim (``fsdp + (model,)``).

**Placement** (the reference's ``NamedSharding`` side, on
``torch.distributed.tensor``): `placements` turns a spec into one
``Shard(d)`` / ``Replicate()`` a mesh dim; several axes on one tensor dim
must come in mesh order, which is DTensor's major-to-minor order.
`shard_tree` / `redistribute_tree` / `gather_tree` place a step's
inputs, its outputs, and gather a tree (`launch.steps.execute`);
`stacked_constrainer` redistributes a parallel round's stacked state
(the identity on plain tensors).

**Fleets.**  The client axis is sharded over every dim of the mesh but
``"model"``, flattened in mesh order on a mesh with several, and every
other leaf of a fleet tree is replicated: the reference's ``fleet_spec``
/ ``fleet_specs``.  The caller pads the fleet to a multiple of the
data-axis product (`energy.fleet.simulate_fleet`); a width that does not
divide raises, and nothing falls back to replication.  Rank r of the data
group holds clients ``[r * n_local, (r + 1) * n_local)`` (`slab`), and
`gather_clients` puts the slabs back together in that order.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.energy.arrivals import map_clients
from repro_torch.tree import tree_map, tree_map_with_path

PyTree = Any

MODEL_AXIS = "model"


class P:
    """A partition spec: one entry a tensor dim, each ``None`` (replicated),
    an axis name or a tuple of names (major-to-minor), as the reference's
    ``PartitionSpec``.  A leaf of spec trees (not a container)."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


# ------------------------------------------------------------- mesh intro --
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


def axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or of a mesh-shaped object
    with a ``shape`` dict and ``axis_names`` (``launch.mesh.SpecMesh``);
    raises ValueError for anything else."""
    if isinstance(mesh, DeviceMesh):
        names = check_mesh(mesh).mesh_dim_names
        return {a: mesh.size(i) for i, a in enumerate(names)}
    shape = getattr(mesh, "shape", None)
    names = getattr(mesh, "axis_names", None)
    if not isinstance(shape, dict) or names is None:
        raise ValueError(f"mesh must be a torch.distributed.device_mesh."
                         f"DeviceMesh or a SpecMesh (axis name -> size), "
                         f"got {type(mesh).__name__}")
    return {a: int(shape[a]) for a in names}


def data_axes(mesh) -> tuple[str, ...]:
    """Every axis of the mesh but ``"model"``, in mesh order."""
    return tuple(a for a in axis_sizes(mesh) if a != MODEL_AXIS)


def mesh_axis_size(mesh, axes) -> int:
    """Product of the named mesh axes' sizes (a name, None or a
    sequence)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _divides(dim: int, mesh, axes) -> bool:
    n = mesh_axis_size(mesh, axes)
    return n > 0 and dim % n == 0


def _progressive_data(dim: int, mesh, daxes: Sequence[str]):
    """Largest suffix of the data axes whose product divides ``dim``
    (dropping leading axes first: a batch that fits one pod's data axis
    still shards there on a multi-pod mesh)."""
    for k in range(len(daxes)):
        cand = tuple(daxes[k:])
        if dim and _divides(dim, mesh, cand):
            return cand if len(cand) > 1 else cand[0]
    return None


# ------------------------------------------------------------ param rules --
# Leaf names that are always replicated: norm scales/biases, projection
# biases, per-head scalar vectors (A_log, D, dt_bias, lambda).
_REPLICATED = {
    "scale", "bias", "norm", "lam",
    "b", "bq", "bk", "bv", "bi", "bo", "ba", "conv_b",
    "a_log", "d", "dt_bias",
}

# name -> (core rank, candidate core dims for the model axis, by
# preference).  Dims left of the core rank are leading stack axes (layers /
# blocks), never sharded over the model axis.  Projections that produce the
# hidden features shard their output dim (column-parallel), those that
# consume them (wo / out_proj) their input dim (row-parallel).
_MATRIX_RULES = {
    "wq": (2, (1, 0)),
    "wk": (2, (1, 0)),
    "wv": (2, (1, 0)),
    "wi": (2, (1, 0)),
    "wx": (2, (1, 0)),
    "wy": (2, (1, 0)),
    "wa": (2, (1, 0)),
    "w": (2, (1, 0)),
    "in_proj": (2, (1, 0)),
    "router": (2, (1, 0)),
    "wo": (2, (0, 1)),
    "out_proj": (2, (0, 1)),
    "conv_w": (2, (0,)),          # depthwise conv: channels only, never taps
    # embeddings: vocab-parallel when the vocab divides, d_model otherwise
    "tok": (2, (0, 1)),
    "pos": (2, (0, 1)),
    "unembed": (2, (1, 0)),       # output side: padded vocab dim first
}

# MoE experts under a "moe" parent: expert-parallel when E divides the
# model axis, otherwise the ff dim.
_MOE_RULES = {
    "wi": (3, (0, 2, 1)),         # (E, d_model, ff*)
    "wo": (3, (0, 1, 2)),         # (E, ff, d_model)
}


def _param_spec(path, shape, mesh, model_axis=MODEL_AXIS,
                fsdp_axes: Sequence[str] = ()) -> P:
    """The spec of one parameter leaf.  ``path``: the tree's key names
    (e.g. ``("layers", "attn", "wq")``); ``model_axis``: the tensor-parallel
    axis (None: weights replicated over it, dp mode); ``fsdp_axes``: data
    axes to shard every weight over as well (ZeRO-3), as a prepended tuple
    on the first free divisible dim."""
    names = tuple(str(n).lower() for n in path)
    name = names[-1] if names else ""
    ndim = len(shape)
    entries: list = [None] * ndim

    if name not in _REPLICATED:
        if "moe" in names and name in _MOE_RULES:
            core_rank, candidates = _MOE_RULES[name]
        elif name in _MATRIX_RULES:
            core_rank, candidates = _MATRIX_RULES[name]
        else:
            # unknown leaf: try dims from the last (feature) dim backwards
            core_rank, candidates = ndim, tuple(range(ndim - 1, -1, -1))
        lead = max(ndim - core_rank, 0)

        if model_axis is not None:
            for c in candidates:
                dim = lead + c
                if dim < ndim and shape[dim] > 1 \
                        and _divides(shape[dim], mesh, model_axis):
                    entries[dim] = model_axis
                    break

        if fsdp_axes:
            fsdp = tuple(fsdp_axes)
            placed = False
            for dim in range(lead, ndim):
                if entries[dim] is None and shape[dim] > 1 \
                        and _divides(shape[dim], mesh, fsdp):
                    entries[dim] = fsdp
                    placed = True
                    break
            if not placed:
                # compose: prepend the data axes onto the model-sharded dim
                for dim in range(lead, ndim):
                    if entries[dim] == model_axis and _divides(
                            shape[dim], mesh, fsdp + (model_axis,)):
                        entries[dim] = fsdp + (model_axis,)
                        break

    return P(*entries)


def param_specs(params: PyTree, mesh, model_axis=MODEL_AXIS,
                fsdp: bool = False) -> PyTree:
    """The spec tree of a parameter (or optimizer-state) tree of tensors
    (real or fake); with ``fsdp=True`` every weight is sharded over the
    mesh's data axes as well (sequential mode: one client owns the
    mesh)."""
    fsdp_axes = data_axes(mesh) if fsdp else ()
    return tree_map_with_path(
        lambda path, x: _param_spec(path, tuple(x.shape), mesh,
                                    model_axis=model_axis,
                                    fsdp_axes=fsdp_axes), params)


# ------------------------------------------------------- batches & caches --
def batch_spec(mesh, ndim: int, batch_dim: int, batch_size: int) -> P:
    """A model input's spec: the batch dim over the data axes where they
    divide it, falling back through suffixes of the data axes to
    replication (e.g. the batch-1 long-context decode)."""
    entries: list = [None] * ndim
    if 0 <= batch_dim < ndim:
        entries[batch_dim] = _progressive_data(batch_size, mesh,
                                               data_axes(mesh))
    return P(*entries)


def cache_specs(cache: PyTree, mesh) -> PyTree:
    """Specs of a serving cache, leaves (L, B, S, heads, head_dim) or
    (L, B, *state): the batch (dim 1) over the data axes; the sequence
    never sharded (ring writes are position-local); the model axis on the
    kv-head dim when it divides, else the trailing feature dim."""
    daxes = data_axes(mesh)

    def spec(x):
        shape = tuple(x.shape)
        nd = len(shape)
        entries: list = [None] * nd
        if nd >= 2:
            entries[1] = _progressive_data(shape[1], mesh, daxes)
        for dim in (nd - 2, nd - 1):
            if dim >= 2 and entries[dim] is None and shape[dim] > 1 \
                    and _divides(shape[dim], mesh, MODEL_AXIS):
                entries[dim] = MODEL_AXIS
                break
        return P(*entries)

    return tree_map(spec, cache)


# ------------------------------------------------- stacked (parallel) mode --
def stacked_specs(tree: PyTree, mesh, model_axis=MODEL_AXIS,
                  zero_axis=None) -> PyTree:
    """The specs that `stacked_constrainer` pins on a tree whose leaves
    carry a leading client axis C (a parallel round's stacked local models
    and optimizer moments): ``P(data axes, *the leaf's param rule)``; with
    ``zero_axis`` (ZeRO-1, dp mode) the last free dim that it divides goes
    over it too.  Scalar leaves (step counters) get ``P()``."""
    daxes = data_axes(mesh)
    lead = daxes if len(daxes) > 1 else daxes[0]

    def leaf(path, x):
        if x.dim() == 0:
            return P()
        spec = _param_spec(path, tuple(x.shape)[1:], mesh,
                           model_axis=model_axis)
        entries = [lead] + list(spec)
        if zero_axis is not None:
            for dim in range(x.dim() - 1, 0, -1):
                if entries[dim] is None and x.shape[dim] > 1 \
                        and _divides(x.shape[dim], mesh, zero_axis):
                    entries[dim] = zero_axis
                    break
        return P(*entries)

    return tree_map_with_path(leaf, tree)


def stacked_constrainer(mesh, model_axis=MODEL_AXIS, zero_axis=None):
    """``constrain(tree)`` for `core.round.parallel_round`: each DTensor
    leaf redistributed to its `stacked_specs` placement on ``mesh`` (a
    ``DeviceMesh``); plain tensors, and every leaf where ``mesh`` is
    None, pass through unchanged."""
    if mesh is None:
        return lambda tree: tree
    from torch.distributed.tensor import DTensor

    def constrain(tree: PyTree) -> PyTree:
        specs = stacked_specs(tree, mesh, model_axis=model_axis,
                              zero_axis=zero_axis)
        return tree_map(
            lambda x, spec: x.redistribute(mesh, placements(spec, mesh))
            if isinstance(x, DTensor) else x, tree, specs)

    return constrain


# --------------------------------------------------------------- placement --
def placements(spec: P, mesh) -> list:
    """One ``Shard(d)`` / ``Replicate()`` a dim of ``mesh`` (a
    ``DeviceMesh``) for ``spec``; an axis of size 1 is ``Replicate()``,
    which holds the same slice and keeps DTensor's sharding propagation
    to the axes that split.  Several axes on one tensor dim must be
    named in mesh order: DTensor splits such a dim over its mesh dims
    major-to-minor in mesh order, which is the reference's tuple order."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = axis_sizes(mesh)
    names = list(sizes)
    out: list = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        where = [names.index(a) for a in axes]
        if where != sorted(where):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in mesh order {tuple(names)}")
        for i in where:
            if sizes[names[i]] > 1:      # one rank's "shard" is the whole dim
                out[i] = Shard(d)
    return out


def shard_tree(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """Each tensor leaf distributed over ``mesh`` by its spec (the same
    full tensor on every rank in; a DTensor holding this rank's slice out,
    cut from the rank's own copy with no collective); leaves that are not
    tensors (a round index, a step offset) pass through."""
    from torch.distributed.tensor import distribute_tensor

    return tree_map(lambda x, spec: distribute_tensor(
        x, mesh, placements(spec, mesh), src_data_rank=None)
        if isinstance(x, torch.Tensor) else x, tree, specs)


def redistribute_tree(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """Each tensor leaf as a DTensor on ``mesh`` at its spec's placement: a
    DTensor redistributed, a plain tensor (the same on every rank: a step
    computed it from replicated inputs) taken as replicated first;
    other leaves as they are.  The outputs' side of `shard_tree`."""
    from torch.distributed.tensor import DTensor, Replicate

    def leaf(x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return x.redistribute(mesh, placements(spec, mesh))

    return tree_map(leaf, tree, specs)


def gather_tree(tree: PyTree) -> PyTree:
    """Each DTensor leaf as its full tensor on every rank; other leaves as
    they are."""
    from torch.distributed.tensor import DTensor

    return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor)
                    else x, tree)


# ------------------------------------------------------------ fleet state --
def fleet_spec(mesh, ndim: int = 1) -> P:
    """A fleet-state leaf's spec: the client dim 0 over every data axis
    (``(pod, data)`` on a multi-pod mesh), every trailing dim replicated.
    The caller pads N to a multiple of the data-axis product."""
    daxes = data_axes(mesh)
    lead = daxes if len(daxes) > 1 else daxes[0]
    return P(lead, *([None] * (ndim - 1)))


def fleet_specs(tree: PyTree, num_clients: int, mesh) -> PyTree:
    """Spec tree of a fleet tree: leaves with a leading client dim of
    ``num_clients`` get `fleet_spec`, every other leaf ``P()``."""
    def leaf(x):
        shape = tuple(getattr(x, "shape", ()))
        if shape and shape[0] == num_clients:
            return fleet_spec(mesh, len(shape))
        return P()

    return tree_map(leaf, tree)


def _fleet_axes(mesh) -> tuple[str, ...]:
    """The data axes of a fleet's ``DeviceMesh``; raises where ``mesh`` is
    no ``DeviceMesh`` or has no data axis."""
    axes = data_axes(check_mesh(mesh))
    if not axes:
        raise ValueError(f"mesh {mesh.mesh_dim_names} has no data axis to "
                         f"shard the client axis over")
    return axes


def data_group(mesh):
    """The process group over the mesh's data axes (``(pod, data)``
    flattened on a mesh with both; the mesh keeps the flattened group it
    makes the first time): the ranks that hold the slabs of one fleet."""
    axes = _fleet_axes(mesh)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def slab(n_pad: int, mesh) -> tuple[int, int]:
    """``(first, n_local)``: the clients of a padded fleet of ``n_pad`` that
    this rank holds.  Raises where ``n_pad`` does not divide the data-axis
    product."""
    world = mesh_axis_size(mesh, _fleet_axes(mesh))
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
