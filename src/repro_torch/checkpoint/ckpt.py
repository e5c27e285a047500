"""msgpack tree checkpointing: an atomic write and a validated read (port
of the JAX package's ``checkpoint/ckpt.py``).

The file contract is the reference's (DESIGN.md §13.1), and so is the
layout, so either package reads the other's files:

* `save_checkpoint` is atomic: the payload is written to a temp file in
  the target's directory and ``os.replace``d over the target, so a reader
  sees the complete previous checkpoint or the complete new one.  A failed
  write leaves no temp file behind.
* `load_checkpoint` returns a fully validated tree or raises
  `CheckpointError`: a truncated or corrupt file never yields a partial
  tree.  With ``like``, every leaf's dtype and shape must equal ``like``'s
  (a checkpoint of another configuration fails loudly, never cast).

A tree is nested dicts, lists and tuples with tensors, numpy arrays or
Python scalars at the leaves.  Leaves are stored in JAX's order (dict keys
sorted, ``None`` an empty node, not a leaf) as ``{"__np__": True, "dtype":
numpy's name, "shape": [...], "data": the raw little-endian bytes}``,
beside the ``structure`` nest with ``None`` at every leaf.  Loaded leaves
are CPU tensors built from the raw bytes (bfloat16 and uint32 included:
numpy is not asked to know them).  The ``treedef`` field holds the port's
own description of the nest; neither package's loader reads it.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack

PyTree = Any

_DTYPE_KEY = "__np__"
_DTYPES = {str(t).removeprefix("torch."): t for t in (
    torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32,
    torch.int64, torch.uint16, torch.uint32, torch.uint64, torch.float16,
    torch.bfloat16, torch.float32, torch.float64, torch.complex64,
    torch.complex128)}
# torch has no numpy view of bfloat16: its bytes travel as int16
_RAW_VIEW = {torch.bfloat16: torch.int16}


class CheckpointError(RuntimeError):
    """A checkpoint could not be read or does not match what the caller
    expects (truncated/corrupt bytes, wrong leaf count/dtype/shape)."""


def tree_flatten(tree: PyTree) -> list:
    """The leaves of ``tree`` in JAX's order: dict keys sorted, ``None`` an
    empty node."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_flatten(v)]
    return [tree]


def tree_unflatten(like: PyTree, leaves) -> PyTree:
    """``like``'s nest with its leaves replaced, in JAX's order, by
    ``leaves`` (an iterator); dicts keep ``like``'s key order."""
    if like is None:
        return None
    if isinstance(like, dict):
        vals = {k: tree_unflatten(like[k], leaves) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(tree_unflatten(v, leaves) for v in like)
    return next(leaves)


def tree_structure(tree: PyTree) -> PyTree:
    """``jax.tree.map(lambda _: None, tree)``: the nest with ``None`` at
    every leaf, dict keys sorted."""
    if isinstance(tree, dict):
        return {k: tree_structure(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_structure(v) for v in tree)
    return None


def _treedef(tree: PyTree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        return "(" + "".join(_treedef(v) + ", " for v in tree) + ")"
    return "None" if tree is None else "*"


def _meta(x) -> tuple[str, tuple]:
    """(numpy's dtype name, shape) of a leaf; a Python scalar as
    ``np.asarray`` types it."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch."), tuple(x.shape)
    arr = np.asarray(x)
    return str(arr.dtype), tuple(arr.shape)


def _pack_leaf(x) -> dict:
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        raw = t.view(_RAW_VIEW.get(t.dtype, t.dtype)).reshape(-1).numpy()
    else:
        raw = np.ascontiguousarray(np.asarray(x)).reshape(-1)
    dtype, shape = _meta(x)
    return {_DTYPE_KEY: True, "dtype": dtype, "shape": list(shape),
            "data": memoryview(raw.view(np.uint8))}


def _unpack_leaf(obj):
    if not (isinstance(obj, dict) and obj.get(_DTYPE_KEY)):
        return obj
    dtype, shape = _DTYPES[obj["dtype"]], [int(s) for s in obj["shape"]]
    data = obj["data"]
    if not len(data):
        return torch.empty(shape, dtype=dtype)
    if memoryview(data).readonly:
        data = bytearray(data)
    # a copy: the bytes sit at any offset of the file's buffer
    return torch.frombuffer(data, dtype=dtype).reshape(shape).clone()


def _as_tensor_leaf(x) -> torch.Tensor:
    """A leaf as the CPU tensor a load would return: the same dtype and
    bytes (a numpy bfloat16 array included)."""
    if isinstance(x, torch.Tensor):
        return x
    return _unpack_leaf(_pack_leaf(x))


def save_checkpoint(path: str, tree: PyTree, step: int = 0,
                    metadata: dict | None = None) -> None:
    """Atomic msgpack save of a tree of tensors, arrays and scalars."""
    payload = {
        "step": step,
        "metadata": metadata or {},
        "treedef": _treedef(tree_structure(tree)),
        "leaves": [_pack_leaf(x) for x in tree_flatten(tree)],
        "structure": tree_structure(tree),
    }
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            f.writelines(_msgpack.pack_chunks(payload))
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def validate_leaves(leaves: list, like: PyTree,
                    context: str = "checkpoint") -> PyTree:
    """Hang ``leaves`` on ``like``'s nest, raising `CheckpointError` on any
    leaf-count, dtype or shape mismatch.  This is the restore-side type
    guard: the file round-trips exact bytes, so anything that does not
    match ``like`` was written by another program, and casting it would
    corrupt the run."""
    ref_leaves = tree_flatten(like)
    if len(ref_leaves) != len(leaves):
        raise CheckpointError(
            f"{context} has {len(leaves)} leaves, expected "
            f"{len(ref_leaves)} (treedef {_treedef(tree_structure(like))})")
    out = []
    for i, (leaf, ref) in enumerate(zip(leaves, ref_leaves)):
        (dt, shape), (ref_dt, ref_shape) = _meta(leaf), _meta(ref)
        if dt != ref_dt or shape != ref_shape:
            raise CheckpointError(
                f"{context} leaf {i}: stored {dt}{shape}, expected "
                f"{ref_dt}{ref_shape} — refusing to cast (the checkpoint "
                f"was written by a different config)")
        out.append(_as_tensor_leaf(leaf))
    return tree_unflatten(like, iter(out))


def _structure_leaves(structure) -> int:
    if isinstance(structure, dict):
        return sum(_structure_leaves(v) for v in structure.values())
    if isinstance(structure, list):
        return sum(_structure_leaves(v) for v in structure)
    return 1


def _from_structure(structure, leaves):
    """The stored nest with ``None`` markers replaced, in JAX's order, by
    ``leaves`` (an iterator)."""
    if isinstance(structure, dict):
        vals = {k: _from_structure(structure[k], leaves)
                for k in sorted(structure)}
        return {k: vals[k] for k in structure}
    if isinstance(structure, list):
        return [_from_structure(v, leaves) for v in structure]
    return next(leaves)


def load_checkpoint(path: str, like: PyTree | None = None
                    ) -> tuple[PyTree, int, dict]:
    """Load a checkpoint: ``(tree, step, metadata)``.

    ``like`` gives the nest; every stored leaf must match the matching
    ``like`` leaf's dtype and shape exactly or `CheckpointError` is raised
    (never a silent cast).  Without ``like`` the stored nest of dicts and
    lists (tuples come back as lists) is rebuilt when its leaf count
    matches, else the flat leaf list is returned.  Truncated or corrupt
    bytes raise `CheckpointError`, never a partial tree.
    """
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    try:
        payload = _msgpack.unpackb(raw, bin_views=True)
        if not isinstance(payload, dict):
            raise TypeError(f"payload is {type(payload).__name__}, not dict")
        leaves = [_unpack_leaf(x) for x in payload["leaves"]]
        step, metadata = payload["step"], payload["metadata"]
    except CheckpointError:
        raise
    except Exception as e:
        raise CheckpointError(
            f"checkpoint {path} is truncated or corrupt: "
            f"{type(e).__name__}: {e}") from e
    if like is not None:
        return validate_leaves(leaves, like, context=path), step, metadata
    structure = payload.get("structure")
    if structure is not None and _structure_leaves(structure) == len(leaves):
        return _from_structure(structure, iter(leaves)), step, metadata
    return leaves, step, metadata
