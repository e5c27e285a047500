"""Streaming run-event log and run manifests (port of the JAX package's
``obs/events.py``).

Every observable run appends newline-delimited JSON events to
``<out_dir>/events.jsonl`` through an `EventLog`.  The first event of a run
is its `RunManifest` (config hash, seed, mesh shape, device, package
versions, git revision), so every artifact downstream is attributable to
the program that produced it.  Events are flushed a line at a time: a
killed run still leaves every round it completed on disk.

    {"seq": 0, "ts": <unix s>, "kind": "manifest", ...manifest fields}
    {"seq": 1, "ts": ..., "kind": "round", "scan": "fleet", "round": 17, ...}
    {"seq": 2, "ts": ..., "kind": "span", "name": "fleet_chunk", "ms": ...}
    {"seq": 3, "ts": ..., "kind": "control", "round": 20, "T": 5, ...}
    {"seq": 4, "ts": ..., "kind": "retrace_warning", "fn": ..., "delta": 1}

The schema is the reference's, so ``python -m repro_torch.obs.report``
reads the logs of both packages.
"""
from __future__ import annotations

import dataclasses
import enum
import hashlib
import json
import os
import platform as platform_lib
import subprocess
import sys
import time
from typing import IO, Any

import numpy as np
import torch

PyTree = Any


def _json_default(x):
    """Serialise the numpy scalars, tensors and small arrays riding in
    telemetry dicts; anything exotic degrades to ``repr`` rather than
    failing a run."""
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().tolist()
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, enum.Enum):
        return x.value
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.asdict(x)
    return repr(x)


class EventLog:
    """Append-only JSONL event stream, one line an event, flushed at once.
    ``seq`` is a per-log monotone counter, continued from the last intact
    line when an existing log is re-opened."""

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f: IO[str] | None = open(self.path, "a")
        self._seq = 0
        if self._f.tell():
            for ev in load_events(self.path):
                s = ev.get("seq")
                if isinstance(s, int) and s >= self._seq:
                    self._seq = s + 1

    def emit(self, kind: str, **fields) -> dict:
        """Append one event; returns the record as written."""
        if self._f is None:
            raise ValueError(f"EventLog {self.path} is closed")
        rec = {"seq": self._seq, "ts": round(time.time(), 6), "kind": kind}
        rec.update(fields)
        self._f.write(json.dumps(rec, default=_json_default) + "\n")
        self._f.flush()
        self._seq += 1
        return rec

    @property
    def closed(self) -> bool:
        return self._f is None

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_events(path: str | os.PathLike) -> list[dict]:
    """A JSONL event log as a list of dicts, skipping a torn last line that
    a killed writer may have left."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


def _hash_into(h, x) -> None:
    """Feed ``x``'s structure and values into ``h``: containers and
    dataclasses by their type and fields, tensors and arrays by dtype,
    shape and bytes, anything else by its ``repr``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous().numpy()
    if isinstance(x, np.ndarray) and x.dtype != object:
        h.update(f"array:{x.dtype}:{x.shape}:".encode())
        h.update(np.ascontiguousarray(x).tobytes())
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        h.update(f"{type(x).__qualname__}(".encode())
        for f in dataclasses.fields(x):
            h.update(f"{f.name}=".encode())
            _hash_into(h, getattr(x, f.name))
        h.update(b")")
    elif isinstance(x, dict):
        h.update(b"{")
        for k in x:
            h.update(f"{k!r}:".encode())
            _hash_into(h, x[k])
        h.update(b"}")
    elif isinstance(x, (tuple, list)):
        h.update(f"{type(x).__name__}[".encode())
        for v in x:
            _hash_into(h, v)
            h.update(b",")
        h.update(b"]")
    else:
        h.update(repr(x).encode())


def pytree_hash(tree: PyTree) -> str:
    """Stable content hash of a config tree (dataclasses, tuples, lists,
    dicts, tensors and arrays by dtype, shape and bytes, other leaves by
    ``repr``): the same across processes, different when any value or the
    structure differs.  It cannot equal the reference's hash of the same
    configuration, which hashes JAX's ``repr`` of a treedef."""
    h = hashlib.sha256()
    _hash_into(h, tree)
    return h.hexdigest()[:16]


def git_revision(cwd: str | None = None) -> str | None:
    """The current git revision, or None outside a repository or without
    git."""
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True, timeout=5,
                             cwd=cwd)
        rev = out.stdout.strip()
        return rev if out.returncode == 0 and rev else None
    except (OSError, subprocess.SubprocessError):
        return None


def _mesh_shape(mesh) -> dict | None:
    """{dim name: size} of a ``DeviceMesh``, None host-local."""
    if mesh is None:
        return None
    names = mesh.mesh_dim_names or tuple(
        f"dim{i}" for i in range(mesh.ndim))
    return {str(a): int(mesh.size(i)) for i, a in enumerate(names)}


@dataclasses.dataclass(frozen=True)
class RunManifest:
    """Provenance record written at run start.  The reference's fields where
    they mean the same; ``packages`` names torch and its CUDA,
    ``device_type`` stands where the reference has ``jax_backend``, and
    ``device_name`` / ``device_count`` name the cards."""

    kind: str                       # "fleet" / "serve" / "train" / ...
    run_id: str
    created: float                  # unix seconds
    seed: int | None = None
    backend: str | None = None      # the round step's executor
    mesh_shape: dict | None = None  # {"data": 2} etc., None host-local
    num_clients: int | None = None
    horizon: int | None = None      # rounds / epochs
    config_hash: str | None = None
    packages: dict = dataclasses.field(default_factory=dict)
    git_rev: str | None = None
    platform: str | None = None
    device_type: str | None = None  # "cuda" / "cpu"
    device_name: str | None = None
    device_count: int | None = None
    argv: list = dataclasses.field(default_factory=list)
    extra: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def create(cls, kind: str, *, config: PyTree = None, seed=None,
               backend=None, mesh=None, num_clients=None, horizon=None,
               device=None, run_id: str | None = None,
               **extra) -> "RunManifest":
        created = time.time()
        if run_id is None:
            run_id = f"{kind}-{int(created)}-{os.getpid()}"
        dev = torch.device(device) if device is not None else None
        on_card = dev is not None and dev.type == "cuda"
        return cls(
            kind=kind, run_id=run_id, created=round(created, 3),
            seed=None if seed is None else int(seed),
            backend=backend, mesh_shape=_mesh_shape(mesh),
            num_clients=None if num_clients is None else int(num_clients),
            horizon=None if horizon is None else int(horizon),
            config_hash=None if config is None else pytree_hash(config),
            packages={"python": platform_lib.python_version(),
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda, "numpy": np.__version__},
            git_rev=git_revision(),
            platform=platform_lib.platform(),
            device_type=None if dev is None else dev.type,
            device_name=(torch.cuda.get_device_name(dev) if on_card
                         else None),
            device_count=(torch.cuda.device_count() if on_card
                          else None if dev is None else 1),
            argv=list(sys.argv),
            extra=extra,
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
