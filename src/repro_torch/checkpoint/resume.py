"""Preemption-safe resumable runs (port of the JAX package's
``checkpoint/resume.py``, DESIGN.md §13).

The chunked controller loops (`energy.control.run_controlled`,
`serve.fleet_serve.run_serve_controlled`) thread the whole cross-chunk
state — ``(charge[, streak], process_state)`` / ``(charge[, streak],
traffic, harvest)``, the `ControlState` knobs and the absolute round
offset — so a chunk boundary is a point where the whole run is a small
tree.  This module persists that tree:

* `RunCheckpointer` — one file per saved boundary
  (``ckpt-<round:08d>.msgpack``, written atomically by
  `ckpt.save_checkpoint`), a retained-last-k rotation, and an atomic
  ``MANIFEST.json`` describing what is on disk.  `restore_payload` walks
  newest to oldest and skips torn or corrupt files, so a crash during a
  save falls back to the previous retained boundary.
* `save_run` / `restore_run` — the closed-loop run schema: the simulator's
  state leaves, the accumulated telemetry, the packed controller (knobs
  and trace), the RNG base key and a config `pytree_hash` guard (resuming
  under another configuration raises instead of diverging).  The mesh,
  the padding and the device are not part of the guard: a run resumes
  across them (bitwise where the parity contract is bitwise).
* `SectionCheckpoint` — record-level resume for the scale benchmarks.

Every value a checkpoint carries round-trips as exact bytes, which is what
makes a kill-and-resume run bit-identical to an uninterrupted one.  The
files are the reference's, but the config hash is the port's own
(`obs.events.pytree_hash`): a run directory written by one package is
refused by the other under a hash, by design.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import Any

import numpy as np
import torch

from repro_torch import prng
from repro_torch.checkpoint.ckpt import (CheckpointError, load_checkpoint,
                                         save_checkpoint, tree_flatten,
                                         validate_leaves)

PyTree = Any

MANIFEST_NAME = "MANIFEST.json"
_PREFIX, _SUFFIX = "ckpt-", ".msgpack"


class RunCheckpointer:
    """Retained-last-k rotation of atomic checkpoints in one directory."""

    def __init__(self, directory: str | os.PathLike, *, keep: int = 3):
        self.directory = os.fspath(directory)
        self.keep = max(1, int(keep))
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{_PREFIX}{step:08d}{_SUFFIX}")

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.directory, MANIFEST_NAME)

    def steps(self) -> list[int]:
        """Retained checkpoint steps, oldest first."""
        out = []
        for name in os.listdir(self.directory):
            if name.startswith(_PREFIX) and name.endswith(_SUFFIX):
                try:
                    out.append(int(name[len(_PREFIX):-len(_SUFFIX)]))
                except ValueError:
                    continue
        return sorted(out)

    def save(self, step: int, tree: PyTree, metadata: dict | None = None
             ) -> str:
        """Atomically write ``step``'s checkpoint, prune beyond ``keep``,
        refresh the manifest.  Returns the checkpoint path."""
        path = self.path(int(step))
        save_checkpoint(path, tree, step=int(step), metadata=metadata or {})
        steps = self.steps()
        for old in steps[:-self.keep]:
            try:
                os.unlink(self.path(old))
            except FileNotFoundError:
                pass
        self._write_manifest(steps[-self.keep:], metadata or {})
        return path

    def _write_manifest(self, steps: list[int], metadata: dict) -> None:
        man = {"updated": round(time.time(), 3), "keep": self.keep,
               "steps": steps, "kind": metadata.get("kind"),
               "config_hash": metadata.get("config_hash"),
               "seed": metadata.get("seed")}
        fd, tmp = tempfile.mkstemp(dir=self.directory)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(man, f, indent=2)
            os.replace(tmp, self.manifest_path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def restore_payload(self) -> tuple[PyTree, int, dict] | None:
        """Newest intact checkpoint as ``(tree, step, metadata)``, or None
        when the directory holds none.  Torn or corrupt files (a kill
        mid-save, a truncated disk) are skipped: the previous retained
        boundary wins."""
        for step in reversed(self.steps()):
            try:
                return load_checkpoint(self.path(step))
            except CheckpointError:
                continue
        return None


def as_checkpointer(checkpoint, *, keep: int = 3) -> RunCheckpointer:
    """Accept a directory path or an existing `RunCheckpointer`."""
    if isinstance(checkpoint, RunCheckpointer):
        return checkpoint
    return RunCheckpointer(checkpoint, keep=keep)


# ---------------------------------------------------------------------------
# Controller (ControlState + trace) <-> arrays.

_TEL_SCALARS = ("participation_rate", "frac_depleted", "overflow_frac",
                "mean_charge", "p95_frac_depleted", "shed_rate",
                "deadline_miss_rate")
_TEL_GROUPS = ("group_frac_depleted", "group_participation_rate")


def _np(x) -> np.ndarray:
    """A loaded leaf (a CPU tensor) or an array as numpy."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def pack_controller(controller) -> dict:
    """`ServerController` knobs and whole trace as a dict of arrays (the
    telemetry flattens to a column a field; the per-group and
    histogram-quantile columns are there only when every trace entry
    carries them)."""
    st = controller.state
    tels = [t["telemetry"] for t in controller.trace]
    out = {
        "T": np.asarray(st.T, np.int64),
        "E": np.asarray(st.E),
        "admit": np.asarray(st.admit, np.float64),
        "trace_T": np.asarray([t["T"] for t in controller.trace], np.int64),
        "trace_E_mean": np.asarray(
            [t["E_mean"] for t in controller.trace], np.float64),
        "trace_admit": np.asarray(
            [t["admit"] for t in controller.trace], np.float64),
    }
    for f in _TEL_SCALARS:
        out["tel_" + f] = np.asarray([getattr(t, f) for t in tels],
                                     np.float64)
    for f in _TEL_GROUPS:
        vals = [getattr(t, f) for t in tels]
        if vals and all(v is not None for v in vals):
            out["tel_" + f] = np.asarray(vals, np.float64)
    # hist_quantiles ({"hist_soc": {"p50": ...}, ...}) flatten to one
    # "tel_hq_<name>_<q>" column a (histogram, quantile), when the whole
    # trace carries one key set (hist runs do)
    hqs = [t.hist_quantiles for t in tels]
    if hqs and all(h is not None for h in hqs):
        keys = [(name, q) for name in sorted(hqs[0])
                for q in sorted(hqs[0][name])]
        if all(sorted((n, q) for n in h for q in h[n]) == sorted(keys)
               for h in hqs):
            for name, q in keys:
                out[f"tel_hq_{name}_{q}"] = np.asarray(
                    [h[name][q] for h in hqs], np.float64)
    return out


def unpack_controller(controller, packed: dict) -> None:
    """Inverse of `pack_controller`, in place: restore the knobs and rebuild
    the trace (its `Telemetry` entries included) bit-exactly."""
    if not packed or "T" not in packed:
        return
    from repro_torch.energy.control import ControlState, Telemetry

    packed = {k: _np(v) for k, v in packed.items()}
    controller.state = ControlState(
        T=int(packed["T"]), E=np.array(packed["E"]),
        admit=float(packed["admit"]))
    trace = []
    for i in range(int(packed["trace_T"].shape[0])):
        kw = {f: float(packed["tel_" + f][i])
              for f in _TEL_SCALARS if "tel_" + f in packed}
        for f in _TEL_GROUPS:
            if "tel_" + f in packed:
                kw[f] = np.array(packed["tel_" + f][i])
        hq: dict = {}
        for key in packed:
            if not key.startswith("tel_hq_"):
                continue
            name, q = key[len("tel_hq_"):].rsplit("_", 1)
            hq.setdefault(name, {})[q] = float(packed[key][i])
        if hq:
            kw["hist_quantiles"] = hq
        trace.append({"T": int(packed["trace_T"][i]),
                      "E_mean": float(packed["trace_E_mean"][i]),
                      "admit": float(packed["trace_admit"][i]),
                      "telemetry": Telemetry(**kw)})
    controller.trace = trace


# ---------------------------------------------------------------------------
# Closed-loop run schema.

@dataclasses.dataclass
class RunCheckpoint:
    """One restored chunk boundary of a controlled run."""

    kind: str            # "fleet_controlled" / "serve_controlled" / ...
    round_offset: int    # rounds/epochs already simulated
    state: PyTree        # simulator cross-chunk state, validated vs like
    stats: dict          # accumulated telemetry, (round_offset,) per key
    metadata: dict


def _base_key_data(seed) -> torch.Tensor:
    """``jax.random.key_data(jax.random.PRNGKey(seed))``: two uint32 words
    (a uint32 zero scalar for no seed)."""
    if seed is None:
        return torch.zeros((), dtype=torch.uint32)
    return prng.PRNGKey(int(seed)).to(torch.uint32)


def save_run(ckptr: RunCheckpointer, *, kind: str, round_offset: int,
             state: PyTree, stats: dict, controller=None,
             config_hash: str | None = None, seed=None,
             extra: dict | None = None) -> str:
    """Persist one chunk boundary.  ``state`` is stored as its flat leaf
    list in JAX's order; `restore_run` hangs the leaves on a caller-built
    ``state_like``."""
    tree = {
        "state": tree_flatten(state),
        "stats": {k: np.asarray(v) for k, v in stats.items()},
        "controller": {} if controller is None else
        pack_controller(controller),
        "rng": {"base_key": _base_key_data(seed)},
    }
    meta = {"kind": kind, "round_offset": int(round_offset),
            "config_hash": config_hash,
            "seed": None if seed is None else int(seed),
            "created": round(time.time(), 3)}
    if extra:
        meta.update(extra)
    return ckptr.save(int(round_offset), tree, meta)


def restore_run(ckptr: RunCheckpointer, *, kind: str, state_like: PyTree,
                config_hash: str | None = None, seed=None, controller=None
                ) -> RunCheckpoint | None:
    """Restore the newest intact boundary, or None for an empty directory.

    Guards, each raising `CheckpointError` rather than diverging silently:
    the stored run ``kind``, the config `pytree_hash`, the RNG base key
    derived from ``seed``, and every state leaf's dtype and shape against
    ``state_like``.  With ``controller`` its knobs and trace are restored
    in place.  The state comes back as CPU tensors, the stats as numpy.
    """
    payload = ckptr.restore_payload()
    if payload is None:
        return None
    tree, step, meta = payload
    if meta.get("kind") != kind:
        raise CheckpointError(
            f"checkpoint dir {ckptr.directory} holds a {meta.get('kind')!r} "
            f"run, expected {kind!r}")
    if config_hash is not None and meta.get("config_hash") != config_hash:
        raise CheckpointError(
            "refusing to resume: the checkpoint was written by a different "
            f"config (stored hash {meta.get('config_hash')}, current "
            f"{config_hash}) — use a fresh checkpoint dir or drop resume")
    want = _base_key_data(seed).to(torch.int64)
    got = tree.get("rng", {}).get("base_key")
    got = want if got is None else torch.as_tensor(got).to(torch.int64)
    if got.shape != want.shape or not torch.equal(got, want):
        raise CheckpointError(
            "refusing to resume: the checkpointed RNG base key does not "
            f"match the current seed (stored seed {meta.get('seed')}, "
            f"current {seed})")
    state = validate_leaves(tree["state"], state_like,
                            context=f"{kind} state at round {step}")
    if controller is not None:
        unpack_controller(controller, tree.get("controller", {}))
    stats = {k: _np(v) for k, v in tree["stats"].items()}
    return RunCheckpoint(kind=kind, round_offset=int(meta["round_offset"]),
                         state=state, stats=stats, metadata=meta)


# ---------------------------------------------------------------------------
# Benchmark section/record resume.

class SectionCheckpoint:
    """Record-granular resume for the scale benchmarks.

    Completed bench records (plain JSON-able dicts) ride in checkpoint
    *metadata* — the payload tree is empty — so a killed benchmark re-run
    with ``resume`` replays finished records from disk and only computes
    the rest.  Records are keyed ``(section, index)``: benches append
    records in a deterministic order, so "the first ``len(stored)``
    records of a section are done" is exact.
    """

    def __init__(self, directory: str | os.PathLike, *, kind: str,
                 config_hash: str | None, resume: bool = False,
                 keep: int = 2):
        self.mgr = RunCheckpointer(directory, keep=keep)
        self.kind, self.config_hash = kind, config_hash
        self.sections: dict[str, list] = {}
        self.step = 0
        if resume:
            payload = self.mgr.restore_payload()
            if payload is not None:
                _, step, meta = payload
                if meta.get("kind") != kind:
                    raise CheckpointError(
                        f"checkpoint dir {self.mgr.directory} holds a "
                        f"{meta.get('kind')!r} run, expected {kind!r}")
                if (config_hash is not None
                        and meta.get("config_hash") != config_hash):
                    raise CheckpointError(
                        "refusing to resume benchmark: stored config hash "
                        f"{meta.get('config_hash')} != current {config_hash}")
                self.sections = {k: list(v) for k, v in
                                 (meta.get("sections") or {}).items()}
                self.step = int(step)

    @property
    def resumed(self) -> bool:
        return self.step > 0

    def cached(self, section: str, index: int, fn):
        """Return the stored record for ``(section, index)`` if the previous
        run completed it, else compute ``fn()``, persist, and return it."""
        recs = self.sections.setdefault(section, [])
        if index < len(recs):
            return recs[index]
        from repro_torch.obs.events import _json_default

        rec = json.loads(json.dumps(fn(), default=_json_default))
        recs.append(rec)
        self.step += 1
        self.mgr.save(self.step, {}, {
            "kind": self.kind, "config_hash": self.config_hash,
            "sections": self.sections})
        return rec
