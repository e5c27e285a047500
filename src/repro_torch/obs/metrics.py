"""Live run metrics: counters and gauges, the per-round `MetricStream`, and
the `Obs` hook the simulators take as ``obs=`` (port of the JAX package's
``obs/metrics.py``).

Two tap points, both outside the round step:

* **Chunk boundaries** (the default): `energy.control.run_controlled` and
  `serve.fleet_serve.run_serve_controlled` bring each chunk's stats to the
  host for the controller anyway; `Obs.rounds` streams them from there.
  Un-chunked `simulate_fleet` / `simulate_serve` runs stream their stacked
  stats once, at the end of the run.
* **The round tap** (``Obs(..., tap=True)``): the rounds are a Python loop,
  so the tap is a per-round call inside it that copies that round's stats
  row to the host and writes its events.  The copy waits for the round's
  launch to finish, so it costs a host sync a round; it only reads the
  stats, so the run's results are bitwise the un-tapped run's.

Emitted per round: the fleet's energy seven (participants, harvested,
consumed, leaked, overflowed, mean_charge, frac_depleted), the serve
ledger (offered, served_full, served_short, shed, deadline_missed,
tokens_decoded, consumed_serve, consumed_train) and any per-group
telemetry, whichever the producing simulator computed.  With ``hist=True``
each round's histogram counts go out as separate ``hist`` events (exact
integers), and one ``hist_spec`` event a stream pins the bin edges.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.obs import hist as hist_lib
from repro_torch.obs.events import EventLog, RunManifest, pytree_hash

# the per-round stats vocabulary, in emission order
ENERGY_SEVEN = ("participants", "harvested", "consumed", "leaked",
                "overflowed", "mean_charge", "frac_depleted")
SERVE_LEDGER = ("offered", "served_full", "served_short", "shed",
                "deadline_missed", "tokens_decoded", "consumed_serve",
                "consumed_train")
# (R, G) per-group telemetry, streamed inline in round events as G-lists
GROUP_KEYS = ("group_participants", "group_frac_depleted")
# (R, N) per-client recordings never belong in an event stream
_SKIP_KEYS = ("mask", "mode")


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _round_to_host(stats: dict) -> dict:
    """One round's stats as numpy arrays of their own dtypes, brought to
    the host in one copy (float64 holds every float32 value and count
    exactly)."""
    tensors = {k: v for k, v in stats.items() if isinstance(v, torch.Tensor)}
    out = {k: v for k, v in stats.items() if k not in tensors}
    if tensors:
        flat = torch.cat([v.detach().reshape(-1).to(torch.float64)
                          for v in tensors.values()]).cpu().numpy()
        at = 0
        for k, v in tensors.items():
            part = flat[at:at + v.numel()].reshape(tuple(v.shape))
            out[k] = part.astype(str(v.dtype).removeprefix("torch."))
            at += v.numel()
    return out


def _scalarize(v):
    """A telemetry value as JSON: 0-d to a float, a per-group vector to a
    list."""
    a = _host(v)
    if a.ndim == 0:
        return float(a)
    return a.tolist()


class Counter:
    """Monotone event counter (rounds seen, chunks, ...)."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, by: int = 1) -> int:
        self.value += by
        return self.value


class Gauge:
    """Last-write-wins instantaneous value (mean charge, admit scale, ...)."""

    def __init__(self, name: str):
        self.name = name
        self.value: float | None = None

    def set(self, v) -> None:
        self.value = float(v)


class MetricStream:
    """Counters and gauges plus the per-round telemetry emitter over one
    `EventLog`."""

    def __init__(self, log: EventLog):
        self.log = log
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._specs_emitted: set[str] = set()

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge(name))

    def emit_hist(self, scan: str, rnd: int, key: str, counts) -> None:
        """One round's histogram counts as a ``hist`` event (and, once a
        stream, the ``hist_spec`` event of its bin edges)."""
        spec = hist_lib.SPECS_BY_NAME.get(key)
        if spec is not None and key not in self._specs_emitted:
            self._specs_emitted.add(key)
            self.log.emit("hist_spec", scan=scan, name=spec.name,
                          buf=spec.buf, lo=spec.lo, hi=spec.hi,
                          bins=spec.bins)
        self.log.emit("hist", scan=scan, round=int(rnd), name=key,
                      counts=[int(c) for c in _host(counts).reshape(-1)])

    def emit_rounds(self, scan: str, offset: int, stats: dict) -> int:
        """One ``round`` event a round from a stats dict of (R,) (or
        (R, G)) arrays, the simulators' output; ``hist_*`` (R, bins) counts
        go out as one ``hist`` event a round and histogram.  Returns the
        number of rounds emitted."""
        arrs = {k: _host(stats[k]) for k in stats if k not in _SKIP_KEYS}
        if not arrs:
            return 0
        keys = [k for k in arrs if not hist_lib.is_hist_key(k)]
        hist_keys = [k for k in arrs if hist_lib.is_hist_key(k)]
        r_len = next(iter(arrs.values())).shape[0]
        for i in range(r_len):
            if keys:
                self.log.emit("round", scan=scan, round=int(offset) + i,
                              **{k: _scalarize(arrs[k][i]) for k in keys})
            for k in hist_keys:
                self.emit_hist(scan, int(offset) + i, k, arrs[k][i])
        self.counter(f"{scan}_rounds").inc(r_len)
        if "mean_charge" in arrs and r_len:
            self.gauge(f"{scan}_mean_charge").set(arrs["mean_charge"][-1])
        return r_len

    def flush(self) -> None:
        """Every counter and gauge as one ``metrics`` event."""
        self.log.emit(
            "metrics",
            counters={c.name: c.value for c in self._counters.values()},
            gauges={g.name: g.value for g in self._gauges.values()})


class Obs:
    """The ``obs=`` hook: one run directory, one JSONL event log, one
    manifest.  Taken by `simulate_fleet` / `simulate_serve` (manifest and
    round events; the round tap with ``tap=True``), `run_controlled` /
    `run_serve_controlled` (chunk-boundary streaming, ``control`` events,
    the retrace sentinel) and the launchers' ``--obs-dir``.  ``obs=None``,
    the default everywhere, is the un-instrumented run.

    Args:
      out_dir: directory for ``events.jsonl`` (created if missing).
      run_id: optional stable id recorded in the manifest.
      tap: stream un-chunked simulator runs a round at a time (a host copy
        of each round's stats) rather than at the end of the run.
    """

    def __init__(self, out_dir: str | os.PathLike, *,
                 run_id: str | None = None, tap: bool = False):
        self.dir = os.fspath(out_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.log = EventLog(os.path.join(self.dir, "events.jsonl"))
        self.metrics = MetricStream(self.log)
        self.tap = bool(tap)
        self.run_id = run_id
        self.manifest: RunManifest | None = None

    def write_manifest(self, kind: str, **kwargs) -> RunManifest:
        """Create and emit the run manifest.  The first call wins: several
        simulator calls sharing one Obs are one run, and each later call
        records a ``phase`` event instead."""
        if self.manifest is None:
            self.manifest = RunManifest.create(kind, run_id=self.run_id,
                                               **kwargs)
            self.run_id = self.manifest.run_id
            fields = self.manifest.to_dict()
            # ``kind`` is the event type on every line; the run's kind
            # rides as ``run_kind``
            fields["run_kind"] = fields.pop("kind")
            self.log.emit("manifest", **fields)
        else:
            config = kwargs.pop("config", None)
            kwargs.pop("device", None)
            self.log.emit(
                "phase", phase=kind,
                config_hash=None if config is None else pytree_hash(config),
                **{k: v for k, v in kwargs.items()
                   if isinstance(v, (int, float, str, bool, type(None)))})
        return self.manifest

    def event(self, kind: str, **fields) -> dict:
        return self.log.emit(kind, **fields)

    def rounds(self, scan: str, offset: int, stats: dict) -> int:
        return self.metrics.emit_rounds(scan, offset, stats)

    def span(self, name: str):
        from repro_torch.obs.profile import span
        return span(name, obs=self)

    def round_tap(self, scan: str):
        """The per-round tap of ``scan``: ``tap(r, stats)`` with one
        round's stats (tensors on the device) copies them to the host and
        emits that round's events."""
        return lambda r, stats: self._on_round(scan, r, stats)

    def _on_round(self, scan: str, r, stats: dict) -> None:
        rnd = int(r)
        stats = _round_to_host(stats)
        row = {k: _scalarize(v) for k, v in stats.items()
               if k not in _SKIP_KEYS and not hist_lib.is_hist_key(k)}
        if row:
            self.log.emit("round", scan=scan, round=rnd, **row)
        for k, v in stats.items():
            if hist_lib.is_hist_key(k):
                self.metrics.emit_hist(scan, rnd, k, v)
        self.metrics.counter(f"{scan}_rounds").inc()

    def close(self) -> None:
        if not self.log.closed:
            self.metrics.flush()
        self.log.close()

    def __enter__(self) -> "Obs":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
