"""Trace replay as arrival and traffic processes on the (shardable) fleet
(port of the JAX package's ``traces/replay.py``).

`TraceHarvest` obeys the `energy.arrivals` contract and `TraceTraffic` the
`serve.traffic` one, so measured day profiles drop into every consumer of
those processes unchanged: `simulate_fleet`, `simulate_serve`, the chunked
`run_controlled` / `run_serve_controlled` loops, `EnergyLoop`, and `Sum` /
`Scaled` composition with the synthetic processes.

* **Client -> profile assignment.**  Each client gets a profile column
  ``row_i``, a time-zone ``phase_i`` and an amplitude ``gain_i``.  The
  ``create`` constructors draw all three through the per-client RNG
  (`arrivals.client_randint` / `client_uniform` on ``fold_in(key, 0|1|2)``),
  so client i's assignment depends on ``(seed, i)`` alone, never on the
  fleet's width; row, phase and gain are bitwise the reference's.
* **Round -> slot.**  Round ``t`` reads slot ``(t + phase_i) mod T`` in
  integer arithmetic.  Both fleet loops pass the absolute round index
  (``round_offset + r``, ``epoch_offset + t``), so chunked controller runs
  read the slots of an unchunked horizon.
* **Values.**  ``TraceHarvest`` replays ``gain_i * table[slot, row_i]``.
  ``TraceTraffic`` treats that as a rate and draws Poisson counts through
  `arrivals.truncated_poisson` (``u`` from `client_uniform`, by the
  client's global index under a slab); ``poisson=False`` replays the rates
  as deterministic counts (integer tables keep every quantity downstream
  on the exact float32 grid: the parity-oracle configuration).

The ``(T, P)`` table has no client axis.  Both processes name it in
``SHARED_FIELDS``, so the client-axis machinery (`arrivals.map_clients`:
padding, slicing, sharding, gathering) never touches it, whatever ``T``
is.  The reference pads and shards by shape alone, so there a table whose
``T`` equals the fleet's width is padded with the clients (``ROADMAP.md``,
"Reference caveats"); here the documented padding and partition
invariance holds for every ``T``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import prng
from repro_torch.energy.arrivals import (PyTree, _per_client, client_randint,
                                         client_uniform, truncated_poisson)


def _assign(table, num_clients: int, seed, row, phase, gain, gain_jitter,
            scale, device):
    """The per-client (row, phase, gain) assignment: explicit arrays win;
    the defaults are drawn per client from ``fold_in(key, 0|1|2)``, in the
    reference's float32 order for the gain."""
    table = torch.as_tensor(table, dtype=torch.float32, device=device)
    if table.dim() == 1:
        table = table[:, None]
    if table.dim() != 2:
        raise ValueError(f"profile table must be (T,) or (T, P), "
                         f"got shape {tuple(table.shape)}")
    T, P = table.shape
    dev = table.device
    key = (seed.to(dev) if isinstance(seed, torch.Tensor)
           else prng.PRNGKey(seed, dev))
    n = num_clients
    if row is None:
        row = client_randint(prng.fold_in(key, 0), n, P)
    else:
        row = torch.as_tensor(row, device=dev).to(torch.int32)
    if phase is None:
        phase = client_randint(prng.fold_in(key, 1), n, T)
    else:
        phase = torch.as_tensor(phase, device=dev).to(torch.int32)
    if gain is None:
        u = client_uniform(prng.fold_in(key, 2), n)
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
        gain = f32(scale) * (1.0 + f32(gain_jitter) * (2.0 * u - 1.0))
    else:
        gain = _per_client(gain, n, dev)
    for name, arr in (("row", row), ("phase", phase), ("gain", gain)):
        if tuple(arr.shape) != (n,):
            raise ValueError(f"{name} must be ({n},), got {tuple(arr.shape)}")
    return table, row, phase, gain


def _replay_value(table, row, phase, gain, t) -> torch.Tensor:
    """(N,) ``gain_i * table[(t + phase_i) mod T, row_i]``, elementwise in
    the client index (so it pads and shards like every per-client op)."""
    slot = torch.remainder(phase + int(t), table.shape[0])
    return gain * table[slot.long(), row.long()]


@dataclasses.dataclass(frozen=True, eq=False)
class TraceHarvest:
    """Replayed measured harvest: client i collects ``gain_i *
    table[(t + phase_i) mod T, row_i]`` joules at round ``t`` (no draw: the
    randomness lives in the measured profile)."""

    table: torch.Tensor  # (T, P) float32 joules per slot per profile
    row: torch.Tensor    # (N,) int32 client -> profile column
    phase: torch.Tensor  # (N,) int32 time-zone offset, slots
    gain: torch.Tensor   # (N,) float32 amplitude (panel size, efficiency)

    SHARED_FIELDS = ("table",)

    @classmethod
    def create(cls, table, num_clients: int, seed=0, *, row=None, phase=None,
               gain=None, gain_jitter: float = 0.0, scale: float = 1.0,
               device=None) -> "TraceHarvest":
        """Assign ``num_clients`` clients onto ``table``: row and phase
        uniform, gain in ``scale * [1 - gain_jitter, 1 + gain_jitter]``,
        each drawn per client; explicit ``row`` / ``phase`` / ``gain``
        arrays pin an assignment."""
        return cls(*_assign(table, num_clients, seed, row, phase, gain,
                            gain_jitter, scale, device))

    @property
    def num_clients(self) -> int:
        return self.row.shape[0]

    def rate_at(self, t) -> torch.Tensor:
        """(N,) replayed joules at round ``t`` (the sample itself)."""
        return _replay_value(self.table, self.row, self.phase, self.gain, t)

    def init(self) -> PyTree:
        return ()

    def sample(self, key, t, state, first: int = 0):
        del key, first              # no draw: the assignment is per client
        return self.rate_at(t), state


@dataclasses.dataclass(frozen=True, eq=False)
class TraceTraffic:
    """Replayed measured request traffic: epoch ``t`` draws ``Poisson(gain_i
    * table[(t + phase_i) mod T, row_i])`` requests per client
    (``poisson=False``: the rate itself, as a deterministic count)."""

    table: torch.Tensor  # (T, P) float32 mean requests per slot per profile
    row: torch.Tensor    # (N,) int32 client -> profile column
    phase: torch.Tensor  # (N,) int32 time-zone offset, slots
    gain: torch.Tensor   # (N,) float32 per-client activity scale
    max_requests: int = 16
    poisson: bool = True

    SHARED_FIELDS = ("table",)

    @classmethod
    def create(cls, table, num_clients: int, seed=0, *, row=None, phase=None,
               gain=None, gain_jitter: float = 0.0, scale: float = 1.0,
               max_requests: int = 16, poisson: bool = True, device=None
               ) -> "TraceTraffic":
        """Assign ``num_clients`` clients onto ``table`` (the defaults and
        draws of `TraceHarvest.create`)."""
        return cls(*_assign(table, num_clients, seed, row, phase, gain,
                            gain_jitter, scale, device), max_requests,
                   poisson)

    @property
    def num_clients(self) -> int:
        return self.row.shape[0]

    def rate_at(self, t) -> torch.Tensor:
        """(N,) replayed mean requests at epoch ``t``."""
        return _replay_value(self.table, self.row, self.phase, self.gain, t)

    def init(self) -> PyTree:
        return ()

    def sample(self, key, t, state, first: int = 0):
        rate = self.rate_at(t)
        if not self.poisson:
            return rate, state
        u = client_uniform(key, self.num_clients, first)
        k = truncated_poisson(u, rate, self.max_requests)
        return k.to(torch.float32), state
