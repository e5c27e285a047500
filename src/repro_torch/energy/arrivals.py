"""Composable stochastic energy-arrival processes (port of the JAX
package's ``energy/arrivals.py``).

Every process obeys one functional contract, vectorised over the fleet:

    state0  = process.init()                          # (N,) tensors or ()
    harvest, state1 = process.sample(key, t, state0)  # harvest: (N,) float32 J
    harvest, state1 = process.sample(key, t, state0, first=f)  # a slab

Per-client parameters are float32 tensors, (N,) or broadcast from a scalar
with ``expand`` (stride 0, no copy).  Randomness is drawn per client
through `repro_torch.prng`: ``fold_in(key, i)`` and then one scalar draw,
so client ``i``'s harvest depends only on ``(key, i)`` and is invariant to
padding the fleet.  A process sized to a slab of a sharded fleet (its
per-client parameters sliced to clients ``[first, first + N)``) draws
with ``first=``: client ``first + j`` of the slab draws by its global
index, bit for bit what the whole fleet draws there.  The uniforms, `Bernoulli` and `DeterministicRenewal`
harvests and `MarkovSolar`'s regimes are bitwise equal to the reference's.
The exponential marks (`MarkovSolar`, `CompoundPoisson`) are within a few
ulp of it (``prng.exponential``), and the truncated-Poisson counts equal
its counts except where ``u`` lies within a few ulp of a cdf step
(``exp`` is rounded differently).  ``TraceHarvest`` (replayed day
profiles) lives in `repro_torch.traces.replay`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import prng

PyTree = Any


def _per_client(x, n: int, device=None) -> torch.Tensor:
    """A scalar broadcast to (n,) float32 (stride 0), or an (n,) array."""
    t = torch.as_tensor(x, dtype=torch.float32, device=device)
    return t.expand(n)


def map_tensors(obj, fn: Callable[[torch.Tensor], torch.Tensor]):
    """``fn`` applied to every tensor of a process (or of a tuple/list of
    them, or of a battery config), recursing into nested processes; other
    fields (ints) are kept."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(map_tensors(x, fn) for x in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: map_tensors(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj)})
    return obj


def map_clients(obj, fn: Callable[[torch.Tensor], torch.Tensor],
                shared: Callable[[torch.Tensor], torch.Tensor] = lambda t: t):
    """`map_tensors` for the client-axis machinery (padding, slicing,
    sharding and gathering a fleet): ``fn`` on every tensor that may carry
    the client axis, ``shared`` on the fields a dataclass names in its
    ``SHARED_FIELDS``, which never do whatever their shape (a replay's
    (T, P) table: a T equal to the fleet's width is not a client axis)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(map_clients(x, fn, shared) for x in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        keep = getattr(obj, "SHARED_FIELDS", ())
        return dataclasses.replace(obj, **{
            f.name: (map_tensors(getattr(obj, f.name), shared)
                     if f.name in keep
                     else map_clients(getattr(obj, f.name), fn, shared))
            for f in dataclasses.fields(obj)})
    return obj


def client_keys(key: torch.Tensor, n: int, first: int = 0) -> torch.Tensor:
    """(n, 2) per-client keys ``fold_in(key, i)`` for the global client
    indices ``i`` in ``[first, first + n)``."""
    return prng.fold_in(key, torch.arange(first, first + n,
                                          dtype=torch.int64,
                                          device=key.device))


def client_uniform(key: torch.Tensor, n: int, first: int = 0
                   ) -> torch.Tensor:
    """(n,) float32 uniforms of clients ``[first, first + n)``; client
    ``i``'s value depends only on ``(key, i)``."""
    return prng.uniform(client_keys(key, n, first), ())


def client_randint(key: torch.Tensor, n: int, bound: int, first: int = 0
                   ) -> torch.Tensor:
    """(n,) int32 draws over {0..bound-1}, per client like
    `client_uniform`."""
    u = client_uniform(key, n, first)
    return torch.clamp_max((u * bound).to(torch.int32), bound - 1)


def client_exponential(key: torch.Tensor, n: int, extra_shape: tuple = (),
                       first: int = 0) -> torch.Tensor:
    """(n, *extra_shape) Exp(1) marks of clients ``[first, first + n)``;
    client ``i``'s row depends only on ``(key, i, extra_shape)``."""
    return prng.exponential(client_keys(key, n, first), extra_shape)


def truncated_poisson(u: torch.Tensor, rate: torch.Tensor,
                      max_count: int) -> torch.Tensor:
    """Poisson(``rate``) counts by inverse cdf on the truncated support
    {0..max_count}: ``K = #{j : u > cdf_j}``, a fixed chain of
    O(max_count) elementwise ops.  Pick ``max_count >= rate +
    6 sqrt(rate)`` for negligible truncation error."""
    rate = rate.float()
    pmf = torch.exp(-rate)
    cdf = pmf
    k = torch.zeros(rate.shape, dtype=torch.int32, device=rate.device)
    for j in range(max_count):
        k = k + (u > cdf).to(torch.int32)
        pmf = pmf * rate / (j + 1)
        cdf = cdf + pmf
    return k


@dataclasses.dataclass(frozen=True, eq=False)
class Bernoulli:
    """Each round, client i harvests ``amount_i`` joules with prob
    ``prob_i``."""

    prob: torch.Tensor     # (N,) in [0, 1]
    amount: torch.Tensor   # (N,) joules per arrival

    @classmethod
    def create(cls, num_clients: int, prob=0.5, amount=1.0, device=None
               ) -> "Bernoulli":
        return cls(_per_client(prob, num_clients, device),
                   _per_client(amount, num_clients, device))

    @property
    def num_clients(self) -> int:
        return self.prob.shape[0]

    def init(self) -> PyTree:
        return ()

    def sample(self, key, t, state, first: int = 0):
        del t
        u = client_uniform(key, self.num_clients, first)
        return torch.where(u < self.prob, self.amount, 0.0), state


@dataclasses.dataclass(frozen=True, eq=False)
class CompoundPoisson:
    """``K_i ~ Poisson(rate_i)`` arrivals per round, each an independent
    Exponential(``mean_amount_i``) packet; the round's harvest is their
    sum.  Counts by truncated inverse cdf, capped at ``max_arrivals``."""

    rate: torch.Tensor         # (N,) mean arrivals per round
    mean_amount: torch.Tensor  # (N,) mean joules per arrival
    max_arrivals: int = 8

    @classmethod
    def create(cls, num_clients: int, rate=1.0, mean_amount=1.0,
               max_arrivals: int = 8, device=None) -> "CompoundPoisson":
        return cls(_per_client(rate, num_clients, device),
                   _per_client(mean_amount, num_clients, device),
                   max_arrivals)

    @property
    def num_clients(self) -> int:
        return self.rate.shape[0]

    def init(self) -> PyTree:
        return ()

    def sample(self, key, t, state, first: int = 0):
        del t
        k1, k2 = prng.split(key)
        u = client_uniform(k1, self.num_clients, first)
        k = truncated_poisson(u, self.rate, self.max_arrivals)
        marks = client_exponential(k2, self.num_clients,
                                   (self.max_arrivals,), first)
        active = (torch.arange(self.max_arrivals, device=k.device)[None, :]
                  < k[:, None])
        harvest = self.mean_amount * torch.sum(marks * active, dim=1)
        return harvest, state


@dataclasses.dataclass(frozen=True, eq=False)
class MarkovSolar:
    """Two-state (day/night) Markov-modulated harvest: per client, stay in
    day with ``p_stay_day``, in night with ``p_stay_night``; the round's
    harvest is ``regime_mean * Exponential(1)``.  State: (N,) int32 regime
    (1 = day); all clients start in day."""

    p_stay_day: torch.Tensor    # (N,)
    p_stay_night: torch.Tensor  # (N,)
    day_mean: torch.Tensor      # (N,) mean joules per daytime round
    night_mean: torch.Tensor    # (N,) mean joules per nighttime round

    @classmethod
    def create(cls, num_clients: int, p_stay_day=0.9, p_stay_night=0.9,
               day_mean=1.0, night_mean=0.0, device=None) -> "MarkovSolar":
        return cls(_per_client(p_stay_day, num_clients, device),
                   _per_client(p_stay_night, num_clients, device),
                   _per_client(day_mean, num_clients, device),
                   _per_client(night_mean, num_clients, device))

    @property
    def num_clients(self) -> int:
        return self.day_mean.shape[0]

    def init(self) -> PyTree:
        return torch.ones((self.num_clients,), dtype=torch.int32,
                          device=self.day_mean.device)

    def sample(self, key, t, state, first: int = 0):
        del t
        k1, k2 = prng.split(key)
        u = client_uniform(k1, self.num_clients, first)
        is_day = state == 1
        day_next = torch.where(is_day, u < self.p_stay_day,
                               u >= self.p_stay_night)
        mean = torch.where(day_next, self.day_mean, self.night_mean)
        harvest = mean * client_exponential(k2, self.num_clients,
                                            first=first)
        return harvest, day_next.to(torch.int32)


@dataclasses.dataclass(frozen=True, eq=False)
class DeterministicRenewal:
    """Exactly ``unit_i`` joules at the first round of every window of
    ``E_i`` rounds (windows aligned to ``t + phase_i``): the static
    renewal-cycle semantics as a degenerate arrival process."""

    E: torch.Tensor      # (N,) int32 renewal cycles
    unit: torch.Tensor   # (N,) joules per renewal
    phase: torch.Tensor  # (N,) int32 per-client start offsets

    @classmethod
    def create(cls, E, unit=1.0, phase=None, device=None
               ) -> "DeterministicRenewal":
        E = torch.as_tensor(E, device=device).to(torch.int32)
        n = E.shape[0]
        ph = (torch.zeros((n,), dtype=torch.int32, device=E.device)
              if phase is None
              else torch.as_tensor(phase, device=E.device).to(torch.int32))
        return cls(E, _per_client(unit, n, E.device), ph)

    @property
    def num_clients(self) -> int:
        return self.E.shape[0]

    def init(self) -> PyTree:
        return ()

    def sample(self, key, t, state, first: int = 0):
        del key, first              # no draw: the phases are per client
        arrives = torch.remainder(int(t) + self.phase, self.E) == 0
        return torch.where(arrives, self.unit, 0.0), state


@dataclasses.dataclass(frozen=True, eq=False)
class Sum:
    """Superposition of independent sources (e.g. solar + ambient RF)."""

    parts: tuple

    @property
    def num_clients(self) -> int:
        return self.parts[0].num_clients

    def init(self) -> PyTree:
        return tuple(p.init() for p in self.parts)

    def sample(self, key, t, state, first: int = 0):
        keys = prng.split(key, len(self.parts))
        total = torch.zeros((self.num_clients,), dtype=torch.float32,
                            device=key.device)
        out = []
        for i, (p, s) in enumerate(zip(self.parts, state)):
            h, s1 = p.sample(keys[i], t, s, first=first)
            total = total + h
            out.append(s1)
        return total, tuple(out)


@dataclasses.dataclass(frozen=True, eq=False)
class Scaled:
    """Harvest gain knob (panel size / harvester efficiency), per client."""

    base: Any
    gain: torch.Tensor  # (N,)

    @classmethod
    def create(cls, base, gain=1.0) -> "Scaled":
        dev = map_device(base)
        return cls(base, _per_client(gain, base.num_clients, dev))

    @property
    def num_clients(self) -> int:
        return self.base.num_clients

    def init(self) -> PyTree:
        return self.base.init()

    def sample(self, key, t, state, first: int = 0):
        h, state = self.base.sample(key, t, state, first=first)
        return h * self.gain, state


def map_device(obj) -> torch.device | None:
    """The device of the first tensor in a process (None if it has none)."""
    found = []
    map_tensors(obj, lambda t: found.append(t.device) or t)
    return found[0] if found else None
