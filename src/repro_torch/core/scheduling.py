"""Energy-aware client scheduling (port of the JAX package's
``core/scheduling.py``): Algorithm 1's schedule, the paper's two
energy-agnostic benchmarks and the unconstrained-FedAvg upper bound.

Every schedule is a stateless function of ``(seed, round, E)``: the mask of
round ``r`` is derived through ``repro_torch.prng``, a bit-exact copy of the
reference's ``jax.random`` calls, so the masks equal the reference's bit
for bit.  Masks are float32 in {0., 1.} on ``E``'s device.

Conventions: ``E`` (N,) int energy renewal cycles, ``E_i >= 1``; a global
round ``r`` is the paper's block of time instances {rT, ..., rT + T - 1}.
"""
from __future__ import annotations

import dataclasses
import enum

import torch

from repro_torch import prng


class Policy(str, enum.Enum):
    """Client scheduling policies."""

    SUSTAINABLE = "sustainable"  # Algorithm 1 (the paper's contribution)
    GREEDY = "greedy"            # Benchmark 1: participate on every energy arrival
    WAIT_ALL = "wait_all"        # Benchmark 2: server waits for all clients
    ALWAYS = "always"            # Unconstrained FedAvg upper bound (no energy limit)
    THRESHOLD = "threshold"      # battery-driven: needs battery state (energy.fleet)


def _int(x, like: torch.Tensor | None = None) -> torch.Tensor:
    dev = like.device if like is not None else None
    return torch.as_tensor(x, device=dev).to(torch.int64)


def sustainable_schedule(seed, rnd, E, phase=None, first: int = 0
                         ) -> torch.Tensor:
    """Algorithm 1, lines 5-7: within each window of ``E_i`` consecutive
    global rounds, client ``i`` draws ``J ~ Uniform{0..E_i-1}`` once and
    participates only in round ``window_start + J``.  ``phase`` (N,) shifts
    client i's windows to ``rnd + phase_i`` (the paper's footnote 1).
    ``E`` (and ``phase``) may be a slab of a sharded fleet, clients
    ``[first, first + N)``: each draws by its global index.

    The reference maps one draw per client with ``vmap``; here the clients
    are one batch of keys, which gives the same draws.
    """
    E = _int(E)
    rnd = _int(rnd, E)
    if phase is not None:
        rnd = rnd + _int(phase, E)
    window = torch.div(rnd, E, rounding_mode="floor")
    pos = rnd - window * E
    # the reference's key: PRNGKey(0) + seed = (seed, seed) as uint32 words
    key = (torch.zeros(2, dtype=torch.int64, device=E.device)
           + _int(seed, E)) & prng.MASK32
    clients = torch.arange(first, first + E.shape[0], dtype=torch.int64,
                           device=E.device)
    keys = prng.fold_in(prng.fold_in(key, clients), window)
    j = prng.randint(keys, (), 0, E)
    return (pos == j).to(torch.float32)


def greedy_schedule(seed, rnd, E, phase=None) -> torch.Tensor:
    """Benchmark 1: a client participates as soon as energy arrives, i.e.
    in the first round of each window (windows aligned to ``rnd +
    phase_i`` under per-client start offsets)."""
    del seed
    E = _int(E)
    rnd = _int(rnd, E)
    if phase is not None:
        rnd = rnd + _int(phase, E)
    return (torch.remainder(rnd, E) == 0).to(torch.float32)


def wait_all_schedule(seed, rnd, E) -> torch.Tensor:
    """Benchmark 2: the server waits until all clients have energy; a
    global update happens only every ``E_max`` rounds (everyone
    participates), with all-zero masks in between."""
    del seed
    E = _int(E)
    live = (torch.remainder(_int(rnd, E), E.max()) == 0).to(torch.float32)
    return live.expand(E.shape).clone()


def always_schedule(seed, rnd, E) -> torch.Tensor:
    """Unconstrained FedAvg: every client participates every round."""
    del seed, rnd
    E = torch.as_tensor(E)
    return torch.ones(E.shape, dtype=torch.float32, device=E.device)


_POLICIES = {
    Policy.SUSTAINABLE: sustainable_schedule,
    Policy.GREEDY: greedy_schedule,
    Policy.WAIT_ALL: wait_all_schedule,
    Policy.ALWAYS: always_schedule,
}


def participation_mask(policy, seed, rnd, E, phase=None) -> torch.Tensor:
    """Dispatch: (N,) float32 mask for global round ``rnd`` under
    ``policy``."""
    pol = Policy(policy)
    if pol not in _POLICIES:
        raise ValueError(
            f"policy {pol.value!r} is battery-driven and has no stateless "
            f"(seed, round, E) schedule; battery-gated masks come from "
            f"repro_torch.energy.fleet.fleet_mask")
    if phase is not None:
        if pol in (Policy.SUSTAINABLE, Policy.GREEDY):
            return _POLICIES[pol](seed, rnd, E, phase)
        if pol == Policy.WAIT_ALL:
            # phased arrivals need not ever coincide across clients, so the
            # every-E_max-rounds sync point is undefined
            raise ValueError("wait_all cannot honor per-client phase offsets")
        # ALWAYS: no energy constraint, offsets are irrelevant by definition
    return _POLICIES[pol](seed, rnd, E)


def aggregation_scale(policy, E) -> torch.Tensor:
    """Per-client scaling of the deltas at aggregation: ``E_i`` for
    Algorithm 1 (eq. 12), 1 for the benchmarks (eq. 9)."""
    E = torch.as_tensor(E).to(torch.float32)
    if Policy(policy) == Policy.SUSTAINABLE:
        return E
    return torch.ones_like(E)


def energy_feasible(masks, E, phase=None) -> bool:
    """The physical energy constraint: within every complete window of
    ``E_i`` rounds, client ``i`` participates at most once.  ``masks`` (R,
    N) are rounds 0..R-1; ``phase`` shifts each client's windows (the
    leading partial window is skipped)."""
    masks = torch.as_tensor(masks)
    R, N = masks.shape
    E = torch.as_tensor(E)
    for i in range(N):
        e = int(E[i])
        start = 0 if phase is None else (-int(phase[i])) % e
        full = ((R - start) // e) * e
        if full <= 0:
            continue
        per_window = masks[start:start + full, i].reshape(-1, e).sum(dim=1)
        if bool((per_window > 1).any()):
            return False
    return True


@dataclasses.dataclass(frozen=True)
class EnergyProfile:
    """The paper's §V energy profile: clients split into ``len(taus)``
    equal groups; group k renews every ``taus[k]`` rounds (client i is in
    group ``i mod len(taus)``)."""

    num_clients: int = 40
    taus: tuple[int, ...] = (1, 5, 10, 20)

    def cycles(self, device="cpu") -> torch.Tensor:
        k = torch.arange(self.num_clients, device=device) % len(self.taus)
        return torch.tensor(self.taus, dtype=torch.int32, device=device)[k]
