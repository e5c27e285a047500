"""Request-arrival processes for the serving fleet (port of the JAX
package's ``serve/traffic.py``).

The same functional contract as `energy.arrivals`, vectorised over the
fleet::

    state0 = traffic.init()                            # (N,) tensors or ()
    requests, state1 = traffic.sample(key, t, state0)  # (N,) float32 counts
    requests, state1 = traffic.sample(key, t, state0, first=f)  # a slab

Randomness is drawn per client (`energy.arrivals.client_uniform`:
``fold_in(key, i)`` and then one scalar draw), so traffic is invariant to
padding the fleet, and a slab of a sharded fleet draws by its clients'
global indices (``first=``, as `energy.arrivals`); Poisson counts go through
`energy.arrivals.truncated_poisson`.

* ``DiurnalPoisson`` — Poisson at a sinusoidal diurnal rate ``base_i (1 +
  swing_i sin(2 pi (t + phase_i) / period))``.
* ``MMPP`` — a two-state (calm / burst) per-client regime chain picks the
  epoch's Poisson rate.
* ``Constant`` — exactly ``rate_i`` requests every epoch.

The uniforms and regimes are bitwise equal to the reference's, and so are
``Constant``'s counts.  The Poisson counts equal the reference's except
where ``u`` lies within a few ulp of a cdf step (``exp``, and for
``DiurnalPoisson`` also ``sin``, are rounded differently).
``TraceTraffic`` (replayed request logs) lives in
`repro_torch.traces.replay`.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import prng
from repro_torch.energy.arrivals import (PyTree, _per_client, client_uniform,
                                         truncated_poisson)


@dataclasses.dataclass(frozen=True, eq=False)
class DiurnalPoisson:
    """Poisson requests at a diurnal rate: ``base_i`` is client i's mean
    requests per epoch over a day, ``swing_i`` in [0, 1] the modulation
    depth, ``phase_i`` its local-time offset in epochs."""

    base: torch.Tensor    # (N,) mean requests per epoch
    swing: torch.Tensor   # (N,) diurnal modulation depth in [0, 1]
    phase: torch.Tensor   # (N,) local-time offset, epochs
    period: int = 24      # epochs per day
    max_requests: int = 16

    @classmethod
    def create(cls, num_clients: int, base=1.0, swing=0.8, phase=0.0,
               period: int = 24, max_requests: int = 16, device=None
               ) -> "DiurnalPoisson":
        return cls(_per_client(base, num_clients, device),
                   _per_client(swing, num_clients, device),
                   _per_client(phase, num_clients, device), period,
                   max_requests)

    @property
    def num_clients(self) -> int:
        return self.base.shape[0]

    def rate_at(self, t) -> torch.Tensor:
        """(N,) mean requests per epoch at epoch ``t``, in float32 as the
        reference computes it."""
        two_pi = torch.tensor(2.0 * math.pi, dtype=torch.float32)
        t = torch.tensor(float(t), dtype=torch.float32)
        ang = two_pi.to(self.phase.device) * (t.to(self.phase.device)
                                              + self.phase) / self.period
        return self.base * (1.0 + self.swing * torch.sin(ang))

    def init(self) -> PyTree:
        return ()

    def sample(self, key, t, state, first: int = 0):
        u = client_uniform(key, self.num_clients, first)
        k = truncated_poisson(u, self.rate_at(t), self.max_requests)
        return k.to(torch.float32), state


@dataclasses.dataclass(frozen=True, eq=False)
class MMPP:
    """Markov-modulated Poisson process: a per-client calm / burst regime
    chain (stay calm with ``p_stay_calm``, bursting with ``p_stay_burst``)
    picks the epoch's Poisson rate.  State: (N,) int32 regime (1 = burst);
    all clients start calm."""

    p_stay_calm: torch.Tensor   # (N,)
    p_stay_burst: torch.Tensor  # (N,)
    calm_rate: torch.Tensor     # (N,) mean requests per calm epoch
    burst_rate: torch.Tensor    # (N,) mean requests per bursting epoch
    max_requests: int = 16

    @classmethod
    def create(cls, num_clients: int, p_stay_calm=0.9, p_stay_burst=0.7,
               calm_rate=0.5, burst_rate=4.0, max_requests: int = 16,
               device=None) -> "MMPP":
        return cls(_per_client(p_stay_calm, num_clients, device),
                   _per_client(p_stay_burst, num_clients, device),
                   _per_client(calm_rate, num_clients, device),
                   _per_client(burst_rate, num_clients, device),
                   max_requests)

    @property
    def num_clients(self) -> int:
        return self.calm_rate.shape[0]

    def init(self) -> PyTree:
        return torch.zeros((self.num_clients,), dtype=torch.int32,
                           device=self.calm_rate.device)

    def sample(self, key, t, state, first: int = 0):
        del t
        k1, k2 = prng.split(key)
        u = client_uniform(k1, self.num_clients, first)
        is_burst = state == 1
        burst_next = torch.where(is_burst, u < self.p_stay_burst,
                                 u >= self.p_stay_calm)
        rate = torch.where(burst_next, self.burst_rate, self.calm_rate)
        k = truncated_poisson(client_uniform(k2, self.num_clients, first),
                              rate, self.max_requests)
        return k.to(torch.float32), burst_next.to(torch.int32)


@dataclasses.dataclass(frozen=True, eq=False)
class Constant:
    """Exactly ``rate_i`` requests every epoch (no randomness)."""

    rate: torch.Tensor  # (N,) requests per epoch

    @classmethod
    def create(cls, num_clients: int, rate=1.0, device=None) -> "Constant":
        return cls(_per_client(rate, num_clients, device))

    @property
    def num_clients(self) -> int:
        return self.rate.shape[0]

    def init(self) -> PyTree:
        return ()

    def sample(self, key, t, state, first: int = 0):
        del key, t, first
        return self.rate, state
