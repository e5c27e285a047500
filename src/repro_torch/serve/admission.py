"""Battery-gated admission policies: serve / degrade to a short answer /
shed (port of the JAX package's ``serve/admission.py``).

A policy maps each client's post-absorb *available* charge and the epoch's
offered load to a mode in {`qos.FULL`, `qos.DEGRADED`, `qos.SHED}`.  The
simulator's physical gate applies whatever the policy decides: a client
serves at most ``floor(available / per_request_cost)`` requests, so an
admission mistake shows as deadline misses, never as negative charge.
Thresholds are float32 tensors, (N,) or a scalar expanded to (N,).
``scaled(factor)`` applies the server controller's admission knob
(`energy.control.AdmissionRule`).

* ``EnergyAgnostic`` — always serve full; the baseline.
* ``BatteryGated`` — relative to this epoch's offered cost: full when
  ``available >= hi *`` (the epoch's full-grade cost), degraded when
  ``available >= lo *`` (its short-grade cost), else shed.
* ``ChargeGated`` — absolute joule thresholds, independent of the load.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.energy.arrivals import _per_client
from repro_torch.serve.qos import DEGRADED, FULL, SHED


def _modes(full_ok: torch.Tensor, short_ok: torch.Tensor) -> torch.Tensor:
    """(N,) int32 modes from the two admission predicates."""
    return torch.where(full_ok, FULL, torch.where(short_ok, DEGRADED, SHED)
                       ).to(torch.int32)


def _scale(t: torch.Tensor, factor) -> torch.Tensor:
    return t * torch.as_tensor(factor, dtype=torch.float32, device=t.device)


@dataclasses.dataclass(frozen=True, eq=False)
class EnergyAgnostic:
    """Serve everything at full grade; the battery is someone else's
    problem."""

    FIELDS = ()
    KIND = "agnostic"

    def decide(self, available, epoch_full_cost, epoch_short_cost):
        del epoch_full_cost, epoch_short_cost
        return torch.full(available.shape, FULL, dtype=torch.int32,
                          device=available.device)

    def scaled(self, factor) -> "EnergyAgnostic":
        del factor
        return self


@dataclasses.dataclass(frozen=True, eq=False)
class BatteryGated:
    """Admission relative to this epoch's offered cost: ``hi`` / ``lo``
    are margins over the epoch's full-grade / short-grade cost."""

    hi: torch.Tensor  # (N,) full-service margin x epoch full cost
    lo: torch.Tensor  # (N,) degraded-service margin x epoch short cost

    FIELDS = ("hi", "lo")
    KIND = "battery_gated"

    @classmethod
    def create(cls, num_clients: int, hi=1.0, lo=1.0, device=None
               ) -> "BatteryGated":
        return cls(_per_client(hi, num_clients, device),
                   _per_client(lo, num_clients, device))

    def decide(self, available, epoch_full_cost, epoch_short_cost):
        return _modes(available >= self.hi * epoch_full_cost,
                      available >= self.lo * epoch_short_cost)

    def scaled(self, factor) -> "BatteryGated":
        """Thresholds scaled by the controller's admission knob."""
        return dataclasses.replace(self, hi=_scale(self.hi, factor),
                                   lo=_scale(self.lo, factor))


@dataclasses.dataclass(frozen=True, eq=False)
class ChargeGated:
    """Absolute state-of-charge thresholds (joules), load-oblivious."""

    hi: torch.Tensor  # (N,) serve full above this charge
    lo: torch.Tensor  # (N,) degrade above this charge, shed below

    FIELDS = ("hi", "lo")
    KIND = "charge_gated"

    @classmethod
    def create(cls, num_clients: int, hi=1.0, lo=0.25, device=None
               ) -> "ChargeGated":
        return cls(_per_client(hi, num_clients, device),
                   _per_client(lo, num_clients, device))

    def decide(self, available, epoch_full_cost, epoch_short_cost):
        del epoch_full_cost, epoch_short_cost
        return _modes(available >= self.hi, available >= self.lo)

    def scaled(self, factor) -> "ChargeGated":
        return dataclasses.replace(self, hi=_scale(self.hi, factor),
                                   lo=_scale(self.lo, factor))
