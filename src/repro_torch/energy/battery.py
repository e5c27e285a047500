"""Vectorised battery dynamics for the energy-harvesting fleet (port of the
JAX package's ``energy/battery.py``).

Battery state is one ``(N,) float32`` tensor of stored joules.  Per-round
order of operations (the fleet contract):

1. **leak** — a fraction ``leak`` of the stored charge is lost;
2. **absorb** — the round's harvest is added and clipped to ``capacity``;
   the clipped excess is *overflow*;
3. the scheduling policy observes the post-absorb *available* charge;
4. **drain** — participants' round cost is subtracted (the fleet only
   drains what is available, so charge never goes negative).

Energy conservation, exact up to float32 rounding:

    harvest - consumed - leaked - overflow == charge' - charge

Parity with the reference: in the reference's jitted fleet scan, XLA's CPU
backend fuses ``charge - charge * leak`` into one fused multiply-add, so
its ``available`` is ``fma(-charge, leak, charge) + harvest``; `absorb`
makes the same contraction (`fma_f32`) and no other, and agrees with the
scan bit for bit.  ``leaked`` stays the rounded product.  (Jitted on its
own with a per-client ``leak``, the reference's ``absorb`` keeps the
product in a separate pass and does not contract; its fleet scan does.)
"""
from __future__ import annotations

import dataclasses

import torch


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add does.

    The product of two float32 values is exact in float64.  The sum is
    rounded to float64 with round-to-odd (TwoSum gives its exact error;
    an inexact sum with an even last bit steps one ulp toward the exact
    value), and a round-to-odd float64 (53 >= 24 + 2 bits) rounds to the
    correctly rounded float32.  So this equals ``fmaf`` on any finite
    inputs, without a double-rounding case."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    bits = s.contiguous().view(torch.int64)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    fix = (err != 0) & ((bits & 1) == 0)
    s = torch.where(fix, (bits + step).view(torch.float64), s)
    return s.float()


def as_field(x, device=None) -> torch.Tensor:
    """A battery field (float, numpy array or tensor) as a float32 tensor:
    0-dim for a scalar, (N,) for a per-client field."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True, eq=False)
class BatteryConfig:
    """Fleet battery parameters; each field is a scalar or an (N,)
    array/tensor."""

    capacity: float | torch.Tensor = 1.0     # joules
    leak: float | torch.Tensor = 0.0         # fraction of stored charge lost/round
    init_charge: float | torch.Tensor = 0.0  # joules at round 0

    FIELDS = ("capacity", "leak", "init_charge")

    def fields(self, device=None) -> dict[str, torch.Tensor]:
        """``{field: float32 tensor on device}`` (0-dim or (N,))."""
        return {f: as_field(getattr(self, f), device) for f in self.FIELDS}

    def init(self, num_clients: int, device=None) -> torch.Tensor:
        """(N,) float32 initial charge, clipped into [0, capacity]."""
        f = self.fields(device)
        c = f["init_charge"].expand(num_clients)
        return torch.minimum(torch.clamp_min(c, 0.0),
                             f["capacity"].expand(num_clients))


def absorb(cfg: BatteryConfig, charge: torch.Tensor, harvest: torch.Tensor
           ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Steps 1-2: leak, then harvest and clip.  Returns ``(available,
    aux)`` with per-client ``leaked`` and ``overflow`` joules."""
    f = cfg.fields(charge.device)
    return absorb_fields(f["capacity"], f["leak"], charge, harvest)


def absorb_fields(capacity, leak, charge, harvest):
    """`absorb` on the battery's float32 fields."""
    charge = charge.float()
    harvest = harvest.float()
    leaked = charge * leak
    pre = fma_f32(-charge, leak, charge) + harvest
    overflow = torch.clamp_min(pre - capacity, 0.0)
    available = torch.minimum(pre, capacity)
    return available, {"leaked": leaked, "overflow": overflow}


def drain(available: torch.Tensor, consume) -> torch.Tensor:
    """Step 4.  ``consume`` must not exceed ``available``; no clamp is
    applied, so a violation shows as a negative charge."""
    return available - torch.as_tensor(consume, dtype=torch.float32,
                                       device=available.device)


def step(cfg: BatteryConfig, charge: torch.Tensor, harvest: torch.Tensor,
         consume) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One full battery round: absorb then drain.  Returns (charge', aux)."""
    available, aux = absorb(cfg, charge, harvest)
    return drain(available, consume), aux
