"""Valid-weighted fleet telemetry reductions on one device (the part of the
JAX package's ``dist/collectives.py`` the fleet uses).

``weight`` doubles as the validity mask of padded client lanes (0. on
padding, 1. on real clients).  The cross-device forms (``axis_name=``)
wait for ``ROADMAP.md`` Queue 1 item 25.
"""
from __future__ import annotations

import torch


def masked_total(value: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """float32 ``sum_i weight_i * value_i`` over the fleet (0-dim)."""
    return torch.sum(weight.float() * value.float())


def masked_average(value: torch.Tensor, weight: torch.Tensor
                   ) -> torch.Tensor:
    """Weight-normalised fleet mean: ``masked_total / max(sum(weight), 1)``."""
    num = masked_total(value, weight)
    den = masked_total(torch.ones_like(value, dtype=torch.float32), weight)
    return num / torch.clamp_min(den, 1.0)
