"""Valid-weighted fleet telemetry reductions (the part of the JAX package's
``dist/collectives.py`` the fleet uses), on one device or across the
ranks of a sharded fleet.

``weight`` doubles as the validity mask of padded client lanes (0. on
padding, 1. on real clients).  Without ``group`` each reduction is the
single-device sum.  With ``group`` (a ``torch.distributed`` process group
over the ranks that each hold a slab of the fleet) the local sums are
all-reduced, as the reference's ``psum`` over a mapped axis does.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map


def masked_total(value: torch.Tensor, weight: torch.Tensor,
                 group=None) -> torch.Tensor:
    """float32 ``sum_i weight_i * value_i`` over the fleet (0-dim); over
    every rank's slab with ``group``."""
    s = torch.sum(weight.float() * value.float())
    if group is not None:
        dist.all_reduce(s, group=group)
    return s


def masked_average(value: torch.Tensor, weight: torch.Tensor,
                   group=None) -> torch.Tensor:
    """Weight-normalised fleet mean: ``masked_total / max(sum(weight), 1)``.
    With ``group`` the numerator and the denominator are all-reduced, then
    divided once."""
    num = masked_total(value, weight, group)
    den = masked_total(torch.ones_like(value, dtype=torch.float32), weight,
                       group)
    return num / torch.clamp_min(den, 1.0)


def tree_psum(tree, group=None):
    """Leafwise float32 sum over the ranks of ``group``, cast back to each
    leaf's dtype; without ``group`` (one device) each leaf round-trips
    through float32 unchanged in value."""
    def leaf(x):
        y = x.float().clone()
        if group is not None:
            dist.all_reduce(y, group=group)
        return y.to(x.dtype)

    return tree_map(leaf, tree)


def all_reduce_row(row: torch.Tensor, group) -> torch.Tensor:
    """Sum a round's float64 row of pre-average sums (`energy.step_ops.
    stat_row`, or a kernel's) over the ranks of ``group``, in place: one
    collective a round.  float64 holds each rank's float32 sums and
    integer counts exactly, so the counts stay exact integers."""
    if row.dtype != torch.float64:
        raise ValueError(f"all_reduce_row: the row must be float64, got "
                         f"{row.dtype}")
    dist.all_reduce(row, group=group)
    return row
