"""Cross-client reductions (port of the JAX package's
``dist/collectives.py``), on one device or across the ranks of a mesh.

**The round's client reductions** (`tree_pmean`, `weighted_client_sum`,
`cross_client_delta`, `participation_count`, `masked_mean`: the building
blocks of a round over client groups, DESIGN.md §3.2).  The reference
reduces over a mapped axis, one client a lane, inside ``jax.vmap`` /
``shard_map``; here a rank holds a stack of client rows (leading axis),
sums them in float32, and with ``group`` (a ``torch.distributed`` process
group over the ranks that hold the other rows) all-reduces the sums once
(`all_reduce_sum`: one collective a call).  Without ``group`` the sum is
over the whole stack.  Every rank gets the same full result.
``tree_pmean`` casts back to each leaf's dtype; the delta reductions
return float32 trees, as the reference's do (they feed the float32 server
accumulator).

**Fleet telemetry** (`masked_total`, `masked_average`, `tree_psum`,
`all_reduce_row`): ``weight`` doubles as the validity mask of padded
client lanes (0. on padding, 1. on real clients).  Without ``group`` each
reduction is the single-device sum; with ``group`` the local sums are
all-reduced, as the reference's ``psum`` over a mapped axis does.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.tree import tree_leaves, tree_map

F32 = torch.float32


def all_reduce_sum(tensors: list, group=None) -> list:
    """float32 tensors summed elementwise over the ranks of ``group`` in one
    collective (flattened into one buffer); without ``group``, or over a
    group of one rank, returned as they are."""
    if group is None or dist.get_world_size(group) == 1 or not tensors:
        return list(tensors)
    for t in tensors:
        if t.dtype != F32:
            raise ValueError(f"all_reduce_sum: float32 only, got {t.dtype}")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    outs, at = [], 0
    for t in tensors:
        outs.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return outs


def _client_sums(tree, coeff, group):
    """float32 ``sum_c coeff_c * leaf_c`` over a tree's stacked rows (no
    ``coeff``: the plain sum), all-reduced over ``group``: the tree of
    sums."""
    leaves = tree_leaves(tree)

    def rows(x):
        x = x.to(F32)
        if coeff is None:
            return x.sum(dim=0)
        c = torch.as_tensor(coeff, dtype=F32, device=x.device)
        return (c.reshape((-1,) + (1,) * (x.dim() - 1)) * x).sum(dim=0)

    sums = iter(all_reduce_sum([rows(x) for x in leaves], group))
    return tree_map(lambda _: next(sums), tree)


def tree_pmean(tree, group=None):
    """Leafwise float32 mean over every client row (a leaf's leading axis,
    on every rank of ``group``), cast back to each leaf's dtype; the row
    count travels with the sums."""
    leaves = tree_leaves(tree)
    n = torch.tensor([float(leaves[0].shape[0])], dtype=F32,
                     device=leaves[0].device)
    *sums, n = all_reduce_sum([x.to(F32).sum(dim=0) for x in leaves] + [n],
                              group)
    means = iter(sums)
    return tree_map(lambda x: (next(means) / n[0]).to(x.dtype), tree)


def weighted_client_sum(tree, coeff, group=None):
    """``sum_c coeff_c * leaf_c`` over the client rows (float32 tree):
    ``coeff`` (C_local,) is each row's weight (``alpha_i p_i scale_i`` for
    eqs. 12-13)."""
    return _client_sums(tree, coeff, group)


def cross_client_delta(w_local, w_global, coeff, group=None):
    """Eq. (13)'s numerator, ``sum_c coeff_c * (w_local_c - w_global)``,
    as a float32 delta tree; ``w_local``'s leaves are stacked rows,
    ``w_global``'s the model's."""
    delta = tree_map(lambda wl, wg: wl.to(F32) - wg.to(F32)[None],
                     w_local, w_global)
    return _client_sums(delta, coeff, group)


def participation_count(alpha, group=None) -> torch.Tensor:
    """The round's participants: float32 sum of the alpha bits (C_local,)."""
    return all_reduce_sum([torch.as_tensor(alpha).to(F32).sum()],
                          group)[0]


def masked_mean(value, alpha, group=None) -> torch.Tensor:
    """Participant-weighted mean of a per-client scalar (the local loss):
    ``sum alpha value / max(sum alpha, 1)``, numerator and denominator in
    one collective."""
    a = torch.as_tensor(alpha).to(F32)
    num, den = all_reduce_sum(
        [(a * torch.as_tensor(value).to(F32)).sum(), a.sum()], group)
    return num / torch.clamp_min(den, 1.0)


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
