"""Server aggregation rules (port of the JAX package's
``core/aggregation.py``; Güler & Yener eqs. 9, 12, 13).

* ``scaled_delta_aggregate`` — Algorithm 1 / eq. (13):
  ``w+ = w + sum_i alpha_i p_i E_i (w_i - w)`` (the ``E_i`` factor is eq. 12).
* ``fedavg_aggregate`` — FedAvg / eq. (9) with absent clients frozen at w:
  ``w+ = w + sum_i alpha_i p_i (w_i - w)``.

Both operate on client-stacked trees (leading axis C).  Unlike the
reference, whose TPU path is plain ``jnp``, ``aggregate`` goes through the
``fused_agg`` kernel (``kernels.ops.fused_agg_tree``, one launch per tree)
with ``s = server_lr * mask * p * scale``: on CUDA tensors it launches the
Hopper kernel, on CPU tensors it takes the kernel's plain version.  The
sequential-mode helpers stay plain float32 PyTorch, as in the reference.

**Across ranks** (a round run by `launch.steps.execute`: the stacked
leaves are DTensors, their client axis split over the mesh's data axes)
each rank launches the kernel on its own client rows and its own rows of
``s`` (one launch a dtype a rank), takes its part as a float32 difference
from ``w`` (the kernel's ``w (1 - sum s)`` term is the rank's own, so the
outputs themselves cannot be summed), and one float32 all-reduce a dtype
carries the sum across ranks; ``w`` plus the sum is rounded once, so
every rank ends with the same new global model, within
`sharded_tolerance` of the host-local one.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import is_dtensor
from repro_torch.dist import collectives
from repro_torch.kernels import ops
from repro_torch.kernels.fused_agg import U32, kernel_tolerance
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


def aggregate(w_global: PyTree, w_stack: PyTree, mask, p, scale,
              server_lr: float = 1.0) -> PyTree:
    """w+ = w + server_lr * sum_c mask_c * p_c * scale_c * (w_stack_c - w).

    Args:
      w_global: current global model (nested dict of tensors).
      w_stack: stacked local models, each leaf with leading client axis C.
      mask: (C,) participation mask alpha.
      p: (C,) data weights p_i = D_i / D (sum to 1 over the population).
      scale: (C,) per-client delta scaling (E_i for Algorithm 1, else 1).
      server_lr: server step size on the aggregated delta (paper: 1).

    Returns the updated global model in ``w_global``'s dtypes.
    """
    dev = tree_leaves(w_global)[0].device
    f32 = lambda x: torch.as_tensor(x).to(dtype=torch.float32, device=dev)
    s = server_lr * (f32(mask) * f32(p) * f32(scale))
    if is_dtensor(tree_leaves(w_stack)[0]):
        return _aggregate_sharded(w_global, w_stack, s)
    return ops.fused_agg_tree(w_global, w_stack, s.contiguous())


def _aggregate_sharded(w_global, w_stack, s):
    """`aggregate` on DTensor stacks: each rank's client rows through the
    kernel, the float32 differences from w all-reduced over the mesh dims
    that split the client axis (one collective a dtype), w plus the sum
    rounded once; each new leaf placed as ``w_global``'s."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    stacks = tree_leaves(w_stack)
    mesh = stacks[0].device_mesh
    split = [i for i, pl in enumerate(stacks[0].placements)
             if pl == Shard(0)]
    ws, w_locals, st_locals, w_pls = [], [], [], []
    for w, st in zip(tree_leaves(w_global), stacks):
        if [i for i, pl in enumerate(st.placements) if pl == Shard(0)] \
                != split:
            raise ValueError(f"aggregate: the stacked leaves split their "
                             f"client axis over different mesh dims "
                             f"({st.placements} vs {stacks[0].placements})")
        # w as its stack is placed, less the client axis
        w_pl = [Shard(pl.dim - 1) if isinstance(pl, Shard) and pl.dim > 0
                else Replicate() for pl in st.placements]
        if not isinstance(w, DTensor):
            w = DTensor.from_local(w, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        ws.append(w)
        w_pls.append(w_pl)
        w_locals.append(w.redistribute(mesh, w_pl).to_local())
        st_locals.append(st.to_local())
    shape, offset = compute_local_shape_and_global_offset(
        stacks[0].shape, mesh, stacks[0].placements)
    s_local = s[offset[0]:offset[0] + shape[0]].contiguous()
    outs = ops.fused_agg_tree(w_locals, st_locals, s_local)
    if split:
        group = (mesh.get_group(split[0]) if len(split) == 1 else
                 mesh[tuple(mesh.mesh_dim_names[i] for i in split)]
                 ._flatten().get_group())
        for dtype in dict.fromkeys(o.dtype for o in outs):
            at = [i for i, o in enumerate(outs) if o.dtype == dtype]
            sums = collectives.all_reduce_sum(
                [outs[i].float() - w_locals[i].float() for i in at], group)
            for i, d in zip(at, sums):
                outs[i] = (w_locals[i].float() + d).to(dtype)
    new = iter(DTensor.from_local(o, mesh, pl, shape=w.shape,
                                  stride=w.stride(), run_check=False)
               .redistribute(mesh, w.placements)
               for o, pl, w in zip(outs, w_pls, ws))
    return tree_map(lambda _: next(new), w_global)


def sharded_tolerance(w, w_stack, s, ranks: int, want):
    """Per-element bound on |`aggregate` over ``ranks`` client groups -
    the host-local one| for one leaf (``w`` (...), ``w_stack`` (C, ...),
    ``want`` the host-local result), on full tensors.

    The host-local kernel and each rank's launch are both within
    ``kernel_tolerance`` of the exact value (with C terms: a rank's own
    sums are shorter).  Beyond that the sharded path takes each rank's
    part as a float32 difference (one rounding), sums ``ranks`` of them
    (``ranks`` - 1 roundings) and adds w (one), each within u = 2^-24 of
    the scale the kernel's bound uses (|w| (1 + sum|s|) + sum_c |s_c|
    |w_c|, which bounds every partial result); so 2 (ranks + 1) u of it
    more.  A bfloat16 leaf's rank outputs are rounded to bf16 before the
    difference is taken: half a bf16 ulp of that scale a rank more
    (``ranks`` = 2: one ulp)."""
    w, st = w.reshape(-1), w_stack.reshape(w_stack.shape[0], -1)
    a = s.float().abs()
    scale = (w.float().abs() * (1.0 + a.sum())
             + (a[:, None] * st.float().abs()).sum(dim=0))
    tol = (kernel_tolerance(w, st, s, want.reshape(-1))
           + 2.0 * (ranks + 1) * U32 * scale)
    if want.dtype == torch.bfloat16:
        _, e = torch.frexp(scale.clamp_min(2.0 ** -126))
        tol = tol + ranks * torch.ldexp(torch.ones_like(scale), e - 9)
    return tol.reshape(want.shape)


def scaled_delta_aggregate(w_global, w_stack, mask, p, E,
                           server_lr: float = 1.0):
    """Algorithm 1 (eqs. 12-13): deltas scaled by the energy renewal cycle."""
    return aggregate(w_global, w_stack, mask, p,
                     torch.as_tensor(E).to(torch.float32), server_lr)


def fedavg_aggregate(w_global, w_stack, mask, p, server_lr: float = 1.0):
    """Eq. (9) with absent clients frozen at w: unscaled aggregation."""
    ones = torch.ones(torch.as_tensor(mask).shape, dtype=torch.float32)
    return aggregate(w_global, w_stack, mask, p, ones, server_lr)


def accumulate_client_delta(acc: PyTree, w_local: PyTree, w_global: PyTree,
                            coeff) -> PyTree:
    """Sequential mode: acc += coeff * (w_local - w_global), in float32;
    ``coeff = alpha_i * p_i * scale_i`` is a scalar."""
    return tree_map(lambda a, wl, wg: a + coeff * (wl.float() - wg.float()),
                    acc, w_local, w_global)


def apply_accumulated(w_global: PyTree, acc: PyTree,
                      server_lr: float = 1.0) -> PyTree:
    """Sequential-mode server apply: w+ = w + server_lr * acc."""
    return tree_map(lambda wg, a: (wg.float() + server_lr * a).to(wg.dtype),
                    w_global, acc)


def zeros_like_fp32(tree: PyTree) -> PyTree:
    """float32 zero accumulator matching a param tree's shapes."""
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), tree)
