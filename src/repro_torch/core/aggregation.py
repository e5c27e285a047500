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
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels import ops
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
    return ops.fused_agg_tree(w_global, w_stack, s.contiguous())


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
