"""Minimal optimizers on trees of tensors (port of the JAX package's
``optim/optimizers.py``): SGD, SGD with momentum, and Adam.

``Optimizer(init, update)``: ``update(grads, state, params, step) ->
(new_params, new_state)`` is functional (new tensors, nothing updated in
place), so it applies unchanged to client-stacked trees.  The state is
float32 whatever the params' dtype; new params are cast back to each
param's dtype.  ``step`` is the global schedule index handed to the
learning-rate schedule.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.device import is_dtensor
from repro_torch.optim.schedules import constant
from repro_torch.tree import tree_map

PyTree = Any
Schedule = Callable[[Any], torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree, Any], tuple[PyTree, PyTree]]
    # update(grads, state, params, step) -> (new_params, new_state)


_CHUNK = 1 << 26             # elements of a leaf a chunk of an update takes


def _chunked(fn, *leaves):
    """``fn`` (elementwise over leaves of one shape, returning a tuple of
    tensors of that shape) in chunks of the leading axis of at most about
    ``_CHUNK`` elements, written into new tensors: the same values as one
    call, with the float32 temporaries of one chunk alive at a time (a
    layer-stacked leaf can hold half a model).  On DTensors (a step run
    across ranks) each rank chunks its local tensors, every leaf placed
    as the first DTensor among them (the update is elementwise), and the
    outputs come back as DTensors so placed."""
    dleaf = next((x for x in leaves if is_dtensor(x)), None)
    if dleaf is not None:
        return _chunked_local(fn, dleaf, leaves)
    lead = leaves[0]
    n = min(-(-lead.numel() // _CHUNK), lead.shape[0] if lead.dim() else 1)
    if n <= 1:
        return fn(*leaves)
    edges = [round(i * lead.shape[0] / n) for i in range(n + 1)]
    outs = None
    for a, b in zip(edges, edges[1:]):
        part = fn(*(x[a:b] for x in leaves))
        if outs is None:
            outs = tuple(lead.new_empty(lead.shape, dtype=t.dtype)
                         for t in part)
        for o, t in zip(outs, part):
            o[a:b] = t
    return outs


def _chunked_local(fn, dleaf, leaves):
    """`_chunked` on each rank's local tensors, placed as ``dleaf``; a plain
    leaf among them is taken as replicated (the same on every rank)."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh, pl = dleaf.device_mesh, dleaf.placements

    def local(x):
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return x.redistribute(mesh, pl).to_local()

    outs = _chunked(fn, *(local(x) for x in leaves))
    return tuple(DTensor.from_local(o, mesh, pl, shape=dleaf.shape,
                                    stride=dleaf.stride(), run_check=False)
                 for o in outs)


def _zeros_f32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def sgd(lr: Schedule | float, momentum: float = 0.0) -> Optimizer:
    sched = lr if callable(lr) else constant(lr)

    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(_zeros_f32, params)

    def update(grads, state, params, step):
        eta = sched(step)
        if momentum == 0.0:
            return tree_map(lambda p, g: (p.float() - eta * g.float()).to(
                p.dtype), params, grads), state
        new_m = tree_map(lambda m, g: momentum * m + g.float(), state, grads)
        return tree_map(lambda p, m: (p.float() - eta * m).to(p.dtype),
                        params, new_m), new_m

    return Optimizer(init, update)


def adam(lr: Schedule | float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    sched = lr if callable(lr) else constant(lr)

    def init(params):
        # "t" counts steps since init: the bias correction tracks the moment
        # buffers (fresh every round, the FedAvg convention), while ``step``
        # is the global schedule index, which keeps decaying across rounds
        return {"m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params),
                "t": torch.zeros((), dtype=torch.float32)}

    def update(grads, state, params, step):
        step_f = state["t"] + 1.0
        eta = sched(step)
        # float32 powers of a float32 counter, as jnp computes them
        mhat_scale = 1.0 / (1 - torch.pow(torch.tensor(b1), step_f))
        vhat_scale = 1.0 / (1 - torch.pow(torch.tensor(b2), step_f))

        def leaf(p, g, m, v):
            m = b1 * m + (1 - b1) * g.float()
            v = b2 * v + (1 - b2) * torch.square(g.float())
            new = p.float() - eta * (m * mhat_scale) / (
                torch.sqrt(v * vhat_scale) + eps)
            return new.to(p.dtype), m, v

        out = tree_map(lambda *x: _chunked(leaf, *x), params, grads,
                       state["m"], state["v"])
        pick = lambda i: tree_map(lambda _, o: o[i], params, out)
        return pick(0), {"m": pick(1), "v": pick(2), "t": step_f}

    return Optimizer(init, update)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adam"          # adam | sgd | sgd_momentum
    lr: float = 1e-3
    momentum: float = 0.9
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


def make_optimizer(cfg: OptimizerConfig,
                   schedule: Schedule | None = None) -> Optimizer:
    lr = schedule if schedule is not None else cfg.lr
    if cfg.name == "adam":
        return adam(lr, cfg.b1, cfg.b2, cfg.eps)
    if cfg.name == "sgd":
        return sgd(lr, 0.0)
    if cfg.name == "sgd_momentum":
        return sgd(lr, cfg.momentum)
    raise ValueError(f"unknown optimizer {cfg.name!r}")
