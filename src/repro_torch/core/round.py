"""The federated round engine, Algorithm 1 (port of the JAX package's
``core/round.py``).

A global round: (1) clients decide participation through the scheduling
policy (``core.scheduling``), (2) scheduled clients run ``T`` local
optimizer steps from the global model (eq. 7), (3) the server aggregates
the scaled deltas (eqs. 12-13) into the new global model.

* **parallel** (``parallel_round``) — every client at once: local models
  are stacked on a leading client axis C, the local step is mapped over it
  with ``torch.func.vmap``, the optimizer runs on the stacked tree, and
  one aggregation ends the round (the ``fused_agg`` kernel, one launch
  per tree).
* **sequential** (``sequential_client_step`` + ``finish_sequential_round``)
  — one client at a time; linearity of eq. (13) makes it equal.
* **replay** (``replay_round``) — the parallel round with the model's
  discrete decisions read out or imposed, for checks that hold one
  float32 evaluation of a round against another (e.g. the card's
  against the CPU's, or float64).

The engine is model-agnostic: it takes ``loss_fn(params, batch, rng)`` and
an ``Optimizer``; params and batches are nested containers of tensors.
Keys are ``repro_torch.prng`` keys, derived exactly as the reference
derives its ``jax.random`` keys.  The reference's ``unroll`` and ``mode``
options steer XLA's scan and its mesh launcher; the port has neither.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable

import torch
from torch.func import grad, grad_and_value, vmap

from repro_torch import prng
from repro_torch.core import aggregation, scheduling
from repro_torch.device import is_dtensor
from repro_torch.optim import Optimizer
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any
LossFn = Callable[[PyTree, PyTree, torch.Tensor], torch.Tensor]


def micro_value_and_grad(loss_fn: LossFn, num_micro: int):
    """(loss, grads) of ``loss_fn``, with gradient accumulation over
    ``num_micro`` splits of the batch's leading dim (float32 sums)."""
    vg = grad_and_value(loss_fn)

    def whole(params, batch, key):
        grads, loss = vg(params, batch, key)
        return loss, grads

    if num_micro <= 1:
        return whole

    def f(params, batch, key):
        for leaf in tree_leaves(batch):
            if leaf.dim() == 0 or leaf.shape[0] % num_micro:
                raise ValueError(
                    f"micro_value_and_grad: batch leading dim "
                    f"{leaf.shape[0] if leaf.dim() else '<scalar>'} is not "
                    f"divisible by micro_batches={num_micro}; pick a "
                    f"micro_batches that divides the per-client batch size")
        acc_l = torch.zeros((), dtype=torch.float32)
        acc_g = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                               device=x.device), params)
        for i in range(num_micro):
            mb = tree_map(lambda b: b.reshape(
                (num_micro, b.shape[0] // num_micro) + b.shape[1:])[i], batch)
            l, g = whole(params, mb, key)
            acc_g = tree_map(lambda a, x: a + x.float() / num_micro, acc_g, g)
            acc_l = acc_l + l / num_micro
        return acc_l, tree_map(lambda g, p: g.to(p.dtype), acc_g, params)

    return f


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """Federated-learning hyperparameters (paper §II/§V notation)."""

    num_clients: int = 40               # N
    local_steps: int = 5                # T
    policy: scheduling.Policy = scheduling.Policy.SUSTAINABLE
    server_lr: float = 1.0
    seed: int = 0
    micro_batches: int = 1              # grad accumulation within a local step
    phase: tuple[int, ...] | None = None  # per-client start offsets (footnote 1)

    def phase_array(self) -> torch.Tensor | None:
        return (None if self.phase is None
                else torch.tensor(self.phase, dtype=torch.int32))


def local_update(loss_fn: LossFn, optimizer: Optimizer, params: PyTree,
                 batches: PyTree, rng: torch.Tensor, num_steps: int,
                 micro_batches: int = 1, step_offset: int = 0):
    """Eq. (7): ``num_steps`` local optimizer steps from ``params`` on
    ``batches`` (leaves with leading axis T, one minibatch per step).

    The optimizer state starts fresh (the FedAvg convention for stateful
    client optimizers).  ``step_offset`` is the global schedule index of
    the first local step (round * T), so Theorem 1's eta_t keeps decaying
    across rounds.  Returns (local params, mean local loss).
    """
    opt_state = optimizer.init(params)
    vg = micro_value_and_grad(loss_fn, micro_batches)
    keys = prng.split(rng, num_steps)
    losses = []
    for t in range(num_steps):
        batch = tree_map(lambda b: b[t], batches)
        loss, grads = vg(params, batch, keys[t])
        params, opt_state = optimizer.update(grads, opt_state, params,
                                             int(step_offset) + t)
        losses.append(loss)
    return params, torch.stack(losses).mean()


def parallel_round(loss_fn: LossFn, optimizer: Optimizer, cfg: FedConfig,
                   w_global: PyTree, client_batches: PyTree, p, E, rnd,
                   rng: torch.Tensor, constrain=None, constrain_opt=None):
    """One global round with every client at once.

    ``client_batches``: leaves (C, T, ...) per-client per-local-step
    minibatches on the params' device; ``p`` (C,) data weights, ``E`` (C,)
    renewal cycles, ``rnd`` the global round index, ``rng`` this round's
    key.  ``constrain`` maps the stacked local models, and
    ``constrain_opt`` (default ``constrain``) the stacked optimizer state,
    after they are made and after every local step
    (`dist.sharding.stacked_constrainer`); both default to the identity.

    All clients compute the local update and the mask zeroes the
    non-participants at aggregation, the equivalent form the paper uses
    for its analysis (eqs. 18-19); a round with an all-zero mask still
    aggregates, with s = 0, and leaves w unchanged.  Returns (new global
    model, {"loss": masked mean local loss, "participants": sum of mask}).
    """
    keys = prng.fold_in(rng, torch.arange(cfg.num_clients))
    step_fn = vmap(micro_value_and_grad(loss_fn, cfg.micro_batches))

    def grad_step(w_stack, batch, ts, rows=slice(None)):
        return step_fn(w_stack, batch, prng.fold_in(keys[rows], ts))

    return _stacked_round(optimizer, cfg, w_global, client_batches, p, E,
                          rnd, grad_step, constrain, constrain_opt)


def replay_round(loss_and_decisions, optimizer: Optimizer, cfg: FedConfig,
                 w_global: PyTree, client_batches: PyTree, p, E, rnd,
                 routes=None, dtype: torch.dtype | None = None):
    """``parallel_round``'s computation for a model whose loss exposes its
    discrete decisions (``loss_and_decisions(params, batch, routes) ->
    (loss, decisions)``, e.g. ``models.cnn.loss_and_decisions``), with
    each local step's decisions read out: (new global model, metrics, the
    decisions of every step, on the CPU).  With ``routes`` (those of
    another evaluation of the same round) every step takes them instead,
    so a float32 round can be replayed elsewhere, or in float64
    (``dtype`` casts the params and the floating batch leaves; the
    optimizer state and the aggregation stay float32).  For checks that
    hold one float32 evaluation against another: without ``routes`` the
    result equals ``parallel_round``'s bit for bit."""
    if cfg.micro_batches > 1:
        raise ValueError("replay_round: micro_batches must be 1")
    if dtype is not None:
        cast = lambda x: x.to(dtype) if x.is_floating_point() else x
        w_global = tree_map(cast, w_global)
        client_batches = tree_map(cast, client_batches)

    def f(params, batch, *rr):
        loss, decisions = loss_and_decisions(params, batch, rr or None)
        return loss, (loss, decisions)

    step_fn = vmap(grad(f, has_aux=True))
    seen = []

    def grad_step(w_stack, batch, ts, rows=slice(None)):
        t = ts - int(rnd) * cfg.local_steps
        leaf = tree_leaves(w_stack)[0]
        rr = () if routes is None else tuple(
            z[rows].to(leaf.device, leaf.dtype) for z in routes[t])
        grads, (loss, decisions) = step_fn(w_stack, batch, *rr)
        seen.append([z.detach().cpu() for z in decisions])
        return loss, grads

    w_new, metrics = _stacked_round(optimizer, cfg, w_global,
                                    client_batches, p, E, rnd, grad_step)
    return w_new, metrics, seen


def _client_split(*trees):
    """``(rows, placements, mesh)`` where every leaf of ``trees`` is a
    DTensor split over the mesh along its leading (client) axis only, and
    replicated over every other mesh dim, all alike: ``rows`` is the
    slice of clients this rank holds.  None otherwise (plain tensors, or
    a stack split over the model axis too)."""
    leaves = [x for tree in trees for x in tree_leaves(tree)]
    if not leaves or not all(is_dtensor(x) for x in leaves):
        return None
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    pl, mesh = leaves[0].placements, leaves[0].device_mesh
    if not any(q == Shard(0) for q in pl) or any(
            q != Shard(0) and not isinstance(q, Replicate) for q in pl) \
            or any(x.placements != pl for x in leaves):
        return None
    shape, offset = compute_local_shape_and_global_offset(
        leaves[0].shape, mesh, pl)
    return slice(offset[0], offset[0] + shape[0]), pl, mesh


def _stacked_dtensor(x, n: int, placements, mesh):
    """This rank's client rows ``x`` as the DTensor of all ``n``."""
    from torch.distributed.tensor import DTensor

    shape = (n,) + tuple(x.shape[1:])
    return DTensor.from_local(x, mesh, placements, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride(), run_check=False)


def _stacked_round(optimizer, cfg, w_global, client_batches, p, E, rnd,
                   grad_step, constrain=None, constrain_opt=None):
    """The round engine around ``grad_step(w_stack, batch, ts, rows) ->
    (losses, grads)``, the local step mapped over the stacked clients
    (``rows`` the slice of clients they are).

    Across ranks (DTensors, `launch.steps.execute`), where the stacks and
    the batches are split over the data axes on their client axis alone,
    each rank steps its own client rows on its local tensors, the
    reference's client group a device; the aggregation then sums the
    groups across ranks.  Any other split (the model axis too) runs the
    step on the DTensors."""
    cst = constrain if constrain is not None else (lambda tree: tree)
    cst_opt = constrain_opt if constrain_opt is not None else cst
    n, T = cfg.num_clients, cfg.local_steps
    rnd = int(rnd)
    mask = scheduling.participation_mask(cfg.policy, cfg.seed, rnd, E,
                                         phase=cfg.phase_array())
    scale = scheduling.aggregation_scale(cfg.policy, E)

    # stacked local models and a fresh local optimizer state (eq. 6)
    w_stack = cst(tree_map(lambda x: x.unsqueeze(0).expand((n,) + x.shape)
                           .clone(), w_global))
    split = _client_split(w_stack, client_batches)
    rows = slice(None)
    if split is not None:
        rows, placed, mesh = split
        w_stack = tree_map(lambda x: x.to_local(), w_stack)
        client_batches = tree_map(lambda x: x.to_local(), client_batches)
        cst = cst_opt = lambda tree: tree
    opt_state = cst_opt(optimizer.init(w_stack))

    losses = []
    for t in range(T):
        ts = rnd * T + t        # global schedule index (Theorem 1's eta_t)
        batch = tree_map(lambda b: b[:, t], client_batches)
        loss, grads = grad_step(w_stack, batch, ts, rows)
        w_stack, opt_state = optimizer.update(grads, opt_state, w_stack, ts)
        w_stack, opt_state = cst(w_stack), cst_opt(opt_state)
        losses.append(loss)
    losses = torch.stack(losses).mean(dim=0)       # (C,) mean local loss
    if split is not None:                # the rows back into the stack
        back = lambda x: _stacked_dtensor(x, n, placed, mesh)
        w_stack, losses = tree_map(back, w_stack), back(losses)

    w_new = aggregation.aggregate(w_global, w_stack, mask, p, scale,
                                  cfg.server_lr)
    mask = mask.to(losses.device)
    metrics = {"loss": (losses * mask).sum() / mask.sum().clamp_min(1.0),
               "participants": mask.sum()}
    return w_new, metrics


def sequential_client_step(loss_fn: LossFn, optimizer: Optimizer,
                           cfg: FedConfig, w_global: PyTree, acc: PyTree,
                           batches: PyTree, p_i, E_i, alpha_i,
                           rng: torch.Tensor, step_offset: int = 0):
    """Sequential mode: ONE client's local round, its scaled delta folded
    into the float32 accumulator ``acc``.  ``finish_sequential_round``
    ends the round.  Returns (acc, local loss)."""
    w_local, loss = local_update(loss_fn, optimizer, w_global, batches, rng,
                                 cfg.local_steps,
                                 micro_batches=cfg.micro_batches,
                                 step_offset=step_offset)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
    if scheduling.Policy(cfg.policy) == scheduling.Policy.SUSTAINABLE:
        scale_i = f32(E_i)                                      # eq. (12)
    else:
        scale_i = f32(1.0)                                      # eq. (9)
    coeff = f32(alpha_i) * f32(p_i) * scale_i
    acc = aggregation.accumulate_client_delta(acc, w_local, w_global, coeff)
    return acc, loss


def finish_sequential_round(cfg: FedConfig, w_global: PyTree, acc: PyTree):
    return aggregation.apply_accumulated(w_global, acc, cfg.server_lr)


def run_rounds(loss_fn: LossFn, optimizer: Optimizer, cfg: FedConfig,
               w0: PyTree, batch_fn: Callable[[int], PyTree], p, E,
               num_rounds: int, rng: torch.Tensor,
               eval_fn: Callable[[PyTree], dict] | None = None,
               eval_every: int = 0, round_fn=None):
    """Host-side driver: ``parallel_round`` for ``num_rounds`` rounds.
    ``batch_fn(r)`` gives round r's (C, T, ...) batches; round r's key is
    ``fold_in(rng, r)``.  Returns (final global model, per-round records)."""
    if round_fn is None:
        round_fn = partial(parallel_round, loss_fn, optimizer, cfg)
    history: list[dict] = []
    w = w0
    for r in range(num_rounds):
        w, metrics = round_fn(w, batch_fn(r), p, E, r, prng.fold_in(rng, r))
        rec = {"round": r, **{k: float(v) for k, v in metrics.items()}}
        if eval_fn is not None and eval_every and (r + 1) % eval_every == 0:
            rec.update({k: float(v) for k, v in eval_fn(w).items()})
        history.append(rec)
    return w, history
