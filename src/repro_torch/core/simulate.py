"""Host-side faithful simulation of Algorithm 1 and the paper's benchmarks
(port of the JAX package's ``core/simulate.py``).

Unlike the client-stacked round engine (``round.py``), this driver computes
local updates ONLY for scheduled participants — exactly the paper's
Algorithm 1 control flow.  Per round r:

  alpha   = participation_mask(policy, seed, r, E, phase)
  for i with alpha_i = 1:   w_i <- T local optimizer steps from w   (eq. 7)
  w <- w + sum_i alpha_i p_i scale_i (w_i - w)                      (eqs. 9/12/13)

The second scheduling source is the energy closed loop
(``energy=energy.fleet.EnergyLoop(...)``): each round's mask comes from
stochastic harvests gated by battery state, and the history gains the
loop's telemetry as ``energy_*`` keys.  With a server controller attached
(``EnergyLoop(..., controller=energy.control.ServerController(...))``)
each round reads the controller's local-step count ``T`` and per-client
cycles ``E`` (``ctrl_T`` / ``ctrl_E_mean`` in the history) and feeds the
round's telemetry back; the learning-rate schedule's offset advances by
the realised cumulative local steps.
"""
from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import aggregation, scheduling
from repro_torch.core.round import FedConfig, local_update
from repro_torch.optim import Optimizer

PyTree = Any

def _accepts_num_steps(batch_fn: Callable) -> bool:
    """True if ``batch_fn`` can take a third (num_steps) positional arg —
    decided once from its signature, so a provider's contract is stable."""
    try:
        params = list(inspect.signature(batch_fn).parameters.values())
    except (TypeError, ValueError):   # builtins / C callables: assume legacy
        return False
    if any(p.kind is inspect.Parameter.VAR_POSITIONAL for p in params):
        return True
    positional = [p for p in params if p.kind in
                  (inspect.Parameter.POSITIONAL_ONLY,
                   inspect.Parameter.POSITIONAL_OR_KEYWORD)]
    return len(positional) >= 3


@dataclasses.dataclass
class SimResult:
    params: PyTree
    history: list[dict]

    def curve(self, key: str) -> tuple[np.ndarray, np.ndarray]:
        xs = [h["round"] for h in self.history if key in h]
        ys = [h[key] for h in self.history if key in h]
        return np.asarray(xs), np.asarray(ys)


def simulate(loss_fn: Callable, optimizer: Optimizer, cfg: FedConfig,
             w0: PyTree, batch_fn: Callable, p, E, num_rounds: int,
             rng: torch.Tensor, eval_fn: Callable[[PyTree], dict] | None = None,
             eval_every: int = 0, verbose: bool = False,
             energy=None) -> SimResult:
    """Run ``num_rounds`` global rounds of Algorithm 1 / a benchmark policy.

    ``batch_fn(round, client)`` gives that client's (T, B, ...) batches; a
    provider that accepts a third positional argument is called as
    ``(round, client, num_steps)``.  Client i's key in round r is
    ``fold_in(fold_in(rng, r), i)``.  ``energy`` (an
    ``energy.fleet.EnergyLoop``) draws the masks from realised harvests;
    its ``controller``, if any, sets each round's T and E.
    """
    E = np.asarray(E)
    p = np.asarray(p)
    phase = cfg.phase_array()
    ctrl = getattr(energy, "controller", None) if energy is not None else None
    if energy is not None:
        energy.reset()
    batch_takes_steps = _accepts_num_steps(batch_fn)
    static_scale = scheduling.aggregation_scale(cfg.policy,
                                                torch.as_tensor(E)).numpy()

    w = w0
    history: list[dict] = []
    t0 = time.time()
    local_steps_done = 0   # realised cumulative local steps (LR offset)
    for r in range(num_rounds):
        T = ctrl.T if ctrl is not None else cfg.local_steps
        E_r = (np.asarray(ctrl.client_E(cfg.num_clients)) if ctrl is not None
               else E)
        scale = (scheduling.aggregation_scale(
            cfg.policy, torch.as_tensor(E_r)).numpy() if ctrl is not None
            else static_scale)
        if energy is not None:
            mask, estats = energy.step(cfg.policy, cfg.seed, r, E_r, T,
                                       phase=phase)
        else:
            mask, estats = scheduling.participation_mask(
                cfg.policy, cfg.seed, r, torch.as_tensor(E_r),
                phase=phase).numpy(), None
        parts = np.nonzero(mask)[0]
        rec = {"round": r, "participants": int(len(parts))}
        if estats is not None:
            rec.update({f"energy_{k}": v for k, v in estats.items()})
        if ctrl is not None:
            rec["ctrl_T"] = T
            rec["ctrl_E_mean"] = float(E_r.mean())
        if len(parts):
            acc = aggregation.zeros_like_fp32(w)
            losses = []
            for i in parts:
                key = prng.fold_in(prng.fold_in(rng, r), int(i))
                batch = (batch_fn(r, int(i), T) if batch_takes_steps
                         else batch_fn(r, int(i)))
                w_i, loss = local_update(loss_fn, optimizer, w, batch, key, T,
                                         micro_batches=cfg.micro_batches,
                                         step_offset=local_steps_done)
                coeff = float(p[i] * scale[i])
                acc = aggregation.accumulate_client_delta(acc, w_i, w, coeff)
                losses.append(float(loss))
            w = aggregation.apply_accumulated(w, acc, cfg.server_lr)
            rec["loss"] = float(np.mean(losses))
        local_steps_done += T
        if ctrl is not None and estats is not None:
            ctrl.update(estats, cfg.num_clients)
        if eval_fn is not None and eval_every and \
                ((r + 1) % eval_every == 0 or r == num_rounds - 1):
            rec.update({k: float(v) for k, v in eval_fn(w).items()})
        history.append(rec)
        if verbose and (r % max(1, num_rounds // 20) == 0
                        or r == num_rounds - 1):
            msg = " ".join(f"{k}={v:.4f}" for k, v in rec.items()
                           if isinstance(v, float))
            print(f"[{cfg.policy}] round {r:4d} |S|={rec['participants']:2d} "
                  f"{msg} ({time.time()-t0:.0f}s)", flush=True)
    return SimResult(w, history)
