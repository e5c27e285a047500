"""Naive oracles for the kernels (port of the JAX package's ``kernels/ref.py``
for every kernel: attention, the SSD scan, aggregation, the fleet step's
fleet and serve programs)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def mha_reference(q, k, v, *, causal: bool = True, window: int = 0):
    """q, k, v (B, S, H, D), H pre-repeated.  Full-matrix attention."""
    Sq, D = q.shape[1], q.shape[3]
    Skv = k.shape[1]
    scale = 1.0 / (D ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= qpos - kpos < window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def ssd_reference(x, dt, A, Bm, Cm):
    """Sequential SSD recurrence: x (B, S, H, P), dt (B, S, H), A (H,),
    Bm / Cm (B, S, H, N) already repeated from groups to heads.  Returns y
    (B, S, H, P) in x's dtype."""
    Bsz, S, H, P = x.shape
    h = torch.zeros((Bsz, H, P, Bm.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(S):
        dt_t = dt[:, t].float()
        a = torch.exp(dt_t * A.float()[None])                 # (B, H)
        h = h * a[:, :, None, None] + torch.einsum(
            "bh,bhn,bhp->bhpn", dt_t, Bm[:, t].float(), x[:, t].float())
        ys.append(torch.einsum("bhn,bhpn->bhp", Cm[:, t].float(), h))
    return torch.stack(ys, dim=1).to(x.dtype)


def agg_reference(w, w_stack, s):
    """out = w + sum_c s_c (w_c - w);  w (M,), w_stack (C, M), s (C,)."""
    d = w_stack.float() - w.float()[None]
    return (w.float() + torch.einsum("c,cm->m", s.float(), d)).to(w.dtype)


def _masked_total(value, weight):
    return torch.sum(torch.as_tensor(weight).float()
                     * torch.as_tensor(value).float())


def _masked_average(value, weight):
    den = _masked_total(torch.ones_like(torch.as_tensor(value).float()),
                        weight)
    return _masked_total(value, weight) / torch.clamp_min(den, 1.0)


def fleet_step_reference(charge, harvest, round_cost, valid, *, capacity,
                         leak=0.0, want=None, threshold=None):
    """One battery-gated fleet round, written out longhand (independent of
    ``energy.step_ops``).  ``want`` is the policy's pre-gate desire mask
    (the SUSTAINABLE slot draw; None = greedy/always 1s); ``threshold``
    switches to the THRESHOLD gate ``available >= threshold * round_cost``.
    Leak and absorb are ``battery.absorb_fields``: the reference fleet
    scan's arithmetic, with its fused multiply-add.  Returns
    ``(charge_out, mask, stats)``."""
    from repro_torch.energy.battery import absorb_fields

    charge = torch.as_tensor(charge).float()
    harvest = torch.as_tensor(harvest).float()
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
    capacity, leak, round_cost = f32(capacity), f32(leak), f32(round_cost)
    available, aux = absorb_fields(capacity, leak, charge, harvest)
    leaked, overflow = aux["leaked"], aux["overflow"]
    feasible = (available >= round_cost).float()
    if threshold is not None:
        want = (available >= f32(threshold) * round_cost).float()
    elif want is None:
        want = torch.ones_like(available)
    mask = torch.as_tensor(want).float() * feasible
    consumed = mask * round_cost
    charge_out = available - consumed
    depleted = (available < round_cost).float()
    stats = {
        "participants": _masked_total(mask, valid),
        "harvested": _masked_total(harvest, valid),
        "consumed": _masked_total(consumed, valid),
        "leaked": _masked_total(leaked, valid),
        "overflowed": _masked_total(overflow, valid),
        "mean_charge": _masked_average(charge_out, valid),
        "frac_depleted": _masked_average(depleted, valid),
    }
    return charge_out, mask, stats


def serve_step_reference(charge, harvest, requests, valid, *, capacity,
                         leak=0.0, full_req, short_req, full_tokens,
                         short_tokens, hi=None, lo=None, charge_gated=False,
                         train_cost=None, train_want=None):
    """One battery-gated serving epoch, written out longhand (independent of
    ``energy.step_ops``).  ``hi`` / ``lo`` are the admission thresholds
    (None: energy-agnostic, everything FULL); ``charge_gated`` compares them
    with the charge instead of the epoch's offered cost.  ``train_cost``
    adds the competing training drain on the charge left after serving,
    with desire mask ``train_want`` (None: 1s).  The absorb and the serve
    drain are fused multiply-adds, as in the reference's jitted serving
    scan.  Returns ``(charge_out, mode, stats)``."""
    from repro_torch.energy.battery import absorb_fields, fma_f32

    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
    charge, harvest, requests = f32(charge), f32(harvest), f32(requests)
    capacity, leak = f32(capacity), f32(leak)
    full_req, short_req = f32(full_req), f32(short_req)
    available, aux = absorb_fields(capacity, leak, charge, harvest)
    leaked, overflow = aux["leaked"], aux["overflow"]
    if hi is None:
        mode = torch.full(available.shape, 2, dtype=torch.int32)
    elif charge_gated:
        mode = torch.where(available >= f32(hi), 2,
                           torch.where(available >= f32(lo), 1, 0))
    else:
        mode = torch.where(available >= f32(hi) * (requests * full_req), 2,
                           torch.where(available >= f32(lo)
                                       * (requests * short_req), 1, 0))
    mode = mode.to(torch.int32)
    per_req = torch.where(mode == 2, full_req, short_req)
    admitted = torch.where(mode > 0, requests, 0.0)
    served = torch.minimum(admitted, torch.floor(
        available / torch.clamp_min(per_req, 1e-20)))
    consumed_serve = served * per_req
    charge_out = fma_f32(-served, per_req, available)
    served_full = torch.where(mode == 2, served, 0.0)
    served_short = torch.where(mode == 1, served, 0.0)
    shed = torch.where(mode == 0, requests, 0.0)
    missed = admitted - served
    depleted = (available < short_req).float()
    if train_cost is not None:
        want = (torch.ones_like(charge_out) if train_want is None
                else f32(train_want))
        tmask = want * (charge_out >= f32(train_cost)).float()
        consumed_train = tmask * f32(train_cost)
        charge_out = charge_out - consumed_train
    else:
        tmask = torch.zeros_like(charge_out)
        consumed_train = torch.zeros_like(charge_out)
    tokens = served_full * f32(full_tokens) + served_short * f32(short_tokens)
    stats = {
        "participants": _masked_total(tmask, valid),
        "harvested": _masked_total(harvest, valid),
        "consumed": _masked_total(consumed_serve + consumed_train, valid),
        "leaked": _masked_total(leaked, valid),
        "overflowed": _masked_total(overflow, valid),
        "mean_charge": _masked_average(charge_out, valid),
        "frac_depleted": _masked_average(depleted, valid),
        "offered": _masked_total(requests, valid),
        "served_full": _masked_total(served_full, valid),
        "served_short": _masked_total(served_short, valid),
        "shed": _masked_total(shed, valid),
        "deadline_missed": _masked_total(missed, valid),
        "tokens_decoded": _masked_total(tokens, valid),
        "consumed_serve": _masked_total(consumed_serve, valid),
        "consumed_train": _masked_total(consumed_train, valid),
    }
    return charge_out, mode, stats
