"""Mixture-of-Experts FFN (Mixtral / OLMoE style): a softmax top-k router,
SwiGLU experts and the Switch load-balance auxiliary loss (port of the JAX
package's ``models/moe.py``).

Four compute modes, the reference's (``cfg.moe_mode``):

* ``dense`` — every token runs every expert, gated by the renormalised
  top-k weights: dropless, (E/k)x the active FLOPs;
* ``dispatch`` — GShard capacity per batch row, ``C = max(1, round(k S / E
  cf))``, through one-hot dispatch and combine tensors; tokens past an
  expert's capacity drop to the residual path;
* ``sorted`` — the assignments of all ``N = B S`` tokens sorted by expert
  (a stable sort, so the first ``round(k N / E cf)`` of each expert in
  token order keep their place, as ``jnp.argsort`` keeps them), gathered
  into an (E, cap, d) buffer, run as E batched expert matmuls and combined
  back with the gate weights;
* ``sorted_local`` — ``sorted`` within each batch row, the aux averaged.

Every mode is written with gathers, masks and out-of-place ops, so that it
runs under ``torch.func.vmap(grad(...))`` (the client-stacked round):
``sorted`` builds its expert buffer as a gather from each expert's first
sorted assignment, and folds the k outputs of a token back through the
inverse permutation, where the reference scatters.  The top-k is a stable
descending sort, so exact ties go to the lower expert index, as
``jax.lax.top_k`` breaks them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dtype_of, init_normal

MODES = ("dense", "dispatch", "sorted", "sorted_local")


def moe_init(cfg: ModelConfig, gen: torch.Generator, shape_prefix=()):
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    dt, pre = dtype_of(cfg), tuple(shape_prefix)
    return {"router": init_normal(gen, pre + (d, E), (1 / d) ** 0.5,
                                  torch.float32),
            "wi": init_normal(gen, pre + (E, d, 2 * ff), (2 / d) ** 0.5, dt),
            "wo": init_normal(gen, pre + (E, ff, d), (2 / ff) ** 0.5, dt)}


def _one_hot(idx, n: int):
    """float32 one-hot of an integer tensor; indices outside [0, n) give a
    zero row, as ``jax.nn.one_hot``."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _route(cfg: ModelConfig, p, x, idx=None):
    """Router logits -> (top-k weights (B, S, k), top-k expert ids (B, S,
    k), aux loss).  The router runs in fp32.  ``idx`` imposes the expert
    ids (another evaluation's, for a check that must not let a near-tie
    route a token elsewhere); the weights still come from this router."""
    E, k = cfg.num_experts, cfg.experts_per_token
    probs = torch.softmax(x.float() @ p["router"], dim=-1)     # (B, S, E)
    if idx is None:
        w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        w, idx = w[..., :k], idx[..., :k]
    else:
        w = torch.gather(probs, -1, idx)
    w = w / w.sum(-1, keepdim=True)                 # renormalise over top-k
    # Switch load-balance loss: E * sum_e f_e P_e
    f = _one_hot(idx, E).sum(-2).mean(dim=(0, 1))   # fraction routed to e
    P = probs.mean(dim=(0, 1))
    return w, idx, E * (f * P).sum()


def _experts(p, xb):
    """SwiGLU of every expert on its own rows: xb (..., E, rows, d)."""
    gate, up = torch.einsum("...ecd,edf->...ecf", xb, p["wi"]).chunk(2, -1)
    return torch.einsum("...ecf,efd->...ecd", F.silu(gate) * up, p["wo"])


def apply_moe(cfg: ModelConfig, p, x, mode: str | None = None):
    """x (B, S, d) -> (out in x's dtype, aux loss).  ``mode`` overrides
    ``cfg.moe_mode``."""
    mode = mode or cfg.moe_mode
    if mode == "dispatch":
        return _apply_dispatch(cfg, p, x)
    if mode == "sorted":
        return _apply_sorted(cfg, p, x)
    if mode == "sorted_local":
        # dispatch within each batch row (the reference vmaps the rows)
        ys, auxs = zip(*(_apply_sorted(cfg, p, x[b:b + 1])
                         for b in range(x.shape[0])))
        return torch.cat(ys), torch.stack(auxs).mean()
    if mode != "dense":
        raise ValueError(f"moe_mode {mode!r} not in {MODES}")
    return _apply_dense(cfg, p, x)


def _apply_dense(cfg: ModelConfig, p, x):
    w, idx, aux = _route(cfg, p, x)
    gates = (_one_hot(idx, cfg.num_experts) * w[..., None]).sum(-2)  # (B,S,E)
    gate, up = torch.einsum("bsd,edf->bsef", x, p["wi"]).chunk(2, -1)
    out = torch.einsum("bsef,efd->bsed", F.silu(gate) * up, p["wo"])
    out = torch.einsum("bsed,bse->bsd", out.float(), gates)
    return out.to(x.dtype), aux


def _apply_sorted(cfg: ModelConfig, p, x):
    """Sort-based capacity dispatch over all B S tokens: overflow past
    ``cap = max(1, round(k N / E cf))`` assignments an expert drops."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    N, dev = B * S, x.device
    cap = int(max(1, round(k * N / E * cfg.capacity_factor)))
    w, idx, aux = _route(cfg, p, x)

    ef = idx.reshape(N * k)                       # expert of each assignment
    wf = w.reshape(N * k).float()
    tok = torch.arange(N, device=dev).repeat_interleave(k)
    order = torch.argsort(ef, stable=True)        # group assignments by expert
    counts = _one_hot(ef, E).sum(0).long()        # assignments an expert
    starts = counts.cumsum(0) - counts            # its first sorted position
    # the buffer: row (e, c) holds expert e's c-th assignment in token order
    c = torch.arange(cap, device=dev)
    filled = c[None] < counts[:, None]                                # (E, cap)
    src = order[(starts[:, None] + c[None]).clamp(max=N * k - 1)]
    buf = torch.where(filled[..., None], x.reshape(N, d)[tok[src]],
                      torch.zeros((), dtype=x.dtype, device=dev))
    y = _experts(p, buf)                                              # (E, cap, d)
    # each assignment's place in its expert's buffer, through the inverse
    # of the sort; past the capacity it drops
    pos = torch.argsort(order) - starts[ef]
    keep = pos < cap
    got = y[ef, pos.clamp(max=cap - 1)].float()
    contrib = torch.where(keep[:, None], got * wf[:, None],
                          torch.zeros((), device=dev))
    out = contrib.reshape(N, k, d).sum(1)
    return out.reshape(B, S, d).to(x.dtype), aux


def _apply_dispatch(cfg: ModelConfig, p, x):
    """Capacity-based dispatch (GShard), per batch row."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    C = int(max(1, round(k * S / E * cfg.capacity_factor)))
    w, idx, aux = _route(cfg, p, x)

    onehot = _one_hot(idx, E)                                 # (B,S,k,E)
    # position of each (token, slot) within its expert's buffer
    pos_in_e = (onehot.reshape(B, S * k, E).cumsum(1).reshape(B, S, k, E)
                - 1.0)
    keep = (pos_in_e < C).float() * onehot                    # drop overflow
    pos_oh = _one_hot(pos_in_e.long(), C)                     # (B,S,k,E,C)
    dispatch = (keep[..., None] * pos_oh).sum(2)              # (B,S,E,C)
    combine = ((keep * w[..., None])[..., None] * pos_oh).sum(2)
    xb = torch.einsum("bsec,bsd->becd", dispatch.to(x.dtype), x)
    yb = _experts(p, xb)                                      # (B,E,C,d)
    out = torch.einsum("bsec,becd->bsd", combine, yb.float())
    return out.to(x.dtype), aux
