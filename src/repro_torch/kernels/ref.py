"""Naive oracles for the kernels (port of the JAX package's ``kernels/ref.py``
for the kernels ported so far)."""
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


def agg_reference(w, w_stack, s):
    """out = w + sum_c s_c (w_c - w);  w (M,), w_stack (C, M), s (C,)."""
    d = w_stack.float() - w.float()[None]
    return (w.float() + torch.einsum("c,cm->m", s.float(), d)).to(w.dtype)
