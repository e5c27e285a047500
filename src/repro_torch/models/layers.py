"""Shared building blocks as plain functions on tensors (port of the JAX
package's ``models/layers.py``).

Conventions kept from the reference, so that parity tests compare like with
like:
* params are plain dicts of tensors; weights are ``x @ W`` matrices of shape
  (d_in, d_out), and layer-stacked params carry a leading ``L`` axis;
* compute dtype = cfg.dtype (bf16 by default); norms and RoPE compute in
  fp32 and cast back.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_normal(gen: torch.Generator, shape, scale: float,
                dtype) -> torch.Tensor:
    """N(0, 1) * scale drawn in fp32 on the generator's device, then cast
    (the reference draws fp32 normals and casts the same way)."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------- norms ----
def rmsnorm(x, scale, eps: float = 1e-5):
    """RMSNorm with a zero-centred gain: scales by ``(1 + scale)`` in fp32."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return out.to(x.dtype)


def norm_init(cfg: ModelConfig, device, shape_prefix=()):
    shape = tuple(shape_prefix) + (cfg.d_model,)
    if cfg.norm_type == "rmsnorm":
        return {"scale": torch.zeros(shape, dtype=torch.float32,
                                     device=device)}
    return {"scale": torch.ones(shape, dtype=torch.float32, device=device),
            "bias": torch.zeros(shape, dtype=torch.float32, device=device)}


def apply_norm(cfg: ModelConfig, p, x):
    if cfg.norm_type == "rmsnorm":
        return rmsnorm(x, p["scale"], cfg.norm_eps)
    return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)


# ----------------------------------------------------------------- mlps ----
def mlp_init(cfg: ModelConfig, gen: torch.Generator, shape_prefix=(),
             d_ff=None):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    dt, pre = dtype_of(cfg), tuple(shape_prefix)
    s_in, s_out = (2.0 / d) ** 0.5, (2.0 / ff) ** 0.5
    if cfg.mlp_type == "swiglu":
        # gate and up fused on the output dim: (d, 2*ff)
        return {"wi": init_normal(gen, pre + (d, 2 * ff), s_in, dt),
                "wo": init_normal(gen, pre + (ff, d), s_out, dt)}
    return {"wi": init_normal(gen, pre + (d, ff), s_in, dt),
            "bi": torch.zeros(pre + (ff,), dtype=dt, device=gen.device),
            "wo": init_normal(gen, pre + (ff, d), s_out, dt),
            "bo": torch.zeros(pre + (d,), dtype=dt, device=gen.device)}


def apply_mlp(cfg: ModelConfig, p, x):
    if cfg.mlp_type == "swiglu":
        gate, up = (x @ p["wi"]).chunk(2, dim=-1)
        return (F.silu(gate) * up) @ p["wo"]
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p["wi"] + p["bi"], approximate="tanh")
    return h @ p["wo"] + p["bo"]


# ----------------------------------------------------------- embeddings ----
def padded_vocab(cfg: ModelConfig) -> int:
    """The unembedding is padded to a multiple of 128 (49155 -> 49280 for
    granite); serving slices the logits back to ``vocab_size``."""
    return ((cfg.vocab_size + 127) // 128) * 128


def embed_init(cfg: ModelConfig, gen: torch.Generator):
    dt = dtype_of(cfg)
    p = {"tok": init_normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt)}
    if not cfg.tie_embeddings:
        p["unembed"] = init_normal(gen, (cfg.d_model, padded_vocab(cfg)), 0.02, dt)
    if cfg.pos_type == "learned":
        p["pos"] = init_normal(gen, (cfg.max_position, cfg.d_model), 0.02, dt)
    return p


def embed_tokens(cfg: ModelConfig, p, tokens, pos_offset: int = 0):
    x = p["tok"][tokens]
    s = tokens.shape[-1]
    if cfg.pos_type == "learned":
        x = x + p["pos"][pos_offset:pos_offset + s]
    elif cfg.pos_type == "sinusoidal":
        pos = pos_offset + torch.arange(s, device=tokens.device)
        x = x + sinusoidal(pos, cfg.d_model).to(x.dtype)
    return x


def unembed(cfg: ModelConfig, p, x, *, padded: bool = False):
    """Vocab logits in fp32.  ``padded=True`` keeps the 128-padded columns
    (training path); otherwise they are sliced back to ``vocab_size``."""
    w = p["tok"].T if cfg.tie_embeddings else p["unembed"]
    logits = (x @ w).float()
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    if padded and not cfg.tie_embeddings:
        return logits
    if not cfg.tie_embeddings and logits.shape[-1] != cfg.vocab_size:
        logits = logits[..., :cfg.vocab_size]
    return logits


def sinusoidal(positions, dim: int):
    half = dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(10000.0) * idx / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ----------------------------------------------------------------- rope ----
def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) int.  Rotates the split halves
    (x1, x2) = x[..., :hd/2], x[..., hd/2:], not interleaved pairs, with fp32
    angles."""
    hd = x.shape[-1]
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd
    inv = 1.0 / (theta ** exps)
    ang = positions[..., None].float() * inv             # (..., S, hd/2)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------- losses ----
def softmax_xent(logits, labels, mask=None, valid_vocab: int | None = None):
    """Mean token cross-entropy; logits fp32 (B, S, Vp), labels int (B, S).

    ``valid_vocab``: the true vocab size when the logits carry the 128
    padding columns, which are set to -1e30 before the logsumexp.  With a
    token ``mask`` the mean runs over the unmasked tokens, with the
    reference's ``max(sum(mask), 1)`` denominator.
    """
    if valid_vocab is not None and logits.shape[-1] != valid_vocab:
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(col < valid_vocab, logits, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
