"""Mamba2 (state-space duality / SSD, arXiv:2405.21060), attention-free stack
(port of the JAX package's ``models/ssm.py``).

Block: in_proj -> [z | x | B | C | dt], short causal depthwise conv over
(x, B, C), selective SSM with a scalar decay A per head, gated RMSNorm,
out_proj.  Params keep the reference's tree and its layer stacking (every
leaf under ``params["layers"]`` carries a leading ``L`` axis); the layers
run as a Python loop over views ``leaf[i]``.

The reference's dispatch is kept: a sequence whose length is a multiple of
``cfg.ssm_chunk`` (and longer than one) takes the chunked scan, anything
else the per-step recurrence.  Unlike the reference, whose chunked path is
jnp, the port's goes through ``kernels.ops.ssd_scan``: the hand-written
kernel on the card, its plain version on the CPU.  Decode is the O(1)-state
recurrent step; ``decode_step`` writes the new states into ``cache`` in
place and ignores the per-slot positions the engine passes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.models import layers as L
from repro_torch.models.remat import remat
from repro_torch.models.transformer import layer_params

IMPLS = (None, "ref")


# --------------------------------------------------------------- params ----
def mixer_init(cfg: ModelConfig, gen: torch.Generator, shape_prefix=()):
    d, din = cfg.d_model, cfg.ssm_inner
    H, st, G, K = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_conv
    dt, pre, dev = L.dtype_of(cfg), tuple(shape_prefix), gen.device
    conv_ch = din + 2 * G * st
    proj_out = 2 * din + 2 * G * st + H

    def full(shape, value, dtype=torch.float32):
        return torch.full(pre + shape, value, dtype=dtype, device=dev)

    return {
        "in_proj": L.init_normal(gen, pre + (d, proj_out), (1 / d) ** 0.5, dt),
        "conv_w": L.init_normal(gen, pre + (conv_ch, K), (1 / K) ** 0.5, dt),
        "conv_b": full((conv_ch,), 0.0, dt),
        "A_log": full((H,), 0.0),               # A = -exp(A_log) = -1
        "D": full((H,), 1.0),
        "dt_bias": full((H,), -2.0),            # softplus(-2) ~ 0.13
        "norm": full((din,), 0.0),
        "out_proj": L.init_normal(gen, pre + (din, d), (1 / din) ** 0.5, dt),
    }


def init_params(cfg: ModelConfig, gen: torch.Generator):
    """Random params on ``gen.device``, drawn from ``gen`` (layer-stacked)."""
    n = cfg.num_layers
    return {"embed": L.embed_init(cfg, gen),
            "layers": {"ln": L.norm_init(cfg, gen.device, (n,)),
                       "mixer": mixer_init(cfg, gen, (n,))},
            "ln_f": L.norm_init(cfg, gen.device)}


# ------------------------------------------------------------- SSD core ----
_softplus = L.softplus


def _causal_conv(x, w, b, state=None):
    """``layers.causal_conv`` then SiLU: (silu(out), the conv tail)."""
    out, new_state = L.causal_conv(x, w, b, state)
    return F.silu(out), new_state


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD: xh (B, S, H, P), dt (B, S, H) softplus'd step sizes,
    A (H,) negative decay rates, Bm / Cm (B, S, G, N).  Returns y
    (B, S, H, P) fp32 and the final state (B, H, P, N) fp32."""
    return ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=chunk)


def ssd_sequential(xh, dt, A, Bm, Cm, h0=None):
    """Per-step recurrence (ragged prefill + decode).  Same shapes as
    ``ssd_chunked``; ``h0`` (B, H, P, N) fp32 is the state to start from."""
    Bsz, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Bh = Bm.float().repeat_interleave(rep, dim=2)
    Ch = Cm.float().repeat_interleave(rep, dim=2)
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device)
         if h0 is None else h0)
    ys = []
    for t in range(S):
        dt_t = dt[:, t]                                      # (B, H)
        a = torch.exp(dt_t * A[None])
        dBx = (xh[:, t].float()[..., None]
               * (dt_t[..., None] * Bh[:, t])[:, :, None, :])  # (B, H, P, N)
        h = h * a[:, :, None, None] + dBx
        ys.append((h @ Ch[:, t, :, :, None])[..., 0])        # (B, H, P)
    return torch.stack(ys, dim=1), h


# ---------------------------------------------------------------- block ----
def _mixer_apply(cfg: ModelConfig, p, x, conv_state=None, ssm_state=None,
                 mode: str = "chunked", impl: str | None = None):
    """x (B, S, d) -> (y (B, S, d), (conv_state, ssm_state)).  ``impl``
    None: the chunked scan through ``ops.ssd_scan`` (the kernel on the
    card); "ref": its plain version."""
    Bsz, S, _ = x.shape
    din, H, st, G = cfg.ssm_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    P = cfg.ssm_head_dim

    proj = x @ p["in_proj"]
    # layout: [z (din) | xBC (din + 2G*st) | dt (H)]
    z = proj[..., :din]
    xbc = proj[..., din:din + din + 2 * G * st]
    dt_raw = proj[..., din + din + 2 * G * st:]

    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    # strided views of the conv output: the kernel reads them in place
    xh = xbc[..., :din].reshape(Bsz, S, H, P)
    Bm = xbc[..., din:din + G * st].reshape(Bsz, S, G, st)
    Cm = xbc[..., din + G * st:].reshape(Bsz, S, G, st)
    dt = _softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    if mode == "chunked" and S % cfg.ssm_chunk == 0 and S > 1:
        if impl == "ref":
            y, h = ssd_scan_plain(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
        else:
            y, h = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk)
    else:
        y, h = ssd_sequential(xh, dt, A, Bm, Cm, ssm_state)
    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(Bsz, S, din)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = L.rmsnorm(y * F.silu(z.float()), p["norm"], cfg.norm_eps)
    return y.to(x.dtype) @ p["out_proj"], (new_conv, h)


def _check_impl(impl):
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")


def forward(cfg: ModelConfig, params, batch, impl: str | None = None,
            padded_logits: bool = False):
    """batch: {tokens (B, S) int} -> (logits (B, S, V) fp32, aux = 0)."""
    _check_impl(impl)
    x = L.embed_tokens(cfg, params["embed"], batch["tokens"])

    def body(h, p):
        y, _ = _mixer_apply(cfg, p["mixer"], L.apply_norm(cfg, p["ln"], h),
                            impl=impl)
        return h + y

    if cfg.remat:
        body = remat(body)
    for i in range(cfg.num_layers):
        x = body(x, layer_params(params["layers"], i))
    x = L.apply_norm(cfg, params["ln_f"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.unembed(cfg, params["embed"], x, padded=padded_logits), aux


def loss_fn(cfg: ModelConfig, params, batch, rng=None, impl: str = "ref"):
    """Next-token cross-entropy over the padded vocab.  ``impl="ref"`` (the
    reference's default) keeps the ssd_scan kernel, which has no backward,
    off the training path."""
    logits, _ = forward(cfg, params, batch, impl=impl, padded_logits=True)
    return L.softmax_xent(logits[:, :-1], batch["tokens"][:, 1:],
                          valid_vocab=cfg.vocab_size)


# ------------------------------------------------------------- serving -----
def init_cache(cfg: ModelConfig, batch: int, cache_len: int = 0,
               device="cuda"):
    """The SSM cache is O(1) in sequence length (``cache_len`` is unused):
    conv (L, batch, K-1, conv channels) in the model dtype and ssm
    (L, batch, H, P, N) in fp32, zeroed."""
    din, st, G = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_groups
    nl = cfg.num_layers
    return {
        "conv": torch.zeros((nl, batch, cfg.ssm_conv - 1, din + 2 * G * st),
                            dtype=L.dtype_of(cfg), device=device),
        "ssm": torch.zeros((nl, batch, cfg.ssm_heads, cfg.ssm_head_dim, st),
                           dtype=torch.float32, device=device),
    }


def prefill(cfg: ModelConfig, params, batch, cache_len: int | None = None,
            impl: str | None = None, window: int | None = None):
    """Run the prompt; return (last-position logits (B, 1, V), cache with
    each layer's conv tail and final SSM state).  ``cache_len`` and
    ``window`` are unused (the state does not grow)."""
    _check_impl(impl)
    tokens = batch["tokens"]
    x = L.embed_tokens(cfg, params["embed"], tokens)
    conv, ssm = [], []
    for i in range(cfg.num_layers):
        p = layer_params(params["layers"], i)
        y, (conv_s, ssm_s) = _mixer_apply(
            cfg, p["mixer"], L.apply_norm(cfg, p["ln"], x), impl=impl)
        x = x + y
        conv.append(conv_s.to(L.dtype_of(cfg)))
        ssm.append(ssm_s.float())
    # stacked, not written into a zeroed cache (`init_cache`'s layout): the
    # same values, and no in-place write a step across ranks cannot place
    cache = {"conv": torch.stack(conv), "ssm": torch.stack(ssm)}
    x = L.apply_norm(cfg, params["ln_f"], x)
    return L.unembed(cfg, params["embed"], x[:, -1:]), cache


def decode_step(cfg: ModelConfig, params, token, cache, pos=None, *,
                ring: bool = False, window: int | None = None):
    """One decode step for a batch of slots.  token: (B,) int.  ``pos``
    (the engine's per-slot positions), ``ring`` and ``window`` are unused:
    the recurrence does not depend on position.  The cache leaves
    (L, B, ...) are updated in place and returned.  Returns (logits (B, V)
    fp32, cache)."""
    x = L.embed_tokens(cfg, params["embed"], token[:, None])
    for i in range(cfg.num_layers):
        p = layer_params(params["layers"], i)
        y, (conv_s, ssm_s) = _mixer_apply(
            cfg, p["mixer"], L.apply_norm(cfg, p["ln"], x),
            conv_state=cache["conv"][i], ssm_state=cache["ssm"][i],
            mode="sequential")
        x = x + y
        cache["conv"][i] = conv_s
        cache["ssm"][i] = ssm_s
    x = L.apply_norm(cfg, params["ln_f"], x)
    return L.unembed(cfg, params["embed"], x)[:, 0], cache
