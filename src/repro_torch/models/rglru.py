"""RecurrentGemma (arXiv:2402.19427): RG-LRU recurrent blocks + local
attention, 1 attention : 2 recurrent (port of the JAX package's
``models/rglru.py``): recurrentgemma-2b, family ``hybrid``.

Each layer is a temporal-mixing block (RG-LRU or local MQA) and a gated
MLP, pre-norm.  RG-LRU:

    r_t = sigmoid(W_a x_t),  i_t = sigmoid(W_i x_t)
    a_t = exp(-c softplus(Lambda) r_t)                    (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)

26 layers = 8 x (R, R, A) + 2 tail R.  Params keep the reference's tree and
its stacking per role (``blocks.{r1, r2, attn}`` with a leading block axis,
``tail`` with a leading tail axis); the blocks run as a Python loop over
views ``leaf[i]``.

Training and prefill run the linear recurrence as a log-step inclusive
scan in plain PyTorch (the reference's ``jax.lax.associative_scan`` is no
Pallas kernel): ceil(log2 S) vectorised steps with the reference's combine,
and no in-place write, so that ``torch.func.vmap(grad)`` takes it.  Decode
is the O(1) sequential step.  The gate products ``x @ wa`` and ``x @ wi``
are float32 matmuls (PyTorch's default keeps TF32 off for them).

Serving differs from the reference as the transformer's does:
``decode_step`` takes a per-slot position vector (B,) and writes the new
states and keys/values into ``cache`` in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models.remat import remat
from repro_torch.models.transformer import layer_params

_C = 8.0  # RG-LRU decay sharpness constant
ROLES = ("r1", "r2")            # the recurrent layers of a block


def _counts(cfg: ModelConfig) -> tuple[int, int]:
    """(blocks of (R, R, A), tail R layers)."""
    n_blocks = cfg.num_layers // 3
    return n_blocks, cfg.num_layers - 3 * n_blocks


# --------------------------------------------------------------- params ----
def _rec_init(cfg: ModelConfig, gen: torch.Generator, prefix: tuple):
    d, w, K = cfg.d_model, cfg.lru_width or cfg.d_model, cfg.ssm_conv
    dt, dev = L.dtype_of(cfg), gen.device

    def g(shape, scale):
        return L.init_normal(gen, prefix + shape, scale, dt)

    def full(value, dtype=torch.float32):
        return torch.full(prefix + (w,), value, dtype=dtype, device=dev)

    return {"wx": g((d, w), (1 / d) ** 0.5), "wy": g((d, w), (1 / d) ** 0.5),
            "conv_w": g((w, K), (1 / K) ** 0.5), "conv_b": full(0.0, dt),
            "wa": g((w, w), (1 / w) ** 0.5), "ba": full(0.0),
            "wi": g((w, w), (1 / w) ** 0.5), "bi": full(0.0),
            "lam": full(0.5), "wo": g((w, d), (1 / w) ** 0.5)}


def _layer_init(cfg: ModelConfig, gen: torch.Generator, kind: str,
                prefix: tuple):
    p = {"ln1": L.norm_init(cfg, gen.device, prefix),
         "ln2": L.norm_init(cfg, gen.device, prefix),
         "mlp": L.mlp_init(cfg, gen, prefix)}
    if kind == "attn":
        p["attn"] = attn_mod.attn_init(cfg, gen, prefix)
    else:
        p["rec"] = _rec_init(cfg, gen, prefix)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator):
    """Random params on ``gen.device``, drawn from ``gen``, stacked per
    role: ``blocks.{r1, r2, attn}`` (n_blocks, ...), ``tail`` (n_tail,
    ...)."""
    n_blocks, n_tail = _counts(cfg)
    pre = (n_blocks,)
    p = {"embed": L.embed_init(cfg, gen),
         "blocks": {"r1": _layer_init(cfg, gen, "rec", pre),
                    "r2": _layer_init(cfg, gen, "rec", pre),
                    "attn": _layer_init(cfg, gen, "attn", pre)},
         "ln_f": L.norm_init(cfg, gen.device)}
    if n_tail:
        p["tail"] = _layer_init(cfg, gen, "rec", (n_tail,))
    return p


# -------------------------------------------------------------- RG-LRU -----
def _rglru_gates(p, x):
    """x (B, S, w) post-conv -> (log_a (B, S, w) fp32, gated input
    (B, S, w) fp32)."""
    xf = x.float()
    r = torch.sigmoid(xf @ p["wa"].float() + p["ba"])
    i = torch.sigmoid(xf @ p["wi"].float() + p["bi"])
    log_a = -_C * L.softplus(p["lam"]) * r
    a2 = torch.exp(2.0 * log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - a2, 1e-12)) * (i * xf)
    return log_a, b


def _linear_scan(log_a, b, h0=None):
    """h_t = exp(log_a_t) h_{t-1} + b_t over axis 1, as a log-step
    inclusive scan: at offset d = 1, 2, 4, ... each position t >= d
    combines the aggregate ending at t - d with its own, by the
    reference's ``(la1 + la2, b1 exp(la2) + b2)``.  ``h0`` (B, w) folds
    into step 0."""
    if h0 is not None:
        b = torch.cat([b[:, :1] + (torch.exp(log_a[:, 0]) * h0)[:, None],
                       b[:, 1:]], dim=1)
    S, la, h, d = b.shape[1], log_a, b, 1
    while d < S:
        h = torch.cat([h[:, :d], h[:, :-d] * torch.exp(la[:, d:]) + h[:, d:]],
                      dim=1)
        if 2 * d < S:               # the last step needs no decay
            la = torch.cat([la[:, :d], la[:, :-d] + la[:, d:]], dim=1)
        d *= 2
    return h


def _rec_apply(cfg: ModelConfig, p, x, conv_state=None, h0=None,
               sequential: bool = False):
    """Recurrent temporal block.  x (B, S, d) -> (y (B, S, d), (conv tail
    (B, K-1, w), h at the last step (B, w) fp32))."""
    xb = x @ p["wx"]
    yb = x @ p["wy"]
    xc, new_conv = L.causal_conv(xb, p["conv_w"], p["conv_b"], conv_state)
    log_a, b = _rglru_gates(p, xc)
    if sequential:                  # decode: S == 1
        h_prev = torch.zeros_like(b[:, 0]) if h0 is None else h0
        h = (torch.exp(log_a[:, 0]) * h_prev + b[:, 0])[:, None]
    else:
        h = _linear_scan(log_a, b, h0)
    # jax.nn.gelu defaults to the tanh approximation
    gate = F.gelu(yb.float(), approximate="tanh")
    return (h * gate).to(x.dtype) @ p["wo"], (new_conv, h[:, -1])


# --------------------------------------------------------------- layers ----
def _apply_layer(cfg: ModelConfig, p, x, kind: str, positions=None,
                 state=None, pos=None, impl=None):
    """Returns (x, new state): (conv tail, h) for a recurrent layer; the
    prefill's (k, v) or, decoding (``state`` a {"k", "v"} ring cache,
    written in place), that cache for the attention layer."""
    z = L.apply_norm(cfg, p["ln1"], x)
    if kind == "rec":
        conv_s, h0 = (None, None) if state is None else state
        y, new_state = _rec_apply(
            cfg, p["rec"], z, conv_s, h0,
            sequential=state is not None and z.shape[1] == 1)
    elif state is None:             # training / prefill: local attention
        y, new_state = attn_mod.attention(
            cfg, p["attn"], z, positions=positions, causal=True,
            window=cfg.local_window, impl=impl)
    else:
        y, new_state = attn_mod.decode_attention(
            cfg, p["attn"], z, state, pos, ring=True,
            window=cfg.local_window)
    x = x + y
    x = x + L.apply_mlp(cfg, p["mlp"], L.apply_norm(cfg, p["ln2"], x))
    return x, new_state


def forward(cfg: ModelConfig, params, batch, impl: str | None = None,
            padded_logits: bool = False):
    """batch: {tokens (B, S) int} -> (logits (B, S, V) fp32, aux = 0)."""
    tokens = batch["tokens"]
    x = L.embed_tokens(cfg, params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    n_blocks, n_tail = _counts(cfg)

    def block(h, p, positions):
        for role in ROLES:
            h, _ = _apply_layer(cfg, p[role], h, "rec")
        h, _ = _apply_layer(cfg, p["attn"], h, "attn", positions=positions,
                            impl=impl)
        return h

    def tail(h, p):
        return _apply_layer(cfg, p, h, "rec")[0]

    if cfg.remat:
        block, tail = remat(block), remat(tail)
    for i in range(n_blocks):
        x = block(x, layer_params(params["blocks"], i), positions)
    for i in range(n_tail):
        x = tail(x, layer_params(params["tail"], i))
    x = L.apply_norm(cfg, params["ln_f"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.unembed(cfg, params["embed"], x, padded=padded_logits), aux


def loss_fn(cfg: ModelConfig, params, batch, rng=None, impl: str = "ref"):
    """Next-token cross-entropy over the padded vocab.  ``impl="ref"`` (the
    reference's default) keeps the flash kernel, which has no backward, off
    the training path."""
    logits, _ = forward(cfg, params, batch, impl=impl, padded_logits=True)
    return L.softmax_xent(logits[:, :-1], batch["tokens"][:, 1:],
                          valid_vocab=cfg.vocab_size)


# ------------------------------------------------------------- serving -----
def init_cache(cfg: ModelConfig, batch: int, cache_len: int = 0,
               device="cuda"):
    """Zeroed state, O(1) in sequence length (``cache_len`` is unused):
    per recurrent layer the conv tail (n, batch, K-1, w) in the model dtype
    and h (n, batch, w) fp32; per attention layer a ring of
    ``local_window`` keys and values (n_blocks, batch, W, K, hd)."""
    w = cfg.lru_width or cfg.d_model
    n_blocks, n_tail = _counts(cfg)
    dt = L.dtype_of(cfg)

    def rec(n):
        return {"conv": torch.zeros((n, batch, cfg.ssm_conv - 1, w),
                                    dtype=dt, device=device),
                "h": torch.zeros((n, batch, w), dtype=torch.float32,
                                 device=device)}

    ring = (n_blocks, batch, cfg.local_window, cfg.num_kv_heads, cfg.head_dim)
    cache = {"r1": rec(n_blocks), "r2": rec(n_blocks),
             "attn": {"k": torch.zeros(ring, dtype=dt, device=device),
                      "v": torch.zeros(ring, dtype=dt, device=device)}}
    if n_tail:
        cache["tail"] = rec(n_tail)
    return cache


def prefill(cfg: ModelConfig, params, batch, cache_len: int | None = None,
            impl: str | None = None, window: int | None = None):
    """Run the prompt; return (last-position logits (B, 1, V), cache).
    ``cache_len`` and ``window`` are unused: each attention layer's last W
    = ``local_window`` positions go into its ring in slot order ``pos mod
    W`` (rolled by S mod W when S >= W, zero-padded to W when S < W)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    W = cfg.local_window
    x = L.embed_tokens(cfg, params["embed"], tokens)
    positions = torch.arange(S, device=tokens.device)
    cache = init_cache(cfg, B, device=x.device)
    n_blocks, n_tail = _counts(cfg)
    for i in range(n_blocks):
        p = layer_params(params["blocks"], i)
        for role in ROLES:
            x, (conv, h) = _apply_layer(cfg, p[role], x, "rec")
            cache[role]["conv"][i] = conv
            cache[role]["h"][i] = h
        x, (k, v) = _apply_layer(cfg, p["attn"], x, "attn",
                                 positions=positions, impl=impl)
        for name, t in (("k", k), ("v", v)):
            if S >= W:
                cache["attn"][name][i] = torch.roll(t[:, -W:], S % W, dims=1)
            else:
                cache["attn"][name][i, :, :S] = t
    for i in range(n_tail):
        x, (conv, h) = _apply_layer(cfg, layer_params(params["tail"], i), x,
                                    "rec")
        cache["tail"]["conv"][i] = conv
        cache["tail"]["h"][i] = h
    x = L.apply_norm(cfg, params["ln_f"], x)
    return L.unembed(cfg, params["embed"], x[:, -1:]), cache


def _step_rec(cfg, p, x, c, i):
    """One recurrent layer's decode step on layer ``i`` of the cache
    entry ``c``, whose conv tail and h it overwrites."""
    x, (conv, h) = _apply_layer(cfg, p, x, "rec",
                                state=(c["conv"][i], c["h"][i]))
    c["conv"][i] = conv
    c["h"][i] = h
    return x


def decode_step(cfg: ModelConfig, params, token, cache, pos, *,
                ring: bool = True, window: int | None = None):
    """One decode step for a batch of slots.  token: (B,) int; pos: (B,)
    absolute position of each slot's token (an int is broadcast).  The
    attention layers use their ``local_window`` ring whatever ``ring`` and
    ``window`` say, as the reference does.  The cache is updated in place
    and returned.  Returns (logits (B, V) fp32, cache)."""
    B = token.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.long, device=token.device)
    if pos.dim() == 0:
        pos = pos.expand(B)
    x = L.embed_tokens(cfg, params["embed"], token[:, None])
    n_blocks, n_tail = _counts(cfg)
    for i in range(n_blocks):
        p = layer_params(params["blocks"], i)
        for role in ROLES:
            x = _step_rec(cfg, p[role], x, cache[role], i)
        ring_i = {"k": cache["attn"]["k"][i], "v": cache["attn"]["v"][i]}
        x, _ = _apply_layer(cfg, p["attn"], x, "attn", state=ring_i, pos=pos)
    for i in range(n_tail):
        x = _step_rec(cfg, layer_params(params["tail"], i), x,
                      cache["tail"], i)
    x = L.apply_norm(cfg, params["ln_f"], x)
    return L.unembed(cfg, params["embed"], x)[:, 0], cache
