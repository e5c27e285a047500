"""Decoder-only dense GQA transformer (port of the JAX package's
``models/transformer.py`` for ``family == "dense"``: qwen1.5-4b,
granite-3-2b, granite-8b, starcoder2-7b).

Params keep the reference's tree and its layer stacking: every leaf under
``params["layers"]`` carries a leading ``L`` axis, and the layers run as a
Python loop over views ``leaf[i]`` (the reference scans them).

Serving differs from the reference in two respects, both stated where they
happen: ``decode_step`` takes a per-slot position vector (B,) and writes
the new keys/values into ``cache`` in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L

NOT_PORTED = ("family {!r} is not ported yet (ROADMAP.md Queue 1 item 20: "
              "remaining families); the port serves families 'dense' and "
              "'ssm' and trains family 'cnn'")


def _require_dense(cfg: ModelConfig):
    if cfg.family != "dense":
        raise NotImplementedError(NOT_PORTED.format(cfg.family))


def init_params(cfg: ModelConfig, gen: torch.Generator):
    """Random params on ``gen.device``, drawn from ``gen`` (layer-stacked)."""
    _require_dense(cfg)
    n = cfg.num_layers
    return {
        "embed": L.embed_init(cfg, gen),
        "layers": {
            "ln1": L.norm_init(cfg, gen.device, (n,)),
            "attn": attn_mod.attn_init(cfg, gen, (n,)),
            "ln2": L.norm_init(cfg, gen.device, (n,)),
            "mlp": L.mlp_init(cfg, gen, (n,)),
        },
        "ln_f": L.norm_init(cfg, gen.device),
    }


def layer_params(layers, i: int):
    """Layer ``i``'s params: views ``leaf[i]`` of the stacked tree."""
    if isinstance(layers, dict):
        return {k: layer_params(v, i) for k, v in layers.items()}
    return layers[i]


def _block(cfg, p, x, positions, window, impl):
    """One pre-norm block; returns (x, (k, v)) with this layer's keys and
    values for the cache."""
    a, kv = attn_mod.attention(cfg, p["attn"], L.apply_norm(cfg, p["ln1"], x),
                               positions=positions, causal=True,
                               window=window, impl=impl)
    x = x + a
    x = x + L.apply_mlp(cfg, p["mlp"], L.apply_norm(cfg, p["ln2"], x))
    return x, kv


def forward(cfg: ModelConfig, params, batch, impl: str | None = None,
            padded_logits: bool = False):
    """batch: {tokens (B, S) int} -> (logits (B, S, V) fp32, aux = 0)."""
    _require_dense(cfg)
    tokens = batch["tokens"]
    x = L.embed_tokens(cfg, params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for i in range(cfg.num_layers):
        x, _ = _block(cfg, layer_params(params["layers"], i), x, positions,
                      None, impl)
    x = L.apply_norm(cfg, params["ln_f"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.unembed(cfg, params["embed"], x, padded=padded_logits), aux


# ------------------------------------------------------------- serving -----
def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda"):
    """Zeroed k and v caches, each (L, batch, cache_len, K, hd).  They are
    separate tensors: decode writes into them in place."""
    shape = (cfg.num_layers, batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    dt = L.dtype_of(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def prefill(cfg: ModelConfig, params, batch, cache_len: int | None = None,
            impl: str | None = None, window: int | None = None):
    """Run the prompt; return (last-position logits (B, 1, V), KV cache).

    A full cache (``cache_len >= S``) holds positions 0..S-1 followed by
    zeros; a ring cache (``cache_len < S``) keeps the last ``cache_len``
    positions rolled into slot order ``pos mod cache_len``.
    """
    _require_dense(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache_len = cache_len or S
    x = L.embed_tokens(cfg, params["embed"], tokens)
    positions = torch.arange(S, device=tokens.device)
    eff_window = cfg.sliding_window if window is None else window
    cache = init_cache(cfg, B, cache_len, device=x.device)
    shift = S % cache_len
    for i in range(cfg.num_layers):
        x, (k, v) = _block(cfg, layer_params(params["layers"], i), x,
                           positions, eff_window, impl)
        if cache_len >= S:           # pad: slots S.. stay zero
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
        else:                        # ring: last cache_len positions, rolled
            cache["k"][i] = torch.roll(k[:, -cache_len:], shift, dims=1)
            cache["v"][i] = torch.roll(v[:, -cache_len:], shift, dims=1)
    x = L.apply_norm(cfg, params["ln_f"], x)
    logits = L.unembed(cfg, params["embed"], x[:, -1:])
    return logits, cache


def decode_step(cfg: ModelConfig, params, token, cache, pos, *,
                ring: bool = False, window: int | None = None):
    """One decode step for a batch of slots.

    token: (B,) int; pos: (B,) absolute position of each slot's token (an
    int is broadcast).  cache leaves (L, B, cache_len, K, hd) are updated in
    place and returned.  Returns (logits (B, V) fp32, cache).
    """
    _require_dense(cfg)
    B = token.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.long, device=token.device)
    if pos.dim() == 0:
        pos = pos.expand(B)
    x = params["embed"]["tok"][token[:, None]]                  # (B, 1, d)
    if cfg.pos_type == "learned":
        x = x + params["embed"]["pos"][pos][:, None]
    elif cfg.pos_type == "sinusoidal":
        x = x + L.sinusoidal(pos, cfg.d_model)[:, None].to(x.dtype)
    eff_window = cfg.sliding_window if window is None else window
    for i in range(cfg.num_layers):
        p = layer_params(params["layers"], i)
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}   # views
        a, _ = attn_mod.decode_attention(
            cfg, p["attn"], L.apply_norm(cfg, p["ln1"], x), layer_cache, pos,
            ring=ring, window=eff_window)
        x = x + a
        x = x + L.apply_mlp(cfg, p["mlp"], L.apply_norm(cfg, p["ln2"], x))
    x = L.apply_norm(cfg, params["ln_f"], x)
    logits = L.unembed(cfg, params["embed"], x)[:, 0]
    return logits, cache
