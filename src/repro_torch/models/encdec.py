"""Whisper-style encoder-decoder backbone (arXiv:2212.04356; port of the JAX
package's ``models/encdec.py``): whisper-tiny, family ``encdec``.

The mel-spectrogram and conv feature extractor are a stub, as in the
reference: the batch provides precomputed frame embeddings ``frames (B,
encoder_seq, d_model)``.  Encoder: bidirectional self-attention + GELU MLP,
sinusoidal positions.  Decoder: causal self-attention, cross-attention to
the encoder memory, GELU MLP, layernorm.  Params keep the reference's tree
and its layer stacking (``enc_layers`` and ``dec_layers`` leaves carry a
leading layer axis); the layers run as a Python loop over views.

The encoder's self-attention and the decoder's causal self-attention take
``impl`` (the flash kernel on the card); cross-attention always takes the
plain path, as in the reference.  Serving differs from the reference as the
transformer's does: ``decode_step`` takes a per-slot position vector (B,)
and writes the new keys/values into ``cache`` in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models.remat import remat
from repro_torch.models.transformer import layer_params


def init_params(cfg: ModelConfig, gen: torch.Generator):
    """Random params on ``gen.device``, drawn from ``gen`` (layer-stacked)."""
    dev, ne, nd = gen.device, (cfg.encoder_layers,), (cfg.num_layers,)
    enc = {"ln1": L.norm_init(cfg, dev, ne),
           "attn": attn_mod.attn_init(cfg, gen, ne),
           "ln2": L.norm_init(cfg, dev, ne), "mlp": L.mlp_init(cfg, gen, ne)}
    dec = {"ln1": L.norm_init(cfg, dev, nd),
           "attn": attn_mod.attn_init(cfg, gen, nd),
           "lnx": L.norm_init(cfg, dev, nd),
           "xattn": attn_mod.attn_init(cfg, gen, nd),
           "ln2": L.norm_init(cfg, dev, nd), "mlp": L.mlp_init(cfg, gen, nd)}
    return {"embed": L.embed_init(cfg, gen), "enc_layers": enc,
            "enc_ln_f": L.norm_init(cfg, dev), "dec_layers": dec,
            "ln_f": L.norm_init(cfg, dev)}


def encode(cfg: ModelConfig, params, frames, impl: str | None = None):
    """frames (B, S_enc, d) stub embeddings -> encoder memory (B, S_enc,
    d): non-causal self-attention."""
    S, dt = frames.shape[1], L.dtype_of(cfg)
    pos = torch.arange(S, device=frames.device)
    x = frames.to(dt) + L.sinusoidal(pos, cfg.d_model).to(dt)
    for i in range(cfg.encoder_layers):
        p = layer_params(params["enc_layers"], i)
        a, _ = attn_mod.attention(cfg, p["attn"],
                                  L.apply_norm(cfg, p["ln1"], x),
                                  causal=False, impl=impl)
        x = x + a
        x = x + L.apply_mlp(cfg, p["mlp"], L.apply_norm(cfg, p["ln2"], x))
    return L.apply_norm(cfg, params["enc_ln_f"], x)


def _dec_layer(cfg: ModelConfig, p, x, memory, positions, impl=None):
    """One decoder layer: (x, self-attention (k, v), cross (k, v))."""
    a, kv = attn_mod.attention(cfg, p["attn"], L.apply_norm(cfg, p["ln1"], x),
                               positions=positions, causal=True, impl=impl)
    x = x + a
    a, xkv = attn_mod.attention(cfg, p["xattn"],
                                L.apply_norm(cfg, p["lnx"], x), memory=memory)
    x = x + a
    x = x + L.apply_mlp(cfg, p["mlp"], L.apply_norm(cfg, p["ln2"], x))
    return x, kv, xkv


def forward(cfg: ModelConfig, params, batch, impl: str | None = None,
            padded_logits: bool = False):
    """batch: {tokens (B, S) int, frames (B, S_enc, d)} -> (logits (B, S,
    V) fp32, aux = 0)."""
    memory = encode(cfg, params, batch["frames"], impl=impl)
    tokens = batch["tokens"]
    x = L.embed_tokens(cfg, params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)

    def body(h, p, memory, positions):
        return _dec_layer(cfg, p, h, memory, positions, impl=impl)[0]

    if cfg.remat:                   # the decoder layers only, as the
        body = remat(body)          # reference
    for i in range(cfg.num_layers):
        x = body(x, layer_params(params["dec_layers"], i), memory, positions)
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
def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda"):
    """Zeroed self-attention k, v (L, batch, cache_len, K, hd) and the
    encoder memory's cross-attention xk, xv (L, batch, encoder_seq, K, hd),
    four separate tensors."""
    dt, nl = L.dtype_of(cfg), cfg.num_layers
    kv = (nl, batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    xkv = (nl, batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, shape in (("k", kv), ("v", kv), ("xk", xkv),
                                ("xv", xkv))}


def prefill(cfg: ModelConfig, params, batch, cache_len: int | None = None,
            impl: str | None = None, window: int | None = None):
    """Encode the frames and run the prompt; return (last-position logits
    (B, 1, V), cache): self-attention keys/values at positions 0..S-1 then
    zeros up to ``cache_len``, and the memory's cross keys/values.
    ``window`` is unused."""
    memory = encode(cfg, params, batch["frames"], impl=impl)
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache = init_cache(cfg, B, cache_len or S, device=tokens.device)
    x = L.embed_tokens(cfg, params["embed"], tokens)
    positions = torch.arange(S, device=tokens.device)
    for i in range(cfg.num_layers):
        x, (k, v), (xk, xv) = _dec_layer(
            cfg, layer_params(params["dec_layers"], i), x, memory, positions,
            impl=impl)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
        cache["xk"][i] = xk
        cache["xv"][i] = xv
    x = L.apply_norm(cfg, params["ln_f"], x)
    return L.unembed(cfg, params["embed"], x[:, -1:]), cache


def decode_step(cfg: ModelConfig, params, token, cache, pos, *,
                ring: bool = False, window: int | None = None):
    """Self-attention against the cache (updated in place) and
    cross-attention against the cached encoder keys/values.  token: (B,)
    int; pos: (B,) absolute position of each slot's token (an int is
    broadcast).  Returns (logits (B, V) fp32, cache)."""
    B = token.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.long, device=token.device)
    if pos.dim() == 0:
        pos = pos.expand(B)
    x = params["embed"]["tok"][token[:, None]]                  # (B, 1, d)
    if cfg.pos_type == "learned":
        x = x + params["embed"]["pos"][pos][:, None]
    elif cfg.pos_type == "sinusoidal":
        x = x + L.sinusoidal(pos, cfg.d_model)[:, None].to(x.dtype)
    H, hd = cfg.num_heads, cfg.head_dim
    for i in range(cfg.num_layers):
        p = layer_params(params["dec_layers"], i)
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}   # views
        a, _ = attn_mod.decode_attention(
            cfg, p["attn"], L.apply_norm(cfg, p["ln1"], x), layer_cache, pos,
            ring=ring, window=window or 0)
        x = x + a
        z = L.apply_norm(cfg, p["lnx"], x)
        q = z @ p["xattn"]["wq"]
        if "bq" in p["xattn"]:
            q = q + p["xattn"]["bq"]
        out = attn_mod.dot_product_attention(
            q.reshape(B, 1, H, hd), attn_mod.repeat_kv(cache["xk"][i], H),
            attn_mod.repeat_kv(cache["xv"][i], H), causal=False)
        x = x + out.reshape(B, 1, cfg.q_dim) @ p["xattn"]["wo"]
        x = x + L.apply_mlp(cfg, p["mlp"], L.apply_norm(cfg, p["ln2"], x))
    x = L.apply_norm(cfg, params["ln_f"], x)
    return L.unembed(cfg, params["embed"], x)[:, 0], cache
