"""Decoder-only transformer: dense GQA, MoE and the VLM backbone (port of
the JAX package's ``models/transformer.py``): qwen1.5-4b, granite-3-2b,
granite-8b, starcoder2-7b (``dense``), mixtral-8x7b, olmoe-1b-7b (``moe``)
and internvl2-76b (``vlm``: the dense trunk with stub vision embeddings
spliced into the prefix).

Params keep the reference's tree and its layer stacking: every leaf under
``params["layers"]`` carries a leading ``L`` axis, and the layers run as a
Python loop over views ``leaf[i]`` (the reference scans them).  A ``moe``
layer holds a ``moe`` leaf in place of ``mlp``, and its router's aux loss
is summed over the layers.

Serving differs from the reference in three respects, each stated where it
happens: ``decode_step`` takes a per-slot position vector (B,), writes the
new keys/values into ``cache`` in place, and routes ``moe_mode="sorted"``
within each slot's row (the reference engine decodes each slot alone).
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models.remat import remat

FAMILIES = ("dense", "moe", "vlm")


def _require_family(cfg: ModelConfig):
    if cfg.family not in FAMILIES:
        raise ValueError(f"models.transformer takes families {FAMILIES}, "
                         f"not {cfg.family!r}")


def init_params(cfg: ModelConfig, gen: torch.Generator):
    """Random params on ``gen.device``, drawn from ``gen`` (layer-stacked)."""
    _require_family(cfg)
    n = cfg.num_layers
    layers = {"ln1": L.norm_init(cfg, gen.device, (n,)),
              "attn": attn_mod.attn_init(cfg, gen, (n,)),
              "ln2": L.norm_init(cfg, gen.device, (n,))}
    if cfg.family == "moe":
        layers["moe"] = moe_mod.moe_init(cfg, gen, (n,))
    else:
        layers["mlp"] = L.mlp_init(cfg, gen, (n,))
    return {"embed": L.embed_init(cfg, gen), "layers": layers,
            "ln_f": L.norm_init(cfg, gen.device)}


def layer_params(layers, i: int):
    """Layer ``i``'s params: views ``leaf[i]`` of the stacked tree."""
    if isinstance(layers, dict):
        return {k: layer_params(v, i) for k, v in layers.items()}
    return layers[i]


def _splice_vision(x, vision_embeds):
    """VLM stub frontend: positions 0..n_vis-1 take the (precomputed)
    projected patch embeddings, in the activations' dtype."""
    if vision_embeds is None:
        return x
    n = vision_embeds.shape[-2]
    return torch.cat([vision_embeds.to(x.dtype), x[:, n:]], dim=1)


def _ffn(cfg, p, z, moe_mode=None):
    """The block's feed-forward: (out, aux), aux 0 for an MLP."""
    if cfg.family == "moe":
        return moe_mod.apply_moe(cfg, p["moe"], z, mode=moe_mode)
    return L.apply_mlp(cfg, p["mlp"], z), torch.zeros(
        (), dtype=torch.float32, device=z.device)


def _block(cfg, p, x, positions, window, impl):
    """One pre-norm block; returns (x, (k, v), aux) with this layer's keys
    and values for the cache."""
    a, kv = attn_mod.attention(cfg, p["attn"], L.apply_norm(cfg, p["ln1"], x),
                               positions=positions, causal=True,
                               window=window, impl=impl)
    x = x + a
    m, aux = _ffn(cfg, p, L.apply_norm(cfg, p["ln2"], x))
    return x + m, kv, aux


def _layer(cfg, x, p, positions, impl=None):
    """One block for training: (x, aux), its keys and values dropped."""
    x, _, aux = _block(cfg, p, x, positions, None, impl)
    return x, aux


def forward(cfg: ModelConfig, params, batch, impl: str | None = None,
            padded_logits: bool = False):
    """batch: {tokens (B, S) int, [vision_embeds (B, n_vis, d)]} ->
    (logits (B, S, V) fp32, aux: the routers' loss summed over layers, 0
    without experts)."""
    _require_family(cfg)
    tokens = batch["tokens"]
    x = L.embed_tokens(cfg, params["embed"], tokens)
    x = _splice_vision(x, batch.get("vision_embeds"))
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    body = partial(_layer, cfg, impl=impl)
    if cfg.remat:
        body = remat(body)
    for i in range(cfg.num_layers):
        x, a = body(x, layer_params(params["layers"], i), positions)
        aux = aux + a
    x = L.apply_norm(cfg, params["ln_f"], x)
    return L.unembed(cfg, params["embed"], x, padded=padded_logits), aux


def loss_fn(cfg: ModelConfig, params, batch, rng=None, impl: str = "ref",
            aux_weight: float = 0.01):
    """Next-token cross-entropy over the padded vocab, plus ``aux_weight``
    times the routers' aux loss.  ``impl="ref"`` (the reference's default)
    keeps the kernels, which have no backward, off the training path."""
    logits, aux = forward(cfg, params, batch, impl=impl, padded_logits=True)
    loss = L.softmax_xent(logits[:, :-1], batch["tokens"][:, 1:],
                          batch.get("mask"), valid_vocab=cfg.vocab_size)
    return loss + aux_weight * aux


# ------------------------------------------------------------- serving -----
def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda"):
    """Zeroed k and v caches, each (L, batch, cache_len, K, hd).  They are
    separate tensors: decode writes into them in place."""
    shape = (cfg.num_layers, batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    dt = L.dtype_of(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _pad_seq(t, length: int):
    """(B, S, ...) zero-padded along S to ``length``."""
    if t.shape[1] == length:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], length - t.shape[1])
                                     + tuple(t.shape[2:]))], dim=1)


def prefill(cfg: ModelConfig, params, batch, cache_len: int | None = None,
            impl: str | None = None, window: int | None = None):
    """Run the prompt; return (last-position logits (B, 1, V), KV cache).

    A full cache (``cache_len >= S``) holds positions 0..S-1 followed by
    zeros; a ring cache (``cache_len < S``) keeps the last ``cache_len``
    positions rolled into slot order ``pos mod cache_len``.
    """
    _require_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache_len = cache_len or S
    x = L.embed_tokens(cfg, params["embed"], tokens)
    x = _splice_vision(x, batch.get("vision_embeds"))
    positions = torch.arange(S, device=tokens.device)
    eff_window = cfg.sliding_window if window is None else window
    dt = L.dtype_of(cfg)
    shift = S % cache_len
    layers = {"k": [], "v": []}
    for i in range(cfg.num_layers):
        x, kv, _ = _block(cfg, layer_params(params["layers"], i), x,
                          positions, eff_window, impl)
        for name, t in zip(("k", "v"), kv):
            t = t.to(dt)
            if cache_len >= S:       # pad: slots S.. stay zero
                t = _pad_seq(t, cache_len)
            else:                    # ring: last cache_len positions, rolled
                t = torch.roll(t[:, -cache_len:], shift, dims=1)
            layers[name].append(t)
    # stacked, not written into a zeroed cache: the same values, and no
    # in-place write into a tensor that a step across ranks cannot place
    cache = {name: torch.stack(ts) for name, ts in layers.items()}
    x = L.apply_norm(cfg, params["ln_f"], x)
    logits = L.unembed(cfg, params["embed"], x[:, -1:])
    return logits, cache


def decode_step(cfg: ModelConfig, params, token, cache, pos, *,
                ring: bool = False, window: int | None = None):
    """One decode step for a batch of slots.

    token: (B,) int; pos: (B,) absolute position of each slot's token (an
    int is broadcast).  cache leaves (L, B, cache_len, K, hd) are updated in
    place and returned.  Returns (logits (B, V) fp32, cache).

    ``moe_mode="sorted"`` routes each slot's row on its own (as
    ``sorted_local``): the reference engine decodes every slot alone, at
    batch 1, and a capacity over all slots would drop other tokens.
    """
    _require_family(cfg)
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
    moe_mode = "sorted_local" if cfg.moe_mode == "sorted" else None
    for i in range(cfg.num_layers):
        p = layer_params(params["layers"], i)
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}   # views
        a, _ = attn_mod.decode_attention(
            cfg, p["attn"], L.apply_norm(cfg, p["ln1"], x), layer_cache, pos,
            ring=ring, window=eff_window)
        x = x + a
        x = x + _ffn(cfg, p, L.apply_norm(cfg, p["ln2"], x), moe_mode)[0]
    x = L.apply_norm(cfg, params["ln_f"], x)
    logits = L.unembed(cfg, params["embed"], x)[:, 0]
    return logits, cache
