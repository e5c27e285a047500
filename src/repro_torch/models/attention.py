"""Attention: GQA/MHA with RoPE, causal + sliding-window masks, KV caches
(port of the JAX package's ``models/attention.py``).

Shapes: q (B, S, H, hd), k/v (B, S, K, hd) with H % K == 0 (GQA groups).
Caches:
* full cache — (B, max_len, K, hd) written at absolute positions;
* ring cache — (B, W, K, hd) written at ``pos mod W``.

``attention``'s ``impl`` picks, in the reference's order: ``"flash"`` (the
Hopper kernel on a CUDA tensor, its plain version on a CPU tensor, through
`repro_torch.kernels.ops`), then ``blocked_attention`` when
``cfg.attn_blocked``, then ``dot_product_attention``.  ``impl=None`` means
``"flash"`` on a CUDA tensor and ``"ref"`` on a CPU tensor.  Cross-attention
(``memory=``) always takes ``dot_product_attention``, as in the reference.

Decode differs from the reference in one respect: ``pos`` is a per-slot
position vector (B,) (the reference takes a scalar and the engine ``vmap``s
over slots), and ``cache_write`` writes into the cache in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import is_dtensor
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, dtype_of, init_normal

NEG_INF = -1e30
IMPLS = ("flash", "ref")


def attn_init(cfg: ModelConfig, gen: torch.Generator, shape_prefix=()):
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    dt, pre = dtype_of(cfg), tuple(shape_prefix)
    s = (1.0 / d) ** 0.5
    p = {"wq": init_normal(gen, pre + (d, qd), s, dt),
         "wk": init_normal(gen, pre + (d, kvd), s, dt),
         "wv": init_normal(gen, pre + (d, kvd), s, dt),
         "wo": init_normal(gen, pre + (qd, d), (1.0 / qd) ** 0.5, dt)}
    if cfg.qkv_bias:
        for name, width in (("bq", qd), ("bk", kvd), ("bv", kvd)):
            p[name] = torch.zeros(pre + (width,), dtype=dt, device=gen.device)
    return p


def _split_heads(x, n_heads, head_dim):
    return x.reshape(x.shape[:-1] + (n_heads, head_dim))


def _project(x, w, b, n_heads, head_dim):
    y = x @ w
    if b is not None:
        y = y + b
    return _split_heads(y, n_heads, head_dim)


def repeat_kv(k, num_heads: int):
    """(B, S, K, hd) -> (B, S, H, hd), each KV head repeated H/K times in
    place (head h reads KV head h // (H/K))."""
    K = k.shape[-2]
    if K == num_heads:
        return k
    return k.repeat_interleave(num_heads // K, dim=-2)


def dot_product_attention(q, k, v, *, causal: bool, window: int = 0,
                          q_positions=None, kv_positions=None,
                          bias_mask=None):
    """Reference attention.  q (B,Sq,H,hd), k/v (B,Skv,H,hd) (GQA-repeated).

    ``q_positions``/``kv_positions`` are absolute positions for the causal
    and window masks; ``bias_mask`` is (Sq, Skv) or per batch (B, Sq, Skv).
    """
    Sq, hd = q.shape[1], q.shape[3]
    Skv = k.shape[1]
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(Sq, device=dev)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=dev)
    scale = 1.0 / (hd ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (q_positions[:, None] >= kv_positions[None, :])
    if window and window > 0:
        mask = mask & (q_positions[:, None] - kv_positions[None, :] < window)
    if bias_mask is not None:
        mask = mask & bias_mask
    mask = mask[None, None] if mask.dim() == 2 else mask[:, None]
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def blocked_attention(q, k, v, *, causal: bool, window: int = 0,
                      block_k: int = 2048, q_positions=None,
                      kv_positions=None):
    """Online-softmax attention in plain PyTorch over KV blocks, with the
    reference's numerics: operands in q's dtype, products accumulated in
    fp32, probabilities rounded to q's dtype before the second product.

    q (B,Sq,H,D); k/v (B,Skv,H,D) GQA-repeated; Skv % block_k == 0.
    """
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    block_k = min(block_k, Skv)
    if Skv % block_k:
        raise ValueError(f"KV length {Skv} is not a multiple of block_k "
                         f"{block_k}")
    dev = q.device
    scale = 1.0 / (D ** 0.5)
    if q_positions is None:
        q_positions = torch.arange(Sq, device=dev)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=dev)
    qf = q.float().transpose(1, 2)                         # (B,H,Sq,D)
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=dev)
    for k0 in range(0, Skv, block_k):
        kb = k[:, k0:k0 + block_k].float().transpose(1, 2)     # (B,H,bk,D)
        vb = v[:, k0:k0 + block_k].float().transpose(1, 2)
        kpos = kv_positions[k0:k0 + block_k]
        s = qf @ kb.transpose(-1, -2) * scale
        mask = torch.ones((Sq, block_k), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (q_positions[:, None] >= kpos[None, :])
        if window and window > 0:
            mask = mask & (q_positions[:, None] - kpos[None, :] < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.to(q.dtype).float() @ vb
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def attention(cfg: ModelConfig, p, x, *, positions=None, causal=True,
              window=None, memory=None, impl: str | None = None):
    """Full attention over a sequence (prefill / training / encoder).

    ``memory`` (B, S_mem, d): keys and values come from it (cross-attention:
    non-causal, no RoPE on either side, never the kernel).  Returns (out
    (B, S, d), (k, v)) with k, v (B, S or S_mem, K, hd) after RoPE —
    un-repeated, as the cache holds them.
    """
    B, S, _ = x.shape
    win = cfg.sliding_window if window is None else window
    if impl is None and memory is None:
        impl = "flash" if x.is_cuda else "ref"
    if impl is not None and impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    src = x if memory is None else memory
    q = _project(x, p["wq"], p.get("bq"), cfg.num_heads, cfg.head_dim)
    k = _project(src, p["wk"], p.get("bk"), cfg.num_kv_heads, cfg.head_dim)
    v = _project(src, p["wv"], p.get("bv"), cfg.num_kv_heads, cfg.head_dim)
    if positions is None:
        positions = torch.arange(S, device=x.device)
    if cfg.pos_type == "rope" and memory is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if memory is not None:
        out = dot_product_attention(
            q, repeat_kv(k, cfg.num_heads), repeat_kv(v, cfg.num_heads),
            causal=False, window=win or 0)
    elif impl == "flash":
        # the kernel maps query head h to KV head h // (H/K) itself
        out = kops.flash_attention(q, k, v, causal=causal, window=win or 0)
    elif cfg.attn_blocked:
        out = blocked_attention(
            q, repeat_kv(k, cfg.num_heads), repeat_kv(v, cfg.num_heads),
            causal=causal, window=win or 0, block_k=cfg.attn_block_k,
            q_positions=positions)
    else:
        out = dot_product_attention(
            q, repeat_kv(k, cfg.num_heads), repeat_kv(v, cfg.num_heads),
            causal=causal, window=win or 0, q_positions=positions)
    out = out.reshape(B, S, cfg.q_dim)
    return out @ p["wo"], (k, v)


# ------------------------------------------------------------- caches ------
def cache_write(cache, k_new, v_new, pos, ring: bool):
    """Write (B, 1, K, hd) into each row's slot, in place: ``pos mod W`` for
    a ring cache, else ``min(pos, W - 1)`` (the reference's clamp).  ``pos``
    is (B,).  Returns ``cache``."""
    W = cache["k"].shape[1]
    idx = pos % W if ring else pos.clamp(max=W - 1)
    for name, new in (("k", k_new), ("v", v_new)):
        _write_rows(cache[name], new, idx)
    return cache


def _write_rows(c, new, idx):
    """``c[b, idx[b]] = new[b, 0]`` for every row b, in place.  A DTensor
    cache (a decode step across ranks: batch and kv heads sharded) is
    written shard by shard: ``new`` is placed as the cache is, and each
    rank writes its own rows (``idx`` read at the rows' global offset)
    into its local tensor, which is a view of the cache's."""
    if is_dtensor(c):
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset

        new = new.redistribute(c.device_mesh, c.placements).to_local()
        shape, offset = compute_local_shape_and_global_offset(
            c.shape, c.device_mesh, c.placements)
        c, idx = c.to_local(), idx[offset[0]:offset[0] + shape[0]]
    rows = torch.arange(new.shape[0], device=new.device)
    c[rows, idx] = new[:, 0].to(c.dtype)


def decode_attention(cfg: ModelConfig, p, x, cache, pos, *, ring: bool,
                     window: int | None = None):
    """One-token attention against a KV cache.

    x: (B, 1, d); cache k/v: (B, L_cache, K, hd), updated in place; pos: (B,)
    absolute position of each row's token.  Returns (out (B, 1, d), cache).
    """
    B = x.shape[0]
    win = cfg.sliding_window if window is None else window
    q = _project(x, p["wq"], p.get("bq"), cfg.num_heads, cfg.head_dim)
    k1 = _project(x, p["wk"], p.get("bk"), cfg.num_kv_heads, cfg.head_dim)
    v1 = _project(x, p["wv"], p.get("bv"), cfg.num_kv_heads, cfg.head_dim)
    posv = pos[:, None]                                        # (B, 1)
    if cfg.pos_type == "rope":
        q = apply_rope(q, posv, cfg.rope_theta)
        k1 = apply_rope(k1, posv, cfg.rope_theta)
    cache = cache_write(cache, k1, v1, pos, ring)
    L = cache["k"].shape[1]
    # absolute position held in each cache slot, per row
    slots = torch.arange(L, device=x.device)[None, :]
    if ring:
        wrap = pos[:, None] // L * L
        kv_pos = torch.where(slots <= pos[:, None] % L, wrap + slots,
                             wrap - L + slots)
    else:
        kv_pos = slots.expand(B, L)
    # >= 0 excludes ring slots not written yet
    valid = (kv_pos <= posv) & (kv_pos >= 0)
    if win and win > 0:
        valid &= posv - kv_pos < win
    out = dot_product_attention(
        q, repeat_kv(cache["k"], cfg.num_heads),
        repeat_kv(cache["v"], cfg.num_heads), causal=False, window=0,
        bias_mask=valid[:, None, :])
    return out.reshape(B, 1, cfg.q_dim) @ p["wo"], cache
