"""The port's dense transformer against the JAX package's, with the JAX
``init_params`` tree carried across by ``repro_torch.convert``.

granite-3-2b smoke config in fp32 (2 layers, d_model 256, 4 heads / 2 KV
heads).  Tolerance 1e-4 absolute/relative on logits and caches: fp32 with
XLA's and PyTorch's CPU matmuls summing in different orders through two
layers (the observed gap is ~1e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import get_model as jax_model
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import get_model

TOL = dict(rtol=1e-4, atol=1e-4)


def _setup(sliding_window=0):
    jcfg = dataclasses.replace(jax_smoke("granite-3-2b"),
                               sliding_window=sliding_window)
    tcfg = dataclasses.replace(get_smoke_config("granite-3-2b"),
                               sliding_window=sliding_window)
    jm, tm = jax_model(jcfg), get_model(tcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    return jm, jp, tm, params_from_numpy(jp, device="cpu")


_BASE = {}


def _base():
    if not _BASE:
        _BASE["v"] = _setup()
    return _BASE["v"]


def _tokens(B, S, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_convert_keeps_tree_and_layer_stacking():
    jm, jp, tm, tp = _base()
    jflat = {jax.tree_util.keystr(k): v
             for k, v in jax.tree_util.tree_leaves_with_path(jp)}
    assert tm.num_params(tp) == sum(v.size for v in jflat.values())
    L = tm.cfg.num_layers
    assert tp["layers"]["attn"]["wq"].shape == (L, 256, 256)
    assert tp["layers"]["mlp"]["wi"].shape == (L, 256, 1024)
    np.testing.assert_array_equal(tp["embed"]["unembed"].numpy(),
                                  np.asarray(jp["embed"]["unembed"]))


@pytest.mark.parametrize("jimpl", ["ref", "flash"])
def test_forward_matches(jimpl):
    jm, jp, tm, tp = _base()
    toks = _tokens(2, 24, tm.cfg.vocab_size)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, impl=jimpl)
    for impl in ("ref", "flash"):
        got, aux = tm.forward(tp, {"tokens": torch.tensor(toks)}, impl=impl)
        assert got.shape == (2, 24, tm.cfg.vocab_size)
        _close(got, want)
        assert float(aux) == 0.0


def test_blocked_attention_branch_matches():
    """``cfg.attn_blocked``: the online-softmax plain path, taken when
    ``impl`` is not "flash" (the reference's branch order)."""
    jcfg = dataclasses.replace(jax_smoke("granite-3-2b"), attn_blocked=True,
                               attn_block_k=8)
    tcfg = dataclasses.replace(get_smoke_config("granite-3-2b"),
                               attn_blocked=True, attn_block_k=8)
    jm, tm = jax_model(jcfg), get_model(tcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = params_from_numpy(jp, device="cpu")
    toks = _tokens(2, 24, tm.cfg.vocab_size, seed=6)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got, _ = tm.forward(tp, {"tokens": torch.tensor(toks)}, impl="ref")
    _close(got, want)
    with pytest.raises(ValueError, match="not a multiple of block_k"):
        tm.forward(tp, {"tokens": torch.tensor(toks[:, :20])}, impl="ref")
    with pytest.raises(ValueError, match="impl"):
        tm.forward(tp, {"tokens": torch.tensor(toks)}, impl="pallas")


@pytest.mark.parametrize("impl", ["ref", "flash"])
def test_prefill_logits_and_cache_match(impl):
    jm, jp, tm, tp = _base()
    S, cache_len = 21, 30
    toks = _tokens(2, S, tm.cfg.vocab_size, seed=2)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        cache_len=cache_len, impl=impl)
    tl, tc = tm.prefill(tp, {"tokens": torch.tensor(toks)},
                        cache_len=cache_len, impl=impl)
    assert tl.shape == (2, 1, tm.cfg.vocab_size)
    _close(tl, jl)
    for name in ("k", "v"):
        assert tc[name].shape == jc[name].shape
        _close(tc[name], jc[name])
        assert not tc[name][:, :, S:].any()          # padded slots stay zero


def _decode_both(jm, jp, tm, tp, S, cache_len, steps, ring, window):
    toks = _tokens(2, S, tm.cfg.vocab_size, seed=3)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        cache_len=cache_len, window=window)
    tl, tc = tm.prefill(tp, {"tokens": torch.tensor(toks)},
                        cache_len=cache_len, window=window)
    _close(tl, jl)
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    ttok = tl[:, -1].argmax(-1)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    for i in range(steps):
        jl, jc = jm.decode_step(jp, jtok, jc, jnp.int32(S + i), ring=ring,
                                window=window)
        tl, tc = tm.decode_step(tp, ttok, tc, torch.full((2,), S + i),
                                ring=ring, window=window)
        _close(tl, jl)
        for name in ("k", "v"):
            _close(tc[name], jc[name])
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = tl.argmax(-1)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def test_decode_steps_match():
    jm, jp, tm, tp = _base()
    _decode_both(jm, jp, tm, tp, S=13, cache_len=13 + 6 + 1, steps=6,
                 ring=False, window=None)


@pytest.mark.parametrize("S", [5, 12])
def test_ring_cache_variant_matches(S):
    """sliding_window=8: a prompt shorter than the window pads, a longer
    one keeps the last 8 positions rolled into slot order; decode wraps."""
    jm, jp, tm, tp = _setup(sliding_window=8)
    _decode_both(jm, jp, tm, tp, S=S, cache_len=8, steps=10, ring=True,
                 window=8)


def test_per_slot_positions_equal_separate_scalar_decodes():
    """One batched decode with positions (13, 9) equals each row decoded
    alone at its own scalar position (the reference engine's vmap)."""
    jm, jp, tm, tp = _base()
    cache_len = 20
    rows = []
    for S, seed in ((13, 4), (9, 5)):
        toks = _tokens(1, S, tm.cfg.vocab_size, seed=seed)
        _, c = tm.prefill(tp, {"tokens": torch.tensor(toks)},
                          cache_len=cache_len)
        rows.append((S, c))
    cache = {n: torch.cat([c[n] for _, c in rows], dim=1) for n in ("k", "v")}
    tok = torch.tensor([3, 7])
    batched, _ = tm.decode_step(tp, tok, cache, torch.tensor([13, 9]))
    for b, (S, c) in enumerate(rows):
        alone, _ = tm.decode_step(tp, tok[b:b + 1], c, S)
        torch.testing.assert_close(batched[b], alone[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family,item", [("hybrid", "20b"),
                                         ("encdec", "20c")])
def test_unported_families_raise(family, item):
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), family=family)
    with pytest.raises(NotImplementedError, match=f"Queue 1 item {item}"):
        get_model(cfg)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b",
                                  "internvl2-76b"])
def test_moe_and_vlm_families_match_reference(arch):
    """The ``moe`` and ``vlm`` branches: forward logits and the summed aux,
    prefill logits and caches (a VLM batch with its vision embeddings
    spliced in), and one decode step, against the reference."""
    jm = jax_model(jax_smoke(arch))
    tm = get_model(get_smoke_config(arch))
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = params_from_numpy(jp, device="cpu")
    assert ("moe" in tp["layers"]) == (tm.cfg.family == "moe")
    toks = _tokens(1, 14, tm.cfg.vocab_size)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.tensor(toks)}
    if tm.cfg.family == "vlm":
        vis = np.random.default_rng(3).standard_normal(
            (1, tm.cfg.vision_tokens, tm.cfg.d_model)).astype(np.float32)
        jb["vision_embeds"], tb["vision_embeds"] = (jnp.asarray(vis),
                                                    torch.tensor(vis))
    want, jaux = jm.forward(jp, jb)
    got, aux = tm.forward(tp, tb)
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    assert (float(aux) > 0) == (tm.cfg.family == "moe")
    jl, jc = jm.prefill(jp, jb, cache_len=20)
    tl, tc = tm.prefill(tp, tb, cache_len=20)
    _close(tl, jl)
    for n in ("k", "v"):
        _close(tc[n], jc[n])
    jd, _ = jm.decode_step(jp, jnp.asarray([5]), jc, 14)
    td, _ = tm.decode_step(tp, torch.tensor([5]), tc, 14)
    _close(td, jd)
