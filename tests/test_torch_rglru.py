"""The port's RecurrentGemma (family ``hybrid``) against the JAX package's,
with the JAX ``init_params`` tree carried across by ``repro_torch.convert``.

recurrentgemma-2b smoke config in fp32 (5 layers = 1 x (R, R, A) + 2 tail
R, d_model 128, LRU width 128, 4 heads / 1 KV head of 32, local window
32).  Tolerance: the reference's own serving tolerance
(``tests/test_decode.py``), 2e-4 absolute/relative on logits, states and
caches: fp32 with XLA's and PyTorch's CPU matmuls summing in different
orders, and the port's log-step scan associating the recurrence
differently from ``jax.lax.associative_scan`` (the observed gap is ~5e-6).
The scan alone is held to 1e-5 of the largest |h|.  Greedy tokens must be
equal.  Prompt lengths 20, 32, 45 and 64 put the ring below, at, past and
at twice the window.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import optim as jopt
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.launch.serve import generate as jgenerate
from repro.models import get_model as jax_model
from repro.models import rglru as jrg
from repro_torch import core as tcore
from repro_torch import optim as topt
from repro_torch import prng
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch.serve import generate
from repro_torch.models import get_model, rglru
from repro_torch.models.transformer import layer_params
from test_torch_round import adam_step_bound

ARCH = "recurrentgemma-2b"
TOL = dict(rtol=2e-4, atol=2e-4)
SCAN_RTOL = 1e-5
RING_LENS = (20, 32, 45, 64)
_BASE = {}


def _base():
    if not _BASE:
        jm = jax_model(jax_smoke(ARCH))
        jp = jm.init_params(jax.random.PRNGKey(0))
        tm = get_model(get_smoke_config(ARCH))
        _BASE["v"] = (jm, jp, tm, params_from_numpy(jp, device="cpu"))
    return _BASE["v"]


def _tokens(B, S, V, seed):
    return np.random.default_rng(seed).integers(0, V, (B, S)).astype(np.int32)


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _close(got, want, **kw):
    np.testing.assert_allclose(_np(got), _np(want), **{**TOL, **kw})


def _flat_raw(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_raw(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _flat(tree):
    return {k: _np(v) for k, v in _flat_raw(tree).items()}


def _shapes(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in _flat_raw(tree).items()}


def _rec_params(jp):
    """Block 0's first recurrent layer: (JAX params, the port's)."""
    jr = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["r1"]["rec"])
    return jr, params_from_numpy(jr, device="cpu")


def test_params_tree_carries_across():
    """The reference's tree (``blocks.{r1, r2, attn}`` stacked per block,
    ``tail`` per tail layer) arrives as the port's own: same keys, shapes
    and dtypes, values bitwise; ``layer_params`` takes block i."""
    jm, jp, tm, tp = _base()
    own = tm.init_params(torch.Generator().manual_seed(0))
    assert _shapes(tp) == _shapes(own) == _shapes(jp)
    assert set(tp["blocks"]) == {"r1", "r2", "attn"}
    assert tp["tail"]["rec"]["wa"].shape == (2, 128, 128)
    for k, v in _flat_raw(jp).items():
        np.testing.assert_array_equal(_flat_raw(tp)[k].numpy(), np.asarray(v))
    blk = layer_params(tp["blocks"], 0)
    assert blk["attn"]["attn"]["wq"].shape == (128, 128)


def test_full_config_is_served_and_trained():
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.num_layers, cfg.d_model, cfg.lru_width,
            cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.local_window,
            cfg.vocab_size) == ("hybrid", 26, 2560, 2560, 10, 1, 256, 2048,
                                256000)
    assert cfg.num_params() == jax_config(ARCH).num_params()
    model = get_model(cfg)
    assert model.loss_fn.func is rglru.loss_fn
    assert model.decode_step.func is rglru.decode_step


def test_rglru_gates_match_reference():
    jm, jp, tm, tp = _base()
    jr, tr = _rec_params(jp)
    x = np.random.default_rng(2).standard_normal((2, 11, 128)).astype(
        np.float32)
    jla, jb = jrg._rglru_gates(jr, jnp.asarray(x))
    tla, tb = rglru._rglru_gates(tr, torch.tensor(x))
    assert tla.dtype == tb.dtype == torch.float32
    _close(tla, jla, rtol=1e-6, atol=1e-6)
    _close(tb, jb, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("S", [1, 7, 64, 100])
@pytest.mark.parametrize("with_h0", [False, True])
def test_linear_scan_matches_reference(S, with_h0):
    """The log-step scan against ``jax.lax.associative_scan``, with the
    starting state folded into step 0 or not, within 1e-5 of the largest
    |h| (decays down to e^-8: a long memory)."""
    r = np.random.default_rng(S)
    log_a = -8.0 * r.random((2, S, 16)).astype(np.float32)
    b = r.standard_normal((2, S, 16)).astype(np.float32)
    h0 = r.standard_normal((2, 16)).astype(np.float32) if with_h0 else None
    want = np.asarray(jax.jit(jrg._linear_scan)(
        jnp.asarray(log_a), jnp.asarray(b),
        None if h0 is None else jnp.asarray(h0)))
    got = rglru._linear_scan(torch.tensor(log_a), torch.tensor(b),
                             None if h0 is None else torch.tensor(h0))
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= SCAN_RTOL * scale
    # the sequential recurrence agrees too
    h = np.zeros((2, 16), np.float32) if h0 is None else h0.copy()
    for t in range(S):
        h = np.exp(log_a[:, t]) * h + b[:, t]
    np.testing.assert_allclose(got[:, -1].numpy(), h, rtol=0,
                               atol=SCAN_RTOL * scale)


def test_rec_apply_matches_reference_and_carries_its_state():
    """The recurrent block on a whole sequence, against the reference; then
    the same sequence split 13 + 7, the conv tail and h carried across,
    equals it; and one sequential decode step equals the reference's."""
    jm, jp, tm, tp = _base()
    jr, tr = _rec_params(jp)
    cfg = tm.cfg
    x = (0.5 * np.random.default_rng(3).standard_normal((2, 20, 128))
         ).astype(np.float32)
    rec = jax.jit(partial(jrg._rec_apply, jm.cfg),
                  static_argnames="sequential")
    jy, (jconv, jh) = rec(jr, jnp.asarray(x))
    ty, (tconv, th) = rglru._rec_apply(cfg, tr, torch.tensor(x))
    _close(ty, jy)
    _close(tconv, jconv)
    _close(th, jh)
    y1, (c1, h1) = rglru._rec_apply(cfg, tr, torch.tensor(x[:, :13]))
    y2, (c2, h2) = rglru._rec_apply(cfg, tr, torch.tensor(x[:, 13:]), c1, h1)
    _close(torch.cat([y1, y2], dim=1), jy)
    _close(c2, jconv)
    _close(h2, jh)
    x1 = x[:, :1]
    jy1, (jc1, jh1) = rec(jr, jnp.asarray(x1), jconv, jh, sequential=True)
    ty1, (tc1, th1) = rglru._rec_apply(cfg, tr, torch.tensor(x1), tconv, th,
                                       sequential=True)
    _close(ty1, jy1)
    _close(tc1, jc1)
    _close(th1, jh1)


def test_forward_and_loss_match_reference():
    jm, jp, tm, tp = _base()
    toks = _tokens(2, 45, tm.cfg.vocab_size, 4)
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, aux = tm.forward(tp, {"tokens": torch.tensor(toks).long()})
    assert tl.shape == (2, 45, tm.cfg.vocab_size) and float(aux) == 0.0
    _close(tl, jl)
    jloss = jm.loss_fn(jp, {"tokens": jnp.asarray(toks)})
    tloss = tm.loss_fn(tp, {"tokens": torch.tensor(toks).long()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("S", RING_LENS)
def test_prefill_matches_reference(S):
    """Last-position logits and every cache leaf: the conv tails and states
    of the recurrent layers, and the attention ring in slot order pos mod
    W (S < W zero-padded, S = W, S > W rolled by S mod W, S = 2W)."""
    jm, jp, tm, tp = _base()
    W = tm.cfg.local_window
    toks = _tokens(2, S, tm.cfg.vocab_size, 5 + S)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=S + 4)
    tl, tc = tm.prefill(tp, {"tokens": torch.tensor(toks).long()},
                        cache_len=S + 4)
    assert tl.shape == (2, 1, tm.cfg.vocab_size)
    _close(tl, jl)
    want, got = _flat(jc), _flat(tc)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        _close(got[k], want[k], err_msg=k)
    ring = tc["attn"]["k"]
    assert ring.shape[2] == W
    if S < W:                       # the slots not written yet stay zero
        assert not ring[:, :, S:].any()
    # the last W positions, position p in slot p mod W
    k_full = _attn_keys(tm, tp, toks)
    for p in range(max(S - W, 0), S):
        torch.testing.assert_close(ring[0, :, p % W], k_full[:, p])


def _attn_keys(tm, tp, toks):
    """Block 0's attention keys over the whole prompt (the prefill's before
    the ring)."""
    seen = []
    real = rglru.attn_mod.attention

    def tap(*a, **kw):
        out = real(*a, **kw)
        seen.append(out[1][0])
        return out

    rglru.attn_mod.attention = tap
    try:
        tm.forward(tp, {"tokens": torch.tensor(toks).long()})
    finally:
        rglru.attn_mod.attention = real
    return seen[0]


def test_init_cache_ignores_cache_len():
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="bfloat16")
    a = rglru.init_cache(cfg, 3, 7, device="cpu")
    b = rglru.init_cache(cfg, 3, 4096, device="cpu")
    assert _shapes(a) == _shapes(b) == {
        "/r1/conv": ((1, 3, 3, 128), "bfloat16"),
        "/r1/h": ((1, 3, 128), "float32"),
        "/r2/conv": ((1, 3, 3, 128), "bfloat16"),
        "/r2/h": ((1, 3, 128), "float32"),
        "/attn/k": ((1, 3, 32, 1, 32), "bfloat16"),
        "/attn/v": ((1, 3, 32, 1, 32), "bfloat16"),
        "/tail/conv": ((2, 3, 3, 128), "bfloat16"),
        "/tail/h": ((2, 3, 128), "float32")}
    assert not any(t.any() for t in _flat_raw(a).values())
    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype="bfloat16")
    assert _shapes(jrg.init_cache(jcfg, 3, 7)) == _shapes(a)


@pytest.mark.parametrize("S", [20, 30])
def test_prefill_decode_match_forward(S):
    """The twin of ``tests/test_decode.py::test_prefill_decode_match_forward``:
    prefill S tokens, then decode 6 (past the window of 32 from S = 30):
    each step's logits equal the full forward at that position and the
    reference's decode; past the window, the greedy tokens of ``generate``
    equal the reference's."""
    jm, jp, tm, tp = _base()
    toks = _tokens(2, S + 6, tm.cfg.vocab_size, 9)
    full, _ = tm.forward(tp, {"tokens": torch.tensor(toks).long()})
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])},
                        cache_len=S + 5)
    tl, tc = tm.prefill(tp, {"tokens": torch.tensor(toks[:, :S]).long()},
                        cache_len=S + 5)
    _close(tl[:, 0], full[:, S - 1])
    jdecode = jax.jit(jm.decode_step)
    for j in range(6):
        jl, jc = jdecode(jp, jnp.asarray(toks[:, S + j]), jc,
                         jnp.int32(S + j))
        tl, tc2 = tm.decode_step(tp, torch.tensor(toks[:, S + j]).long(), tc,
                                 torch.tensor([S + j, S + j]))
        assert tc2 is tc                             # written in place
        _close(tl, full[:, S + j])
        _close(tl, jl)
    want, got = _flat(jc), _flat(tc)
    for k in want:
        _close(got[k], want[k], err_msg=k)
    W = tm.cfg.local_window
    if S + 8 <= W:
        return
    jt = jgenerate(jm, jp, {"tokens": jnp.asarray(toks[:, :S])}, 8, W,
                   ring=True, rng=jax.random.PRNGKey(0))
    tt = generate(tm, tp, {"tokens": torch.tensor(toks[:, :S]).long()}, 8, W,
                  ring=True, device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


C, T, BC = 4, 2, 2
E = np.array([1, 2, 4, 8], np.int32)
P = np.full(C, 1.0 / C, np.float32)


def test_parallel_round_matches_reference():
    """One sustainable round of C=4 clients, T=2 Adam steps under
    ``torch.func.vmap(grad)`` (the scan takes it): the same participants,
    the loss within 1e-5, every param within the round's Adam bound and
    90% within 1e-6 (1 + |w|), as ``test_torch_lm_train`` holds
    granite's (which also holds this family's grads)."""
    jm, jp, tm, tp = _base()
    toks = np.random.default_rng(2).integers(
        0, tm.cfg.vocab_size, (C, T, BC, 16)).astype(np.int32)
    lr, rnd = 1e-3, 0
    wj, mj = jax.jit(partial(
        jcore.parallel_round, lambda p, x, k: jm.loss_fn(p, x),
        jopt.adam(lr), jcore.FedConfig(num_clients=C, local_steps=T)))(
        jp, {"tokens": jnp.asarray(toks)}, jnp.asarray(P), jnp.asarray(E),
        jnp.int32(rnd), jax.random.PRNGKey(rnd))
    wt, mt = tcore.parallel_round(
        lambda p, x, k: tm.loss_fn(p, x), topt.adam(lr),
        tcore.FedConfig(num_clients=C, local_steps=T), tp,
        {"tokens": torch.tensor(toks).long()}, torch.tensor(P),
        torch.tensor(E), rnd, prng.PRNGKey(rnd))
    assert float(mt["participants"]) == float(mj["participants"]) > 0
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-5, atol=1e-5)
    want, got = _flat(wj), _flat(wt)
    d = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    w = np.concatenate([np.abs(want[k]).ravel() for k in want])
    mask = np.asarray(jcore.participation_mask(
        "sustainable", 0, jnp.int32(rnd), jnp.asarray(E)))
    s = float((mask * P * E).sum())
    assert d.max() <= 2.0 * adam_step_bound(T) * lr * T * s, d.max()
    assert np.quantile(d / (1 + w), 0.9) <= 1e-6
