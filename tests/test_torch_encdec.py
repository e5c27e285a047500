"""The port's encoder-decoder (family ``encdec``) against the JAX package's,
with the JAX ``init_params`` tree carried across by ``repro_torch.convert``.

whisper-tiny smoke config in fp32 (2 encoder + 2 decoder layers, 32
frames, d_model 128, 4 heads of 32).  Tolerance: the reference's own
serving tolerance (``tests/test_decode.py``), 2e-4 absolute/relative on
logits, memories and caches: fp32 with XLA's and PyTorch's CPU matmuls
summing in different orders (the observed gap is ~3e-6).  Greedy tokens
must be equal.
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
from repro.models import attention as jattn
from repro.models import encdec as jed
from repro.models import get_model as jax_model
from repro_torch import core as tcore
from repro_torch import optim as topt
from repro_torch import prng
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch.serve import generate
from repro_torch.models import attention, encdec, get_model
from test_torch_round import adam_step_bound

ARCH = "whisper-tiny"
TOL = dict(rtol=2e-4, atol=2e-4)
_BASE = {}


def _base():
    if not _BASE:
        jm = jax_model(jax_smoke(ARCH))
        jp = jm.init_params(jax.random.PRNGKey(0))
        tm = get_model(get_smoke_config(ARCH))
        _BASE["v"] = (jm, jp, tm, params_from_numpy(jp, device="cpu"))
    return _BASE["v"]


def _batch(cfg, lead, S, seed):
    """tokens (*lead, S) and frames (*lead, encoder_seq, d), numpy."""
    r = np.random.default_rng(seed)
    return {"tokens": r.integers(0, cfg.vocab_size, lead + (S,)).astype(
                np.int32),
            "frames": r.standard_normal(
                lead + (cfg.encoder_seq, cfg.d_model)).astype(np.float32)}


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b):
    return {k: torch.tensor(v).long() if v.dtype == np.int32
            else torch.tensor(v) for k, v in b.items()}


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _close(got, want, **kw):
    np.testing.assert_allclose(_np(got), _np(want), **{**TOL, **kw})


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_params_tree_carries_across():
    """The reference's tree (``enc_layers`` and ``dec_layers`` stacked, the
    decoder's ``xattn`` beside ``attn``) arrives as the port's own: same
    keys, shapes and dtypes, values bitwise."""
    jm, jp, tm, tp = _base()
    own = tm.init_params(torch.Generator().manual_seed(0))
    shapes = lambda t: {k: (tuple(v.shape),
                            str(v.dtype).replace("torch.", ""))
                        for k, v in _flat(t).items()}
    assert shapes(tp) == shapes(own) == shapes(jp)
    assert set(tp["dec_layers"]) == {"ln1", "attn", "lnx", "xattn", "ln2",
                                     "mlp"}
    for k, v in _flat(jp).items():
        np.testing.assert_array_equal(_flat(tp)[k].numpy(), np.asarray(v))


def test_full_config_is_served_and_trained():
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.encoder_layers, cfg.num_layers, cfg.encoder_seq,
            cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.vocab_size) == ("encdec", 4, 4, 1500, 384, 6, 6, 64, 51865)
    assert cfg.num_params() == jax_config(ARCH).num_params()
    model = get_model(cfg)
    assert model.loss_fn.func is encdec.loss_fn
    assert model.prefill.func is encdec.prefill


@pytest.mark.parametrize("impl", [None, "ref", "flash"])
def test_cross_attention_matches_reference_and_takes_no_kernel(impl):
    """``attention(memory=)``: keys and values from the memory, no RoPE,
    non-causal, against the reference; whatever ``impl`` says, the call
    never reaches the kernel (the reference's dispatch)."""
    jm, jp, tm, tp = _base()
    jx = jax.tree_util.tree_map(lambda a: a[0], jp["dec_layers"]["xattn"])
    tx = params_from_numpy(jx, device="cpu")
    r = np.random.default_rng(1)
    x = r.standard_normal((2, 9, 128)).astype(np.float32)
    mem = r.standard_normal((2, 32, 128)).astype(np.float32)
    rope = dataclasses.replace(jm.cfg, pos_type="rope")
    trope = dataclasses.replace(tm.cfg, pos_type="rope")
    real = ops.flash_attention

    def refuse(*a, **kw):
        raise AssertionError("cross-attention reached the kernel")

    ops.flash_attention = refuse
    try:
        for jc, tc in ((jm.cfg, tm.cfg), (rope, trope)):
            want, (jk, jv) = jattn.attention(jc, jx, jnp.asarray(x),
                                             memory=jnp.asarray(mem))
            got, (tk, tv) = attention.attention(
                tc, tx, torch.tensor(x), memory=torch.tensor(mem), impl=impl)
            assert tk.shape == (2, 32, 4, 32)
            _close(got, want)
            _close(tk, jk)
            _close(tv, jv)
    finally:
        ops.flash_attention = real


@pytest.mark.parametrize("impl", ["ref", "flash"])
def test_encode_matches_reference(impl):
    """Non-causal self-attention over the frames, sinusoidal positions; the
    port's flash path (its plain version on the CPU) too."""
    jm, jp, tm, tp = _base()
    b = _batch(tm.cfg, (2,), 4, 2)
    want = jax.jit(partial(jed.encode, jm.cfg))(jp, jnp.asarray(b["frames"]))
    got = encdec.encode(tm.cfg, tp, torch.tensor(b["frames"]), impl=impl)
    assert got.shape == (2, 32, 128)
    _close(got, want)


def test_forward_and_loss_match_reference():
    jm, jp, tm, tp = _base()
    b = _batch(tm.cfg, (2,), 24, 3)
    jl, _ = jm.forward(jp, _j(b))
    tl, aux = tm.forward(tp, _t(b))
    assert tl.shape == (2, 24, tm.cfg.vocab_size) and float(aux) == 0.0
    _close(tl, jl)
    np.testing.assert_allclose(float(tm.loss_fn(tp, _t(b))),
                               float(jm.loss_fn(jp, _j(b))), rtol=1e-5,
                               atol=1e-5)
    # the frames reach the logits
    b2 = dict(b, frames=b["frames"][::-1].copy())
    assert (tm.forward(tp, _t(b2))[0] - tl).abs().max() > 1e-2


@pytest.mark.parametrize("S,cache_len", [(1, 9), (17, 22), (24, 24)])
def test_prefill_matches_reference(S, cache_len):
    """Last-position logits and the cache: self-attention k, v at positions
    0..S-1 then zeros to ``cache_len``, the memory's xk, xv."""
    jm, jp, tm, tp = _base()
    b = _batch(tm.cfg, (2,), S, 4 + S)
    jl, jc = jm.prefill(jp, _j(b), cache_len=cache_len)
    tl, tc = tm.prefill(tp, _t(b), cache_len=cache_len)
    assert tl.shape == (2, 1, tm.cfg.vocab_size)
    _close(tl, jl)
    assert set(tc) == {"k", "v", "xk", "xv"}
    assert tuple(tc["k"].shape) == (2, 2, cache_len, 4, 32)
    assert tuple(tc["xk"].shape) == (2, 2, 32, 4, 32)
    for name in tc:
        assert tuple(tc[name].shape) == tuple(jc[name].shape)
        _close(tc[name], jc[name], err_msg=name)
    assert not tc["k"][:, :, S:].any() and not tc["v"][:, :, S:].any()


def test_prefill_decode_match_forward():
    """The twin of ``tests/test_decode.py::test_prefill_decode_match_forward``:
    prefill S tokens, decode 4: each step's logits equal the full forward at
    that position and the reference's decode; the greedy tokens of
    ``generate`` equal the reference's."""
    jm, jp, tm, tp = _base()
    S = 12
    b = _batch(tm.cfg, (2,), S + 4, 5)
    full, _ = tm.forward(tp, _t(b))
    prompt = dict(b, tokens=b["tokens"][:, :S])
    jl, jc = jm.prefill(jp, _j(prompt), cache_len=S + 5)
    tl, tc = tm.prefill(tp, _t(prompt), cache_len=S + 5)
    _close(tl[:, 0], full[:, S - 1])
    jdecode = jax.jit(jm.decode_step)
    toks = b["tokens"]
    for j in range(4):
        jl, jc = jdecode(jp, jnp.asarray(toks[:, S + j]), jc,
                         jnp.int32(S + j))
        tl, tc2 = tm.decode_step(tp, torch.tensor(toks[:, S + j]).long(), tc,
                                 torch.tensor([S + j, S + j]))
        assert tc2 is tc                             # written in place
        _close(tl, full[:, S + j])
        _close(tl, jl)
    for name in tc:
        _close(tc[name], jc[name], err_msg=name)
    jt = jgenerate(jm, jp, _j(prompt), 6, S + 7, rng=jax.random.PRNGKey(0))
    tt = generate(tm, tp, _t(prompt), 6, S + 7, device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


C, T, BC = 4, 2, 2
E = np.array([1, 2, 4, 8], np.int32)
P = np.full(C, 1.0 / C, np.float32)


def test_parallel_round_matches_reference():
    """One sustainable round of C=4 clients, T=2 Adam steps under
    ``torch.func.vmap(grad)``, each client's batch with its own frames:
    the same participants, the loss within 1e-5, every param within the
    round's Adam bound and 90% within 1e-6 (1 + |w|), as
    ``test_torch_lm_train`` holds granite's (which also holds this
    family's grads)."""
    jm, jp, tm, tp = _base()
    b = _batch(tm.cfg, (C, T, BC), 16, 6)
    lr, rnd = 1e-3, 0
    wj, mj = jax.jit(partial(
        jcore.parallel_round, lambda p, x, k: jm.loss_fn(p, x),
        jopt.adam(lr), jcore.FedConfig(num_clients=C, local_steps=T)))(
        jp, _j(b), jnp.asarray(P), jnp.asarray(E), jnp.int32(rnd),
        jax.random.PRNGKey(rnd))
    wt, mt = tcore.parallel_round(
        lambda p, x, k: tm.loss_fn(p, x), topt.adam(lr),
        tcore.FedConfig(num_clients=C, local_steps=T), tp, _t(b),
        torch.tensor(P), torch.tensor(E), rnd, prng.PRNGKey(rnd))
    assert float(mt["participants"]) == float(mj["participants"]) > 0
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-5, atol=1e-5)
    want = {k: np.asarray(v) for k, v in _flat(wj).items()}
    got = {k: _np(v) for k, v in _flat(wt).items()}
    d = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    w = np.concatenate([np.abs(want[k]).ravel() for k in want])
    mask = np.asarray(jcore.participation_mask(
        "sustainable", 0, jnp.int32(rnd), jnp.asarray(E)))
    s = float((mask * P * E).sum())
    assert d.max() <= 2.0 * adam_step_bound(T) * lr * T * s, d.max()
    assert np.quantile(d / (1 + w), 0.9) <= 1e-6
