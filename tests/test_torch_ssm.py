"""The port's Mamba2 against the JAX package's, with the JAX ``init_params``
tree carried across by ``repro_torch.convert``.

mamba2-1.3b smoke config in fp32 (2 layers, d_model 128, 8 heads of 32,
state 16, chunk 16).  Tolerance: the reference's own serving tolerance
(``tests/test_decode.py``), 2e-4 absolute/relative on logits, outputs and
caches: fp32 with XLA's and PyTorch's CPU matmuls, einsums and prefix sums
in different orders through two layers.  Prompt lengths 16 and 32 take the
chunked scan (``kernels.ops.ssd_scan``, its plain version on the CPU); 9
and 1 take the per-step recurrence, as in the reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import get_model as jax_model
from repro.models import ssm as jssm
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import get_model
from repro_torch.models import ssm

TOL = dict(rtol=2e-4, atol=2e-4)
_BASE = {}


def _base():
    if not _BASE:
        jm = jax_model(jax_smoke("mamba2-1.3b"))
        jp = jm.init_params(jax.random.PRNGKey(0))
        tm = get_model(get_smoke_config("mamba2-1.3b"))
        _BASE["v"] = (jm, jp, tm, params_from_numpy(jp, device="cpu"))
    return _BASE["v"]


def _tokens(B, S, V, seed):
    return np.random.default_rng(seed).integers(0, V, (B, S)).astype(np.int32)


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _close(got, want, **kw):
    np.testing.assert_allclose(_np(got), _np(want), **{**TOL, **kw})


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


def test_params_tree_carries_across():
    """The reference's Mamba2 tree (in_proj, conv_w (C, K), conv_b, A_log,
    D, dt_bias, norm, out_proj under layers.mixer; layers.ln; embed; ln_f)
    arrives as the port's own tree: same keys, shapes (leading L axis) and
    dtypes, values bitwise."""
    jm, jp, tm, tp = _base()
    own = tm.init_params(torch.Generator().manual_seed(0))
    want = jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)), jp)
    assert _shapes(tp) == _shapes(own) == want
    assert set(tp["layers"]["mixer"]) == {"in_proj", "conv_w", "conv_b",
                                          "A_log", "D", "dt_bias", "norm",
                                          "out_proj"}
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in flat_j:
        t = tp
        for k in path:
            t = t[k.key]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def test_full_config_registers_serving():
    cfg = get_config("mamba2-1.3b")
    assert cfg == dataclasses.replace(cfg)           # a frozen config
    assert (cfg.num_layers, cfg.d_model, cfg.ssm_inner, cfg.ssm_heads,
            cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_chunk,
            cfg.ssm_conv, cfg.vocab_size, cfg.dtype) == (
        48, 2048, 4096, 64, 64, 128, 1, 256, 4, 50280, "bfloat16")
    assert cfg.num_params() == jax_config("mamba2-1.3b").num_params() \
        == 1_446_503_424
    model = get_model(cfg)
    assert model.prefill is not None and model.decode_step is not None
    assert model.init_cache is not None
    assert model.loss_fn.func is ssm.loss_fn          # trained too


def test_softplus_is_jax_softplus():
    x = np.concatenate([np.linspace(-40, 40, 4001, dtype=np.float32),
                        np.float32([-1e-8, 0.0, 1e-8, 19.99, 20.01, 88.0])])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = ssm._softplus(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    r = np.random.default_rng(1)
    B, S, C, K = 2, 7, 12, 4
    x = r.standard_normal((B, S, C)).astype(np.float32)
    w = r.standard_normal((C, K)).astype(np.float32)
    b = r.standard_normal(C).astype(np.float32)
    st = r.standard_normal((B, K - 1, C)).astype(np.float32) if with_state \
        else None
    jy, js = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b),
                               None if st is None else jnp.asarray(st))
    ty, ts = ssm._causal_conv(torch.tensor(x), torch.tensor(w),
                              torch.tensor(b),
                              None if st is None else torch.tensor(st))
    _close(ty, jy, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_np(ts), _np(js))


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("S,chunk", [(32, 8), (64, 16)])
def test_ssd_chunked_and_sequential_match_reference(G, S, chunk):
    """y and the final state of both scans, at G = 1 and G < H."""
    r = np.random.default_rng(2)
    B, H, P, N = 2, 8, 16, 8
    x = (r.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(r.standard_normal(H) * 0.3).astype(np.float32)
    Bm = (r.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    Cm = (r.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    J = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    T = [torch.tensor(a) for a in (x, dt, A, Bm, Cm)]
    jy, jh = jssm.ssd_chunked(*J, chunk)
    ty, th = ssm.ssd_chunked(*T, chunk)
    _close(ty, jy, rtol=2e-5, atol=2e-5)
    _close(th, jh, rtol=2e-5, atol=2e-5)
    jy, jh = jssm.ssd_sequential(*J)
    sy, sh = ssm.ssd_sequential(*T)
    _close(sy, jy, rtol=2e-5, atol=2e-5)
    _close(sh, jh, rtol=2e-5, atol=2e-5)
    h0 = (r.standard_normal((B, H, P, N)) * 0.1).astype(np.float32)
    jy, jh = jssm.ssd_sequential(*J, h0=jnp.asarray(h0))
    sy, sh = ssm.ssd_sequential(*T, h0=torch.tensor(h0))
    _close(sy, jy, rtol=2e-5, atol=2e-5)
    _close(sh, jh, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("S", [32, 9])
def test_mixer_matches_reference(S):
    """One mixer, chunked (S = 32) and sequential (S = 9): output and both
    states."""
    jm, jp, tm, tp = _base()
    cfg = tm.cfg
    x = (np.random.default_rng(3).standard_normal((2, S, cfg.d_model))
         .astype(np.float32))
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["mixer"])
    tl = {k: v[0] for k, v in tp["layers"]["mixer"].items()}
    jy, (jc, js) = jssm._mixer_apply(jm.cfg, jl, jnp.asarray(x))
    ty, (tc, ts) = ssm._mixer_apply(cfg, tl, torch.tensor(x))
    _close(ty, jy)
    _close(tc, jc)
    _close(ts, js)


def test_forward_matches_reference():
    jm, jp, tm, tp = _base()
    toks = _tokens(2, 32, tm.cfg.vocab_size, 4)
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, aux = tm.forward(tp, {"tokens": torch.tensor(toks).long()})
    assert tl.shape == (2, 32, tm.cfg.vocab_size) and tl.dtype == torch.float32
    assert float(aux) == 0.0
    _close(tl, jl)
    pl, _ = tm.forward(tp, {"tokens": torch.tensor(toks).long()},
                       padded_logits=True)
    assert pl.shape[-1] % 128 == 0
    torch.testing.assert_close(pl[..., :tm.cfg.vocab_size], tl)


@pytest.mark.parametrize("S", [16, 32, 9, 1])
def test_prefill_matches_reference(S):
    """Last-position logits and both caches, chunked and sequential."""
    jm, jp, tm, tp = _base()
    toks = _tokens(2, S, tm.cfg.vocab_size, 5 + S)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=S + 4)
    tl, tc = tm.prefill(tp, {"tokens": torch.tensor(toks).long()},
                        cache_len=S + 4)
    assert tl.shape == (2, 1, tm.cfg.vocab_size)
    _close(tl, jl)
    assert set(tc) == {"conv", "ssm"}
    for name in ("conv", "ssm"):
        assert tuple(tc[name].shape) == tuple(jc[name].shape)
        assert tc[name].dtype == {"conv": torch.float32,
                                  "ssm": torch.float32}[name]
        _close(tc[name], jc[name])


def test_init_cache_shapes_and_dtypes():
    cfg = dataclasses.replace(get_smoke_config("mamba2-1.3b"),
                              dtype="bfloat16")
    c = ssm.init_cache(cfg, 3, device="cpu")
    conv_ch = cfg.ssm_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    assert tuple(c["conv"].shape) == (cfg.num_layers, 3, cfg.ssm_conv - 1,
                                      conv_ch)
    assert c["conv"].dtype == torch.bfloat16
    assert tuple(c["ssm"].shape) == (cfg.num_layers, 3, cfg.ssm_heads,
                                     cfg.ssm_head_dim, cfg.ssm_state)
    assert c["ssm"].dtype == torch.float32
    assert not c["conv"].any() and not c["ssm"].any()


@pytest.mark.parametrize("S", [16, 9])
def test_decode_steps_match_reference_and_forward(S):
    """Prefill then 4 decode steps: logits and caches equal the reference's
    step by step, and the logits equal the port's own full forward at those
    positions.  The per-slot position vector is ignored."""
    jm, jp, tm, tp = _base()
    toks = _tokens(2, S + 4, tm.cfg.vocab_size, 6)
    full, _ = tm.forward(tp, {"tokens": torch.tensor(toks).long()})
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])})
    _, tc = tm.prefill(tp, {"tokens": torch.tensor(toks[:, :S]).long()})
    for j in range(4):
        jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, S + j]), jc, S + j)
        pos = torch.tensor([S + j, 1000])          # any positions
        tl, tc2 = tm.decode_step(tp, torch.tensor(toks[:, S + j]).long(), tc,
                                 pos)
        assert tc2 is tc                             # written in place
        _close(tl, jl)
        _close(tl, full[:, S + j])
        for name in ("conv", "ssm"):
            _close(tc[name], jc[name])


def test_impl_switch():
    """On the CPU the default path and ``impl="ref"`` are both the plain
    chunked scan; any other impl is refused."""
    _, _, tm, tp = _base()
    batch = {"tokens": torch.tensor(_tokens(1, 32, tm.cfg.vocab_size, 7))
             .long()}
    a, ca = tm.prefill(tp, batch)
    b, cb = tm.prefill(tp, batch, impl="ref")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(ca["ssm"], cb["ssm"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="impl"):
        tm.prefill(tp, batch, impl="flash")
    with pytest.raises(ValueError, match="impl"):
        tm.forward(tp, batch, impl="blocked")


def test_bf16_model_runs_and_keeps_cache_dtypes():
    """The served dtype: bf16 weights and conv cache, fp32 SSM state and
    logits, on both the chunked and the sequential prefill."""
    cfg = dataclasses.replace(get_smoke_config("mamba2-1.3b"),
                              dtype="bfloat16")
    model = get_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    assert params["layers"]["mixer"]["in_proj"].dtype == torch.bfloat16
    assert params["layers"]["mixer"]["A_log"].dtype == torch.float32
    for S in (32, 5):
        batch = {"tokens": torch.tensor(_tokens(1, S, cfg.vocab_size, S))
                 .long()}
        logits, cache = model.prefill(params, batch)
        assert logits.dtype == torch.float32
        assert bool(torch.isfinite(logits).all())
        assert cache["conv"].dtype == torch.bfloat16
        assert cache["ssm"].dtype == torch.float32
        logits, _ = model.decode_step(params, torch.tensor([3]), cache,
                                      torch.tensor([S]))
        assert bool(torch.isfinite(logits).all())
