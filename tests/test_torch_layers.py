"""The port's building blocks against ``repro.models.layers`` on the same
numpy inputs.  Tolerance: fp32 throughout; 1e-5 absolute/relative covers
the different summation order of XLA's and PyTorch's CPU reductions and
matmuls at these widths (<= 512)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import layers as JL
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import layers as TL

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def test_rmsnorm_and_layernorm():
    r = _rng(1)
    x = r.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = r.standard_normal(64).astype(np.float32) * 0.1
    bias = r.standard_normal(64).astype(np.float32) * 0.1
    _close(TL.rmsnorm(torch.tensor(x), torch.tensor(scale), 1e-5),
           JL.rmsnorm(jnp.asarray(x), jnp.asarray(scale), 1e-5))
    _close(TL.layernorm(torch.tensor(x), torch.tensor(scale),
                        torch.tensor(bias), 1e-5),
           JL.layernorm(jnp.asarray(x), jnp.asarray(scale),
                        jnp.asarray(bias), 1e-5))


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_apply_norm_dispatch(norm_type):
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"),
                              norm_type=norm_type)
    jcfg = dataclasses.replace(jax_smoke("granite-3-2b"), norm_type=norm_type)
    r = _rng(2)
    x = r.standard_normal((3, cfg.d_model)).astype(np.float32)
    p = {"scale": r.standard_normal(cfg.d_model).astype(np.float32),
         "bias": r.standard_normal(cfg.d_model).astype(np.float32)}
    _close(TL.apply_norm(cfg, {k: torch.tensor(v) for k, v in p.items()},
                         torch.tensor(x)),
           JL.apply_norm(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x)))


@pytest.mark.parametrize("positions", ["prefill", "per_slot"])
def test_rope_split_halves(positions):
    r = _rng(3)
    x = r.standard_normal((2, 6, 4, 64)).astype(np.float32)
    if positions == "prefill":
        pos = np.arange(6) + 100
    else:                       # (B, S) per-row positions, as decode uses
        pos = np.array([[7] * 6, [4093] * 6])
    _close(TL.apply_rope(torch.tensor(x), torch.tensor(pos), 1e4),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_mlp(mlp_type):
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"),
                              mlp_type=mlp_type)
    jcfg = dataclasses.replace(jax_smoke("granite-3-2b"), mlp_type=mlp_type)
    r = _rng(4)
    d, ff = cfg.d_model, cfg.d_ff
    wi_w = 2 * ff if mlp_type == "swiglu" else ff
    p = {"wi": r.standard_normal((d, wi_w)) * d ** -0.5,
         "wo": r.standard_normal((ff, d)) * ff ** -0.5}
    if mlp_type == "gelu":
        p["bi"] = r.standard_normal(ff) * 0.1
        p["bo"] = r.standard_normal(d) * 0.1
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = r.standard_normal((2, 3, d)).astype(np.float32)
    _close(TL.apply_mlp(cfg, {k: torch.tensor(v) for k, v in p.items()},
                        torch.tensor(x)),
           JL.apply_mlp(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x)))


def test_padded_vocab():
    assert TL.padded_vocab(get_config("granite-3-2b")) == 49280
    cfg = get_smoke_config("granite-3-2b")
    assert TL.padded_vocab(cfg) == JL.padded_vocab(jax_smoke("granite-3-2b"))


@pytest.mark.parametrize("pos_type", ["rope", "learned", "sinusoidal"])
def test_embed_and_unembed_padded_vocab(pos_type):
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"),
                              pos_type=pos_type, max_position=64)
    jcfg = dataclasses.replace(jax_smoke("granite-3-2b"), pos_type=pos_type,
                               max_position=64)
    r = _rng(5)
    V, Vp, d = cfg.vocab_size, TL.padded_vocab(cfg), cfg.d_model
    p = {"tok": r.standard_normal((V, d)) * 0.02,
         "unembed": r.standard_normal((d, Vp)) * 0.02,
         "pos": r.standard_normal((64, d)) * 0.02}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    tp = {k: torch.tensor(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tokens = r.integers(0, V, (2, 7))
    x_t = TL.embed_tokens(cfg, tp, torch.tensor(tokens), pos_offset=3)
    x_j = JL.embed_tokens(jcfg, jp, jnp.asarray(tokens), pos_offset=3)
    _close(x_t, x_j)
    for padded in (False, True):
        got = TL.unembed(cfg, tp, x_t, padded=padded)
        want = JL.unembed(jcfg, jp, x_j, padded=padded)
        assert got.dtype == torch.float32
        assert got.shape[-1] == (Vp if padded else V)
        _close(got, want)


def test_sinusoidal():
    pos = np.arange(0, 40, 3)
    _close(TL.sinusoidal(torch.tensor(pos), 32),
           JL.sinusoidal(jnp.asarray(pos), 32))
