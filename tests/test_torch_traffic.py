"""``repro_torch.serve.traffic`` against the JAX package's request
processes over 40 epochs of 3000 clients: ``Constant`` counts and ``MMPP``
regimes bitwise; MMPP's Poisson counts and ``DiurnalPoisson``'s rates
within a few ulp (``exp`` and ``sin`` are rounded differently), so their
counts differ only where the uniform lies within a few ulp of a cdf step
(at most 1e-3 of the draws here); padding the fleet changes no client's
stream."""
import jax
import numpy as np
import pytest
import torch

from repro.serve import traffic as jtr
from repro_torch import prng
from repro_torch.serve import traffic as ttr

N, T = 3000, 40


def _stream(mod, proc, n, keyfn):
    state = proc.init()
    out, states = [], []
    for t in range(T):
        req, state = proc.sample(keyfn(t), t, state)
        out.append(np.asarray(req.numpy() if isinstance(req, torch.Tensor)
                              else req))
        if not isinstance(state, tuple):
            states.append(np.asarray(state.numpy() if isinstance(
                state, torch.Tensor) else state))
    return np.stack(out), (np.stack(states) if states else None)


def _both(make_j, make_t, n=N, seed=7):
    jkey = jax.random.PRNGKey(seed)
    tkey = prng.PRNGKey(seed)
    j = _stream(jtr, make_j(n), n, lambda t: jax.random.fold_in(jkey, t))
    t = _stream(ttr, make_t(n), n, lambda t: prng.fold_in(tkey, t))
    return j, t


def test_constant_is_bitwise():
    rate = np.random.default_rng(0).integers(0, 9, N).astype(np.float32)
    (jr, _), (tr_, _) = _both(lambda n: jtr.Constant.create(n, rate),
                              lambda n: ttr.Constant.create(n, rate))
    assert tr_.dtype == np.float32 and np.array_equal(tr_, jr)


@pytest.mark.parametrize("rates", [(0.5, 4.0), (2.0, 9.0)])
def test_mmpp_regimes_bitwise_counts_within_ulps(rates):
    make = lambda mod: lambda n: mod.MMPP.create(
        n, p_stay_calm=0.8, p_stay_burst=0.6, calm_rate=rates[0],
        burst_rate=rates[1])
    (jr, js), (tr_, ts) = _both(make(jtr), make(ttr))
    assert np.array_equal(ts, js)                     # regimes
    assert ts.dtype == np.int32
    moved = np.abs(tr_ - jr)
    assert moved.max() <= 1 and (moved > 0).mean() <= 1e-3
    assert np.array_equal(tr_, np.round(tr_))


def test_diurnal_rate_within_ulps_and_counts_close():
    phase = np.arange(N) % 24
    r = np.random.default_rng(1)
    base = r.uniform(0.2, 3.0, N).astype(np.float32)
    jp = jtr.DiurnalPoisson.create(N, base=base, swing=0.9, phase=phase)
    tp = ttr.DiurnalPoisson.create(N, base=base, swing=0.9, phase=phase)
    for t in (0, 5, 17, 100, 10_000):
        a = tp.rate_at(t).numpy()
        b = np.asarray(jp.rate_at(t))
        assert a.dtype == np.float32
        assert np.all(np.abs(a - b) <= 4 * np.spacing(np.abs(b)) + 1e-7), t
    (jr, _), (tr_, _) = _both(lambda n: jp, lambda n: tp)
    moved = np.abs(tr_ - jr)
    assert moved.max() <= 1 and (moved > 0).mean() <= 1e-3
    assert abs(tr_.mean() - base.mean()) < 0.05 * base.mean()


def test_streams_are_padding_invariant():
    n, pad = 37, 64
    key = prng.PRNGKey(3)
    for make in (lambda m: ttr.MMPP.create(m, calm_rate=1.0),
                 lambda m: ttr.DiurnalPoisson.create(m, base=2.0,
                                                     phase=np.arange(m) % 24)):
        small, big = make(n), make(pad)
        a, _ = small.sample(key, 5, small.init())
        b, _ = big.sample(key, 5, big.init())
        assert torch.equal(a, b[:n])
