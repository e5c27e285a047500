"""``repro_torch.energy.arrivals`` against the JAX package's
``energy/arrivals.py`` (jitted): per-client uniforms and randints,
Bernoulli and DeterministicRenewal harvests and MarkovSolar regimes
bitwise; exponential marks within 2 ulp (``log1p`` is rounded differently
by XLA's CPU backend and by PyTorch); truncated-Poisson counts equal
except where ``u`` lies within a few ulp of a cdf step (``exp`` is);
MarkovSolar and CompoundPoisson harvests within 4 ulp while the counts
agree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.energy import arrivals as ja
from repro_torch import prng
from repro_torch.energy import arrivals as ta

N = 100_000


def _keys(seed, r):
    return (jax.random.fold_in(jax.random.PRNGKey(seed), r),
            prng.fold_in(prng.PRNGKey(seed), r))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("seed,n", [(0, 1), (3, 1000), (7, N)])
def test_client_uniform_and_randint_bitwise(seed, n):
    kj, kt = _keys(seed, 11)
    np.testing.assert_array_equal(
        ta.client_uniform(kt, n).numpy(),
        np.asarray(jax.jit(ja.client_uniform, static_argnums=1)(kj, n)))
    np.testing.assert_array_equal(
        ta.client_randint(kt, n, 7).numpy(),
        np.asarray(jax.jit(ja.client_randint, static_argnums=(1, 2))(
            kj, n, 7)))
    np.testing.assert_array_equal(
        ta.client_keys(kt, n).numpy(),
        np.asarray(jax.random.key_data(jax.vmap(jax.random.fold_in,
                                                (None, 0))(
            kj, jnp.arange(n, dtype=jnp.uint32)))).astype(np.int64))


@pytest.mark.parametrize("shape", [(), (8,)])
def test_client_exponential_within_two_ulp(shape):
    kj, kt = _keys(1, 2)
    want = jax.jit(ja.client_exponential, static_argnums=(1, 2))(kj, N,
                                                                 shape)
    got = ta.client_exponential(kt, N, shape)
    assert got.shape == (N,) + shape
    d = _ulps(got.numpy(), want)
    assert d.max() <= 2, d.max()
    assert (d > 0).mean() < 0.2          # most marks agree exactly


def test_prng_exponential_is_minus_log1p_of_the_uniform():
    k = prng.PRNGKey(5)
    u = prng.uniform(k, (1000,))
    assert torch.equal(prng.exponential(k, (1000,)), -torch.log1p(-u))


def test_truncated_poisson_counts_equal_except_at_cdf_steps():
    """Counts differ only where u lies within 4 ulp of one of the
    reference's cdf values (its exp(-rate) and the port's differ by an
    ulp); such clients are rare."""
    r = np.random.default_rng(0)
    u = r.uniform(size=N).astype(np.float32)
    rate = r.uniform(0.05, 3.0, N).astype(np.float32)
    want = np.asarray(jax.jit(ja.truncated_poisson, static_argnums=2)(
        u, rate, 8))
    got = ta.truncated_poisson(torch.tensor(u), torch.tensor(rate), 8)
    assert got.dtype == torch.int32
    diff = np.nonzero(got.numpy() != want)[0]

    def cdfs(rt):
        pmf = jnp.exp(-rt)
        out, cdf = [pmf], pmf
        for j in range(8):
            pmf = pmf * rt / (j + 1)
            cdf = cdf + pmf
            out.append(cdf)
        return jnp.stack(out, axis=-1)

    steps = np.asarray(jax.jit(cdfs)(rate[diff]))
    near = np.min(_ulps(np.broadcast_to(u[diff, None], steps.shape), steps),
                  axis=1)
    assert np.all(near <= 4), near.max()
    assert len(diff) <= 1e-3 * N, len(diff)


def _process(mod, name, n):
    """Named processes with per-client parameters from one numpy draw."""
    r = np.random.default_rng(9)
    E = r.integers(1, 6, n).astype(np.int32)
    return {
        "bernoulli": lambda: mod.Bernoulli.create(
            n, prob=r.uniform(0.2, 0.8, n).astype(np.float32), amount=1.2),
        "renewal": lambda: mod.DeterministicRenewal.create(
            E, unit=0.75, phase=r.integers(0, 5, n).astype(np.int32)),
        "solar": lambda: mod.MarkovSolar.create(
            n, p_stay_day=0.9, p_stay_night=0.8, day_mean=0.9,
            night_mean=0.05),
        "poisson": lambda: mod.CompoundPoisson.create(n, rate=0.4,
                                                      mean_amount=1.5),
        "solar+rf": lambda: mod.Sum((
            mod.Scaled.create(mod.MarkovSolar.create(n, day_mean=0.9),
                              gain=np.linspace(0.5, 2.0, n,
                                               dtype=np.float32)),
            mod.CompoundPoisson.create(n, rate=0.1, mean_amount=0.3))),
    }[name]()


def _state_leaves(s):
    if isinstance(s, (tuple, list)):
        return [x for v in s for x in _state_leaves(v)]
    return [s]


@pytest.mark.parametrize("name", ["bernoulli", "renewal", "solar",
                                  "poisson", "solar+rf"])
def test_processes_match_reference_over_rounds(name):
    n = 20_000
    pj, pt = _process(ja, name, n), _process(ta, name, n)
    assert pt.num_clients == pj.num_clients == n
    sj, st = pj.init(), pt.init()
    for r in range(6):
        kj, kt = _keys(4, r)
        hj, sj = jax.jit(pj.sample)(kj, r, sj)
        ht, st = pt.sample(kt, r, st)
        for a, b in zip(_state_leaves(st), jax.tree.leaves(sj)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        if name in ("bernoulli", "renewal"):
            np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
        else:
            d = _ulps(ht.numpy(), hj)
            zero = (ht.numpy() == 0) != (np.asarray(hj) == 0)
            assert not zero.any()          # the same arrivals
            assert d.max() <= 4, (r, d.max())


def test_harvest_is_padding_invariant():
    """Client i's draw depends on (key, i) only: a larger fleet repeats
    the smaller one's harvests on its first clients."""
    kt = prng.PRNGKey(2)
    small = ta.CompoundPoisson.create(100, rate=0.7).sample(kt, 0, ())[0]
    big = ta.CompoundPoisson.create(1000, rate=0.7).sample(kt, 0, ())[0]
    assert torch.equal(big[:100], small)


def test_map_tensors_moves_every_parameter():
    p = _process(ta, "solar+rf", 16)
    q = ta.map_tensors(p, lambda t: t.double())
    assert q.parts[0].gain.dtype == torch.float64
    assert q.parts[0].base.day_mean.dtype == torch.float64
    assert q.parts[1].max_arrivals == 8
    assert ta.map_device(q) == torch.device("cpu")
