"""The round's client reductions of ``repro_torch.dist.collectives``
(``tree_pmean``, ``weighted_client_sum``, ``cross_client_delta``,
``participation_count``, ``masked_mean``) with ``group=None``, against the
JAX package's under ``jax.vmap(axis_name=...)``, as ``tests/test_dist.py``
holds them.  The port sums a stack of client rows where the reference
sums over a mapped axis, one client a lane: every lane of the reference's
result is the port's.  The same functions over two gloo ranks are held in
``tests/test_torch_steps_sharded.py``'s spawn.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.dist import collectives as jcol
from repro_torch.dist import collectives as col

AXIS = "clients"
C = 6


def _inputs(seed, dtype=np.float32):
    r = np.random.default_rng(seed)
    tree = {"a": r.standard_normal((C, 4, 3)).astype(dtype),
            "b": {"c": r.standard_normal((C, 5)).astype(dtype)}}
    w_global = {"a": r.standard_normal((4, 3)).astype(dtype),
                "b": {"c": r.standard_normal(5).astype(dtype)}}
    coeff = np.abs(r.standard_normal(C)).astype(np.float32)
    alpha = (r.random(C) < 0.5).astype(np.float32)
    alpha[0] = 1.0
    loss = r.standard_normal(C).astype(np.float32)
    return tree, w_global, coeff, alpha, loss


def _t(tree, dtype=None):
    return jax.tree.map(lambda a: torch.tensor(a) if dtype is None
                        else torch.tensor(a).to(dtype), tree)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return np.asarray(jnp.asarray(tree, jnp.float32))


def _each_lane(mapped, got, **tol):
    """Every lane of the reference's mapped result equals the port's."""
    for m, g in zip(jax.tree.leaves(_np(mapped)), jax.tree.leaves(_np(got))):
        assert m.shape == (C,) + g.shape
        for lane in m:
            np.testing.assert_allclose(g, lane, **tol)


@pytest.mark.parametrize("seed", [0, 1])
def test_tree_pmean(seed):
    tree, *_ = _inputs(seed)
    want = jax.vmap(lambda t: jcol.tree_pmean(t, AXIS), axis_name=AXIS)(tree)
    got = col.tree_pmean(_t(tree))
    _each_lane(want, got, rtol=1e-6, atol=1e-6)
    assert jax.tree.leaves(got)[0].dtype == torch.float32


def test_tree_pmean_casts_back_bf16():
    tree, *_ = _inputs(2)
    tb = _t(tree, torch.bfloat16)
    jb = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    want = jax.vmap(lambda t: jcol.tree_pmean(t, AXIS), axis_name=AXIS)(jb)
    got = col.tree_pmean(tb)
    assert all(x.dtype == torch.bfloat16 for x in jax.tree.leaves(got))
    # float32 means rounded once to bf16 on both sides: within one ulp
    _each_lane(want, got, rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_weighted_client_sum(seed):
    tree, _, coeff, _, _ = _inputs(seed)
    want = jax.vmap(lambda t, c: jcol.weighted_client_sum(t, c, AXIS),
                    axis_name=AXIS)(tree, coeff)
    got = col.weighted_client_sum(_t(tree), torch.tensor(coeff))
    _each_lane(want, got, rtol=1e-5, atol=1e-6)
    assert all(x.dtype == torch.float32 for x in jax.tree.leaves(got))


@pytest.mark.parametrize("seed", [0, 1])
def test_cross_client_delta(seed):
    tree, w_global, coeff, _, _ = _inputs(seed)
    want = jax.vmap(lambda wl, c: jcol.cross_client_delta(
        wl, w_global, c, AXIS), axis_name=AXIS)(tree, coeff)
    got = col.cross_client_delta(_t(tree), _t(w_global),
                                 torch.tensor(coeff))
    _each_lane(want, got, rtol=1e-5, atol=1e-6)
    # the aggregation's numerator (eq. 13)
    dense = jagg._weighted_delta_sum(tree, w_global, jnp.asarray(coeff))
    for d, g in zip(jax.tree.leaves(_np(dense)), jax.tree.leaves(_np(got))):
        np.testing.assert_allclose(g, d, rtol=1e-5, atol=1e-6)


def test_cross_client_delta_bf16_returns_float32():
    tree, w_global, coeff, _, _ = _inputs(3)
    got = col.cross_client_delta(_t(tree, torch.bfloat16),
                                 _t(w_global, torch.bfloat16),
                                 torch.tensor(coeff))
    jb = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), t)
    want = jax.vmap(lambda wl, c: jcol.cross_client_delta(
        wl, jb(w_global), c, AXIS), axis_name=AXIS)(jb(tree), coeff)
    assert all(x.dtype == torch.float32 for x in jax.tree.leaves(got))
    _each_lane(want, got, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_participation_count_and_masked_mean(seed):
    _, _, _, alpha, loss = _inputs(seed)
    mean, count = jax.vmap(
        lambda l, a: (jcol.masked_mean(l, a, AXIS),
                      jcol.participation_count(a, AXIS)),
        axis_name=AXIS)(loss, alpha)
    got_count = col.participation_count(torch.tensor(alpha))
    got_mean = col.masked_mean(torch.tensor(loss), torch.tensor(alpha))
    assert float(got_count) == float(count[0]) == float(alpha.sum())
    np.testing.assert_allclose(float(got_mean), np.asarray(mean),
                               rtol=1e-6)


def test_masked_mean_of_no_participants_is_zero():
    loss = torch.tensor([1.0, 2.0])
    alpha = torch.zeros(2)
    want = jax.vmap(lambda l, a: jcol.masked_mean(l, a, AXIS),
                    axis_name=AXIS)(jnp.asarray([1.0, 2.0]), jnp.zeros(2))
    assert float(col.masked_mean(loss, alpha)) == float(want[0]) == 0.0


def test_all_reduce_sum_without_group_is_identity():
    xs = [torch.randn(3), torch.randn(2, 2)]
    out = col.all_reduce_sum(xs)
    assert all(a is b for a, b in zip(out, xs))
