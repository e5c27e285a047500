"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's, on the olmoe-1b-7b and mixtral-8x7b smoke configs in fp32 with
the JAX ``moe_init`` params carried across by ``repro_torch.convert``.

Tolerances: the router's choices (top-k ids) must be equal; weights,
outputs and the aux loss within 1e-5 (fp32 matmuls and sums in other
orders; observed ~4e-6 on outputs of order 1).  With a capacity factor
small enough that tokens drop, ``dispatch`` and ``sorted`` must drop the
same tokens as the reference: the outputs would otherwise differ by a
whole expert's share.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.configs import get_smoke_config as jax_smoke
from repro.models import moe as jmoe
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("olmoe-1b-7b", "mixtral-8x7b")
DROP_CF = 0.5          # capacity half the mean load: tokens drop


def _setup(arch, **over):
    jcfg = dataclasses.replace(jax_smoke(arch), **over)
    tcfg = dataclasses.replace(get_smoke_config(arch), **over)
    jp = jmoe.moe_init(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_numpy(jp, device="cpu")


def _x(cfg, B=2, S=16, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch):
    jcfg, tcfg, jp, tp = _setup(arch)
    x = _x(jcfg)
    jw, jidx, jaux = jax.jit(partial(jmoe._route, jcfg))(jp, jnp.asarray(x))
    tw, tidx, taux = moe._route(tcfg, tp, torch.tensor(x))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)


def test_route_ties_go_to_the_lower_expert():
    """A zero router gives every expert the same probability: both packages
    pick experts 0..k-1, in that order (``jax.lax.top_k``'s tie rule)."""
    jcfg, tcfg, jp, tp = _setup("olmoe-1b-7b")
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = _x(jcfg, B=1, S=3)
    _, jidx, _ = jmoe._route(jcfg, jp, jnp.asarray(x))
    _, tidx, _ = moe._route(tcfg, tp, torch.tensor(x))
    k = tcfg.experts_per_token
    np.testing.assert_array_equal(np.asarray(jidx), np.broadcast_to(
        np.arange(k), (1, 3, k)))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", moe.MODES)
@pytest.mark.parametrize("cf", [1.25, DROP_CF])
def test_apply_moe_matches_reference(arch, mode, cf):
    jcfg, tcfg, jp, tp = _setup(arch, moe_mode=mode, capacity_factor=cf)
    x = _x(jcfg)
    jy, jaux = jax.jit(partial(jmoe.apply_moe, jcfg))(jp, jnp.asarray(x))
    ty, taux = moe.apply_moe(tcfg, tp, torch.tensor(x))
    assert ty.shape == x.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["dispatch", "sorted", "sorted_local"])
def test_small_capacity_drops_tokens(arch, mode):
    """At ``DROP_CF`` the capacity modes really drop: their output moves
    away from the dropless dense mode's, on whole tokens."""
    _, tcfg, _, tp = _setup(arch, capacity_factor=DROP_CF)
    x = torch.tensor(_x(tcfg))
    dense, _ = moe.apply_moe(tcfg, tp, x, mode="dense")
    capped, _ = moe.apply_moe(tcfg, tp, x, mode=mode)
    moved = (capped - dense).abs().amax(-1) > 1e-3          # (B, S)
    assert 0 < int(moved.sum()) < moved.numel()


@pytest.mark.parametrize("mode", moe.MODES)
def test_apply_moe_grads_under_vmap(mode):
    """``torch.func.vmap(grad(...))`` over stacked params (the parallel
    round's form) equals each member's own ``grad``."""
    _, tcfg, _, tp = _setup("olmoe-1b-7b", moe_mode=mode,
                            capacity_factor=DROP_CF)
    stack = {k: torch.stack([v, 1.1 * v, 0.9 * v]) for k, v in tp.items()}
    x = torch.tensor(np.stack([_x(tcfg, seed=s) for s in range(3)]))

    def f(p, xb):
        y, aux = moe.apply_moe(tcfg, p, xb)
        return y.square().mean() + aux

    got = vmap(grad(f))(stack, x)
    for c in range(3):
        want = grad(f)({k: v[c] for k, v in stack.items()}, x[c])
        for k in want:
            torch.testing.assert_close(got[k][c], want[k], rtol=1e-6,
                                       atol=1e-7)


def test_unknown_mode_raises():
    _, tcfg, _, tp = _setup("olmoe-1b-7b")
    with pytest.raises(ValueError, match="moe_mode"):
        moe.apply_moe(tcfg, tp, torch.zeros(1, 2, tcfg.d_model), mode="bad")
