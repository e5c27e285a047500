"""The port's aggregation, round engine and faithful simulator against the
JAX package's, on the same params (numpy) and batches; and the engine's
own properties (sequential == parallel, no-op rounds, fresh optimizer
state, micro-batch errors).

Tolerances, with their reasons:

* SGD and the aggregation: float32 sums in other orders.  One CNN round
  is held at rtol 1e-5, atol 1e-6 (params ~0.5, observed ~6e-8).
* Adam: its first steps amplify gradient noise near g = 0 by up to
  lr / eps = 1e5 (step = lr m^ / (sqrt(v^) + eps), and m^ / sqrt(v^) is
  +-1 for any tiny g on the first step), so an element whose true
  gradient sits at the rounding noise may move by up to the whole step on
  one side and not on the other.  Every element is therefore held to the
  hard bound ``adam_bound``: each client's local delta differs by at most
  2 a lr T per element, where a is the largest |m^| / sqrt(v^) over T
  steps (Cauchy-Schwarz on the moment sums: 1.01 for T <= 5), and the
  server scales it by sum_c s_c; over R rounds the bounds add.  The bulk
  of a round from the same params follows float32: 90% of the elements
  within ``BULK_TOL`` = 1e-6 (1 + |w|) (observed <= 1e-7), which a fault
  that moves the whole update breaks.  Over many rounds the runs drift
  apart (E-scaled aggregation amplifies the differences), so each round
  is also held against a reference round from the port's own params
  before it.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import optim as jopt
from repro.configs import get_config as jget_config
from repro.data import FederatedLoader, SyntheticImages, iid_partition
from repro.models import get_model as jget_model
from repro_torch import core as tcore
from repro_torch import optim as topt
from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.convert import cnn_params_from_numpy, cnn_params_to_numpy
from repro_torch.models import cnn as cnn_module
from repro_torch.models import get_model

C, T, B = 4, 2, 8
E = np.array([1, 5, 10, 20], np.int32)
P = np.full(C, 1.0 / C, np.float32)
LR = 1e-3
BULK_Q, BULK_TOL = 0.9, 1e-6


def adam_step_bound(T, b1=0.9, b2=0.999):
    """Largest |m^| / sqrt(v^) of Adam within its first T steps."""
    worst = 0.0
    for t in range(1, T + 1):
        s = sum((1 - b1) ** 2 * b1 ** (2 * k) / ((1 - b2) * b2 ** k)
                for k in range(t))
        worst = max(worst, math.sqrt(s) * math.sqrt(1 - b2 ** t)
                    / (1 - b1 ** t))
    return worst


def adam_bound(masks, policy, lr=LR, T=T, E=E, p=P):
    """Per-element bound on |w_a - w_b| after the rounds of ``masks`` for
    two Adam runs from the same params (see the module docstring)."""
    scale = E.astype(np.float32) if policy == "sustainable" else np.ones(len(E))
    s = sum(float((m * p * scale).sum()) for m in masks)
    return 2.0 * adam_step_bound(T) * lr * T * s


@pytest.fixture(scope="module")
def cnn():
    jm = jget_model(jget_config("cifar-cnn"))
    tm = get_model(get_config("cifar-cnn"))
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = cnn_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    data = SyntheticImages(num_train=400, num_test=10)
    x, y = data.train_set()
    loader = FederatedLoader({"images": x, "labels": y},
                             iid_partition(y, C, 0), B, T, 0)
    return jm, tm, jp, tp, loader


def _diff(jtree, ttree):
    t = cnn_params_to_numpy(ttree)
    d = [np.abs(np.asarray(jtree[k][kk]) - t[k][kk]).ravel()
         for k in t for kk in t[k]]
    w = [np.abs(np.asarray(jtree[k][kk])).ravel() for k in t for kk in t[k]]
    return np.concatenate(d), np.concatenate(w)


def _opts(name):
    if name == "sgd":
        return jopt.sgd(1e-2), topt.sgd(1e-2)
    return jopt.adam(LR), topt.adam(LR)


@pytest.mark.parametrize("policy", ["sustainable", "wait_all"])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("rnd", [0, 1])
def test_parallel_round_matches_reference(cnn, policy, opt, rnd):
    jm, tm, jp, tp, loader = cnn
    b = loader.round_batch(rnd)
    jo, to = _opts(opt)
    wj, mj = jcore.parallel_round(
        lambda p, x, k: jm.loss_fn(p, x), jo,
        jcore.FedConfig(num_clients=C, local_steps=T, policy=policy), jp,
        {k: jnp.asarray(v) for k, v in b.items()}, jnp.asarray(P),
        jnp.asarray(E), jnp.int32(rnd), jax.random.PRNGKey(rnd))
    wt, mt = tcore.parallel_round(
        lambda p, x, k: tm.loss_fn(p, x), to,
        tcore.FedConfig(num_clients=C, local_steps=T, policy=policy), tp,
        {k: torch.tensor(v) for k, v in b.items()}, torch.tensor(P),
        torch.tensor(E), rnd, prng.PRNGKey(rnd))
    assert float(mt["participants"]) == float(mj["participants"])
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-4, atol=1e-6)
    d, w = _diff(wj, wt)
    if policy == "wait_all" and rnd == 1:          # the no-op round
        assert float(mt["participants"]) == 0 and d.max() == 0.0
        return
    if opt == "sgd":
        assert (d <= 1e-6 + 1e-5 * w).all(), d.max()
    else:
        mask = np.asarray(jcore.participation_mask(policy, 0, jnp.int32(rnd),
                                                   jnp.asarray(E)))
        assert d.max() <= adam_bound([mask], policy), d.max()
        assert np.quantile(d / (1 + w), BULK_Q) <= BULK_TOL


@pytest.mark.parametrize("policy", ["sustainable", "wait_all"])
def test_run_rounds_matches_reference_over_rounds(cnn, policy):
    """Five Adam rounds through both drivers: the same masks and
    participants every round, the same first-round loss, and params within
    the summed Adam bound at the end; and each of the port's rounds against
    the reference's round from the port's params before it (loss, the
    bulk and every element as in one round)."""
    jm, tm, jp, tp, loader = cnn
    R = 5
    jloss = lambda p, x, k: jm.loss_fn(p, x)
    jfed = jcore.FedConfig(num_clients=C, local_steps=T, policy=policy)
    jbatch = lambda r: {k: jnp.asarray(v)
                        for k, v in loader.round_batch(r).items()}
    wj, hj = jcore.run_rounds(jloss, jopt.adam(LR), jfed, jp, jbatch,
                              jnp.asarray(P), jnp.asarray(E), R,
                              jax.random.PRNGKey(0))
    tloss = lambda p, x, k: tm.loss_fn(p, x)
    tfed = tcore.FedConfig(num_clients=C, local_steps=T, policy=policy)
    inputs = []

    def round_fn(w, *args):
        inputs.append(w)
        return tcore.parallel_round(tloss, topt.adam(LR), tfed, w, *args)

    wt, ht = tcore.run_rounds(
        tloss, topt.adam(LR), tfed, tp,
        lambda r: {k: torch.tensor(v) for k, v in loader.round_batch(r).items()},
        torch.tensor(P), torch.tensor(E), R, prng.PRNGKey(0),
        round_fn=round_fn)
    assert [h["participants"] for h in ht] == [h["participants"] for h in hj]
    np.testing.assert_allclose(ht[0]["loss"], hj[0]["loss"], rtol=1e-4)
    masks = [np.asarray(jcore.participation_mask(policy, 0, jnp.int32(r),
                                                 jnp.asarray(E)))
             for r in range(R)]
    d, _ = _diff(wj, wt)
    assert d.max() <= adam_bound(masks, policy), d.max()

    outputs = inputs[1:] + [wt]
    for r in range(R):
        start = jax.tree.map(jnp.asarray, cnn_params_to_numpy(inputs[r]))
        wr, mr = jcore.parallel_round(
            jloss, jopt.adam(LR), jfed, start, jbatch(r), jnp.asarray(P),
            jnp.asarray(E), jnp.int32(r),
            jax.random.fold_in(jax.random.PRNGKey(0), r))
        assert float(mr["participants"]) == ht[r]["participants"]
        np.testing.assert_allclose(ht[r]["loss"], float(mr["loss"]),
                                   rtol=1e-4, atol=1e-6)
        d, w = _diff(wr, outputs[r])
        assert d.max() <= adam_bound([masks[r]], policy), (r, d.max())
        assert np.quantile(d / (1 + w), BULK_Q) <= BULK_TOL, r


@pytest.mark.parametrize("policy", ["sustainable", "wait_all"])
def test_replay_round_equals_parallel_round(cnn, policy):
    """``replay_round`` without routes is ``parallel_round`` bit for bit;
    replaying its own decisions, in float32 and in float64, an SGD round
    stays within the SGD tolerance of itself."""
    _, tm, _, tp, loader = cnn
    b = {k: torch.tensor(v) for k, v in loader.round_batch(0).items()}
    cfg = tcore.FedConfig(num_clients=C, local_steps=T, policy=policy)
    args = (cfg, tp, b, torch.tensor(P), torch.tensor(E), 0)
    for opt in (topt.adam(LR), topt.sgd(1e-2)):
        want, mw = tcore.parallel_round(lambda p, x, k: tm.loss_fn(p, x),
                                        opt, *args, prng.PRNGKey(0))
        got, mg, seen = tcore.replay_round(cnn_module.loss_and_decisions,
                                           opt, *args)
        assert len(seen) == T and seen[0][0].shape[:2] == (C, B)
        for k in want:
            for kk in want[k]:
                assert torch.equal(got[k][kk], want[k][kk])
        assert all(torch.equal(mg[k], mw[k]) for k in mw)
    for dtype in (None, torch.float64):
        again, _, _ = tcore.replay_round(cnn_module.loss_and_decisions,
                                         opt, *args, routes=seen,
                                         dtype=dtype)
        for k in want:
            for kk in want[k]:
                d = (again[k][kk].double() - want[k][kk].double()).abs()
                assert bool((d <= 1e-6 + 1e-5 * want[k][kk].abs()).all())
    with pytest.raises(ValueError, match="micro_batches"):
        tcore.replay_round(cnn_module.loss_and_decisions, opt,
                           tcore.FedConfig(num_clients=C, local_steps=T,
                                           micro_batches=2), *args[1:])


def test_aggregate_matches_reference():
    r = np.random.default_rng(3)
    w = {"a": r.standard_normal((6, 5)).astype(np.float32),
         "b": r.standard_normal(7).astype(np.float32)}
    ws = {k: r.standard_normal((C,) + v.shape).astype(np.float32)
          for k, v in w.items()}
    mask = np.array([1, 0, 1, 1], np.float32)
    for server_lr in (1.0, 0.5):
        want = jcore.aggregate(
            {k: jnp.asarray(v) for k, v in w.items()},
            {k: jnp.asarray(v) for k, v in ws.items()}, jnp.asarray(mask),
            jnp.asarray(P), jnp.asarray(E, jnp.float32), server_lr)
        got = tcore.aggregate(
            {k: torch.tensor(v) for k, v in w.items()},
            {k: torch.tensor(v) for k, v in ws.items()}, torch.tensor(mask),
            torch.tensor(P), torch.tensor(E), server_lr)
        for k in w:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=2e-5, atol=2e-5)
    fed = tcore.fedavg_aggregate({k: torch.tensor(v) for k, v in w.items()},
                                 {k: torch.tensor(v) for k, v in ws.items()},
                                 torch.tensor(mask), torch.tensor(P))
    jfed = jcore.fedavg_aggregate({k: jnp.asarray(v) for k, v in w.items()},
                                  {k: jnp.asarray(v) for k, v in ws.items()},
                                  jnp.asarray(mask), jnp.asarray(P))
    for k in w:
        np.testing.assert_allclose(fed[k].numpy(), np.asarray(jfed[k]),
                                   rtol=2e-5, atol=2e-5)


# --------------------------------------------------------- engine properties
def _quad_loss(p, batch, rng):
    x, y = batch
    return 0.5 * torch.mean((x @ p["w"] + p["b"] - y) ** 2)


def _jquad_loss(p, batch, rng):
    x, y = batch
    return 0.5 * jnp.mean((x @ p["w"] + p["b"] - y) ** 2)


def _quad_setup(C=6, T=3, B=4, d=3, seed=0):
    r = np.random.default_rng(seed)
    xs = r.standard_normal((C, T, B, d)).astype(np.float32)
    ys = r.standard_normal((C, T, B)).astype(np.float32)
    E = np.asarray(([1, 2, 3] * C)[:C], np.int32)
    return xs, ys, np.full(C, 1.0 / C, np.float32), E


@pytest.mark.parametrize("name", ["sgd", "sgd_momentum", "adam"])
def test_parallel_round_matches_reference_on_tuple_batches(name):
    """The quadratic model of the reference's ``test_round.py`` (a tuple
    batch, a scalar leaf), all three optimizers: float32 to 1e-5."""
    xs, ys, p, E = _quad_setup()
    mk = {"sgd": lambda m: m.sgd(0.1),
          "sgd_momentum": lambda m: m.sgd(0.05, momentum=0.9),
          "adam": lambda m: m.adam(1e-2)}[name]
    wj, mj = jcore.parallel_round(
        _jquad_loss, mk(jopt), jcore.FedConfig(num_clients=6, local_steps=3,
                                               seed=3),
        {"w": jnp.zeros(3), "b": jnp.zeros(())},
        (jnp.asarray(xs), jnp.asarray(ys)), jnp.asarray(p), jnp.asarray(E),
        jnp.int32(0), jax.random.PRNGKey(0))
    wt, mt = tcore.parallel_round(
        _quad_loss, mk(topt), tcore.FedConfig(num_clients=6, local_steps=3,
                                              seed=3),
        {"w": torch.zeros(3), "b": torch.zeros(())},
        (torch.tensor(xs), torch.tensor(ys)), torch.tensor(p),
        torch.tensor(E), 0, prng.PRNGKey(0))
    for k in ("w", "b"):
        assert wt[k].shape == tuple(wj[k].shape)
        np.testing.assert_allclose(wt[k].numpy(), np.asarray(wj[k]),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-5)


def test_sequential_equals_parallel():
    """Linearity of eq. 13: one-at-a-time accumulation == stacked round."""
    xs, ys, p, E = _quad_setup(C=4, T=2)
    cfg = tcore.FedConfig(num_clients=4, local_steps=2, seed=1)
    w0 = {"w": torch.zeros(3), "b": torch.zeros(())}
    E_t = torch.tensor(E)
    mask = tcore.participation_mask(cfg.policy, cfg.seed, 0, E_t)
    acc = tcore.zeros_like_fp32(w0)
    opt = topt.sgd(0.1)
    key = prng.PRNGKey(0)
    for i in range(4):
        acc, _ = tcore.sequential_client_step(
            _quad_loss, opt, cfg, w0, acc,
            (torch.tensor(xs[i]), torch.tensor(ys[i])), p[i], E[i], mask[i],
            prng.fold_in(key, i))
    w_seq = tcore.finish_sequential_round(cfg, w0, acc)
    w_par, _ = tcore.parallel_round(_quad_loss, opt, cfg, w0,
                                    (torch.tensor(xs), torch.tensor(ys)),
                                    torch.tensor(p), E_t, 0, key)
    for k in w0:
        np.testing.assert_allclose(w_par[k].numpy(), w_seq[k].numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_wait_all_noop_round_keeps_model():
    xs, ys, p, _ = _quad_setup(C=4, T=2)
    E = torch.tensor([2, 2, 4, 4], dtype=torch.int32)
    cfg = tcore.FedConfig(num_clients=4, local_steps=2, policy="wait_all")
    w0 = {"w": torch.randn(3, generator=torch.Generator().manual_seed(0)),
          "b": torch.ones(())}
    w1, m = tcore.parallel_round(_quad_loss, topt.sgd(0.1), cfg, w0,
                                 (torch.tensor(xs), torch.tensor(ys)),
                                 torch.tensor(p), E, 1, prng.PRNGKey(0))
    assert float(m["participants"]) == 0 and float(m["loss"]) == 0
    for k in w0:
        assert torch.equal(w1[k], w0[k])


def test_adam_state_resets_each_round():
    """Same inputs, different round index, constant lr: identical result
    (the local optimizer state is fresh every round)."""
    xs, ys, p, E = _quad_setup(C=2, T=2)
    cfg = tcore.FedConfig(num_clients=2, local_steps=2, policy="always")
    w0 = {"w": torch.zeros(3), "b": torch.zeros(())}
    args = ((torch.tensor(xs), torch.tensor(ys)), torch.tensor(p * 3),
            torch.tensor(E))
    a, _ = tcore.parallel_round(_quad_loss, topt.adam(1e-2), cfg, w0, *args,
                                0, prng.PRNGKey(0))
    b, _ = tcore.parallel_round(_quad_loss, topt.adam(1e-2), cfg, w0, *args,
                                5, prng.PRNGKey(0))
    for k in a:
        assert torch.equal(a[k], b[k])


def test_micro_batches():
    """Gradient accumulation equals the whole batch; an indivisible split
    raises the reference's ValueError."""
    xs, ys, p, E = _quad_setup(C=2, T=2, B=4)
    batches = (torch.tensor(xs), torch.tensor(ys))
    w0 = {"w": torch.zeros(3), "b": torch.zeros(())}
    outs = []
    for micro in (1, 2):
        cfg = tcore.FedConfig(num_clients=2, local_steps=2, policy="always",
                              micro_batches=micro)
        outs.append(tcore.parallel_round(_quad_loss, topt.sgd(0.1), cfg, w0,
                                         batches, torch.tensor(p),
                                         torch.tensor(E), 0,
                                         prng.PRNGKey(0))[0])
    for k in w0:
        np.testing.assert_allclose(outs[0][k].numpy(), outs[1][k].numpy(),
                                   rtol=1e-5, atol=1e-6)
    cfg = tcore.FedConfig(num_clients=2, local_steps=2, micro_batches=3)
    with pytest.raises(ValueError, match="not divisible by micro_batches=3"):
        tcore.parallel_round(_quad_loss, topt.sgd(0.1), cfg, w0, batches,
                             torch.tensor(p), torch.tensor(E), 0,
                             prng.PRNGKey(0))


def test_simulate_matches_reference(cnn):
    """Three rounds of the faithful participants-only driver, Adam, with
    the reference's local keys and step offsets."""
    jm, tm, jp, tp, loader = cnn
    R = 3

    def jbatch(r, i):
        return {k: jnp.asarray(v[i]) for k, v in loader.round_batch(r).items()}

    def tbatch(r, i, num_steps):      # the variable-T contract
        assert num_steps == T
        return {k: torch.tensor(v[i]) for k, v in loader.round_batch(r).items()}

    evals = []
    res_j = jcore.simulate(lambda p, x, k: jm.loss_fn(p, x), jopt.adam(LR),
                           jcore.FedConfig(num_clients=C, local_steps=T), jp,
                           jbatch, P, E, R, jax.random.PRNGKey(0))
    res_t = tcore.simulate(lambda p, x, k: tm.loss_fn(p, x), topt.adam(LR),
                           tcore.FedConfig(num_clients=C, local_steps=T), tp,
                           tbatch, P, E, R, prng.PRNGKey(0),
                           eval_fn=lambda w: evals.append(1) or {"x": 1.0},
                           eval_every=2)
    assert len(evals) == 2                      # rounds 1 and 2 (the last)
    assert ([h["participants"] for h in res_t.history]
            == [h["participants"] for h in res_j.history])
    first = next(h for h in res_j.history if "loss" in h)
    got = next(h for h in res_t.history if "loss" in h)
    np.testing.assert_allclose(got["loss"], first["loss"], rtol=1e-4)
    masks = [np.asarray(jcore.participation_mask("sustainable", 0,
                                                 jnp.int32(r),
                                                 jnp.asarray(E)))
             for r in range(R)]
    d, _ = _diff(res_j.params, res_t.params)
    assert d.max() <= adam_bound(masks, "sustainable"), d.max()

    # the controlled closed loop: masks from a lean Bernoulli harvest, the
    # server's budget rule re-planning the cycles E each round; the same
    # participants, cycles and losses as the reference's
    from repro.energy import arrivals as ja
    from repro.energy import battery as jb
    from repro.energy import control as jctl
    from repro.energy import fleet as jf
    from repro_torch.energy import BatteryConfig, Bernoulli, EnergyLoop
    from repro_torch.energy import control as tctl

    def ctrl(m):
        return m.ServerController(T0=T, E0=E, rules=(
            m.BudgetRule(depleted_high=0.2, slip=0.9),))

    Rc = 3
    loop = EnergyLoop(Bernoulli.create(C, prob=0.3, amount=0.6),
                      BatteryConfig(capacity=2.0), 0.5, controller=ctrl(tctl),
                      device="cpu")
    res_t = tcore.simulate(lambda p, x, k: tm.loss_fn(p, x), topt.adam(LR),
                           tcore.FedConfig(num_clients=C, local_steps=T), tp,
                           tbatch, P, E, Rc, prng.PRNGKey(0), energy=loop)
    jloop = jf.EnergyLoop(ja.Bernoulli.create(C, prob=0.3, amount=0.6),
                          jb.BatteryConfig(capacity=2.0), 0.5,
                          controller=ctrl(jctl))
    res_j = jcore.simulate(lambda p, x, k: jm.loss_fn(p, x), jopt.adam(LR),
                           jcore.FedConfig(num_clients=C, local_steps=T), jp,
                           jbatch, P, E, Rc, jax.random.PRNGKey(0),
                           energy=jloop)
    for h, g in zip(res_t.history, res_j.history):
        for k in ("participants", "ctrl_T", "ctrl_E_mean"):
            assert h[k] == g[k], k
        if "loss" in g:
            np.testing.assert_allclose(h["loss"], g["loss"], rtol=1e-4)
    assert len({h["ctrl_E_mean"] for h in res_t.history}) > 1
    assert any("loss" in h for h in res_t.history)


def test_theorem1_constants_match():
    from repro.core.convergence import Theorem1Constants as J
    kw = dict(mu=0.5, L=4.0, T=5, G2=2.0, sigma2=0.1, gamma_het=0.3,
              E_max=20, w0_dist2=1.5)
    j, t = J(**kw), tcore.Theorem1Constants(**kw)
    for K in (1, 10, 1000):
        assert t.bound(K) == j.bound(K)
    assert t.eta(7) == j.eta(7) and t.C(3) == j.C(3)
