"""``repro_torch.energy.fleet`` against the JAX package's ``energy/fleet.py``
(its jitted scan): ``simulate_fleet`` over 12 rounds for the four
policies, with and without groups and histograms, padded: masks, charge,
streak and every stat bitwise on the reference's dyadic Bernoulli
configuration; masks, charge and counts bitwise on a non-dyadic Bernoulli
battery, its energy stats to 1e-5 relative; on the example's solar + RF
scenario (ulp-close harvests) stats to 1e-5 relative and counts to a few
clients.  Chunked runs equal unchunked ones; the closed loop through
``core.simulate`` equals the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EnergyProfile as JProfile
from repro.core import FedConfig as JFed
from repro.core import simulate as jsimulate
from repro.energy import arrivals as ja
from repro.energy import battery as jb
from repro.energy import costs as jcosts
from repro.energy import fleet as jf
from repro.optim import sgd as jsgd
from repro_torch import prng
from repro_torch.core import FedConfig, simulate
from repro_torch.energy import arrivals as ta
from repro_torch.energy import battery as tb
from repro_torch.energy import costs as tcosts
from repro_torch.energy import fleet as tf
from repro_torch.launch import fleet as launch
from repro_torch.optim import sgd

POLICIES = ["sustainable", "greedy", "threshold", "always"]
COST = 0.75


def _run(mod_a, mod_b, mod_f, policy, n, R, bat, proc, **kw):
    cfg = mod_f.FleetConfig(num_clients=n, policy=policy, seed=3,
                            threshold=1.5)
    extra = {"device": "cpu"} if mod_f is tf else {}
    return mod_f.simulate_fleet(proc(mod_a), mod_b.BatteryConfig(**bat),
                                COST, cfg, R, **kw, **extra)


def _pair(policy, n, R, bat, proc, **kw):
    return (_run(ja, jb, jf, policy, n, R, bat, proc, **kw),
            _run(ta, tb, tf, policy, n, R, bat, proc, **kw))


def _eq(a, b, label):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_array_equal(a, np.asarray(b), err_msg=label)


DYADIC = dict(capacity=2.5, leak=0.0, init_charge=0.5)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("groups", [False, True])
@pytest.mark.parametrize("hist", [False, True])
def test_simulate_fleet_bitwise_on_dyadic_config(policy, groups, hist):
    """The reference's exact-arithmetic configuration (Bernoulli 0.375 of
    1.25 J, capacity 2.5, no leak, cost 0.75), N = 21 padded to 32."""
    n = 21
    E = np.asarray(JProfile(n).cycles())
    kw = dict(E=E, record_masks=True, hist=hist, pad_to=32)
    if groups:
        kw.update(groups=np.arange(n) % 3, num_groups=3)
    j, t = _pair(policy, n, 12, DYADIC,
                 lambda m: m.Bernoulli.create(n, prob=0.375, amount=1.25),
                 **kw)
    _eq(t.masks, j.masks, "masks")
    _eq(t.final_charge, j.final_charge, "charge")
    if hist:
        _eq(t.final_streak, j.final_streak, "streak")
    assert set(t.stats) == set(j.stats)
    for k in j.stats:
        _eq(t.stats[k], j.stats[k], k)
        assert t.stats[k].shape == j.stats[k].shape


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("per_client", [False, True])
def test_simulate_fleet_non_dyadic_battery(policy, per_client):
    """A leaking battery, one leak for the fleet or one per client (the
    reference's scan contracts the absorb either way): masks, charge and
    the counting stats bitwise; energy sums to 1e-5 relative."""
    n = 3000
    r = np.random.default_rng(0)
    bat = (dict(capacity=r.uniform(1.5, 3, n).astype(np.float32),
                leak=r.uniform(0, 0.1, n).astype(np.float32),
                init_charge=0.5) if per_client
           else dict(capacity=2.5, leak=0.02, init_charge=0.5))
    E = np.asarray(JProfile(n).cycles())
    j, t = _pair(policy, n, 12, bat,
                 lambda m: m.Bernoulli.create(n, prob=0.35, amount=1.2),
                 E=E, record_masks=True, hist=True)
    _eq(t.masks, j.masks, "masks")
    _eq(t.final_charge, j.final_charge, "charge")
    for k in ("participants", "consumed", "frac_depleted", "hist_soc",
              "hist_spend", "hist_streak"):
        _eq(t.stats[k], j.stats[k], k)
    for k in ("harvested", "leaked", "overflowed", "mean_charge"):
        np.testing.assert_allclose(t.stats[k], j.stats[k], rtol=1e-5,
                                   err_msg=k)


def _scenario(mod, n):
    rs = np.random.RandomState(0)
    return mod.Sum((
        mod.Scaled.create(mod.MarkovSolar.create(
            n, p_stay_day=0.92, p_stay_night=0.92, day_mean=0.9),
            gain=rs.uniform(0.5, 2.0, n).astype(np.float32)),
        mod.CompoundPoisson.create(n, rate=0.1, mean_amount=0.3)))


@pytest.mark.parametrize("policy,thr", [("sustainable", 1.0),
                                        ("greedy", 1.0), ("threshold", 1.5)])
def test_simulate_fleet_on_the_example_scenario(policy, thr):
    """examples/energy_fleet.py's scenario at N = 5000 for 10 rounds: the
    harvests are ulp-close, so a client within a few ulp of a threshold or
    bin edge may flip; at most 3 clients a round here."""
    n, R = 5000, 10
    E = np.asarray(JProfile(n).cycles())
    bat = dict(capacity=2.5, leak=0.02, init_charge=0.5)
    j = jf.simulate_fleet(_scenario(ja, n), jb.BatteryConfig(**bat), 1.0,
                          jf.FleetConfig(num_clients=n, policy=policy,
                                         threshold=thr), R, E=E, hist=True,
                          record_masks=True)
    proc, battery, tE = launch.scenario(n, 0, "cpu")
    t, _, launches = launch.run_policy(proc, tE, n, R, policy, thr, 0, True,
                                       "cpu", record_masks=True)
    assert launches == 0
    assert int((t.masks.numpy() != np.asarray(j.masks)).sum(axis=1).max()) \
        <= 3
    np.testing.assert_allclose(t.final_charge.numpy(),
                               np.asarray(j.final_charge), atol=1.1)
    for k in ("harvested", "leaked", "overflowed", "mean_charge"):
        np.testing.assert_allclose(t.stats[k], j.stats[k], rtol=1e-5,
                                   err_msg=k)
    for k in ("participants", "consumed"):
        np.testing.assert_allclose(t.stats[k], j.stats[k], atol=3, err_msg=k)
    for k in ("hist_soc", "hist_spend", "hist_streak"):
        assert np.abs(t.stats[k] - j.stats[k]).sum(axis=1).max() <= 6, k


@pytest.mark.parametrize("hist", [False, True])
def test_chunked_run_equals_unchunked(hist):
    n, R = 200, 12
    proc = ta.MarkovSolar.create(n, day_mean=0.8)
    bat = tb.BatteryConfig(capacity=2.0, leak=0.01)
    cfg = tf.FleetConfig(num_clients=n, policy="sustainable", seed=4)
    E = np.arange(n) % 5 + 1
    kw = dict(E=E, hist=hist, device="cpu", record_masks=True)
    whole = tf.simulate_fleet(proc, bat, 1.0, cfg, R, **kw)
    a = tf.simulate_fleet(proc, bat, 1.0, cfg, 5, **kw)
    b = tf.simulate_fleet(proc, bat, 1.0, cfg, R - 5, state=a.final_state,
                          round_offset=5, **kw)
    assert torch.equal(b.final_charge, whole.final_charge)
    assert torch.equal(torch.cat([a.masks, b.masks]), whole.masks)
    for k in whole.stats:
        _eq(np.concatenate([a.stats[k], b.stats[k]]), whole.stats[k], k)
    if hist:
        with pytest.raises(ValueError, match="3-tuple"):
            tf.simulate_fleet(proc, bat, 1.0, cfg, 1,
                              state=a.final_state[::2], **kw)


def test_final_state_and_result_match_reference():
    n = 64
    E = np.asarray(JProfile(n).cycles())
    j, t = _pair("threshold", n, 7, dict(capacity=2.5, leak=0.02),
                 lambda m: m.MarkovSolar.create(n, day_mean=0.9), E=E,
                 hist=True)
    _eq(t.final_pstate, j.final_pstate, "regime")
    _eq(t.final_streak, j.final_streak, "streak")
    np.testing.assert_array_equal(t.participation_rate,
                                  j.participation_rate)
    assert len(t.final_state) == 3


def test_deterministic_renewal_reproduces_sustainable_schedule():
    """Capacity = cost = unit, no leak, empty start: the battery never
    blocks, so the masks are Algorithm 1's stateless slot draw."""
    from repro_torch.core import sustainable_schedule
    n, R = 40, 20
    E = np.asarray(JProfile(n).cycles())
    proc = ta.DeterministicRenewal.create(E, unit=1.0)
    res = tf.simulate_fleet(proc, tb.BatteryConfig(capacity=1.0), 1.0,
                            tf.FleetConfig(num_clients=n, seed=7), R, E=E,
                            record_masks=True, device="cpu")
    want = torch.stack([sustainable_schedule(7, r, torch.tensor(E))
                        for r in range(R)])
    assert torch.equal(res.masks, want)


@pytest.mark.parametrize("policy", POLICIES)
def test_fleet_mask_matches_reference(policy):
    n = 500
    r = np.random.default_rng(1)
    avail = r.uniform(0, 3, n).astype(np.float32)
    E = np.asarray(JProfile(n).cycles())
    want = jf.fleet_mask(policy, 2, 5, E, jnp.asarray(avail), 1.0,
                         threshold=1.5)
    got = tf.fleet_mask(policy, 2, 5, torch.tensor(E), torch.tensor(avail),
                        1.0, threshold=1.5)
    _eq(got, want, policy)


def test_unported_options_raise_naming_the_roadmap_item(tmp_path):
    """A wrong mesh, fleet size or policy raises; ``obs=`` (observability,
    once unported) writes a manifest and a round event a round."""
    from repro_torch.obs import Obs, load_events
    proc = ta.Bernoulli.create(4)
    cfg = tf.FleetConfig(num_clients=4)
    with pytest.raises(ValueError, match="DeviceMesh"):
        tf.simulate_fleet(proc, tb.BatteryConfig(), 1.0, cfg, 1,
                          mesh=object(), device="cpu")
    with Obs(tmp_path) as obs:
        tf.simulate_fleet(proc, tb.BatteryConfig(), 1.0, cfg, 3, obs=obs,
                          device="cpu")
    ev = load_events(tmp_path / "events.jsonl")
    assert [e["kind"] for e in ev][:4] == ["manifest"] + ["round"] * 3
    assert ev[0]["run_kind"] == "fleet" and ev[0]["num_clients"] == 4
    assert [e["round"] for e in ev[1:4]] == [0, 1, 2]
    with pytest.raises(ValueError, match="sized for"):
        tf.simulate_fleet(ta.Bernoulli.create(5), tb.BatteryConfig(), 1.0,
                          cfg, 1, device="cpu")
    with pytest.raises(ValueError, match="no battery-gated"):
        tf.simulate_fleet(proc, tb.BatteryConfig(), 1.0,
                          tf.FleetConfig(num_clients=4, policy="wait_all"),
                          1, device="cpu")


def test_cost_models_match_reference():
    jm = jcosts.from_flops(3e9, 2e6, 1e6)
    tm = tcosts.from_flops(3e9, 2e6, 1e6)
    assert tm == tcosts.DeviceCostModel(jm.joules_per_step,
                                        jm.joules_per_upload,
                                        jm.joules_per_download)
    assert tm.round_cost(5) == jm.round_cost(5)
    n = 30
    cost = tcosts.DeviceCostModel(0.1, 0.2, 0.05)
    res = tf.simulate_fleet(ta.Bernoulli.create(n, 0.5, 1.0),
                            tb.BatteryConfig(capacity=2.0), cost,
                            tf.FleetConfig(num_clients=n, local_steps=3,
                                           policy="greedy"), 4, device="cpu")
    jres = jf.simulate_fleet(ja.Bernoulli.create(n, 0.5, 1.0),
                             jb.BatteryConfig(capacity=2.0),
                             jcosts.DeviceCostModel(0.1, 0.2, 0.05),
                             jf.FleetConfig(num_clients=n, local_steps=3,
                                            policy="greedy"), 4)
    np.testing.assert_allclose(res.stats["consumed"], jres.stats["consumed"],
                               rtol=1e-6)
    _eq(res.stats["participants"], jres.stats["participants"], "parts")


def test_closed_loop_matches_reference():
    """examples/energy_fleet.py's closed loop: 8 clients, threshold policy,
    masks from a Markov solar harvest; the port's history against the
    reference's (participants and energy telemetry equal, loss to 1e-5)."""
    C, R = 8, 20
    res = launch.closed_loop(0, "cpu", rounds=R)
    loop = jf.EnergyLoop(ja.MarkovSolar.create(C, day_mean=0.8),
                         jb.BatteryConfig(capacity=3.0, leak=0.01), 1.0)
    b = jnp.linspace(-1.0, 1.0, C)
    jres = jsimulate(
        lambda p, x, k: 0.5 * jnp.sum((p["w"] - b[x["client"]]) ** 2),
        jsgd(0.2), JFed(num_clients=C, local_steps=2, policy="threshold",
                        seed=0), {"w": jnp.zeros(())},
        lambda r, i: {"client": jnp.full((2,), i, jnp.int32)},
        np.ones(C) / C, np.ones(C, np.int32), R, jax.random.PRNGKey(0),
        energy=loop)
    assert len(res.history) == len(jres.history) == R
    for h, g in zip(res.history, jres.history):
        assert h["participants"] == g["participants"]
        assert set(h) == set(g)
        for k in g:
            if k.startswith("energy_") or k == "loss":
                np.testing.assert_allclose(h[k], g[k], rtol=1e-5, atol=1e-6,
                                           err_msg=k)


def test_energy_loop_with_a_controller_raises():
    """The closed loop with a server controller attached (cadence and
    budget rules): each round reads the controller's T and E and feeds the
    round's telemetry back.  The history (participants, ctrl_T,
    ctrl_E_mean, energy telemetry, loss) equals the reference's, and T and
    E move.  An EnergyLoop sized for another fleet still raises."""
    from repro.energy import control as jctl
    from repro_torch.energy import control as tctl

    C, R = 8, 24

    def ctrl(m):
        return m.ServerController(
            T0=4, E0=2, rules=(m.CadenceRule(depleted_high=0.25),
                               m.BudgetRule(depleted_high=0.25, slip=0.9)))

    b = np.linspace(-1.0, 1.0, C).astype(np.float32)
    loop = tf.EnergyLoop(ta.MarkovSolar.create(C, day_mean=0.6),
                         tb.BatteryConfig(capacity=3.0, leak=0.01), 1.0,
                         controller=ctrl(tctl), device="cpu")
    res = simulate(
        lambda p, x, k: 0.5 * torch.sum((p["w"] - torch.tensor(b)[
            x["client"]]) ** 2), sgd(0.2),
        FedConfig(num_clients=C, local_steps=4, policy="threshold", seed=0),
        {"w": torch.zeros(())},
        lambda r, i, steps: {"client": torch.full((steps,), i,
                                                  dtype=torch.long)},
        np.ones(C) / C, np.ones(C, np.int32), R, prng.PRNGKey(0),
        energy=loop)
    jloop = jf.EnergyLoop(ja.MarkovSolar.create(C, day_mean=0.6),
                          jb.BatteryConfig(capacity=3.0, leak=0.01), 1.0,
                          controller=ctrl(jctl))
    jb_ = jnp.asarray(b)
    jres = jsimulate(
        lambda p, x, k: 0.5 * jnp.sum((p["w"] - jb_[x["client"]]) ** 2),
        jsgd(0.2), JFed(num_clients=C, local_steps=4, policy="threshold",
                        seed=0), {"w": jnp.zeros(())},
        lambda r, i, steps: {"client": jnp.full((steps,), i, jnp.int32)},
        np.ones(C) / C, np.ones(C, np.int32), R, jax.random.PRNGKey(0),
        energy=jloop)
    assert len(res.history) == len(jres.history) == R
    for h, g in zip(res.history, jres.history):
        assert set(h) == set(g)
        for k in ("participants", "ctrl_T", "ctrl_E_mean"):
            assert h[k] == g[k], k
        for k in g:
            if k.startswith("energy_") or k == "loss":
                np.testing.assert_allclose(h[k], g[k], rtol=1e-5, atol=1e-6,
                                           err_msg=k)
    assert len({h["ctrl_T"] for h in res.history}) > 1
    assert len({h["ctrl_E_mean"] for h in res.history}) > 1
    with pytest.raises(ValueError, match="sized for"):
        tf.EnergyLoop(ta.Bernoulli.create(C), tb.BatteryConfig(), 1.0,
                      device="cpu").step("greedy", 0, 0, np.ones(5), 1)


def test_conservation_over_the_horizon():
    n, R = 1000, 30
    proc, bat, E = launch.scenario(n, 1, "cpu")
    res = tf.simulate_fleet(proc, bat, 1.0,
                            tf.FleetConfig(num_clients=n, policy="greedy"),
                            R, E=E, device="cpu")
    s = res.stats
    lhs = (s["harvested"].sum() - s["consumed"].sum() - s["leaked"].sum()
           - s["overflowed"].sum())
    delta = float(res.final_charge.double().sum()) - 0.5 * n
    assert abs(lhs - delta) <= 1e-4 * (s["harvested"].sum() + n)
