"""``repro_torch.serve.fleet_serve`` against the JAX package's jitted
``simulate_serve``.

* A Constant-traffic, Bernoulli-harvest fleet (the example's battery,
  request cost and QoS budgets), padded, for every admission rule and
  training gate, with and without histograms: modes, charge, streak, every
  ledger count (offered, served, shed, missed, tokens, participants) and
  histogram count bitwise; the energy stats (float32 sums in another
  order) to 1e-5 relative.
* The example's scenario (diurnal Poisson traffic and Markov solar
  harvest, whose ``sin``, ``exp`` and ``log1p`` are ulp-close, not
  bitwise): modes may differ on at most 1e-3 of the client-epochs, ledger
  counts within 2e-3 relative, energy stats to 1e-3 relative.
* Padding, ``pad_to``, chunking through ``state=`` / ``epoch_offset=``,
  histogram counts, request conservation and energy conservation.
"""
import numpy as np
import pytest
import torch

from repro.core.scheduling import Policy as JPolicy
from repro.energy import arrivals as ja
from repro.energy import battery as jb
from repro.energy import costs as jc
from repro.serve import admission as jad
from repro.serve import fleet_serve as jfs
from repro.serve import traffic as jtr
from repro.serve.qos import QoSSpec as JQoS
from repro_torch.core.scheduling import Policy
from repro_torch.energy import arrivals as ta
from repro_torch.energy import battery as tb
from repro_torch.energy import costs as tc
from repro_torch.launch import serve_fleet as launch
from repro_torch.serve import admission as tad
from repro_torch.serve import fleet_serve as tfs
from repro_torch.serve import traffic as ttr
from repro_torch.serve.qos import QoSSpec as TQoS

J = dict(fs=jfs, tr=jtr, ad=jad, Q=JQoS, a=ja, b=jb, c=jc, P=JPolicy)
T = dict(fs=tfs, tr=ttr, ad=tad, Q=TQoS, a=ta, b=tb, c=tc, P=Policy)
KINDS = ["agnostic", "gated", "charge"]
TRAINS = [None, "sustainable", "threshold", "greedy", "always"]
LEDGER = ("offered", "served_full", "served_short", "shed",
          "deadline_missed", "tokens_decoded", "participants")
ENERGY = ("harvested", "consumed", "leaked", "overflowed", "mean_charge",
          "consumed_serve", "consumed_train")


def _policy(m, kind, n):
    return {"agnostic": lambda: m["ad"].EnergyAgnostic(),
            "gated": lambda: m["ad"].BatteryGated.create(n, hi=2.0, lo=1.5),
            "charge": lambda: m["ad"].ChargeGated.create(n, hi=3.0,
                                                        lo=1.0)}[kind]()


def _run(m, kind, train, n, E, *, traffic, harvest, hist=False, seed=3,
         **kw):
    fs = m["fs"]
    tl = None if train is None else fs.TrainLoad.create(
        np.full(n, 4), 0.2, policy=m["P"](train), threshold=1.3)
    extra = {"device": "cpu"} if fs is tfs else {}
    return fs.simulate_serve(
        traffic(m, n), harvest(m, n),
        m["b"].BatteryConfig(capacity=8.0, leak=0.01, init_charge=2.0),
        m["c"].DecodeCostModel.from_params(1e8), m["Q"](128.0, 256.0, 32.0),
        _policy(m, kind, n), fs.ServeConfig(n, seed=seed), E, train=tl,
        hist=hist, record_modes=True, **kw, **extra)


RATE = np.random.default_rng(0).integers(0, 7, 64).astype(np.float32)
const = lambda m, n: m["tr"].Constant.create(n, RATE[:n])
bern = lambda m, n: m["a"].Bernoulli.create(n, prob=0.5, amount=1.7)
diurnal = lambda m, n: m["tr"].DiurnalPoisson.create(
    n, base=1.0, swing=0.9, phase=np.arange(n) % 24)
solar = lambda m, n: m["a"].MarkovSolar.create(n, p_stay_day=0.9,
                                               p_stay_night=0.9, day_mean=3.0)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(got, want, label):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and np.array_equal(got, want), label


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("train", TRAINS)
@pytest.mark.parametrize("hist", [False, True])
def test_constant_bernoulli_fleet_bitwise(kind, train, hist):
    n, E = 45, 24
    kw = dict(traffic=const, harvest=bern, hist=hist, pad_to=64)
    j = _run(J, kind, train, n, E, **kw)
    t = _run(T, kind, train, n, E, **kw)
    _eq(t.modes, j.modes, "modes")
    _eq(t.final_charge, j.final_charge, "charge")
    if hist:
        _eq(t.final_streak, j.final_streak, "streak")
    assert set(t.stats) == set(j.stats)
    for k in j.stats:
        assert t.stats[k].shape == j.stats[k].shape, k
        if k in LEDGER or k.startswith("hist_") or k == "frac_depleted":
            _eq(t.stats[k], j.stats[k], k)
        else:
            np.testing.assert_allclose(t.stats[k], j.stats[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    assert (np.asarray(j.modes) == 0).any() == (kind != "agnostic")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("train", [None, "sustainable"])
def test_the_example_scenario_within_tolerance(kind, train):
    n, E = 400, 30
    kw = dict(traffic=diurnal, harvest=solar, hist=True)
    j = _run(J, kind, train, n, E, **kw)
    t = _run(T, kind, train, n, E, **kw)
    flips = (_np(t.modes) != _np(j.modes)).mean()
    assert flips <= 1e-3, flips
    for k in LEDGER:
        np.testing.assert_allclose(t.stats[k], j.stats[k], rtol=2e-3,
                                   atol=2, err_msg=k)
    for k in ENERGY:
        np.testing.assert_allclose(t.stats[k], j.stats[k], rtol=1e-3,
                                   atol=1e-3, err_msg=k)
    for k in ("hist_soc", "hist_spend", "hist_streak"):
        assert np.abs(t.stats[k] - j.stats[k]).sum(axis=1).max() <= 4, k


def test_result_properties_match_reference():
    n, E = 30, 12
    kw = dict(traffic=const, harvest=bern)
    j = _run(J, "gated", "greedy", n, E, **kw)
    t = _run(T, "gated", "greedy", n, E, **kw)
    for p in ("shed_rate", "deadline_miss_rate", "served_rate"):
        np.testing.assert_array_equal(getattr(t, p), getattr(j, p), p)
    assert t.joules_per_token == pytest.approx(j.joules_per_token, rel=1e-6)
    assert len(t.final_state) == 3
    tt = _run(T, "gated", "greedy", n, E, hist=True, **kw)
    assert len(tt.final_state) == 4


@pytest.mark.parametrize("hist", [False, True])
def test_padding_is_invisible(hist):
    """A fleet padded to 64 clients (copies of the last client, excluded
    from the stats) gives the unpadded fleet's results bitwise."""
    n, E = 37, 16
    kw = dict(traffic=diurnal, harvest=solar, hist=hist)
    a = _run(T, "gated", "sustainable", n, E, **kw)
    b = _run(T, "gated", "sustainable", n, E, pad_to=64, **kw)
    _eq(b.modes, a.modes, "modes")
    _eq(b.final_charge, a.final_charge, "charge")
    for k in a.stats:
        if k in LEDGER or k.startswith("hist_"):
            _eq(b.stats[k], a.stats[k], k)
        else:
            np.testing.assert_allclose(b.stats[k], a.stats[k], rtol=1e-6,
                                       err_msg=k)
    with pytest.raises(ValueError, match="below the fleet width"):
        _run(T, "gated", None, n, 1, pad_to=n - 1, **kw)


@pytest.mark.parametrize("hist", [False, True])
def test_chunked_run_equals_unchunked(hist):
    n, E = 50, 20
    kw = dict(traffic=lambda m, k: m["tr"].MMPP.create(k, calm_rate=1.0),
              harvest=solar, hist=hist)
    whole = _run(T, "charge", "threshold", n, E, **kw)
    first = _run(T, "charge", "threshold", n, 7, **kw)
    rest = _run(T, "charge", "threshold", n, E - 7, state=first.final_state,
                epoch_offset=7, **kw)
    _eq(torch.cat([first.modes, rest.modes]), whole.modes, "modes")
    _eq(rest.final_charge, whole.final_charge, "charge")
    for k in whole.stats:
        _eq(np.concatenate([first.stats[k], rest.stats[k]]), whole.stats[k],
            k)
    if hist:
        _eq(rest.final_streak, whole.final_streak, "streak")
        with pytest.raises(ValueError, match="4-tuple"):
            _run(T, "charge", None, n, 1, state=first.final_state[:3], **kw)


def test_histograms_count_every_client_and_ledger_conserves():
    n, E = 300, 48
    res = _run(T, "gated", "greedy", n, E, traffic=diurnal, harvest=solar,
               hist=True)
    s = res.stats
    for k in ("hist_soc", "hist_spend", "hist_streak"):
        assert s[k].shape == (E, 32 if k != "hist_streak" else 64)
        assert np.array_equal(s[k].sum(axis=1), np.full(E, n)), k
    np.testing.assert_array_equal(
        s["offered"], s["served_full"] + s["served_short"] + s["shed"]
        + s["deadline_missed"])
    charge = np.concatenate([[2.0 * n], s["mean_charge"] * n])
    lhs = s["harvested"] - s["consumed"] - s["leaked"] - s["overflowed"]
    np.testing.assert_allclose(lhs, np.diff(charge), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(s["consumed"],
                               s["consumed_serve"] + s["consumed_train"],
                               rtol=1e-5)
    assert float(res.final_charge.min()) >= 0.0
    assert (s["participants"] > 0).all()


def test_train_load_create_and_unported_options(tmp_path):
    """`TrainLoad.create` equals the reference's; a wrong mesh or fleet
    size raises; ``obs=`` (observability, once unported) writes a manifest
    and a round event an epoch."""
    from repro_torch.obs import Obs, load_events
    E = np.full(6, 3)
    load = tfs.TrainLoad.create(E, tc.DeviceCostModel(0.1, 0.2, 0.05),
                                local_steps=4, policy="greedy")
    jload = jfs.TrainLoad.create(E, jc.DeviceCostModel(0.1, 0.2, 0.05),
                                 local_steps=4, policy="greedy")
    _eq(load.round_cost, jload.round_cost, "round cost")
    _eq(load.E, jload.E, "E")
    assert load.round_cost.stride() == (0,)
    assert load.policy == Policy.GREEDY
    kw = dict(traffic=const, harvest=bern)
    with pytest.raises(ValueError, match="DeviceMesh"):
        _run(T, "gated", None, 8, 1, mesh=object(), **kw)
    with Obs(tmp_path) as obs:
        _run(T, "gated", None, 8, 3, obs=obs, **kw)
    ev = load_events(tmp_path / "events.jsonl")
    assert [e["kind"] for e in ev][:4] == ["manifest"] + ["round"] * 3
    assert ev[0]["run_kind"] == "serve" and ev[0]["horizon"] == 3
    assert all(e["scan"] == "serve" and "offered" in e for e in ev[1:4])
    with pytest.raises(ValueError, match="sized for"):
        tfs.simulate_serve(ttr.Constant.create(4), ta.Bernoulli.create(5),
                           tb.BatteryConfig(), tc.DecodeCostModel(1.0, 1.0),
                           TQoS(), tad.EnergyAgnostic(), tfs.ServeConfig(4),
                           1, device="cpu")


def test_launcher_scenario_matches_the_example():
    """The twin's fleet is the example's: the same traffic, harvest,
    battery, prices and training load give the reference's first epochs."""
    n, E = 200, 6
    traffic, harvest, cost, train = launch.scenario(n, "cpu")
    t = tfs.simulate_serve(traffic, harvest, launch.BATTERY, cost,
                           launch.QOS, tad.BatteryGated.create(n, 2.0, 1.5),
                           tfs.ServeConfig(n), E, train=train, device="cpu",
                           record_modes=True)
    j = jfs.simulate_serve(
        jtr.DiurnalPoisson.create(n, base=1.0, swing=0.9,
                                  phase=np.arange(n) % 24),
        ja.MarkovSolar.create(n, p_stay_day=0.9, p_stay_night=0.9,
                              day_mean=3.0),
        jb.BatteryConfig(capacity=8.0, leak=0.01, init_charge=2.0),
        jc.DecodeCostModel.from_params(1e8), JQoS(128.0, 256.0, 32.0),
        jad.BatteryGated.create(n, 2.0, 1.5), jfs.ServeConfig(n), E,
        train=jfs.TrainLoad.create(np.full(n, 4), 0.2), record_modes=True)
    assert (_np(t.modes) != _np(j.modes)).mean() <= 1e-2
    np.testing.assert_allclose(t.stats["offered"], j.stats["offered"],
                               rtol=1e-2)
    np.testing.assert_allclose(t.stats["mean_charge"], j.stats["mean_charge"],
                               rtol=1e-3)
