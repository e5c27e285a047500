"""``repro_torch.energy.control`` against the JAX package's: `Telemetry`
(fleet, grouped, histogram and serving-ledger signals), the three rules on
both depletion signals, the controller's trajectory, `run_controlled`
over the port's fleet and `run_serve_controlled` over the port's serving
fleet.  The control law is the same numpy on both sides, so every knob and
every telemetry field is equal; the fleets under control are the ones the
other parity tests hold bitwise (Bernoulli / Constant)."""
import dataclasses
import os

import numpy as np
import pytest

from repro.energy import arrivals as ja
from repro.energy import battery as jb
from repro.energy import control as jctl
from repro.energy import costs as jc
from repro.energy import fleet as jf
from repro.serve import admission as jad
from repro.serve import fleet_serve as jfs
from repro.serve import traffic as jtr
from repro.serve.qos import QoSSpec as JQoS
from repro_torch.energy import arrivals as ta
from repro_torch.energy import battery as tb
from repro_torch.energy import control as tctl
from repro_torch.energy import costs as tc
from repro_torch.energy import fleet as tf
from repro_torch.serve import admission as tad
from repro_torch.serve import fleet_serve as tfs
from repro_torch.serve import traffic as ttr
from repro_torch.serve.qos import QoSSpec as TQoS


def _stats(r, R, n, *, groups=0, hist=False, serve=False):
    s = {"participants": r.integers(0, n, R).astype(np.float32),
         "harvested": r.uniform(0, n, R).astype(np.float32),
         "overflowed": r.uniform(0, n / 4, R).astype(np.float32),
         "frac_depleted": r.uniform(0, 0.6, R).astype(np.float32),
         "mean_charge": r.uniform(0, 3, R).astype(np.float32),
         "consumed": r.uniform(0, n, R).astype(np.float32),
         "leaked": r.uniform(0, 1, R).astype(np.float32)}
    if groups:
        s["group_frac_depleted"] = r.uniform(0, .6, (R, groups)
                                             ).astype(np.float32)
        s["group_participants"] = r.integers(0, n // groups, (R, groups)
                                             ).astype(np.float32)
    if hist:
        for k, b in (("hist_soc", 32), ("hist_spend", 32),
                     ("hist_streak", 64)):
            s[k] = r.multinomial(n, np.ones(b) / b, R).astype(np.float32)
    if serve:
        s["offered"] = r.integers(n, 3 * n, R).astype(np.float32)
        s["shed"] = r.integers(0, n // 2, R).astype(np.float32)
        s["deadline_missed"] = r.integers(0, n // 8, R).astype(np.float32)
    return s


def _same_telemetry(a, b):
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, dict):
            assert x == y, f.name
        elif y is None:
            assert x is None, f.name
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f.name)


@pytest.mark.parametrize("groups,hist,serve", [
    (0, False, False), (4, False, False), (0, True, False), (0, False, True),
    (3, True, True)])
@pytest.mark.parametrize("R", [0, 1, 10])
def test_telemetry_matches_reference(groups, hist, serve, R):
    n = 120
    s = _stats(np.random.default_rng(R + groups), R, n, groups=groups,
               hist=hist, serve=serve)
    sizes = [40, 40, 40][:groups] if groups == 3 else None
    _same_telemetry(tctl.Telemetry.from_stats(s, n, sizes),
                    jctl.Telemetry.from_stats(s, n, sizes))


RULES = [("CadenceRule", {}), ("CadenceRule", {"signal": "p95"}),
         ("BudgetRule", {}), ("BudgetRule", {"signal": "p95"}),
         ("AdmissionRule", {}), ("AdmissionRule", {"signal": "p95"})]


@pytest.mark.parametrize("rule,kw", RULES)
@pytest.mark.parametrize("groups", [0, 4])
def test_rules_match_reference_over_a_trajectory(rule, kw, groups):
    """The same chain of 60 random telemetry reports folded by the port's
    and the reference's controller: the same knobs after every report."""
    r = np.random.default_rng(5)
    n = 80
    make = lambda m: m.ServerController(
        T0=5, E0=[4, 8, 2, 1][:groups] if groups else 3,
        rules=(getattr(m, rule)(**kw),), bounds=m.ControlBounds(),
        groups=np.arange(n) % groups if groups else None, admit0=1.0)
    t, j = make(tctl), make(jctl)
    for _ in range(60):
        s = _stats(r, 6, n, groups=groups, hist=True, serve=True)
        ts, js = t.update(s, n), j.update(s, n)
        assert ts.T == js.T and ts.admit == js.admit
        np.testing.assert_array_equal(ts.E, js.E)
    np.testing.assert_array_equal(t.client_E(n), j.client_E(n))
    assert len({tr["admit"] for tr in t.trace}) > 1 or rule != "AdmissionRule"
    for a, b in zip(t.trace, j.trace):
        assert (a["T"], a["E_mean"], a["admit"]) == (b["T"], b["E_mean"],
                                                     b["admit"])


def test_controller_errors_and_bounds_match_reference():
    for m in (tctl, jctl):
        c = m.ServerController(T0=50, E0=[0, 100], admit0=100.0)
        assert (c.T, c.E.tolist(), c.state.admit) == (20, [1, 64], 16.0)
        with pytest.raises(ValueError, match="covers 2 clients"):
            c.client_E(5)
        with pytest.raises(ValueError, match="unknown depletion signal"):
            m.Telemetry.from_stats(_stats(np.random.default_rng(0), 3, 10),
                                   10).depletion("p50")


def _fleet(m, n):
    return m.Bernoulli.create(n, prob=0.35, amount=1.25)


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("hist", [False, True])
def test_run_controlled_matches_reference(grouped, hist):
    """A Bernoulli fleet under cadence and budget control, 36 rounds in
    chunks of 6: masks, charge, every ledger stat, and the controller's
    knobs after each chunk equal the reference's."""
    n, R = 40, 36
    groups = np.arange(n) % 4 if grouped else None

    def go(mods, extra):
        a, b, f, ctl = mods
        ctrl = ctl.ServerController(
            T0=6, E0=[1, 5, 10, 20] if grouped else 2, groups=groups,
            rules=(ctl.CadenceRule(depleted_high=0.2),
                   ctl.BudgetRule(depleted_high=0.2, slip=0.9)))
        cfg = f.FleetConfig(num_clients=n, policy="sustainable", seed=2)
        return ctl.run_controlled(
            _fleet(a, n), b.BatteryConfig(capacity=2.5, init_charge=0.5),
            jc.DeviceCostModel(0.125, 0.25) if f is jf
            else tc.DeviceCostModel(0.125, 0.25), cfg, R, ctrl,
            control_every=6, record_masks=True, hist=hist, **extra)

    jres, jctrl = go((ja, jb, jf, jctl), {})
    tres, tctrl = go((ta, tb, tf, tctl), {"device": "cpu"})
    np.testing.assert_array_equal(tres.masks.numpy(), np.asarray(jres.masks))
    np.testing.assert_array_equal(tres.final_charge.numpy(),
                                  np.asarray(jres.final_charge))
    assert set(tres.stats) == set(jres.stats)
    for k in jres.stats:
        np.testing.assert_allclose(tres.stats[k], jres.stats[k], rtol=1e-6,
                                   err_msg=k)
    assert [(t["T"], t["E_mean"]) for t in tctrl.trace] == [
        (t["T"], t["E_mean"]) for t in jctrl.trace]
    assert len({t["T"] for t in tctrl.trace}) > 1
    if hist:
        np.testing.assert_array_equal(tres.final_streak.numpy(),
                                      np.asarray(jres.final_streak))


def test_run_controlled_with_a_holding_controller_equals_one_run(tmp_path):
    from repro_torch.obs import Obs, load_events
    n, R = 30, 20
    cfg = tf.FleetConfig(num_clients=n, policy="greedy", seed=1)
    ctrl = tctl.ServerController(T0=5, E0=2, rules=())
    res, _ = tctl.run_controlled(_fleet(ta, n), tb.BatteryConfig(capacity=2.0),
                                 1.0, cfg, R, ctrl, control_every=7,
                                 record_masks=True, device="cpu")
    one = tf.simulate_fleet(_fleet(ta, n), tb.BatteryConfig(capacity=2.0),
                            1.0, cfg, R, E=np.full(n, 2), record_masks=True,
                            device="cpu")
    assert np.array_equal(res.masks.numpy(), one.masks.numpy())
    for k in one.stats:
        np.testing.assert_array_equal(res.stats[k], one.stats[k], k)
    # checkpoint= (run checkpoints, once unported): the chunk boundaries
    # are saved, and a resume past the horizon returns the same run
    ck = str(tmp_path / "ck")
    saved, _ = tctl.run_controlled(_fleet(ta, n), tb.BatteryConfig(), 1.0,
                                   cfg, 14, ctrl, control_every=7,
                                   checkpoint=ck, device="cpu")
    assert sorted(os.listdir(ck)) == ["MANIFEST.json", "ckpt-00000007.msgpack",
                                      "ckpt-00000014.msgpack"]
    again, _ = tctl.run_controlled(_fleet(ta, n), tb.BatteryConfig(), 1.0,
                                   cfg, 14, ctrl, control_every=7,
                                   checkpoint=ck, resume=True, device="cpu")
    assert np.array_equal(again.final_charge.numpy(),
                          saved.final_charge.numpy())
    for k in saved.stats:
        np.testing.assert_array_equal(again.stats[k], saved.stats[k], k)
    with pytest.raises(ValueError, match="DeviceMesh"):
        tctl.run_controlled(_fleet(ta, n), tb.BatteryConfig(), 1.0, cfg, 1,
                            ctrl, mesh=object(), device="cpu")
    # obs= (observability, once unported): the manifest, then a chunk's
    # span, its rounds and a control event at each boundary
    with Obs(tmp_path) as obs:
        tctl.run_controlled(_fleet(ta, n), tb.BatteryConfig(), 1.0, cfg, 4,
                            ctrl, control_every=2, obs=obs, device="cpu")
    kinds = [e["kind"] for e in load_events(tmp_path / "events.jsonl")]
    assert kinds == (["manifest"] + ["span", "round", "round", "control"] * 2
                     + ["metrics"])


RATE = np.random.default_rng(4).integers(0, 6, 300).astype(np.float32)


@pytest.mark.parametrize("hist", [False, True])
def test_run_serve_controlled_matches_reference(hist):
    """The example's controlled run (battery-gated admission under
    `AdmissionRule`, a 0.2 J training load re-priced each day) on a
    Constant-traffic, Bernoulli-harvest fleet: the reference's ``admit``
    trajectory, modes, charge and ledger."""
    n, E = 300, 96

    def go(fs, tr, a, b, c, Q, ad, ctl, extra):
        ctrl = ctl.ServerController(T0=5, E0=4, rules=(ctl.AdmissionRule(),),
                                    bounds=ctl.ControlBounds())
        return fs.run_serve_controlled(
            tr.Constant.create(n, RATE[:n]),
            a.Bernoulli.create(n, prob=0.3, amount=0.8),
            b.BatteryConfig(capacity=8.0, leak=0.01, init_charge=2.0),
            c.DecodeCostModel.from_params(1e8), Q(128.0, 256.0, 32.0),
            ad.BatteryGated.create(n), fs.ServeConfig(n, seed=1), E, ctrl,
            train_cost=0.2, control_every=24, record_modes=True, hist=hist,
            **extra)

    jres, jctrl = go(jfs, jtr, ja, jb, jc, JQoS, jad, jctl, {})
    tres, tctrl = go(tfs, ttr, ta, tb, tc, TQoS, tad, tctl, {"device": "cpu"})
    admits = [t["admit"] for t in tctrl.trace]
    assert admits == [t["admit"] for t in jctrl.trace]
    assert len(set(admits)) > 1
    np.testing.assert_array_equal(tres.modes.numpy(), np.asarray(jres.modes))
    np.testing.assert_array_equal(tres.final_charge.numpy(),
                                  np.asarray(jres.final_charge))
    for k in ("offered", "served_full", "served_short", "shed",
              "deadline_missed", "participants"):
        np.testing.assert_array_equal(tres.stats[k], jres.stats[k], k)
    for a, b in zip(tctrl.trace, jctrl.trace):
        _same_telemetry_close(a["telemetry"], b["telemetry"])


def _same_telemetry_close(a, b):
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, dict):
            assert x == y, f.name
        elif y is not None:
            np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                       rtol=1e-6, atol=1e-9, err_msg=f.name)


def test_run_serve_controlled_refuses_unported_options(tmp_path):
    from repro_torch.obs import Obs, load_events
    n = 8
    args = (ttr.Constant.create(n), ta.Bernoulli.create(n),
            tb.BatteryConfig(), tc.DecodeCostModel(1.0, 1.0), TQoS(),
            tad.BatteryGated.create(n), tfs.ServeConfig(n), 4,
            tctl.ServerController())
    # checkpoint= (run checkpoints, once unported): a boundary a chunk, and
    # the resumed run equals the uninterrupted one
    ck = str(tmp_path / "ck")
    whole, _ = tfs.run_serve_controlled(*args, control_every=2,
                                        device="cpu")
    tfs.run_serve_controlled(*args[:7], 2, tctl.ServerController(),
                             control_every=2, checkpoint=ck, device="cpu")
    resumed, _ = tfs.run_serve_controlled(*args, control_every=2,
                                          checkpoint=ck, resume=True,
                                          device="cpu")
    assert sorted(os.listdir(ck)) == ["MANIFEST.json", "ckpt-00000002.msgpack",
                                      "ckpt-00000004.msgpack"]
    assert np.array_equal(resumed.final_charge.numpy(),
                          whole.final_charge.numpy())
    for k in whole.stats:
        np.testing.assert_array_equal(resumed.stats[k], whole.stats[k], k)
    # obs= (observability, once unported): the manifest, then a chunk's
    # span, its epochs and a control event at each boundary
    with Obs(tmp_path) as obs:
        tfs.run_serve_controlled(*args, control_every=2, obs=obs,
                                 device="cpu")
    kinds = [e["kind"] for e in load_events(tmp_path / "events.jsonl")]
    assert kinds == (["manifest"] + ["span", "round", "round", "control"] * 2
                     + ["metrics"])
    with pytest.raises(ValueError, match="DeviceMesh"):
        tfs.run_serve_controlled(*args, mesh=object(), device="cpu")
