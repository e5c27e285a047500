"""``repro_torch.traces`` against the JAX package's ``repro.traces``.

* profiles: every bundled table bitwise, ``rescale`` and ``load_trace``
  (``.npy`` / ``.csv``, its validation) bitwise;
* assignment: row, phase and gain bitwise, drawn and explicit;
* replay: `TraceHarvest` paths and ``poisson=False`` `TraceTraffic` paths
  bitwise against ``repro.traces.sample_paths``; Poisson counts differ
  from the reference's only where ``u`` lies within a few ulp of a cdf
  step (at most 1e-3 of the draws, by one request);
* the fleets: `simulate_fleet` / `simulate_serve` on the golden dyadic
  tables bitwise; padding invariance, also where T equals N or the padded
  width (the port equals the reference's unpadded run); chunked
  `run_controlled` equal to one run; `Sum` / `Scaled` over a trace;
* fits: each ``fit_*`` on the same paths bitwise against the reference's
  parameters, and a round trip each at the reference's tolerances.
"""
import jax
import numpy as np
import pytest
import torch

from repro import traces as jt
from repro.core import Policy as JPolicy
from repro.energy import arrivals as ja
from repro.energy import battery as jb
from repro.energy import control as jctl
from repro.energy import costs as jc
from repro.energy import fleet as jf
from repro.serve import admission as jad
from repro.serve import fleet_serve as jfs
from repro.serve import traffic as jtr
from repro.serve.qos import QoSSpec as JQoS
from repro_torch import prng
from repro_torch import traces as tt
from repro_torch.core.scheduling import Policy
from repro_torch.energy import arrivals as ta
from repro_torch.energy import battery as tb
from repro_torch.energy import control as tctl
from repro_torch.energy import costs as tc
from repro_torch.energy import fleet as tf
from repro_torch.serve import admission as tad
from repro_torch.serve import fleet_serve as tfs
from repro_torch.serve import traffic as ttr
from repro_torch.serve.qos import QoSSpec as TQoS

J = dict(t=jt, a=ja, b=jb, c=jc, f=jf, fs=jfs, ad=jad, tr=jtr, Q=JQoS,
         P=JPolicy, ctl=jctl)
T = dict(t=tt, a=ta, b=tb, c=tc, f=tf, fs=tfs, ad=tad, tr=ttr, Q=TQoS,
         P=Policy, ctl=tctl)

# the reference's golden trace: T=3 slots, P=2 profiles, dyadic values
GOLD_TABLE = np.array([[0.25, 2.0], [1.5, 0.0], [3.0, 0.5]], np.float32)
GOLD_ROW = np.array([0, 1, 0, 1], np.int32)
GOLD_PHASE = np.array([0, 1, 2, 0], np.int32)
GOLD_GAIN = np.array([1.0, 2.0, 0.5, 1.0], np.float32)
GOLD_REQUESTS = np.array([[1.0, 4.0], [2.0, 0.0], [3.0, 1.0]], np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(x):
    """Bit-level view, so float comparisons are bitwise (-0.0, NaN)."""
    a = _np(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eq(got, want, msg=""):
    g, w = _np(got), _np(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (msg, g.dtype, w.dtype)
    assert np.array_equal(_bits(g), _bits(w)), msg


# ------------------------------------------------------------- profiles ----

@pytest.mark.parametrize("slots,peak", [(24, 1.0), (48, 2.5), (7, 0.3)])
def test_profile_tables_bitwise(slots, peak):
    _eq(tt.solar_profile_table(slots, peak), jt.solar_profile_table(slots,
                                                                    peak))
    _eq(tt.request_profile_table(slots, peak),
        jt.request_profile_table(slots, peak))
    for s in tt.SEASONS:
        for c in tt.CLOUDS:
            _eq(tt.solar_day_profile(s, c, slots, peak),
                jt.solar_day_profile(s, c, slots, peak), (s, c))
    for k in tt.REQUEST_KINDS:
        _eq(tt.request_day_profile(k, slots, peak),
            jt.request_day_profile(k, slots, peak), k)
    _eq(tt.rescale(tt.solar_profile_table(slots), 1.7),
        jt.rescale(jt.solar_profile_table(slots), 1.7))
    assert (tt.SEASONS, tt.CLOUDS, tt.REQUEST_KINDS) == (
        jt.SEASONS, jt.CLOUDS, jt.REQUEST_KINDS)


def test_profile_errors_match():
    for fn, arg, match in ((tt.solar_day_profile, ("monsoon",), "season"),
                           (tt.solar_day_profile, ("winter", "fog"), "cloud"),
                           (tt.request_day_profile, ("holiday",), "kind")):
        with pytest.raises(ValueError, match=match):
            fn(*arg)
    with pytest.raises(ValueError, match="all-zero"):
        tt.rescale(np.zeros((4, 2), np.float32), 1.0)


def test_load_trace_bitwise_and_validation(tmp_path):
    tab = tt.solar_profile_table()
    np.save(tmp_path / "t.npy", tab)
    np.savetxt(tmp_path / "t.csv", tab, delimiter=",")
    np.savetxt(tmp_path / "one.csv", tab[:, 0], delimiter=",")
    for name in ("t.npy", "t.csv", "one.csv"):
        _eq(tt.load_trace(str(tmp_path / name)),
            jt.load_trace(str(tmp_path / name)), name)
    assert tt.load_trace(str(tmp_path / "one.csv")).shape == (24, 1)
    bad = tmp_path / "bad.npy"
    for arr, match in ((np.array([1.0, -2.0]), "negative"),
                       (np.array([1.0, np.nan]), "non-finite"),
                       (np.zeros((2, 2, 2)), r"\(T,\) or \(T, P\)")):
        np.save(bad, arr)
        for mod in (tt, jt):
            with pytest.raises(ValueError, match=match):
                mod.load_trace(str(bad))
    with pytest.raises(ValueError, match="format"):
        tt.load_trace("trace.parquet")


# ----------------------------------------------------------- assignment ----

@pytest.mark.parametrize("n,seed,jitter,scale", [
    (1, 0, 0.0, 1.0), (37, 11, 0.3, 1.0), (4096, 5, 0.3, 0.45),
    (1000, 2 ** 31 + 7, 0.25, 1.7)])
@pytest.mark.parametrize("kind", ["TraceHarvest", "TraceTraffic"])
def test_drawn_assignment_bitwise(kind, n, seed, jitter, scale):
    """Row and phase through ``client_randint`` and gain through
    ``client_uniform`` in the reference's float32 order: bitwise."""
    tab = tt.rescale(tt.solar_profile_table(), 0.8)
    a = getattr(tt, kind).create(tab, n, seed=seed, gain_jitter=jitter,
                                 scale=scale)
    b = getattr(jt, kind).create(tab, n, seed=seed, gain_jitter=jitter,
                                 scale=scale)
    for f in ("table", "row", "phase", "gain"):
        _eq(getattr(a, f), getattr(b, f), f)
    assert a.num_clients == n


def test_explicit_assignment_key_and_validation():
    a = tt.TraceHarvest.create(GOLD_TABLE, 4, row=GOLD_ROW, phase=GOLD_PHASE,
                               gain=GOLD_GAIN)
    b = jt.TraceHarvest.create(GOLD_TABLE, 4, row=GOLD_ROW, phase=GOLD_PHASE,
                               gain=GOLD_GAIN)
    for f in ("table", "row", "phase", "gain"):
        _eq(getattr(a, f), getattr(b, f), f)
    # a key in place of a seed, and a scalar gain
    a = tt.TraceTraffic.create(GOLD_TABLE, 9, seed=prng.PRNGKey(3), gain=2.0)
    b = jt.TraceTraffic.create(GOLD_TABLE, 9, seed=jax.random.PRNGKey(3),
                               gain=2.0)
    for f in ("row", "phase", "gain"):
        _eq(getattr(a, f), getattr(b, f), f)
    one = tt.TraceHarvest.create(tt.solar_day_profile(), 6, seed=0)
    assert one.table.shape == (24, 1) and not one.row.any()
    with pytest.raises(ValueError, match=r"\(T,\) or \(T, P\)"):
        tt.TraceHarvest.create(np.zeros((2, 2, 2), np.float32), 4)
    with pytest.raises(ValueError, match=r"row must be \(4,\)"):
        tt.TraceHarvest.create(GOLD_TABLE, 4, row=np.zeros(3, np.int32))


# --------------------------------------------------------------- replay ----

def test_golden_replay_values():
    """The reference's hand-computed slots: gain_i table[(t + phase_i) mod
    T, row_i], for two periods and at large absolute rounds."""
    proc = tt.TraceHarvest.create(GOLD_TABLE, 4, row=GOLD_ROW,
                                  phase=GOLD_PHASE, gain=GOLD_GAIN)
    for t in list(range(6)) + [10 ** 6 + 1, 2 ** 30]:
        want = np.array([GOLD_GAIN[i] * GOLD_TABLE[(t + GOLD_PHASE[i]) % 3,
                                                   GOLD_ROW[i]]
                         for i in range(4)], np.float32)
        h, state = proc.sample(None, t, ())
        _eq(h, want, t)
        assert state == ()
    np.testing.assert_array_equal(proc.sample(None, 1, ())[0].numpy(),
                                  [1.5, 1.0, 0.125, 0.0])


@pytest.mark.parametrize("seed", [0, 9])
def test_sample_paths_bitwise(seed):
    """`sample_paths` of the harvest replay and of ``poisson=False``
    traffic equal the reference's bitwise; Poisson counts by the rule of
    the other Poisson processes."""
    n, R = 700, 30
    sol = tt.rescale(tt.solar_profile_table(), 0.9)
    req = tt.rescale(tt.request_profile_table(), 1.5)
    for kind, tab, kw in (("TraceHarvest", sol, {}),
                          ("TraceTraffic", req, {"poisson": False})):
        a = getattr(tt, kind).create(tab, n, seed=seed, gain_jitter=0.3, **kw)
        b = getattr(jt, kind).create(tab, n, seed=seed, gain_jitter=0.3, **kw)
        _eq(tt.sample_paths(a, R, seed=seed + 1),
            jt.sample_paths(b, R, seed=seed + 1), kind)
    a = tt.TraceTraffic.create(req, n, seed=seed, gain_jitter=0.3)
    b = jt.TraceTraffic.create(req, n, seed=seed, gain_jitter=0.3)
    got = tt.sample_paths(a, R, seed=seed + 1)
    want = jt.sample_paths(b, R, seed=seed + 1)
    moved = np.abs(got - want)
    assert got.dtype == np.float32 and np.array_equal(got, np.round(got))
    assert moved.max() <= 1 and (moved > 0).mean() <= 1e-3
    assert abs(got.mean() - req.mean()) < 0.1 * req.mean()


def test_slab_draws_by_global_index():
    """A slab (``first=``) reads its own clients' row, phase and gain and
    draws its Poisson counts by their global indices."""
    n, first, m = 40, 13, 11
    tab = tt.rescale(tt.request_profile_table(), 2.0)
    whole = tt.TraceTraffic.create(tab, n, seed=4, gain_jitter=0.3)
    part = ta.map_clients(whole, lambda x: x[first:first + m])
    assert part.table.shape == tab.shape
    key = prng.PRNGKey(7)
    for t in (0, 5, 23):
        a, _ = whole.sample(key, t, ())
        b, _ = part.sample(key, t, (), first=first)
        _eq(b, a[first:first + m], t)


# --------------------------------------------------------------- fleets ----

def _fleet(m, proc, n, R, policy, **kw):
    cfg = m["f"].FleetConfig(num_clients=n, policy=m["P"](policy),
                             threshold=1.5, seed=1)
    extra = {"device": "cpu"} if m is T else {}
    return m["f"].simulate_fleet(
        proc, m["b"].BatteryConfig(capacity=4.0, leak=0.0, init_charge=0.5),
        0.75, cfg, R, record_masks=True, **kw, **extra)


def _same_fleet(a, b, label):
    _eq(a.masks, b.masks, f"{label} masks")
    _eq(a.final_charge, b.final_charge, f"{label} charge")
    assert set(a.stats) == set(b.stats)
    for k in b.stats:
        _eq(a.stats[k], b.stats[k], f"{label} {k}")


@pytest.mark.parametrize("policy", ["greedy", "threshold", "sustainable"])
def test_golden_fleet_bitwise(policy):
    procs = [m["t"].TraceHarvest.create(GOLD_TABLE, 4, row=GOLD_ROW,
                                        phase=GOLD_PHASE, gain=GOLD_GAIN)
             for m in (T, J)]
    a, b = _fleet(T, procs[0], 4, 12, policy), _fleet(J, procs[1], 4, 12,
                                                      policy)
    _same_fleet(a, b, policy)
    want = [sum(GOLD_GAIN[i] * GOLD_TABLE[(t + GOLD_PHASE[i]) % 3,
                                          GOLD_ROW[i]] for i in range(4))
            for t in range(12)]
    np.testing.assert_array_equal(a.stats["harvested"], want)


def _serve(m, traffic, harvest, n, E, **kw):
    extra = {"device": "cpu"} if m is T else {}
    cost = m["c"].DecodeCostModel(2.0 ** -8, 2.0 ** -9, 2.0 ** -6)
    qos = m["Q"](prompt_tokens=64.0, full_decode_tokens=128.0,
                 short_decode_tokens=32.0)
    return m["fs"].simulate_serve(
        traffic, harvest,
        m["b"].BatteryConfig(capacity=8.0, leak=0.0, init_charge=2.0), cost,
        qos, m["ad"].BatteryGated.create(n), m["fs"].ServeConfig(n, seed=0),
        E, record_modes=True, **kw, **extra)


def _same_serve(a, b, label):
    _eq(a.modes, b.modes, f"{label} modes")
    _eq(a.final_charge, b.final_charge, f"{label} charge")
    assert set(a.stats) == set(b.stats)
    for k in b.stats:
        _eq(a.stats[k], b.stats[k], f"{label} {k}")


@pytest.mark.parametrize("hist", [False, True])
def test_golden_serve_bitwise(hist):
    """``poisson=False`` integer traffic over the golden harvest: modes,
    charge and every ledger and energy stat bitwise."""
    runs = []
    for m in (T, J):
        traffic = m["t"].TraceTraffic.create(
            GOLD_REQUESTS, 4, row=GOLD_ROW, phase=GOLD_PHASE,
            gain=np.ones(4, np.float32), poisson=False)
        harvest = m["t"].TraceHarvest.create(GOLD_TABLE, 4, row=GOLD_ROW,
                                             phase=GOLD_PHASE, gain=GOLD_GAIN)
        runs.append(_serve(m, traffic, harvest, 4, 6, hist=hist))
    _same_serve(*runs, "golden serve")
    want = [sum(GOLD_REQUESTS[(t + GOLD_PHASE[i]) % 3, GOLD_ROW[i]]
                for i in range(4)) for t in range(6)]
    np.testing.assert_array_equal(runs[0].stats["offered"], want)


@pytest.mark.parametrize("T_slots,n,pad", [(3, 5, 8), (5, 5, 8), (8, 5, 8),
                                           (4, 4, 8)])
def test_padding_invariance_against_the_unpadded_reference(T_slots, n, pad):
    """A table of T slots under ``pad_to``: T = 3 as the reference tests it,
    T = N, T = the padded width.  The port's padded run equals the
    reference's unpadded one bitwise (the reference's own padded run does
    not where T = N: it pads the table with the clients)."""
    tab = (np.arange(2 * T_slots).reshape(T_slots, 2) % 5 * 0.5
           ).astype(np.float32)
    a = _fleet(T, tt.TraceHarvest.create(tab, n, seed=2), n, 30,
               "threshold", pad_to=pad)
    b = _fleet(J, jt.TraceHarvest.create(tab, n, seed=2), n, 30, "threshold")
    _same_fleet(a, b, f"T={T_slots}")
    traffic_tab = (np.arange(2 * T_slots).reshape(T_slots, 2) % 4
                   ).astype(np.float32)
    runs = []
    for m, kw in ((T, {"pad_to": pad}), (J, {})):
        runs.append(_serve(
            m, m["t"].TraceTraffic.create(traffic_tab, n, seed=2,
                                          poisson=False),
            m["t"].TraceHarvest.create(tab, n, seed=2), n, 20, **kw))
    _same_serve(*runs, f"serve T={T_slots}")


def test_chunked_controller_reads_the_slots_of_one_run():
    """A rule-free `run_controlled` in chunks of 7 replays the slots of one
    unchunked run (absolute round indices), bitwise, as the reference's
    does."""
    n, R = 9, 40
    E = np.full(n, 2, np.int64)
    out = []
    for m in (T, J):
        proc = m["t"].TraceHarvest.create(GOLD_TABLE, n, seed=6)
        bat = m["b"].BatteryConfig(capacity=4.0, leak=0.0, init_charge=0.5)
        cfg = m["f"].FleetConfig(num_clients=n, policy=m["P"]("sustainable"),
                                 seed=5)
        extra = {"device": "cpu"} if m is T else {}
        ctrl = m["ctl"].ServerController(T0=cfg.local_steps, E0=E, rules=())
        chunked, _ = m["ctl"].run_controlled(proc, bat, 0.5, cfg, R, ctrl,
                                             control_every=7,
                                             record_masks=True, **extra)
        out.append(chunked)
    cfg = tf.FleetConfig(num_clients=n, policy="sustainable", seed=5)
    one = tf.simulate_fleet(tt.TraceHarvest.create(GOLD_TABLE, n, seed=6),
                            tb.BatteryConfig(capacity=4.0, leak=0.0,
                                             init_charge=0.5), 0.5, cfg, R,
                            E=E, record_masks=True, device="cpu")
    _same_fleet(out[0], one, "chunked vs one run")
    _same_fleet(out[0], out[1], "chunked vs reference")


def test_sum_and_scaled_over_a_trace():
    """`Sum` of a `Scaled` replay and a Bernoulli side channel: the
    reference's fleet bitwise on dyadic gains, and battery conservation."""
    n, R = 16, 24
    gain = (np.arange(n) % 4 * 0.5 + 0.5).astype(np.float32)
    tab = tt.rescale(tt.solar_profile_table(), 1.0)

    def proc(m):
        return m["a"].Sum((
            m["a"].Scaled.create(m["t"].TraceHarvest.create(
                tab, n, seed=3, gain_jitter=0.3), gain=gain),
            m["a"].Bernoulli.create(n, prob=0.3, amount=0.5)))

    a, b = _fleet(T, proc(T), n, R, "greedy"), _fleet(J, proc(J), n, R,
                                                      "greedy")
    _eq(a.masks, b.masks, "masks")
    for k in ("participants", "consumed"):
        _eq(a.stats[k], b.stats[k], k)
    for k in b.stats:
        np.testing.assert_allclose(a.stats[k], b.stats[k], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    charge = a.final_charge.numpy().astype(np.float64)
    s = {k: v.astype(np.float64).sum() for k, v in a.stats.items()}
    lhs = s["harvested"] - s["consumed"] - s["leaked"] - s["overflowed"]
    assert abs(lhs - (charge.sum() - 0.5 * n)) < 1e-3


# ----------------------------------------------------------------- fits ----

@pytest.fixture(scope="module")
def paths():
    """Sample paths of a MarkovSolar, an MMPP and a DiurnalPoisson (the
    reference's), and of the replays the trace launcher fits to."""
    sol = jt.rescale(jt.solar_profile_table(), 1.5)
    req = jt.rescale(jt.request_profile_table(), 1.0)
    zero = np.zeros(64, np.int32)
    return {
        "markov": jt.sample_paths(ja.MarkovSolar.create(
            48, p_stay_day=0.9, p_stay_night=0.8, day_mean=1.4,
            night_mean=0.05), 120, seed=1),
        "mmpp": jt.sample_paths(jtr.MMPP.create(
            48, p_stay_calm=0.9, p_stay_burst=0.7, calm_rate=0.5,
            burst_rate=4.0), 120, seed=2),
        "diurnal": jt.sample_paths(jtr.DiurnalPoisson.create(
            48, base=1.2, swing=0.6, phase=5.0), 120, seed=3),
        "solar_replay": jt.sample_paths(jt.TraceHarvest.create(
            sol, 64, seed=0, phase=zero, gain_jitter=0.3), 96, seed=0),
        "request_replay": jt.sample_paths(jt.TraceTraffic.create(
            req, 64, seed=0, phase=zero, gain_jitter=0.3), 96, seed=0),
    }


FITS = {"markov_solar": ("markov", ("p_stay_day", "p_stay_night",
                                    "day_mean", "night_mean")),
        "markov_solar_replay": ("solar_replay", ("p_stay_day",
                                                 "p_stay_night", "day_mean",
                                                 "night_mean")),
        "mmpp": ("mmpp", ("p_stay_calm", "p_stay_burst", "calm_rate",
                          "burst_rate")),
        "diurnal_poisson": ("diurnal", ("base", "swing", "phase")),
        "diurnal_poisson_replay": ("request_replay", ("base", "swing",
                                                      "phase"))}


@pytest.mark.parametrize("name", sorted(FITS))
def test_fit_parameters_bitwise_on_the_same_paths(paths, name):
    key, fields = FITS[name]
    fn = "fit_" + name.removesuffix("_replay")
    for x in (paths[key], paths[key][:, 0]):
        a = getattr(tt, fn)(x, 5)
        b = getattr(jt, fn)(x, 5)
        assert type(a).__name__ == type(b).__name__ and a.num_clients == 5
        for f in fields:
            _eq(getattr(a, f), getattr(b, f), f)
        for f in ("period", "max_requests"):
            assert getattr(a, f, None) == getattr(b, f, None)
    with pytest.raises(ValueError, match="R >= 2"):
        getattr(tt, fn)(np.zeros((1,)))


def _close(got, want, rel=0.15, floor=0.08):
    return abs(got - want) <= max(rel * abs(want), floor)


def test_fit_round_trips_at_the_reference_tolerances():
    """Processes of known parameters re-fit from the port's own sample
    paths (96 clients x 240 rounds): stay probabilities within 0.08, rates
    within 15% (0.08 floor), diurnal base within 10% (0.05), swing within
    0.1, phase within 1.5 slots."""
    R, N = 240, 96
    fit = tt.fit_markov_solar(tt.sample_paths(ta.MarkovSolar.create(
        N, p_stay_day=0.9, p_stay_night=0.8, day_mean=1.4, night_mean=0.05),
        R, seed=11), 4)
    for f, want in (("p_stay_day", 0.9), ("p_stay_night", 0.8),
                    ("day_mean", 1.4), ("night_mean", 0.05)):
        assert _close(float(getattr(fit, f)[0]), want), f
    fit = tt.fit_mmpp(tt.sample_paths(ttr.MMPP.create(
        N, p_stay_calm=0.85, p_stay_burst=0.7, calm_rate=0.4,
        burst_rate=4.5), R, seed=12), 4)
    for f, want in (("p_stay_calm", 0.85), ("p_stay_burst", 0.7),
                    ("calm_rate", 0.4), ("burst_rate", 4.5)):
        assert _close(float(getattr(fit, f)[0]), want), f
    fit = tt.fit_diurnal_poisson(tt.sample_paths(ttr.DiurnalPoisson.create(
        N, base=1.3, swing=0.6, phase=7.0), R, seed=13), 4)
    assert _close(float(fit.base[0]), 1.3, rel=0.1, floor=0.05)
    assert abs(float(fit.swing[0]) - 0.6) <= 0.1
    d = abs(float(fit.phase[0]) - 7.0)
    assert min(d, 24.0 - d) <= 1.5 and fit.period == 24


def test_reference_caveat_a_table_of_n_slots_under_padding():
    """The reference's padding takes a (T, P) table with T = N for a client
    axis (``ROADMAP.md``, "Reference caveats"): its padded run harvests
    44.75 J where its unpadded run harvests 50.75 J.  The port's padded
    run harvests the unpadded 50.75 J."""
    tab = np.array([[0.25, 2.0], [1.5, 0.0], [3.0, 0.5], [1.0, 0.75]],
                   np.float32)
    got = {}
    for m in (J, T):
        proc = m["t"].TraceHarvest.create(tab, 4, seed=0)
        for pad in (None, 8):
            res = _fleet(m, proc, 4, 10, "greedy", pad_to=pad)
            got[m is T, pad] = float(res.stats["harvested"].sum())
    assert got[False, None] == got[True, None] == got[True, 8] == 50.75
    assert got[False, 8] == 44.75
