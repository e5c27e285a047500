"""``repro_torch.obs`` against the JAX package's ``repro.obs``.

* `EventLog`: ``seq`` continued on re-open, a torn last line skipped (the
  reference's ``load_events`` reads the port's logs alike);
* `pytree_hash`: the same across processes, different when any value,
  dtype or field differs;
* the manifest: first call wins, later calls are ``phase`` events, torch
  and the device named;
* ``obs=`` in all four entry points: ``obs=None``, ``Obs()`` and
  ``Obs(tap=True)`` give bitwise the same results, and the tapped and
  untapped streams carry the same round values;
* the reports: ``summary``, ``dist``, ``trend`` and ``bench-diff`` give
  the reference's dicts, tables and verdicts on the same event logs and
  BENCH-style dicts (built here, in ``tmp_path``);
* spans, ``profiler_trace``, the retrace sentinel, and the launchers'
  ``--obs-dir`` (``launch.train``, ``launch.trace_fleet``).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.obs import events as jev
from repro.obs import metrics as jmet
from repro.obs import report as jrep
from repro_torch.energy import arrivals as ta
from repro_torch.energy import battery as tb
from repro_torch.energy import control as tctl
from repro_torch.energy import costs as tc
from repro_torch.energy import fleet as tf
from repro_torch.obs import (EventLog, Obs, RetraceSentinel, RunManifest,
                             annotate, load_events, profiler_trace,
                             pytree_hash, reset_spans, span, span_totals)
from repro_torch.obs import report as trep
from repro_torch.serve import admission as tad
from repro_torch.serve import fleet_serve as tfs
from repro_torch.serve import traffic as ttr
from repro_torch.serve.qos import QoSSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


# ------------------------------------------------------------ event log ----

def test_event_log_seq_on_reopen_and_torn_tail(tmp_path):
    path = tmp_path / "events.jsonl"
    with EventLog(path) as log:
        log.emit("a", x=1, f=np.float32(2.5), arr=np.arange(3),
                 t=torch.tensor([0.5, 1.5]), s=torch.tensor(3))
        log.emit("b", nested={"k": [1, 2]})
        log.emit("c")
    with open(path, "a") as f:
        f.write('{"seq": 99, "kind": "torn')           # a killed writer
    ev = load_events(path)
    assert [e["kind"] for e in ev] == ["a", "b", "c"]
    assert [e["seq"] for e in ev] == [0, 1, 2]
    assert ev[0]["f"] == 2.5 and ev[0]["arr"] == [0, 1, 2]
    assert ev[0]["t"] == [0.5, 1.5] and ev[0]["s"] == 3
    with open(path, "a") as f:
        f.write("\n")
    with EventLog(path) as log:                         # re-opened: seq goes on
        rec = log.emit("d")
    assert rec["seq"] == 3
    ev = load_events(path)
    assert [e["seq"] for e in ev] == [0, 1, 2, 3]
    assert jev.load_events(path) == ev
    with pytest.raises(ValueError, match="closed"):
        log.emit("e")


# --------------------------------------------------------- pytree hash -----

def _config(n=8, prob=0.5, max_requests=16):
    return (ta.Bernoulli.create(n, prob=prob, amount=1.25),
            tb.BatteryConfig(capacity=2.0, leak=0.01),
            ttr.MMPP.create(n, max_requests=max_requests), 0.75,
            {"policy": "greedy", "E": np.arange(n)})


def test_pytree_hash_stable_across_processes_and_discriminating():
    h = pytree_hash(_config())
    assert h == pytree_hash(_config()) and len(h) == 16
    code = ("import sys; sys.path.insert(0, 'tests'); "
            "from test_torch_obs import _config; "
            "from repro_torch.obs import pytree_hash; "
            "print(pytree_hash(_config()))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == h
    # a stride-0 expand hashes as its values do
    proc = _config()[0]
    dense = dataclasses.replace(proc, prob=proc.prob.contiguous())
    assert pytree_hash(dense) == pytree_hash(proc)
    changed = [
        _config(prob=0.25), _config(max_requests=8), _config(n=9),
        _config()[:4] + ({"policy": "greedy", "E": np.arange(8) + 1},),
        _config()[:4] + ({"policy": "always", "E": np.arange(8)},),
        _config()[:3] + (0.5,) + _config()[4:],
        (dataclasses.replace(proc, amount=proc.amount.double()),)
        + _config()[1:],
        list(_config())]
    hashes = {pytree_hash(c) for c in changed}
    assert h not in hashes and len(hashes) == len(changed)


def test_manifest_first_call_wins_and_phase_events(tmp_path):
    config = _config()
    with Obs(tmp_path, run_id="r1") as obs:
        m1 = obs.write_manifest("fleet", config=config, seed=7,
                                num_clients=8, horizon=5, device="cpu",
                                backend="plain", policy="greedy")
        m2 = obs.write_manifest("serve", config=config[:2], seed=7,
                                num_clients=8, horizon=5, device="cpu")
    assert m1 is m2 and m1.kind == "fleet" and m1.run_id == "r1"
    ev = load_events(obs.log.path)
    man = ev[0]
    assert man["kind"] == "manifest" and man["run_kind"] == "fleet"
    assert man["config_hash"] == pytree_hash(config)
    assert man["packages"]["torch"] == torch.__version__
    assert "jax" not in man["packages"]
    assert (man["device_type"], man["device_name"], man["device_count"]) \
        == ("cpu", None, 1)
    assert man["extra"] == {"policy": "greedy"} and man["seed"] == 7
    phases = [e for e in ev if e["kind"] == "phase"]
    assert len(phases) == 1 and phases[0]["phase"] == "serve"
    assert phases[0]["config_hash"] == pytree_hash(config[:2])
    assert ev[-1]["kind"] == "metrics"
    assert set(RunManifest.create("x").to_dict()) >= {
        "kind", "run_id", "created", "seed", "backend", "mesh_shape",
        "num_clients", "horizon", "config_hash", "packages", "git_rev",
        "platform", "device_count", "argv", "extra"}


# ------------------------------------------------- the four entry points ---

N, R = 24, 12


def _fleet(obs=None, hist=True):
    cfg = tf.FleetConfig(num_clients=N, policy="sustainable", seed=2)
    return tf.simulate_fleet(
        ta.MarkovSolar.create(N, day_mean=0.9), tb.BatteryConfig(
            capacity=2.5, leak=0.02, init_charge=0.5), 0.75, cfg, R,
        E=np.arange(N) % 4 + 1, groups=np.arange(N) % 3, record_masks=True,
        hist=hist, obs=obs, device="cpu")


def _serve(obs=None, hist=True):
    return tfs.simulate_serve(
        ttr.DiurnalPoisson.create(N, base=1.5, phase=np.arange(N) % 24),
        ta.Bernoulli.create(N, prob=0.4, amount=1.5),
        tb.BatteryConfig(capacity=8.0, leak=0.01, init_charge=2.0),
        tc.DecodeCostModel.from_params(1e8), QoSSpec(128.0, 256.0, 32.0),
        tad.BatteryGated.create(N), tfs.ServeConfig(N, seed=1), R,
        train=tfs.TrainLoad.create(np.full(N, 4), 0.2), record_modes=True,
        hist=hist, obs=obs, device="cpu")


def _controlled(obs=None):
    ctrl = tctl.ServerController(
        T0=6, E0=[1, 5, 10], groups=np.arange(N) % 3,
        rules=(tctl.CadenceRule(depleted_high=0.2),
               tctl.BudgetRule(depleted_high=0.2, slip=0.9)))
    cfg = tf.FleetConfig(num_clients=N, policy="sustainable", seed=2)
    res, ctrl = tctl.run_controlled(
        ta.Bernoulli.create(N, prob=0.35, amount=1.25),
        tb.BatteryConfig(capacity=2.5, init_charge=0.5),
        tc.DeviceCostModel(0.125, 0.25), cfg, R, ctrl, control_every=4,
        record_masks=True, hist=True, obs=obs, device="cpu")
    res.knobs = [(t["T"], t["E_mean"], t["admit"]) for t in ctrl.trace]
    return res


def _serve_controlled(obs=None):
    ctrl = tctl.ServerController(T0=5, E0=4, rules=(tctl.AdmissionRule(),))
    res, ctrl = tfs.run_serve_controlled(
        ttr.MMPP.create(N, calm_rate=1.0, burst_rate=5.0),
        ta.MarkovSolar.create(N, day_mean=2.0),
        tb.BatteryConfig(capacity=8.0, leak=0.01, init_charge=2.0),
        tc.DecodeCostModel.from_params(1e8), QoSSpec(128.0, 256.0, 32.0),
        tad.BatteryGated.create(N), tfs.ServeConfig(N, seed=3), R, ctrl,
        train_cost=0.2, control_every=4, record_modes=True, hist=True,
        obs=obs, device="cpu")
    res.knobs = [(t["T"], t["E_mean"], t["admit"]) for t in ctrl.trace]
    return res


ENTRIES = {"simulate_fleet": (_fleet, "fleet", "masks"),
           "simulate_serve": (_serve, "serve", "modes"),
           "run_controlled": (_controlled, "fleet", "masks"),
           "run_serve_controlled": (_serve_controlled, "serve", "modes")}


def _round_values(path):
    return [{k: v for k, v in e.items() if k not in ("seq", "ts")}
            for e in load_events(path) if e["kind"] in ("round", "hist")]


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_obs_none_is_bitwise_the_instrumented_run(tmp_path, entry):
    """``obs=None``, ``Obs()`` and ``Obs(tap=True)``: the same masks or
    modes, charge, stats (and controller knobs) bitwise; the streamed
    rounds are the result's stats, tapped or not."""
    run, scan, per_client = ENTRIES[entry]
    plain = run()
    streams = []
    for tap in (False, True):
        with Obs(tmp_path / str(tap), tap=tap) as obs:
            res = run(obs=obs)
        assert torch.equal(getattr(res, per_client),
                           getattr(plain, per_client))
        assert torch.equal(res.final_charge.view(torch.int32),
                           plain.final_charge.view(torch.int32))
        assert set(res.stats) == set(plain.stats)
        for k in plain.stats:
            assert np.array_equal(res.stats[k].view(np.uint8),
                                  plain.stats[k].view(np.uint8)), k
        assert getattr(res, "knobs", None) == getattr(plain, "knobs", None)
        ev = load_events(obs.log.path)
        kinds = [e["kind"] for e in ev]
        assert kinds[0] == "manifest" and kinds.count("manifest") == 1
        rounds = [e for e in ev if e["kind"] == "round"]
        assert [e["round"] for e in rounds] == list(range(R))
        assert all(e["scan"] == scan for e in rounds)
        np.testing.assert_array_equal(
            [e["participants"] for e in rounds], plain.stats["participants"])
        hists = [e for e in ev if e["kind"] == "hist"]
        assert len(hists) == 3 * R
        assert all(sum(e["counts"]) == N for e in hists)
        if entry.startswith("run_"):
            assert kinds.count("control") == R // 4
            assert kinds.count("span") == R // 4
            assert "retrace_warning" not in kinds
        streams.append(_round_values(obs.log.path))
    assert streams[0] == streams[1]


# ----------------------------------------------------------------- reports --

def _report_log(tmp_path):
    """One event log: a hist fleet run, a controlled run and a serving run
    streamed into one Obs, with a span and a retrace warning."""
    with Obs(tmp_path / "run") as obs:
        _fleet(obs=obs)
        _controlled(obs=obs)
        _serve(obs=obs)
        with obs.span("extra"):
            pass
        obs.event("retrace_warning", fn="kernel_libraries", delta=1,
                  size=2, context="test")
    return load_events(obs.log.path)


def test_summary_and_dist_equal_the_reference(tmp_path):
    events = _report_log(tmp_path)
    s = trep.summarize(events)
    assert s == jrep.summarize(events)
    assert s["scans"]["fleet"]["rounds"] == 2 * R
    assert s["scans"]["serve"]["rounds"] == R
    assert len(s["retrace_warnings"]) == 1 and len(s["controls"]) == R // 4
    ours, ref = (trep.render_summary(s).splitlines(),
                 jrep.render_summary(s).splitlines())
    # the header names the manifest's framework: torch here, jax there
    assert f"torch={torch.__version__}" in ours[1]
    assert ours[1].replace(f"torch={torch.__version__}", "jax=None") \
        == ref[1]
    assert ours[:1] + ours[2:] == ref[:1] + ref[2:]
    d = trep.dist(events)
    assert d == jrep.dist(events)
    assert trep.render_dist(d) == jrep.render_dist(d)
    assert set(d["scans"]["fleet"]["hists"]) == {"hist_soc", "hist_spend",
                                                "hist_streak"}


def test_reports_read_the_reference_logs(tmp_path):
    """A log written by the reference's own `Obs` (its manifest names jax)
    renders as the reference renders it."""
    res = _serve()
    with jmet.Obs(tmp_path / "ref") as obs:
        obs.write_manifest("serve", seed=1, num_clients=N, horizon=R)
        obs.rounds("serve", 0, res.stats)
    events = jev.load_events(tmp_path / "ref" / "events.jsonl")
    assert trep.render_summary(trep.summarize(events)) == \
        jrep.render_summary(jrep.summarize(events))
    assert "jax=" in trep.render_summary(trep.summarize(events))
    assert trep.render_dist(trep.dist(events)) == \
        jrep.render_dist(jrep.dist(events))
    for degenerate in ([], [{"seq": 0, "kind": "resume",
                             "run_kind": "fleet_controlled", "round": 12,
                             "horizon": 36, "checkpoint_dir": "c"}]):
        assert trep.summarize(degenerate) == jrep.summarize(degenerate)
        assert "(no round events)" in trep.render_summary(
            trep.summarize(degenerate))


def _bench():
    rs = np.random.default_rng(0)
    return {
        "round_step": [{"num_clients": n, "policy": p,
                        "unfused_ms": float(rs.uniform(1, 5)),
                        "lax_fused_ms": float(rs.uniform(1, 5)),
                        "pallas_ms": float(rs.uniform(1, 5)),
                        "speedup_fused_vs_unfused": float(rs.uniform(1, 3))}
                       for n in (1000, 100000) for p in ("greedy", "always")],
        "results": [{"num_clients": 1000, "policy": "greedy",
                     "process": "markov", "run_s": 2.0}],
        "engine": [{"arch": "a", "slots": 4, "cache_len": 64,
                    "prefill_ms": 3.0, "decode_step_ms": 1.0}],
        "percentiles": [{"scan": "fleet", "regime": "drought",
                         "num_clients": 1000, "policy": "greedy",
                         "p95_frac_depleted": 0.3}]}


def test_bench_diff_and_trend_equal_the_reference(tmp_path):
    assert trep.SECTION_SPECS == jrep.SECTION_SPECS
    base = _bench()
    fresh = json.loads(json.dumps(base))
    fresh["round_step"][0]["lax_fused_ms"] *= 2.0
    fresh["round_step"][1]["speedup_fused_vs_unfused"] *= 0.4
    fresh["engine"][0]["decode_step_ms"] *= 3.0
    fresh["percentiles"][0]["p95_frac_depleted"] *= 1.2     # within 25%
    del fresh["results"]
    cases = [(base, base, {}), (base, fresh, {}),
             (base, fresh, {"sections": ["round_step"]}),
             (base, fresh, {"rel": 0.1}), (fresh, base, {}),
             ({"results": []}, base, {})]
    for b, f, kw in cases:
        v = trep.bench_diff(b, f, **kw)
        assert v == jrep.bench_diff(b, f, **kw), kw
        assert trep.render_diff(v, "b.json", "f.json") == \
            jrep.render_diff(v, "b.json", "f.json")
    assert {x["metric"] for x in trep.bench_diff(base, fresh)} == {
        "lax_fused_ms", "speedup_fused_vs_unfused", "decode_step_ms", None}
    with pytest.raises(ValueError, match="no tripwire spec"):
        trep.bench_diff(base, base, sections=["nope"])
    (tmp_path / "base.json").write_text(json.dumps(base))
    (tmp_path / "fresh.json").write_text(json.dumps(fresh))
    assert trep.main(["bench-diff", str(tmp_path / "base.json"),
                      str(tmp_path / "base.json")]) == 0
    assert trep.main(["bench-diff", str(tmp_path / "base.json"),
                      str(tmp_path / "fresh.json")]) == 1
    hist = tmp_path / "BENCH_history.jsonl"
    hist.write_text("\n".join(json.dumps(
        {"bench": b, "git_rev": f"abc{i}", "recorded": f"2026-0{i + 1}-01",
         "headline": {"rounds_per_s": 10.0 + i, "n": i}})
        for i, b in enumerate(("fleet_scale", "serve_scale", "fleet_scale")))
        + "\n{torn")
    recs = trep.load_history(str(hist))
    assert recs == jrep.load_history(str(hist)) and len(recs) == 3
    for bench in (None, "fleet_scale", "missing"):
        assert trep.render_trend(recs, bench) == \
            jrep.render_trend(recs, bench)


def test_report_cli_summary_and_dist(tmp_path):
    _report_log(tmp_path)
    run = str(tmp_path / "run")
    for args in (["summary", run], ["summary", run, "--json"],
                 ["dist", run, "--out", str(tmp_path / "dist.md")]):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.report", *args],
            capture_output=True, text=True, env=_env(), cwd=REPO,
            timeout=120)
        assert out.returncode == 0, out.stderr
        assert "RuntimeWarning" not in out.stderr
    assert (tmp_path / "dist.md").read_text().startswith(
        "# Distributional telemetry")
    assert trep.main(["summary", str(tmp_path / "nowhere")]) == 2


# ------------------------------------------------- spans and the sentinel --

def test_spans_annotate_and_profiler_trace(tmp_path):
    reset_spans()

    @annotate("decorated")
    def work(x):
        return x * 2

    with Obs(tmp_path / "run") as obs:
        with profiler_trace(str(tmp_path / "trace")):
            with span("outer", obs=obs):
                assert work(torch.ones(4)).sum() == 8
            with span("outer"):
                pass
    totals = span_totals()
    assert totals["outer"]["count"] == 2 and totals["decorated"]["count"] == 1
    ev = [e for e in load_events(obs.log.path) if e["kind"] == "span"]
    assert [e["name"] for e in ev] == ["outer"] and ev[0]["ms"] >= 0
    traces = os.listdir(tmp_path / "trace")
    assert len(traces) == 1 and traces[0].endswith(".json")
    names = {e.get("name") for e in json.load(
        open(tmp_path / "trace" / traces[0]))["traceEvents"]}
    assert {"outer", "decorated"} <= names
    with profiler_trace(None):                      # a no-op
        pass
    with pytest.raises(KeyError):                   # the body's errors pass
        with span("raises"):
            raise KeyError("x")
    assert "raises" not in span_totals()
    reset_spans()
    assert span_totals() == {}


def test_retrace_sentinel(tmp_path):
    box = {"n": 1}
    with Obs(tmp_path) as obs:
        s = RetraceSentinel(obs, watch={"lib": lambda: box["n"]})
        assert s.check() == [] and s.snapshot() == {"lib": 1}
        box["n"] = 2
        assert s.check(expect=1) == []
        box["n"] = 4
        grown = s.check(context="chunk 3")
        assert grown == [{"fn": "lib", "delta": 2, "size": 4,
                          "context": "chunk 3"}]
        assert s.check() == []                      # reported once
    ev = [e for e in load_events(obs.log.path)
          if e["kind"] == "retrace_warning"]
    assert len(ev) == 1 and ev[0]["delta"] == 2
    sizes = RetraceSentinel().sizes()
    assert list(sizes) == ["kernel_libraries"] and sizes["kernel_libraries"] \
        >= 0


# ------------------------------------------------------------ launchers ---

def test_train_launcher_obs_dir(tmp_path, capsys):
    from repro_torch.launch import train
    assert train.main(["--arch", "cifar-cnn", "--device", "cpu", "--rounds",
                       "2", "--clients", "2", "--local-steps", "1",
                       "--batch", "2", "--obs-dir", str(tmp_path)]) == 0
    assert "obs events ->" in capsys.readouterr().out
    ev = load_events(tmp_path / "events.jsonl")
    assert [e["kind"] for e in ev] == ["manifest", "span", "round", "span",
                                       "round", "metrics"]
    assert ev[0]["run_kind"] == "train" and ev[0]["extra"]["arch"] == \
        "cifar-cnn"
    assert {e["name"] for e in ev if e["kind"] == "span"} == {"train_round"}
    assert [e["round"] for e in ev if e["kind"] == "round"] == [0, 1]
    assert all(np.isfinite(e["loss"]) for e in ev if e["kind"] == "round")


def test_trace_fleet_launcher(tmp_path, capsys):
    """``launch.trace_fleet`` at 64 clients x 48 epochs: the twins' fit, the
    table's two rows, and both controlled runs in one event log (one
    manifest, one phase)."""
    from repro_torch.launch import trace_fleet
    assert trace_fleet.main(["--device", "cpu", "--clients", "64",
                             "--epochs", "48", "--obs-dir",
                             str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "calibrated twins (fit on 256 clients x 240 epochs" in out
    rows = {line.split()[0]: line.split() for line in out.splitlines()
            if line.split()[:1] in (["trace"], ["twin"])}
    assert set(rows) == {"trace", "twin"}
    for name in ("trace", "twin"):
        row = [r for r in out.splitlines() if r.split()[:1] == [name]]
        table, speed = row[0].split(), row[1].split()
        assert len(table) == 7 and len(speed) == 4 and speed[-1] == "0"
        served, shed, miss = (float(x) for x in table[1:4])
        assert abs(served + shed + miss - 100.0) < 0.02
    assert "depletion p95:" in out and "offered  p99:" in out
    ev = load_events(tmp_path / "events.jsonl")
    kinds = [e["kind"] for e in ev]
    assert kinds.count("manifest") == 1 and kinds.count("phase") == 1
    assert ev[0]["run_kind"] == "serve_controlled"
    assert kinds.count("control") == 2 * 48 // 24
    assert sum(e["kind"] == "round" for e in ev) == 2 * 48
