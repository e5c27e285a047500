"""Preemption-safe runs of the port (``repro_torch.checkpoint.resume``,
DESIGN.md §13), the twin of ``tests/test_resume.py``:

* crash injection: a child (``_torch_resume_child.py``) SIGKILLs itself
  after a seeded chunk boundary, a second SIGTERMs after tearing the file
  it just wrote; the resumed run equals the uninterrupted one bitwise (and
  the reference's uninterrupted run, on the exact-arithmetic fleets);
* resume at every boundary, any chunk split, the ``hist`` variants, a run
  resumed past its horizon;
* the store (rotation, manifest, torn-file fallback), the ``restore_run``
  guards, the argument guards and the obs ``resume`` event;
* across the packages: ``pack_controller`` columns, a reference-written
  controller unpacked by the port, a reference run directory refused
  under the hash and its state validated without it;
* topology-free: a 2-rank gloo checkpoint resumes host-local, bitwise.
"""
import dataclasses
import json
import os
import random
import signal
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_resume_child as child  # noqa: E402
from conftest import kill_at, spawn_child  # noqa: E402
from repro_torch.checkpoint import (CheckpointError, RunCheckpointer,  # noqa
                                    load_checkpoint, pack_controller,
                                    restore_run, save_run, unpack_controller)
from repro_torch.energy import fleet as tf  # noqa: E402
from repro_torch.serve import fleet_serve as tfs  # noqa: E402

CHILD = "_torch_resume_child.py"
CHUNKS = child.ROUNDS // child.EVERY
PORT = child.port()


def reference():
    from repro.core import Policy
    from repro.energy import arrivals, battery, control, costs, fleet
    from repro.serve import admission, fleet_serve, qos, traffic
    return SimpleNamespace(Policy=Policy, arrivals=arrivals, battery=battery,
                           control=control, costs=costs, fleet=fleet,
                           admission=admission, fleet_serve=fleet_serve,
                           qos=qos, traffic=traffic, kw={})


def _equal_digests(a: dict, b: dict, label=""):
    assert sorted(a) == sorted(b), label
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and np.array_equal(x, y), f"{label} {k}"


def _reference_digest(kind, hist=False):
    """The reference's uninterrupted run, as the port's digest."""
    res, ctl = child.RUNS[kind](reference(), hist=hist)
    out = {"stat_" + k: np.asarray(v) for k, v in res.stats.items()}
    out["final_charge"] = np.asarray(res.final_charge)
    if hist:
        out["final_streak"] = np.asarray(res.final_streak)
    out.update({"ctl_" + k: v for k, v in pack_controller(ctl).items()})
    return out


# ------------------------------------------------------- crash injection ---

@pytest.mark.parametrize("kind,seed", [("fleet", 0), ("serve", 1)])
def test_crash_resume_bitwise(tmp_path, kind, seed):
    """SIGKILL after a seeded boundary, then SIGTERM mid-write (the newest
    file torn: the next resume falls back one boundary), then a resume to
    the end: bitwise the uninterrupted run, the port's and the
    reference's."""
    rnd = random.Random(seed)
    ckpt, out = str(tmp_path / "ckpt"), str(tmp_path / "run.npz")
    j1 = rnd.randint(1, CHUNKS - 3)
    kill_at(CHILD, "crash", "--kind", kind, "--ckpt", ckpt,
            "--kill-after-saves", str(j1), "--signal", "KILL",
            signum=signal.SIGKILL)
    assert RunCheckpointer(ckpt).steps()[-1] == j1 * child.EVERY
    j2 = rnd.randint(2, CHUNKS - j1 - 1)
    kill_at(CHILD, "crash", "--kind", kind, "--ckpt", ckpt, "--resume",
            "--kill-after-saves", str(j2), "--signal", "TERM",
            "--corrupt", "truncate", signum=signal.SIGTERM)
    newest = RunCheckpointer(ckpt).steps()[-1]
    assert newest == (j1 + j2) * child.EVERY
    with pytest.raises(CheckpointError, match="truncated or corrupt"):
        load_checkpoint(RunCheckpointer(ckpt).path(newest))
    spawn_child(CHILD, "crash", "--kind", kind, "--ckpt", ckpt, "--resume",
                "--out", out, expect="resume child OK")
    res, ctl = child.RUNS[kind](PORT)
    with np.load(out) as got:
        got = dict(got)
    _equal_digests(got, child.digest(res, ctl), "port")
    _equal_digests(got, _reference_digest(kind), "reference")


# --------------------------------------------- resume at every boundary ----

@pytest.mark.parametrize("hist", [False, True], ids=["plain", "hist"])
@pytest.mark.parametrize("kind", ["fleet", "serve"])
def test_resume_at_every_boundary(tmp_path, kind, hist):
    """Extending the horizon a chunk at a time through checkpoint resume —
    stopping and restarting at every boundary — reproduces the
    uninterrupted run bitwise: telemetry (histogram counts included),
    charge, streak and controller."""
    run = child.RUNS[kind]
    base = child.digest(*run(PORT, hist=hist))
    d = str(tmp_path / "ckpt")
    for b in range(child.EVERY, child.ROUNDS + 1, child.EVERY):
        res, ctl = run(PORT, rounds=b, checkpoint=d, resume=True, hist=hist)
    _equal_digests(child.digest(res, ctl), base)
    if hist:
        assert "final_streak" in base and "stat_hist_soc" in base
        assert "ctl_tel_hq_hist_soc_p95" in base


@pytest.mark.parametrize("kind", ["fleet", "serve"])
def test_resume_past_horizon_returns_restored_run(tmp_path, kind):
    """Resuming a run whose checkpoint covers the horizon returns the
    stored result without simulating anything."""
    run = child.RUNS[kind]
    d = str(tmp_path / "ck")
    base = child.digest(*run(PORT, rounds=12, checkpoint=d))
    sim = tf.simulate_fleet if kind == "fleet" else tfs.simulate_serve
    name = "simulate_fleet" if kind == "fleet" else "simulate_serve"
    mod = tf if kind == "fleet" else tfs

    def refuse(*a, **k):
        raise AssertionError("a resumed-past-horizon run simulated")
    try:
        setattr(mod, name, refuse)
        res, ctl = run(PORT, rounds=12, checkpoint=d, resume=True)
    finally:
        setattr(mod, name, sim)
    _equal_digests(child.digest(res, ctl), base)


# ---------------------------------------------- chunk-split property -------

@settings(max_examples=8, deadline=None)
@given(st.lists(st.integers(1, 9), min_size=1, max_size=5),
       st.sampled_from(tf.FLEET_POLICIES))
def test_any_chunk_split_matches_unchunked_fleet(splits, policy):
    """Any split of the horizon into chunks, threaded through ``state`` /
    ``round_offset``, equals the unchunked run bitwise: the seam every
    checkpoint boundary rests on."""
    n = 16
    lib = PORT
    proc = lib.arrivals.Bernoulli.create(n, prob=0.375, amount=1.25)
    bat = lib.battery.BatteryConfig(capacity=2.5, leak=0.0, init_charge=0.5)
    cfg = tf.FleetConfig(num_clients=n, policy=policy, threshold=1.5, seed=2)
    E = np.full(n, 2)
    base = tf.simulate_fleet(proc, bat, 0.75, cfg, sum(splits), E=E,
                             device="cpu")
    state, off, parts = None, 0, []
    for c in splits:
        r = tf.simulate_fleet(proc, bat, 0.75, cfg, c, E=E, state=state,
                              round_offset=off, device="cpu")
        state, off = r.final_state, off + c
        parts.append(r.stats)
    for k in base.stats:
        assert np.array_equal(base.stats[k],
                              np.concatenate([p[k] for p in parts])), k
    assert torch.equal(base.final_charge, state[0])


@settings(max_examples=8, deadline=None)
@given(st.lists(st.integers(1, 9), min_size=1, max_size=5),
       st.sampled_from(["agnostic", "gated", "charge"]))
def test_any_chunk_split_matches_unchunked_serve(splits, pol_name):
    n = 16
    lib = PORT
    pol = {"agnostic": lib.admission.EnergyAgnostic(),
           "gated": lib.admission.BatteryGated.create(n),
           "charge": lib.admission.ChargeGated.create(n)}[pol_name]
    args = (lib.traffic.Constant.create(n, rate=2.0),
            lib.arrivals.Bernoulli.create(n, prob=0.375, amount=1.25),
            lib.battery.BatteryConfig(capacity=2.5, leak=0.0,
                                      init_charge=0.5),
            lib.costs.DecodeCostModel(2.0 ** -8, 2.0 ** -9, 2.0 ** -6),
            lib.qos.QoSSpec(64.0, 128.0, 32.0), pol,
            tfs.ServeConfig(num_clients=n, seed=5))
    base = tfs.simulate_serve(*args, sum(splits), device="cpu")
    state, off, parts = None, 0, []
    for c in splits:
        r = tfs.simulate_serve(*args, c, state=state, epoch_offset=off,
                               device="cpu")
        state, off = r.final_state, off + c
        parts.append(r.stats)
    for k in base.stats:
        assert np.array_equal(base.stats[k],
                              np.concatenate([p[k] for p in parts])), k
    assert torch.equal(base.final_charge, state[0])


# --------------------------------------------------- store & guards --------

def test_rotation_retains_last_k_and_manifest(tmp_path):
    ck = RunCheckpointer(tmp_path / "r", keep=3)
    for s in range(1, 7):
        ck.save(s, {"x": np.arange(s)}, {"kind": "t", "config_hash": "h"})
    assert ck.steps() == [4, 5, 6]
    with open(ck.manifest_path) as f:
        man = json.load(f)
    assert man["steps"] == [4, 5, 6] and man["keep"] == 3
    assert man["kind"] == "t" and man["config_hash"] == "h"
    tree, step, _ = ck.restore_payload()
    assert step == 6 and torch.equal(tree["x"], torch.arange(6))
    assert sorted(os.listdir(ck.directory)) == [
        "MANIFEST.json", "ckpt-00000004.msgpack", "ckpt-00000005.msgpack",
        "ckpt-00000006.msgpack"]


def test_torn_file_falls_back_to_previous_boundary(tmp_path):
    ck = RunCheckpointer(tmp_path / "r", keep=3)
    ck.save(1, {"x": np.arange(4.0)})
    ck.save(2, {"x": np.arange(8.0)})
    p2 = ck.path(2)
    with open(p2, "r+b") as f:
        f.truncate(os.path.getsize(p2) // 2)
    with pytest.raises(CheckpointError, match="truncated or corrupt"):
        load_checkpoint(p2)
    tree, step, _ = ck.restore_payload()
    assert step == 1 and np.array_equal(tree["x"].numpy(), np.arange(4.0))
    with open(ck.path(1), "r+b") as f:
        f.write(b"\x00" * 32)
    assert ck.restore_payload() is None   # every retained file torn


@pytest.mark.parametrize("change,match", [
    (dict(kind="serve_controlled"), "expected 'serve_controlled'"),
    (dict(config_hash="zzz"), "different config"),
    (dict(seed=2), "RNG base key"),
    (dict(state_like={"charge": torch.zeros(4, dtype=torch.float64)}),
     "refusing to cast"),
    (dict(state_like={"charge": torch.zeros(5)}), "refusing to cast")],
    ids=["kind", "hash", "seed", "dtype", "shape"])
def test_restore_run_guards(tmp_path, change, match):
    state = {"charge": torch.arange(4, dtype=torch.float32)}
    ck = RunCheckpointer(tmp_path / "g")
    save_run(ck, kind="fleet_controlled", round_offset=5, state=state,
             stats={"a": np.arange(5.0)}, config_hash="abc", seed=1)
    kw = dict(kind="fleet_controlled", state_like=state, config_hash="abc",
              seed=1)
    with pytest.raises(CheckpointError, match=match):
        restore_run(ck, **{**kw, **change})
    rc = restore_run(ck, **kw)
    assert rc.round_offset == 5
    assert torch.equal(rc.state["charge"], state["charge"])
    assert np.array_equal(rc.stats["a"], np.arange(5.0))
    assert restore_run(RunCheckpointer(tmp_path / "empty"), kind="x",
                       state_like=state) is None


@pytest.mark.parametrize("kind", ["fleet", "serve"])
def test_resume_rejects_config_change_end_to_end(tmp_path, kind):
    d = str(tmp_path / "ck")
    run = child.RUNS[kind]
    run(PORT, rounds=12, checkpoint=d)
    other = dataclasses.replace(
        child.fleet_controller(PORT).bounds, t_max=9) if kind == "fleet" \
        else dataclasses.replace(child.serve_controller(PORT).bounds,
                                 admit_max=8.0)
    ctl = (child.fleet_controller(PORT) if kind == "fleet"
           else child.serve_controller(PORT))
    ctl.bounds = other
    with pytest.raises(CheckpointError, match="different config"):
        run(PORT, rounds=24, controller=ctl, checkpoint=d, resume=True)


@pytest.mark.parametrize("kind", ["fleet", "serve"])
def test_checkpoint_argument_guards(tmp_path, kind):
    run = child.RUNS[kind]
    with pytest.raises(ValueError, match="resume=True requires"):
        run(PORT, rounds=6, resume=True)
    record = {"record_masks": True} if kind == "fleet" \
        else {"record_modes": True}
    with pytest.raises(ValueError, match=next(iter(record))):
        run(PORT, rounds=6, checkpoint=str(tmp_path / "ck"), **record)


@pytest.mark.parametrize("kind", ["fleet", "serve"])
def test_obs_resume_event_not_second_manifest(tmp_path, kind):
    """A resumed run re-attaches the same event stream: one manifest, a
    ``resume`` event at the restored round, ``seq`` monotone."""
    from repro_torch.obs import Obs, load_events
    run = child.RUNS[kind]
    d, od = str(tmp_path / "ck"), str(tmp_path / "obs")
    with Obs(od) as obs:
        run(PORT, rounds=12, checkpoint=d, obs=obs)
    with Obs(od) as obs:
        run(PORT, rounds=24, checkpoint=d, resume=True, obs=obs)
        path = obs.log.path
    events = load_events(path)
    kinds = [e["kind"] for e in events]
    assert kinds[0] == "manifest" and kinds.count("manifest") == 1
    assert kinds.count("resume") == 1
    r = next(e for e in events if e["kind"] == "resume")
    assert r["run_kind"] == f"{kind}_controlled" and r["round"] == 12
    assert sum(k == "round" for k in kinds) == 24
    assert [e["seq"] for e in events] == list(range(len(events)))
    assert not any(k == "retrace_warning" for k in kinds)


# ------------------------------------------------ across the packages -----

@pytest.mark.parametrize("hist", [False, True], ids=["plain", "hist"])
@pytest.mark.parametrize("kind", ["fleet", "serve"])
def test_pack_controller_equals_reference(kind, hist):
    """The same run's controller packs to equal columns in both packages;
    the reference's columns unpack in the port into the port's trace."""
    from repro.checkpoint import pack_controller as jpack
    _, tctl = child.RUNS[kind](PORT, hist=hist)
    _, jctl = child.RUNS[kind](reference(), hist=hist)
    tp, jp = pack_controller(tctl), jpack(jctl)
    assert sorted(tp) == sorted(jp)
    for k in tp:
        assert tp[k].dtype == jp[k].dtype and np.array_equal(tp[k], jp[k]), k
    fresh = (child.fleet_controller(PORT) if kind == "fleet"
             else child.serve_controller(PORT))
    unpack_controller(fresh, {k: torch.from_numpy(np.asarray(v))
                              for k, v in jp.items()})
    again = pack_controller(fresh)
    for k in tp:
        assert np.array_equal(again[k], tp[k]), k
    for a, b in zip(fresh.trace, tctl.trace):
        for f in dataclasses.fields(b["telemetry"]):
            x, y = getattr(a["telemetry"], f.name), getattr(b["telemetry"],
                                                            f.name)
            assert (x == y if isinstance(y, dict) or y is None
                    else np.array_equal(x, y)), f.name


@pytest.mark.parametrize("hist", [False, True], ids=["plain", "hist"])
@pytest.mark.parametrize("kind", ["fleet", "serve"])
def test_reference_run_directory(tmp_path, kind, hist):
    """A run directory the reference wrote: refused by the port under the
    port's config hash (the hashes differ by design), and without a hash
    its state leaves validate against the port's ``state_like`` (a dtype
    that differed would be a parity fault), its controller unpacks into
    the port's, and the port continues it to the reference's end
    bitwise."""
    d = str(tmp_path / "ref")
    child.RUNS[kind](reference(), rounds=18, hist=hist, checkpoint=d)
    with pytest.raises(CheckpointError, match="different config"):
        child.RUNS[kind](PORT, rounds=36, hist=hist, checkpoint=d,
                         resume=True)
    n = child.N
    charge = torch.zeros(n)
    procs = ((PORT.arrivals.Bernoulli.create(n).init(),) if kind == "fleet"
             else (PORT.traffic.Constant.create(n).init(),
                   PORT.arrivals.Bernoulli.create(n).init()))
    like = (charge, charge) + procs if hist else (charge,) + procs
    ctl = (child.fleet_controller(PORT) if kind == "fleet"
           else child.serve_controller(PORT))
    rc = restore_run(RunCheckpointer(d),
                     kind=f"{kind}_controlled", state_like=like,
                     seed=3 if kind == "fleet" else 5, controller=ctl)
    assert rc.round_offset == 18 and len(ctl.trace) == 3
    want, _ = child.RUNS[kind](PORT, rounds=18, hist=hist)
    assert torch.equal(rc.state[0], want.final_charge)
    for k in want.stats:
        assert rc.stats[k].dtype == want.stats[k].dtype, k
        assert np.array_equal(rc.stats[k], want.stats[k]), k


def test_two_rank_checkpoint_resumes_host_local(tmp_path):
    """A checkpoint that a 2-rank gloo run wrote (the gathered, unpadded
    state, from rank 0) resumes host-local, bitwise the uninterrupted
    host-local run: fleet and serve, with and without ``hist``."""
    from test_torch_fleet_sharded import spawn_groups
    out = spawn_groups(os.path.join(os.path.dirname(__file__), CHILD), (2,),
                       tmp_path)
    assert [r["rank"] for r in out[2]] == [0, 1]
    d = tmp_path / "world2"
    for kind, run in child.RUNS.items():
        for hist in (False, True):
            ck = str(d / f"{kind}-{hist}")
            assert RunCheckpointer(ck).steps()[-1] == child.ROUNDS // 2
            got = child.digest(*run(PORT, checkpoint=ck, resume=True,
                                    hist=hist))
            _equal_digests(got, child.digest(*run(PORT, hist=hist)),
                           f"{kind} hist={hist}")
