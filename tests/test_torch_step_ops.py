"""``repro_torch.energy.step_ops`` against the JAX package's
``energy/step_ops.py``: the same fleet programs (ops, reads, writes,
state, emits, stats; battery leaves bound by field name), ``run_step``
against the jitted ``run_step_lax`` (every per-client buffer bitwise on
random non-dyadic inputs, stats to 1e-5 relative as float32 sums in other
orders, histogram counts exact, every stat bitwise on the dyadic
configuration) and ``bytes_moved`` equal to the reference's count."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.scheduling import Policy as JPolicy
from repro.energy import battery as jb
from repro.energy import step_ops as js
from repro_torch.core.scheduling import Policy
from repro_torch.energy import battery as tb
from repro_torch.energy import step_ops as ts

POLICIES = ["sustainable", "greedy", "threshold", "always"]
# the reference binds the battery's pytree leaves as bat0, bat1, bat2
NAMES = {"bat0": "bat_capacity", "bat1": "bat_leak", "bat2": "bat_init_charge"}
rename = lambda names: tuple(NAMES.get(x, x) for x in names)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("hist", [False, True])
@pytest.mark.parametrize("groups", [None, 3])
def test_program_structure_matches_reference(policy, hist, groups):
    jp, _ = js.fleet_step_program(jb.BatteryConfig(), JPolicy(policy),
                                  groups, hist=hist)
    tp, env = ts.fleet_step_program(tb.BatteryConfig(), Policy(policy),
                                    groups, hist=hist)
    assert tp.name == jp.name
    assert [(o.name, o.reads, o.writes) for o in tp.ops] == [
        (o.name, rename(o.reads), o.writes) for o in jp.ops]
    for f in ("state_out", "emit", "totals", "averages", "group_totals",
              "group_averages"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert [(s.name, s.buf, s.lo, s.hi, s.bins) for s in tp.hists] == [
        (s.name, s.buf, s.lo, s.hi, s.bins) for s in jp.hists]
    assert tp.input_names() == rename(jp.input_names())
    assert set(env) == set(ts.BAT_NAMES)


def _inputs(n, seed, dyadic=False, per_client=False):
    r = np.random.default_rng(seed)
    if dyadic:
        bat = dict(capacity=2.5, leak=0.25, init_charge=0.5)
        charge = r.integers(0, 11, n) * 0.25
        harvest = r.integers(0, 5, n) * 0.25
        cost = 0.75
    else:
        # one leak for the fleet: jitted on its own, the reference
        # contracts the absorb only then (tests/test_torch_battery.py)
        bat = (dict(capacity=r.uniform(1, 3, n), leak=0.02,
                    init_charge=r.uniform(0, 3, n)) if per_client
               else dict(capacity=2.5, leak=0.02, init_charge=0.5))
        charge = r.uniform(0, 3, n)
        harvest = r.exponential(0.7, n)
        cost = r.uniform(0.5, 1.5, n) if per_client else 1.0
    bat = {k: np.asarray(v, np.float32) for k, v in bat.items()}
    f32 = lambda a: np.asarray(a, np.float32)
    bufs = dict(charge=f32(charge), harvest=f32(harvest),
                round_cost=f32(cost), threshold=f32(1.5),
                want=f32(r.uniform(size=n) < 0.5),
                streak=f32(r.integers(0, 70, n)),
                valid=f32(np.arange(n) % 7 != 6))
    return bat, bufs, r.integers(0, 3, n).astype(np.int32)


def _both(policy, hist, groups, bat, bufs, gid):
    jp, jenv = js.fleet_step_program(jb.BatteryConfig(**bat), JPolicy(policy),
                                     groups, hist=hist)
    tp, tenv = ts.fleet_step_program(
        tb.BatteryConfig(**{k: torch.tensor(v) for k, v in bat.items()}),
        Policy(policy), groups, hist=hist)
    jenv.update({k: jnp.asarray(v) for k, v in bufs.items()})
    tenv.update({k: torch.tensor(v) for k, v in bufs.items()})
    g = None
    if groups:
        jenv["groups"], tenv["groups"] = jnp.asarray(gid), torch.tensor(gid)
        g = gid
    jout, jstats = jax.jit(lambda e: js.run_step_lax(
        jp, e, valid=e["valid"], groups=e.get("groups"),
        num_groups=groups))(jenv)
    tout, tstats = ts.run_step(tp, tenv, valid=tenv["valid"],
                               groups=tenv.get("groups"), num_groups=groups)
    return tp, jout, jstats, tout, tstats, g


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("hist,groups", [(False, None), (True, 3)])
@pytest.mark.parametrize("per_client", [False, True])
def test_run_step_matches_jitted_reference(policy, hist, groups, per_client):
    n = 200_000
    bat, bufs, gid = _inputs(n, 1, per_client=per_client)
    tp, jout, jstats, tout, tstats, _ = _both(policy, hist, groups, bat, bufs,
                                              gid)
    written = {w for op in tp.ops for w in op.writes}
    for k in written:
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]),
                                      err_msg=k)
    assert set(tstats) == set(jstats)
    for k in jstats:
        if k.startswith("hist_"):
            np.testing.assert_array_equal(tstats[k].numpy(),
                                          np.asarray(jstats[k]), err_msg=k)
        else:
            np.testing.assert_allclose(tstats[k].numpy(),
                                       np.asarray(jstats[k]), rtol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("policy", POLICIES)
def test_run_step_dyadic_stats_bitwise(policy):
    n = 4099
    bat, bufs, gid = _inputs(n, 2, dyadic=True)
    _, jout, jstats, tout, tstats, _ = _both(policy, True, 3, bat, bufs, gid)
    for k in jstats:
        np.testing.assert_array_equal(tstats[k].numpy(),
                                      np.asarray(jstats[k]), err_msg=k)


def test_apply_ops_leaves_the_input_env_alone():
    tp, env = ts.fleet_step_program(tb.BatteryConfig(), Policy.GREEDY)
    env.update(charge=torch.ones(4), harvest=torch.ones(4),
               round_cost=torch.tensor(1.0))
    before = set(env)
    out = ts.apply_ops(tp.ops, env)
    assert set(env) == before and {"available", "mask", "charge_out"} <= set(
        out)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("hist", [False, True])
@pytest.mark.parametrize("per_client", [False, True])
@pytest.mark.parametrize("emit", [False, True])
def test_bytes_moved_equals_reference(policy, hist, per_client, emit):
    n = 1024
    bat, bufs, _ = _inputs(n, 3, per_client=per_client)
    jp, jenv = js.fleet_step_program(jb.BatteryConfig(**bat), JPolicy(policy),
                                     hist=hist)
    tp, tenv = ts.fleet_step_program(
        tb.BatteryConfig(**{k: torch.tensor(v) for k, v in bat.items()}),
        Policy(policy), hist=hist)
    jenv.update({k: jnp.asarray(v) for k, v in bufs.items()})
    tenv.update({k: torch.tensor(v) for k, v in bufs.items()})
    assert ts.bytes_moved(tp, tenv, n, emit=emit) == js.bytes_moved(
        jp, jenv, n, emit=emit)


def test_bytes_moved_leaves_out_inputs_read_through_stride_zero():
    """A scalar expanded to (n,) is one value read through a stride of 0:
    the fused count leaves it out, as it leaves out 0-dim scalars."""
    n = 1024
    tp, env = ts.fleet_step_program(tb.BatteryConfig(), Policy.GREEDY)
    env.update(charge=torch.ones(n), harvest=torch.ones(n),
               valid=torch.ones(n))
    scalar = ts.bytes_moved(tp, dict(env, round_cost=torch.tensor(1.0)), n)
    expanded = ts.bytes_moved(
        tp, dict(env, round_cost=torch.tensor(1.0).expand(n)), n)
    full = ts.bytes_moved(tp, dict(env, round_cost=torch.ones(n)), n)
    assert scalar == expanded
    assert full["fused_bytes"] == scalar["fused_bytes"] + 4 * n
