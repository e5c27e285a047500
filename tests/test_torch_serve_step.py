"""The serve program of the fleet step (``energy.step_ops.
serve_step_program``) and its kernel wrapper against the JAX package.

* The program's ops, reads, writes, state, emits and stats equal the
  reference's (its pytree leaves ``bat0``, ``cost0``, ``qos0``, ``pol0``,
  ``train0``, ... are bound here by field name).
* ``run_step`` (the plain version) against the jitted ``run_step_lax``,
  the Pallas kernel in interpret mode and both ``serve_step_reference``
  oracles: every buffer and stat bitwise on the reference's dyadic
  configuration (``tests/test_kernels.py``), for every admission rule and
  training gate.
* The three multiply-add sites whose product is inexact, each against the
  reference's jitted serving scan (``fleet_serve._run_serve_scan``), read
  per client through a one-hot ``valid``: the serve drain and the decode
  term of the prices are fused multiply-adds there, the total spend is not.
* The CUDA wrapper's program check and ``kernel_tolerance`` against a model
  of csrc/serve_step.cu's summation order with planted faults.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.scheduling import Policy as JPolicy
from repro.energy import battery as jb
from repro.energy import costs as jc
from repro.energy import step_ops as js
from repro.kernels import fleet_step as jfleet
from repro.kernels import ref as jref
from repro.serve import admission as jad
from repro.serve import fleet_serve as jfs
from repro.serve import traffic as jtr
from repro.serve.qos import QoSSpec as JQoS
from repro_torch.core.scheduling import Policy
from repro_torch.energy import battery as tb
from repro_torch.energy import costs as tc
from repro_torch.energy import step_ops as ts
from repro_torch.kernels import fleet_step as fs
from repro_torch.kernels import ops, ref
from repro_torch.obs import hist as hist_lib
from repro_torch.serve import admission as tad
from repro_torch.serve import fleet_serve as tfs
from repro_torch.serve.qos import QoSSpec as TQoS

ADMISSIONS = ["agnostic", "battery", "charge"]
TRAINS = [None, "sustainable", "threshold", "greedy", "always"]
# the reference binds pytree leaves by position; the port by field name
NAMES = {"bat0": "bat_capacity", "bat1": "bat_leak", "bat2": "bat_init_charge",
         "cost0": "cost_joules_per_prefill_token",
         "cost1": "cost_joules_per_decode_step",
         "cost2": "cost_joules_per_response_upload",
         "qos0": "qos_prompt_tokens", "qos1": "qos_full_decode_tokens",
         "qos2": "qos_short_decode_tokens", "pol0": "pol_hi", "pol1": "pol_lo",
         "train0": "train_E", "train1": "train_round_cost",
         "train2": "train_threshold"}
rename = lambda names: tuple(NAMES.get(x, x) for x in names)

# the reference's dyadic serving configuration (tests/test_kernels.py)
CAP, LEAK = 2.5, 0.25
DECODE = (2.0 ** -8, 2.0 ** -9, 2.0 ** -6)
QOS = (64.0, 128.0, 32.0)


def _policy(mod, kind, hi, lo):
    if kind == "agnostic":
        return mod.EnergyAgnostic()
    cls = mod.BatteryGated if kind == "battery" else mod.ChargeGated
    if mod is tad:
        hi, lo = torch.as_tensor(hi), torch.as_tensor(lo)
    return cls(hi=hi, lo=lo)


def _train(fsmod, kind, n, cost=0.25):
    if kind is None:
        return None
    P = JPolicy if fsmod is jfs else Policy
    return fsmod.TrainLoad.create(np.full(n, 4), cost, policy=P(kind),
                                  threshold=1.5)


def _programs(kind, train, hist, n=8, bat=(CAP, LEAK), decode=DECODE,
              qos=QOS, hi=1.0, lo=0.25):
    jp, jenv = js.serve_step_program(
        jb.BatteryConfig(capacity=bat[0], leak=bat[1], init_charge=0.5),
        jc.DecodeCostModel(*decode), JQoS(*qos), _policy(jad, kind, hi, lo),
        _train(jfs, train, n), hist=hist)
    tp, tenv = ts.serve_step_program(
        tb.BatteryConfig(capacity=bat[0], leak=bat[1], init_charge=0.5),
        tc.DecodeCostModel(*decode), TQoS(*qos), _policy(tad, kind, hi, lo),
        _train(tfs, train, n), hist=hist)
    return jp, jenv, tp, tenv


@pytest.mark.parametrize("kind", ADMISSIONS)
@pytest.mark.parametrize("train", TRAINS)
@pytest.mark.parametrize("hist", [False, True])
def test_program_structure_matches_reference(kind, train, hist):
    jp, jenv, tp, tenv = _programs(kind, train, hist)
    assert tp.name == jp.name
    assert [(o.name, o.reads, o.writes) for o in tp.ops] == [
        (o.name, rename(o.reads), o.writes) for o in jp.ops]
    for f in ("state_out", "emit", "totals", "averages", "group_totals",
              "group_averages"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert [dataclasses.astuple(h) for h in tp.hists] == [
        dataclasses.astuple(h) for h in jp.hists]
    assert tp.input_names() == rename(jp.input_names())
    assert set(tenv) == set(rename(tuple(jenv)))
    want = {"agnostic": "agnostic", "battery": "battery_gated",
            "charge": "charge_gated"}[kind]
    assert dict(tp.params) == {"admission": want, "train": {
        None: "none", "always": "greedy"}.get(train, train)}


def _dyadic_inputs(n, seed=9):
    r = np.random.default_rng(seed)
    return dict(charge=r.integers(0, 9, n).astype(np.float32) * 0.25,
                harvest=r.integers(0, 5, n).astype(np.float32) * 0.25,
                requests=r.integers(0, 5, n).astype(np.float32),
                twant=(r.uniform(size=n) < 0.5).astype(np.float32),
                streak=r.integers(0, 70, n).astype(np.float32))


def _fill(jenv, tenv, inputs, n, admit=1.0, valid=None):
    valid = np.ones(n, np.float32) if valid is None else valid
    for k, v in dict(inputs, valid=valid).items():
        jenv[k] = jnp.asarray(v)
        tenv[k] = torch.tensor(v)
    jenv["admit"] = jnp.float32(admit)
    tenv["admit"] = torch.tensor(admit, dtype=torch.float32)


def _bitwise(got, want, label):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and np.array_equal(got, want), label


@pytest.mark.parametrize("kind", ADMISSIONS)
@pytest.mark.parametrize("train", TRAINS)
@pytest.mark.parametrize("hist", [False, True])
def test_plain_matches_jitted_run_step_lax_on_dyadic_config(kind, train,
                                                            hist):
    """Every buffer of the final env and every stat bitwise, with the
    admission scale 1.5 and one padding lane."""
    n = 21
    jp, jenv, tp, tenv = _programs(kind, train, hist, n)
    valid = (np.arange(n) < n - 1).astype(np.float32)
    _fill(jenv, tenv, _dyadic_inputs(n), n, admit=1.5, valid=valid)
    jout, jstats = jax.jit(lambda e: js.run_step_lax(jp, e,
                                                     valid=e["valid"]))(jenv)
    tout, tstats = ts.run_step(tp, tenv, valid=tenv["valid"])
    written = {w for op in jp.ops for w in op.writes}
    for k in written:
        _bitwise(tout[k].expand(n), jnp.broadcast_to(jout[k], (n,)), k)
    assert set(tstats) == set(jstats)
    for k in jstats:
        _bitwise(tstats[k], jstats[k], k)


@pytest.mark.parametrize("kind", ADMISSIONS)
@pytest.mark.parametrize("train", [None, "greedy", "sustainable"])
@pytest.mark.parametrize("n,tile", [(24, 8), (21, 8)])
def test_plain_matches_pallas_kernel_and_oracles(kind, train, n, tile):
    """The plain version vs ``fused_step`` on the serve program in
    interpret mode and both ``serve_step_reference`` oracles: charge, mode
    and every stat bitwise on the dyadic configuration."""
    jp, jenv, tp, tenv = _programs(kind, train, False, n)
    inputs = _dyadic_inputs(n)
    _fill(jenv, tenv, inputs, n)
    jstate, jemits, jstats = jfleet.fused_step(jp, jenv, n=n, emit=True,
                                               tile=tile, interpret=True)
    state, emits, stats = fs.fleet_step_plain(tp, tenv, n=n, emit=True)
    q = TQoS(*QOS)
    oracle = dict(
        capacity=CAP, leak=LEAK,
        full_req=float(q.request_cost(tc.DecodeCostModel(*DECODE))),
        short_req=float(q.request_cost(tc.DecodeCostModel(*DECODE),
                                       degraded=True)),
        full_tokens=QOS[1], short_tokens=QOS[2],
        hi=None if kind == "agnostic" else 1.0,
        lo=None if kind == "agnostic" else 0.25,
        charge_gated=kind == "charge",
        train_cost=None if train is None else 0.25,
        train_want=inputs["twant"] if train == "sustainable" else None)
    args = (inputs["charge"], inputs["harvest"], inputs["requests"],
            np.ones(n, np.float32))
    jc_, jm, jst = jref.serve_step_reference(*args, **oracle)
    tc_, tm, tst = ref.serve_step_reference(*args, **oracle)
    for got in (state["charge_out"], tc_):
        _bitwise(got, jstate["charge_out"], "charge")
        _bitwise(got, jc_, "charge vs oracle")
    for got in (emits["mode"], tm):
        _bitwise(got, jemits["mode"], "mode")
        _bitwise(got, jm, "mode vs oracle")
    assert set(stats) == set(jstats) == set(jst) == set(tst)
    for k in jst:
        _bitwise(stats[k], jstats[k], k)
        _bitwise(tst[k], jst[k], k)


def test_oracle_matches_plain_on_random_inputs():
    """The port's longhand oracle and the plain version make the same
    roundings: charge and mode bitwise on non-dyadic inputs."""
    r = np.random.default_rng(3)
    n = 5000
    decode = (2e-3, 2e-3, 5.12e-5)
    jp, jenv, tp, tenv = _programs("battery", "greedy", False, n, bat=(8.0,
                                   0.01), decode=decode, qos=(128.0, 256.0,
                                   32.0), hi=2.0, lo=1.5)
    inputs = dict(charge=r.uniform(0, 8, n).astype(np.float32),
                  harvest=r.exponential(1.5, n).astype(np.float32),
                  requests=r.integers(0, 7, n).astype(np.float32))
    _fill(jenv, tenv, inputs, n)
    state, emits, _ = fs.fleet_step_plain(tp, tenv, n=n, emit=True)
    full, short = ts.request_costs(tenv)
    c, m, _ = ref.serve_step_reference(
        inputs["charge"], inputs["harvest"], inputs["requests"],
        np.ones(n, np.float32), capacity=8.0, leak=0.01, full_req=full,
        short_req=short, full_tokens=256.0, short_tokens=32.0, hi=2.0,
        lo=1.5, train_cost=0.25)
    _bitwise(c, state["charge_out"].numpy(), "charge")
    _bitwise(m, emits["mode"].numpy(), "mode")


# ------------------------------------------------- the contraction sites --
def _train_costs(n):
    return (0.3 + 0.1 * (np.arange(n) % 3)).astype(np.float32)


def _scan_lanes(kind, train, n, inputs, bat, decode, qos, hi, lo):
    """The reference's jitted serving scan, one epoch, run once per client
    with a one-hot ``valid``: each stat is then that client's own value
    (0 * x adds nothing).  Returns (charge out, mode, {stat: (n,)})."""
    policy = _policy(jad, kind, jnp.asarray(hi), jnp.asarray(lo))
    train_ = _train(jfs, train, n, cost=jnp.asarray(_train_costs(n)))
    cost = jc.DecodeCostModel(*(jnp.asarray(x) for x in decode))
    q = JQoS(*(jnp.asarray(x) for x in qos))
    bat_ = jb.BatteryConfig(capacity=jnp.asarray(bat[0]),
                            leak=jnp.asarray(bat[1]), init_charge=0.0)
    per = {}
    for i in range(n):
        valid = jnp.asarray(np.eye(n, dtype=np.float32)[i])
        carry, stats = jfs._run_serve_scan(
            jtr.Constant(jnp.asarray(inputs["requests"])),
            jtr.Constant(jnp.asarray(inputs["harvest"])), bat_, cost, q,
            policy, train_, valid, jax.random.PRNGKey(0),
            jnp.asarray(inputs["charge"]), None, (), (), jnp.uint32(0),
            jnp.float32(1.0), jnp.int32(0), num_epochs=1, record_modes=True)
        for k, v in stats.items():
            if k != "mode":
                per.setdefault(k, []).append(np.asarray(v)[0])
    return (np.asarray(carry[0]), np.asarray(stats["mode"])[0],
            {k: np.asarray(v, np.float32) for k, v in per.items()})


def _port_lanes(kind, train, n, inputs, bat, decode, qos, hi, lo):
    policy = _policy(tad, kind, hi, lo)
    train_ = None
    if train is not None:
        train_ = tfs.TrainLoad.create(
            np.full(n, 4), _train_costs(n), policy=Policy(train),
            threshold=1.5)
    tp, tenv = ts.serve_step_program(
        tb.BatteryConfig(capacity=torch.tensor(bat[0]),
                         leak=torch.tensor(bat[1])),
        tc.DecodeCostModel(*(torch.tensor(x) for x in decode)),
        TQoS(*(torch.tensor(x) for x in qos)), policy, train_)
    _fill({}, tenv, inputs, n)
    out, _ = ts.run_step(tp, tenv, valid=tenv["valid"])
    return out


def _lane_case(seed, n, per_client_cost):
    r = np.random.default_rng(seed)
    pc = lambda lo, hi: r.uniform(lo, hi, n).astype(np.float32)
    f = lambda x: x if per_client_cost else np.float32(x[0])
    inputs = dict(charge=pc(0, 8), harvest=r.exponential(2.0, n)
                  .astype(np.float32),
                  requests=r.integers(0, 6, n).astype(np.float32))
    bat = (pc(4, 8), pc(0.001, 0.05))
    decode = (f(pc(1e-3, 3e-3)), f(pc(1e-3, 3e-3)), f(pc(1e-5, 1e-4)))
    qos = (f(np.round(pc(50, 200))), f(np.round(pc(100, 300))),
           f(np.round(pc(10, 40))))
    return inputs, bat, decode, qos, pc(0.5, 1.5), pc(0.5, 1.5)


def test_contraction_serve_drain_is_fused_in_the_reference_scan():
    """``available - served * per_req``: the reference's scan rounds it once
    (an FMA; the product is not exact), and the port's charge equals it on
    every client, where the twice-rounded drain differs on some."""
    n = 48
    inputs, bat, decode, qos, hi, lo = _lane_case(11, n, False)
    decode = (np.float32(2e-3), np.float32(2e-3), np.float32(5.12e-5))
    qos = (np.float32(128), np.float32(256), np.float32(32))  # exact prices
    args = ("battery", None, n, inputs, bat, decode, qos, hi, lo)
    jcharge, jmode, _ = _scan_lanes(*args)
    out = _port_lanes(*args)
    _bitwise(out["mode"], jmode, "mode")
    _bitwise(out["charge_out"], jcharge, "charge: the fused drain")
    twice = (out["available"] - out["consumed_serve"]).numpy()
    assert (twice != jcharge).any()


def test_contraction_total_spend_is_not_fused_in_the_reference_scan():
    """``consumed_serve + consumed_train`` (``consumed_serve = served *
    per_req``): the reference's scan adds the rounded product, and so does
    the port; a fused total differs on some clients."""
    n = 48
    inputs, bat, decode, qos, hi, lo = _lane_case(12, n, False)
    decode = (np.float32(2e-3), np.float32(2e-3), np.float32(5.12e-5))
    qos = (np.float32(128), np.float32(256), np.float32(32))
    args = ("agnostic", "greedy", n, inputs, bat, decode, qos, hi, lo)
    _, _, lanes = _scan_lanes(*args)
    out = _port_lanes(*args)
    _bitwise(out["consumed_total"], lanes["consumed"], "total spend")
    _bitwise(out["consumed_serve"], lanes["consumed_serve"], "serve spend")
    fused = tb.fma_f32(out["served"], out["per_req"], out["consumed_train"])
    assert (fused.numpy() != lanes["consumed"]).any()


def test_contraction_price_fuses_the_decode_term():
    """``prompt * jpp + tokens * jpd + upload`` with per-client costs and
    token budgets, battery-gated (both grades priced in one pass of the
    reference's scan): the reference computes ``fma(tokens, jpd, prompt *
    jpp) + upload``; the port's per-request price reproduces its serve
    spend ``served * per_req`` on every client, where the unfused price
    and the other fusion, ``fma(prompt, jpp, tokens * jpd)``, miss on
    some.  (Where the scan prices one grade alone, as under
    ``EnergyAgnostic``, XLA fuses the prompt term instead: ROADMAP.md
    Queue 3.)"""
    n = 48
    inputs, bat, decode, qos, hi, lo = _lane_case(13, n, True)
    args = ("battery", None, n, inputs, bat, decode, qos, hi, lo)
    jcharge, jmode, lanes = _scan_lanes(*args)
    out = _port_lanes(*args)
    _bitwise(out["mode"], jmode, "mode")
    _bitwise(out["consumed_serve"], lanes["consumed_serve"], "serve spend")
    _bitwise(out["charge_out"], jcharge, "charge")
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
    P, A, B, U = (f32(x) for x in (qos[0], decode[0], decode[1], decode[2]))
    toks = torch.where(out["mode"] == 2, f32(qos[1]), f32(qos[2]))
    served = out["served"]
    for other in (P * A + toks * B + U, tb.fma_f32(P, A, toks * B) + U):
        assert ((served * other).numpy() != lanes["consumed_serve"]).any()


# ------------------------------------------- the CUDA wrapper's checks --
@pytest.mark.parametrize("kind", ADMISSIONS)
@pytest.mark.parametrize("train", TRAINS)
@pytest.mark.parametrize("hist", [False, True])
def test_program_check_accepts_serve_programs_only(kind, train, hist):
    _, _, tp, _ = _programs(kind, train, hist)
    adm, tr, h = fs.serve_program_variant(tp)
    assert adm == {"agnostic": 0, "battery": 1, "charge": 2}[kind]
    assert tr == {None: 0, "sustainable": 1, "threshold": 2,
                  "greedy": 3, "always": 3}[train]
    assert h == hist
    for bad in (dataclasses.replace(tp, ops=tp.ops[:-1]),
                dataclasses.replace(tp, totals=tp.totals[::-1]),
                dataclasses.replace(tp, params=(("admission", "other"),
                                                tp.params[1]))):
        with pytest.raises(ValueError, match="serve_step_program"):
            fs.serve_program_variant(bad)


def test_wrapper_refuses_other_programs_groups_and_cpu_tensors():
    """A fleet program is not a serve program, a custom admission class has
    no kernel, groups are refused, and CPU tensors are refused before any
    build."""
    fleet, _ = ts.fleet_step_program(tb.BatteryConfig(), Policy.GREEDY)
    with pytest.raises(ValueError, match="serve_step_program"):
        fs.serve_program_variant(fleet)

    @dataclasses.dataclass(frozen=True, eq=False)
    class Custom(tad.ChargeGated):
        pass

    prog, env = ts.serve_step_program(
        tb.BatteryConfig(), tc.DecodeCostModel(1.0, 1.0), TQoS(),
        Custom(torch.ones(4), torch.ones(4)), None)
    assert dict(prog.params)["admission"] == "Custom"
    with pytest.raises(ValueError, match="serve_step_program"):
        fs.serve_program_variant(prog)
    _, _, tp, tenv = _programs("battery", None, False, 8)
    _fill({}, tenv, _dyadic_inputs(8), 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fs.serve_step_cuda(tp, tenv, n=8)
    with pytest.raises(ValueError, match="no group stats"):
        fs.fleet_step_cuda(tp, tenv, n=8, num_groups=2)


def test_cpu_dispatch_takes_the_plain_version():
    _, _, tp, tenv = _programs("charge", "threshold", True, 30)
    _fill({}, tenv, _dyadic_inputs(30), 30)
    before = (fs.fleet_step_cuda.launches, fs.serve_step_cuda.launches)
    got = ops.fleet_step(tp, tenv, n=30, emit=True)
    want = fs.fleet_step_plain(tp, tenv, n=30, emit=True)
    assert (fs.fleet_step_cuda.launches, fs.serve_step_cuda.launches) \
        == before
    _bitwise(got[0]["charge_out"], want[0]["charge_out"], "charge")
    _bitwise(got[0]["streak_out"], want[0]["streak_out"], "streak")
    _bitwise(got[1]["mode"], want[1]["mode"], "mode")


def test_stat_layout_and_kernel_bytes():
    _, _, tp, tenv = _programs("battery", "sustainable", True, 8)
    lay = fs.stat_layout(tp, None)
    idx = []
    for v in lay.values():
        idx += list(range(v.start, v.stop)) if isinstance(v, slice) else [v]
    assert sorted(idx) == list(range(15 + fs.NBINS))
    assert lay["frac_depleted"] == 14
    assert lay["hist_streak"] == slice(15 + 64, 15 + 128)
    n = 1000
    tenv = dict(tenv, **{k: torch.zeros(n) for k in
                         ("charge", "harvest", "requests", "valid", "twant",
                          "streak")})
    tenv["train_E"] = torch.ones(n, dtype=torch.int32)
    tenv["train_round_cost"] = torch.tensor(0.2).expand(n)
    tenv["admit"] = torch.tensor(1.0)
    # charge, harvest, requests, valid, twant, streak in; charge', streak'
    # out; train_E is listed among the reads but not read by any op
    stats = 15 + 1 + fs.NBINS
    assert fs.kernel_bytes(tp, tenv, n) == 4 * (8 * n + stats)
    assert fs.kernel_bytes(tp, tenv, n, emit=True) == 4 * (9 * n + stats)
    assert ts.bytes_moved(tp, tenv, n)["fused_bytes"] \
        == fs.kernel_bytes(tp, tenv, n) + 4 * n


def test_bytes_moved_equals_reference():
    n = 512
    jp, jenv, tp, tenv = _programs("battery", "sustainable", True, n)
    for k in ("charge", "harvest", "requests", "valid", "twant", "streak"):
        jenv[k] = jnp.zeros(n)
        tenv[k] = torch.zeros(n)
    jenv["pol0"] = jnp.ones(n)
    tenv["pol_hi"] = torch.ones(n)
    jenv["train1"] = jnp.full((n,), 0.25)        # a per-client cost
    tenv["train_round_cost"] = torch.full((n,), 0.25)
    for emit in (False, True):
        assert ts.bytes_moved(tp, tenv, n, emit=emit) == js.bytes_moved(
            jp, jenv, n, emit=emit)


# ------------------------------------------------ kernel model and faults --
def _block_sums(x, n, fold_fault=None, keep=None):
    """Column sums in csrc/serve_step.cu's order: block g of the persistent
    grid walks tiles g, g + grid, ...; thread tid adds clients tid, tid +
    256, ... (SERVE_CPT of them) of each tile in order, from +0; a warp
    shuffle tree, the 8 warps in order; then lane l of the fold adds rows
    l, l+32, ... and a shuffle tree.  ``fold_fault`` plants a fold that skips the last row or counts
    row 0 twice."""
    grid = fs.serve_grid(n)
    tiles = -(-n // fs.SERVE_TILE)
    steps = -(-tiles // grid)
    xp = np.zeros(steps * grid * fs.SERVE_TILE, np.float32)
    xp[:n] = np.where(keep, x, 0) if keep is not None else x
    t = xp.reshape(steps, grid, fs.SERVE_CPT, fs.SERVE_THREADS)
    acc = np.zeros((grid, fs.SERVE_THREADS), np.float32)
    for k in range(steps):
        for j in range(fs.SERVE_CPT):
            acc = (acc + t[k, :, j, :]).astype(np.float32)

    def tree(w):
        w = w.copy()
        for off in (16, 8, 4, 2, 1):
            w[..., :32 - off] = (w[..., :32 - off] + w[..., off:32]
                                 ).astype(np.float32)
        return w[..., 0]

    warps = fs.SERVE_THREADS // 32
    lanes = tree(acc.reshape(grid, warps, 32))
    rows = lanes[:, 0]
    for j in range(1, warps):
        rows = (rows + lanes[:, j]).astype(np.float32)
    if fold_fault == "skip_last_row":
        rows = rows[:-1]
    elif fold_fault == "double_row":
        rows = np.append(rows, rows[0])
    m = -(-len(rows) // 32)
    rp = np.zeros(m * 32, np.float32)
    rp[:len(rows)] = rows
    col = np.zeros(32, np.float32)
    for j in range(m):
        col = (col + rp[j * 32:(j + 1) * 32]).astype(np.float32)
    return tree(col[None])[0]


def _kernel_model(program, out, valid, n, fault=None):
    """The stats as csrc/serve_step.cu sums them, from the per-client
    buffers of a plain epoch; ``fault`` plants one the check must catch:
    the fold skipping the last row or counting a row twice, the last
    partial tile dropped, the missed requests summed from the shed
    buffer."""
    v = valid.numpy()
    keep = (np.arange(n) < (n // fs.SERVE_TILE) * fs.SERVE_TILE
            if fault == "drop_tail" else None)
    fold_fault = fault if fault in ("skip_last_row", "double_row") else None
    buf = lambda b: out[b].expand(n).numpy().astype(np.float32)
    if fault == "wrong_buffer":
        buf = lambda b, _b=buf: _b("shed" if b == "missed" else b)
    col = lambda x: _block_sums((v * x).astype(np.float32), n, fold_fault,
                                keep)
    stats = {s: col(buf(b)) for s, b in program.totals}
    den = max(col(np.ones(n, np.float32)), np.float32(1))
    stats.update({s: np.float32(col(buf(b)) / den)
                  for s, b in program.averages})
    for spec in program.hists:
        idx = hist_lib.bin_index(out[spec.buf], spec.lo, spec.hi,
                                 spec.bins).numpy()
        w = v.copy() if keep is None else v * keep
        stats[spec.name] = np.bincount(idx, weights=w, minlength=spec.bins
                                       ).astype(np.float32)
    return {k: torch.tensor(np.asarray(x)) for k, x in stats.items()}


@pytest.mark.parametrize("n", [3 * 4096 + 1000, 65537, 300_001])
@pytest.mark.parametrize("kind", ["battery", "charge"])
def test_kernel_tolerance_admits_rounding_and_rejects_faults(n, kind):
    """A model of the kernel's float32 summation order (the persistent
    walk, SERVE_CPT clients a thread a tile, the fixed-order fold) lies
    well inside
    ``kernel_tolerance`` of the float64 sums of the 15 serve stats; each
    planted fault breaks it by more than 10x, or breaks an exact count."""
    r = np.random.default_rng(n)
    tp, tenv = ts.serve_step_program(
        tb.BatteryConfig(capacity=8.0, leak=0.01),
        tc.DecodeCostModel.from_params(1e8), TQoS(),
        _policy(tad, kind, torch.tensor(1.5), torch.tensor(0.5)),
        tfs.TrainLoad.create(np.full(n, 4), 0.2, policy=Policy.SUSTAINABLE),
        hist=True)
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    tenv.update(charge=t(r.uniform(0, 8, n)), harvest=t(r.exponential(1.5, n)),
                requests=t(r.poisson(1.0, n)), twant=t(r.uniform(size=n) < .3),
                streak=t(r.integers(0, 70, n)), valid=t(np.arange(n) % 7 != 6),
                admit=torch.tensor(1.0))
    out, _ = ts.run_step(tp, tenv, valid=tenv["valid"])
    valid = tenv["valid"]
    exact = fs.stats_float64(tp, out, valid)
    tol = fs.kernel_tolerance(tp, out, valid, n)
    ratios = fs.stats_error(_kernel_model(tp, out, valid, n), exact, tol)
    assert max(ratios.values()) < 0.5, ratios
    faults = ["skip_last_row", "double_row", "wrong_buffer"]
    if n % fs.SERVE_TILE:
        faults.append("drop_tail")
    for fault in faults:
        bad = _kernel_model(tp, out, valid, n, fault=fault)
        ratios = fs.stats_error(bad, exact, tol)
        assert max(ratios.values()) > 10, (fault, ratios)
