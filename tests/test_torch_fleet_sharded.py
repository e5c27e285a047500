"""The sharded fleet on the CPU: ``simulate_fleet(mesh=)`` and
``run_controlled(mesh=)`` over gloo ranks (world sizes 2 and 3), against
the port's host-local runs and the JAX package's host-local
``simulate_fleet`` (whose own sharded tests cannot run under jax 0.9.0;
its host-local path is the one it promises equal to them).

Each world size is one group of processes, spawned once for every case:
this file run as a script is a rank (it imports torch and the port only),
writes its results, and the test process holds them against the
references it computes itself.  Cases mirror the reference's
``tests/_fleet_sharded_child.py``:

* parity: every fleet policy, N divisible by the ranks (24) and padded
  (23), on the reference's exact-arithmetic configuration: masks, charge
  and every stat bitwise;
* a leaky MarkovSolar fleet: masks and charge bitwise, stats to 1e-5;
* histograms (counts sum to N) and groups (G = 3), bitwise;
* ``run_controlled``: the knobs after every chunk equal the host-local
  run's on every rank;
* a replayed dyadic table (`TraceHarvest`) whose T equals a slab's width
  at two ranks or the padded fleet's width: the table is never padded or
  sharded, so every rank equals the reference's unpadded run bitwise;
* the collectives with ``group=`` and the refusals of a width that does
  not divide.

The slab draws (every arrival process and the SUSTAINABLE slot draw at
``first=``) are checked in this process: bit for bit the host-local draws
at the slab's global indices.
"""
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.core.scheduling import EnergyProfile, sustainable_schedule
from repro_torch.energy import arrivals as ta
from repro_torch.energy import battery as tb
from repro_torch.energy import control as tctl
from repro_torch.energy import fleet as tf
from repro_torch.energy.arrivals import map_clients, map_tensors
from repro_torch.energy.costs import DeviceCostModel
from repro_torch.traces import TraceHarvest, TraceTraffic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 3)
DEADLINE = 240.0          # seconds for every spawned group to finish
COLLECTIVE_TIMEOUT = 60   # seconds a rank waits in a collective
POLICIES = ("sustainable", "greedy", "threshold", "always")
NS = (24, 23)             # divisible by 2 and 3; padded to 24
ROUNDS = 12
DYADIC = dict(capacity=2.5, leak=0.0, init_charge=0.5)
# replayed tables of T slots: a slab's width at two ranks, and the padded
# width of 23 clients
TRACE_TS = (12, 24)


def parity_run(policy, n, mesh=None, **kw):
    """The reference's exact-arithmetic fleet (zero leak, dyadic packet,
    cost and threshold)."""
    cfg = tf.FleetConfig(num_clients=n, policy=policy, threshold=1.5,
                         seed=3)
    return tf.simulate_fleet(
        ta.Bernoulli.create(n, prob=0.375, amount=1.25),
        tb.BatteryConfig(**DYADIC), 0.75, cfg, ROUNDS,
        E=EnergyProfile(n).cycles(), record_masks=True, mesh=mesh,
        device="cpu", **kw)


def stochastic_run(n, mesh=None):
    cfg = tf.FleetConfig(num_clients=n, policy="threshold", threshold=1.2,
                         seed=1)
    return tf.simulate_fleet(
        ta.MarkovSolar.create(n, day_mean=0.8),
        tb.BatteryConfig(capacity=2.5, leak=0.03, init_charge=0.5), 1.0,
        cfg, ROUNDS, E=EnergyProfile(n).cycles(), record_masks=True,
        mesh=mesh, device="cpu")


def controlled_run(mesh=None):
    """Cadence and budget control of a grouped Bernoulli fleet, 24 rounds
    in chunks of 6."""
    n = 23
    ctrl = tctl.ServerController(
        T0=6, E0=[1, 5, 10, 20], groups=np.arange(n) % 4,
        rules=(tctl.CadenceRule(depleted_high=0.2),
               tctl.BudgetRule(depleted_high=0.2, slip=0.9)))
    cfg = tf.FleetConfig(num_clients=n, policy="sustainable", seed=2)
    res, ctrl = tctl.run_controlled(
        ta.Bernoulli.create(n, prob=0.35, amount=1.25),
        tb.BatteryConfig(capacity=2.5, init_charge=0.5),
        DeviceCostModel(0.125, 0.25), cfg, 24, ctrl, control_every=6,
        record_masks=True, hist=True, mesh=mesh, device="cpu")
    out = flat(res)
    out["knobs"] = np.asarray([(t["T"], t["E_mean"], t["admit"])
                               for t in ctrl.trace])
    return out


def trace_table(T: int) -> np.ndarray:
    """(T, 3) dyadic rates."""
    return (np.arange(3 * T).reshape(T, 3) % 7 * 0.25).astype(np.float32)


def trace_run(T, mesh=None):
    """The exact-arithmetic fleet on a replayed (T, 3) table, 23 clients."""
    n = 23
    cfg = tf.FleetConfig(num_clients=n, policy="threshold", threshold=1.5,
                         seed=3)
    return tf.simulate_fleet(
        TraceHarvest.create(trace_table(T), n, seed=4),
        tb.BatteryConfig(**DYADIC), 0.75, cfg, ROUNDS, record_masks=True,
        mesh=mesh, device="cpu")


def flat(res) -> dict:
    """A FleetResult as numpy arrays."""
    out = {f"stat/{k}": np.asarray(v) for k, v in res.stats.items()}
    out["final_charge"] = res.final_charge.numpy()
    for k in ("masks", "final_streak"):
        if getattr(res, k) is not None:
            out[k] = getattr(res, k).numpy()
    return out


def cases() -> dict:
    """{name: run(mesh) -> dict of arrays}: every sharded run a rank makes,
    and the host-local run it is held to (mesh=None)."""
    out = {}
    for pol in POLICIES:
        for n in NS:
            out[f"parity/{pol}/{n}"] = \
                lambda mesh, pol=pol, n=n: flat(parity_run(pol, n, mesh))
        out[f"groups/{pol}"] = lambda mesh, pol=pol: flat(parity_run(
            pol, 23, mesh, groups=np.arange(23) % 3, num_groups=3))
        out[f"hist/{pol}"] = lambda mesh, pol=pol: flat(parity_run(
            pol, 23, mesh, hist=True))
    for n in NS:
        out[f"stochastic/{n}"] = lambda mesh, n=n: flat(stochastic_run(n,
                                                                       mesh))
    out["pad_to"] = lambda mesh: flat(parity_run("threshold", 23, mesh,
                                                 pad_to=30))
    for T in TRACE_TS:
        out[f"trace/{T}"] = lambda mesh, T=T: flat(trace_run(T, mesh))
    out["controlled"] = controlled_run
    return out


def child(rank: int, world: int, init: str, out_dir: str) -> None:
    """One rank: every case under a ("data",) mesh, then the collectives
    and the refusals; results pickled to out_dir/rank{rank}.pkl."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import collectives, sharding
    from repro_torch.energy import step_ops
    from repro_torch.kernels import fleet_step as fs

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=init, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    res = {name: run(mesh) for name, run in cases().items()}

    # a 2-D mesh: the client axis over (pod, data) flattened, and over
    # "data" alone beside a "model" dim
    pod = init_device_mesh("cpu", (1, world), mesh_dim_names=("pod", "data"))
    res["pod/threshold/23"] = flat(parity_run("threshold", 23, pod))
    model = init_device_mesh("cpu", (world, 1),
                             mesh_dim_names=("data", "model"))
    res["model/threshold/23"] = flat(parity_run("threshold", 23, model))
    res["axes"] = (sharding.data_axes(pod), sharding.data_axes(model),
                   sharding.mesh_axis_size(pod, ("pod", "data")),
                   sharding.slab(6 * world, mesh))

    # the collectives over the ranks: each rank holds values of its own
    g = sharding.data_group(mesh)
    v = torch.arange(5, dtype=torch.float32) + 0.25 * rank
    w = torch.tensor([1.0, 0.0, 1.0, 1.0, float(rank % 2)])
    res["collectives"] = {
        "total": collectives.masked_total(v, w, g).item(),
        "average": collectives.masked_average(v, w, g).item(),
        "psum": collectives.tree_psum(
            {"a": v, "b": [torch.full((2,), rank, dtype=torch.bfloat16)]},
            g),
    }

    # refusals: a width that does not divide the ranks, as n or as pad_to
    refused = []
    program, env = step_ops.fleet_step_program(tb.BatteryConfig(),
                                               "greedy")
    try:
        fs.fused_step_sharded(program, env, n=world * 4 + 1, mesh=mesh)
    except ValueError as e:
        refused.append(str(e))
    try:
        tf.simulate_fleet(ta.Bernoulli.create(5), tb.BatteryConfig(), 1.0,
                          tf.FleetConfig(num_clients=5), 1, mesh=mesh,
                          pad_to=world * 3 + 1, device="cpu")
    except ValueError as e:
        refused.append(str(e))
    res["refused"] = refused
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


def spawn_groups(path: str, worlds, base_dir) -> dict:
    """{world: [each rank's results]}: one group of processes a world size,
    all started together, each running ``path`` as a script; fails the
    caller if a rank fails or the groups outlast DEADLINE."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs = []
    for world in worlds:
        d = base_dir / f"world{world}"
        d.mkdir()
        init = f"file://{d / 'rendezvous'}"
        for rank in range(world):
            log = open(d / f"rank{rank}.log", "w")
            procs.append((world, rank, d, log, subprocess.Popen(
                [sys.executable, path, str(rank), str(world), init, str(d)],
                env=env, stdout=log, stderr=subprocess.STDOUT, cwd=REPO)))
    t0 = time.monotonic()
    try:
        for world, rank, d, log, p in procs:
            left = DEADLINE - (time.monotonic() - t0)
            try:
                p.wait(timeout=max(left, 0.1))
            except subprocess.TimeoutExpired:
                pytest.fail(f"world {world}: the spawned group outlasted its "
                            f"{DEADLINE:.0f} s deadline")
            log.close()
            if p.returncode != 0:
                pytest.fail(f"world {world} rank {rank} exited "
                            f"{p.returncode}:\n"
                            + (d / f"rank{rank}.log").read_text()[-4000:])
    finally:
        for *_, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = {}
    for world, rank, d, _, _ in procs:
        with open(d / f"rank{rank}.pkl", "rb") as f:
            out.setdefault(world, []).append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    return spawn_groups(os.path.abspath(__file__), WORLDS,
                        tmp_path_factory.mktemp("fleet_sharded"))


@pytest.fixture(scope="module")
def host():
    return {name: run(None) for name, run in cases().items()}


def _same(got: dict, want: dict, label):
    assert set(got) == set(want), label
    for k in want:
        np.testing.assert_array_equal(got[k], want[k],
                                      err_msg=f"{label} {k}")


def _reference(policy, n):
    """The JAX package's host-local run of `parity_run`."""
    from repro.core import EnergyProfile as JProfile
    from repro.energy import arrivals as ja
    from repro.energy import battery as jb
    from repro.energy import fleet as jf

    cfg = jf.FleetConfig(num_clients=n, policy=policy, threshold=1.5, seed=3)
    res = jf.simulate_fleet(ja.Bernoulli.create(n, prob=0.375, amount=1.25),
                            jb.BatteryConfig(**DYADIC), 0.75, cfg, ROUNDS,
                            E=np.asarray(JProfile(n).cycles()),
                            record_masks=True)
    out = {f"stat/{k}": np.asarray(v) for k, v in res.stats.items()}
    out["final_charge"] = np.asarray(res.final_charge)
    out["masks"] = np.asarray(res.masks)
    return out


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("world", WORLDS)
def test_parity_bitwise_against_host_local_and_reference(sharded, host,
                                                         world, policy, n):
    name = f"parity/{policy}/{n}"
    want = host[name]
    _same(_reference(policy, n), want, f"{name} port vs reference")
    for rank, res in enumerate(sharded[world]):
        _same(res[name], want, f"world {world} rank {rank} {name}")


@pytest.mark.parametrize("kind", ["groups", "hist"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("world", WORLDS)
def test_groups_and_histograms_bitwise(sharded, host, world, policy, kind):
    name = f"{kind}/{policy}"
    for rank, res in enumerate(sharded[world]):
        _same(res[name], host[name], f"world {world} rank {rank} {name}")
        if kind == "hist":
            for k in ("hist_soc", "hist_spend", "hist_streak"):
                sums = res[name][f"stat/{k}"].sum(axis=-1)
                assert np.array_equal(sums, np.full_like(sums, 23)), k
        else:
            assert res[name]["stat/group_participants"].shape == (ROUNDS, 3)


@pytest.mark.parametrize("T", TRACE_TS)
@pytest.mark.parametrize("world", WORLDS)
def test_trace_table_is_never_padded_or_sharded(sharded, host, world, T):
    """A table whose T equals a slab's or the padded fleet's width stays
    whole on every rank: the reference's unpadded host-local run, bitwise
    (the reference's own padding takes such a table for a client axis)."""
    from repro.energy import battery as jb
    from repro.energy import fleet as jf
    from repro.traces import TraceHarvest as JTraceHarvest

    name = f"trace/{T}"
    cfg = jf.FleetConfig(num_clients=23, policy="threshold", threshold=1.5,
                         seed=3)
    ref = jf.simulate_fleet(JTraceHarvest.create(trace_table(T), 23, seed=4),
                            jb.BatteryConfig(**DYADIC), 0.75, cfg, ROUNDS,
                            record_masks=True)
    want = {f"stat/{k}": np.asarray(v) for k, v in ref.stats.items()}
    want["final_charge"] = np.asarray(ref.final_charge)
    want["masks"] = np.asarray(ref.masks)
    _same(host[name], want, f"{name} port vs reference")
    for rank, res in enumerate(sharded[world]):
        _same(res[name], want, f"world {world} rank {rank} {name}")


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("world", WORLDS)
def test_stochastic_fleet(sharded, host, world, n):
    """Leaky battery, Markov solar: the per-client state is elementwise, so
    masks and charge are bitwise; stats sum in another order (1e-5)."""
    name, want = f"stochastic/{n}", host[f"stochastic/{n}"]
    for res in sharded[world]:
        got = res[name]
        for k in ("masks", "final_charge"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("name", ["pad_to", "pod/threshold/23",
                                  "model/threshold/23"])
@pytest.mark.parametrize("world", WORLDS)
def test_padding_and_two_dimensional_meshes(sharded, host, world, name):
    want = host["pad_to"] if name == "pad_to" else \
        host["parity/threshold/23"]
    for res in sharded[world]:
        _same(res[name], want, f"world {world} {name}")


@pytest.mark.parametrize("world", WORLDS)
def test_run_controlled_takes_the_same_decisions_on_every_rank(
        sharded, host, world):
    want = host["controlled"]
    assert len(set(want["knobs"][:, 0])) > 1        # the cadence moved
    for rank, res in enumerate(sharded[world]):
        got = res["controlled"]
        np.testing.assert_array_equal(got["knobs"], want["knobs"],
                                      err_msg=f"rank {rank} knobs")
        for k in ("masks", "final_charge", "final_streak"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_collectives_and_refusals_over_ranks(sharded, world):
    ranks = range(world)
    v = [np.arange(5, dtype=np.float32) + np.float32(0.25 * r) for r in ranks]
    w = [np.array([1, 0, 1, 1, r % 2], np.float32) for r in ranks]
    total = sum(float((a * b).sum()) for a, b in zip(v, w))
    den = sum(float(b.sum()) for b in w)
    for rank, res in enumerate(sharded[world]):
        c = res["collectives"]
        assert c["total"] == pytest.approx(total, rel=1e-6)
        assert c["average"] == pytest.approx(total / den, rel=1e-6)
        np.testing.assert_allclose(c["psum"]["a"].numpy(), sum(v), rtol=1e-6)
        assert c["psum"]["b"][0].dtype == torch.bfloat16
        assert c["psum"]["b"][0].float().tolist() == [sum(ranks)] * 2
        assert res["axes"] == (("pod", "data"), ("data",), world,
                               (6 * rank, 6))
        assert len(res["refused"]) == 2
        assert "data-axis product" in res["refused"][0]
        assert "multiple of the data-axis product" in res["refused"][1]


def run_launcher(module: str, *args, ranks: int = 1) -> str:
    """The launcher's standard output, run alone or under ``torchrun``
    (``python -m torch.distributed.run``) with ``ranks`` processes."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    head = [sys.executable]
    if ranks > 1:
        head += ["-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", str(ranks)]
    out = subprocess.run(head + ["-m", module, *args], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=DEADLINE)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_fleet_launcher_under_torchrun_prints_the_one_process_numbers():
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.fleet`` shards
    the client axis over two gloo ranks; rank 0 alone prints, and the
    policy table (all but the clock columns) and the closed loop are the
    one-process run's."""
    args = ("--device", "cpu", "--clients", "2000", "--rounds", "10")
    one = run_launcher("repro_torch.launch.fleet", *args)
    two = run_launcher("repro_torch.launch.fleet", *args, ranks=2)
    assert "sharding the client axis over 2 ranks" in two
    assert two.count("fleet: N=2,000 clients") == 1

    def table(text):
        rows = [ln.split() for ln in text.splitlines()]
        return ([r[:6] + r[8:] for r in rows if r and r[0] in POLICIES],
                [ln for ln in text.splitlines() if "participants=" in ln])

    got, want = table(two), table(one)
    assert len(got[0]) == 3 and len(got[1]) == 4
    assert got == want


# ------------------------------------------------------- slab draws -------
N_DRAW, FIRST, N_SLAB = 37, 11, 13


def _slab(tree):
    return map_clients(tree, lambda x: x[FIRST:FIRST + N_SLAB]
                       if x.dim() and x.shape[0] == N_DRAW else x)


def _processes():
    n = N_DRAW
    rs = np.random.RandomState(0)
    gain = rs.uniform(0.5, 2.0, n).astype(np.float32)
    return {
        "bernoulli": ta.Bernoulli.create(n, prob=0.4, amount=1.25),
        "compound_poisson": ta.CompoundPoisson.create(n, rate=0.7,
                                                      mean_amount=0.3),
        "markov_solar": ta.MarkovSolar.create(n, day_mean=0.9),
        "renewal": ta.DeterministicRenewal.create(np.arange(n) % 4 + 1,
                                                  phase=np.arange(n) % 3),
        "sum_scaled": ta.Sum((ta.Scaled.create(
            ta.MarkovSolar.create(n, p_stay_day=0.92, p_stay_night=0.92,
                                  day_mean=0.9), gain=gain),
            ta.CompoundPoisson.create(n, rate=0.1, mean_amount=0.3))),
        # tables of T = N_DRAW slots: never sliced with the clients
        "trace_harvest": TraceHarvest.create(
            rs.uniform(0, 2, (n, 3)).astype(np.float32), n, seed=1,
            gain_jitter=0.3),
        "trace_traffic": TraceTraffic.create(
            rs.uniform(0, 3, (n, 2)).astype(np.float32), n, seed=2,
            gain_jitter=0.3),
    }


@pytest.mark.parametrize("name", sorted(_processes()))
def test_slab_draws_equal_the_host_local_draws_there(name):
    proc = _processes()[name]
    part = _slab(proc)
    state, pstate = proc.init(), part.init()
    for t in range(4):
        key = prng.fold_in(prng.PRNGKey(5), t)
        h, state = proc.sample(key, t, state)
        hp, pstate = part.sample(key, t, pstate, first=FIRST)
        np.testing.assert_array_equal(
            hp.numpy(), h[FIRST:FIRST + N_SLAB].numpy(), err_msg=str(t))
        for a, b in zip(_leaves(pstate), _leaves(_slab(state)),
                        strict=True):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def _leaves(tree):
    out = []
    map_tensors(tree, lambda x: out.append(x) or x)
    return out


@pytest.mark.parametrize("phase", [False, True])
def test_slab_slot_draw_equals_the_host_local_draw_there(phase):
    E = torch.arange(N_DRAW, dtype=torch.int32) % 5 + 1
    ph = torch.arange(N_DRAW, dtype=torch.int32) % 7 if phase else None
    for r in range(6):
        whole = sustainable_schedule(4, r, E, ph)
        part = sustainable_schedule(4, r, E[FIRST:FIRST + N_SLAB],
                                    None if ph is None
                                    else ph[FIRST:FIRST + N_SLAB],
                                    first=FIRST)
        np.testing.assert_array_equal(
            part.numpy(), whole[FIRST:FIRST + N_SLAB].numpy())


def test_client_draws_by_global_index():
    key = prng.PRNGKey(9)
    for fn, extra in ((ta.client_uniform, ()), (ta.client_randint, (6,)),
                      (ta.client_exponential, ((3,),))):
        whole = fn(key, N_DRAW, *extra)
        part = fn(key, N_SLAB, *extra, first=FIRST)
        np.testing.assert_array_equal(part.numpy(),
                                      whole[FIRST:FIRST + N_SLAB].numpy())


@pytest.mark.parametrize("n", [1, 4097, 1_000_001])
def test_reduction_depths_take_the_number_of_ranks(n):
    """One more sum over ``world`` ranks' rows adds at most world - 1
    levels to the depth of a slab of ceil(n / world) clients; one rank is
    the host-local depth."""
    from repro_torch.kernels import fleet_step as fs

    for depth in (fs.reduction_depth, fs.serve_reduction_depth):
        assert depth(n, world=1) == depth(n)
        for world in (2, 3, 8):
            assert depth(n, world=world) == depth(-(-n // world)) + world - 1


def test_kernel_tolerance_widens_with_the_ranks():
    from repro_torch.energy import step_ops
    from repro_torch.kernels import fleet_step as fs

    n = 5000
    r = np.random.default_rng(0)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    prog, env = step_ops.fleet_step_program(
        tb.BatteryConfig(capacity=2.5, leak=0.02), "threshold", 3, hist=True)
    env.update(charge=t(r.uniform(0, 3, n)), harvest=t(r.exponential(0.7, n)),
               streak=t(r.integers(0, 70, n)), valid=t(np.arange(n) % 7 != 6),
               round_cost=t(1.0), threshold=t(1.5),
               groups=torch.tensor(r.integers(0, 3, n), dtype=torch.int32))
    out, _ = step_ops.run_step(prog, env, valid=env["valid"],
                               groups=env["groups"], num_groups=3)
    one, two = (fs.kernel_tolerance(prog, out, env["valid"], n,
                                    env["groups"], 3, world=w)
                for w in (1, 2))
    assert set(one) == set(two)
    for k in one:
        assert bool((two[k] >= one[k]).all()), k
        assert bool((two[k] > one[k]).any()) == (not k.startswith("hist_"))


def test_a_mesh_must_be_a_device_mesh():
    from repro_torch.dist import sharding

    with pytest.raises(ValueError, match="DeviceMesh"):
        sharding.data_axes(object())
    with pytest.raises(ValueError, match="DeviceMesh"):
        tf.padded_width(8, object())
    assert tf.padded_width(8) == 8
    assert tf.padded_width(8, pad_to=11) == 11
    with pytest.raises(ValueError, match="below the fleet width"):
        tf.padded_width(8, pad_to=7)


if __name__ == "__main__":
    child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
