"""The sharded serving fleet on the CPU: ``simulate_serve(mesh=)`` and
``run_serve_controlled(mesh=)`` over gloo ranks (world sizes 2 and 3),
against the port's host-local runs and the JAX package's host-local
``simulate_serve`` (whose own sharded tests cannot run under jax 0.9.0).

As in ``test_torch_fleet_sharded.py`` (whose `spawn_groups` this file
uses), each world size is one group of processes running this file as a
script.  Cases mirror the reference's ``tests/_serve_sharded_child.py``:

* parity: every admission rule with a sustainable training load, N
  divisible (24) and padded (23), and every training gate under battery
  gating, on the reference's exact-arithmetic configuration (Constant
  traffic, Bernoulli harvest, zero leak, dyadic per-token joules): modes,
  charge and the whole ledger bitwise;
* DiurnalPoisson traffic on a leaky MarkovSolar fleet: modes and charge
  bitwise, stats to 1e-5;
* histograms (counts sum to N), bitwise;
* ``run_serve_controlled``: the admission scale after every day equal to
  the host-local run's on every rank.

The traffic processes' slab draws are checked in this process.
"""
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.energy import arrivals as ta
from repro_torch.energy import battery as tb
from repro_torch.energy import control as tctl
from repro_torch.energy.arrivals import map_tensors
from repro_torch.energy.costs import DecodeCostModel
from repro_torch.serve import admission as tad
from repro_torch.serve import fleet_serve as tfs
from repro_torch.serve import traffic as ttr
from repro_torch.serve.qos import QoSSpec

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_fleet_sharded import (COLLECTIVE_TIMEOUT, WORLDS,  # noqa: E402
                                      run_launcher, spawn_groups)

ADMISSIONS = ("agnostic", "battery_gated", "charge_gated")
TRAINS = (None, "threshold", "greedy", "always")
NS = (24, 23)
EPOCHS = 12
DYADIC = dict(capacity=2.5, leak=0.0, init_charge=0.5)
COST = (2.0 ** -8, 2.0 ** -9, 2.0 ** -6)
QOS = (64.0, 128.0, 32.0)


def admission(kind, n):
    return {"agnostic": lambda: tad.EnergyAgnostic(),
            "battery_gated": lambda: tad.BatteryGated.create(n, hi=1.0,
                                                             lo=1.0),
            "charge_gated": lambda: tad.ChargeGated.create(n, hi=1.0,
                                                           lo=0.25)}[kind]()


def parity_run(kind, n, mesh=None, train="sustainable", **kw):
    """The reference's exact-arithmetic serving fleet."""
    load = None if train is None else tfs.TrainLoad.create(
        np.full(n, 4), 0.25, policy=train, threshold=1.5)
    return tfs.simulate_serve(
        ttr.Constant.create(n, rate=2.0),
        ta.Bernoulli.create(n, prob=0.375, amount=1.25),
        tb.BatteryConfig(**DYADIC), DecodeCostModel(*COST), QoSSpec(*QOS),
        admission(kind, n), tfs.ServeConfig(num_clients=n, seed=3), EPOCHS,
        train=load, record_modes=True, mesh=mesh, device="cpu", **kw)


def stochastic_run(n, mesh=None):
    return tfs.simulate_serve(
        ttr.DiurnalPoisson.create(n, base=1.5, swing=0.9,
                                  phase=np.arange(n) % 24),
        ta.MarkovSolar.create(n, day_mean=0.8),
        tb.BatteryConfig(capacity=2.5, leak=0.03, init_charge=0.5),
        DecodeCostModel(1e-3, 2e-3, 5e-2), QoSSpec(*QOS),
        tad.BatteryGated.create(n, hi=1.2, lo=1.0),
        tfs.ServeConfig(num_clients=n, seed=1), EPOCHS, record_modes=True,
        mesh=mesh, device="cpu")


def controlled_run(mesh=None):
    """The admission rule over a drought-prone diurnal fleet, 40 epochs in
    days of 8, with a training load under cadence control."""
    n = 23
    ctrl = tctl.ServerController(
        T0=5, E0=2, rules=(tctl.AdmissionRule(),
                           tctl.CadenceRule(depleted_high=0.2)))
    res, ctrl = tfs.run_serve_controlled(
        ttr.DiurnalPoisson.create(n, base=1.5, swing=0.8),
        ta.MarkovSolar.create(n, day_mean=0.7),
        tb.BatteryConfig(capacity=2.5, leak=0.02, init_charge=0.4),
        DecodeCostModel(1e-3, 2e-3, 5e-2), QoSSpec(*QOS),
        tad.BatteryGated.create(n, hi=1.2, lo=1.0),
        tfs.ServeConfig(num_clients=n, seed=11), 40, ctrl, train_cost=0.2,
        control_every=8, record_modes=True, hist=True, mesh=mesh,
        device="cpu")
    out = flat(res)
    out["knobs"] = np.asarray([(t["T"], t["E_mean"], t["admit"])
                               for t in ctrl.trace])
    return out


def flat(res) -> dict:
    """A ServeResult as numpy arrays."""
    out = {f"stat/{k}": np.asarray(v) for k, v in res.stats.items()}
    out["final_charge"] = res.final_charge.numpy()
    for k in ("modes", "final_streak"):
        if getattr(res, k) is not None:
            out[k] = getattr(res, k).numpy()
    return out


def cases() -> dict:
    """{name: run(mesh) -> dict of arrays}: every sharded run a rank makes,
    and the host-local run it is held to (mesh=None)."""
    out = {}
    for kind in ADMISSIONS:
        for n in NS:
            out[f"parity/{kind}/{n}"] = \
                lambda mesh, kind=kind, n=n: flat(parity_run(kind, n, mesh))
        out[f"hist/{kind}"] = lambda mesh, kind=kind: flat(parity_run(
            kind, 23, mesh, hist=True))
    for train in TRAINS:
        out[f"train/{train}"] = lambda mesh, train=train: flat(parity_run(
            "battery_gated", 23, mesh, train=train))
    for n in NS:
        out[f"stochastic/{n}"] = lambda mesh, n=n: flat(stochastic_run(n,
                                                                       mesh))
    out["pad_to"] = lambda mesh: flat(parity_run("charge_gated", 23, mesh,
                                                 pad_to=30))
    out["controlled"] = controlled_run
    return out


def child(rank: int, world: int, init: str, out_dir: str) -> None:
    """One rank: every case under a ("data",) mesh; results pickled to
    out_dir/rank{rank}.pkl."""
    import datetime
    import pickle

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=init, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    res = {name: run(mesh) for name, run in cases().items()}
    model = init_device_mesh("cpu", (world, 1),
                             mesh_dim_names=("data", "model"))
    res["model/battery_gated/23"] = flat(parity_run("battery_gated", 23,
                                                    model))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    return spawn_groups(os.path.abspath(__file__), WORLDS,
                        tmp_path_factory.mktemp("serve_sharded"))


@pytest.fixture(scope="module")
def host():
    return {name: run(None) for name, run in cases().items()}


def _same(got: dict, want: dict, label):
    assert set(got) == set(want), label
    for k in want:
        np.testing.assert_array_equal(got[k], want[k],
                                      err_msg=f"{label} {k}")


def _reference(kind, n):
    """The JAX package's host-local run of `parity_run`."""
    from repro.energy import arrivals as ja
    from repro.energy import battery as jb
    from repro.energy import costs as jc
    from repro.serve import admission as jad
    from repro.serve import fleet_serve as jfs
    from repro.serve import traffic as jtr
    from repro.serve.qos import QoSSpec as JQoS

    pol = {"agnostic": lambda: jad.EnergyAgnostic(),
           "battery_gated": lambda: jad.BatteryGated.create(n, hi=1.0,
                                                            lo=1.0),
           "charge_gated": lambda: jad.ChargeGated.create(n, hi=1.0,
                                                          lo=0.25)}[kind]()
    res = jfs.simulate_serve(
        jtr.Constant.create(n, rate=2.0),
        ja.Bernoulli.create(n, prob=0.375, amount=1.25),
        jb.BatteryConfig(**DYADIC), jc.DecodeCostModel(*COST), JQoS(*QOS),
        pol, jfs.ServeConfig(num_clients=n, seed=3), EPOCHS,
        train=jfs.TrainLoad.create(np.full(n, 4), 0.25, threshold=1.5),
        record_modes=True)
    out = {f"stat/{k}": np.asarray(v) for k, v in res.stats.items()}
    out["final_charge"] = np.asarray(res.final_charge)
    out["modes"] = np.asarray(res.modes)
    return out


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("kind", ADMISSIONS)
@pytest.mark.parametrize("world", WORLDS)
def test_parity_bitwise_against_host_local_and_reference(sharded, host,
                                                         world, kind, n):
    name = f"parity/{kind}/{n}"
    want = host[name]
    _same(_reference(kind, n), want, f"{name} port vs reference")
    for rank, res in enumerate(sharded[world]):
        _same(res[name], want, f"world {world} rank {rank} {name}")


@pytest.mark.parametrize("name", [f"train/{t}" for t in TRAINS]
                         + [f"hist/{k}" for k in ADMISSIONS]
                         + ["pad_to", "model/battery_gated/23"])
@pytest.mark.parametrize("world", WORLDS)
def test_training_gates_histograms_and_padding_bitwise(sharded, host, world,
                                                       name):
    want = (host["parity/battery_gated/23"] if name.startswith("model/")
            else host[name])
    for rank, res in enumerate(sharded[world]):
        _same(res[name], want, f"world {world} rank {rank} {name}")
        if name.startswith("hist/"):
            for k in ("hist_soc", "hist_spend", "hist_streak"):
                sums = res[name][f"stat/{k}"].sum(axis=-1)
                assert np.array_equal(sums, np.full_like(sums, 23)), k


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("world", WORLDS)
def test_stochastic_fleet(sharded, host, world, n):
    """Diurnal Poisson traffic, Markov solar, a leaky battery: the
    per-client state is elementwise, so modes and charge are bitwise;
    stats sum in another order (1e-5)."""
    name, want = f"stochastic/{n}", host[f"stochastic/{n}"]
    assert (want["modes"] == 0).any() and (want["modes"] == 2).any()
    for res in sharded[world]:
        got = res[name]
        for k in ("modes", "final_charge"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_run_serve_controlled_takes_the_same_decisions_on_every_rank(
        sharded, host, world):
    want = host["controlled"]
    assert len(set(want["knobs"][:, 2])) > 1        # the admission moved
    for rank, res in enumerate(sharded[world]):
        got = res["controlled"]
        np.testing.assert_array_equal(got["knobs"], want["knobs"],
                                      err_msg=f"rank {rank} knobs")
        for k in ("modes", "final_charge", "final_streak"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=k)


def test_serve_launcher_under_torchrun_prints_the_one_process_numbers():
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.serve_fleet``:
    rank 0 alone prints, and the table and the controller's trajectory
    are the one-process run's."""
    args = ("--device", "cpu", "--clients", "2000", "--epochs", "24")
    one = run_launcher("repro_torch.launch.serve_fleet", *args)
    two = run_launcher("repro_torch.launch.serve_fleet", *args, ranks=2)
    assert "sharding the client axis over 2 ranks" in two
    assert two.count("fleet: N=2,000, 24 epochs") == 1

    def table(text):
        lines = text.splitlines()
        start = next(i for i, ln in enumerate(lines) if "served%" in ln)
        stop = next(i for i, ln in enumerate(lines) if "epochs/s" in ln)
        return lines[start:stop] + [ln for ln in lines
                                    if ln.startswith("unanswered")]

    assert len(table(one)) >= 9
    assert table(two) == table(one)


# ------------------------------------------------------- slab draws -------
N_DRAW, FIRST, N_SLAB = 37, 11, 13


def _slab(tree):
    return map_tensors(tree, lambda x: x[FIRST:FIRST + N_SLAB]
                       if x.dim() and x.shape[0] == N_DRAW else x)


def _traffic():
    n = N_DRAW
    return {
        "diurnal": ttr.DiurnalPoisson.create(n, base=1.5, swing=0.9,
                                             phase=np.arange(n) % 24),
        "mmpp": ttr.MMPP.create(n, calm_rate=0.5, burst_rate=4.0),
        "constant": ttr.Constant.create(n, rate=np.arange(n) % 5),
    }


@pytest.mark.parametrize("name", sorted(_traffic()))
def test_slab_traffic_equals_the_host_local_traffic_there(name):
    proc = _traffic()[name]
    part = _slab(proc)
    state, pstate = proc.init(), part.init()
    for t in range(5):
        key = prng.fold_in(prng.PRNGKey(7), t)
        r, state = proc.sample(key, t, state)
        rp, pstate = part.sample(key, t, pstate, first=FIRST)
        np.testing.assert_array_equal(
            rp.numpy(), r[FIRST:FIRST + N_SLAB].numpy(), err_msg=str(t))
        if isinstance(state, torch.Tensor):
            np.testing.assert_array_equal(
                pstate.numpy(), state[FIRST:FIRST + N_SLAB].numpy())


if __name__ == "__main__":
    child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
