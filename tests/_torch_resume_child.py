"""Children of ``tests/test_torch_resume.py`` (they import torch and the port
only).

* ``crash``: one controlled fleet or serving horizon with chunk-boundary
  checkpoints that, when told to, kills itself (SIGKILL or SIGTERM) right
  after its j-th save, first tearing the file it just wrote when asked
  (a kill in the middle of a write).  A run that completes writes its
  telemetry, final charge (and streak) and packed controller to ``--out``.
* a rank (``RANK WORLD INIT OUT_DIR``, as ``spawn_groups`` of
  ``tests/test_torch_fleet_sharded.py`` starts it): the fleet and serving
  runs under a gloo ``("data",)`` mesh for the first half of the horizon,
  checkpointing into ``OUT_DIR`` (rank 0 writes).

The scenarios are the reference's exact-arithmetic ones (zero leak, a
dyadic grid): every float32 partial sum is exact, so interrupted,
uninterrupted, sharded and host-local runs agree bitwise.  The builders
take the package to build from (the port's modules, or the reference's in
the test process).
"""
import argparse
import os
import pickle
import signal
import sys
from types import SimpleNamespace

import numpy as np

N, ROUNDS, EVERY = 21, 36, 6
SIGNALS = {"KILL": signal.SIGKILL, "TERM": signal.SIGTERM}


def port():
    """The port's names the scenarios use."""
    from repro_torch.core import Policy
    from repro_torch.energy import arrivals, battery, control, costs, fleet
    from repro_torch.serve import admission, fleet_serve, qos, traffic
    return SimpleNamespace(Policy=Policy, arrivals=arrivals, battery=battery,
                           control=control, costs=costs, fleet=fleet,
                           admission=admission, fleet_serve=fleet_serve,
                           qos=qos, traffic=traffic,
                           kw={"device": "cpu"})


def fleet_controller(lib, n=N):
    c = lib.control
    return c.ServerController(
        T0=5, E0=[1, 2, 4], groups=np.arange(n) % 3,
        bounds=c.ControlBounds(t_min=1, t_max=10, e_min=1, e_max=64),
        rules=(c.CadenceRule(), c.BudgetRule()))


def serve_controller(lib):
    c = lib.control
    return c.ServerController(
        T0=4, E0=4, admit0=1.0,
        rules=(c.AdmissionRule(), c.CadenceRule(), c.BudgetRule()))


def fleet_run(lib, rounds=ROUNDS, n=N, controller=None, **kw):
    """`run_controlled` of the exact-arithmetic fleet: (result,
    controller)."""
    proc = lib.arrivals.Bernoulli.create(n, prob=0.375, amount=1.25)
    bat = lib.battery.BatteryConfig(capacity=2.5, leak=0.0, init_charge=0.5)
    cfg = lib.fleet.FleetConfig(num_clients=n,
                                policy=lib.Policy.SUSTAINABLE,
                                threshold=1.5, seed=3)
    return lib.control.run_controlled(
        proc, bat, 0.75, cfg, rounds, controller or fleet_controller(lib, n),
        control_every=EVERY, **lib.kw, **kw)


def serve_run(lib, rounds=ROUNDS, n=N, controller=None, **kw):
    """`run_serve_controlled` of the exact-arithmetic serving fleet."""
    cost = lib.costs.DecodeCostModel(2.0 ** -8, 2.0 ** -9, 2.0 ** -6)
    qos = lib.qos.QoSSpec(prompt_tokens=64.0, full_decode_tokens=128.0,
                          short_decode_tokens=32.0)
    return lib.fleet_serve.run_serve_controlled(
        lib.traffic.Constant.create(n, rate=2.0),
        lib.arrivals.Bernoulli.create(n, prob=0.375, amount=1.25),
        lib.battery.BatteryConfig(capacity=2.5, leak=0.0, init_charge=0.5),
        cost, qos, lib.admission.BatteryGated.create(n),
        lib.fleet_serve.ServeConfig(num_clients=n, seed=5), rounds,
        controller or serve_controller(lib), train_cost=0.25,
        control_every=EVERY, **lib.kw, **kw)


RUNS = {"fleet": fleet_run, "serve": serve_run}


def digest(res, controller) -> dict:
    """Everything a kill-and-resume run must reproduce, as numpy."""
    from repro_torch.checkpoint import pack_controller

    out = {"stat_" + k: np.asarray(v) for k, v in res.stats.items()}
    out["final_charge"] = np.asarray(res.final_charge)
    if getattr(res, "final_streak", None) is not None:
        out["final_streak"] = np.asarray(res.final_streak)
    out.update({"ctl_" + k: v
                for k, v in pack_controller(controller).items()})
    return out


def killing_checkpointer(directory, kill_after, sig, corrupt):
    """A `RunCheckpointer` that kills its process after its
    ``kill_after``-th save, tearing the file it wrote first when
    ``corrupt`` is "truncate"."""
    from repro_torch.checkpoint import RunCheckpointer

    class Killing(RunCheckpointer):
        saves = 0

        def save(self, step, tree, metadata=None):
            path = super().save(step, tree, metadata)
            self.saves += 1
            if kill_after is not None and self.saves >= kill_after:
                if corrupt == "truncate":
                    with open(path, "r+b") as f:
                        f.truncate(max(1, os.path.getsize(path) // 2))
                sys.stdout.flush()
                os.kill(os.getpid(), sig)
            return path

    return Killing(directory)


def crash(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--kind", choices=sorted(RUNS), required=True)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--hist", action="store_true")
    p.add_argument("--kill-after-saves", type=int, default=None)
    p.add_argument("--signal", default="KILL", choices=sorted(SIGNALS))
    p.add_argument("--corrupt", default="none",
                   choices=["none", "truncate"])
    args = p.parse_args(argv)
    ck = killing_checkpointer(args.ckpt, args.kill_after_saves,
                              SIGNALS[args.signal], args.corrupt)
    res, ctl = RUNS[args.kind](port(), checkpoint=ck, resume=args.resume,
                               hist=args.hist)
    assert len(next(iter(res.stats.values()))) == ROUNDS
    if args.out:
        np.savez(args.out, **digest(res, ctl))
    print("resume child OK")


def rank(rank_: int, world: int, init: str, out_dir: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank_,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    lib = port()
    for kind, run in RUNS.items():
        for hist in (False, True):
            run(lib, rounds=ROUNDS // 2, mesh=mesh, hist=hist,
                checkpoint=os.path.join(out_dir, f"{kind}-{hist}"))
    with open(os.path.join(out_dir, f"rank{rank_}.pkl"), "wb") as f:
        pickle.dump({"rank": rank_}, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "crash":
        crash(sys.argv[2:])
    else:
        rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
