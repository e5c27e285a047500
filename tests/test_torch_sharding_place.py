"""The placement side of the port's sharding rules over two gloo ranks on
the CPU: ``placements`` / ``shard_tree`` / ``gather_tree`` /
``stacked_constrainer`` on ``torch.distributed.tensor``.

One group of two processes is spawned for every case: this file run as a
script is a rank (it imports torch and the port only).  Each rank computes
the slice that a spec names from its own coordinates (row-major in the
mesh's shape; a dim over several axes split major-to-minor in the
entry's order) and holds its local shard to it bitwise, including dims
sharded over ("data", "model") and ("pod", "data", "model"); the full
tensors gathered back equal the originals bitwise; a parallel round's
stacked state redistributed by ``stacked_constrainer`` holds the slices
of ``stacked_specs``; axes named out of mesh order are refused."""
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
DEADLINE = 180.0          # seconds for the spawned group to finish
COLLECTIVE_TIMEOUT = 60   # seconds a rank waits in a collective
MESHES = {                # name -> axis sizes (product WORLD)
    "data": {"data": 2, "model": 1},
    "model": {"data": 1, "model": 2},
    "pod": {"pod": 1, "data": 2, "model": 1},
    "pod_model": {"pod": 1, "data": 1, "model": 2},
}


def expected_slice(x, spec, sizes: dict, rank: int):
    """The block of ``x`` that ``rank`` holds under ``spec`` on a mesh of
    ``sizes`` (ranks row-major over the mesh's shape)."""
    names = list(sizes)
    coord = dict(zip(names, np.unravel_index(rank, tuple(sizes.values()))))
    out = x
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        parts, index = 1, 0
        for a in axes:                       # major to minor
            index = index * sizes[a] + int(coord[a])
            parts *= sizes[a]
        n = x.shape[d] // parts
        out = out.narrow(d, index * n, n)
    return out


def _tree(gen):
    """A small parameter tree with the rule names of the transformer."""
    r = lambda *s: torch.randn(*s, generator=gen)
    return {"embed": {"tok": r(12, 8)},
            "layers": {"attn": {"wq": r(2, 8, 8), "wo": r(2, 8, 8)},
                       "ln1": {"scale": r(2, 8)},
                       "mlp": {"wi": r(2, 8, 16)}}}


def child(rank: int, world: int, init: str, out_dir: str) -> None:
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.dist import sharding as sh
    from repro_torch.tree import tree_leaves, tree_map

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=init, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
    P = sh.P
    checked, failures = [], []

    def check(label, got, want):
        checked.append(label)
        if got.shape != want.shape or not torch.equal(got, want):
            failures.append(f"{label}: {tuple(got.shape)} vs "
                            f"{tuple(want.shape)}")

    gen = torch.Generator().manual_seed(0)        # the same on every rank
    x = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    for name, sizes in MESHES.items():
        mesh = init_device_mesh("cpu", tuple(sizes.values()),
                                mesh_dim_names=tuple(sizes))
        data = ("pod", "data") if "pod" in sizes else "data"
        specs = [P(None, None, None), P(data, None, None),
                 P(None, "model", None), P(None, None, "model"),
                 P(sh.data_axes(mesh) + ("model",), None, None),
                 P(data, None, "model")]
        for spec in specs:
            d = sh.shard_tree({"x": x}, {"x": spec}, mesh)["x"]
            check(f"{name} {spec}", d.to_local(),
                  expected_slice(x, spec, sizes, rank))
            back = sh.gather_tree({"x": d})["x"]
            check(f"{name} {spec} gathered", back, x)

        # the model's own rules on a DeviceMesh, tp and fsdp
        params = _tree(torch.Generator().manual_seed(1))
        for fsdp in (False, True):
            pspecs = sh.param_specs(params, mesh, fsdp=fsdp)
            dist_p = sh.shard_tree(params, pspecs, mesh)
            for p, spec, dt in zip(tree_leaves(params), tree_leaves(pspecs),
                                   tree_leaves(dist_p)):
                check(f"{name} params fsdp={fsdp} {spec}", dt.to_local(),
                      expected_slice(p, spec, sizes, rank))
            for p, g in zip(tree_leaves(params),
                            tree_leaves(sh.gather_tree(dist_p))):
                check(f"{name} params fsdp={fsdp} gathered", g, p)

        # a parallel round's stacked state: replicated in, the stacked
        # specs out; plain tensors pass through
        stacked = tree_map(lambda t: t.unsqueeze(0).expand(
            (2,) + tuple(t.shape)).clone(), _tree(gen))
        repl = tree_map(lambda s: P(), stacked)
        for model_axis, zero in (("model", None), (None, "model")):
            cst = sh.stacked_constrainer(mesh, model_axis=model_axis,
                                         zero_axis=zero)
            want = sh.stacked_specs(stacked, mesh, model_axis=model_axis,
                                    zero_axis=zero)
            out = cst(sh.shard_tree(stacked, repl, mesh))
            for t, spec, o in zip(tree_leaves(stacked), tree_leaves(want),
                                  tree_leaves(out)):
                assert isinstance(o, DTensor)
                check(f"{name} stacked {model_axis}/{zero} {spec}",
                      o.to_local(), expected_slice(t, spec, sizes, rank))
            plain = cst(stacked)
            for t, o in zip(tree_leaves(stacked), tree_leaves(plain)):
                checked.append("plain passes")
                if o is not t:
                    failures.append("stacked_constrainer moved a plain "
                                    "tensor")

    try:
        sh.placements(P(("model", "data"), None), init_device_mesh(
            "cpu", (2, 1), mesh_dim_names=("data", "model")))
        failures.append("axes out of mesh order were placed")
    except ValueError:
        checked.append("out of mesh order refused")
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump({"checked": checked, "failures": failures}, f)
    dist.destroy_process_group()


def test_placement_at_two_gloo_ranks(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = []
    for rank in range(WORLD):
        log = open(tmp_path / f"rank{rank}.log", "w")
        procs.append((log, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank),
             str(WORLD), init, str(tmp_path)],
            env=env, stdout=log, stderr=subprocess.STDOUT, cwd=REPO)))
    t0 = time.monotonic()
    try:
        for rank, (log, p) in enumerate(procs):
            try:
                p.wait(timeout=max(DEADLINE - (time.monotonic() - t0), 0.1))
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {rank} outlasted {DEADLINE} s")
            log.close()
            if p.returncode != 0:
                pytest.fail(f"rank {rank} exited {p.returncode}:\n"
                            + (tmp_path / f"rank{rank}.log").read_text()[-3000:])
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank in range(WORLD):
        with open(tmp_path / f"rank{rank}.pkl", "rb") as f:
            res = pickle.load(f)
        assert not res["failures"], res["failures"]
        assert len(res["checked"]) > 150


def test_expected_slice_is_major_to_minor():
    """The oracle itself, at a 2 x 2 layout: a dim over ("data", "model")
    gives rank (d, m) block 2 d + m."""
    x = torch.arange(8)
    sizes = {"data": 2, "model": 2}
    blocks = [expected_slice(x, (("data", "model"),), sizes, r).tolist()
              for r in range(4)]
    assert blocks == [[0, 1], [2, 3], [4, 5], [6, 7]]
    blocks = [expected_slice(x, ("model",), sizes, r).tolist()
              for r in range(4)]
    assert blocks == [[0, 1, 2, 3], [4, 5, 6, 7]] * 2


if __name__ == "__main__":
    child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
