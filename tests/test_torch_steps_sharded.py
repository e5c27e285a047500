"""Step bundles executed across two gloo ranks on the CPU
(``repro_torch.launch.steps.execute``): the port's counterpart of the
reference's ``jax.jit(fn, in_shardings, out_shardings)``.

One group of two processes a mesh is spawned for the whole file, the
groups together (this file run as a script is a rank; it imports torch
and the port only, one thread a rank).  On two meshes, ``data`` = {data 2, model 1} and ``model`` =
{data 1, model 2}, each rank executes, on the fp32 smoke configs with the
JAX package's ``init_params`` carried across by ``repro_torch.convert`` and
at ``test_torch_steps``' shapes:

* granite-3-2b's and mamba2-1.3b's prefill bundles (flash_attention and
  ssd_scan, plain on the CPU, through their sharding rules);
* granite-3-2b's decode bundle (the cache written shard by shard);
* granite-3-2b's parallel train bundle (C = 2 on ``data``, a client group
  a rank and the aggregation split over them; C = 1 on ``model``);
* its sequential train bundle (FSDP specs).

Rank 0 returns the gathered outputs, and this process holds them against
the port's host-local run of the same bundle and against the JAX package
(as ``test_torch_steps`` does).  Forward steps split only over ``data`` are
bitwise, except the decode step: its projections are CPU matrix products
of one row a rank against two host-local (``aten.mm`` takes another
summation order at M = 1), held to ``SERVE_TOL``; forward steps split over
``model`` are held to ``SERVE_TOL``, the train steps to the reference's
own "schedule, never the math" tolerances (``tests/test_steps_integration
.py``: loss rtol 1e-5, params rtol = atol = 2e-4).

The ranks run the port's ``aten.squeeze.dims`` rule in place of
DTensor's own (``kernels.ops.squeeze_dims_placements``: torch 2.11, the
card's, has none).  They also record: the local shapes each kernel's
plain version was called with (a rank's shard), each rule's placements,
that a placement no rule lists is redistributed to one that does, Adam's
chunked update on a ``Shard(0)`` leaf against its full tensor, the
aggregation across ranks within ``aggregation.sharded_tolerance``
(float32 and bfloat16 leaves) with both ranks holding the same model, and
the five collectives of ``dist.collectives`` over the two ranks
(``tests/test_torch_collectives.py`` holds them with ``group=None``).
"""
import dataclasses
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
DEADLINE = 300.0          # seconds for the spawned group to finish
COLLECTIVE_TIMEOUT = 120  # seconds a rank waits in a collective
MESHES = {"data": {"data": 2, "model": 1},
          "model": {"data": 1, "model": 2}}
CASES = ("prefill-granite", "prefill-mamba2", "decode-granite",
         "train-parallel", "train-sequential")
ARCH = {"prefill-granite": "granite-3-2b", "prefill-mamba2": "mamba2-1.3b",
        "decode-granite": "granite-3-2b", "train-parallel": "granite-3-2b",
        "train-sequential": "granite-3-2b"}
T = 2                      # local steps, as test_torch_steps
SEQ_LEN = {"prefill": 32, "decode": 16, "train": 16}
BATCH = 2                  # prefill / decode rows
TRAIN_BATCH = 4
SERVE_TOL = dict(rtol=2e-5, atol=2e-5)
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------- both sides ----
def tcfg_of(case):
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config(ARCH[case])
    if case == "train-sequential":
        cfg = dataclasses.replace(cfg, fed_mode="sequential")
    return cfg


def shape_of(case):
    from repro_torch.configs.base import InputShape

    kind = case.split("-")[0]
    batch = TRAIN_BATCH if kind == "train" else BATCH
    return InputShape(f"tiny_{kind}", SEQ_LEN[kind], batch, kind)


def build(case, mesh):
    """The case's bundle for ``mesh`` (a DeviceMesh, a SpecMesh of the
    same layout for the host-local run, or None)."""
    from repro_torch.launch import steps

    return steps.build_step(tcfg_of(case), shape_of(case), mesh,
                            device="cpu", local_steps=T)


def case_args(case, bundle, params):
    """Real arguments of ``bundle``, drawn with numpy from a seed: the same
    in every process."""
    from repro_torch.tree import tree_map

    cfg = tcfg_of(case)
    r = np.random.default_rng(CASES.index(case) + 1)
    tok = lambda *s: torch.tensor(r.integers(0, cfg.vocab_size, s)
                                  .astype(np.int32))
    kind = case.split("-")[0]
    if kind == "prefill":
        return (params, {"tokens": tok(BATCH, SEQ_LEN["prefill"])})
    if kind == "decode":
        cache = tree_map(lambda x: torch.tensor(
            (0.5 * r.standard_normal(tuple(x.shape))).astype(np.float32)),
            bundle.args[2])
        return (params, tok(BATCH), cache, bundle.args[3])
    if case == "train-parallel":
        C = bundle.meta["client_groups"]
        batch = {"tokens": tok(C, T, TRAIN_BATCH // C, SEQ_LEN["train"])}
        return (params, batch) + tuple(bundle.args[2:])
    acc = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32),
                   params)
    batch = {"tokens": tok(T, TRAIN_BATCH, SEQ_LEN["train"])}
    return (params, acc, batch) + tuple(bundle.args[3:])


def pl_name(p) -> str:
    """``"S<dim>"`` for a Shard, ``"R"`` for Replicate, else its repr."""
    from torch.distributed.tensor import Replicate, Shard

    if isinstance(p, Shard):
        return f"S{p.dim}"
    return "R" if isinstance(p, Replicate) else repr(p)


def to_numpy(tree):
    from repro_torch.tree import tree_map

    return tree_map(lambda x: x.detach().numpy() if isinstance(
        x, torch.Tensor) else x, tree)


# -------------------------------------------------------------- a rank ----
def _tap(calls):
    """Record the local shapes the kernels' plain versions are called
    with: ops.py reaches them through their modules."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_agg as agg
    from repro_torch.kernels import ssd_scan as ssd

    for mod, name, key in ((fa, "flash_attention_plain", "flash"),
                           (ssd, "ssd_scan_plain", "ssd"),
                           (agg, "fused_agg_plain", "agg")):
        orig = getattr(mod, name)

        def wrap(*a, _orig=orig, _key=key, **k):
            calls.append((_key, tuple(a[1].shape if _key == "agg"
                                      else a[0].shape)))
            return _orig(*a, **k)

        setattr(mod, name, wrap)


def _rules(mesh, res):
    """Each rule's placements and the local shapes the plain versions see,
    against the plain call on the full tensors; a placement no rule lists
    (the sequence split) comes back at one a rule lists."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd

    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 64, 4, 64, generator=g)
    k, v = (torch.randn(2, 64, 2, 64, generator=g) for _ in range(2))
    want = fa.flash_attention_plain(q, k, v, causal=True)
    R = Replicate()
    for d in (0, 1, 2, None):
        pl = [R, Shard(d) if d is not None else R]
        dq, dk, dv = (distribute_tensor(t, mesh, pl, src_data_rank=None)
                      for t in (q, k, v))
        out = ops.flash_attention(dq, dk, dv, causal=True)
        res[("flash", d)] = (pl_name(out.placements[1]),
                             tuple(out.to_local().shape),
                             bool(torch.equal(out.full_tensor(), want)))
    B, S, H, P, N = 2, 32, 4, 8, 8
    for G in (1, 2):
        x = torch.randn(B, S, H, P, generator=g)
        dt = torch.rand(B, S, H, generator=g)
        A = -torch.rand(H, generator=g)
        Bm, Cm = (torch.randn(B, S, G, N, generator=g) for _ in range(2))
        yw, hw = ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=16)
        for d in (0, 1, 2):
            pl = lambda dim: [R, Shard(dim)]
            xs = distribute_tensor(x, mesh, pl(d), src_data_rank=None)
            dts = distribute_tensor(dt, mesh, pl(d), src_data_rank=None)
            As = distribute_tensor(A, mesh, pl(0) if d == 2 else [R, R],
                                   src_data_rank=None)
            Bs, Cs = (distribute_tensor(t, mesh, pl(d) if d != 2 or G > 1
                                        else [R, R], src_data_rank=None)
                      for t in (Bm, Cm))
            y, h = ops.ssd_scan(xs, dts, As, Bs, Cs, chunk=16)
            res[("ssd", G, d)] = (pl_name(y.placements[1]), pl_name(h.placements[1]),
                                  tuple(y.to_local().shape),
                                  bool(torch.equal(y.full_tensor(), yw)
                                       and torch.equal(h.full_tensor(), hw)))
    w, st = torch.randn(10, generator=g), torch.randn(2, 10, generator=g)
    s = torch.tensor([0.3, 0.5])
    dw, dst, ds = (distribute_tensor(t, mesh, [R, Shard(0)],
                                     src_data_rank=None) for t in (w, st, s))
    out = ops.fused_agg(dw, dst, ds)
    res[("agg",)] = (pl_name(out.placements[1]), bool(torch.equal(
        out.full_tensor(), ops.fused_agg(w, st, s))))
    tree = ops.fused_agg_tree({"a": dw, "b": dst}, {"a": dst.redistribute(
        mesh, [R, R]), "b": distribute_tensor(torch.randn(2, 2, 10,
                                                          generator=g),
                                              mesh, [R, Shard(1)],
                                              src_data_rank=None)}, ds)
    res[("agg_tree",)] = tuple(pl_name(t.placements[1]) for t in tree.values())


def _chunked(mesh, res):
    """Adam's update in chunks on a Shard(0) leaf, chunked on each rank's
    local tensor, against the full tensor's (one pass and chunked)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.optim import adam, optimizers

    g = torch.Generator().manual_seed(3)
    p, gr = torch.randn(8, 6, generator=g), torch.randn(8, 6, generator=g)
    opt = adam(1e-2)
    st = opt.init(p)
    want, _ = opt.update(gr, st, p, 0)
    keep = optimizers._CHUNK
    optimizers._CHUNK = 12                    # chunks of 2 rows
    try:
        chunked, _ = opt.update(gr, st, p, 0)
        dp, dg = (distribute_tensor(t, mesh, [Replicate(), Shard(0)],
                                    src_data_rank=None) for t in (p, gr))
        got, gst = opt.update(dg, opt.init(dp), dp, 0)
    finally:
        optimizers._CHUNK = keep
    res["chunked"] = (pl_name(got.placements[1]),
                      pl_name(gst["m"].placements[1]),
                      bool(torch.equal(got.full_tensor(), want)),
                      bool(torch.equal(chunked, want)))


def _aggregate(mesh, res):
    """`aggregate` on stacks split over the data axis: float32 and
    bfloat16 leaves, C = 4 clients, 2 a rank."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.core import aggregation

    g = torch.Generator().manual_seed(4)
    w = {"f": torch.randn(3, 40, generator=g),
         "h": torch.randn(33, generator=g).to(torch.bfloat16)}
    st = {k: (v.float()[None] + 0.1 * torch.randn((4,) + v.shape,
                                                  generator=g)).to(v.dtype)
          for k, v in w.items()}
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0])
    p, E = torch.full((4,), 0.25), torch.tensor([1.0, 3.0, 2.0, 1.0])
    want = aggregation.aggregate(w, st, mask, p, E)
    # over data: the client rows; over model: the last feature dim
    split = lambda v: ([Shard(0), Replicate()] if mesh.size(0) > 1 else
                       [Replicate(), Shard(v.dim() - 1)])
    dw = {k: distribute_tensor(v, mesh, [Replicate(), Replicate()],
                               src_data_rank=None) for k, v in w.items()}
    dst = {k: distribute_tensor(v, mesh, split(v), src_data_rank=None)
           for k, v in st.items()}
    got = aggregation.aggregate(dw, dst, mask, p, E)
    res["aggregate"] = {
        "inputs": to_numpy({"w": {k: v.float() for k, v in w.items()},
                            "st": {k: v.float() for k, v in st.items()},
                            "s": mask * p * E}),
        "want": {k: v.float().numpy() for k, v in want.items()},
        "got": {k: v.to_local().float().numpy() for k, v in got.items()},
        "dtypes": {k: str(v.dtype) for k, v in got.items()}}


def _collectives(res, rank):
    """The five collectives over the two ranks: each rank holds two of the
    four client rows of `collective_inputs`."""
    import torch.distributed as dist

    from repro_torch.dist import collectives as col

    x = collective_inputs()
    rows = slice(2 * rank, 2 * rank + 2)
    take = lambda a: torch.tensor(a[rows])
    g = dist.group.WORLD
    tree = {"a": take(x["tree"]["a"]), "b": take(x["tree"]["b"])}
    res["collectives"] = to_numpy({
        "tree_pmean": col.tree_pmean(tree, g),
        "weighted_client_sum": col.weighted_client_sum(
            tree, take(x["coeff"]), g),
        "cross_client_delta": col.cross_client_delta(
            tree, {k: torch.tensor(v) for k, v in x["w_global"].items()},
            take(x["coeff"]), g),
        "participation_count": col.participation_count(take(x["alpha"]), g),
        "masked_mean": col.masked_mean(take(x["loss"]), take(x["alpha"]),
                                       g)})


def collective_inputs():
    """Four client rows (seeded numpy): a tree with a bf16-representable
    float32 leaf and a float32 one, weights, alpha bits and losses."""
    r = np.random.default_rng(7)
    return {"tree": {"a": r.standard_normal((4, 3, 5)).astype(np.float32),
                     "b": r.standard_normal((4, 7)).astype(np.float32)},
            "w_global": {"a": r.standard_normal((3, 5)).astype(np.float32),
                         "b": r.standard_normal(7).astype(np.float32)},
            "coeff": np.abs(r.standard_normal(4)).astype(np.float32),
            "alpha": np.array([1.0, 0.0, 1.0, 1.0], np.float32),
            "loss": r.standard_normal(4).astype(np.float32)}


def child(rank: int, world: int, init: str, out_dir: str,
          name: str) -> None:
    """A rank of the group for mesh ``name``: its cases, then, on
    ``data``, the collectives, on ``model``, the rules and the chunked
    update, and on each the aggregation; writes its results."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.convert import params_from_numpy
    from repro_torch.dist import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.launch import steps

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=init, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
    # the port's aten.squeeze.dims rule in place of DTensor's own (which
    # torch 2.11 lacks, and the train steps' gradients reach)
    ops.register_sharding_rules()
    ops._register_rule(torch.ops.aten.squeeze.dims,
                       ops.squeeze_dims_placements, static_argnum=1)
    path, t0 = os.path.join(out_dir, "params.pkl"), time.monotonic()
    while not os.path.exists(path):       # written as the ranks start
        if time.monotonic() - t0 > DEADLINE:
            raise TimeoutError("no params.pkl")
        time.sleep(0.1)
    with open(path, "rb") as f:
        params = {a: params_from_numpy(p, device="cpu")
                  for a, p in pickle.load(f).items()}
    calls, res = [], {"cases": {}, "seconds": {}}
    _tap(calls)
    sizes = MESHES[name]
    mesh = init_device_mesh("cpu", tuple(sizes.values()),
                            mesh_dim_names=tuple(sizes))
    for case in CASES:
        t0 = time.perf_counter()
        b = build(case, mesh)
        args = case_args(case, b, params[ARCH[case]])
        del calls[:]
        out = sh.gather_tree(steps.execute(b, args, mesh))
        res["cases"][(case, name)] = {"out": to_numpy(out),
                                      "kernels": list(calls),
                                      "meta": dict(b.meta)}
        res["seconds"][(case, name)] = time.perf_counter() - t0
    if name == "model":
        _rules(mesh, res.setdefault("rules", {}))
        _chunked(mesh, res)
    else:
        _collectives(res, rank)
    _aggregate(mesh, res.setdefault("aggregates", {}).setdefault(name, {}))
    with open(os.path.join(out_dir, f"rank{rank}_{name}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


# ------------------------------------------------------- this process ----
def jax_reference(case, b, args, jparams):
    """The JAX package's result for the same inputs: the serving bundle
    jitted on ``make_local_mesh()``; the host-local ``parallel_round``
    with the same C, or ``sequential_client_step`` (its own train
    bundles raise under jax 0.9.0)."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from repro import core as jcore
    from repro.configs import get_smoke_config as jax_smoke
    from repro.launch import mesh as jmesh
    from repro.launch import steps as jsteps
    from repro.models import get_model as jax_model

    jcfg = jax_smoke(ARCH[case])
    jp = jparams[ARCH[case]]
    if not case.startswith("train"):
        m = jmesh.make_local_mesh()
        with m:
            jb = jsteps.build_step(jcfg, shape_of(case), m)
            jargs = [jp] + [jax.tree.map(lambda x: jnp.asarray(
                np.asarray(x)), a) for a in args[1:]]
            if case.startswith("decode"):
                jargs[3] = jnp.int32(int(args[3]))
            out = jax.jit(jb.fn, in_shardings=jb.in_shardings,
                          out_shardings=jb.out_shardings)(*jargs)
        return jax.tree.map(np.asarray, tuple(out))
    if case == "train-sequential":
        jcfg = dataclasses.replace(jcfg, fed_mode="sequential")
    jm = jax_model(jcfg)
    loss_fn = lambda p, x, k: jm.loss_fn(p, x)
    opt = jsteps.make_optimizer_for(jcfg)
    if case == "train-parallel":
        C = b.meta["client_groups"]
        fed = jcore.FedConfig(num_clients=C, local_steps=T,
                              micro_batches=jcfg.micro_batches)
        out = jax.jit(partial(jcore.parallel_round, loss_fn, opt, fed))(
            jp, {"tokens": jnp.asarray(args[1]["tokens"].numpy())},
            jnp.full((C,), 1.0 / C), jnp.ones((C,), jnp.int32),
            jnp.int32(0), jax.random.PRNGKey(0))
    else:
        fed = jcore.FedConfig(num_clients=1, local_steps=T,
                              mode="sequential",
                              micro_batches=jcfg.micro_batches)
        one = jnp.float32(1.0)
        out = jax.jit(partial(
            jcore.sequential_client_step, loss_fn, opt, fed))(
            jp, jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), jp),
            {"tokens": jnp.asarray(args[2]["tokens"].numpy())}, one, one,
            one, jax.random.PRNGKey(0), jnp.int32(0))
    return jax.tree.map(np.asarray, out)


def references(jparams, tparams):
    """{(case, mesh): (bundle meta, the port's host-local output, the JAX
    package's)}; each computed once a layout that changes it (the
    parallel round's C), shared otherwise."""
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import SpecMesh

    refs, done = {}, {}
    for case in CASES:
        for name in MESHES:
            b = build(case, SpecMesh(MESHES[name]))
            key = (case, b.meta.get("client_groups"))
            if key not in done:
                args = case_args(case, b, tparams[ARCH[case]])
                want = to_numpy(steps.execute(b, args))
                done[key] = (want, jax_reference(
                    case, b, case_args(case, b, tparams[ARCH[case]]),
                    jparams))
            refs[(case, name)] = (dict(b.meta),) + done[key]
    return refs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the two ranks once and compute the references while they
    run; returns (rank 0's results, rank 1's, the references, the
    port's params by arch)."""
    import jax

    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import get_model as jax_model

    tmp = tmp_path_factory.mktemp("steps_sharded")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs = []                         # a group of WORLD ranks a mesh
    for name in MESHES:
        init = f"file://{tmp / f'rendezvous_{name}'}"
        for rank in range(WORLD):
            log = open(tmp / f"rank{rank}_{name}.log", "w")
            procs.append((f"{rank}_{name}", log, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(rank),
                 str(WORLD), init, str(tmp), name],
                env=env, stdout=log, stderr=subprocess.STDOUT, cwd=REPO)))
    t0 = time.monotonic()
    try:
        # the params as the ranks start (they wait for the file)
        jparams = {a: jax_model(jax_smoke(a)).init_params(
            jax.random.PRNGKey(0)) for a in sorted(set(ARCH.values()))}
        with open(tmp / "params.tmp", "wb") as f:
            pickle.dump({a: jax.tree.map(np.asarray, p)
                         for a, p in jparams.items()}, f)
        os.replace(tmp / "params.tmp", tmp / "params.pkl")
        tparams = {a: _torch_params(jparams, a) for a in jparams}
        refs = references(jparams, tparams)
        for which, log, p in procs:
            try:
                p.wait(timeout=max(DEADLINE - (time.monotonic() - t0), 0.1))
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {which} outlasted {DEADLINE} s")
            log.close()
            if p.returncode != 0:
                pytest.fail(f"rank {which} exited {p.returncode}:\n"
                            + (tmp / f"rank{which}.log").read_text()[-4000:])
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for rank in range(WORLD):
        merged = {"cases": {}, "seconds": {}, "aggregates": {}}
        for name in MESHES:
            with open(tmp / f"rank{rank}_{name}.pkl", "rb") as f:
                res = pickle.load(f)
            for key in ("cases", "seconds", "aggregates"):
                merged[key].update(res.pop(key))
            merged.update(res)
        out.append(merged)
    return out[0], out[1], refs, tparams


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{pre}/{i}"))
        return out
    return {pre: np.asarray(tree.detach().float() if isinstance(
        tree, torch.Tensor) else tree, dtype=np.float32)}


def _torch_params(jparams, arch):
    import jax

    from repro_torch.convert import params_from_numpy

    return params_from_numpy(jax.tree.map(np.asarray, jparams[arch]),
                             device="cpu")


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("case", CASES)
def test_sharded_step_matches_host_local(run, case, mesh_name):
    rank0, rank1, refs, _ = run
    got = rank0["cases"][(case, mesh_name)]
    meta, want, _ = refs[(case, mesh_name)]
    assert got["meta"] == meta
    g, w = _flat(got["out"]), _flat(want)
    assert set(g) == set(w)
    kind = case.split("-")[0]
    if kind == "train":
        # the loss, then the params (parallel) or the delta accumulator
        loss = "/1/loss" if case == "train-parallel" else "/1"
        np.testing.assert_allclose(g[loss], w[loss], rtol=LOSS_RTOL)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **PARAM_TOL)
        # every rank ends with the same result
        g1 = _flat(rank1["cases"][(case, mesh_name)]["out"])
        for k in g:
            np.testing.assert_array_equal(g[k], g1[k], err_msg=k)
    elif mesh_name == "data" and kind == "prefill":
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    else:
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **SERVE_TOL)


# the local shapes each kernel's plain version saw (two layers a step)
KERNEL_SHAPES = {
    ("prefill-granite", "data"): [("flash", (1, 32, 4, 64))] * 2,
    ("prefill-granite", "model"): [("flash", (2, 32, 2, 64))] * 2,
    ("prefill-mamba2", "data"): [("ssd", (1, 32, 8, 32))] * 2,
    ("prefill-mamba2", "model"): [("ssd", (2, 32, 4, 32))] * 2,
}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("case", CASES)
def test_kernels_run_on_each_ranks_shard(run, case, mesh_name):
    """flash_attention and ssd_scan on a rank's batch rows or heads; the
    aggregation on a rank's client rows (C = 2 on ``data``: one a rank;
    its leaves (1, ...)); the decode and sequential steps reach none."""
    rank0, rank1, _, _ = run
    for res in (rank0, rank1):
        calls = res["cases"][(case, mesh_name)]["kernels"]
        if case == "train-parallel":
            assert calls and all(k == "agg" for k, _ in calls)
            assert {s[0] for _, s in calls} == {1}
        else:
            assert calls == KERNEL_SHAPES.get((case, mesh_name), [])


def test_flash_rules(run):
    rules = run[0]["rules"]
    assert rules[("flash", 2)] == ("S2", (2, 64, 2, 64), True)
    assert rules[("flash", 0)] == ("S0", (1, 64, 4, 64), True)
    assert rules[("flash", None)] == ("S2", (2, 64, 2, 64), True)
    # the sequence split is no rule's: redistributed to one that is
    assert rules[("flash", 1)][0] in ("S0", "S2")
    assert rules[("flash", 1)][2]


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_rules(run, G):
    rules = run[0]["rules"]
    assert rules[("ssd", G, 2)] == ("S2", "S1",
                                    (2, 32, 2, 8), True)
    assert rules[("ssd", G, 0)] == ("S0", "S0",
                                    (1, 32, 4, 8), True)
    assert rules[("ssd", G, 1)][3]            # the sequence: redistributed
    assert rules[("ssd", G, 1)][0] != "S1"


def test_fused_agg_rules_replicate(run):
    rules = run[0]["rules"]
    assert rules[("agg",)] == ("R", True)
    assert rules[("agg_tree",)] == ("R", "R")


def test_rule_functions_list_the_stated_placements():
    """The rules as functions: the head split only where H and K (or G)
    split evenly over the mesh; fused_agg replicated only."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.kernels import ops

    class Spec:
        def __init__(self, shape, size):
            self.shape = shape
            self.mesh = type("M", (), {"size": lambda self: size})()

    q, k = Spec((1, 8, 32, 64), 2), Spec((1, 8, 8, 64), 2)
    outs = [r[0] for r in ops.flash_placements(q, k, k, True, 0)]
    assert outs == [[Replicate()], [Shard(2)], [Shard(0)]]
    k3 = Spec((1, 8, 3, 64), 2)
    outs = [r[0] for r in ops.flash_placements(q, k3, k3, True, 0)]
    assert outs == [[Replicate()], [Shard(0)]]
    x, one = Spec((1, 8, 64, 64), 2), Spec((1, 8, 1, 128), 2)
    heads = ops.ssd_placements(x, None, None, one, one, 16)[1]
    assert heads[1][3:5] == [Replicate(), Replicate()]
    three = Spec((1, 8, 3, 128), 2)
    assert len(ops.ssd_placements(x, None, None, three, three, 16)) == 2
    assert ops.agg_placements(None, None, None) == [
        ([Replicate()], [Replicate()] * 3)]
    # squeeze.dims of (4, 1, 6, 1) at dims [1, 3]: dims 0 and 2 may split
    # (renumbered 0 and 1); a named dim of size > 1 never splits
    sq = Spec((4, 1, 6, 1), 2)
    splits = [(r[1][0], r[0][0]) for r in ops.squeeze_dims_placements(
        sq, [1, -1]) if isinstance(r[0][0], Shard)]
    assert splits == [(Shard(0), Shard(0)), (Shard(2), Shard(1))]
    splits = [r[1][0] for r in ops.squeeze_dims_placements(sq, [0, 1])
              if isinstance(r[0][0], Shard)]
    assert splits == [Shard(2), Shard(3)]


def test_chunked_update_on_a_shard0_leaf(run):
    placement, m_placement, equal, chunked_equal = run[0]["chunked"]
    assert placement == m_placement == "S0"
    assert equal and chunked_equal


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_aggregate_across_ranks_within_bound(run, mesh_name):
    """The aggregation over client rows split across ranks; on ``model``
    the data axis has one rank and the stacks are split over their last
    feature dim: no client sum crosses ranks, each rank's kernel takes its
    columns, and the result is bitwise."""
    from repro_torch.core.aggregation import sharded_tolerance

    a0 = run[0]["aggregates"][mesh_name]["aggregate"]
    a1 = run[1]["aggregates"][mesh_name]["aggregate"]
    x = a0["inputs"]
    for k, want in a0["want"].items():
        got = a0["got"][k]
        np.testing.assert_array_equal(got, a1["got"][k])   # one model
        if mesh_name == "model":
            np.testing.assert_array_equal(got, want)
            continue
        dtype = getattr(torch, a0["dtypes"][k].split(".")[1])
        tol = sharded_tolerance(
            torch.tensor(x["w"][k]).to(dtype),
            torch.tensor(x["st"][k]).to(dtype), torch.tensor(x["s"]),
            WORLD, torch.tensor(want).to(dtype)).numpy()
        assert (np.abs(got - want) <= tol).all(), k


def test_sharded_tolerance_catches_a_lost_rank():
    """The bound is tight enough that one rank's rows left out of the sum
    fails it."""
    from repro_torch.core import aggregation
    from repro_torch.core.aggregation import sharded_tolerance

    g = torch.Generator().manual_seed(5)
    for dtype in (torch.float32, torch.bfloat16):
        w = torch.randn(64, generator=g).to(dtype)
        st = (w.float() + 0.1 * torch.randn(4, 64, generator=g)).to(dtype)
        s = torch.full((4,), 0.25)
        want = aggregation.aggregate({"w": w}, {"w": st}, torch.ones(4), s,
                                     torch.ones(4))["w"]
        lost = aggregation.aggregate({"w": w}, {"w": st[:2]}, torch.ones(2),
                                     s[:2], torch.ones(2))["w"]
        tol = sharded_tolerance(w, st, s, WORLD, want)
        assert ((lost.float() - want.float()).abs() > tol).any()


def test_collectives_over_two_ranks(run):
    """Both ranks get the same full result, that of the whole stack."""
    from repro_torch.dist import collectives as col

    x = collective_inputs()
    t = lambda a: torch.tensor(a)
    tree = {k: t(v) for k, v in x["tree"].items()}
    want = to_numpy({
        "tree_pmean": col.tree_pmean(tree),
        "weighted_client_sum": col.weighted_client_sum(tree, t(x["coeff"])),
        "cross_client_delta": col.cross_client_delta(
            tree, {k: t(v) for k, v in x["w_global"].items()},
            t(x["coeff"])),
        "participation_count": col.participation_count(t(x["alpha"])),
        "masked_mean": col.masked_mean(t(x["loss"]), t(x["alpha"]))})
    g0, g1, w = (_flat(run[0]["collectives"]), _flat(run[1]["collectives"]),
                 _flat(want))
    assert set(g0) == set(w)
    for k in w:
        np.testing.assert_array_equal(g0[k], g1[k], err_msg=k)
        np.testing.assert_allclose(g0[k], w[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


# ----------------------------------------------- against the JAX package --
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("case", ["prefill-granite", "prefill-mamba2",
                                  "decode-granite"])
def test_sharded_serve_step_matches_reference(run, case, mesh_name):
    """Against the reference's bundle jitted on ``make_local_mesh()``, at
    ``test_torch_steps``' ``SERVE_TOL``."""
    g = _flat(run[0]["cases"][(case, mesh_name)]["out"])
    w = _flat(run[2][(case, mesh_name)][2])
    assert set(g) == set(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **SERVE_TOL)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("case", ["train-parallel", "train-sequential"])
def test_sharded_train_step_matches_reference(run, case, mesh_name):
    """Against the reference's host-local ``parallel_round`` with the same
    C, or ``sequential_client_step``, at ``test_torch_steps``' loss
    tolerance and one round's Adam bound."""
    from test_torch_steps import LOSS_TOL, _adam_check

    rank0, _, refs, tparams = run
    got = rank0["cases"][(case, mesh_name)]["out"]
    w, m = refs[(case, mesh_name)][2]
    if case == "train-parallel":
        assert float(got[1]["participants"]) == float(m["participants"])
        np.testing.assert_allclose(float(got[1]["loss"]), float(m["loss"]),
                                   **LOSS_TOL)
    else:
        np.testing.assert_allclose(float(got[1]), float(m), **LOSS_TOL)
    _adam_check(got[0], w, tparams[ARCH[case]], 1.0)


if __name__ == "__main__":
    child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
          sys.argv[5])
