"""The fleet_step kernel's plain version against the JAX package's Pallas
kernel (interpret mode) and both ``fleet_step_reference`` oracles, the
program check the CUDA wrapper makes, and ``kernel_tolerance`` against a
model of the CUDA kernel's summation order with planted faults.

Tolerances: per-client state and masks bitwise everywhere; stats bitwise
on the reference's dyadic configuration (``tests/test_kernels.py``), where
every partial sum is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.scheduling import Policy as JPolicy
from repro.energy import battery as jbattery
from repro.energy import step_ops as jstep
from repro.kernels import fleet_step as jfleet
from repro.kernels import ref as jref
from repro_torch.core.scheduling import Policy
from repro_torch.energy import battery as tbattery
from repro_torch.energy import step_ops
from repro_torch.kernels import fleet_step as fs
from repro_torch.kernels import ops, ref

# the reference's dyadic fleet configuration (tests/test_kernels.py)
CAP, LEAK, COST, THR = 2.5, 0.25, 0.75, 1.5
FLAVORS = {"sustainable": Policy.SUSTAINABLE, "greedy": Policy.GREEDY,
           "threshold": Policy.THRESHOLD}


def _dyadic(n, seed=5):
    r = np.random.default_rng(seed)
    charge = r.integers(0, 9, n).astype(np.float32) * 0.25
    harvest = r.integers(0, 5, n).astype(np.float32) * 0.25
    want = (r.uniform(size=n) > 0.5).astype(np.float32)
    return charge, harvest, want


def _bitwise(got, want, label):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert np.array_equal(got, np.asarray(want)), label


@pytest.mark.parametrize("n,tile", [(24, 8), (21, 8), (13, 16)])
@pytest.mark.parametrize("flavor", ["sustainable", "greedy", "threshold"])
def test_plain_matches_pallas_kernel_and_references(n, tile, flavor):
    """The plain version vs the Pallas kernel in interpret mode and both
    longhand oracles: per-client state, mask and every stat bitwise."""
    charge, harvest, want = _dyadic(n)
    valid = np.ones(n, np.float32)
    jprog, jenv = jstep.fleet_step_program(
        jbattery.BatteryConfig(capacity=CAP, leak=LEAK, init_charge=0.5),
        JPolicy(flavor))
    jenv.update(charge=jnp.asarray(charge), harvest=jnp.asarray(harvest),
                round_cost=jnp.float32(COST), threshold=jnp.float32(THR),
                valid=jnp.asarray(valid))
    if flavor == "sustainable":
        jenv["want"] = jnp.asarray(want)
    jstate, jemits, jstats = jfleet.fused_step(jprog, jenv, n=n, emit=True,
                                               tile=tile, interpret=True)
    prog, env = step_ops.fleet_step_program(
        tbattery.BatteryConfig(capacity=CAP, leak=LEAK, init_charge=0.5),
        FLAVORS[flavor])
    env.update(charge=torch.tensor(charge), harvest=torch.tensor(harvest),
               round_cost=torch.tensor(COST), threshold=torch.tensor(THR),
               valid=torch.tensor(valid))
    if flavor == "sustainable":
        env["want"] = torch.tensor(want)
    state, emits, stats = fs.fleet_step_plain(prog, env, n=n, emit=True)
    oracle_kw = dict(capacity=CAP, leak=LEAK,
                     want=want if flavor == "sustainable" else None,
                     threshold=THR if flavor == "threshold" else None)
    jc, jm, js = jref.fleet_step_reference(charge, harvest, COST, valid,
                                           **oracle_kw)
    tc, tm, ts = ref.fleet_step_reference(charge, harvest, COST, valid,
                                          **oracle_kw)
    for got in (state["charge_out"], tc):
        _bitwise(got, jstate["charge_out"], "charge")
        _bitwise(got, jc, "charge vs oracle")
    for got in (emits["mask"], tm):
        _bitwise(got, jemits["mask"], "mask")
        _bitwise(got, jm, "mask vs oracle")
    assert set(stats) == set(jstats) == set(js) == set(ts)
    for k in js:
        _bitwise(stats[k], jstats[k], k)
        _bitwise(stats[k], js[k], k)
        _bitwise(ts[k], js[k], k)


@pytest.mark.parametrize("flavor", ["sustainable", "greedy", "threshold"])
def test_oracle_matches_reference_oracle_on_random_inputs(flavor):
    """Non-dyadic inputs: the port's longhand oracle keeps the jitted
    reference's absorb contraction, so charge and mask stay bitwise."""
    import jax
    r = np.random.default_rng(1)
    n = 100_000
    charge = r.uniform(0, 3, n).astype(np.float32)
    harvest = r.exponential(0.7, n).astype(np.float32)
    want = (r.uniform(size=n) < 0.5).astype(np.float32)
    valid = np.ones(n, np.float32)
    kw = dict(capacity=2.5, leak=0.02,
              want=want if flavor == "sustainable" else None,
              threshold=1.5 if flavor == "threshold" else None)
    jc, jm, js = jax.jit(lambda c, h: jref.fleet_step_reference(
        c, h, 1.0, valid, **kw))(charge, harvest)
    tc, tm, ts = ref.fleet_step_reference(charge, harvest, 1.0, valid, **kw)
    _bitwise(tc, jc, "charge")
    _bitwise(tm, jm, "mask")
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=1e-5)


def test_cpu_dispatch_takes_the_plain_version():
    charge, harvest, want = _dyadic(40)
    prog, env = step_ops.fleet_step_program(
        tbattery.BatteryConfig(capacity=CAP, leak=LEAK), Policy.GREEDY)
    env.update(charge=torch.tensor(charge), harvest=torch.tensor(harvest),
               round_cost=torch.tensor(COST), valid=torch.ones(40))
    before = fs.fleet_step_cuda.launches
    got = ops.fleet_step(prog, env, n=40, emit=True)
    want_ = fs.fleet_step_plain(prog, env, n=40, emit=True)
    assert fs.fleet_step_cuda.launches == before
    _bitwise(got[0]["charge_out"], want_[0]["charge_out"], "charge")
    _bitwise(got[1]["mask"], want_[1]["mask"], "mask")


@pytest.mark.parametrize("policy", list(Policy))
@pytest.mark.parametrize("hist", [False, True])
@pytest.mark.parametrize("groups", [None, 3])
def test_program_check_accepts_fleet_programs_only(policy, hist, groups):
    """Every fleet program maps to a kernel instantiation (ALWAYS runs the
    GREEDY gate); WAIT_ALL has no fleet program; a changed program, or
    group stats without num_groups, is refused."""
    bat = tbattery.BatteryConfig()
    if policy == Policy.WAIT_ALL:
        with pytest.raises(ValueError, match="no battery-gated"):
            step_ops.fleet_step_program(bat, policy)
        return
    prog, _ = step_ops.fleet_step_program(bat, policy, groups, hist=hist)
    gate, h = fs.program_variant(prog, groups)
    want_gate = {Policy.SUSTAINABLE: 0, Policy.THRESHOLD: 1}.get(policy, 2)
    assert (gate, h) == (want_gate, hist)
    with pytest.raises(ValueError, match="come together"):
        fs.program_variant(prog, None if groups else 2)
    import dataclasses
    changed = dataclasses.replace(prog, ops=prog.ops[:-1])
    with pytest.raises(ValueError, match="fleet_step_program"):
        fs.program_variant(changed, groups)
    swapped = dataclasses.replace(prog, totals=prog.totals[::-1])
    with pytest.raises(ValueError, match="fleet_step_program"):
        fs.program_variant(swapped, groups)


def test_cuda_wrapper_refuses_cpu_tensors_before_building():
    prog, env = step_ops.fleet_step_program(tbattery.BatteryConfig(),
                                            Policy.GREEDY)
    env.update(charge=torch.zeros(8), harvest=torch.zeros(8),
               round_cost=torch.tensor(1.0), valid=torch.ones(8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fs.fleet_step_cuda(prog, env, n=8)


def test_stat_layout_covers_every_stat_once():
    prog, _ = step_ops.fleet_step_program(tbattery.BatteryConfig(),
                                          Policy.SUSTAINABLE, 3, hist=True)
    lay = fs.stat_layout(prog, 3)
    idx = []
    for v in lay.values():
        idx += list(range(v.start, v.stop)) if isinstance(v, slice) else [v]
    assert sorted(idx) == list(range(7 + 2 * 3 + fs.NBINS))
    assert lay["group_participants"] == slice(7, 10)
    assert lay["hist_streak"] == slice(7 + 6 + 64, 7 + 6 + 128)


# ------------------------------------------------ kernel model and faults --
def _block_sums(x, n, skip_last=False, keep=None):
    """Column sums in csrc/fleet_step.cu's order: per thread CPT clients
    from +0, a warp shuffle tree, the 8 warps in order; then lane l of the
    second pass adds rows l, l+32, ... and a shuffle tree.  ``keep`` (n,)
    bool leaves clients out (a kernel that never reached them)."""
    blocks = -(-n // fs.TILE)
    xp = np.zeros(blocks * fs.TILE, np.float32)
    xp[:n] = np.where(keep, x, 0) if keep is not None else x
    t = xp.reshape(blocks, fs.CPT, fs.THREADS)
    acc = np.zeros((blocks, fs.THREADS), np.float32)
    for k in range(fs.CPT):
        acc = (acc + t[:, k, :]).astype(np.float32)

    def tree(w):
        w = w.copy()
        for off in (16, 8, 4, 2, 1):
            w[..., :32 - off] = (w[..., :32 - off] + w[..., off:32]
                                 ).astype(np.float32)
        return w[..., 0]

    lanes = tree(acc.reshape(blocks, fs.WARPS, 32))
    rows = lanes[:, 0]
    for j in range(1, fs.WARPS):
        rows = (rows + lanes[:, j]).astype(np.float32)
    if skip_last:
        rows = rows[:-1]
    m = -(-len(rows) // 32)
    rp = np.zeros(m * 32, np.float32)
    rp[:len(rows)] = rows
    col = np.zeros(32, np.float32)
    for j in range(m):
        col = (col + rp[j * 32:(j + 1) * 32]).astype(np.float32)
    return tree(col[None])[0]


def _kernel_model(program, out, valid, n, groups=None, num_groups=None,
                  fault=None):
    """The stats as the CUDA kernel sums them, from the per-client buffers
    of a plain round; ``fault`` plants one of the faults the check must
    catch: the last block skipped, the ragged tail past the last whole
    block dropped, a stat read from the wrong buffer."""
    v = valid.numpy()
    keep = None
    if fault == "drop_tail":
        keep = np.arange(n) < (n // fs.TILE) * fs.TILE
    skip = fault == "skip_last_block"
    buf = lambda b: out[b].numpy().astype(np.float32)
    if fault == "wrong_buffer":
        buf = lambda b, _b=buf: _b("overflow" if b == "leaked" else b)
    col = lambda x: _block_sums((v * x).astype(np.float32), n, skip, keep)
    stats = {s: col(buf(b)) for s, b in program.totals}
    den = max(col(np.ones(n, np.float32)), np.float32(1))
    stats.update({s: np.float32(col(buf(b)) / den)
                  for s, b in program.averages})
    if num_groups:
        g = groups.numpy()
        gt, ga = [], []
        for k in range(num_groups):
            w = (v * (g == k)).astype(np.float32)
            c = lambda x: _block_sums((w * x).astype(np.float32), n, skip,
                                      keep)
            gt.append(c(buf("mask")))
            ga.append(np.float32(c(buf("depleted"))
                                 / max(c(np.ones(n, np.float32)),
                                       np.float32(1))))
        stats["group_participants"] = np.array(gt, np.float32)
        stats["group_frac_depleted"] = np.array(ga, np.float32)
    from repro_torch.obs import hist as hist_lib
    for spec in program.hists:
        idx = hist_lib.bin_index(out[spec.buf], spec.lo, spec.hi,
                                 spec.bins).numpy()
        w = v.copy()
        if keep is not None:
            w = w * keep
        if skip:
            w[((n - 1) // fs.TILE) * fs.TILE:] = 0
        stats[spec.name] = np.bincount(idx, weights=w, minlength=spec.bins
                                       ).astype(np.float32)
    return {k: torch.tensor(np.asarray(x)) for k, x in stats.items()}


def _round(n, policy, hist, groups, seed):
    r = np.random.default_rng(seed)
    bat = tbattery.BatteryConfig(capacity=2.5, leak=0.02)
    prog, env = step_ops.fleet_step_program(bat, policy, groups, hist=hist)
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    env.update(charge=t(r.uniform(0, 3, n)),
               harvest=t(r.exponential(0.7, n)),
               want=t(r.uniform(size=n) < 0.5),
               streak=t(r.integers(0, 70, n)),
               valid=t(np.arange(n) % 7 != 6),
               round_cost=torch.tensor(1.0), threshold=torch.tensor(1.5))
    if groups:
        env["groups"] = torch.tensor(r.integers(0, groups, n),
                                     dtype=torch.int32)
    out, _ = step_ops.run_step(prog, env, valid=env["valid"],
                               groups=env.get("groups"), num_groups=groups)
    return prog, env, out


@pytest.mark.parametrize("n", [3 * 4096 + 1000, 65537, 300_001])
@pytest.mark.parametrize("groups", [None, 3])
def test_kernel_tolerance_admits_rounding_and_rejects_faults(n, groups):
    """A model of the kernel's float32 summation order lies well inside
    ``kernel_tolerance`` of the float64 sums; the three planted faults
    (last block skipped, ragged tail dropped, leaked read from the
    overflow buffer) each break it by more than 10x, or break an exact
    histogram count."""
    prog, env, out = _round(n, Policy.SUSTAINABLE, True, groups, n)
    valid, g = env["valid"], env.get("groups")
    exact = fs.stats_float64(prog, out, valid, g, groups)
    tol = fs.kernel_tolerance(prog, out, valid, n, g, groups)
    model = _kernel_model(prog, out, valid, n, g, groups)
    ratios = fs.stats_error(model, exact, tol)
    assert max(ratios.values()) < 0.5, ratios
    faults = ["skip_last_block", "wrong_buffer"]
    if n % fs.TILE:
        faults.append("drop_tail")
    for fault in faults:
        bad = _kernel_model(prog, out, valid, n, g, groups, fault=fault)
        ratios = fs.stats_error(bad, exact, tol)
        assert max(ratios.values()) > 10, (fault, ratios)


def test_reduction_depth_follows_the_launch_shape():
    assert fs.reduction_depth(1) == fs.CPT + 5 + fs.WARPS - 1 + 1 + 5
    assert fs.reduction_depth(10_000_000) == 16 + 5 + 7 + 77 + 5


def test_serve_reduction_depth_follows_the_serve_launch_shape():
    """csrc/serve_step.cu: a persistent grid of SERVE_BLOCKS_PER_SM blocks
    an SM (at most a block a tile), SERVE_CPT clients a thread a tile."""
    assert fs.serve_grid(1) == 1
    assert fs.serve_grid(10_000_000) == 132 * fs.SERVE_BLOCKS_PER_SM
    assert fs.serve_grid(10_000_000, sms=114) == 114 * fs.SERVE_BLOCKS_PER_SM
    assert fs.serve_reduction_depth(1) == fs.SERVE_CPT + 5 + 7 + 1 + 5
    tiles, grid = -(-10_000_000 // fs.SERVE_TILE), fs.serve_grid(10_000_000)
    assert fs.serve_reduction_depth(10_000_000) == (
        fs.SERVE_CPT * -(-tiles // grid) + 5 + 7 + -(-grid // 32) + 5)
    assert fs.serve_reduction_depth(10_000_000) == 2 * 50 + 5 + 7 + 13 + 5
