"""Tests that need an NVIDIA card (marker ``cuda``; they skip without one).

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)  Each kernel is held
against its plain version within its module's ``kernel_tolerance``: flash
attention's (bf16: twice the largest move of rounding P to bf16, plus the
output's rounding; fp32: the reference's 2e-5), fused_agg's (twice the
first-order rounding bound of a float32 evaluation, plus two bf16 ulps in
bf16), fleet_step's, for its fleet and serve programs (per-client
outputs bitwise; each stat within gamma_d sum |valid x| of its float64
sum, d the kernel's summation depth; counts exact) and ssd_scan's (twice a
one-evaluation float32 bound over the sum of the terms' absolute values,
y and the final state); ``chip_smoke.py`` repeats the checks at the main
path's shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_agg as agg
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import get_model
from repro_torch.serve.engine import DecodeEngine, EngineConfig, Request

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(B, S, H, K, D, dtype, device, seed=0):
    r = np.random.default_rng(seed)
    mk = lambda h: torch.tensor(r.standard_normal((B, S, h, D)) * 0.5,
                                dtype=torch.float32).to(dtype).to(device)
    return mk(H), mk(K), mk(K)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("H,K,layout", [(8, 2, "gqa"), (4, 1, "mqa"),
                                        (8, 2, "fused")])
def test_kernel_matches_plain(card, dtype, D, H, K, layout):
    """Batch 2, ragged length 200, GQA 8/2 or MQA 4/1, all three masks;
    "fused": q, k, v are views of one (B, S, H + 2K, D) projection (strided
    heads).  The launch counter moves once per launch."""
    if layout == "fused":
        qkv, _, _ = _qkv(2, 200, H + 2 * K, 1, D, dtype, card)
        q, k, v = qkv.split([H, K, K], dim=2)
    else:
        q, k, v = _qkv(2, 200, H, K, D, dtype, card)
    for causal, window in ((True, 0), (True, 64), (False, 0)):
        before = fa.flash_attention_cuda.launches
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert fa.flash_attention_cuda.launches == before + 1
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window)
        tol = fa.kernel_tolerance(q, k, v, want, causal=causal,
                                  window=window)
        err = (got.float() - want.float()).abs()
        assert bool((err <= tol).all()), (err / tol).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("view", ["heads", "batch", "size1"])
def test_kernel_on_stride0_kv_matches_plain_or_raises(card, dtype, view):
    """k, v with stride 0: expanded along the KV heads or the batch (size >
    1), or along dimensions of size 1.  fp32 reads through pointers and
    takes all three; bf16 reads through TMA, which takes no stride 0, so it
    raises on an expanded view and takes stride 0 only at size 1.  Taken
    views match the plain version."""
    q, k, v = _qkv(2, 200, 8, 2, 64, dtype, card)
    if view == "heads":
        k, v = (t[:, :, :1].expand(2, 200, 2, 64) for t in (k, v))
    elif view == "batch":
        k, v = (t[:1].expand(2, 200, 2, 64) for t in (k, v))
    else:
        q = q[:1]
        k, v = (t[:1, :, :1].as_strided((1, 200, 1, 64),
                                         (0, t.stride(1), 0, 1))
                for t in (k, v))
    assert 0 in k.stride() and 0 in v.stride()
    if dtype == torch.bfloat16 and view != "size1":
        with pytest.raises(ValueError, match="stride 0"):
            fa.flash_attention_cuda(q, k, v)
        return
    got = fa.flash_attention_cuda(q, k, v, window=64)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v, window=64)
    tol = fa.kernel_tolerance(q, k, v, want, window=64)
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol).all()), (err / tol).max().item()


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(card):
    q, k, v = _qkv(1, 16, 4, 2, 64, torch.float32, card)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_cuda(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_cuda(q.transpose(1, 3).contiguous()
                                .transpose(1, 3), k, v)
    with pytest.raises(ValueError, match="multiple of KV heads"):
        fa.flash_attention_cuda(q[:, :, :3], k, v)


@pytest.mark.cuda
def test_engine_on_card_matches_engine_on_cpu(card):
    """granite-3-2b smoke config in fp32: greedy tokens through the engine
    on the card (flash kernel in prefill) equal those on the CPU (plain
    path), for staggered mixed-length prompts."""
    cfg = get_smoke_config("granite-3-2b")
    model = get_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    on_card = _to(params, card)
    specs = [(12, 6), (16, 4), (9, 8), (14, 5)]
    prompts = [np.random.default_rng(i).integers(0, cfg.vocab_size, S)
               for i, (S, _) in enumerate(specs)]
    config = EngineConfig(slots=2, cache_len=25, max_new=8)

    def run(p, device):
        return DecodeEngine(model, p, config, device=device).run(
            [Request(rid=i, tokens=prompts[i], max_new=g)
             for i, (_, g) in enumerate(specs)], arrivals=[0, 0, 2, 3])

    before = fa.flash_attention_cuda.launches
    got, want = run(on_card, card), run(params, "cpu")
    assert fa.flash_attention_cuda.launches - before == (
        len(specs) * cfg.num_layers)
    for i in range(len(specs)):
        np.testing.assert_array_equal(got[i].tokens, want[i].tokens)


def _ssd_inputs(B, S, H, P, G, N, dtype, device, seed=0):
    r = np.random.default_rng(seed)
    f = lambda a: torch.tensor(a, dtype=torch.float32)
    x = f(r.standard_normal((B, S, H, P)) * 0.5).to(dtype)
    dt = f(np.logaddexp(r.standard_normal((B, S, H)), 0.0))
    A = f(-np.exp(r.standard_normal(H) * 0.3))
    Bm = f(r.standard_normal((B, S, G, N)) * 0.3).to(dtype)
    Cm = f(r.standard_normal((B, S, G, N)) * 0.3).to(dtype)
    return tuple(t.to(device) for t in (x, dt, A, Bm, Cm))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,P,G,N,chunk", [
    (512, 8, 64, 1, 128, 256),     # the mamba2-1.3b layout, two P blocks
    (256, 8, 64, 8, 128, 16),      # pre-repeated groups, small chunk
    (192, 4, 40, 2, 16, 96),       # ragged P block and ragged row tile
    (64, 8, 32, 1, 16, 16),        # the smoke config's widths
    (256, 8, 64, 1, 128, 256),     # one chunk: no state carried between chunks
    (4096, 4, 64, 1, 128, 256),    # 16 chunks: the longest chain of states
    (512, 64, 64, 8, 128, 256),    # 8 groups of 8 heads
])
def test_ssd_scan_matches_plain(card, dtype, S, H, P, G, N, chunk):
    """y and the final state within ``kernel_tolerance`` at batch 2; one
    counted launch per call."""
    x, dt, A, Bm, Cm = _ssd_inputs(2, S, H, P, G, N, dtype, card)
    before = ssd.ssd_scan_cuda.launches
    y, h = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.ssd_scan_cuda.launches == before + 1
    wy, wh = ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
    ty, th = ssd.kernel_tolerance(x, dt, A, Bm, Cm, chunk=chunk)
    assert y.dtype == h.dtype == torch.float32
    for got, want, tol in ((y, wy, ty), (h, wh, th)):
        err = (got - want).abs()
        assert bool(torch.isfinite(got).all())
        assert bool((err <= tol).all()), (err / tol).max().item()


@pytest.mark.cuda
def test_ssd_scan_reads_strided_slices(card):
    """x, Bm, Cm as slices of one wider tensor (the model's conv output),
    in fp32 and bf16: no copy, same result as contiguous inputs, bitwise."""
    B, S, H, P, G, N = 1, 256, 4, 64, 1, 128
    for dtype in (torch.float32, torch.bfloat16):
        wide = (torch.randn(B, S, H * P + 2 * G * N + 8, device=card)
                * 0.3).to(dtype)
        x = wide[..., :H * P].reshape(B, S, H, P)
        Bm = wide[..., H * P:H * P + G * N].reshape(B, S, G, N)
        Cm = wide[..., H * P + G * N:H * P + 2 * G * N].reshape(B, S, G, N)
        dt = torch.nn.functional.softplus(torch.randn(B, S, H, device=card))
        A = -torch.rand(H, device=card)
        a = ssd.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=128)
        b = ssd.ssd_scan_cuda(x.contiguous(), dt, A, Bm.contiguous(),
                              Cm.contiguous(), chunk=128)
        for u, v in zip(a, b):
            assert torch.equal(u, v)


@pytest.mark.cuda
def test_ssd_scan_rejects_what_it_does_not_take(card):
    x, dt, A, Bm, Cm = _ssd_inputs(1, 32, 2, 8, 1, 16, torch.float32, card)
    with pytest.raises(ValueError, match="dtype"):
        ssd.ssd_scan_cuda(x.half(), dt, A, Bm.half(), Cm.half(), chunk=8)
    with pytest.raises(ValueError, match="float32"):
        ssd.ssd_scan_cuda(x, dt.double(), A, Bm, Cm, chunk=8)
    with pytest.raises(ValueError, match="last dim"):
        ssd.ssd_scan_cuda(x.transpose(2, 3).contiguous().transpose(2, 3),
                          dt, A, Bm, Cm, chunk=8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd.ssd_scan_cuda(x, dt.cpu(), A, Bm, Cm, chunk=8)
    with pytest.raises(ValueError, match="not divisible"):
        ssd.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=5)
    big = torch.zeros(1, 32, 1, 256, device=card)
    with pytest.raises(ValueError, match="state size"):
        ssd.ssd_scan_cuda(x, dt, A, big, big, chunk=8)
    # what the bf16 path's TMA loads do not take
    xb, Bb, Cb = (t.bfloat16() for t in (x, Bm, Cm))
    wide = torch.zeros(1, 32, 2, 72, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        ssd.ssd_scan_cuda(wide, dt, A, Bb, Cb, chunk=8)
    odd = torch.zeros(1, 32, 1, 12, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        ssd.ssd_scan_cuda(xb, dt, A, odd, odd, chunk=8)
    padded = torch.zeros(1, 32, 2, 9, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        ssd.ssd_scan_cuda(padded[..., :8], dt, A, Bb, Cb, chunk=8)


@pytest.mark.cuda
def test_ssm_engine_on_card_matches_engine_on_cpu(card):
    """mamba2-1.3b smoke config in fp32: greedy tokens through the engine
    on the card (ssd_scan kernel in the chunked prefills) equal those on
    the CPU (plain path), for staggered prompts of chunk-multiple and
    ragged lengths."""
    cfg = get_smoke_config("mamba2-1.3b")
    model = get_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    on_card = _to(params, card)
    specs = [(32, 6), (16, 4), (9, 8), (14, 5)]
    prompts = [np.random.default_rng(i).integers(0, cfg.vocab_size, S)
               for i, (S, _) in enumerate(specs)]
    config = EngineConfig(slots=2, cache_len=41, max_new=8)

    def run(p, device):
        return DecodeEngine(model, p, config, device=device).run(
            [Request(rid=i, tokens=prompts[i], max_new=g)
             for i, (_, g) in enumerate(specs)], arrivals=[0, 0, 2, 3])

    before = ssd.ssd_scan_cuda.launches
    got, want = run(on_card, card), run(params, "cpu")
    assert ssd.ssd_scan_cuda.launches - before == 2 * cfg.num_layers
    for i in range(len(specs)):
        np.testing.assert_array_equal(got[i].tokens, want[i].tokens)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,M", [(40, 1), (40, 257), (40, 16385),
                                 (40, 2400), (40, 10), (8, 2048 * 8192)])
def test_fused_agg_matches_plain(card, dtype, C, M):
    """Ragged and aligned leaves (both the scalar and the vector path);
    s = 0 gives w back exactly; one launch per call."""
    r = np.random.default_rng(M)
    w = torch.tensor(r.standard_normal(M), dtype=torch.float32).to(dtype)
    ws = torch.tensor(r.standard_normal((C, M)),
                      dtype=torch.float32).to(dtype)
    s = torch.tensor(r.uniform(0, 5.0 / C, C), dtype=torch.float32)
    w, ws, s = w.to(card), ws.to(card), s.to(card)
    before = agg.fused_agg_cuda.launches
    got = ops.fused_agg(w, ws, s)
    torch.cuda.synchronize()
    assert agg.fused_agg_cuda.launches == before + 1
    want = agg.fused_agg_plain(w, ws, s)
    tol = agg.kernel_tolerance(w, ws, s, want)
    err = (got.float() - want.float()).abs()
    assert got.dtype == dtype and bool((err <= tol).all()), (
        (err / tol).max().item())
    assert torch.equal(ops.fused_agg(w, ws, torch.zeros_like(s)), w)


@pytest.mark.cuda
def test_fused_agg_rejects_what_it_does_not_take(card):
    w = torch.zeros(64, device=card)
    ws = torch.zeros(3, 64, device=card)
    s = torch.zeros(3, device=card)
    with pytest.raises(ValueError, match="float32 or both"):
        agg.fused_agg_cuda(w.half(), ws.half(), s)
    with pytest.raises(ValueError, match="contiguous"):
        agg.fused_agg_cuda(w, ws.t().contiguous().t(), s)
    with pytest.raises(ValueError, match="CUDA tensors"):
        agg.fused_agg_cuda(w, ws, s.cpu())
    with pytest.raises(ValueError, match="do not match"):
        agg.fused_agg_cuda(w, ws, torch.zeros(4, device=card))


@pytest.mark.cuda
def test_fused_agg_tree_is_one_launch_bitwise_equal_to_leaf_launches(card):
    """The CIFAR CNN's ten leaves at C = 40 in one launch (and a bf16 leaf
    in a second), each leaf bitwise what its own launch gives, including a
    leaf that starts off a 16-byte boundary (the scalar path)."""
    from repro_torch.configs import get_config
    r = np.random.default_rng(1)
    params = get_model(get_config("cifar-cnn")).init_params(
        torch.Generator().manual_seed(0))
    C = 40
    t = lambda a, dt=torch.float32: torch.tensor(a, dtype=torch.float32
                                                 ).to(dt).to(card)
    tree = {n: {l: t(params[n][l].numpy()) for l in params[n]}
            for n in params}
    stack = {n: {l: t(params[n][l].numpy()[None] + 1e-3 * r.standard_normal(
        (C,) + tuple(params[n][l].shape))) for l in params[n]}
        for n in params}
    s = t(r.uniform(0, 5.0 / C, C))
    before = agg.fused_agg_cuda.launches
    got = ops.fused_agg_tree(tree, stack, s)
    torch.cuda.synchronize()
    assert agg.fused_agg_cuda.launches - before == 1
    for n in tree:
        for l in tree[n]:
            want = agg.fused_agg_cuda(tree[n][l].reshape(-1),
                                      stack[n][l].reshape(C, -1), s)
            assert torch.equal(got[n][l].reshape(-1), want), (n, l)
    buf = t(r.standard_normal(1001))
    mixed = {"a": tree["fc2"]["w"], "off": buf[1:],
             "h": t(r.standard_normal(300), torch.bfloat16)}
    mstack = {"a": stack["fc2"]["w"], "off": t(r.standard_normal((C, 1000))),
              "h": t(r.standard_normal((C, 300)), torch.bfloat16)}
    before = agg.fused_agg_cuda.launches
    got = ops.fused_agg_tree(mixed, mstack, s)
    torch.cuda.synchronize()
    assert agg.fused_agg_cuda.launches - before == 2     # one per dtype
    for k in mixed:
        want = agg.fused_agg_cuda(mixed[k].reshape(-1),
                                  mstack[k].reshape(C, -1), s)
        assert got[k].dtype == mixed[k].dtype
        assert torch.equal(got[k].reshape(-1), want), k


@pytest.mark.cuda
def test_train_round_on_card_matches_cpu(card):
    """One CNN round (C=4, T=2, B=8, SGD) on the card, through the kernel,
    against the same round on the CPU (plain path): same participants, and
    every param within 1e-6 + 1e-5 |w| (float32 sums in other orders, as
    ``tests/test_torch_round.py`` holds the port against the reference)."""
    from repro_torch import prng
    from repro_torch.core import FedConfig, parallel_round
    from repro_torch.launch.train import disable_tf32
    from repro_torch.optim import sgd
    disable_tf32()
    cfg = get_smoke_config("cifar-cnn")
    model = get_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    r = np.random.default_rng(0)
    batch = {"images": torch.tensor(r.standard_normal((4, 2, 8, 32, 32, 3)),
                                    dtype=torch.float32),
             "labels": torch.tensor(r.integers(0, 10, (4, 2, 8)))}
    E = torch.tensor([1, 5, 10, 20], dtype=torch.int32)
    p = torch.full((4,), 0.25)
    fed = FedConfig(num_clients=4, local_steps=2)

    def run(w, b, dev):
        return parallel_round(lambda q, x, k: model.loss_fn(q, x), sgd(1e-2),
                              fed, w, b, p.to(dev), E, 0, prng.PRNGKey(0))

    before = agg.fused_agg_cuda.launches
    got, mg = run(_to(params, card), _to(batch, card), card)
    torch.cuda.synchronize()
    assert agg.fused_agg_cuda.launches - before == 1      # one per tree
    want, mw = run(params, batch, "cpu")
    assert float(mg["participants"]) == float(mw["participants"])
    flat = lambda t: torch.cat([t[k][kk].cpu().reshape(-1) for k in t
                                for kk in t[k]])
    d = (flat(got) - flat(want)).abs()
    tol = 1e-6 + 1e-5 * flat(want).abs()
    assert bool((d <= tol).all()), (int((d > tol).sum()), d.max().item())


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _fleet_round(n, gate, hist, groups, card, seed=0):
    """One fleet round's program and inputs on the card (non-dyadic: the
    stats are held to ``fleet_step.kernel_tolerance``)."""
    from repro_torch.energy import battery, step_ops
    r = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32,
                               device=card)
    prog, env = step_ops.fleet_step_program(
        battery.BatteryConfig(capacity=2.5, leak=0.02), gate, groups,
        hist=hist, device=card)
    env.update(charge=t(r.uniform(0, 3, n)), harvest=t(r.exponential(0.7, n)),
               want=t(r.uniform(size=n) < 0.5), streak=t(r.integers(0, 70, n)),
               valid=t(np.arange(n) % 7 != 6), round_cost=t(1.0),
               threshold=t(1.5))
    if groups:
        env["groups"] = torch.tensor(r.integers(0, groups, n),
                                     dtype=torch.int32, device=card)
    return prog, env


def _fleet_errors(prog, env, stats, n, groups):
    from repro_torch.energy import step_ops
    from repro_torch.kernels import fleet_step as fs
    out, _ = step_ops.run_step(prog, env, valid=env["valid"],
                               groups=env.get("groups"), num_groups=groups)
    exact = fs.stats_float64(prog, out, env["valid"], env.get("groups"),
                             groups)
    tol = fs.kernel_tolerance(prog, out, env["valid"], n, env.get("groups"),
                              groups)
    return out, fs.stats_error(stats, exact, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("gate", ["sustainable", "threshold", "greedy"])
@pytest.mark.parametrize("hist,groups", [(False, None), (True, 3)])
@pytest.mark.parametrize("n", [1000, 70_001])
def test_fleet_step_matches_plain(card, gate, hist, groups, n):
    """Per-client outputs bitwise, stats within ``kernel_tolerance`` of
    their float64 sums (counts exact); one launch per call."""
    from repro_torch.kernels import fleet_step as fs
    prog, env = _fleet_round(n, gate, hist, groups, card)
    before = fs.fleet_step_cuda.launches
    state, emits, stats = ops.fleet_step(prog, env, n=n, emit=True,
                                         num_groups=groups)
    torch.cuda.synchronize()
    assert fs.fleet_step_cuda.launches == before + 1
    out, ratios = _fleet_errors(prog, env, stats, n, groups)
    for k in prog.state_out:
        assert torch.equal(state[k], out[k]), k
    assert torch.equal(emits["mask"], out["mask"])
    assert max(ratios.values()) <= 1.0, ratios


@pytest.mark.cuda
def test_fleet_step_tolerance_catches_faults_on_card(card):
    """The outcomes of the three planted faults, made with the kernel
    itself: the last block skipped (the kernel run on the clients before
    it), the ragged tail dropped (on all but the last client), a stat read
    from the wrong buffer (leaked reported as overflowed): each breaks the
    bound of the full round."""
    from repro_torch.kernels import fleet_step as fs
    n = 3 * fs.TILE + 1000
    prog, env = _fleet_round(n, "sustainable", True, None, card)
    _, _, good = fs.fleet_step_cuda(prog, env, n=n)
    assert max(_fleet_errors(prog, env, good, n, None)[1].values()) <= 1.0
    for m in (3 * fs.TILE, n - 1):
        cut = {k: (v[:m] if v.dim() and v.shape[0] == n else v)
               for k, v in env.items()}
        _, _, bad = fs.fleet_step_cuda(prog, cut, n=m)
        assert max(_fleet_errors(prog, env, bad, n, None)[1].values()) > 1.0
    swapped = dict(good, leaked=good["overflowed"])
    assert max(_fleet_errors(prog, env, swapped, n, None)[1].values()) > 1.0


@pytest.mark.cuda
def test_fleet_step_rejects_what_it_does_not_take(card):
    import dataclasses
    from repro_torch.kernels import fleet_step as fs
    prog, env = _fleet_round(64, "sustainable", False, None, card)
    with pytest.raises(ValueError, match="float32"):
        fs.fleet_step_cuda(prog, dict(env, charge=env["charge"].double()),
                           n=64)
    with pytest.raises(ValueError, match="shape"):
        fs.fleet_step_cuda(prog, dict(env, harvest=env["harvest"][:10]),
                           n=64)
    with pytest.raises(ValueError, match="is on"):
        fs.fleet_step_cuda(prog, dict(env, want=env["want"].cpu()), n=64)
    with pytest.raises(ValueError, match="fleet_step_program"):
        fs.fleet_step_cuda(dataclasses.replace(prog, ops=prog.ops[:2]), env,
                           n=64)


@pytest.mark.cuda
def test_simulate_fleet_on_card_matches_cpu(card):
    """A Bernoulli fleet (non-dyadic battery) for 10 rounds with groups
    and histograms: masks, charge, streak and counts bitwise between the
    card (one kernel launch a round) and the CPU (plain version)."""
    from repro_torch.energy import BatteryConfig, Bernoulli, FleetConfig
    from repro_torch.energy import simulate_fleet
    from repro_torch.kernels import fleet_step as fs
    n, R = 50_000, 10
    cfg = FleetConfig(num_clients=n, policy="sustainable", seed=1)
    kw = dict(E=np.arange(n) % 4 + 1, groups=np.arange(n) % 3, hist=True,
              record_masks=True)
    bat = BatteryConfig(capacity=2.5, leak=0.02, init_charge=0.5)
    before = fs.fleet_step_cuda.launches
    a = simulate_fleet(Bernoulli.create(n, 0.35, 1.2), bat, 1.0, cfg, R,
                       device=card, **kw)
    assert fs.fleet_step_cuda.launches - before == R
    b = simulate_fleet(Bernoulli.create(n, 0.35, 1.2), bat, 1.0, cfg, R,
                       device="cpu", **kw)
    assert torch.equal(a.masks.cpu(), b.masks)
    assert torch.equal(a.final_charge.cpu(), b.final_charge)
    assert torch.equal(a.final_streak.cpu(), b.final_streak)
    for k in ("participants", "consumed", "hist_soc", "hist_spend",
              "hist_streak", "group_participants"):
        np.testing.assert_array_equal(a.stats[k], b.stats[k], err_msg=k)
    for k in ("harvested", "leaked", "overflowed", "mean_charge"):
        np.testing.assert_allclose(a.stats[k], b.stats[k], rtol=1e-5,
                                   err_msg=k)


def _serve_epoch(n, admission, train, hist, device, seed=0):
    """One serving epoch's program and env on ``device``: non-dyadic
    charge, harvest and requests, a padding lane in seven, the example's
    prices, per-client battery and thresholds."""
    from repro_torch.energy import BatteryConfig, DecodeCostModel, step_ops
    from repro_torch.serve import (BatteryGated, ChargeGated, EnergyAgnostic,
                                   QoSSpec, TrainLoad)
    r = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    policy = {"agnostic": EnergyAgnostic(),
              "battery": BatteryGated(t(r.uniform(0.5, 2.5, n)),
                                      t(r.uniform(0.5, 2.0, n))),
              "charge": ChargeGated(t(r.uniform(1, 4, n)),
                                    t(r.uniform(0.2, 1, n)))}[admission]
    load = None if train is None else TrainLoad.create(
        np.full(n, 4), 0.2, policy=train, threshold=1.5, device=device)
    prog, env = step_ops.serve_step_program(
        BatteryConfig(capacity=t(r.uniform(4, 8, n)), leak=0.01),
        DecodeCostModel.from_params(1e8), QoSSpec(), policy, load,
        hist=hist, device=device)
    env.update(charge=t(r.uniform(0, 8, n)), harvest=t(r.exponential(1.5, n)),
               requests=t(r.poisson(1.0, n)), twant=t(r.uniform(size=n) < .3),
               streak=t(r.integers(0, 70, n)), valid=t(np.arange(n) % 7 != 6),
               admit=t(1.25))
    return prog, env


@pytest.mark.cuda
@pytest.mark.parametrize("admission", ["agnostic", "battery", "charge"])
@pytest.mark.parametrize("train", [None, "sustainable", "threshold",
                                   "greedy"])
@pytest.mark.parametrize("hist", [False, True])
def test_serve_step_matches_plain(card, admission, train, hist):
    """The serve program's kernel: charge, streak and mode bitwise, stats
    within ``kernel_tolerance`` (counts exact); one launch per call,
    through ``ops.fleet_step``."""
    from repro_torch.energy import step_ops
    from repro_torch.kernels import fleet_step as fs
    n = 70_001
    prog, env = _serve_epoch(n, admission, train, hist, card)
    before = (fs.fleet_step_cuda.launches, fs.serve_step_cuda.launches)
    state, emits, stats = ops.fleet_step(prog, env, n=n, emit=True)
    torch.cuda.synchronize()
    assert (fs.fleet_step_cuda.launches,
            fs.serve_step_cuda.launches) == (before[0], before[1] + 1)
    out, _ = step_ops.run_step(prog, env, valid=env["valid"])
    for k in prog.state_out:
        assert torch.equal(state[k], out[k]), k
    assert torch.equal(emits["mode"], out["mode"])
    exact = fs.stats_float64(prog, out, env["valid"])
    ratios = fs.stats_error(stats, exact, fs.kernel_tolerance(
        prog, out, env["valid"], n))
    assert max(ratios.values()) <= 1.0, ratios


def _offset(t):
    """An equal view of ``t`` that starts 4 bytes into a larger buffer."""
    buf = torch.empty(t.shape[0] + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t
    return buf[1:]


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["misaligned", "stride-1", "stride",
                                   "stride+1", "2stride-1", "2stride+1"])
def test_serve_step_scalar_path_and_grid_edges(card, where):
    """Per-client inputs as views at a 4-byte offset (the kernel's scalar
    path), and n one client either side of one and two sweeps of the
    persistent grid (grid x SERVE_TILE clients): charge, streak and mode
    bitwise, stats within ``kernel_tolerance``."""
    from repro_torch.energy import step_ops
    from repro_torch.kernels import fleet_step as fs
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    stride = fs.serve_grid(10 ** 9, sms) * fs.SERVE_TILE
    n = {"misaligned": 70_001, "stride-1": stride - 1, "stride": stride,
         "stride+1": stride + 1, "2stride-1": 2 * stride - 1,
         "2stride+1": 2 * stride + 1}[where]
    prog, env = _serve_epoch(n, "battery", "sustainable", True, card)
    if where == "misaligned":
        env = {k: _offset(v) if torch.is_tensor(v) and v.shape == (n,)
               and v.stride(0) == 1 else v for k, v in env.items()}
        assert env["charge"].data_ptr() % 16 == 4
    state, emits, stats = ops.fleet_step(prog, env, n=n, emit=True)
    torch.cuda.synchronize()
    out, _ = step_ops.run_step(prog, env, valid=env["valid"])
    for k in prog.state_out:
        assert torch.equal(state[k], out[k]), k
    assert torch.equal(emits["mode"], out["mode"])
    exact = fs.stats_float64(prog, out, env["valid"])
    ratios = fs.stats_error(stats, exact, fs.kernel_tolerance(
        prog, out, env["valid"], n))
    assert max(ratios.values()) <= 1.0, ratios


@pytest.mark.cuda
def test_serve_step_launch_shape(card):
    """The grid is SMs x SERVE_BLOCKS_PER_SM, which is what the kernel
    says and the occupancy CUDA reports for the main instantiation."""
    from repro_torch.kernels import fleet_step as fs
    lib = fs._serve_kernel()
    assert lib.serve_step_blocks_per_sm() == fs.SERVE_BLOCKS_PER_SM
    assert lib.serve_step_occupancy(fs.ADMISSIONS["battery_gated"],
                                    fs.TRAINS["sustainable"], 1) \
        == fs.SERVE_BLOCKS_PER_SM


@pytest.mark.cuda
def test_serve_step_rejects_what_it_does_not_take(card):
    import dataclasses
    from repro_torch.kernels import fleet_step as fs
    prog, env = _serve_epoch(64, "battery", "sustainable", False, card)
    with pytest.raises(ValueError, match="float32"):
        fs.serve_step_cuda(prog, dict(env, requests=env["requests"].double()),
                           n=64)
    with pytest.raises(ValueError, match="shape"):
        fs.serve_step_cuda(prog, dict(env, twant=env["twant"][:10]), n=64)
    with pytest.raises(ValueError, match="is on"):
        fs.serve_step_cuda(prog, dict(env, harvest=env["harvest"].cpu()),
                           n=64)
    with pytest.raises(ValueError, match="serve_step_program"):
        fs.serve_step_cuda(dataclasses.replace(prog, ops=prog.ops[:3]), env,
                           n=64)


@pytest.mark.cuda
def test_simulate_serve_on_card_matches_cpu(card):
    """A Constant-traffic, Bernoulli-harvest fleet under battery-gated
    admission and a sustainable training load, 10 epochs with histograms:
    modes, charge, streak, the ledger and the counts bitwise between the
    card (one serve-program launch an epoch) and the CPU."""
    from repro_torch.energy import BatteryConfig, Bernoulli, DecodeCostModel
    from repro_torch.kernels import fleet_step as fs
    from repro_torch.serve import (BatteryGated, Constant, QoSSpec,
                                   ServeConfig, TrainLoad, simulate_serve)
    n, E = 50_000, 10
    rate = np.random.default_rng(0).integers(0, 7, n).astype(np.float32)

    def go(dev):
        return simulate_serve(
            Constant.create(n, rate, device=dev),
            Bernoulli.create(n, 0.4, 1.5, device=dev),
            BatteryConfig(capacity=8.0, leak=0.01, init_charge=2.0),
            DecodeCostModel.from_params(1e8), QoSSpec(),
            BatteryGated.create(n, 2.0, 1.5, device=dev),
            ServeConfig(n, seed=1), E,
            train=TrainLoad.create(np.full(n, 4), 0.2, device=dev),
            hist=True, record_modes=True, device=dev)

    before = fs.serve_step_cuda.launches
    a = go(card)
    assert fs.serve_step_cuda.launches - before == E
    b = go("cpu")
    assert torch.equal(a.modes.cpu(), b.modes)
    assert torch.equal(a.final_charge.cpu(), b.final_charge)
    assert torch.equal(a.final_streak.cpu(), b.final_streak)
    for k in ("offered", "served_full", "served_short", "shed",
              "deadline_missed", "tokens_decoded", "participants",
              "frac_depleted", "hist_soc", "hist_spend", "hist_streak"):
        np.testing.assert_array_equal(a.stats[k], b.stats[k], err_msg=k)
    for k in ("harvested", "consumed", "leaked", "overflowed",
              "mean_charge", "consumed_serve", "consumed_train"):
        np.testing.assert_allclose(a.stats[k], b.stats[k], rtol=1e-5,
                                   err_msg=k)


# ------------------------------------------------- the sharded fleet ------
def _halves(env, n, m):
    """Two slabs of a round's env: clients [0, m) and [m, n)."""
    cut = lambda lo, hi: {k: (v[lo:hi] if v.dim() and v.shape[0] == n
                              else v) for k, v in env.items()}
    return cut(0, m), cut(m, n)


def _dyadic_fleet(n, gate, hist, groups, card, seed=1):
    """A fleet round on the exact-arithmetic grid: zero leak, charge,
    harvest, cost and threshold in quarters, so every partial sum is
    exact in any order."""
    from repro_torch.energy import battery, step_ops
    r = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32,
                               device=card)
    prog, env = step_ops.fleet_step_program(
        battery.BatteryConfig(capacity=2.5, leak=0.0), gate, groups,
        hist=hist, device=card)
    env.update(charge=t(r.integers(0, 11, n) * 0.25),
               harvest=t(r.integers(0, 6, n) * 0.25),
               want=t(r.uniform(size=n) < 0.5), streak=t(r.integers(0, 70, n)),
               valid=t(np.arange(n) % 7 != 6), round_cost=t(0.75),
               threshold=t(1.5))
    if groups:
        env["groups"] = torch.tensor(r.integers(0, groups, n),
                                     dtype=torch.int32, device=card)
    return prog, env


def _same_stats(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k].view(torch.int32), b[k].view(torch.int32)), k


@pytest.mark.cuda
@pytest.mark.parametrize("gate,hist,groups", [("sustainable", True, None),
                                              ("threshold", False, 3),
                                              ("greedy", True, 3)])
def test_fleet_step_row_then_finalize(card, gate, hist, groups):
    """One rank: the kernel's row, finalized, equals the host-local
    launch's stats bitwise on any inputs.  Two ranks: on dyadic inputs the
    sum of two half-fleets' rows, finalized, equals the whole fleet's
    launch bitwise.  A row-mode call counts one main launch, a finalize
    one finalize launch."""
    from repro_torch.kernels import fleet_step as fs
    n = 3 * fs.TILE + 777
    prog, env = _fleet_round(n, gate, hist, groups, card)
    _, _, want = fs.fleet_step_cuda(prog, env, n=n, num_groups=groups)
    before = (fs.fleet_step_cuda.launches, fs.fleet_finalize_cuda.launches)
    state, _, row = fs.fleet_step_cuda(prog, env, n=n, num_groups=groups,
                                       row=True)
    assert row.dtype == torch.float64
    _same_stats(fs.fleet_finalize_cuda(prog, row, groups), want)
    assert (fs.fleet_step_cuda.launches,
            fs.fleet_finalize_cuda.launches) == (before[0] + 1,
                                                 before[1] + 1)
    prog, env = _dyadic_fleet(n, gate, hist, groups, card)
    _, _, want = fs.fleet_step_cuda(prog, env, n=n, num_groups=groups)
    m = fs.TILE + 5
    rows = [fs.fleet_step_cuda(prog, half, n=len(half["valid"]),
                               num_groups=groups, row=True)[2]
            for half in _halves(env, n, m)]
    _same_stats(fs.fleet_finalize_cuda(prog, rows[0] + rows[1], groups),
                want)


def _dyadic_serve(n, admission, card, seed=1):
    """A serving epoch on the exact-arithmetic grid (zero leak, integer
    requests, dyadic prices and charge)."""
    from repro_torch.energy import BatteryConfig, DecodeCostModel, step_ops
    from repro_torch.serve import (BatteryGated, ChargeGated, EnergyAgnostic,
                                   QoSSpec, TrainLoad)
    r = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32,
                               device=card)
    policy = {"agnostic": EnergyAgnostic(),
              "battery": BatteryGated.create(n, 1.0, 1.0, device=card),
              "charge": ChargeGated.create(n, 1.0, 0.25, device=card)}[
                  admission]
    prog, env = step_ops.serve_step_program(
        BatteryConfig(capacity=2.5, leak=0.0),
        DecodeCostModel(2.0 ** -8, 2.0 ** -9, 2.0 ** -6),
        QoSSpec(64.0, 128.0, 32.0), policy,
        TrainLoad.create(np.full(n, 4), 0.25, device=card), hist=True,
        device=card)
    env.update(charge=t(r.integers(0, 11, n) * 0.25),
               harvest=t(r.integers(0, 6, n) * 0.25),
               requests=t(r.integers(0, 4, n)),
               twant=t(r.uniform(size=n) < .3),
               streak=t(r.integers(0, 70, n)),
               valid=t(np.arange(n) % 7 != 6), admit=t(1.0))
    return prog, env


@pytest.mark.cuda
@pytest.mark.parametrize("admission", ["agnostic", "battery", "charge"])
def test_serve_step_row_then_finalize(card, admission):
    """The serve program's kernel: one rank's row, finalized, equals the
    host-local launch bitwise; two half-fleets' rows summed and finalized
    equal the whole fleet's launch bitwise on dyadic inputs; the fold in
    row mode leaves its ticket and counts at 0 for the next call."""
    from repro_torch.kernels import fleet_step as fs
    n = 70_001
    prog, env = _serve_epoch(n, admission, "sustainable", True, card)
    _, _, want = fs.serve_step_cuda(prog, env, n=n)
    before = (fs.serve_step_cuda.launches, fs.serve_finalize_cuda.launches)
    _, _, row = fs.serve_step_cuda(prog, env, n=n, row=True)
    torch.cuda.synchronize()
    dev = env["charge"].device
    scratch = fs._serve_scratch(dev, torch.cuda.current_stream(dev)
                                .cuda_stream)[1]
    assert int(scratch.abs().sum()) == 0
    _same_stats(fs.serve_finalize_cuda(prog, row), want)
    assert (fs.serve_step_cuda.launches,
            fs.serve_finalize_cuda.launches) == (before[0] + 1,
                                                 before[1] + 1)
    _, _, again = fs.serve_step_cuda(prog, env, n=n)
    _same_stats(again, want)
    prog, env = _dyadic_serve(n, admission, card)
    _, _, want = fs.serve_step_cuda(prog, env, n=n)
    rows = [fs.serve_step_cuda(prog, half, n=len(half["valid"]),
                               row=True)[2]
            for half in _halves(env, n, 40_000)]
    _same_stats(fs.serve_finalize_cuda(prog, rows[0] + rows[1]), want)


@pytest.mark.cuda
def test_one_rank_sharded_fleet_on_card_equals_host_local(card, tmp_path):
    """A one-rank NCCL mesh: ``simulate_fleet`` and ``simulate_serve`` on
    the card equal their host-local runs bitwise (a one-rank all-reduce
    adds nothing), with one main launch and one finalize a round; a mesh
    on the CPU refuses a fleet on the card."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.energy import BatteryConfig, Bernoulli, FleetConfig
    from repro_torch.energy import simulate_fleet
    from repro_torch.kernels import fleet_step as fs

    dist.init_process_group(init_method=f"file://{tmp_path / 'rdzv'}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        n, R = 50_001, 6
        cfg = FleetConfig(num_clients=n, policy="sustainable", seed=1)
        kw = dict(E=np.arange(n) % 4 + 1, groups=np.arange(n) % 3,
                  hist=True, record_masks=True, device=card)
        bat = BatteryConfig(capacity=2.5, leak=0.02, init_charge=0.5)
        a = simulate_fleet(Bernoulli.create(n, 0.35, 1.2), bat, 1.0, cfg, R,
                           **kw)
        ops.zero_launches()
        b = simulate_fleet(Bernoulli.create(n, 0.35, 1.2), bat, 1.0, cfg, R,
                           mesh=mesh, **kw)
        assert (fs.fleet_step_cuda.launches,
                fs.fleet_finalize_cuda.launches) == (R, R)
        assert torch.equal(a.masks, b.masks)
        assert torch.equal(a.final_charge, b.final_charge)
        assert torch.equal(a.final_streak, b.final_streak)
        for k in a.stats:
            np.testing.assert_array_equal(a.stats[k], b.stats[k], err_msg=k)
        cpu_mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        with pytest.raises(ValueError, match="the mesh is on 'cpu'"):
            simulate_fleet(Bernoulli.create(8), bat, 1.0,
                           FleetConfig(num_clients=8), 1, mesh=cpu_mesh,
                           device=card)
    finally:
        dist.destroy_process_group()
