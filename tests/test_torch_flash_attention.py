"""The port's flash attention against the JAX Pallas kernel (interpret
mode, as ``tests/test_kernels.py`` runs it) and ``ref.mha_reference``, on
the same numpy inputs.

Tolerances are the reference's own (``test_kernels.py``): 2e-5 for fp32
(sum order), 2e-2 for bf16 (the output is rounded to bf16, and the two
frameworks round inputs and outputs at the same places but sum in another
order).  The CUDA kernel itself runs only on the card:
``test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(B, S, H, D, dtype, K=None, skv=None, seed=0):
    """numpy fp32 inputs, cast to ``dtype`` identically in both packages
    (round to nearest even)."""
    r = np.random.default_rng(seed)
    K = K or H
    mk = lambda s: (r.standard_normal(s) * 0.5).astype(np.float32)
    arrays = (mk((B, S, H, D)), mk((B, skv or S, K, D)),
              mk((B, skv or S, K, D)))
    jx = tuple(jnp.asarray(a).astype(dtype) for a in arrays)
    tx = tuple(torch.tensor(a).to(getattr(torch, dtype)) for a in arrays)
    return jx, tx


def _np(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _check(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,H,D", [
    (1, 32, 1, 16), (2, 64, 4, 32), (1, 128, 2, 64), (2, 48, 3, 32),
    (2, 40, 2, 256),            # recurrentgemma's head dim, ragged S
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16), (False, 0)])
def test_plain_matches_pallas_kernel(B, S, H, D, dtype, causal, window):
    (jq, jk, jv), (tq, tk, tv) = _qkv(B, S, H, D, dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                block_q=16, block_k=16, interpret=True)
    oracle = jref.mha_reference(jq, jk, jv, causal=causal, window=window)
    for blocks in ({"block_q": 16, "block_k": 16}, {}):   # reference's, kernel's
        got = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                       window=window, **blocks)
        assert got.dtype == tq.dtype and got.shape == tq.shape
        _check(got, want, dtype)
        _check(got, oracle, dtype)


@pytest.mark.parametrize("Sq,Skv", [(40, 40), (1, 1), (1, 37), (70, 70)])
def test_uneven_lengths_and_single_query(Sq, Skv):
    """Ragged tails (the padded-KV guard) and Sq = 1."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, Sq, 2, 32, "float32", skv=Skv)
    causal = Sq == Skv
    want = jref.mha_reference(jq, jk, jv, causal=causal)
    _check(ops.flash_attention(tq, tk, tv, causal=causal), want, "float32")
    if Sq == Skv:
        pallas = jops.flash_attention(jq, jk, jv, causal=True, block_q=16,
                                      block_k=16, interpret=True)
        _check(fa.flash_attention_plain(tq, tk, tv, causal=True, block_q=16,
                                        block_k=16), pallas, "float32")


@pytest.mark.parametrize("H,K,D,S", [
    pytest.param(4, 2, 16, 24, id="4-2"),
    pytest.param(8, 1, 16, 24, id="8-1"),
    pytest.param(32, 8, 16, 24, id="32-8"),
    # MQA at recurrentgemma-2b's head dim, a ragged length
    pytest.param(3, 1, 256, 37, id="3-1-D256-S37"),
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 8)])
def test_gqa_mapping_matches_repeated_kv(H, K, D, S, causal, window):
    """Query head h reads KV head h // (H/K): the same as the reference's
    ``repeat_kv`` before the Pallas kernel."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, S, H, D, "float32", K=K)
    rep = lambda a: jnp.repeat(a, H // K, axis=2)
    want = jops.flash_attention(jq, rep(jk), rep(jv), causal=causal,
                                window=window, block_q=8, block_k=8,
                                interpret=True)
    _check(ops.flash_attention(tq, tk, tv, causal=causal, window=window),
           want, "float32")


def test_mha_reference_port_matches():
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, 20, 3, 16, "float32")
    for causal, window in ((True, 0), (True, 5), (False, 0)):
        _check(ref.mha_reference(tq, tk, tv, causal=causal, window=window),
               jref.mha_reference(jq, jk, jv, causal=causal, window=window),
               "float32")


def test_cpu_dispatch_takes_plain_and_cuda_wrapper_refuses_cpu():
    _, (tq, tk, tv) = _qkv(1, 8, 2, 16, "float32")
    before = fa.flash_attention_cuda.launches
    out = ops.flash_attention(tq, tk, tv)
    assert fa.flash_attention_cuda.launches == before
    torch.testing.assert_close(out, fa.flash_attention_plain(tq, tk, tv))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_cuda(tq, tk, tv)
    with pytest.raises(ValueError, match="multiple of KV heads"):
        fa.flash_attention_plain(tq, tk[:, :, :1].repeat(1, 1, 3, 1),
                                 tv[:, :, :1].repeat(1, 1, 3, 1))


def test_tile_sizes_mirror_the_kernels_dispatch():
    """``tile_sizes`` gives, for every (dtype, head dim) the kernel takes,
    the tiles that ``csrc/flash_attention.cu``'s C entry launches for it,
    one instantiation a head dim, and the plain version defaults to them;
    other head dims and dtypes raise."""
    src = (fa.build.CSRC / "flash_attention.cu").read_text()
    f32_bk = re.search(r"constexpr int F32_BK = (\d+);", src).group(1)
    made = {}
    for dtype, pat in (
            (torch.bfloat16,
             r"if \(D == (\d+)\) return launch_bf16<(\d+), (\d+), (\d+), \d+>"),
            (torch.float32,
             r"if \(D == (\d+)\) return launch_f32<(\d+), (\d+)>()")):
        for d, d_t, bq, bk in re.findall(pat, src):
            assert d == d_t and (dtype, int(d)) not in made, (dtype, d)
            made[(dtype, int(d))] = (int(bq), int(bk or f32_bk))
    assert made == {(dtype, D): fa.tile_sizes(D, dtype)
                    for dtype in fa.DTYPES for D in fa.HEAD_DIMS}
    assert fa.HEAD_DIMS == (64, 128, 256)
    _, (q, k, v) = _qkv(1, 130, 2, 8, "float32", K=1)
    for dtype in fa.DTYPES:
        for D in fa.HEAD_DIMS:
            bq, bk = fa.tile_sizes(D, dtype)
            x = [t.to(dtype).repeat(1, 1, 1, D // 8) for t in (q, k, v)]
            torch.testing.assert_close(
                fa.flash_attention_plain(*x, causal=False, window=7),
                fa.flash_attention_plain(*x, causal=False, window=7,
                                         block_q=bq, block_k=bk),
                rtol=0, atol=0)
    for D, dtype in ((32, torch.float32), (32, torch.bfloat16),
                     (16, torch.bfloat16), (64, torch.float16)):
        with pytest.raises(ValueError, match="head dim|dtype"):
            fa.tile_sizes(D, dtype)


def _bf16_kernel_model(q, k, v, *, causal, fault=None, late=256):
    """Dense attention with the bf16 kernel's rounding: each p (relative
    to its row max) rounded to bf16 before P V, l summed from the unrounded
    p, the output rounded to bf16.  ``fault`` plants a kernel bug in rows
    ``>= late``: "dropped_tile" skips the first KV tile of the kernel's
    tiles (``tile_sizes``), "causal_off_by_one" lets row q see key
    q + 1."""
    B, S, H, D = q.shape
    g = H // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(g, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(g, dim=2).transpose(1, 2)
    rows, cols = torch.arange(S)[:, None], torch.arange(S)[None, :]
    reach = rows + (1 if fault == "causal_off_by_one" else 0) * (rows >= late)
    visible = cols <= reach if causal else torch.ones(S, S, dtype=torch.bool)
    if fault == "dropped_tile":
        block_k = fa.tile_sizes(D, q.dtype)[1]
        visible = visible & ~((rows >= late) & (cols < block_k))
    s = torch.where(visible, qf @ kf.transpose(-1, -2) / D ** 0.5, fa.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = (p.bfloat16().float() @ vf) / p.sum(-1, keepdim=True)
    return out.transpose(1, 2).to(torch.bfloat16)


_FAULTS = [(None, True), (None, False), ("dropped_tile", True),
           ("dropped_tile", False), ("causal_off_by_one", True)]


@pytest.mark.parametrize("fault,causal,D,K", [
    pytest.param(f, c, 64, 2, id=f"{f}-{c}") for f, c in _FAULTS] + [
    # recurrentgemma-2b's head dim, MQA
    pytest.param(f, c, 256, 1, id=f"{f}-{c}-D256") for f, c in _FAULTS])
def test_kernel_tolerance_admits_rounding_and_rejects_faults(fault, causal,
                                                             D, K):
    """``kernel_tolerance`` (the on-card kernel check's bound) admits the
    bf16 kernel's rounding of P and of the output, and rejects a dropped
    KV tile or a causal off-by-one confined to rows >= 256 of 512, where
    each output averages hundreds of values: the off-by-one moves none by
    more than ~1e-2, which the reference's 2e-2 tolerance would admit."""
    _, (q, k, v) = _qkv(1, 512, 4, D, "bfloat16", K=K)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    got = _bf16_kernel_model(q, k, v, causal=causal, fault=fault)
    err = (got.float() - want.float()).abs()
    within = bool((err <= fa.kernel_tolerance(q, k, v, want,
                                              causal=causal)).all())
    assert within == (fault is None)
