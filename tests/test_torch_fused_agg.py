"""The port's ``fused_agg`` (plain version, CPU dispatch and tree wrapper)
against the JAX Pallas kernel (interpret mode, as ``tests/test_kernels.py``
runs it) and ``ref.agg_reference``, on the same numpy inputs; and its
``kernel_tolerance`` against a model of the CUDA kernel's arithmetic.

Tolerance: ``fused_agg.kernel_tolerance``.  Any two float32 evaluations of
w (1 - sum s) + sum_c s_c w_c from the same inputs lie within
2 (C + 2) 2^-24 (|w| (1 + sum|s|) + sum_c |s_c| |w_c|) of each other
(first order); bf16 outputs add two bf16 ulps of the expected value.  The
CUDA kernel itself runs only on the card (``test_torch_kernels_cuda.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_agg as jagg
from repro.kernels import ref as jref
from repro_torch.kernels import fused_agg as agg
from repro_torch.kernels import ops, ref


def _inputs(C, M, seed=0, s_scale=1.0):
    r = np.random.default_rng(seed)
    w = r.standard_normal(M).astype(np.float32)
    ws = r.standard_normal((C, M)).astype(np.float32)
    s = (r.uniform(0, 1, C) * s_scale).astype(np.float32)
    return w, ws, s


def _both(w, ws, s, dtype):
    jx = (jnp.asarray(w).astype(dtype), jnp.asarray(ws).astype(dtype),
          jnp.asarray(s))
    tx = (torch.tensor(w).to(getattr(torch, dtype)),
          torch.tensor(ws).to(getattr(torch, dtype)), torch.tensor(s))
    return jx, tx


def _within(got, want_t, tx):
    tol = agg.kernel_tolerance(*tx, want_t)
    err = (got.float() - want_t.float()).abs()
    return bool((err <= tol).all()), float((err / tol).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,M", [(1, 1), (3, 257), (8, 5000), (40, 16385)])
def test_plain_matches_pallas_kernel_and_reference(dtype, C, M):
    (jw, jws, js), tx = _both(*_inputs(C, M, seed=C + M, s_scale=5.0 / C),
                              dtype)
    want = agg.fused_agg_plain(*tx)
    assert want.dtype == tx[0].dtype and want.shape == (M,)
    pallas = jagg.fused_agg(jw, jws, js, interpret=True)
    oracle = jref.agg_reference(jw, jws, js)
    for other in (torch.tensor(np.asarray(pallas, np.float32)),
                  torch.tensor(np.asarray(oracle, np.float32)),
                  ref.agg_reference(*tx)):
        ok, ratio = _within(other, want, tx)
        assert ok, ratio
    np.testing.assert_allclose(ref.agg_reference(*tx).float().numpy(),
                               np.asarray(oracle, np.float32), rtol=1e-5,
                               atol=1e-5 if dtype == "float32" else 2e-2)


def test_cpu_dispatch_takes_the_plain_version():
    _, tx = _both(*_inputs(4, 300), "float32")
    torch.testing.assert_close(ops.fused_agg(*tx), agg.fused_agg_plain(*tx),
                               rtol=0, atol=0)
    assert agg.fused_agg_cuda.launches == 0


def test_zero_weights_return_w_exactly():
    _, (w, ws, _) = _both(*_inputs(6, 999), "float32")
    out = ops.fused_agg(w, ws, torch.zeros(6))
    assert torch.equal(out, w)


def test_tree_matches_pallas_tree_and_paper_aggregation():
    from repro.core import aggregate as jaggregate
    r = np.random.default_rng(5)
    C = 6
    tree = {"a": {"w": r.standard_normal((5, 7)).astype(np.float32),
                  "b": r.standard_normal(()).astype(np.float32)},
            "c": r.standard_normal((3, 2, 4)).astype(np.float32)}
    stack = {"a": {"w": r.standard_normal((C, 5, 7)).astype(np.float32),
                   "b": r.standard_normal((C,)).astype(np.float32)},
             "c": r.standard_normal((C, 3, 2, 4)).astype(np.float32)}
    mask = (r.uniform(size=C) > 0.4).astype(np.float32)
    p = np.full(C, 1.0 / C, np.float32)
    E = np.arange(1, C + 1, dtype=np.float32)
    s = mask * p * E
    to_j = lambda t: {k: to_j(v) if isinstance(v, dict) else jnp.asarray(v)
                      for k, v in t.items()}
    to_t = lambda t: {k: to_t(v) if isinstance(v, dict) else torch.tensor(v)
                      for k, v in t.items()}
    got = ops.fused_agg_tree(to_t(tree), to_t(stack), torch.tensor(s))
    want = jagg.fused_agg_tree(to_j(tree), to_j(stack), jnp.asarray(s),
                               interpret=True)
    paper = jaggregate(to_j(tree), to_j(stack), jnp.asarray(mask),
                       jnp.asarray(p), jnp.asarray(E))
    for path in (("a", "w"), ("a", "b"), ("c",)):
        g, wv, pv = got, want, paper
        for k in path:
            g, wv, pv = g[k], wv[k], pv[k]
        assert g.shape == tuple(np.shape(wv))
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(pv), rtol=1e-5,
                                   atol=1e-5)


def _kernel_model(w, ws, s, skip_last=False, ragged_tail=0, no_sum=False):
    """The CUDA kernel's arithmetic in numpy: per element, a float32 FMA
    chain over c = 0..C-1 (each FMA rounded once, via float64), sum s in
    the same order, then w * (1 - S) + acc.  The flags plant the faults
    that chip_smoke's mutants plant in the CUDA source."""
    C = ws.shape[0] - (1 if skip_last else 0)
    acc = np.zeros(w.shape, np.float32)
    S = np.float32(0)
    for c in range(C):
        acc = (s[c].astype(np.float64) * ws[c].astype(np.float64)
               + acc.astype(np.float64)).astype(np.float32)
        S = np.float32(S + s[c])
    keep = np.float32(1) - (np.float32(0) if no_sum else S)
    out = (w.astype(np.float64) * np.float64(keep)
           + acc.astype(np.float64)).astype(np.float32)
    if ragged_tail:
        out[-ragged_tail:] = 0.0        # never written
    return out


@pytest.mark.parametrize("C,M", [(40, 257), (40, 2400), (8, 16385)])
def test_kernel_tolerance_admits_rounding_and_rejects_faults(C, M):
    """A model of the kernel's rounding passes the bound; the three
    planted faults (last client skipped, ragged tail unwritten, sum of s
    taken as 0) fail it, on the paper's s = mask p E with p = 1/C."""
    w, ws, _ = _inputs(C, M, seed=M)
    E = np.array([1, 5, 10, 20] * (C // 4 + 1))[:C].astype(np.float32)
    mask = np.ones(C, np.float32)
    s = mask * np.float32(1.0 / C) * E
    tx = tuple(torch.tensor(a) for a in (w, ws, s))
    want = agg.fused_agg_plain(*tx)
    ok, ratio = _within(torch.tensor(_kernel_model(w, ws, s)), want, tx)
    assert ok and ratio < 0.5, ratio
    for fault in ({"skip_last": True}, {"ragged_tail": 1}, {"no_sum": True}):
        ok, ratio = _within(torch.tensor(_kernel_model(w, ws, s, **fault)),
                            want, tx)
        assert not ok and ratio > 10, (fault, ratio)


def _leaf(M, C=3, dtype=torch.float32, offset=0):
    """(w, w_stack, out) of one leaf; ``offset`` elements into a larger
    buffer, so the rows start off a 16-byte boundary."""
    w = torch.zeros(M + offset, dtype=dtype)[offset:]
    ws = torch.zeros(C, M, dtype=dtype)
    return w, ws, torch.zeros(M, dtype=dtype)


def test_segment_table_block_offsets_and_vector_widths():
    """Each row starts where the blocks of the rows before it end (a block
    takes THREADS * vec elements); vec is 4 only where M % 4 == 0 and the
    rows are aligned."""
    leaves = [_leaf(1024), _leaf(1025), _leaf(10), _leaf(4096, offset=1),
              _leaf(1)]
    (dtype, rows), = agg.segment_table(leaves)
    assert dtype == torch.float32
    assert [r[3] for r in rows] == [1024, 1025, 10, 4096, 1]
    assert [r[5] for r in rows] == [4, 1, 1, 1, 1]
    assert [r[4] for r in rows] == [0, 1, 6, 7, 23]
    for (w, ws, out, *_), leaf in zip(rows, leaves):
        assert w is leaf[0] and ws is leaf[1] and out is leaf[2]


def test_segment_table_one_launch_per_dtype():
    """The CNN tree's ten leaves are one launch; a bf16 leaf among them
    starts its own group (numbered from block 0); more than MAX_SEGMENTS
    leaves of one dtype split."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    params = get_model(get_config("cifar-cnn")).init_params(
        torch.Generator().manual_seed(0))
    leaves = [(w.reshape(-1), torch.zeros(2, w.numel()),
               torch.empty(w.numel())) for w in
              (params[n][l] for n in params for l in params[n])]
    assert len(leaves) == 10 and len(agg.segment_table(leaves)) == 1
    mixed = leaves[:3] + [_leaf(300, dtype=torch.bfloat16)] + leaves[3:]
    groups = agg.segment_table(mixed)
    assert [g[0] for g in groups] == [torch.float32, torch.bfloat16]
    assert len(groups[0][1]) == 10 and groups[1][1][0][4] == 0
    many = agg.segment_table([_leaf(8)] * (agg.MAX_SEGMENTS + 1))
    assert [len(rows) for _, rows in many] == [agg.MAX_SEGMENTS, 1]
    assert many[1][1][0][4] == 0


def test_tree_wrapper_refuses_cpu_tensors_before_any_build(monkeypatch):
    """The card's tree wrapper checks every leaf before it loads (and so
    builds) the kernel library: a CPU tensor raises and nothing is
    built."""
    from repro_torch.kernels import build

    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(build, "load", no_build)
    tree = {"a": torch.zeros(4, 5), "b": torch.zeros(3)}
    stack = {"a": torch.zeros(2, 4, 5), "b": torch.zeros(2, 3)}
    before = agg.fused_agg_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        agg.fused_agg_tree_cuda(tree, stack, torch.zeros(2))
    assert agg.fused_agg_cuda.launches == before
