"""The port's SSD scan against the JAX Pallas kernel (interpret mode, as
``tests/test_kernels.py`` runs it), ``ref.ssd_reference`` and the
reference model's ``ssd_chunked``, on the same numpy inputs; and
``kernel_tolerance`` against planted faults.

Tolerances are the reference's own (``test_kernels.py``): 2e-5 for fp32
(sum order), 5e-2 for bf16 (inputs and the output rounded to bf16).  The
CUDA kernel itself runs only on the card: ``test_torch_kernels_cuda.py``
and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ss

TOL = {"float32": 2e-5, "bfloat16": 5e-2}


def _inputs(B, S, H, P, N, dtype, G=None, seed=0, dt_shift=0.0):
    """numpy inputs as the reference sweep draws them (dt softplus'd, A
    negative), cast to ``dtype`` identically in both packages."""
    r = np.random.default_rng(seed)
    G = G or H
    x = (r.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    dt = np.logaddexp(r.standard_normal((B, S, H)) + dt_shift, 0.0)
    A = -np.exp(r.standard_normal(H) * 0.3)
    Bm = (r.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    Cm = (r.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    arrays = (x, dt.astype(np.float32), A.astype(np.float32), Bm, Cm)
    cast = (dtype, "float32", "float32", dtype, dtype)
    jx = tuple(jnp.asarray(a).astype(c) for a, c in zip(arrays, cast))
    tx = tuple(torch.tensor(a).to(getattr(torch, c))
               for a, c in zip(arrays, cast))
    return jx, tx


def _np(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 32, 1, 8, 4, 8), (2, 64, 4, 16, 8, 16), (1, 128, 2, 32, 16, 32),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel(B, S, H, P, N, chunk, dtype):
    """The reference sweep: the port's scan (its plain version on the CPU)
    against the Pallas kernel and the sequential oracle of both packages."""
    J, T = _inputs(B, S, H, P, N, dtype)
    want = jops.ssd_scan(*J, chunk=chunk, interpret=True)
    oracle = jref.ssd_reference(*J)
    got = ops.ssd_scan_y(*T, chunk=chunk)
    assert got.dtype == T[0].dtype and got.shape == T[0].shape
    tol = TOL[dtype]
    for w in (want, oracle, ref.ssd_reference(*T)):
        np.testing.assert_allclose(_np(got), _np(w), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(ref.ssd_reference(*T)), _np(oracle),
                               rtol=tol, atol=tol)
    y, h = ss.ssd_scan_plain(*T, chunk=chunk)
    assert y.dtype == h.dtype == torch.float32
    assert tuple(h.shape) == (B, H, P, N)


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_final_state_matches_ssd_chunked(G, dtype):
    """y in fp32 and the final state against the reference model's
    ``ssd_chunked`` (which returns both), at G = 1 (the mamba2-1.3b layout:
    head h reads group h // (H / G)) and G = H (pre-repeated)."""
    J, T = _inputs(2, 64, 4, 16, 8, dtype, G=G, seed=1)
    jy, jh = jssm.ssd_chunked(*J, 16)
    ty, th = ops.ssd_scan(*T, chunk=16)
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(th), _np(jh), rtol=2e-5, atol=2e-5)


def test_state_carries_across_chunks():
    """A decay near 1 makes early tokens reach late chunks (the reference's
    state-carry test)."""
    B, S, H, P, N = 1, 64, 1, 4, 4
    x = np.zeros((B, S, H, P), np.float32)
    x[:, 0] = 1.0
    dt = np.full((B, S, H), 0.05, np.float32)
    A = np.asarray([-0.01], np.float32)
    ones = np.ones((B, S, H, N), np.float32)
    J = [jnp.asarray(a) for a in (x, dt, A, ones, ones)]
    T = [torch.tensor(a) for a in (x, dt, A, ones, ones)]
    want = jref.ssd_reference(*J)
    got = ops.ssd_scan_y(*T, chunk=16)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    assert abs(float(got[0, -1, 0, 0])) > 1e-3    # late chunk sees token 0


def test_overflowing_upper_triangle_is_dropped():
    """Steep decays: above the diagonal exp(cum_t - cum_s) overflows to inf
    in the reference's unmasked tile.  The port's scan stays finite and
    agrees with the reference wherever the reference is finite, and with
    the sequential oracle everywhere."""
    J, T = _inputs(1, 128, 2, 8, 4, "float32", seed=2, dt_shift=3.0)
    dA = _np(T[1]) * _np(T[2])[None, None]
    assert dA.reshape(1, 2, 64, 2).sum(axis=2).min() < -89   # exp(-x) > max
    jy, _ = jssm.ssd_chunked(*J, 64)
    ty, th = ops.ssd_scan(*T, chunk=64)
    assert bool(torch.isfinite(ty).all()) and bool(torch.isfinite(th).all())
    fin = np.isfinite(_np(jy))
    np.testing.assert_allclose(_np(ty)[fin], _np(jy)[fin], rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(_np(ty), _np(ref.ssd_reference(*T)),
                               rtol=2e-5, atol=2e-5)


def test_strided_inputs_and_groups_are_read_in_place():
    """x, Bm and Cm as slices of one wider tensor (as the model hands them
    over) give the same result as contiguous copies."""
    r = np.random.default_rng(3)
    B, S, H, P, G, N = 2, 32, 4, 8, 2, 8
    wide = torch.tensor(r.standard_normal((B, S, H * P + 2 * G * N + 3)),
                        dtype=torch.float32) * 0.3
    x = wide[..., :H * P].reshape(B, S, H, P)
    Bm = wide[..., H * P:H * P + G * N].reshape(B, S, G, N)
    Cm = wide[..., H * P + G * N:H * P + 2 * G * N].reshape(B, S, G, N)
    assert not x.is_contiguous() and not Bm.is_contiguous()
    dt = torch.nn.functional.softplus(torch.randn(B, S, H))
    A = -torch.rand(H)
    a = ss.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=8)
    b = ss.ssd_scan_plain(x.contiguous(), dt, A, Bm.contiguous(),
                          Cm.contiguous(), chunk=8)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)


def test_dispatch_and_checks():
    _, T = _inputs(1, 32, 2, 8, 4, "float32")
    torch.testing.assert_close(ops.ssd_scan(*T, chunk=8)[0],
                               ss.ssd_scan_plain(*T, chunk=8)[0])
    with pytest.raises(ValueError, match="CUDA tensors"):
        ss.ssd_scan_cuda(*T, chunk=8)
    meta = tuple(t.to("meta") for t in T)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.ssd_scan(*meta, chunk=8)
    with pytest.raises(ValueError, match="not divisible by chunk"):
        ops.ssd_scan(*T, chunk=12)
    x, dt, A, Bm, Cm = T
    with pytest.raises(ValueError, match="multiple of groups"):
        ops.ssd_scan(x, dt, A, Bm.repeat(1, 1, 3, 1),
                     Cm.repeat(1, 1, 3, 1), chunk=8)      # H = 2, G = 6
    with pytest.raises(ValueError, match="dt >= 0"):
        ss.kernel_tolerance(x, -dt, A, Bm, Cm, chunk=8)


# ------------------------------------------------------- kernel_tolerance --

def _exact(x, dt, A, Bm, Cm, chunk):
    """The chunked scan in float64 (numpy) on the float32 exp(.) arguments
    that the kernel and the plain version share (``chunk_cumsum`` of the
    float32 dt A, and their float32 differences): y and the final state,
    the exact values both float32 versions approximate."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2:]
    Q, nC = chunk, S // chunk
    cum = ss.chunk_cumsum((dt.float() * A.float()).reshape(B, nC, Q, H))
    diff = (cum[:, :, :, None] - cum[:, :, None]).double().numpy()
    seg = (cum[:, :, -1:] - cum).double().numpy()
    cum = cum.double().numpy()
    x, dt, Bm, Cm = (t.double().numpy().reshape(B, nC, Q, *t.shape[2:])
                     for t in (x, dt, Bm, Cm))
    Bh, Ch = np.repeat(Bm, H // G, axis=3), np.repeat(Cm, H // G, axis=3)
    decay = np.where(np.tril(np.ones((Q, Q), bool))[None, None, :, :, None],
                     np.exp(np.minimum(diff, 0.0)), 0.0)
    M = np.einsum("bcqhn,bcshn->bcqsh", Ch, Bh) * decay * dt[:, :, None]
    y = np.einsum("bcqsh,bcshp->bcqhp", M, x)
    h = np.zeros((B, H, P, N))
    for ic in range(nC):
        y[:, ic] += np.einsum("bqhn,bhpn,bqh->bqhp", Ch[:, ic], h,
                              np.exp(cum[:, ic]))
        h = (h * np.exp(cum[:, ic, -1])[..., None, None]
             + np.einsum("bqh,bqhn,bqhp->bhpn",
                         np.exp(seg[:, ic]) * dt[:, ic], Bh[:, ic], x[:, ic]))
    return y.reshape(B, S, H, P), h


def _round(t, fmt):
    """float32 ``t`` rounded to bf16 or TF32 (10 mantissa bits, nearest,
    ties away), back in float32."""
    if fmt == "bf16":
        return t.to(torch.bfloat16).float()
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(t, k):
    """float32 ``t`` as the kernel's k-term bf16 split represents it: the
    sum, in float64, of k bf16 terms, each the bf16 rounding of what the
    terms before it leave (the residuals are exact in float32)."""
    total, rest = torch.zeros_like(t, dtype=torch.float64), t.float()
    for _ in range(k):
        term = rest.to(torch.bfloat16).float()
        total, rest = total + term.double(), rest - term
    return total.float()


def _planted(x, dt, A, Bm, Cm, chunk, *, mask="causal", carry=True,
             round_m=None, round_state=None, split_m=None, split_state=None):
    """The chunked scan with a planted fault: ``mask`` "none" keeps the
    upper triangle, "strict" drops the diagonal; ``carry=False`` restarts
    every chunk from a zero state (drops the inter-chunk term);
    ``round_m`` / ``round_state`` ("bf16", "tf32") round the weights M of
    the intra-chunk product, or the state update's x dt exp(.) operand,
    before multiplying (what a tensor-core product without a split does).
    ``split_m`` / ``split_state`` = k replace M, or the state update's
    operand and the carried state of C h^T, by their k-term bf16 split
    (``_split``): what the kernel's tensor-core products multiply."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2:]
    Q, nC = chunk, S // chunk
    c = lambda t: t.float().reshape(B, nC, Q, *t.shape[2:])
    xh, d = c(x), c(dt)
    Bh = c(Bm).repeat_interleave(H // G, 3)
    Ch = c(Cm).repeat_interleave(H // G, 3)
    cum = ss.chunk_cumsum(d * A)
    tri = {"causal": torch.ones(Q, Q).tril(), "none": torch.ones(Q, Q),
           "strict": torch.ones(Q, Q).tril(-1)}[mask].bool()
    decay = torch.where(tri[None, None, :, :, None],
                        torch.exp(cum[:, :, :, None] - cum[:, :, None]), 0.0)
    M = torch.einsum("bcqhn,bcshn->bcqsh", Ch, Bh) * decay * d[:, :, None]
    if round_m:
        M = _round(M, round_m)
    if split_m:
        M = _split(M, split_m)
    y = torch.einsum("bcqsh,bcshp->bcqhp", M, xh)
    xw = (torch.exp(cum[:, :, -1:] - cum) * d)[..., None] * xh
    if round_state:
        xw = _round(xw, round_state)
    if split_state:
        xw = _split(xw, split_state)
    dBx = torch.einsum("bcqhn,bcqhp->bchpn", Bh, xw)
    h = torch.zeros(B, H, P, N)
    for ic in range(nC):
        if carry:
            hc = _split(h, split_state) if split_state else h
            y[:, ic] += torch.einsum("bqhn,bhpn,bqh->bqhp", Ch[:, ic], hc,
                                     torch.exp(cum[:, ic]))
        else:
            h = torch.zeros(B, H, P, N)
        h = h * torch.exp(cum[:, ic, -1])[..., None, None] + dBx[:, ic]
    return y.reshape(B, S, H, P), h


@pytest.mark.parametrize("G,chunk,dt_shift", [(1, 16, 0.0), (4, 32, -2.0)])
def test_kernel_tolerance_holds_and_rejects_planted_faults(G, chunk,
                                                            dt_shift):
    """The bound covers the plain version's own distance from exact
    arithmetic on the exp(.) arguments both versions share (it is twice a
    one-evaluation bound) and rejects a dropped
    inter-chunk term, an unmasked upper triangle and an off-by-one causal
    mask, in y; and a state not carried, in the final state."""
    _, T = _inputs(2, 128, 4, 8, 16, "float32", G=G, seed=4,
                   dt_shift=dt_shift)
    y, h = ss.ssd_scan_plain(*T, chunk=chunk)
    tol_y, tol_h = ss.kernel_tolerance(*T, chunk=chunk)
    ey, eh = _exact(*T, chunk)
    assert (np.abs(y.double().numpy() - ey) <= tol_y.numpy() / 2).all()
    assert (np.abs(h.double().numpy() - eh) <= tol_h.numpy() / 2).all()
    clean = _planted(*T, chunk)
    assert bool(((clean[0] - y).abs() <= tol_y).all())
    assert bool(((clean[1] - h).abs() <= tol_h).all())

    def rejected(got, want, tol):
        return bool(((got - want).abs() > tol).any())

    no_carry = _planted(*T, chunk, carry=False)
    assert rejected(no_carry[0], y, tol_y), "dropped inter-chunk term"
    assert rejected(no_carry[1], h, tol_h), "state not carried"
    assert rejected(_planted(*T, chunk, mask="none")[0], y, tol_y), \
        "unmasked upper triangle"
    assert rejected(_planted(*T, chunk, mask="strict")[0], y, tol_y), \
        "off-by-one causal mask"


SPLITS = (f"split{ss.SPLIT_TERMS}", f"split{ss.SPLIT_TERMS - 1}")


@pytest.mark.parametrize("where,fmt", [
    ("M", "bf16"), ("M", "tf32"), ("state", "tf32"),
    *(("M", f) for f in SPLITS), *(("state", f) for f in SPLITS)])
def test_kernel_tolerance_rejects_rounded_products(where, fmt):
    """At mamba2-1.3b's chunk (256) and state size (128), bf16 x, B and C,
    where a chunk's sum of |dt A| reaches the hundreds, the bound still
    holds a clean scan and rejects one that rounds the intra-chunk weights
    M, or the state update's x dt exp(.) operand, to bf16 or TF32.  The
    kernel's split ("split<k>": M, or the state operands, as k bf16 terms)
    passes it with ``ssd_scan.SPLIT_TERMS`` terms, at under a quarter of
    the bound, and is rejected with one term fewer."""
    _, T = _inputs(1, 512, 4, 16, 128, "bfloat16", G=1, seed=5)
    y, h = ss.ssd_scan_plain(*T, chunk=256)
    tol_y, tol_h = ss.kernel_tolerance(*T, chunk=256)
    clean = _planted(*T, 256)
    assert bool(((clean[0] - y).abs() <= tol_y).all())
    assert bool(((clean[1] - h).abs() <= tol_h).all())
    if fmt.startswith("split"):
        k = int(fmt[len("split"):])
        got = _planted(*T, 256, **{"split_m" if where == "M"
                                   else "split_state": k})
        ratio = max(float(((g - w).abs() / t).max())
                    for g, w, t in ((got[0], y, tol_y), (got[1], h, tol_h)))
        if k == ss.SPLIT_TERMS:
            assert ratio <= 0.25, f"{k}-term {where} split at {ratio:.3f}"
        else:
            assert ratio > 1, f"{k}-term {where} split passed ({ratio:.3f})"
        return
    if where == "M":
        got, want, tol = _planted(*T, 256, round_m=fmt)[0], y, tol_y
    else:
        got, want, tol = _planted(*T, 256, round_state=fmt)[1], h, tol_h
    assert bool(((got - want).abs() > tol).any()), f"{fmt} {where} passed"
