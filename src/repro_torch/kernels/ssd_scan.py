"""Mamba2's chunked SSD scan (state-space duality): the Hopper kernel's
wrapper and its plain PyTorch version.

Port of ``repro/kernels/ssd_scan.py``.  The kernel lives in
``csrc/ssd_scan.cu`` (CUDA C++ for ``sm_90a``, built by ``kernels/build.py``
and bound through ``ctypes``); its source note says what it replaces and
what bounds it on the card.  In bf16 it runs as three launches (the
chunks' state updates in parallel, their recurrence, then y chunk by chunk
in parallel) on ``wgmma`` with TMA loads, its fp32 operands split into
``SPLIT_TERMS`` bf16 terms; fp32 inputs take FMA loops on the CUDA cores.

* ``ssd_scan_cuda`` launches the kernel on PyTorch's current stream.  It
  takes CUDA tensors only and raises on anything the kernel does not take;
  it never falls back to the plain version.  ``.launches`` counts its
  calls (one a call, whatever the number of launches inside it).
* ``ssd_scan_plain`` is the same function in plain PyTorch: the chunked
  einsums of the reference's ``models.ssm.ssd_chunked``, with its masked
  ``where(mask, exp(diff), 0)``, and the kernel's prefix sums of dt A
  (``chunk_cumsum``).  The CPU path, ``impl="ref"`` and the on-card kernel
  check use it; ``kernel_tolerance`` is the bound the check holds the
  kernel to.

Both take x (B, S, H, P) in bf16 or fp32, dt (B, S, H) fp32 (softplus'd
step sizes, >= 0), A (H,) fp32 (negative decay rates) and Bm, Cm
(B, S, G, N) in x's dtype with H % G == 0: head h reads group h // (H / G),
which is what the reference's ``repeat`` to heads computes.  Both return y
(B, S, H, P) in fp32 (the model adds D x and the gated norm to it before
any rounding) and the final state h (B, H, P, N) in fp32, which the decode
cache keeps.  ``chunk`` must divide S.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 128                     # csrc/ssd_scan.cu NMAX
MAX_HEAD_DIM_BF16 = 64              # csrc/ssd_scan.cu PMAX_BF16
# bf16 terms of each fp32 operand of the bf16 path's tensor-core products
# (M, the state update's x dt exp(.), the carried state in C h^T).  It
# mirrors the two terms csrc/ssd_scan.cu hardcodes (hi and lo): changing it
# does not change the kernel, only the CPU model of the split and the bound.
SPLIT_TERMS = 2


def _check_shapes(x, dt, A, Bm, Cm, chunk: int):
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (B, S, H, P), got "
                         f"{tuple(x.shape)}")
    Bsz, S, H, P = x.shape
    if tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)} / A "
                         f"{tuple(A.shape)} do not match x {tuple(x.shape)}")
    if (Bm.dim() != 4 or Bm.shape != Cm.shape
            or tuple(Bm.shape[:2]) != (Bsz, S)):
        raise ValueError(f"ssd_scan: Bm {tuple(Bm.shape)} / Cm "
                         f"{tuple(Cm.shape)} must be (B, S, G, N) with x's "
                         f"B and S")
    G = Bm.shape[2]
    if G < 1 or H % G:
        raise ValueError(f"ssd_scan: heads ({H}) must be a multiple of "
                         f"groups ({G})")
    if chunk < 1 or S % chunk:
        raise ValueError(f"ssd_scan: seq {S} not divisible by chunk {chunk}")


def chunk_cumsum(dA):
    """Within-chunk prefix sums of dA (B, nC, Q, H) float32 along Q, in
    float64 in the kernel's order, each rounded once to float32: a 32-lane
    Hillis-Steele scan over each block of 32 rows (``v_i += v_(i-o)`` for
    o = 1, 2, 4, 8, 16), then the previous block's last sum added.  Float64
    addition is correctly rounded on every device, so ``csrc/ssd_scan.cu``
    and this function return the same float32 values bit for bit, and
    every exp(.) of the kernel and of the plain version sees the same
    argument (``kernel_tolerance`` relies on it)."""
    Q = dA.shape[2]
    v = torch.nn.functional.pad(dA.double().movedim(2, -1), (0, -Q % 32))
    v = v.unflatten(-1, (-1, 32))                            # (..., Q/32, 32)
    for o in (1, 2, 4, 8, 16):
        v = torch.cat([v[..., :o], v[..., o:] + v[..., :-o]], dim=-1)
    blocks, carry = [], torch.zeros_like(v[..., 0, :1])
    for k in range(v.shape[-2]):
        blocks.append(v[..., k, :] + carry)
        carry = blocks[-1][..., 31:]
    cum = torch.stack(blocks, dim=-2).flatten(-2)[..., :Q]
    return cum.float().movedim(-1, 2)


def ssd_scan_plain(x, dt, A, Bm, Cm, *, chunk: int):
    """Plain PyTorch chunked SSD scan; returns (y (B, S, H, P) fp32, final
    state (B, H, P, N) fp32).  The reference's ``ssd_chunked``, einsum for
    einsum, with two changes that the kernel makes too: the within-chunk
    prefix sums of dt A are taken in float64 in the kernel's order and
    rounded once to float32 (``chunk_cumsum``: the kernel and this version
    exponentiate the same arguments), and a chunk's decay is exp(cum at its
    last row) rather than exp of a separate sum.  Its inter-chunk scan is a
    Python loop over chunks."""
    _check_shapes(x, dt, A, Bm, Cm, chunk)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q, nC, rep = chunk, S // chunk, H // G

    def c(t):
        return t.float().reshape(Bsz, nC, Q, *t.shape[2:])

    xh, dt_ = c(x), c(dt)
    Bh = c(Bm).repeat_interleave(rep, dim=3)                 # (B,nC,Q,H,N)
    Ch = c(Cm).repeat_interleave(rep, dim=3)

    dA = dt_ * A.float()[None, None, None, :]                # log-decay
    cum = chunk_cumsum(dA)                                   # within chunk

    # intra-chunk (dual) term: M[t, s] = C_t.B_s exp(cum_t - cum_s) dt_s,
    # s <= t; above the diagonal exp may overflow, and where() drops it
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nC,Q,Q,H)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    decay = torch.where(mask[None, None, :, :, None], torch.exp(diff), 0.0)
    CB = torch.einsum("bcqhn,bcshn->bcqsh", Ch, Bh)
    M = CB * decay * dt_[:, :, None, :, :]
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", M, xh)

    # chunk-final states: sum_s exp(cum_end - cum_s) dt_s x_s B_s^T
    seg = torch.exp(cum[:, :, -1:, :] - cum)                 # (B,nC,Q,H)
    dBx = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", seg * dt_, Bh, xh)

    # inter-chunk recurrence; h_prev[c] is the state before chunk c
    chunk_decay = torch.exp(cum[:, :, -1])                   # (B,nC,H)
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    h_prev = []
    for ic in range(nC):
        h_prev.append(h)
        h = h * chunk_decay[:, ic, :, None, None] + dBx[:, ic]
    h_prev = torch.stack(h_prev, dim=1)                      # (B,nC,H,P,N)

    y_inter = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Ch, h_prev,
                           torch.exp(cum))
    return (y_intra + y_inter).reshape(Bsz, S, H, P), h


def work_flops(B: int, S: int, H: int, P: int, G: int, N: int,
               chunk: int) -> int:
    """The FLOPs of the chunked scan, per chunk of Q = ``chunk`` rows: C.B
    over the causal pairs (Q(Q+1)/2 N products) once a (batch row,
    group), since it depends on neither dt nor A; and once a (batch row,
    head) M x over the causal pairs (Q(Q+1)/2 P), C.h and the state update
    (2 Q P N); two FLOPs a product.  The count of
    ``chip_smoke.ssd_work``."""
    Q, nC = chunk, S // chunk
    pairs = Q * (Q + 1) // 2
    cb = 2 * B * G * nC * pairs * N
    rest = 2 * B * H * nC * (pairs * P + 2 * Q * P * N)
    return cb + rest


def _gamma(n: int, u: float = 2.0 ** -24) -> float:
    return n * u / (1 - n * u)


def kernel_tolerance(x, dt, A, Bm, Cm, *, chunk: int):
    """Per-element bounds (tol_y, tol_h) on |kernel - plain version| for the
    same inputs, from the rounding of two float32 evaluations of the same
    sums in different orders.

    Both versions compute dt A in float32 and its within-chunk prefix sums
    in the same order (``chunk_cumsum``), so every exp(.) of either sees
    the same float32 argument, bit for bit; the bound holds them to exact
    arithmetic on those shared values.  Every output element is a sum of
    nonnegative-weighted products: ``ssd_scan_plain`` on |x|, |Bm|, |Cm|
    (the decays exp(.) and dt are >= 0) gives the sum of their absolute
    values, ``W``.  In one float32 evaluation each term is off by a factor
    within ``e^eta - 1`` of one, ``eta = gamma_d + (nC + 2) 4u``:
    * ``d = 2N + Q + 2 nC + 8`` bounds the additions and multiplications
      any term passes through (C.B over N, the sum over a chunk's Q rows,
      C.h over N, two per chunk step of the state, and a few products);
    * each exp(.) is off by at most two ulps (``4u``), and a term passes
      through at most ``nC + 2`` of them (its own chunk's decay, one per
      chunk step, exp(cum_t)).
    The bound is twice that, since both versions are off, over ``2 -
    e^eta``, since W is such an evaluation too.  Requires dt >= 0.
    """
    if bool((dt < 0).any()):
        raise ValueError("kernel_tolerance: needs dt >= 0 (softplus output)")
    _check_shapes(x, dt, A, Bm, Cm, chunk)
    N, Q = Bm.shape[3], chunk
    nC = x.shape[1] // Q
    eta = _gamma(2 * N + Q + 2 * nC + 8) + (nC + 2) * 4 * 2.0 ** -24
    if eta >= 0.25:
        raise ValueError(f"kernel_tolerance: no useful bound (eta {eta:.3g})")
    rel = math.expm1(eta) / (1 - math.expm1(eta))
    w_y, w_h = ssd_scan_plain(x.abs(), dt, A, Bm.abs(), Cm.abs(),
                              chunk=chunk)
    return 2 * rel * w_y, 2 * rel * w_h


@functools.cache
def _kernel():
    lib = build.load("ssd_scan")
    fn = lib.ssd_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong] * 9 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.ssd_scan_workspace_bytes.argtypes = [ctypes.c_int] * 7
    lib.ssd_scan_workspace_bytes.restype = ctypes.c_longlong
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_inputs(x, dt, A, Bm, Cm, chunk):
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if t.device.type != "cuda":
            raise ValueError(f"ssd_scan_cuda: {name} is on {t.device}; the "
                             f"kernel takes CUDA tensors")
        if t.device != x.device:
            raise ValueError(f"ssd_scan_cuda: {name} is on {t.device}, x on "
                             f"{x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"ssd_scan_cuda: dtype {x.dtype} not supported "
                         f"(float32, bfloat16)")
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if t.dtype != x.dtype:
            raise ValueError(f"ssd_scan_cuda: {name} is {t.dtype}, x is "
                             f"{x.dtype}")
    for name, t in (("dt", dt), ("A", A)):
        if t.dtype != torch.float32:
            raise ValueError(f"ssd_scan_cuda: {name} must be float32, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan_cuda: {name} must be contiguous "
                             f"(strides {t.stride()})")
    _check_shapes(x, dt, A, Bm, Cm, chunk)
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_scan_cuda: {name}'s last dim must be "
                             f"contiguous (strides {t.stride()})")
    if Bm.shape[3] > MAX_STATE:
        raise ValueError(f"ssd_scan_cuda: state size {Bm.shape[3]} > "
                         f"{MAX_STATE}")
    if x.dtype == torch.bfloat16:
        _check_tma_views(x, Bm, Cm)


def _check_tma_views(x, Bm, Cm):
    """What the bf16 path's TMA loads and tiles take: P <= 64, N a multiple
    of 8, 16-byte aligned bases and strides (in elements, multiples of 8)
    along every dimension of size > 1."""
    if x.shape[3] > MAX_HEAD_DIM_BF16:
        raise ValueError(f"ssd_scan_cuda: head dim {x.shape[3]} > "
                         f"{MAX_HEAD_DIM_BF16} in bfloat16")
    if Bm.shape[3] % 8:
        raise ValueError(f"ssd_scan_cuda: state size {Bm.shape[3]} is not a "
                         f"multiple of 8 in bfloat16")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.data_ptr() % 16 or any(
                st % 8 or st <= 0 for st, n in zip(t.stride()[:3], t.shape)
                if n > 1):
            raise ValueError(f"ssd_scan_cuda: bfloat16 {name} needs a 16-byte "
                             f"aligned base and positive strides that are "
                             f"multiples of 8 elements (strides "
                             f"{t.stride()})")


def ssd_scan_cuda(x, dt, A, Bm, Cm, *, chunk: int):
    """Launch the Hopper kernel; returns (y (B, S, H, P) fp32, final state
    (B, H, P, N) fp32), both contiguous.  x, Bm and Cm are read through
    their strides (their last dim contiguous): the model hands in slices of
    the conv output without copying.  Raises on a launch error
    (``cudaGetLastError``), which a chunk too long for one block's shared
    memory gives: a few floats a row beside the tiles, ~101 KB in bf16,
    ~108 KB in fp32.  In bf16 the call allocates a workspace of its own
    (the chunks' state updates and carried states, ~4 P N bytes a chunk
    and head, twice)."""
    chunk = int(chunk)
    _check_cuda_inputs(x, dt, A, Bm, Cm, chunk)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y = torch.empty((Bsz, S, H, P), dtype=torch.float32, device=x.device)
    h = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    lib = _kernel()
    dtype = DTYPES[x.dtype]
    nbytes = lib.ssd_scan_workspace_bytes(dtype, Bsz, S, H, P, N, chunk)
    work = (torch.empty(nbytes, dtype=torch.uint8, device=x.device)
            if nbytes else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), h.data_ptr(),
        None if work is None else work.data_ptr(),
        dtype, Bsz, S, H, P, G, N, chunk,
        *x.stride()[:3], *Bm.stride()[:3], *Cm.stride()[:3], stream)
    if err != 0:
        msg = lib.ssd_scan_error_string(err).decode()
        raise RuntimeError(f"ssd_scan kernel launch failed ({err}: {msg}) "
                           f"for x {tuple(x.shape)} Bm {tuple(Bm.shape)} "
                           f"{x.dtype} chunk {chunk}")
    ssd_scan_cuda.launches += 1
    return y, h


ssd_scan_cuda.launches = 0
