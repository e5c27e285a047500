"""Flash attention (causal / sliding-window, online softmax): the Hopper
kernel's wrapper and its plain PyTorch version.

Port of ``repro/kernels/flash_attention.py``.  The kernel lives in
``csrc/flash_attention.cu`` (CUDA C++ for ``sm_90a``, built by
``kernels/build.py`` and bound through ``ctypes``); its source note says what
it replaces and what bounds it on the card.

* ``flash_attention_cuda`` launches the kernel on PyTorch's current stream.
  It takes CUDA tensors only and raises on anything the kernel does not
  take; it never falls back to the plain version.  ``.launches`` counts its
  launches.
* ``flash_attention_plain`` is the same function in plain PyTorch, with the
  kernel's tiles (``tile_sizes``), the same tile-level skip, the same
  padded-KV guard and the same finite ``NEG_INF`` masking.  The CPU path
  and the on-card kernel check use it; ``kernel_tolerance`` is the bound
  the check holds the kernel to.

Both take q (B, Sq, H, D) and k, v (B, Skv, K, D) with H % K == 0: query
head h attends with KV head h // (H / K), which is what the reference's
``repeat_kv`` before the call computes.  Positions run from 0 on both sides.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (query rows, keys) of a tile, per (dtype, head dim): the instantiations
# csrc/flash_attention.cu's C entry picks, chosen by measurement
# (probes/flash_tiles.py).
# bf16: 64 x 64 (one consumer warpgroup, 3 or 2 blocks an SM) up to
# D = 128; 128 x 64 at D = 256 (two consumer warpgroups; Q and two stages
# of K and V fill 192 KB).  fp32: 64 x 64, and 32 query rows at D = 256
# (the FMA loop's output rows stay in registers).
_TILES = {
    (torch.bfloat16, 64): (64, 64),
    (torch.bfloat16, 128): (64, 64),
    (torch.bfloat16, 256): (128, 64),
    (torch.float32, 64): (64, 64),
    (torch.float32, 128): (64, 64),
    (torch.float32, 256): (32, 64),
}
# tiles the plain version takes for a head dim or dtype the kernel does not
# take (the CPU path only)
_OTHER_TILES = (64, 64)


def tile_sizes(D: int, dtype) -> tuple:
    """(block_q, block_k) of the kernel for head dim ``D`` and ``dtype``;
    raises for a head dim or dtype the kernel does not take."""
    if dtype not in DTYPES:
        raise ValueError(f"flash_attention: dtype {dtype} not supported "
                         f"(float32, bfloat16)")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not supported "
                         f"{HEAD_DIMS}")
    return _TILES[(dtype, D)]


def _check_heads(H: int, K: int):
    if K < 1 or H % K:
        raise ValueError(f"query heads ({H}) must be a multiple of KV heads "
                         f"({K})")


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          block_q: int | None = None,
                          block_k: int | None = None):
    """Plain PyTorch flash attention; returns (B, Sq, H, D) in q's dtype.

    The loop runs over KV tiles and is vectorised over query rows; a row
    takes a tile's update only if the tile is live for the row's query tile
    (the kernel's skip of fully masked tiles).  That skip changes the result
    only for rows with no visible key at all, which it leaves as the
    kernel does.  The tiles default to the kernel's (``tile_sizes``).
    """
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    _check_heads(H, K)
    tiles = _TILES.get((q.dtype, D), _OTHER_TILES)
    block_q = tiles[0] if block_q is None else block_q
    block_k = tiles[1] if block_k is None else block_k
    scale = 1.0 / (D ** 0.5)
    g = H // K
    qf = q.float().transpose(1, 2)                               # (B,H,Sq,D)
    kf = k.float().repeat_interleave(g, dim=2).transpose(1, 2)   # (B,H,Skv,D)
    vf = v.float().repeat_interleave(g, dim=2).transpose(1, 2)
    nk = -(-Skv // block_k)
    pad = nk * block_k - Skv
    # padded-KV guard: the ragged tail's keys are masked below and its
    # values are zero, so they add nothing to acc
    kf = F.pad(kf, (0, 0, 0, pad))
    vf = F.pad(vf, (0, 0, 0, pad))

    dev = q.device
    q_pos = torch.arange(Sq, device=dev)
    q_lo = q_pos // block_q * block_q                 # first row of its tile
    q_hi = q_lo + block_q - 1
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=dev)
    for ik in range(nk):
        k0 = ik * block_k
        live = torch.ones(Sq, dtype=torch.bool, device=dev)
        if causal:
            live &= k0 <= q_hi
        if window > 0:
            live &= k0 + block_k - 1 > q_lo - window
        if not bool(live.any()):
            continue
        k_pos = k0 + torch.arange(block_k, device=dev)
        s = qf @ kf[:, :, k0:k0 + block_k].transpose(-1, -2) * scale
        mask = (k_pos < Skv)[None, :]
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        if window > 0:
            mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + p.sum(-1)
        acc_new = acc * alpha[..., None] + p @ vf[:, :, k0:k0 + block_k]
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live[:, None], acc_new, acc)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).contiguous().to(q.dtype)


def visible_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the mask keeps, positions from 0 on both
    sides: key j is visible to query i where j < Skv, j <= i if
    ``causal``, and i - j < ``window`` if ``window`` > 0."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i + 1, Skv) if causal else np.full(Sq, Skv)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(Sq)
    return int(np.maximum(hi - lo, 0).sum())


def work_flops(B: int, Sq: int, Skv: int, H: int, D: int, causal: bool,
               window: int) -> int:
    """The FLOPs of the function: two products of D over each visible
    (query, key) pair (``visible_pairs``), for every batch row and query
    head; what the kernel computes once its masked tiles are skipped."""
    return 4 * B * H * D * visible_pairs(Sq, Skv, causal, window)


def kernel_tolerance(q, k, v, want, *, causal: bool = True, window: int = 0):
    """Per-element bound on |kernel - plain version| for the same inputs,
    given ``want`` = ``flash_attention_plain(q, k, v, ...)``.

    fp32: the reference's 2e-5 + 2e-5 |want| (sum order only).  bf16: the
    kernel rounds each p to bf16 (unit roundoff 2^-9) before P V, so its
    fp32 output moves by at most 2^-9 sum_k p_k |v_k| / l, which is
    attention with |v| as values; both outputs are then rounded to bf16,
    which 2e-2 |want| covers (one bf16 ulp is at most 2^-7 |x|).  The
    bound takes twice the first term:
    2^-8 attention(q, k, |v|) + 2e-2 |want|.
    """
    want = want.float()
    if q.dtype == torch.float32:
        return 2e-5 + 2e-5 * want.abs()
    spread = flash_attention_plain(q, k, v.abs(), causal=causal,
                                   window=window).float()
    return 2.0 ** -8 * spread + 2e-2 * want.abs()


@functools.cache
def _kernel():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 9
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_inputs(q, k, v, window):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention_cuda: {name} is on {t.device}; "
                             f"the kernel takes CUDA tensors")
        if t.device != q.device:
            raise ValueError(f"flash_attention_cuda: {name} is on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention_cuda: {name} is {t.dtype}, "
                             f"q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention_cuda: {name} must be "
                             f"(B, S, heads, D), got {tuple(t.shape)}")
    B, Sq, H, D = q.shape
    tile_sizes(D, q.dtype)
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention_cuda: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    _check_heads(H, k.shape[2])
    if Sq < 1 or k.shape[1] < 1:
        raise ValueError("flash_attention_cuda: empty sequence")
    if window < 0:
        raise ValueError(f"flash_attention_cuda: window {window} < 0")
    vec = 16 // q.element_size()        # 16-byte loads and TMA boxes
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention_cuda: {name}'s head dim must "
                             f"be contiguous (strides {t.stride()})")
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"flash_attention_cuda: {name} must be 16-byte "
                             f"aligned with strides in multiples of {vec} "
                             f"(strides {t.stride()})")
        # bf16 is read by TMA, whose strides are positive; fp32 by pointers
        if q.dtype == torch.bfloat16 and any(
                st == 0 and n > 1 for st, n in zip(t.stride()[:3], t.shape)):
            raise ValueError(f"flash_attention_cuda: bf16 {name} has stride "
                             f"0 along a dimension of size > 1 (an expanded "
                             f"view, strides {t.stride()}); make it "
                             f"contiguous")


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0):
    """Launch the Hopper kernel (its tiles: ``tile_sizes``); returns a
    contiguous (B, Sq, H, D) tensor in q's dtype.  Raises on a launch
    error."""
    window = int(window)
    _check_cuda_inputs(q, k, v, window)
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lib = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPES[q.dtype], B, Sq, Skv, H, K, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(bool(causal)), window, 1.0 / (D ** 0.5), stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed "
                           f"({err}: {msg}) for q {tuple(q.shape)} "
                           f"k {tuple(k.shape)} {q.dtype}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
