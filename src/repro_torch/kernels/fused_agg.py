"""The server's aggregation (eqs. 12-13): the Hopper kernel's wrapper and
its plain PyTorch version.

Port of ``repro/kernels/fused_agg.py``.  For ``w`` (M,), ``w_stack`` (C, M)
(both float32 or both bfloat16) and ``s`` (C,) float32, both return (M,) in
``w``'s dtype:

    out = w (1 - sum_c s_c) + sum_c s_c w_stack[c]

which is ``w + sum_c s_c (w_stack[c] - w)`` without the (C, M) deltas.

* ``fused_agg_cuda`` launches ``csrc/fused_agg.cu`` (built by
  ``kernels/build.py``, bound through ``ctypes``) on PyTorch's current
  stream.  It takes CUDA tensors only and raises on anything the kernel
  does not take; it never falls back to the plain version.
  ``fused_agg_tree_cuda`` does the same for every leaf of a tree in one
  launch per dtype (``segment_table``), each leaf bit for bit as
  ``fused_agg_cuda`` computes it.  ``fused_agg_cuda.launches`` counts the
  kernel's launches by both.
* ``fused_agg_plain`` computes the same expression in float32 PyTorch
  (elementwise products and sums, so no TF32 setting reaches it).  The CPU
  path and the on-card check use it; ``kernel_tolerance`` is the bound the
  check holds the kernel to.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.tree import tree_leaves, tree_map

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CLIENTS = 12288            # csrc/fused_agg.cu: s fits 48 KB of smem
VEC = 4                        # outputs per thread on the aligned path
THREADS = 256                  # csrc/fused_agg.cu: threads a block
MAX_SEGMENTS = 64              # csrc/fused_agg.cu: leaves a launch
U32 = 2.0 ** -24               # float32 unit roundoff


def fused_agg_plain(w, w_stack, s):
    """Plain PyTorch: the same function in float32; returns w's dtype."""
    s = s.float()
    mix = (s[:, None] * w_stack.float()).sum(dim=0)
    return (w.float() * (1.0 - s.sum()) + mix).to(w.dtype)


def kernel_tolerance(w, w_stack, s, want):
    """Per-element bound on |kernel - plain version| for the same inputs,
    given ``want`` = ``fused_agg_plain(w, w_stack, s)``.

    Both compute w (1 - S) + sum_c s_c w_c in float32 from the same
    inputs, in other orders.  To first order each is within (C + 2) u
    (|w| (1 + sum|s|) + sum_c |s_c| |w_c|) of the exact value, u = 2^-24:
    C - 1 roundings in each of the two sums over clients, plus the
    products, 1 - S, the product with w and the final add.  The two are
    within twice that of each other.  bfloat16 outputs are then rounded to
    bf16 on both sides; each moves by at most half an ulp of its own
    binade, and the kernel's can lie one binade above ``want``'s, so two
    bf16 ulps of ``want`` are added.
    """
    C = w_stack.shape[0]
    a = s.float().abs()
    scale = (w.float().abs() * (1.0 + a.sum())
             + (a[:, None] * w_stack.float().abs()).sum(dim=0))
    tol = 2.0 * (C + 2) * U32 * scale
    if want.dtype == torch.bfloat16:
        mag = want.float().abs().clamp_min(2.0 ** -126)
        _, e = torch.frexp(mag)                      # mag = m 2^e, m in [.5, 1)
        tol = tol + torch.ldexp(torch.ones_like(mag), e - 7)   # 2 ulps
    return tol


class Segment(ctypes.Structure):
    """A row of csrc/fused_agg.cu's segment table: one leaf."""
    _fields_ = [("w", ctypes.c_void_p), ("w_stack", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("M", ctypes.c_longlong),
                ("first_block", ctypes.c_longlong), ("vec", ctypes.c_int)]


@functools.cache
def _kernel():
    lib = build.load("fused_agg")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_agg.argtypes = [ptr] * 4 + [i, i, ctypes.c_longlong, i, ptr]
    lib.fused_agg.restype = i
    lib.fused_agg_segments.argtypes = [ctypes.POINTER(Segment), i, ptr, i, i,
                                       ptr]
    lib.fused_agg_segments.restype = i
    lib.fused_agg_error_string.argtypes = [ctypes.c_int]
    lib.fused_agg_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_inputs(w, w_stack, s):
    for name, t in (("w", w), ("w_stack", w_stack), ("s", s)):
        if t.device.type != "cuda":
            raise ValueError(f"fused_agg_cuda: {name} is on {t.device}; the "
                             f"kernel takes CUDA tensors")
        if t.device != w.device:
            raise ValueError(f"fused_agg_cuda: {name} is on {t.device}, w on "
                             f"{w.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_agg_cuda: {name} must be contiguous "
                             f"(strides {t.stride()})")
    if w.dtype not in DTYPES or w_stack.dtype != w.dtype:
        raise ValueError(f"fused_agg_cuda: w {w.dtype} / w_stack "
                         f"{w_stack.dtype}: both must be float32 or both "
                         f"bfloat16")
    if s.dtype != torch.float32:
        raise ValueError(f"fused_agg_cuda: s must be float32, got {s.dtype}")
    if w.dim() != 1 or w_stack.dim() != 2 or s.dim() != 1:
        raise ValueError(f"fused_agg_cuda: expected w (M,), w_stack (C, M), "
                         f"s (C,); got {tuple(w.shape)}, "
                         f"{tuple(w_stack.shape)}, {tuple(s.shape)}")
    C, M = w_stack.shape
    if w.shape[0] != M or s.shape[0] != C:
        raise ValueError(f"fused_agg_cuda: shapes do not match: w "
                         f"{tuple(w.shape)}, w_stack {tuple(w_stack.shape)}, "
                         f"s {tuple(s.shape)}")
    if not 1 <= C <= MAX_CLIENTS or M < 1:
        raise ValueError(f"fused_agg_cuda: C={C} must be in [1, "
                         f"{MAX_CLIENTS}] and M={M} at least 1")


def _vector_width(w, w_stack, out) -> int:
    """4 where every row starts aligned for the kernel's vector loads (16
    bytes of float32, 8 of bfloat16), else 1."""
    align = VEC * w.element_size()
    M = w.shape[0]
    ok = M % VEC == 0 and all(t.data_ptr() % align == 0
                              for t in (w, w_stack, out))
    return VEC if ok else 1


def fused_agg_cuda(w, w_stack, s):
    """Launch the Hopper kernel; returns a new (M,) tensor in w's dtype.
    Raises on a launch error (``cudaGetLastError``)."""
    _check_cuda_inputs(w, w_stack, s)
    C, M = w_stack.shape
    out = torch.empty_like(w)
    vec = _vector_width(w, w_stack, out)
    lib = _kernel()
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = lib.fused_agg(w.data_ptr(), w_stack.data_ptr(), s.data_ptr(),
                        out.data_ptr(), DTYPES[w.dtype], C, M, vec, stream)
    if err != 0:
        msg = lib.fused_agg_error_string(err).decode()
        raise RuntimeError(f"fused_agg kernel launch failed ({err}: {msg}) "
                           f"for w_stack {tuple(w_stack.shape)} {w.dtype}")
    fused_agg_cuda.launches += 1
    return out


fused_agg_cuda.launches = 0


def segment_table(leaves) -> list:
    """The launches of one tree: ``leaves`` is a list of (w (M,), w_stack
    (C, M), out (M,)) on one card; returns [(dtype, rows)], one entry per
    dtype in the order the dtype first appears (and another where a dtype
    has more than MAX_SEGMENTS leaves), each row (w, w_stack, out, M,
    first_block, vec) with first_block the blocks of the rows before it
    (ceil(M / (THREADS vec)) a row) and vec as ``_vector_width``."""
    groups: dict = {}
    for w, ws, out in leaves:
        groups.setdefault(w.dtype, []).append((w, ws, out))
    table = []
    for dtype, items in groups.items():
        for at in range(0, len(items), MAX_SEGMENTS):
            rows, first = [], 0
            for w, ws, out in items[at:at + MAX_SEGMENTS]:
                M, vec = w.shape[0], _vector_width(w, ws, out)
                rows.append((w, ws, out, M, first, vec))
                first += -(-M // (THREADS * vec))
            table.append((dtype, rows))
    return table


def fused_agg_tree_cuda(w_global, w_stack, s):
    """``fused_agg_cuda`` over every leaf of a tree (nested dicts, lists or
    tuples; w_global's leaves (...), w_stack's (C, ...)), in one launch
    per dtype; returns the tree of new tensors.  Each leaf is bitwise
    what ``fused_agg_cuda`` gives for it.  Raises, before anything is
    built, on what the kernel does not take."""
    ws_leaves = tree_leaves(w_stack)
    flat = [(w.reshape(-1), ws.reshape(ws.shape[0], -1))
            for w, ws in zip(tree_leaves(w_global), ws_leaves)]
    if not flat or len(flat) != len(ws_leaves):
        raise ValueError(f"fused_agg_tree_cuda: w_global has "
                         f"{len(flat)} leaves, w_stack {len(ws_leaves)}")
    for w, ws in flat:
        _check_cuda_inputs(w, ws, s)
    leaves = [(w, ws, torch.empty_like(w)) for w, ws in flat]
    C = flat[0][1].shape[0]
    lib = _kernel()
    stream = torch.cuda.current_stream(s.device).cuda_stream
    for dtype, rows in segment_table(leaves):
        table = (Segment * len(rows))(*[
            Segment(w.data_ptr(), ws.data_ptr(), out.data_ptr(), M, first,
                    vec) for w, ws, out, M, first, vec in rows])
        err = lib.fused_agg_segments(table, len(rows), s.data_ptr(),
                                     DTYPES[dtype], C, stream)
        if err != 0:
            msg = lib.fused_agg_error_string(err).decode()
            raise RuntimeError(f"fused_agg kernel launch failed ({err}: "
                               f"{msg}) for {len(rows)} {dtype} leaves")
        fused_agg_cuda.launches += 1
    outs = iter(out for _, _, out in leaves)
    return tree_map(lambda w: next(outs).reshape(w.shape), w_global)
