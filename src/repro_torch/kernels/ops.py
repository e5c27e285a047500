"""Device dispatch for the kernels: a CUDA tensor launches the kernel (or
the wrapper raises), a CPU tensor takes the kernel's plain version.  There
is no fallback from one to the other."""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fleet_step as _fleet
from repro_torch.kernels import fused_agg as _agg
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.tree import tree_leaves, tree_map


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B, Sq, H, D); k, v (B, Skv, K, D) with H % K == 0 (GQA mapped
    inside).  Returns (B, Sq, H, D) in q's dtype."""
    if q.device.type == "cuda":
        return _fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        return _fa.flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int):
    """Chunked SSD scan: x (B, S, H, P), dt (B, S, H) fp32, A (H,) fp32,
    Bm / Cm (B, S, G, N) with H % G == 0 (groups mapped inside).  Returns
    (y (B, S, H, P) fp32, final state (B, H, P, N) fp32)."""
    if x.device.type == "cuda":
        return _ssd.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=chunk)
    if x.device.type == "cpu":
        return _ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
    raise ValueError(f"ssd_scan: no kernel for device {x.device}")


def ssd_scan_y(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """``ssd_scan`` with the JAX package kernel's signature and result:
    Bm / Cm may be pre-repeated to heads, and only y comes back, in x's
    dtype."""
    return ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)[0].to(x.dtype)


def fused_agg(w, w_stack, s):
    """w (M,), w_stack (C, M), s (C,) float32 -> (M,) in w's dtype:
    w (1 - sum s) + s @ w_stack, i.e. w + sum_c s_c (w_stack[c] - w)."""
    if w.device.type == "cuda":
        return _agg.fused_agg_cuda(w, w_stack, s)
    if w.device.type == "cpu":
        return _agg.fused_agg_plain(w, w_stack, s)
    raise ValueError(f"fused_agg: no kernel for device {w.device}")


def fused_agg_tree(w_global, w_stack, s):
    """``fused_agg`` over a tree, each leaf flattened: w_global's leaves
    (...), w_stack's (C, ...).  On the card one launch per tree (per
    dtype); on the CPU leaf by leaf."""
    if tree_leaves(w_global)[0].device.type == "cuda":
        return _agg.fused_agg_tree_cuda(w_global, w_stack, s)
    return tree_map(lambda w, ws: fused_agg(
        w.reshape(-1), ws.reshape(ws.shape[0], -1), s).reshape(w.shape),
        w_global, w_stack)


def fleet_step(program, env, *, n: int, emit: bool = False,
               num_groups: int | None = None, mesh=None):
    """One round of the fleet's step program over ``n`` clients (``env``
    as ``kernels.fleet_step`` takes it): (state, emits, stats).  With a
    ``mesh`` the fleet is sharded over its ranks: ``n`` is the padded
    width of the whole fleet and ``env`` this rank's slab
    (``fused_step_sharded``)."""
    if mesh is not None:
        return _fleet.fused_step_sharded(program, env, n=n, mesh=mesh,
                                         emit=emit, num_groups=num_groups)
    dev = env["charge"].device
    if dev.type == "cuda":
        return _fleet.fleet_step_cuda(program, env, n=n, emit=emit,
                                      num_groups=num_groups)
    if dev.type == "cpu":
        return _fleet.fleet_step_plain(program, env, n=n, emit=emit,
                                       num_groups=num_groups)
    raise ValueError(f"fleet_step: no kernel for device {dev}")


def backend(device) -> str:
    """The executor of the port's kernels on ``device`` (a run manifest's
    ``backend``): ``"cuda"``, the hand-written kernels, on the card and
    ``"plain"``, their plain versions, on the CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "plain"


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port, by kernel name.  Each adds one to
    its ``.launches`` where it launches its kernel, and nowhere else (the
    serve program of fleet_step has its own wrapper and count;
    ``fused_agg_tree_cuda`` launches the fused_agg kernel and counts on
    ``fused_agg_cuda.launches``)."""
    return {"flash_attention": _fa.flash_attention_cuda,
            "fused_agg": _agg.fused_agg_cuda,
            "fleet_step": _fleet.fleet_step_cuda,
            "serve_step": _fleet.serve_step_cuda,
            "ssd_scan": _ssd.ssd_scan_cuda}


def finalize_wrappers() -> dict:
    """The sharded fleet's finalize wrappers, by the kernel whose library
    holds them; each counts its one-block launches on ``.launches``, apart
    from the kernel's main launches."""
    return {"fleet_step": _fleet.fleet_finalize_cuda,
            "serve_step": _fleet.serve_finalize_cuda}


def launch_counts() -> dict:
    """Each kernel's launches so far, by kernel name."""
    return {name: w.launches for name, w in kernel_wrappers().items()}


def finalize_counts() -> dict:
    """Each finalize's launches so far, by kernel name."""
    return {name: w.launches for name, w in finalize_wrappers().items()}


def zero_launches():
    for wrapper in (list(kernel_wrappers().values())
                    + list(finalize_wrappers().values())):
        wrapper.launches = 0
