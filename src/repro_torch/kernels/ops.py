"""Device dispatch for the kernels: a CUDA tensor launches the kernel (or
the wrapper raises), a CPU tensor takes the kernel's plain version.  There
is no fallback from one to the other."""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fleet_step as _fleet
from repro_torch.kernels import fused_agg as _agg


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B, Sq, H, D); k, v (B, Skv, K, D) with H % K == 0 (GQA mapped
    inside).  Returns (B, Sq, H, D) in q's dtype."""
    if q.device.type == "cuda":
        return _fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        return _fa.flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


def fused_agg(w, w_stack, s):
    """w (M,), w_stack (C, M), s (C,) float32 -> (M,) in w's dtype:
    w (1 - sum s) + s @ w_stack, i.e. w + sum_c s_c (w_stack[c] - w)."""
    if w.device.type == "cuda":
        return _agg.fused_agg_cuda(w, w_stack, s)
    if w.device.type == "cpu":
        return _agg.fused_agg_plain(w, w_stack, s)
    raise ValueError(f"fused_agg: no kernel for device {w.device}")


def fused_agg_tree(w_global, w_stack, s):
    """``fused_agg`` leaf by leaf over nested dicts (one launch per leaf),
    each leaf flattened: w_global's leaves (...), w_stack's (C, ...)."""
    if isinstance(w_global, dict):
        return {k: fused_agg_tree(v, w_stack[k], s)
                for k, v in w_global.items()}
    flat = fused_agg(w_global.reshape(-1),
                     w_stack.reshape(w_stack.shape[0], -1), s)
    return flat.reshape(w_global.shape)


def fleet_step(program, env, *, n: int, emit: bool = False,
               num_groups: int | None = None):
    """One round of the fleet's step program over ``n`` clients (``env``
    as ``kernels.fleet_step`` takes it): (state, emits, stats)."""
    dev = env["charge"].device
    if dev.type == "cuda":
        return _fleet.fleet_step_cuda(program, env, n=n, emit=emit,
                                      num_groups=num_groups)
    if dev.type == "cpu":
        return _fleet.fleet_step_plain(program, env, n=n, emit=emit,
                                       num_groups=num_groups)
    raise ValueError(f"fleet_step: no kernel for device {dev}")
