"""Device dispatch for the kernels: a CUDA tensor launches the kernel (or
the wrapper raises), a CPU tensor takes the kernel's plain version.  There
is no fallback from one to the other."""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B, Sq, H, D); k, v (B, Skv, K, D) with H % K == 0 (GQA mapped
    inside).  Returns (B, Sq, H, D) in q's dtype."""
    if q.device.type == "cuda":
        return _fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        return _fa.flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")
