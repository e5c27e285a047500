"""PyTorch/CUDA port of the Sustainable Federated Learning system.

A second package beside the JAX reference.  This slice serves the dense
GQA transformers through the continuous-batching decode engine
(`serve.engine.DecodeEngine`, `launch.serve`); prefill attention runs on a
hand-written Hopper kernel (`kernels/csrc/flash_attention.cu`).

Public functions keep the JAX package's layouts — (B, S, H, hd)
activations, ``x @ W`` weights of shape (d_in, d_out), layer-stacked caches
(L, B, cache_len, K, hd) — so the parity tests compare like with like.
Entry points take an explicit ``device`` that defaults to ``"cuda"`` and
raise without a card unless the caller asks for ``"cpu"``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
