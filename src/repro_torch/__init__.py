"""PyTorch/CUDA port of the Sustainable Federated Learning system.

A second package beside the JAX reference.  It serves the dense GQA
transformers through the continuous-batching decode engine
(`serve.engine.DecodeEngine`, `launch.serve`), with prefill attention on a
hand-written Hopper kernel (`kernels/csrc/flash_attention.cu`), and trains
the paper's CIFAR CNN with Algorithm 1 (`core`, `launch.train`,
`launch.fig1`), with the server's aggregation on a second one
(`kernels/csrc/fused_agg.cu`), and runs the battery-gated energy fleet
scan (`energy.fleet.simulate_fleet`, `launch.fleet`), each round's step on
a third (`kernels/csrc/fleet_step.cu`).

Public functions keep the JAX package's layouts — (B, S, H, hd)
activations, ``x @ W`` weights of shape (d_in, d_out), layer-stacked caches
(L, B, cache_len, K, hd); the CNN's conv weights alone are OIHW
(``convert.cnn_params_from_numpy``) — so the parity tests compare like
with like.
Entry points take an explicit ``device`` that defaults to ``"cuda"`` and
raise without a card unless the caller asks for ``"cpu"``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
