"""The paper's §V CNN (port of the JAX package's ``models/cnn.py``): the
CIFAR-10 network of McMahan et al. [7], two 5x5 conv + 2x2 max-pool
stages and two hidden FC layers, 1,702,794 parameters in float32.

Functional, on a dict of tensors, so ``torch.func`` can map it over
clients.  Batches
keep the reference's layout: ``images`` (B, 32, 32, 3) NHWC, ``labels``
(B,) int.  Conv weights are PyTorch's OIHW (the reference's are HWIO;
``convert.cnn_params_from_numpy`` transposes them); ``fc*`` and ``out``
weights are (d_in, d_out) for ``x @ W`` as in the reference.

Layout trap: the reference flattens the (B, 8, 8, 64) activation in NHWC
order before ``fc1``, so this NCHW path permutes back to NHWC before its
flatten; without that the logits differ completely while every shape
still fits.

Convolutions are im2col + one float32 matmul (``conv_same``), not cuDNN:
under ``vmap`` a stacked conv becomes a grouped convolution, and for it
cuDNN picks engines whose float32 weight gradients lie ~2e-3 (of the
largest) from float64 where the replayed float32 computation lies ~1e-6
(``probes/grad_routing.py``); the matmul runs on cuBLAS, with TF32 off
on the card (the train entry point turns it off).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

CONV_SHAPES = {"conv1": (32, 3, 5, 5), "conv2": (64, 32, 5, 5)}   # OIHW
FC_SHAPES = {"fc1": (8 * 8 * 64, 384), "fc2": (384, 192)}


def init_params(cfg: ModelConfig, gen: torch.Generator,
                num_classes: int = 10):
    """He-normal weights drawn from ``gen``, zero biases, on
    ``gen.device`` (the reference's init, from another generator)."""
    dev = gen.device

    def he(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=dev)
                * (2.0 / fan_in) ** 0.5)

    def zeros(n):
        return torch.zeros(n, device=dev)

    params = {}
    for name, (o, i, kh, kw) in CONV_SHAPES.items():
        params[name] = {"w": he((o, i, kh, kw), kh * kw * i), "b": zeros(o)}
    for name, (d_in, d_out) in FC_SHAPES.items():
        params[name] = {"w": he((d_in, d_out), d_in), "b": zeros(d_out)}
    params["out"] = {"w": he((192, num_classes), 192),
                     "b": zeros(num_classes)}
    return params


def conv_same(x, w, b):
    """Stride-1 "SAME" convolution of x (B, I, H, W) with w (O, I, k, k)
    and bias b (O,): im2col, then one (O, I k k) @ (I k k, B H W) matmul
    (a batched matmul over clients under ``vmap``)."""
    B, _, H, W = x.shape
    O, k = w.shape[0], w.shape[-1]
    cols = F.unfold(x, k, padding=k // 2)                  # (B, I k k, H W)
    cols = cols.transpose(0, 1).reshape(cols.shape[1], B * H * W)
    out = (w.reshape(O, -1) @ cols).reshape(O, B, H, W).transpose(0, 1)
    return out + b[:, None, None]


def _windows(a):
    """(..., H, W) -> (..., H/2, W/2, 4), in ``max_pool2d``'s window order."""
    *lead, H, W = a.shape
    a = a.reshape(*lead, H // 2, 2, W // 2, 2).transpose(-3, -2)
    return a.reshape(*lead, H // 2, W // 2, 4)


def _relu(z, route):
    return F.relu(z) if route is None else z * (route > 0).to(z.dtype)


def _pool(a, route):
    if route is None:
        return F.max_pool2d(a, 2)
    idx = _windows(F.relu(route)).argmax(-1, keepdim=True)
    return torch.gather(_windows(a), -1, idx)[..., 0]


def features(params, images, routes=None):
    """(logits (B, 10), pre-activations (conv1, conv2, fc1, fc2)): the
    forward pass with its discrete decisions exposed.  Each ReLU keeps
    where its input is > 0 and each 2x2 max-pool routes to its window's
    largest element; with ``routes`` (the four pre-activations of another
    evaluation) they take that evaluation's decisions instead, so one
    float32 run can be replayed in float64 or on another device."""
    r = routes or (None,) * 4
    x = images.permute(0, 3, 1, 2)                            # NHWC -> NCHW
    z1 = conv_same(x, params["conv1"]["w"], params["conv1"]["b"])
    z2 = conv_same(_pool(_relu(z1, r[0]), r[0]), params["conv2"]["w"],
                   params["conv2"]["b"])
    x = _pool(_relu(z2, r[1]), r[1])
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)         # NHWC flatten
    h1 = x @ params["fc1"]["w"] + params["fc1"]["b"]
    h2 = _relu(h1, r[2]) @ params["fc2"]["w"] + params["fc2"]["b"]
    logits = _relu(h2, r[3]) @ params["out"]["w"] + params["out"]["b"]
    return logits, (z1, z2, h1, h2)


def forward(cfg: ModelConfig, params, batch, impl: str = "ref"):
    """batch: {images (B, 32, 32, 3)} -> (logits (B, 10), aux 0)."""
    logits, _ = features(params, batch["images"])
    return logits, torch.zeros((), device=logits.device)


def loss_and_decisions(params, batch, routes=None):
    """(mean softmax cross-entropy against ``labels``, pre-activations);
    ``routes`` as in ``features``."""
    logits, pre = features(params, batch["images"], routes)
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[:, None])[:, 0]
    return torch.mean(logz - gold), pre


def loss_fn(cfg: ModelConfig, params, batch, rng=None, impl: str = "ref"):
    """Mean softmax cross-entropy of the logits against ``labels``."""
    return loss_and_decisions(params, batch)[0]


def accuracy(params, batch):
    logits, _ = forward(None, params, batch)
    return torch.mean((logits.argmax(-1) == batch["labels"].long()).float())
