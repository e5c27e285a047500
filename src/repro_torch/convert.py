"""Carry the JAX package's parameter tree across to the port.

The tree arrives as nested dicts of numpy-convertible arrays (``np.asarray``
of each leaf; nothing of JAX is imported here).  Layout and layer stacking
are kept as they are: ``x @ W`` weights of shape (d_in, d_out), and every
leaf under ``"layers"`` keeps its leading ``L`` axis — the port's
transformer indexes that axis per layer.  Both packages then compute the
same function.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _leaf(a, device):
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":     # ml_dtypes bf16: exact via fp32
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))          # own the memory
    return t.to(device)


def params_from_numpy(tree, device="cuda"):
    """Nested dict of arrays -> the same nest of tensors on ``device``, in
    the arrays' own dtypes."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return _leaf(tree, dev)


CNN_CONVS = ("conv1", "conv2")


def cnn_params_from_numpy(tree, device="cuda"):
    """The reference CNN's params (conv weights HWIO) -> the port's (conv
    weights OIHW), on ``device``."""
    tree = {name: dict(leaves) for name, leaves in tree.items()}
    for name in CNN_CONVS:
        tree[name]["w"] = np.asarray(tree[name]["w"]).transpose(3, 2, 0, 1)
    return params_from_numpy(tree, device)


def cnn_params_to_numpy(tree):
    """The port's CNN params (or grads) -> numpy in the reference's layout
    (conv weights HWIO)."""
    out = {name: {k: v.detach().float().cpu().numpy()
                  for k, v in leaves.items()} for name, leaves in tree.items()}
    for name in CNN_CONVS:
        out[name]["w"] = np.ascontiguousarray(
            out[name]["w"].transpose(2, 3, 1, 0))
    return out
