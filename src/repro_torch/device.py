"""Device resolution: the card by default, the CPU only when asked for."""
from __future__ import annotations

import sys

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and no card
    is visible.  Nothing falls back to the CPU unless the caller asked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            f"False (torch {torch.__version__}); pass device='cpu' "
            f"(--device cpu on the command line) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda' or "
                         f"'cpu'")
    return dev


def require_same_device(tensor: torch.Tensor, device: torch.device,
                        what: str) -> None:
    """Raise unless ``tensor`` lives on ``device`` (any index of its type
    when ``device`` names none)."""
    if tensor.device.type != device.type or (
            device.index is not None and tensor.device.index != device.index):
        raise ValueError(f"{what} is on {tensor.device}, expected {device}")


def is_dtensor(t) -> bool:
    """True for a ``torch.distributed.tensor.DTensor`` (a step run across
    ranks); imports nothing: no DTensor exists before its module is."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)
