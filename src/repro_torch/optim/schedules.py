"""Learning-rate schedules (port of the JAX package's ``optim/schedules.py``).

Each schedule maps a step (an int or an int tensor) to a float32 0-dim
tensor on the CPU, which PyTorch multiplies into tensors on any device.
``paper_theorem1`` is Theorem 1's ``eta_t = 2 / (mu (gamma + t))`` with
``gamma = max(8 kappa, T)`` and ``kappa = L / mu``.
"""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(dtype=torch.float32, device="cpu")


def constant(lr: float):
    def sched(step):
        return _f32(lr)

    return sched


def cosine(peak: float, total_steps: int, floor: float = 0.0):
    def sched(step):
        frac = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
        return floor + 0.5 * (peak - floor) * (1 + torch.cos(
            _f32(math.pi) * frac))

    return sched


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0):
    cos = cosine(peak, max(total_steps - warmup_steps, 1), floor)

    def sched(step):
        step = _f32(step)
        warm = peak * step / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm, cos(step - warmup_steps))

    return sched


def paper_theorem1(mu: float, L: float, T: int):
    """eta_t = 2 / (mu (gamma + t)), gamma = max{8 kappa, T}, kappa = L/mu."""
    kappa = L / mu
    gamma = max(8.0 * kappa, float(T))

    def sched(step):
        return 2.0 / (mu * (gamma + _f32(step)))

    return sched
