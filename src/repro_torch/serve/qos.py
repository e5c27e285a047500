"""QoS tiers for battery-gated serving: what a request costs at each grade
(port of the JAX package's ``serve/qos.py``).

A request is served at one of two generation grades — **full** or
**degraded** (a short answer: cheaper than full service, better than
shedding) — or it is **shed** (dropped).  `QoSSpec` holds the token
budgets that price the two grades through a `DecodeCostModel`: one
prefill over ``prompt_tokens``, one decode step per generated token and one
response upload.  Budgets are floats or (N,) arrays / tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.energy.costs import DecodeCostModel

# admission modes (`serve.admission` decides one per client per epoch)
SHED, DEGRADED, FULL = 0, 1, 2


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


@dataclasses.dataclass(frozen=True, eq=False)
class QoSSpec:
    """Token budgets of the two service grades; ``short_decode_tokens <
    full_decode_tokens`` is what makes the degraded tier a rung of
    admission control."""

    prompt_tokens: float | torch.Tensor = 128.0
    full_decode_tokens: float | torch.Tensor = 256.0
    short_decode_tokens: float | torch.Tensor = 32.0

    FIELDS = ("prompt_tokens", "full_decode_tokens", "short_decode_tokens")

    def request_cost(self, model: DecodeCostModel,
                     degraded: bool = False) -> torch.Tensor:
        """Joules for one request at the given grade, in float32 as the
        reference computes it outside its scan."""
        toks = self.short_decode_tokens if degraded else self.full_decode_tokens
        return (_f32(self.prompt_tokens) * _f32(model.joules_per_prefill_token)
                + _f32(toks) * _f32(model.joules_per_decode_step)
                + _f32(model.joules_per_response_upload))

    def decoded_tokens(self, served_full, served_short) -> torch.Tensor:
        """Generated-token count of a (full, degraded) served split."""
        return (_f32(served_full) * _f32(self.full_decode_tokens)
                + _f32(served_short) * _f32(self.short_decode_tokens))
