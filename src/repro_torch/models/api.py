"""Model API: ``get_model(cfg)`` dispatches on ``cfg.family`` (port of the
JAX package's ``models/api.py``).

Every family exposes, with ``cfg`` bound:
  init_params(gen) -> params                       (on gen.device)
  forward(params, batch, impl) -> (logits, aux)
  loss_fn(params, batch, rng, impl) -> scalar
  init_cache(batch, cache_len, device) -> cache    (decoder families)
  prefill(params, batch, cache_len, impl, window) -> (logits, cache)
  decode_step(params, token, cache, pos, ring, window) -> (logits, cache)

Registered: ``dense``, ``moe``, ``vlm`` and ``ssm`` (served and trained)
and ``cnn`` (trained).  ``hybrid`` and ``encdec`` raise until they are
ported.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import cnn, ssm, transformer

_FAMILY_MODULES = {"dense": transformer, "moe": transformer,
                   "vlm": transformer, "ssm": ssm}
NOT_PORTED = {"hybrid": "20b", "encdec": "20c"}
NOT_PORTED_MSG = ("family {!r} is not ported yet (ROADMAP.md Queue 1 item "
                  "{}); the port serves and trains families 'dense', 'moe', "
                  "'vlm' and 'ssm' and trains family 'cnn'")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init_params: Callable
    forward: Callable
    loss_fn: Callable
    init_cache: Callable | None = None
    prefill: Callable | None = None
    decode_step: Callable | None = None

    def num_params(self, params) -> int:
        if isinstance(params, dict):
            return sum(self.num_params(v) for v in params.values())
        return params.numel()


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family == "cnn":
        return Model(cfg=cfg, init_params=partial(cnn.init_params, cfg),
                     forward=partial(cnn.forward, cfg),
                     loss_fn=partial(cnn.loss_fn, cfg))
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(NOT_PORTED_MSG.format(
            cfg.family, NOT_PORTED[cfg.family]))
    mod = _FAMILY_MODULES[cfg.family]
    return Model(cfg=cfg,
                 init_params=partial(mod.init_params, cfg),
                 forward=partial(mod.forward, cfg),
                 loss_fn=partial(mod.loss_fn, cfg),
                 init_cache=partial(mod.init_cache, cfg),
                 prefill=partial(mod.prefill, cfg),
                 decode_step=partial(mod.decode_step, cfg))
