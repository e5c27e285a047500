"""Per-stage decode-engine microbenchmarks: measured seconds (and joules) per
token, per stage (port of the JAX package's ``serve/microbench.py``).

Each engine stage is timed warm on materialized outputs: one warm-up call,
then ``reps`` calls, then ``torch.cuda.synchronize`` on the card (PyTorch
returns before the device finishes, so a host clock without it would time
the enqueue).  On the CPU the ops run synchronously.

Stages (mean over ``reps``):

* **prefill** — one (1, S) prompt through the model's prefill;
  ``seconds_per_prefill_token`` = t / S.
* **decode**  — one decode step over a full running batch of ``slots``
  requests; ``seconds_per_decode_token`` = t / slots.
* **insert**  — one prefilled request written into a slot of the running
  cache (priced per event, not per token).
"""
from __future__ import annotations

import time

import torch

from repro_torch.device import resolve_device
from repro_torch.energy.costs import DEVICE_WATTS, DecodeCostModel
from repro_torch.serve.engine import DecodeEngine, EngineConfig, Request


def _timed(fn, reps: int, device: torch.device) -> float:
    """Steady-state seconds per call of ``fn`` on ``device``."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps


def engine_microbench(model, params, *, slots: int = 4, prompt_len: int = 32,
                      gen: int = 16, cache_len: int | None = None,
                      ring: bool = False, window: int | None = None,
                      reps: int = 5, seed: int = 0, device="cuda") -> dict:
    """Per-stage engine timings for one model, as a flat record dict: ms and
    tok/s per stage, and the measured joules/token at ``DEVICE_WATTS`` next
    to the analytic ``from_params`` figure."""
    dev = resolve_device(device)
    cfg = model.cfg
    cache_len = cache_len or (prompt_len + gen + 1)
    econfig = EngineConfig(slots=slots, cache_len=cache_len, max_new=gen,
                           ring=ring, window=window)
    engine = DecodeEngine(model, params, econfig, device=dev,
                          rng=torch.Generator(device=dev).manual_seed(seed))
    prompts = torch.randint(
        0, cfg.vocab_size, (slots, prompt_len), device=dev,
        generator=torch.Generator(device=dev).manual_seed(seed + 1))

    # --- prefill: (1, S) prompt -> logits + cache ---------------------------
    batch1 = {"tokens": prompts[:1]}
    prefill_s = _timed(lambda: engine._prefill(batch1), reps, dev)

    # --- insert: one prefilled request into a running cache ----------------
    logits, pcache = engine._prefill(batch1)
    first = logits[0].argmax()
    insert_s = _timed(lambda: engine._insert(pcache, first, 0), reps, dev)

    # --- decode step: a full running batch, every slot occupied ------------
    engine.reset(torch.Generator(device=dev).manual_seed(seed))
    for i in range(slots):
        engine.prefill_request(Request(rid=i, tokens=prompts[i].cpu().numpy(),
                                       max_new=gen))
    pos, active, gen_idx = (engine._host_vector(a) for a in
                            (engine._pos, engine._active, engine._gen))
    step_s = _timed(lambda: engine._step(pos, active, gen_idx), reps, dev)

    per_prefill_tok = prefill_s / prompt_len
    per_decode_tok = step_s / slots
    measured = DecodeCostModel.from_microbench(per_prefill_tok,
                                               per_decode_tok)
    analytic = DecodeCostModel.from_params(cfg.num_active_params())
    return {
        "arch": cfg.name,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "slots": slots,
        "prompt_len": prompt_len,
        "cache_len": cache_len,
        "gen": gen,
        "reps": reps,
        "prefill_ms": prefill_s * 1e3,
        "insert_ms": insert_s * 1e3,
        "decode_step_ms": step_s * 1e3,
        "prefill_tok_s": prompt_len / prefill_s,
        "decode_tok_s": slots / step_s,
        "seconds_per_prefill_token": per_prefill_tok,
        "seconds_per_decode_token": per_decode_tok,
        "device_watts": DEVICE_WATTS,
        "joules_per_prefill_token_measured":
            float(measured.joules_per_prefill_token),
        "joules_per_decode_token_measured":
            float(measured.joules_per_decode_step),
        "joules_per_decode_token_analytic":
            float(analytic.joules_per_decode_step),
    }


def measured_cost(record: dict, watts: float = DEVICE_WATTS,
                  **kw) -> DecodeCostModel:
    """`DecodeCostModel` from a microbench record."""
    return DecodeCostModel.from_microbench(
        record["seconds_per_prefill_token"],
        record["seconds_per_decode_token"], watts=watts, **kw)
