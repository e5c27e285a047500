"""Serving across the architecture families (twin of the JAX package's
``examples/serve_decode.py``): batched prefill + decode through `generate`
on the smoke configs of five families, with the reference's cache shapes
(the state-space model's O(1) state, a full cache, the MoE's sliding-window
ring, the hybrid's local-window ring, the encoder-decoder's cross-attention
memory); then the continuous-batching engine over a staggered workload on
mamba2-1.3b, whose every request must be token-identical to its
single-stream `generate`.

  python -m repro_torch.launch.serve_decode --device cpu
  python -m repro_torch.launch.serve_decode                  # the card

Exits 1 if an engine request's tokens differ from its single-stream run.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import (_decode_shape, _make_prompt, generate,
                                      seeded_generators)
from repro_torch.models import get_model
from repro_torch.serve.engine import DecodeEngine, EngineConfig, Request

ARCHS = ("mamba2-1.3b", "granite-3-2b", "mixtral-8x7b", "recurrentgemma-2b",
         "whisper-tiny")
B, PROMPT, GEN = 2, 24, 8
# the engine part: (prompt, gen) per request, arrivals, three slots
ENGINE_ARCH = "mamba2-1.3b"
SPECS = ((12, 8), (24, 4), (9, 8), (16, 6), (24, 8))
ARRIVALS = (0, 0, 2, 4, 7)
SLOTS = 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        model = get_model(cfg)
        g_params, g_prompt, _ = seeded_generators(args.seed, dev)
        params = model.init_params(g_params)
        prompt = _make_prompt(cfg, g_prompt, B, PROMPT)
        cache_len, ring, window = _decode_shape(cfg, PROMPT, GEN)
        t0 = time.perf_counter()
        toks = generate(model, params, prompt, GEN, cache_len, ring=ring,
                        window=window, device=dev).cpu().numpy()
        print(f"{arch:20s} [{cfg.family:7s}] cache_len={cache_len} "
              f"ring={ring} generated {toks[0][:6]}… "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)

    cfg = get_smoke_config(ENGINE_ARCH)
    model = get_model(cfg)
    g_params, g_prompt, _ = seeded_generators(args.seed, dev)
    params = model.init_params(g_params)
    cache_len = max(S for S, _ in SPECS) + max(g for _, g in SPECS) + 1
    engine = DecodeEngine(model, params, EngineConfig(
        slots=SLOTS, cache_len=cache_len, max_new=max(g for _, g in SPECS)),
        device=dev)
    reqs = [Request(rid=i, tokens=torch.randint(
                0, cfg.vocab_size, (S,), generator=g_prompt,
                device=dev).cpu().numpy(), max_new=g)
            for i, (S, g) in enumerate(SPECS)]
    done = engine.run(reqs, arrivals=list(ARRIVALS))
    print(f"\nengine[{ENGINE_ARCH}] slots={SLOTS}, {len(reqs)} staggered "
          f"requests (arrivals {list(ARRIVALS)}): {engine.stats['steps']} "
          f"steps, {engine.stats['inserts']} inserts")
    mismatches = 0
    for i, (S, g) in enumerate(SPECS):
        solo = generate(model, params, {"tokens": torch.tensor(
            reqs[i].tokens, dtype=torch.long, device=dev)[None]}, g,
            cache_len, device=dev)[0].cpu().numpy()
        same = (done[i].tokens == solo).all()
        mismatches += not same
        print(f"  rid={i} prompt={S:2d} gen={g} slot={done[i].slot} "
              f"tokens={done[i].tokens[:5]}… "
              f"{'== single-stream' if same else 'MISMATCH'}")
    if mismatches:
        print(f"error: {mismatches} engine requests differ from their "
              f"single-stream generate", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
