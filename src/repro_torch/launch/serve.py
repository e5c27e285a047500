"""Serving launcher: continuous-batching decode over a registered dense,
MoE, VLM or state-space architecture (port of the JAX package's
``launch/serve.py``).  A VLM prompt carries ``vision_embeds`` of
``min(vision_tokens, prompt_len)`` rows drawn from the prompt generator,
handed to the engine per request through ``Request.extras``.

The default path drives `repro_torch.serve.engine.DecodeEngine` over a batch
of requests with staggered arrivals (``--stagger`` steps apart);
``--single-stream`` runs the whole-batch `generate` loop instead.  Both
report throughput on materialized outputs (tokens fetched to the host) for
a first pass, which includes building the kernel library and warming the
card up, and a second, warm pass.

Decode energy is reported two ways: *measured* joules/token from the
per-stage engine microbenchmarks (`repro_torch.serve.microbench`, priced at
the nominal device wattage) next to the *analytic* ``from_params`` pricing
(~2*N FLOPs/token).  The launch counts of the prefill kernels
(``flash_attention``, ``ssd_scan``) over both passes are printed; they are
0 on the CPU, which takes the kernels' plain versions.

  python -m repro_torch.launch.serve                       # mamba2-1.3b, card
  python -m repro_torch.launch.serve --arch granite-3-2b
  python -m repro_torch.launch.serve --arch olmoe-1b-7b
  python -m repro_torch.launch.serve --smoke --device cpu
  python -m repro_torch.launch.serve --arch internvl2-76b --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import require_same_device, resolve_device
from repro_torch.energy.costs import DecodeCostModel
from repro_torch.kernels import ops
from repro_torch.models import get_model
from repro_torch.serve.engine import (DecodeEngine, EngineConfig, Request,
                                      pick_tokens)


def generate(model, params, prompt, gen_steps: int, cache_len: int,
             ring: bool = False, window=None, greedy: bool = True,
             temperature: float = 1.0, generator=None, device="cuda"):
    """Batched greedy or temperature-sampled generation (single-stream path).

    prompt: dict with (B, S) int ``tokens`` on ``device``.  With
    ``greedy=False`` each step draws from ``softmax(logits / temperature)``
    with noise from ``generator``.  Returns (B, ``gen_steps``) tokens: the
    first from the prefill logits, the rest from ``gen_steps - 1`` decode
    steps.
    """
    dev = resolve_device(device)
    if not greedy and generator is None:
        raise ValueError("sampling (greedy=False) requires a generator")
    if not greedy and not temperature > 0.0:
        raise ValueError(
            f"temperature must be > 0 for sampling (got {temperature}); "
            f"use greedy=True for argmax decoding")
    tokens = prompt["tokens"]
    require_same_device(tokens, dev, "prompt tokens")
    B, S = tokens.shape
    if gen_steps < 1:
        return torch.zeros((B, 0), dtype=torch.long, device=dev)
    logits, cache = model.prefill(params, prompt, cache_len=cache_len,
                                  window=window)
    logits = logits[:, -1] if logits.dim() == 3 else logits
    gens = [generator] * B

    tok = pick_tokens(logits, greedy, temperature, gens)
    out = [tok]
    for i in range(gen_steps - 1):
        logits, cache = model.decode_step(params, tok, cache, S + i,
                                          ring=ring, window=window)
        tok = pick_tokens(logits, greedy, temperature, gens)
        out.append(tok)
    return torch.stack(out, dim=1)


def _decode_shape(cfg, prompt_len: int, gen: int):
    """(cache_len, ring, window): a full cache sized to the workload, or a
    ring cache of the arch's sliding window."""
    cache_len, ring, window = prompt_len + gen + 1, False, None
    if cfg.sliding_window:
        cache_len, ring, window = cfg.sliding_window, True, cfg.sliding_window
    return cache_len, ring, window


def _make_prompt(cfg, generator: torch.Generator, batch: int,
                 prompt_len: int) -> dict:
    dev = generator.device
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                      generator=generator, device=dev)}
    if cfg.family == "vlm":
        nv = min(cfg.vision_tokens, prompt_len)
        prompt["vision_embeds"] = torch.randn(
            (batch, nv, cfg.d_model), generator=generator, device=dev
        ).to(getattr(torch, cfg.dtype))
    return prompt


def seeded_generators(seed: int, device: torch.device, n: int = 3):
    """``n`` independent generators on ``device`` from one seed: params,
    prompts and sampling must not share a stream."""
    states = np.random.SeedSequence(seed).spawn(n)
    return [torch.Generator(device=device).manual_seed(
        int(s.generate_state(1, np.uint64)[0] >> np.uint64(1)))
        for s in states]


def _run_engine(model, params, prompt, args, cache_len, ring, window,
                generator, device):
    """One engine pass over the staggered workload; returns (tokens (B, gen),
    wall seconds, engine).  Output rows are fetched to the host as each
    request finishes, so the clock covers materialized results."""
    B = args.batch
    toks = prompt["tokens"].cpu().numpy()
    extras = [k for k in prompt if k != "tokens"]
    reqs = [Request(rid=i, tokens=toks[i], max_new=args.gen,
                    extras={k: prompt[k][i] for k in extras} or None)
            for i in range(B)]
    arrivals = [i * args.stagger for i in range(B)]
    engine = DecodeEngine(model, params,
                          EngineConfig(slots=args.slots, cache_len=cache_len,
                                       max_new=args.gen, ring=ring,
                                       window=window,
                                       greedy=not args.sample,
                                       temperature=args.temperature),
                          rng=generator, device=device)
    t0 = time.perf_counter()
    done = engine.run(reqs, arrivals=arrivals)
    dt = time.perf_counter() - t0
    return np.stack([done[i].tokens for i in range(B)]), dt, engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--batch", type=int, default=4,
                    help="number of requests in the workload")
    ap.add_argument("--slots", type=int, default=4,
                    help="engine running-batch width (cache slots)")
    ap.add_argument("--stagger", type=int, default=2,
                    help="steps between request arrivals (0 = all at once)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sample", action="store_true",
                    help="temperature-sample instead of greedy argmax")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--single-stream", action="store_true",
                    help="whole-batch generate loop instead of the engine")
    ap.add_argument("--skip-microbench", action="store_true",
                    help="skip the per-stage microbenchmark")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = get_model(cfg)
    g_params, g_prompt, _ = seeded_generators(args.seed, dev)
    params = model.init_params(g_params)

    B, S = args.batch, args.prompt_len
    prompt = _make_prompt(cfg, g_prompt, B, S)
    cache_len, ring, window = _decode_shape(cfg, S, args.gen)

    def sampler():      # the same sampling stream for both passes
        return seeded_generators(args.seed, dev)[2]

    mode = (f"sampled@T={args.temperature}" if args.sample else "greedy")
    launches0 = ops.launch_counts()
    if args.single_stream:
        def run():
            toks = generate(model, params, prompt, args.gen, cache_len,
                            ring=ring, window=window, greedy=not args.sample,
                            temperature=args.temperature,
                            generator=sampler(), device=dev)
            return toks.cpu().numpy()          # materialized on the host

        t0 = time.perf_counter()
        toks = run()
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        toks = run()
        warm = time.perf_counter() - t0
        path = "single-stream"
    else:
        toks, wall, engine = _run_engine(model, params, prompt, args,
                                         cache_len, ring, window, sampler(),
                                         dev)
        toks, warm, engine = _run_engine(model, params, prompt, args,
                                         cache_len, ring, window, sampler(),
                                         dev)
        path = (f"engine[slots={args.slots} stagger={args.stagger} "
                f"inserts={engine.stats['inserts']} "
                f"steps={engine.stats['steps']}]")

    n_tokens = toks.shape[0] * toks.shape[1]
    if toks.shape != (B, args.gen):
        raise RuntimeError(f"generated {toks.shape}, expected {(B, args.gen)}")
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"arch={cfg.name} batch={B} prompt={S} generated={args.gen} "
          f"({mode}, {path}) device={where}")
    print("tokens[0]:", toks[0])
    print(f"{n_tokens / wall:.1f} tok/s (first pass, incl. kernel build and "
          f"warm-up)   {n_tokens / warm:.1f} tok/s (warm)")
    launches = {name: count - launches0[name]
                for name, count in ops.launch_counts().items()}
    print(f"kernel launches (both passes): flash_attention "
          f"{launches['flash_attention']}, ssd_scan {launches['ssd_scan']}")

    cost = DecodeCostModel.from_params(cfg.num_active_params())
    per_request = float(cost.request_cost(S, args.gen))
    total_j = B * per_request
    print(f"energy (analytic, nominal edge device): "
          f"{total_j / n_tokens:.3e} J/token, {per_request:.3e} J/request "
          f"({B} requests, {total_j:.3e} J total)")
    if not args.skip_microbench:
        from repro_torch.serve.microbench import (engine_microbench,
                                                  measured_cost)
        rec = engine_microbench(model, params, slots=args.slots,
                                prompt_len=S, gen=args.gen,
                                cache_len=cache_len, ring=ring,
                                window=window, reps=3, seed=args.seed,
                                device=dev)
        mcost = measured_cost(rec)
        mreq = float(mcost.request_cost(S, args.gen))
        print(f"energy (measured microbench on {rec['device']} @ "
              f"{rec['device_watts']:.1f} W nominal): "
              f"{float(mcost.joules_per_decode_step):.3e} J/token decode, "
              f"{mreq:.3e} J/request  [prefill {rec['prefill_tok_s']:.0f} "
              f"tok/s, decode step {rec['decode_step_ms']:.2f} ms, insert "
              f"{rec['insert_ms']:.2f} ms]")


if __name__ == "__main__":
    main()
