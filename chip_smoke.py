#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--seed N]

Needs one NVIDIA card (Hopper: the kernels are built for sm_90a) and a
checkout of this repo around it; exits non-zero, printing no result,
without either.  Phases, each of which raises on a failed check:

1. Environment: the card's name and power limit, torch and CUDA versions,
   and the time to build the kernel library from ``src/repro_torch/
   kernels/csrc`` (``nvcc``, first use).
2. Kernels: ``flash_attention`` on the card against its plain PyTorch
   version on the same inputs, at the granite-3-2b prefill shapes (B=1,
   H=32, K=8, D=64; S in {1, 127, 128, 777, 2048}) plus D=128 at S=1024, in
   bf16 and fp32, causal, causal with window 256, and non-causal.  Times the
   kernel, its plain version and one library call
   (``scaled_dot_product_attention``, timed here only, never called by the
   port) at S=2048, bf16, causal, beside the card's bound.
3. Serve: granite-3-2b at full width and depth (40 layers, bf16, random
   weights from ``--seed``) through ``DecodeEngine.run``: 4 slots, 6 greedy
   requests of 32 new tokens, arrivals 2 steps apart, prompt lengths
   {2048, 1537, 777, 1024, 129, 1999}.  Every kernel's launch count is set
   to 0 just before the run and read just after (6 prefills x 40 layers =
   240 flash launches).  Each request's prefill logits through the kernel
   are then held against the plain PyTorch attention path (``impl="ref"``),
   in bf16 and with the same weights in fp32; the engine's per-stage
   microbenchmark and a profile of one prefill and one decode step (wall
   time, device-busy time, kernel count) are printed.

Prints one ``{"kernels": [...]}`` line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  ``--out PATH`` also writes a
JSON record of every number measured.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(REPO, "src")

# H100 SXM published dense peaks (NVIDIA data sheet, at a 700 W limit)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# kernel vs plain version: ``flash_attention.kernel_tolerance``, a
# per-element bound from the kernel's own rounding.  bf16:
# 2^-8 attention(q, k, |v|) + 2e-2 |want| (twice the largest move that
# rounding P to bf16 can make, plus the bf16 rounding of the output);
# fp32: the reference's 2e-5 + 2e-5 |want| (sum order only).
# Prefill logits of granite-3-2b (40 layers, random init: logits have std
# ~0.9 and max ~4), kernel path vs plain PyTorch attention path on the same
# weights.  bf16, the served dtype: a coarse bound on drift through depth.
# The two paths round P differently and the difference travels through
# every later layer; the bf16 kernel itself is held tightly, layer by
# layer, on the served prompts' own q, k, v (``served_kernel_check``).
# fp32 (the same weights upcast, TF32 off): sum order only, through 40
# layers.
LOGIT_ATOL = {"bfloat16": 0.5, "float32": 1e-3}

PROMPT_LENS = (2048, 1537, 777, 1024, 129, 1999)
GEN = 32
SLOTS = 4
STAGGER = 2


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def power_limit_watts(card: str) -> float:
    """The power limit from nvidia-smi's "name, 700.00 W" line."""
    return float(card.rsplit(",", 1)[1].split()[0])


def cuda_ms(fn, reps: int, torch) -> float:
    """Mean device ms per call of ``fn`` between CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(torch, fn) -> dict:
    """Wall time, device-busy time and kernel count of one call of ``fn``
    (after a warm-up call), from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_share": device_ms / wall_ms,
            "kernels": sum(e.count for e in kernels),
            "top": [(e.key[:60], e.self_device_time_total / 1e3) for e in top]}


def _tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    return fn(tree)


def attention_work(B, S, H, K, D, causal, window, elsize):
    """(FLOPs, bytes) this attention needs: two products over the visible
    (query, key) pairs, and q, k, v read once and o written once."""
    pairs = 0
    for q in range(S):
        lo = max(0, q - window + 1) if window > 0 else 0
        hi = q + 1 if causal else S
        pairs += max(0, hi - lo)
    flops = 4 * B * H * D * pairs
    nbytes = elsize * (2 * B * S * H * D + 2 * B * S * K * D)
    return flops, nbytes


def check_kernel(torch, fa, q, k, v, causal, window, label,
                 show=True) -> tuple:
    """Hold ``flash_attention_cuda`` against ``flash_attention_plain`` on
    the same inputs within ``kernel_tolerance``; raises on a non-finite
    output or any element past its bound.  Returns (max abs error, largest
    error / bound)."""
    got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    tol = fa.kernel_tolerance(q, k, v, want, causal=causal, window=window)
    err = (got.float() - want.float()).abs()
    ratio = (err / tol.clamp_min(1e-30)).max().item()
    ok = bool(torch.isfinite(got).all()) and bool((err <= tol).all())
    if show or not ok:
        print(f"kernel flash_attention {label} causal={causal} window={window}: "
              f"max_abs_err={err.max().item():.3e}, worst err/bound="
              f"{ratio:.3f} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"flash_attention kernel disagrees with its "
                             f"plain version at {label} causal={causal} "
                             f"window={window}")
    return err.max().item(), ratio


def kernel_phase(torch, fa, seed: int) -> dict:
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(seed)
    B, H, K = 1, 32, 8
    cases = [(64, S) for S in (1, 127, 128, 777, 2048)] + [(128, 1024)]
    masks = ((True, 0), (True, 256), (False, 0))
    worst = {"bfloat16": 0.0, "float32": 0.0}
    worst_ratio = {"bfloat16": 0.0, "float32": 0.0}
    for D, S in cases:
        for dname in ("bfloat16", "float32"):
            dt = getattr(torch, dname)
            q, k, v = ((torch.randn((B, S, h, D), generator=gen, device="cuda")
                        * 0.5).to(dt) for h in (H, K, K))
            for causal, window in masks:
                err, ratio = check_kernel(torch, fa, q, k, v, causal, window,
                                          f"D={D} S={S} {dname}")
                worst[dname] = max(worst[dname], err)
                worst_ratio[dname] = max(worst_ratio[dname], ratio)

    # timing at the longest main-path prompt: S=2048, bf16, causal
    S, D, dname = 2048, 64, "bfloat16"
    q, k, v = ((torch.randn((B, S, h, D), generator=gen, device="cuda") * 0.5)
               .to(torch.bfloat16) for h in (H, K, K))
    kernel_ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v), 20, torch)
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v), 3, torch)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))      # (B, heads, S, D)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 20, torch)
    lib_err = (F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2).float()
        - fa.flash_attention_cuda(q, k, v).float()).abs().max().item()
    flops, nbytes = attention_work(B, S, H, K, D, True, 0, 2)
    t_ops, t_bytes = flops / PEAK_FLOPS[dname] * 1e3, nbytes / PEAK_BYTES * 1e3
    print(f"flash_attention S={S} bf16 causal: kernel {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, library sdpa {library_ms:.4f} ms "
          f"(|sdpa - kernel| max {lib_err:.3e}); bound {max(t_ops, t_bytes):.4f}"
          f" ms ({flops:.4g} FLOP, {nbytes:.4g} B)", flush=True)
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:23",
        "launches": None,
        "max_abs_err": max(worst.values()),
        "max_abs_err_bf16": worst["bfloat16"],
        "max_abs_err_fp32": worst["float32"],
        "worst_err_over_bound": worst_ratio,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
        "timed_at": {"B": B, "S": S, "H": H, "K": K, "D": D,
                     "dtype": dname, "causal": True, "window": 0},
    }


def served_kernel_check(torch, fa, model, params, prompts, cache_len,
                        device="cuda"):
    """The bf16 kernel on the served path's own inputs: record the q, k, v
    that every layer's prefill hands the kernel, for every prompt, and
    hold the kernel against its plain version on each within
    ``kernel_tolerance``.  Returns the largest error / bound per prompt."""
    from repro_torch.kernels import ops

    real = ops.flash_attention
    worst = []
    for i, p in enumerate(prompts):
        calls = []

        def record(q, k, v, **kw):
            calls.append((q, k, v, kw))
            return real(q, k, v, **kw)

        batch = {"tokens": torch.tensor(p, dtype=torch.long,
                                        device=device)[None]}
        ops.flash_attention = record
        try:
            model.prefill(params, batch, cache_len=cache_len, impl="flash")
        finally:
            ops.flash_attention = real
        if len(calls) != model.cfg.num_layers:
            raise AssertionError(f"request {i}: recorded {len(calls)} "
                                 f"kernel calls, expected one per layer")
        res = [check_kernel(torch, fa, q, k, v, kw["causal"], kw["window"],
                            f"served request {i} S={len(p)} layer {layer} "
                            f"{q.dtype}", show=False)
               for layer, (q, k, v, kw) in enumerate(calls)]
        worst.append(max(r for _, r in res))
        print(f"serve: request {i} S={len(p)}: bf16 kernel vs plain on the "
              f"served q, k, v of all {len(res)} layers: max_abs_err "
              f"{max(e for e, _ in res):.3e}, worst err/bound {worst[-1]:.3f}"
              f" ok", flush=True)
    return worst


def serve_phase(torch, fa, seed: int, card: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import seeded_generators
    from repro_torch.models import get_model
    from repro_torch.serve.engine import DecodeEngine, EngineConfig, Request
    from repro_torch.serve.microbench import engine_microbench, measured_cost

    cfg = get_config("granite-3-2b")
    model = get_model(cfg)
    g_params, g_prompt, _ = seeded_generators(seed, torch.device("cuda"))
    t0 = time.perf_counter()
    params = model.init_params(g_params)
    torch.cuda.synchronize()
    print(f"serve: {cfg.name} {cfg.num_layers} layers d_model={cfg.d_model} "
          f"{cfg.dtype}, {model.num_params(params) / 1e9:.3f} B params made "
          f"on the card in {time.perf_counter() - t0:.2f} s", flush=True)
    prompts = [torch.randint(0, cfg.vocab_size, (S,), generator=g_prompt,
                             device="cuda").cpu().numpy()
               for S in PROMPT_LENS]
    cache_len = max(PROMPT_LENS) + GEN + 1
    config = EngineConfig(slots=SLOTS, cache_len=cache_len, max_new=GEN)

    # warm-up (cuBLAS handles, allocator): one short request, not counted
    DecodeEngine(model, params, config).run(
        [Request(rid="warm", tokens=prompts[4], max_new=2)])

    engine = DecodeEngine(model, params, config)
    reqs = [Request(rid=i, tokens=p, max_new=GEN)
            for i, p in enumerate(prompts)]
    arrivals = [i * STAGGER for i in range(len(reqs))]
    fa.flash_attention_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run(reqs, arrivals=arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.flash_attention_cuda.launches
    want_launches = len(reqs) * cfg.num_layers
    print(f"serve: DecodeEngine.run {len(reqs)} requests x {GEN} tokens in "
          f"{wall:.3f} s = {len(reqs) * GEN / wall:.1f} tok/s "
          f"({engine.stats['steps']} decode steps, {engine.stats['inserts']} "
          f"inserts); flash_attention launches {launches}", flush=True)
    if launches != want_launches:
        raise AssertionError(f"flash_attention launched {launches} times on "
                             f"the serve path, expected {want_launches}")
    for i, S in enumerate(PROMPT_LENS):
        toks = done[i].tokens
        if toks.shape != (GEN,) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"request {i}: bad tokens {toks}")
        if done[i].prompt_len != S:
            raise AssertionError(f"request {i}: prompt_len {done[i].prompt_len}")

    # prefill logits through the kernel vs the plain PyTorch attention path,
    # in bf16 and with the same weights in fp32
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = get_model(cfg32)
    params32 = _tree_map(params, lambda t: t.float())
    prefill_ms, checks = [], []
    for i, p in enumerate(prompts):
        batch = {"tokens": torch.tensor(p, dtype=torch.long,
                                        device="cuda")[None]}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lk, _ = model.prefill(params, batch, cache_len=cache_len,
                              impl="flash")
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        lp, _ = model.prefill(params, batch, cache_len=cache_len, impl="ref")
        lk32, _ = model32.prefill(params32, batch, impl="flash")
        lp32, _ = model32.prefill(params32, batch, impl="ref")
        lk, lp, lk32, lp32 = (t[0, -1] for t in (lk, lp, lk32, lp32))
        for name, t in (("bf16", lk), ("fp32", lk32)):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"request {i}: non-finite {name} logits")
        err = (lk - lp).abs().max().item()
        err32 = (lk32 - lp32).abs().max().item()
        noise = (lp - lp32).abs().max().item()
        top2 = lp.topk(2).values
        margin = (top2[0] - top2[1]).item()
        agree = int(lk.argmax()) == int(lp.argmax())
        tol, tol32 = LOGIT_ATOL["bfloat16"], LOGIT_ATOL["float32"]
        print(f"serve: request {i} S={PROMPT_LENS[i]} prefill "
              f"{prefill_ms[-1]:.2f} ms; logits kernel vs plain: bf16 "
              f"max_abs_err {err:.4f} (tol {tol}; noise: plain bf16 vs fp32 "
              f"{noise:.4f}), fp32 {err32:.3e} (tol {tol32}); top-2 margin "
              f"{margin:.4f}, argmax {'agrees' if agree else 'differs'}",
              flush=True)
        if err > tol or err32 > tol32:
            raise AssertionError(f"request {i}: prefill logits through the "
                                 f"kernel differ from the plain path by "
                                 f"{err} (bf16) / {err32} (fp32)")
        if margin > tol and not agree:
            raise AssertionError(f"request {i}: argmax differs with top-2 "
                                 f"margin {margin} > {tol}")
        if int(done[i].tokens[0]) != int(lk.argmax()):
            raise AssertionError(f"request {i}: the engine's first token is "
                                 f"not the kernel prefill's argmax")
        checks.append({"S": PROMPT_LENS[i], "bf16_max_abs_err": err,
                       "fp32_max_abs_err": err32,
                       "bf16_plain_vs_fp32": noise, "top2_margin": margin,
                       "argmax_agrees": agree})
    del params32
    served_ratio = served_kernel_check(torch, fa, model, params, prompts,
                                       cache_len)

    rec = engine_microbench(model, params, slots=SLOTS,
                            prompt_len=max(PROMPT_LENS), gen=GEN, reps=3,
                            seed=seed)
    watts = power_limit_watts(card)
    at_limit = measured_cost(rec, watts=watts)
    print(f"serve microbench on {card}: prefill (S={rec['prompt_len']}) "
          f"{rec['prefill_ms']:.3f} ms = {rec['prefill_tok_s']:.0f} tok/s; "
          f"decode step ({SLOTS} slots) {rec['decode_step_ms']:.3f} ms = "
          f"{rec['decode_tok_s']:.1f} tok/s; insert {rec['insert_ms']:.3f} ms;"
          f" J/token decode {rec['joules_per_decode_token_measured']:.3e} at "
          f"the nominal {rec['device_watts']} W, "
          f"{at_limit.joules_per_decode_step:.3e} at the card's {watts} W "
          f"limit (an upper bound: draw not measured)", flush=True)
    # where the time goes: one prefill at S=2048 and one decode step,
    # under the profiler
    busy = DecodeEngine(model, params, config)
    for i in range(SLOTS):
        busy.prefill_request(Request(rid=i, tokens=prompts[i], max_new=GEN))
    pos, active, gen_idx = (busy._host_vector(a) for a in
                            (busy._pos, busy._active, busy._gen))
    batch = {"tokens": torch.tensor(prompts[0], dtype=torch.long,
                                    device="cuda")[None]}
    profiles = {
        "prefill_2048": device_profile(
            torch, lambda: model.prefill(params, batch, cache_len=cache_len)),
        "decode_step_4_slots": device_profile(
            torch, lambda: busy._step(pos, active, gen_idx)),
    }
    for name, prof in profiles.items():
        print(f"profile {name}: wall {prof['wall_ms']:.3f} ms, device busy "
              f"{prof['device_ms']:.3f} ms ({prof['device_share']:.1%}), "
              f"{prof['kernels']} kernels; top: "
              + "; ".join(f"{n} {ms:.3f} ms" for n, ms in prof["top"][:5]),
              flush=True)

    return {"arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
            "prompt_lens": list(PROMPT_LENS), "gen": GEN, "slots": SLOTS,
            "stagger": STAGGER, "wall_s": wall,
            "tok_s": len(reqs) * GEN / wall, "stats": engine.stats,
            "flash_launches": launches, "prefill_ms": prefill_ms,
            "prefill_logit_checks": checks, "profiles": profiles,
            "served_kernel_worst_err_over_bound": served_ratio,
            "microbench": rec,
            "joules_per_decode_token_at_power_limit":
                at_limit.joules_per_decode_step}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="write the JSON record of the run here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card (torch.cuda.is_available() "
                         "is False)")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        raise SystemExit(f"chip_smoke: {SRC}/repro_torch not found; run from "
                         f"a checkout of the repo")
    sys.path.insert(0, SRC)
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    # the port is held to float32 where it computes in float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = nvidia_smi()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda},"
          f" {torch.cuda.get_device_name(0)}; allow_tf32=False", flush=True)
    seconds = build.build("flash_attention")
    print("kernel library build: " + (f"{seconds:.2f} s" if seconds is not None
                                      else "already built"), flush=True)
    for line in build.ptxas_log("flash_attention").splitlines():
        if ("entry function" in line or "registers" in line
                or "spill" in line):
            print("ptxas:", line.strip())

    kernel = kernel_phase(torch, fa, args.seed)
    serve = serve_phase(torch, fa, args.seed, card)
    kernel["launches"] = serve["flash_launches"]

    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "kernels": [kernel], "serve": serve}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)

    print(json.dumps({"kernels": [kernel]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
