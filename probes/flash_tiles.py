#!/usr/bin/env python3
"""The flash-attention kernel's instantiations against their plain version,
and the bf16 ones timed at the serving shapes, on the card.

    python3 probes/flash_tiles.py [--quick | --time-only] [--dims 64,256]
    python3 probes/flash_tiles.py --plant 64:128:1 [--quick | --time-only]

Builds ``csrc/flash_attention.cu``, prints what ``ptxas`` reports for each
instantiation (registers, shared memory, spills), then for every (dtype,
head dim) the C entry takes (``tile_sizes``) holds the kernel against
``flash_attention_plain`` within ``kernel_tolerance`` (B = 2, GQA 8/2 and
MQA 4/1, S in {1, 200, 777}, the three masks).  Then it times each bf16
head dim at S = 2048 (B = 1, causal): H = 32, K = 8 at D = 64 and 128,
H = 10, K = 1, window 2048 at D = 256; device time from ``torch.profiler``
and CUDA events, beside ``scaled_dot_product_attention`` by the same two
clocks (timed only) and the bound.  ``--quick`` checks S = 200 only and
skips the timing; ``--time-only`` skips the checks; ``--dims`` keeps only
the given head dims.

``--plant D:BQ:BLOCKS`` measures a bf16 tile that does not ship: in a copy
of the checkout (``probes/plant.py``; never in the checkout itself) the C
entry's instantiation for head dim D becomes ``launch_bf16<D, BQ, 64,
BLOCKS>`` (BQ query rows: 64 or 128, BLOCKS blocks an SM) and
``tile_sizes`` follows it, and the copy's probe runs for that head dim
alone.

Exits 1 if a check fails.  Needs one NVIDIA Hopper card.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))
sys.path.insert(0, REPO)

import chip_smoke as cs                                   # noqa: E402
from repro_torch.kernels import build                     # noqa: E402
from repro_torch.kernels import flash_attention as fa     # noqa: E402
from plant import plant                                   # noqa: E402

SHAPES = {64: (32, 8, 0), 128: (32, 8, 0), 256: (10, 1, 2048)}   # H, K, window
CU = os.path.join("src", "repro_torch", "kernels", "csrc", "flash_attention.cu")
PY = os.path.join("src", "repro_torch", "kernels", "flash_attention.py")


def plant_tile(spec: str, rest: list) -> int:
    """Run this probe in a copy of the checkout whose bf16 tile at head dim
    D is (BQ, 64) with BLOCKS blocks an SM; returns its exit code."""
    D, bq, blocks = (int(x) for x in spec.split(":"))
    edits = []
    for path, pat, new in ((CU, rf"launch_bf16<{D}, \d+, 64, \d+>",
                            f"launch_bf16<{D}, {bq}, 64, {blocks}>"),
                           (PY, rf"\(torch\.bfloat16, {D}\): \(\d+, 64\)",
                            f"(torch.bfloat16, {D}): ({bq}, 64)")):
        with open(os.path.join(REPO, path)) as f:
            found = re.findall(pat, f.read())
        if len(found) != 1:
            raise SystemExit(f"flash_tiles: --plant {spec} matched "
                             f"{len(found)} places in {path}")
        edits.append((path, found[0], new))
    with tempfile.TemporaryDirectory() as work:
        plant(work, edits, extra=[os.path.join("probes", name)
                                  for name in ("flash_tiles.py", "plant.py")])
        print(f"planted bf16 D={D}: tiles ({bq}, 64), {blocks} blocks an SM",
              flush=True)
        return subprocess.run([sys.executable,
                               os.path.join(work, "probes", "flash_tiles.py"),
                               "--dims", str(D), *rest]).returncode


def check(q, k, v, causal, window):
    got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    tol = fa.kernel_tolerance(q, k, v, want, causal=causal, window=window)
    err = (got.float() - want.float()).abs()
    ok = bool(torch.isfinite(got).all()) and bool((err <= tol).all())
    return ok, err.max().item(), (err / tol.clamp_min(1e-30)).max().item()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--time-only", action="store_true")
    ap.add_argument("--dims", default=",".join(map(str, fa.HEAD_DIMS)))
    ap.add_argument("--plant", metavar="D:BQ:BLOCKS")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_tiles: no CUDA card")
    if args.plant:
        return plant_tile(args.plant,
                          [f for f in ("--quick", "--time-only")
                           if getattr(args, f[2:].replace("-", "_"))])
    dims = [int(d) for d in args.dims.split(",")]
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi(), "| torch", torch.__version__, "CUDA",
          torch.version.cuda, flush=True)
    print(subprocess.run([build.nvcc(), "--version"], capture_output=True,
                         text=True).stdout.strip().splitlines()[-1])
    secs = build.build("flash_attention")
    print(f"nvcc flash_attention: {secs} s", flush=True)
    for line in build.ptxas_log("flash_attention").splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "arning", "rror")):
            print("ptxas:", line.strip())

    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = 0
    seqs = (200,) if args.quick else (1, 200, 777)
    for dt in [] if args.time_only else fa.DTYPES:
        for D in dims:
            bq, bk = fa.tile_sizes(D, dt)
            for B, H, K in ((2, 8, 2), (2, 4, 1)):
                for S in seqs:
                    q, k, v = ((torch.randn((B, S, h, D), generator=gen,
                                            device="cuda") * 0.5).to(dt)
                               for h in (H, K, K))
                    for causal, window in ((True, 0), (True, 64), (False, 0)):
                        try:
                            ok, err, ratio = check(q, k, v, causal, window)
                            msg = (f"max_abs_err {err:.3e} worst err/bound "
                                   f"{ratio:.4f} {'ok' if ok else 'FAIL'}")
                        except Exception as e:          # report and go on
                            ok, msg = False, f"ERROR {type(e).__name__}: {e}"
                        failed += not ok
                        print(f"{str(dt)[6:]} D={D} tiles ({bq}, {bk}) B={B} "
                              f"H={H} K={K} S={S} causal={causal} "
                              f"window={window}: {msg}", flush=True)
    if failed or args.quick:
        print(f"{failed} checks failed")
        return 1 if failed else 0

    F = torch.nn.functional
    reps = 20
    for D in dims:
        H, K, window = SHAPES[D]
        S, dt = 2048, torch.bfloat16
        q, k, v = ((torch.randn((1, S, h, D), generator=gen, device="cuda")
                    * 0.5).to(dt) for h in (H, K, K))
        run = lambda: fa.flash_attention_cuda(q, k, v, window=window)
        ev = cs.cuda_ms(run, 50, torch)
        prof = cs.device_profile(torch, lambda: [run() for _ in range(reps)])
        dev = sum(ms for n, ms in prof["all"] if "flash" in n) / reps
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
        lib_ev = cs.cuda_ms(sdpa, 50, torch)
        lib_dev = cs.device_profile(
            torch, lambda: [sdpa() for _ in range(reps)])["device_ms"] / reps
        flops, nbytes = cs.attention_work(1, S, H, K, D, True, window, 2)
        bound = max(flops / cs.PEAK_FLOPS["bfloat16"],
                    nbytes / cs.PEAK_BYTES) * 1e3
        print(f"time bf16 D={D} tiles {fa.tile_sizes(D, dt)} H={H} K={K} "
              f"S={S} window={window}: profiler {dev:.4f} ms, events "
              f"{ev:.4f} ms; sdpa profiler {lib_dev:.4f} ms, events "
              f"{lib_ev:.4f} ms; bound {bound:.5f} ms ({bound / dev:.1%} of "
              f"it)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
