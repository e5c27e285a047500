#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--seed N]

Needs one NVIDIA card (Hopper: the kernels are built for sm_90a) and a
checkout of this repo around it; exits non-zero, printing no result,
without either.  Phases, each of which raises on a failed check:

1. Environment: the card's name and power limit, torch and CUDA versions,
   and the time to build the kernel libraries from ``src/repro_torch/
   kernels/csrc`` (one ``nvcc`` per source, all started together).
2. Kernels: ``flash_attention`` on the card against its plain PyTorch
   version on the same inputs within ``kernel_tolerance``, in bf16 and
   fp32, causal, causal with window 256 and non-causal: at the
   granite-3-2b prefill shapes (B=1, H=32, K=8, D=64; S in {1, 127, 128,
   777, 2048}), D=128 at S=1024 (granite-8b), recurrentgemma-2b's
   attention (H=10, K=1, D=256; S in {1, 127, 2048}, also with its window
   2048), B=2 at S=777 for each head dim, olmoe-1b-7b's (H = K = 16) and
   internvl2-76b's (H=64, K=8) at D=128, S=777, and q, k, v as views of
   one fused (B, S, H+2K, D) projection.  Times the bf16 kernel (device
   time from ``torch.profiler``, and CUDA events), its plain version and
   one library call (``scaled_dot_product_attention``, timed here only,
   never called by the port) at S=2048, causal, at the five models'
   shapes, beside the card's bound.
3. fused_agg kernel: ``fused_agg_cuda`` against ``fused_agg_plain`` within
   ``fused_agg.kernel_tolerance``, on every leaf of the CIFAR CNN at C=40
   with s = mask p E from a sustainable round (p = 1/40, E in {1, 5, 10,
   20}), on ragged M in {1, 257, 16385} in fp32 and bf16, on a bf16
   granite-3-2b MLP weight (2048 x 8192) at C=8, and with s = 0 (out must
   equal w exactly); the whole CNN tree in one launch
   (``ops.fused_agg_tree``), bitwise equal to one launch a leaf.  Times
   the tree and fc1.w alone (C=40, M=1,572,864, fp32): the kernel's device
   time (``torch.profiler``) and CUDA events, the plain version and the
   library call (``torch.addmv``, one a leaf: ten for the tree; timed
   here only, never called by the port) beside the card's bound.
4. Serve: granite-3-2b at full width and depth (40 layers, bf16, random
   weights from ``--seed``) through ``DecodeEngine.run``: 4 slots, 6 greedy
   requests of 32 new tokens, arrivals 2 steps apart, prompt lengths
   {2048, 1537, 777, 1024, 129, 1999}.  Every kernel's launch count is set
   to 0 just before the run and read just after (6 prefills x 40 layers =
   240 flash launches).  Each request's prefill logits through the kernel
   are then held against the plain PyTorch attention path (``impl="ref"``),
   in bf16 and with the same weights in fp32; the engine's per-stage
   microbenchmark, a profile of one prefill and one decode step (wall
   time, device-busy time, kernel count) and flash's share of the S=2048
   prefill's device time are printed.
5. Train: ``repro_torch.launch.train``'s path (``make_run`` ->
   ``train_round`` -> ``core.round.parallel_round``) with the paper's §V
   setup: the CIFAR CNN at full width (1,702,794 params, fp32, TF32 off:
   set on before ``make_run`` and asserted off after it), N=40 clients,
   taus (1, 5, 10, 20), T=5, batch 24, Adam lr 1e-3, p = 1/40; 5 rounds
   of ``sustainable`` and 3 of ``wait_all`` (the loss is 0 from round 4
   on).  Every kernel's count is set to 0 before each run and read after
   it (one fused_agg launch per round: the whole tree).  The card's masks must equal the
   CPU's bitwise, no-op rounds must leave the model bitwise unchanged, and
   the loss must fall.  Sustainable rounds 0, 2 and 3 and wait_all round
   0 (rounds 1 and 4 are left out for time: ~1 min each) are run again
   from the card's params before them: on the card through
   ``core.replay_round``, which reads out every local step's max-pool and
   ReLU decisions and must equal the round bitwise, and on the CPU
   replaying those decisions in float32 and in float64.  The card's round
   must agree with the CPU's float32 round (loss to 1e-4, 90% of the params
   to 1e-6 (1 + |w|), or to the CPU's own float32 distance from float64
   where that is larger) and lie within one round's Adam bound.  Two SGD
   rounds (lr 1e-2) through the same entry point are held elementwise, to
   1e-6 + 1e-5 |w|, against their float64 replays.  Prints per-round ms,
   client-steps/s and a profile of one round.
6. Fig. 1: ``repro_torch.launch.fig1.run_fig1`` for 20 rounds under
   ``sustainable`` and ``greedy`` (N=40, the faithful participants-only
   driver), with test accuracy, which must be above chance.
7. fleet_step kernel (run after phase 3): ``fleet_step_cuda`` against
   ``fleet_step_plain`` for every gate (sustainable, threshold, greedy),
   with and without histograms, groups (G=3) and mask output, at ragged
   n in {1, 257, 65537}, with per-client battery fields and costs, and at
   n = 10,000,000: every per-client output bitwise, the stats within
   ``fleet_step.kernel_tolerance`` of their float64 sums (histogram counts
   exact), and bitwise on a dyadic configuration.  Times the main path's
   instantiation at n = 10,000,000 (device time of its two launches from
   ``torch.profiler``, and CUDA events around back-to-back calls, which
   include the wrapper's host time) against its plain version and the
   bytes bound (``step_ops.bytes_moved``; no library call computes it).
8. Fleet: ``repro_torch.launch.fleet``'s path, ``examples/energy_fleet.py``'s
   scenario at N = 1,000,000: 150 rounds each of sustainable, greedy and
   threshold 1.5 with histograms, and one grouped sustainable run; every
   kernel's count is set to 0 before each run and read after it (one
   fleet_step launch a round, no other kernel), energy is conserved every
   round and each histogram counts N clients.  Then the card against the
   chip machine's CPU: a
   Bernoulli fleet for 10 rounds (masks, charge, streak and counts
   bitwise), the scenario's first 2 rounds per policy (its exponential
   marks are ulp-close, so up to 1e-5 N clients may land on the other
   side of a threshold or bin edge; energy stats to 1e-5), and the
   8-client closed loop through ``core.simulate``.  Prints rounds/s,
   client-rounds/s and a profile of one round.
9. serve_step kernel (run after phase 7): ``fleet_step_cuda`` on the serve
   program (``csrc/serve_step.cu``) against ``fleet_step_plain`` for every
   admission rule (agnostic, battery-gated, charge-gated) and training
   gate (none, sustainable, threshold, greedy), with and without
   histograms and mode output, at n in {1, 257, 65537}, with per-client
   battery, prices, token budgets and thresholds, on a dyadic
   configuration (every stat bitwise), with every per-client input a view
   at a 4-byte offset (the kernel's scalar path), at n one client either
   side of one and two strides of the persistent grid, and at n =
   10,000,000: charge, streak and mode bitwise, the stats within
   ``kernel_tolerance`` (histogram counts exact).  Prints the launch shape
   (grid, blocks an SM, the occupancy CUDA reports) and times the main
   path's instantiation at n = 10,000,000 (battery-gated, sustainable
   training, hist): its one launch by ``torch.profiler`` and CUDA events,
   and the fold alone in a launch of its own.
10. Serving fleet: ``repro_torch.launch.serve_fleet``'s path,
   ``examples/serve_fleet.py``'s scenario at N = 1,000,000 for 192 epochs:
   the agnostic, gated and controlled runs (the last with histograms);
   every kernel's count is set to 0 before each run and read after it (one
   serve-program launch an epoch, no other kernel); every epoch conserves
   energy and the request ledger (offered == served + shed + missed) and
   each histogram counts N clients.  Then the card against the chip
   machine's CPU: a Constant-traffic, Bernoulli-harvest fleet for 10
   controlled epochs (modes, charge, streak, ledger and counts bitwise),
   the scenario's first 2 epochs per run (ulp-close draws: up to 1e-5 N
   mode flips), a 30-round ``energy.control.run_controlled`` fleet (N =
   20,000, grouped cadence and budget rules) and the 8-client closed loop
   with a ``ServerController`` through ``core.simulate``.  Prints
   epochs/s, client-epochs/s and a profile of one epoch.
11. ssd_scan kernel (run after phase 9): ``ssd_scan_cuda`` against
   ``ssd_scan_plain`` on the same inputs, y and the final state within
   ``ssd_scan.kernel_tolerance``, at the mamba2-1.3b prefill shape (B=1,
   H=64, P=64, N=128, one group, chunk 256; S in {256, 512, 2048, 4096}:
   one chunk up to a chain of 16), at B=2 with groups pre-repeated to
   heads and chunk 16 and with 8 groups at chunk 256, each in bf16 and
   fp32, and the reference's state-carry case (dt 0.05, A -0.01, a unit
   impulse at t=0, S=1024: the last chunk must still see token 0).  Times
   the kernel (device time from ``torch.profiler``, each of its kernels by
   name, and CUDA events) and its plain version at S=2048, bf16, beside the
   card's bound with its terms (C B^T and the split products on the tensor
   cores, the bytes) and its CUDA-core pricing; no single
   PyTorch call computes the scan.
12. Serve Mamba2 (run after phase 4): mamba2-1.3b at full width and depth
   (48 layers, bf16, random weights from ``--seed``) through
   ``DecodeEngine.run``: 4 slots, 6 greedy requests of 32 new tokens,
   arrivals 2 steps apart, prompt lengths {2048, 1536, 768, 1024, 129,
   2048}; five are multiples of the chunk (256) and take the kernel, 129
   the per-step recurrence, as in the reference.  Every kernel's launch
   count is set to 0 just before the run and read just after (5 x 48 =
   240 ssd_scan launches, no other kernel).  Each request's last-position
   prefill logits and prefilled SSM states through the kernel are held
   against the plain chunked path (``impl="ref"``), in bf16 and with the
   weights upcast to fp32; then tok/s, the engine's per-stage
   microbenchmark and a profile of one S=2048 prefill and one decode step.
13. Sharded fleet (run after phases 8 and 10): the client axis over
   ``torch.distributed`` ranks (``simulate_fleet`` / ``run_serve_
   controlled`` with ``mesh=``).  (a) One NCCL rank on cuda:0 at full
   size: the example's fleet scenario at N = 1,000,000, 150 sustainable
   rounds with histograms and masks, and the serving scenario's controlled
   run, 192 epochs with modes: every stat, mask, mode, charge and count
   bitwise equal to the same run host-local on the card, one step kernel
   and one finalize a round or epoch and no other kernel, and each round's
   finalize bitwise equal to its plain version (``step_ops.row_stats``)
   on the row the round all-reduced; rounds/s and epochs/s beside the
   host-local runs'; the all-reduce of a round's row alone, the finalize
   launches' device time (``torch.profiler``) on the last round's row,
   and the kernels one sharded round and one sharded epoch record, by
   name.
   (b) Two gloo ranks sharing cuda:0 (spawned as this script with
   ``--sharded-child``, a deadline on both): a dyadic Bernoulli fleet at N
   = 1,000,001 (padded) for 20 rounds of each fleet policy with histograms
   and groups (G = 3), a Constant-traffic, Bernoulli-harvest serving fleet
   for 10 controlled epochs, and a fleet of 2^24 + 2 clients padded so
   that one rank counts 2^24 + 1 clients in a bin: bitwise to host-local
   on the card; the scenarios' first 2 rounds and epochs: per-client
   outputs and counts bitwise, the other stats within
   ``kernel_tolerance(..., world=2)`` of their exact values (from each
   round's inputs, recorded in the host-local run); on each rank every
   round's finalize bitwise equal to ``step_ops.row_stats`` on its
   all-reduced row.

14. Serve MoE: olmoe-1b-7b at full width and depth (16 layers, 64 experts
   top-8, H = K = 16, head dim 128, bf16, ``moe_mode="dense"`` as
   configured, random weights from ``--seed``) through
   ``DecodeEngine.run`` on phase 4's workload (6 x 16 = 96 flash
   launches, counts set to 0 just before and read just after); prefill
   logits kernel vs plain in bf16 and fp32 (``LOGIT_ATOL``), the bf16
   kernel on the served q, k, v of every layer, the per-stage
   microbenchmark and flash's share of one S=2048 prefill.  Then the same
   workload with ``moe_mode="sorted"`` (96 launches again): its batched
   engine's tokens against a slot-by-slot decode (batch 1), reported in
   bf16 and held in fp32 (they may part only at a near-tie, ``NEAR_TIE``).
15. Serve VLM: internvl2-76b's trunk at full width (d_model 8192, H = 64,
   K = 8, head dim 128, d_ff 28672, vocab 128256, bf16), its 80 layers cut
   to 8; 3 requests with 256 vision rows each through ``Request.extras``,
   prompts {2048, 777, 300}, 16 tokens each (3 x 8 = 24 flash launches);
   the same checks as phase 14, and the vision rows must move the logits.
16. Train LM: ``repro_torch.launch.train``'s path on granite-3-2b at full
   width (its 40 layers cut to 4, or to 2 if 4 peak above 70 GB), 8
   clients, taus (1, 2, 4, 8), T = 5 Adam steps of 4 x 512 tokens, 3
   sustainable rounds after a warm-up: two fused_agg launches a round (one
   a dtype: fp32 norms, bf16 weights) and no other kernel, every leaf the
   kernel wrote within ``kernel_tolerance`` of ``fused_agg_plain`` on the
   round's own stacked tree, the loss falls; the kernel's device time on
   that tree beside its bytes bound, its plain version and one addmv a
   leaf.  Then round 0 of granite-3-2b's smoke config and of olmoe-1b-7b's
   in each MoE mode, fp32, on the card against the CPU from the card's
   params (phase 5's bounds; MoE losses within 1e-5).

Every profile must record the kernels its window launched (the port's
launch counts say how many), or it is taken again, and after ten the
run fails.

Prints one ``{"kernels": [...]}`` line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  ``--out PATH`` also writes a
JSON record of every number measured.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

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

# the training phase: the paper's §V setup, cut to a few rounds
TRAIN = dict(clients=40, local_steps=5, batch=24, taus=(1, 5, 10, 20),
             lr=1e-3)
TRAIN_ROUNDS = {"sustainable": 5, "wait_all": 3}
# the rounds replayed on the CPU (~1 min each): sustainable rounds 1 and 4
# (loss 0 from round 4 on) are left out to keep the script within its time
TRAIN_REPLAY = {"sustainable": (0, 2, 3), "wait_all": (0,)}
# each round of the card with participants, against the same round on
# the CPU from the card's params before it, every max-pool and ReLU taking
# the card's decision of the same step and client (``replay_round``; a
# float32 near-tie, two candidates one or two ulps apart, may otherwise
# route a client's gradient elsewhere), in float32 and in float64:
# - the round's loss within 1e-4 relative, or within the CPU's own float32
#   distance from float64 where that is larger;
# - 90% of the params within 1e-6 (1 + |w|), or within the 90% quantile
#   of the CPU's own float32 distance from float64 where that is larger
#   (once the loss is small, Adam turns float32 noise in small gradients
#   into steps: ~1e-4 of it in round 3, on the CPU as on the card);
# - every param within the hard Adam bound of one round
#   (``adam_step_bound``).
# And SGD rounds, elementwise: every param within 1e-6 + 1e-5 |w| of the
# float64 replay.
LOSS_RTOL = 1e-4
BULK_Q, BULK_TOL = 0.9, 1e-6
SGD_CHECK = dict(policy="sustainable", optimizer="sgd", lr=1e-2, rounds=2)
FIG1_ROUNDS = 20

PROMPT_LENS = (2048, 1537, 777, 1024, 129, 1999)
GEN = 32
SLOTS = 4
STAGGER = 2

# the Mamba2 serve phase: five prompt lengths are multiples of the chunk
# (256) and take the ssd_scan kernel; 129 takes the per-step recurrence
MAMBA_PROMPT_LENS = (2048, 1536, 768, 1024, 129, 2048)
# Prefill of mamba2-1.3b (48 layers, random init), kernel path vs the plain
# chunked path on the same weights.  The kernel and the plain scan are both
# float32 and differ by summation order only (``ssd_scan.kernel_tolerance``,
# held in phase 11, and layer by layer on the served prompts' own inputs,
# ``served_ssd_check``), ~1e-6 of a layer's output.  bf16, the served
# dtype: such a difference moves a bf16 rounding of the scan's consumers now
# and then, by one bf16 ulp (2^-8 relative), and the moved roundings travel
# through every later layer, as rounding P did for granite's flash path
# (LOGIT_ATOL): the two paths then differ by a second draw of the bf16
# rounding noise through depth.  So logits within 0.5, and the prefilled
# SSM states (the largest |difference| of a layer over that layer's largest
# |h|, the worst layer) within twice the plain path's own distance from its
# fp32 twin, measured the same way.  These two bf16 checks are sanity
# checks only (finite, of the noise's scale): the state bound scales with
# the bf16 noise of the same run, so it cannot tell a wrong kernel from
# bf16 chaos.  The checks that decide are the fp32 ones (the weights
# upcast, TF32 off: summation order only, through 48 layers: logits within
# 1e-3, states within 1e-3 of the layer's largest |h|) and the bf16 kernel
# layer by layer on the served inputs within ``kernel_tolerance``.
SSM_LOGIT_ATOL = {"bfloat16": 0.5, "float32": 1e-3}
SSM_STATE_RTOL_FP32 = 1e-3
SSM_STATE_NOISE_FACTOR = 2.0
# the ssd_scan phase: mamba2-1.3b's prefill layout
SSD_WIDTHS = dict(H=64, P=64, N=128)
SSD_CHUNK = 256
# S = 256 is one chunk (no state to carry between chunks); 4096 the longest
# chain of carried states
SSD_SEQS = (256, 512, 2048, 4096)
SSD_GROUPS = 8                      # the B = 2 grouped case: 8 heads a group


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


def queued_ms(torch, fn, reps: int) -> float:
    """Mean device ms per call of ``fn`` between CUDA events, the calls'
    launches queued behind a sleeping kernel so that the card runs them
    back to back, with no host time between them (after one warm-up
    call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)          # ~60 ms of device time
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# the port's kernels as a profile names them, by the launch count that
# counts them: (substrings of a kernel's name, kernels recorded a launch)
PROFILE_NAMES = {
    "flash_attention": ((("flash_fwd_bf16", "flash_fwd_f32"), 1),),
    "fused_agg": ((("fused_agg_kernel",), 1),),
    "fleet_step": ((("fleet_step_kernel",), 1), (("fleet_step_reduce",), 1)),
    "serve_step": ((("serve_step_kernel",), 1),),
    # bf16 records three kernels a launch, fp32 one: the chunk pass or the
    # fp32 kernel is the one both record
    "ssd_scan": ((("ssd_scan_chunk_bf16", "ssd_scan_f32"), 1),),
    "fleet_step finalize": ((("fleet_step_finalize_kernel",), 1),),
    "serve_step finalize": ((("serve_step_finalize_kernel",), 1),),
}


class ProfileIncomplete(AssertionError):
    """A profile that did not record every kernel its window launched."""


def launched(torch, fn) -> dict:
    """{name substrings: kernels} of the port's kernels that one call of
    ``fn`` launches, from their wrappers' launch counts (read before and
    after the call, not reset) and ``PROFILE_NAMES``."""
    from repro_torch.kernels import ops

    def counts():
        return {**ops.launch_counts(), **{f"{k} finalize": v for k, v in
                                          ops.finalize_counts().items()}}

    before = counts()
    fn()
    torch.cuda.synchronize()
    after = counts()
    return {names: (after[wrapper] - before[wrapper]) * per_launch
            for wrapper, kinds in PROFILE_NAMES.items()
            for names, per_launch in kinds}


def device_profile(torch, fn, expect=None, calls: int | None = None,
                   tries: int = 10) -> dict:
    """Wall time, device-busy time and kernel count of one call of ``fn``
    (after a warm-up call), from ``torch.profiler``.  The profile must
    hold every kernel the call launched: ``expect`` maps a kernel-name
    substring (or a tuple of them) to the kernels of those names the call
    launches (written at the call site, or from `launched`); with
    ``calls`` (``fn`` calls one library function that many times, whose
    kernels the port does not count) each kernel name must be recorded a
    multiple of ``calls`` times; and some kernel must be recorded.  The
    profiler on the card has been seen to miss whole windows, so a profile
    short of this is taken again, up to ``tries`` times, and then this
    raises ProfileIncomplete.  The result says how many were taken."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    expect = {(k,) if isinstance(k, str) else k: v
              for k, v in (expect or {}).items()}
    fn()
    torch.cuda.synchronize()
    for taken in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation]
        short = []
        for names, want in expect.items():
            got = sum(e.count for e in kernels
                      if any(s in e.key for s in names))
            if got != want:
                short.append(f"{'|'.join(names)}: {got} of {want}")
        if calls:
            short += [f"{e.key[:60]}: {e.count}, not a multiple of {calls}"
                      for e in kernels if e.count % calls]
        if not kernels:
            short.append("no kernel recorded")
        if not short:
            break
        print(f"profile {taken} of {tries} incomplete: " + "; ".join(short),
              flush=True)
    else:
        raise ProfileIncomplete(f"torch.profiler missed kernels in {tries} "
                                f"profiles: " + "; ".join(short))
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_share": device_ms / wall_ms,
            "kernels": sum(e.count for e in kernels), "profiles": taken,
            "counts": {e.key: e.count for e in kernels},
            "top": [(e.key[:60], e.self_device_time_total / 1e3) for e in top],
            "all": [(e.key, e.self_device_time_total / 1e3) for e in kernels]}


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


# the flash checks: (B, H, K, D, sequence lengths, masks); the timed
# shapes: (name, H, K, D, window), B=1, S=2048, bf16, causal
FLASH_MASKS = ((True, 0), (True, 256), (False, 0))
FLASH_CASES = (
    [(1, 32, 8, 64, (1, 127, 128, 777, 2048), FLASH_MASKS),   # granite-3-2b
     (1, 32, 8, 128, (1024,), FLASH_MASKS),                    # granite-8b
     # recurrentgemma-2b: MQA, head dim 256, local window 2048
     (1, 10, 1, 256, (1, 127, 2048), FLASH_MASKS + ((True, 2048),))]
    + [(2, H, K, D, (777,), FLASH_MASKS)
       for H, K, D in ((32, 8, 64), (32, 8, 128), (10, 1, 256))]
    # olmoe-1b-7b (MHA) and internvl2-76b (H = 64, K = 8) at head dim 128
    + [(1, 16, 16, 128, (777,), FLASH_MASKS),
       (1, 64, 8, 128, (777,), FLASH_MASKS)])
FLASH_TIMED = (("granite-3-2b", 32, 8, 64, 0), ("granite-8b", 32, 8, 128, 0),
               ("recurrentgemma-2b", 10, 1, 256, 2048),
               ("olmoe-1b-7b", 16, 16, 128, 0), ("internvl2-76b", 64, 8, 128, 0))


def flash_inputs(torch, gen, B, S, H, K, D, dtype, fused=False):
    """q, k, v ~ 0.5 N in ``dtype``; ``fused``: views of one (B, S, H + 2K,
    D) projection, as a fused QKV matmul leaves them (strided heads)."""
    if fused:
        qkv = (torch.randn((B, S, H + 2 * K, D), generator=gen, device="cuda")
               * 0.5).to(dtype)
        return qkv.split([H, K, K], dim=2)
    return tuple((torch.randn((B, S, h, D), generator=gen, device="cuda")
                  * 0.5).to(dtype) for h in (H, K, K))


def kernel_phase(torch, fa, seed: int) -> dict:
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst = {"bfloat16": 0.0, "float32": 0.0}
    worst_ratio = {"bfloat16": 0.0, "float32": 0.0}
    cases = [(B, H, K, D, S, masks, False)
             for B, H, K, D, seqs, masks in FLASH_CASES for S in seqs]
    cases.append((2, 32, 8, 64, 777, FLASH_MASKS, True))
    for B, H, K, D, S, masks, fused in cases:
        for dname in ("bfloat16", "float32"):
            q, k, v = flash_inputs(torch, gen, B, S, H, K, D,
                                   getattr(torch, dname), fused)
            for causal, window in masks:
                err, ratio = check_kernel(
                    torch, fa, q, k, v, causal, window,
                    f"B={B} H={H} K={K} D={D} S={S}"
                    f"{' fused-qkv view' if fused else ''} {dname}")
                worst[dname] = max(worst[dname], err)
                worst_ratio[dname] = max(worst_ratio[dname], ratio)

    # timing at S=2048, bf16, causal: the kernel and one library call
    # (scaled_dot_product_attention, timed here only), each by device time
    # from torch.profiler and by CUDA events, its plain version (events)
    # and the bound
    S, reps, shapes = 2048, 10, []
    for name, H, K, D, window in FLASH_TIMED:
        q, k, v = flash_inputs(torch, gen, 1, S, H, K, D, torch.bfloat16)
        run = lambda: fa.flash_attention_cuda(q, k, v, window=window)
        event_ms = cuda_ms(run, 20, torch)
        prof = device_profile(torch, lambda: [run() for _ in range(reps)],
                              expect={"flash_fwd_bf16": reps})
        kernel_ms = sum(ms for n, ms in prof["all"] if "flash_fwd" in n) / reps
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(
            q, k, v, window=window), 3, torch)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # (B, heads, S, D)
        sdpa = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
        library_event_ms = cuda_ms(sdpa, 20, torch)
        lprof = device_profile(torch, lambda: [sdpa() for _ in range(reps)],
                               calls=reps)
        library_ms = lprof["device_ms"] / reps
        # window 2048 at S = 2048 masks nothing that causal does not
        lib_err = (sdpa().transpose(1, 2).float()
                   - run().float()).abs().max().item()
        flops, nbytes = attention_work(1, S, H, K, D, True, window, 2)
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        print(f"flash_attention {name} S={S} H={H} K={K} D={D} bf16 causal "
              f"window={window}: kernel {kernel_ms:.4f} ms of device time, "
              f"{event_ms:.4f} ms between CUDA events; plain {plain_ms:.4f} "
              f"ms; library sdpa {library_ms:.4f} ms of device time, "
              f"{library_event_ms:.4f} ms between events (|sdpa - kernel| max "
              f"{lib_err:.3e}); bound {bound:.5f} ms ({flops:.4g} FLOP, "
              f"{nbytes:.4g} B): kernel at {bound / kernel_ms:.1%} of it",
              flush=True)
        shapes.append({"shape": name, "B": 1, "S": S, "H": H, "K": K, "D": D,
                       "dtype": "bfloat16", "causal": True, "window": window,
                       "ms": kernel_ms, "event_ms": event_ms,
                       "plain_ms": plain_ms, "library_ms": library_ms,
                       "library_event_ms": library_event_ms,
                       "library_max_abs_diff": lib_err, "bound_ms": bound,
                       "bound_by": "operations" if t_ops >= t_bytes
                       else "bytes", "flops": flops, "bytes": nbytes})
    main = shapes[0]
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
        "ms": main["ms"],
        "event_ms": main["event_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "library_event_ms": main["library_event_ms"],
        "timed_at": {k: main[k] for k in ("shape", "B", "S", "H", "K", "D",
                                          "dtype", "causal", "window")}
        | {"ms, library_ms": "device time from torch.profiler",
           "event_ms, library_event_ms, plain_ms": "CUDA events"},
        "shapes": shapes,
    }


def served_kernel_check(torch, fa, model, params, prompts, cache_len,
                        device="cuda", extras=None, label="serve"):
    """The bf16 kernel on the served path's own inputs: record the q, k, v
    that every layer's prefill hands the kernel, for every prompt (with
    its ``extras[i]`` in the batch, if given), and hold the kernel against
    its plain version on each within ``kernel_tolerance``.  Returns the
    largest error / bound per prompt."""
    from repro_torch.kernels import ops

    real = ops.flash_attention
    worst = []
    for i, p in enumerate(prompts):
        calls = []

        def record(q, k, v, **kw):
            calls.append((q, k, v, kw))
            return real(q, k, v, **kw)

        batch = {"tokens": torch.tensor(p, dtype=torch.long,
                                        device=device)[None],
                 **{k: v[None] for k, v in (extras[i] if extras else
                                            {}).items()}}
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
        print(f"{label}: request {i} S={len(p)}: bf16 kernel vs plain on the "
              f"served q, k, v of all {len(res)} layers: max_abs_err "
              f"{max(e for e, _ in res):.3e}, worst err/bound {worst[-1]:.3f}"
              f" ok", flush=True)
    return worst


def serve_phase(torch, fa, seed: int, card: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
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
    ops.zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run(reqs, arrivals=arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    launches = counts["flash_attention"]
    want_launches = len(reqs) * cfg.num_layers
    print(f"serve: DecodeEngine.run {len(reqs)} requests x {GEN} tokens in "
          f"{wall:.3f} s = {len(reqs) * GEN / wall:.1f} tok/s "
          f"({engine.stats['steps']} decode steps, {engine.stats['inserts']} "
          f"inserts); launches {counts}", flush=True)
    if counts != {**dict.fromkeys(counts, 0),
                  "flash_attention": want_launches}:
        raise AssertionError(f"kernel launches on the serve path {counts}, "
                             f"expected {want_launches} of flash_attention "
                             f"and no other")
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
    prefill = lambda: model.prefill(params, batch, cache_len=cache_len)
    step = lambda: busy._step(pos, active, gen_idx)
    profiles = {
        "prefill_2048": device_profile(torch, prefill,
                                       launched(torch, prefill)),
        "decode_step_4_slots": device_profile(torch, step,
                                              launched(torch, step)),
    }
    for name, prof in profiles.items():
        print(f"profile {name}: wall {prof['wall_ms']:.3f} ms, device busy "
              f"{prof['device_ms']:.3f} ms ({prof['device_share']:.1%}), "
              f"{prof['kernels']} kernels; top: "
              + "; ".join(f"{n} {ms:.3f} ms" for n, ms in prof["top"][:5]),
              flush=True)
    prefill = profiles["prefill_2048"]
    flash_ms = sum(ms for n, ms in prefill["all"] if "flash_fwd" in n)
    print(f"serve: flash_attention in one S=2048 prefill: {flash_ms:.3f} ms "
          f"of {prefill['device_ms']:.3f} ms of device time "
          f"({flash_ms / prefill['device_ms']:.1%})", flush=True)

    return {"arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
            "prompt_lens": list(PROMPT_LENS), "gen": GEN, "slots": SLOTS,
            "stagger": STAGGER, "wall_s": wall,
            "tok_s": len(reqs) * GEN / wall, "stats": engine.stats,
            "flash_launches": launches, "prefill_ms": prefill_ms,
            "prefill_2048_flash_device_ms": flash_ms,
            "prefill_logit_checks": checks, "profiles": profiles,
            "served_kernel_worst_err_over_bound": served_ratio,
            "microbench": rec,
            "joules_per_decode_token_at_power_limit":
                at_limit.joules_per_decode_step}


def served_ssd_check(torch, ssd, model, params, prompts):
    """The bf16 kernel on the served path's own inputs: record the x, dt,
    A, B, C that every layer's chunked prefill hands ``ops.ssd_scan``, for
    every prompt that takes the kernel, and hold the kernel against its
    plain version on each within ``kernel_tolerance``.  Returns the largest
    error / bound per such prompt."""
    from repro_torch.kernels import ops

    real = ops.ssd_scan
    worst = []
    for i, p in enumerate(prompts):
        if len(p) % model.cfg.ssm_chunk:
            continue
        calls = []

        def record(*args, **kw):
            calls.append((args, kw["chunk"]))
            return real(*args, **kw)

        batch = {"tokens": torch.tensor(p, dtype=torch.long,
                                        device="cuda")[None]}
        ops.ssd_scan = record
        try:
            model.prefill(params, batch)
        finally:
            ops.ssd_scan = real
        if len(calls) != model.cfg.num_layers:
            raise AssertionError(f"request {i}: recorded {len(calls)} "
                                 f"kernel calls, expected one per layer")
        res = [ssd_check(torch, ssd, args, chunk,
                         f"served request {i} S={len(p)} layer {layer} "
                         f"{args[0].dtype}", show=False)
               for layer, (args, chunk) in enumerate(calls)]
        worst.append(max(r for _, _, r in res))
        print(f"serve mamba2: request {i} S={len(p)}: bf16 kernel vs plain on "
              f"the served x, dt, A, B, C of all {len(res)} layers: "
              f"max_abs_err {max(e for _, e, _ in res):.3e}, worst err/bound "
              f"{worst[-1]:.4f} ok", flush=True)
    return worst


def mamba2_serve_phase(torch, ssd, seed: int, card: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import seeded_generators
    from repro_torch.models import get_model
    from repro_torch.serve.engine import DecodeEngine, EngineConfig, Request
    from repro_torch.serve.microbench import engine_microbench, measured_cost

    cfg = get_config("mamba2-1.3b")
    model = get_model(cfg)
    g_params, g_prompt, _ = seeded_generators(seed, torch.device("cuda"))
    t0 = time.perf_counter()
    params = model.init_params(g_params)
    torch.cuda.synchronize()
    print(f"serve mamba2: {cfg.name} {cfg.num_layers} layers d_model="
          f"{cfg.d_model} {cfg.ssm_heads} heads x {cfg.ssm_head_dim}, state "
          f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}, {cfg.dtype}, "
          f"{model.num_params(params):,} params made on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    prompts = [torch.randint(0, cfg.vocab_size, (S,), generator=g_prompt,
                             device="cuda").cpu().numpy()
               for S in MAMBA_PROMPT_LENS]
    cache_len = max(MAMBA_PROMPT_LENS) + GEN + 1
    config = EngineConfig(slots=SLOTS, cache_len=cache_len, max_new=GEN)

    # warm-up (cuBLAS handles, allocator, the kernel library): one short
    # chunked request, not counted
    DecodeEngine(model, params, config).run(
        [Request(rid="warm", tokens=prompts[2][:cfg.ssm_chunk], max_new=2)])

    engine = DecodeEngine(model, params, config)
    reqs = [Request(rid=i, tokens=p, max_new=GEN)
            for i, p in enumerate(prompts)]
    arrivals = [i * STAGGER for i in range(len(reqs))]
    ops.zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run(reqs, arrivals=arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    chunked = sum(S % cfg.ssm_chunk == 0 for S in MAMBA_PROMPT_LENS)
    want = {**dict.fromkeys(counts, 0),
            "ssd_scan": chunked * cfg.num_layers}
    print(f"serve mamba2: DecodeEngine.run {len(reqs)} requests x {GEN} "
          f"tokens in {wall:.3f} s = {len(reqs) * GEN / wall:.1f} tok/s "
          f"({engine.stats['steps']} decode steps, {engine.stats['inserts']} "
          f"inserts); launches {counts}", flush=True)
    if counts != want:
        raise AssertionError(f"kernel launches on the Mamba2 serve path "
                             f"{counts}, expected {want}")
    for i, S in enumerate(MAMBA_PROMPT_LENS):
        toks = done[i].tokens
        if toks.shape != (GEN,) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"request {i}: bad tokens {toks}")
        if done[i].prompt_len != S:
            raise AssertionError(f"request {i}: prompt_len {done[i].prompt_len}")

    # prefill logits and states through the kernel vs the plain chunked
    # path, in bf16 and with the same weights in fp32
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = get_model(cfg32)
    params32 = _tree_map(params, lambda t: t.float())

    def state_err(a, b):
        """Largest |a - b| of each layer over that layer's largest |b|."""
        scale = b.flatten(1).abs().amax(1).clamp_min(1e-30)
        return ((a - b).flatten(1).abs().amax(1) / scale).max().item()

    prefill_ms, checks = [], []
    for i, p in enumerate(prompts):
        batch = {"tokens": torch.tensor(p, dtype=torch.long,
                                        device="cuda")[None]}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lk, ck = model.prefill(params, batch)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        lp, cp = model.prefill(params, batch, impl="ref")
        lk32, ck32 = model32.prefill(params32, batch)
        lp32, cp32 = model32.prefill(params32, batch, impl="ref")
        lk, lp, lk32, lp32 = (t[0, -1] for t in (lk, lp, lk32, lp32))
        for name, t in (("bf16", lk), ("fp32", lk32)):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"request {i}: non-finite {name} logits")
        err = (lk - lp).abs().max().item()
        err32 = (lk32 - lp32).abs().max().item()
        serr = state_err(ck["ssm"], cp["ssm"])
        serr32 = state_err(ck32["ssm"], cp32["ssm"])
        snoise = state_err(cp["ssm"], cp32["ssm"])
        noise = (lp - lp32).abs().max().item()
        top2 = lp.topk(2).values
        margin = (top2[0] - top2[1]).item()
        agree = int(lk.argmax()) == int(lp.argmax())
        tol, tol32 = SSM_LOGIT_ATOL["bfloat16"], SSM_LOGIT_ATOL["float32"]
        stol, stol32 = SSM_STATE_NOISE_FACTOR * snoise, SSM_STATE_RTOL_FP32
        print(f"serve mamba2: request {i} S={MAMBA_PROMPT_LENS[i]} prefill "
              f"{prefill_ms[-1]:.2f} ms; kernel vs plain: logits bf16 "
              f"max_abs_err {err:.4f} (tol {tol}; noise: plain bf16 vs fp32 "
              f"{noise:.4f}), fp32 {err32:.3e} (tol {tol32}); states bf16 "
              f"{serr:.3e} (tol {stol:.3e}: twice the plain bf16 vs fp32 "
              f"{snoise:.3e}), fp32 {serr32:.3e} (tol {stol32}) of the "
              f"layer's max |h|; top-2 margin {margin:.4f}, argmax "
              f"{'agrees' if agree else 'differs'}", flush=True)
        if err > tol or err32 > tol32 or serr > stol or serr32 > stol32:
            raise AssertionError(f"request {i}: the prefill through the "
                                 f"kernel differs from the plain path: "
                                 f"logits {err} / {err32}, states {serr} / "
                                 f"{serr32} (bf16 / fp32)")
        if margin > tol and not agree:
            raise AssertionError(f"request {i}: argmax differs with top-2 "
                                 f"margin {margin} > {tol}")
        if int(done[i].tokens[0]) != int(lk.argmax()):
            raise AssertionError(f"request {i}: the engine's first token is "
                                 f"not the kernel prefill's argmax")
        checks.append({"S": MAMBA_PROMPT_LENS[i], "bf16_max_abs_err": err,
                       "fp32_max_abs_err": err32, "bf16_state_err": serr,
                       "fp32_state_err": serr32,
                       "bf16_state_plain_vs_fp32": snoise,
                       "bf16_plain_vs_fp32": noise, "top2_margin": margin,
                       "argmax_agrees": agree})
    del params32
    served_ratio = served_ssd_check(torch, ssd, model, params, prompts)

    rec = engine_microbench(model, params, slots=SLOTS,
                            prompt_len=max(MAMBA_PROMPT_LENS), gen=GEN,
                            reps=3, seed=seed)
    watts = power_limit_watts(card)
    at_limit = measured_cost(rec, watts=watts)
    print(f"serve mamba2 microbench on {card}: prefill (S="
          f"{rec['prompt_len']}) {rec['prefill_ms']:.3f} ms = "
          f"{rec['prefill_tok_s']:.0f} tok/s; decode step ({SLOTS} slots) "
          f"{rec['decode_step_ms']:.3f} ms = {rec['decode_tok_s']:.1f} tok/s;"
          f" insert {rec['insert_ms']:.3f} ms; J/token decode "
          f"{rec['joules_per_decode_token_measured']:.3e} at the nominal "
          f"{rec['device_watts']} W, {at_limit.joules_per_decode_step:.3e} at "
          f"the card's {watts} W limit (an upper bound: draw not measured)",
          flush=True)
    busy = DecodeEngine(model, params, config)
    for i in range(SLOTS):
        busy.prefill_request(Request(rid=i, tokens=prompts[i], max_new=GEN))
    pos, active, gen_idx = (busy._host_vector(a) for a in
                            (busy._pos, busy._active, busy._gen))
    batch = {"tokens": torch.tensor(prompts[0], dtype=torch.long,
                                    device="cuda")[None]}
    prefill = lambda: model.prefill(params, batch)
    step = lambda: busy._step(pos, active, gen_idx)
    profiles = {
        "prefill_2048": device_profile(torch, prefill,
                                       launched(torch, prefill)),
        "decode_step_4_slots": device_profile(torch, step,
                                              launched(torch, step)),
    }
    for name, prof in profiles.items():
        print(f"profile mamba2 {name}: wall {prof['wall_ms']:.3f} ms, device "
              f"busy {prof['device_ms']:.3f} ms ({prof['device_share']:.1%}),"
              f" {prof['kernels']} kernels; top: "
              + "; ".join(f"{n} {ms:.3f} ms" for n, ms in prof["top"][:5]),
              flush=True)
    pre = profiles["prefill_2048"]
    ssd_ms = sum(ms for name, ms in pre["all"] if "ssd_scan" in name)
    print(f"profile mamba2 prefill_2048: ssd_scan kernels {ssd_ms:.3f} ms of "
          f"{pre['device_ms']:.3f} ms device busy "
          f"({ssd_ms / pre['device_ms']:.1%})", flush=True)
    return {"arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
            "params": model.num_params(params),
            "prompt_lens": list(MAMBA_PROMPT_LENS), "gen": GEN,
            "slots": SLOTS, "stagger": STAGGER, "wall_s": wall,
            "tok_s": len(reqs) * GEN / wall, "stats": engine.stats,
            "launches": counts, "ssd_launches": counts["ssd_scan"],
            "prefill_ms": prefill_ms, "prefill_checks": checks,
            "served_kernel_worst_err_over_bound": served_ratio,
            "profiles": profiles, "prefill_2048_ssd_device_ms": ssd_ms,
            "microbench": rec,
            "joules_per_decode_token_at_power_limit":
                at_limit.joules_per_decode_step}


def fused_agg_check(torch, agg, w, ws, s, label, show=True) -> tuple:
    """Hold ``fused_agg_cuda`` against ``fused_agg_plain`` on the same
    inputs within ``kernel_tolerance``, and s = 0 to give w back exactly;
    raises on a failure.  Returns (max abs error, largest error / bound)."""
    got = agg.fused_agg_cuda(w, ws, s)
    torch.cuda.synchronize()
    want = agg.fused_agg_plain(w, ws, s)
    tol = agg.kernel_tolerance(w, ws, s, want)
    err = (got.float() - want.float()).abs()
    ratio = (err / tol).max().item()
    ok = bool(torch.isfinite(got).all()) and bool((err <= tol).all())
    same = agg.fused_agg_cuda(w, ws, torch.zeros_like(s))
    torch.cuda.synchronize()
    exact = bool(torch.equal(same, w))
    if show or not (ok and exact):
        print(f"kernel fused_agg {label}: max_abs_err={err.max().item():.3e},"
              f" worst err/bound={ratio:.3f}, s=0 exact={exact} "
              f"{'ok' if ok and exact else 'FAIL'}", flush=True)
    if not (ok and exact):
        raise AssertionError(f"fused_agg kernel disagrees with its plain "
                             f"version at {label}")
    return err.max().item(), ratio


def stack_like(torch, tree, C, gen):
    """(C, ...) client models around a global tree: w + 1e-3 N(0, 1)."""
    return _tree_map(tree, lambda t: t[None] + 1e-3 * torch.randn(
        (C,) + tuple(t.shape), generator=gen, device=t.device, dtype=t.dtype))


def fused_agg_phase(torch, agg, seed: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core import EnergyProfile, participation_mask
    from repro_torch.kernels import ops
    from repro_torch.models import get_model

    gen = torch.Generator(device="cuda").manual_seed(seed)
    C = TRAIN["clients"]
    E = EnergyProfile(C, TRAIN["taus"]).cycles()
    # the first sustainable round in which the last client takes part, so
    # that every client's term reaches the kernel
    rnd = next(r for r in range(100)
               if participation_mask("sustainable", seed, r, E)[-1] == 1)
    mask = participation_mask("sustainable", seed, rnd, E)
    s = (mask * (1.0 / C) * E.float()).cuda()
    params = get_model(get_config("cifar-cnn")).init_params(gen)
    stack = stack_like(torch, params, C, gen)
    worst, worst_ratio = 0.0, 0.0

    def record(res):
        nonlocal worst, worst_ratio
        worst, worst_ratio = max(worst, res[0]), max(worst_ratio, res[1])

    for name in params:
        for leaf in params[name]:
            w, ws = params[name][leaf], stack[name][leaf]
            record(fused_agg_check(
                torch, agg, w.reshape(-1), ws.reshape(C, -1), s,
                f"cnn {name}.{leaf} C={C} M={w.numel()} fp32 "
                f"(sustainable round {rnd}, {int(mask.sum())} participants)"))
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        for M in (1, 257, 16385):
            w = torch.randn(M, generator=gen, device="cuda").to(dt)
            ws = torch.randn((C, M), generator=gen, device="cuda").to(dt)
            sr = torch.rand(C, generator=gen, device="cuda") * (5.0 / C)
            record(fused_agg_check(torch, agg, w, ws, sr,
                                   f"ragged C={C} M={M} {dname}"))
    w = torch.randn(2048 * 8192, generator=gen, device="cuda").bfloat16()
    ws = (w[None].float() + 1e-2 * torch.randn(
        (8, w.numel()), generator=gen, device="cuda")).bfloat16()
    record(fused_agg_check(torch, agg, w, ws, s[:8] + 0.01,
                           "granite-3-2b MLP weight 2048x8192 C=8 bfloat16"))

    # the tree in one launch, bitwise equal to the leaves' own launches
    before = agg.fused_agg_cuda.launches
    tree_out = ops.fused_agg_tree(params, stack, s)
    torch.cuda.synchronize()
    tree_launches = agg.fused_agg_cuda.launches - before
    same = all(torch.equal(tree_out[n][l].reshape(-1),
                           agg.fused_agg_cuda(params[n][l].reshape(-1),
                                              stack[n][l].reshape(C, -1), s))
               for n in params for l in params[n])
    print(f"kernel fused_agg CNN tree (10 leaves, C={C}): {tree_launches} "
          f"launch, bitwise equal to one launch a leaf: {same} "
          f"{'ok' if same and tree_launches == 1 else 'FAIL'}", flush=True)
    if not (same and tree_launches == 1):
        raise AssertionError(f"fused_agg tree: {tree_launches} launches, "
                             f"bitwise equal to the leaves' launches {same}")

    # timing: the whole CNN tree (one aggregation of the train path) and
    # fc1.w alone, against the bytes bound; the library call is one addmv
    # a leaf (ten calls for the tree: no single call computes it)
    def library(wt, wst):
        return torch.addmv(wt, wst.t(), s, beta=1.0 - float(s.sum()))

    leaves = [(params[n][l].reshape(-1), stack[n][l].reshape(C, -1))
              for n in params for l in params[n]]
    fc1 = (params["fc1"]["w"].reshape(-1), stack["fc1"]["w"].reshape(C, -1))
    lib_err = max((library(w, ws) - agg.fused_agg_cuda(w, ws, s)).abs()
                  .max().item() for w, ws in leaves)
    run = {"tree": lambda: ops.fused_agg_tree(params, stack, s),
           "fc1.w": lambda: agg.fused_agg_cuda(*fc1, s)}
    times = {}
    for label, items in (("tree", leaves), ("fc1.w", [fc1])):
        nbytes = sum((C + 2) * w.numel() * w.element_size() for w, _ in items)
        prof = device_profile(torch, lambda: [run[label]()
                                              for _ in range(10)],
                              expect={"fused_agg_kernel": 10})
        times[label] = {
            "kernel_ms": sum(ms for n, ms in prof["all"]
                             if "fused_agg" in n) / 10,
            "event_ms": cuda_ms(run[label], 50, torch),
            "plain_ms": cuda_ms(lambda: [agg.fused_agg_plain(w, ws, s)
                                         for w, ws in items], 5, torch),
            "library_ms": cuda_ms(lambda: [library(w, ws) for w, ws in items],
                                  50, torch),
            "library_calls": len(items),
            "bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES * 1e3,
            "launches_per_call": 1}
        t = times[label]
        print(f"fused_agg {label} (C={C}, fp32): kernel {t['kernel_ms']:.4f} "
              f"ms of device time in one launch ({t['event_ms']:.4f} ms "
              f"between CUDA events, host included), plain "
              f"{t['plain_ms']:.4f} ms, library addmv {t['library_ms']:.4f} "
              f"ms ({len(items)} call{'s' if len(items) > 1 else ''}); bound "
              f"{t['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB at "
              f"{PEAK_BYTES / 1e12} TB/s), {t['bound_ms'] / t['kernel_ms']:.1%}"
              f" of it", flush=True)
    print(f"fused_agg: |addmv - kernel| max {lib_err:.3e} over the CNN tree",
          flush=True)
    tree_t = times["tree"]
    return {
        "name": "fused_agg",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_agg.cu",
        "replaces": "src/repro/kernels/fused_agg.py:23",
        "launches": None,
        "max_abs_err": worst,
        "worst_err_over_bound": worst_ratio,
        "ms": tree_t["kernel_ms"],
        "plain_ms": tree_t["plain_ms"],
        "bound_ms": tree_t["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "timed_at": f"the CIFAR CNN tree, one aggregation of the train path: "
                    f"10 leaves, C={C}, fp32, one launch; ms is device time "
                    f"from torch.profiler; no single PyTorch call computes "
                    f"the tree (ten addmv: library_ten_calls_ms)",
        "library_ten_calls_ms": tree_t["library_ms"],
        "tree": tree_t,
        "fc1.w": times["fc1.w"],
        "library_max_abs_diff": lib_err,
    }


FLEET_KERNEL_NS = (1, 257, 65537)
FLEET_KERNEL_BIG = 10_000_000        # fleet_scale.py's largest round step
FLEET_GROUPS = 3
FLEET_GATES = ("sustainable", "threshold", "greedy")


def fleet_inputs(torch, n, gen, *, dyadic=False, per_client=False,
                 groups=None):
    """One round's inputs on the card: (battery, env without the battery,
    round cost).  Non-dyadic: charge U(0, 3), harvest Exp(0.7), want 0/1,
    valid 0 on every seventh lane (padding lanes), streak in 0..69,
    battery 2.5 J / leak 0.02 (or per client U(1, 3) / U(0, 0.1) with a
    per-client cost U(0.5, 1.5)).  Dyadic: quarters everywhere, leak 0.25,
    cost 0.75, so every sum of one round is exact in float32."""
    from repro_torch.energy.battery import BatteryConfig

    dev = "cuda"
    u = lambda: torch.rand(n, generator=gen, device=dev)
    ri = lambda hi: torch.randint(0, hi, (n,), generator=gen, device=dev)
    if dyadic:
        bat = BatteryConfig(capacity=2.5, leak=0.25)
        env = {"charge": ri(11).float() * 0.25,
               "harvest": ri(5).float() * 0.25,
               "valid": torch.ones(n, device=dev)}
        cost = torch.tensor(0.75, device=dev)
    else:
        bat = (BatteryConfig(capacity=1.0 + 2.0 * u(), leak=0.1 * u())
               if per_client else BatteryConfig(capacity=2.5, leak=0.02))
        env = {"charge": 3.0 * u(), "harvest": -0.7 * torch.log1p(-u()),
               "valid": (torch.arange(n, device=dev) % 7 != 6).float()}
        cost = (0.5 + u()) if per_client else torch.tensor(1.0, device=dev)
    env.update(want=(u() < 0.5).float(), streak=ri(70).float(),
               threshold=torch.tensor(1.5, device=dev))
    if groups:
        env["groups"] = ri(groups).to(torch.int32)
    return bat, env, cost


def fleet_step_check(torch, fs, gate, n, gen, *, hist, groups, emit,
                     label, show=False, **kw) -> dict:
    """``fleet_step_cuda`` against ``fleet_step_plain`` on the same inputs:
    every per-client output bitwise, the stats within
    ``fleet_step.kernel_tolerance`` of their float64 sums (histogram counts
    exact); on dyadic inputs every stat bitwise equal to the plain
    version's.  Raises on a failure."""
    from repro_torch.energy import step_ops

    bat, inputs, cost = fleet_inputs(torch, n, gen, groups=groups, **kw)
    program, env = step_ops.fleet_step_program(bat, gate, groups, hist=hist,
                                               device="cuda")
    env.update(inputs, round_cost=cost)
    got_state, got_emits, got = fs.fleet_step_cuda(
        program, env, n=n, emit=emit, num_groups=groups)
    torch.cuda.synchronize()
    out, plain = step_ops.run_step(program, env, valid=env["valid"],
                                   groups=env.get("groups"),
                                   num_groups=groups)
    same = lambda a, b: torch.equal(a.view(torch.int32), b.view(torch.int32))
    per_client = [same(got_state[k], out[k]) for k in program.state_out]
    if emit:
        per_client.append(same(got_emits["mask"], out["mask"]))
    exact = fs.stats_float64(program, out, env["valid"], env.get("groups"),
                             groups)
    ratios = fs.stats_error(got, exact, fs.kernel_tolerance(
        program, out, env["valid"], n, env.get("groups"), groups))
    worst = max(ratios.values())
    err = max((got[k].double() - plain[k].double()).abs().max().item()
              for k in got)
    finite = all(bool(torch.isfinite(v).all()) for v in got.values())
    ok = all(per_client) and finite and worst <= 1.0
    if kw.get("dyadic"):
        ok = ok and all(same(got[k], plain[k]) for k in got)
    if show or not ok:
        print(f"kernel fleet_step {label}: per-client outputs bitwise "
              f"{all(per_client)}; stats worst err/bound {worst:.3f}, max "
              f"|kernel - plain| {err:.3e} {'ok' if ok else 'FAIL'}",
              flush=True)
    if not ok:
        raise AssertionError(f"fleet_step kernel disagrees with its plain "
                             f"version at {label}: {ratios}")
    return {"worst": worst, "err": err}


def fleet_step_phase(torch, fs, seed: int) -> dict:
    from repro_torch.energy import step_ops

    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst, err, cases = 0.0, 0.0, 0

    def record(res):
        nonlocal worst, err, cases
        worst, err = max(worst, res["worst"]), max(err, res["err"])
        cases += 1

    for n in FLEET_KERNEL_NS:
        for gate in FLEET_GATES:
            for hist in (False, True):
                for groups in (None, FLEET_GROUPS):
                    for emit in (False, True):
                        record(fleet_step_check(
                            torch, fs, gate, n, gen, hist=hist,
                            groups=groups, emit=emit,
                            label=f"{gate} n={n} hist={hist} "
                                  f"groups={groups} emit={emit}"))
        for gate in FLEET_GATES:
            record(fleet_step_check(
                torch, fs, gate, n, gen, hist=True, groups=FLEET_GROUPS,
                emit=True, per_client=True, show=n == FLEET_KERNEL_NS[-1],
                label=f"{gate} n={n} per-client battery and cost"))
            if n > 1:
                record(fleet_step_check(
                    torch, fs, gate, n, gen, hist=True, groups=FLEET_GROUPS,
                    emit=True, dyadic=True, show=n == FLEET_KERNEL_NS[-1],
                    label=f"{gate} n={n} dyadic (stats bitwise)"))
    n = FLEET_KERNEL_BIG
    for gate in FLEET_GATES:
        record(fleet_step_check(torch, fs, gate, n, gen, hist=True,
                                groups=None, emit=False, show=True,
                                label=f"{gate} n={n} hist"))
    record(fleet_step_check(torch, fs, "sustainable", n, gen, hist=True,
                            groups=FLEET_GROUPS, emit=True, show=True,
                            label=f"sustainable n={n} hist groups emit"))
    print(f"kernel fleet_step: {cases} cases, worst stats err/bound "
          f"{worst:.3f}, max |kernel - plain| {err:.3e}", flush=True)

    # timing: the main path's instantiation (sustainable, hist, no groups,
    # no mask output) at fleet_scale.py's largest round-step size
    bat, inputs, cost = fleet_inputs(torch, n, gen)
    program, env = step_ops.fleet_step_program(bat, "sustainable", None,
                                               hist=True, device="cuda")
    env.update(inputs, round_cost=cost)
    event_ms = cuda_ms(lambda: fs.fleet_step_cuda(program, env, n=n), 20,
                       torch)
    plain_ms = cuda_ms(lambda: fs.fleet_step_plain(program, env, n=n), 3,
                       torch)
    # CUDA events around back-to-back calls also count the wrapper's host
    # time between launches; the kernel's own time is the device time of
    # its two launches per call
    reps = 10
    prof = device_profile(torch, lambda: [
        fs.fleet_step_cuda(program, env, n=n) for _ in range(reps)],
        expect={"fleet_step_kernel": reps, "fleet_step_reduce": reps})
    parts = {name: ms / reps for name, ms in prof["all"]
             if "fleet_step" in name}
    kernel_ms = sum(parts.values())
    nbytes = step_ops.bytes_moved(program, env, n)["fused_bytes"]
    bound_ms = nbytes / PEAK_BYTES * 1e3
    print(f"fleet_step n={n} sustainable hist: kernel {kernel_ms:.4f} ms of "
          f"device time a call ("
          + ", ".join(f"{'reduce' if 'reduce' in k else 'step'} {v:.4f}"
                      for k, v in parts.items())
          + f"), {event_ms:.4f} ms between CUDA events (host included); "
          f"plain {plain_ms:.4f} ms, no library call; bound {bound_ms:.4f} "
          f"ms ({nbytes / 1e6:.1f} MB at {PEAK_BYTES / 1e12} TB/s)",
          flush=True)
    return {
        "name": "fleet_step",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fleet_step.cu",
        "replaces": "src/repro/kernels/fleet_step.py:102",
        "launches": None,
        "max_abs_err": err,
        "worst_err_over_bound": worst,
        "ms": kernel_ms,
        "event_ms": event_ms,
        "kernel_parts_ms": parts,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "timed_at": f"n={n}, sustainable gate, hist, no groups, no mask "
                    f"output, scalar battery and cost: {nbytes} bytes; ms "
                    f"is device time from torch.profiler",
        "cases": cases,
    }


# the fleet phase: examples/energy_fleet.py's scenario at fleet_scale.py's
# largest host-local size
FLEET = dict(clients=1_000_000, rounds=150)
FLEET_GROUPS_RUN = 4                # the §V taus: group = client mod 4
FLEET_BERNOULLI_ROUNDS = 10         # card vs CPU, masks and charge bitwise
FLEET_CPU_ROUNDS = 2                # the scenario's first rounds on the CPU
# card vs CPU on the scenario: its exponential marks are ulp-close, not
# bitwise (log1p is rounded differently), so a client within a few ulp of
# the round cost, the threshold or a bin edge may land on the other side:
# at most FLEET_FLIP_FRAC of the fleet per round; the energy totals and
# averages (sums of nonnegative terms in other orders) to FLEET_STAT_RTOL
FLEET_FLIP_FRAC = 1e-5
FLEET_STAT_RTOL = 1e-5


def conservation_check(stats, n, charge0_sum, depth) -> float:
    """harvested - consumed - leaked - overflowed == change of the fleet's
    charge, per round.  Returns the largest |difference| / bound; the bound
    is (depth + 5) u times the magnitudes involved (each client's identity
    holds to a few roundings, each stat sum to ``depth`` of them)."""
    worst = 0.0
    prev = charge0_sum
    for r in range(len(stats["harvested"])):
        f = {k: float(stats[k][r]) for k in
             ("harvested", "consumed", "leaked", "overflowed")}
        now = float(stats["mean_charge"][r]) * n
        lhs = f["harvested"] - f["consumed"] - f["leaked"] - f["overflowed"]
        bound = (depth + 5) * 2.0 ** -24 * (sum(f.values()) + prev + now)
        worst = max(worst, abs(lhs - (now - prev)) / bound)
        prev = now
    return worst


COUNT_STATS = ("participants", "consumed", "frac_depleted")


def fleet_compare(card, cpu, n) -> dict:
    """The card's run against the CPU's, worst over the rounds: clients
    whose mask differs; for the counting stats (participants, consumed at
    1 J a round, frac_depleted x N) and each histogram the clients that
    moved (|difference|, summed over the bins); for the energy stats the
    relative difference."""
    out = {"mask_flips": int((card.masks.cpu() != cpu.masks).sum(dim=1)
                             .max())}
    for k, v in cpu.stats.items():
        a, b = np.asarray(card.stats[k], np.float64), v.astype(np.float64)
        d = np.abs(a - b)
        if k.startswith("hist_"):
            out[k] = float(d.sum(axis=-1).max())
        elif k in COUNT_STATS:
            out[k] = float(d.max()) * (n if k == "frac_depleted" else 1)
        else:
            out[k] = float((d / np.maximum(np.abs(b), 1e-30)).max())
    return out


def fleet_within(diff, flips) -> bool:
    """Every count within ``flips`` clients (a moved client changes two
    bins of a histogram), every energy stat within FLEET_STAT_RTOL."""
    return all(v <= (2 * flips if k.startswith("hist_") else flips
                     if k in COUNT_STATS or k == "mask_flips"
                     else FLEET_STAT_RTOL) for k, v in diff.items())


def fleet_rel(diff) -> float:
    return max(v for k, v in diff.items() if not k.startswith("hist_")
               and k not in COUNT_STATS and k != "mask_flips")


def fleet_phase(torch, fs, seed: int, card: str) -> dict:
    from repro_torch.energy.arrivals import Bernoulli
    from repro_torch.kernels import ops
    from repro_torch.launch import fleet as launch

    n, rounds = FLEET["clients"], FLEET["rounds"]
    process, battery, E = launch.scenario(n, seed, "cuda")
    charge0 = float(battery.init(1)[0]) * n
    depth = fs.reduction_depth(n)
    runs = []
    kw_runs = [(p, thr, {}) for p, thr in launch.POLICIES]
    groups = torch.arange(n, device="cuda") % FLEET_GROUPS_RUN
    kw_runs.append((launch.POLICIES[0][0], 1.0, {"groups": groups}))
    launch.run_policy(process, E, n, 2, *launch.POLICIES[0], seed, True,
                      "cuda")                        # warm-up, not counted
    last = None
    for policy, thr, extra in kw_runs:
        ops.zero_launches()
        torch.cuda.synchronize()
        res, wall, launches = launch.run_policy(process, E, n, rounds, policy,
                                                thr, seed, True, "cuda",
                                                **extra)
        others = sum(count for name, count in ops.launch_counts().items()
                     if name != "fleet_step")
        label = policy.value + (" groups" if extra else "")
        s = res.stats
        cons = conservation_check(s, n, charge0, depth)
        finite = all(np.isfinite(v).all() for v in s.values())
        shapes = (s["participants"].shape == (rounds,)
                  and s["hist_soc"].shape == (rounds, 32)
                  and (not extra or s["group_participants"].shape
                       == (rounds, FLEET_GROUPS_RUN)))
        counts = all(np.array_equal(s[k].sum(axis=1), np.full(rounds, n))
                     for k in ("hist_soc", "hist_spend", "hist_streak"))
        ok = (launches == rounds == fs.fleet_step_cuda.launches
              and others == 0 and cons <= 1.0 and finite and shapes
              and counts and 0 <= s["participants"].min()
              and s["participants"].max() <= n)
        print(f"fleet {label}: N={n:,} x {rounds} rounds in {wall:.3f} s = "
              f"{rounds / wall:.2f} rounds/s, {n * rounds / wall:.4g} "
              f"client-rounds/s on {card}; participation "
              f"{100 * res.participation_rate.mean():.2f}%, depleted "
              f"{100 * s['frac_depleted'].mean():.2f}%; fleet_step launches "
              f"{launches} (flash_attention and fused_agg {others}); "
              f"conservation worst err/bound {cons:.3f}; hist "
              f"counts sum to N {counts} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise AssertionError(f"fleet {label}: a check failed")
        runs.append({"policy": label, "wall_s": wall,
                     "rounds_per_s": rounds / wall,
                     "client_rounds_per_s": n * rounds / wall,
                     "launches": launches, "conservation": cons,
                     "participation": float(res.participation_rate.mean())})
        last = res

    # card vs the chip machine's CPU: a Bernoulli fleet bitwise, the
    # scenario's first rounds within the stated tolerances
    checks = {}
    bern = Bernoulli.create(n, prob=0.35, amount=1.2)
    on = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        on[dev] = launch.run_policy(bern, E.to(dev), n,
                                    FLEET_BERNOULLI_ROUNDS,
                                    launch.POLICIES[0][0], 1.0, seed, True,
                                    dev, record_masks=True)[0]
        checks[f"bernoulli_{dev}_s"] = time.perf_counter() - t0
    a, b = on["cuda"], on["cpu"]
    same = lambda x, y: torch.equal(x.cpu().view(torch.int32),
                                    y.view(torch.int32))
    diff = fleet_compare(a, b, n)
    bitwise = (same(a.masks, b.masks) and same(a.final_charge, b.final_charge)
               and same(a.final_streak, b.final_streak))
    ok = bitwise and fleet_within(diff, 0)
    print(f"fleet card vs CPU, Bernoulli fleet N={n:,}, "
          f"{FLEET_BERNOULLI_ROUNDS} sustainable rounds: masks, charge and "
          f"streak bitwise {bitwise}; participants, consumed, depleted and "
          f"hist counts equal {fleet_within(diff, 0)}; energy stats rel "
          f"diff max {fleet_rel(diff):.3e} (tol {FLEET_STAT_RTOL}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"fleet: the card's Bernoulli run differs from "
                             f"the CPU's: {diff}")
    checks["bernoulli"] = diff
    cpu_process, _, cpu_E = launch.scenario(n, seed, "cpu")
    for policy, thr in launch.POLICIES:
        kw = dict(record_masks=True)
        a = launch.run_policy(process, E, n, FLEET_CPU_ROUNDS, policy, thr,
                              seed, True, "cuda", **kw)[0]
        t0 = time.perf_counter()
        b = launch.run_policy(cpu_process, cpu_E, n, FLEET_CPU_ROUNDS,
                              policy, thr, seed, True, "cpu", **kw)[0]
        cpu_s = time.perf_counter() - t0
        diff = fleet_compare(a, b, n)
        flips = FLEET_FLIP_FRAC * n
        ok = fleet_within(diff, flips)
        print(f"fleet card vs CPU, scenario {policy.value}, first "
              f"{FLEET_CPU_ROUNDS} rounds (CPU {cpu_s:.1f} s): mask flips "
              f"{diff['mask_flips']}, clients moved in a count or histogram "
              f"{max(v for k, v in diff.items() if k.startswith('hist_') or k in COUNT_STATS):.0f}"
              f" (allowed {flips:.0f}, 2x in a histogram); energy stats rel "
              f"diff max {fleet_rel(diff):.3e} (tol {FLEET_STAT_RTOL}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"fleet {policy.value}: the card's rounds "
                                 f"differ from the CPU's: {diff}")
        checks[policy.value] = diff

    # the closed loop (core.simulate with an EnergyLoop), card vs CPU
    ops.zero_launches()
    loop = {"cuda": launch.closed_loop(seed, "cuda")}
    loop_launches = fs.fleet_step_cuda.launches
    loop["cpu"] = launch.closed_loop(seed, "cpu")
    ha, hb = loop["cuda"].history, loop["cpu"].history
    ok = (loop_launches == len(ha)
          and [h["participants"] for h in ha] == [h["participants"]
                                                   for h in hb]
          and all(abs(x.get("loss", 0.0) - y.get("loss", 0.0)) <= 1e-5
                  for x, y in zip(ha, hb)))
    print(f"fleet closed loop (8 clients, threshold, {len(ha)} rounds): "
          f"participants card == CPU {ok}, fleet_step launches "
          f"{loop_launches} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("fleet: the closed loop on the card differs "
                             "from the CPU's")

    # where a round's time goes
    one = lambda: launch.run_policy(
        process, E, n, 1, launch.POLICIES[0][0], 1.0, seed, True, "cuda",
        state=last.final_state, round_offset=rounds)
    prof = device_profile(torch, one, launched(torch, one))
    step_ms = sum(ms for name, ms in prof["all"] if "fleet_step" in name)
    print(f"profile fleet round (sustainable, N={n:,}): wall "
          f"{prof['wall_ms']:.3f} ms, device busy {prof['device_ms']:.3f} ms "
          f"({prof['device_share']:.1%}), {prof['kernels']} kernels, "
          f"fleet_step {step_ms:.4f} ms ({step_ms / prof['device_ms']:.2%} of "
          f"busy); top: " + "; ".join(f"{nm} {ms:.3f} ms"
                                      for nm, ms in prof["top"][:5]),
          flush=True)
    return {"clients": n, "rounds": rounds, "runs": runs,
            "launches": sum(r["launches"] for r in runs),
            "card_vs_cpu": checks, "closed_loop_launches": loop_launches,
            "profile": {k: v for k, v in prof.items() if k != "all"},
            "profile_fleet_step_ms": step_ms}


SERVE_KERNEL_NS = (1, 257, 65537)
SERVE_KERNEL_BIG = 10_000_000        # serve_scale.py's round-step size
SERVE_ADMISSIONS = ("agnostic", "battery_gated", "charge_gated")
SERVE_TRAINS = (None, "sustainable", "threshold", "greedy")


def serve_inputs(torch, n, gen, *, admission, train, hist, dyadic=False,
                 per_client=False):
    """One serving epoch's program and env on the card.  Non-dyadic: charge
    U(0, 8), harvest Exp(1.5), 0-6 requests, valid 0 on every seventh lane,
    twant 0/1, streak in 0..69, admit 1.25, the example's battery (8 J, leak
    0.01), prices (a 1e8-parameter model; 128 / 256 / 32 tokens) and
    thresholds (2.0 / 1.5 battery-gated, 3.0 / 1.0 J charge-gated), a 0.2 J
    training round; ``per_client``: battery, prices, token budgets,
    thresholds and the training cost drawn per client.  Dyadic: quarters,
    leak 0.25, prices 2^-8 / 2^-9 / 2^-6 J at 64 / 32 / 8 tokens, training
    0.25 J, admit 1, so every sum of one epoch is exact in float32."""
    from repro_torch.energy import step_ops
    from repro_torch.energy.battery import BatteryConfig
    from repro_torch.energy.costs import DecodeCostModel
    from repro_torch.serve import (BatteryGated, ChargeGated, EnergyAgnostic,
                                   QoSSpec, TrainLoad)

    dev = "cuda"
    u = lambda: torch.rand(n, generator=gen, device=dev)
    ri = lambda lo, hi: torch.randint(lo, hi, (n,), generator=gen,
                                      device=dev).float()
    scalar = lambda x: torch.tensor(x, device=dev)
    if dyadic:
        bat = BatteryConfig(capacity=2.5, leak=0.25)
        cost = DecodeCostModel(2.0 ** -8, 2.0 ** -9, 2.0 ** -6)
        qos = QoSSpec(64.0, 32.0, 8.0)
        hi, lo, rc = scalar(1.0), scalar(0.25), 0.25
        env = {"charge": ri(0, 11) * 0.25, "harvest": ri(0, 5) * 0.25,
               "requests": ri(0, 5), "valid": torch.ones(n, device=dev),
               "admit": scalar(1.0)}
    else:
        if per_client:
            bat = BatteryConfig(capacity=4.0 + 4.0 * u(), leak=0.05 * u())
            cost = DecodeCostModel(1e-3 + 2e-3 * u(), 1e-3 + 2e-3 * u(),
                                   1e-5 + 9e-5 * u())
            qos = QoSSpec(ri(50, 200), ri(100, 300), ri(10, 40))
            hi, lo, rc = 0.5 + 2.5 * u(), 0.2 + u(), 0.1 + 0.3 * u()
        else:
            bat = BatteryConfig(capacity=8.0, leak=0.01)
            cost = DecodeCostModel.from_params(1e8)
            qos = QoSSpec(128.0, 256.0, 32.0)
            hi, lo = scalar(2.0 if admission == "battery_gated" else 3.0), \
                scalar(1.5 if admission == "battery_gated" else 1.0)
            rc = 0.2
        env = {"charge": 8.0 * u(), "harvest": -1.5 * torch.log1p(-u()),
               "requests": ri(0, 7),
               "valid": (torch.arange(n, device=dev) % 7 != 6).float(),
               "admit": scalar(1.25)}
    policy = {"agnostic": lambda: EnergyAgnostic(),
              "battery_gated": lambda: BatteryGated(hi.expand(n), lo.expand(n)),
              "charge_gated": lambda: ChargeGated(hi.expand(n), lo.expand(n))
              }[admission]()
    load = None if train is None else TrainLoad.create(
        torch.full((n,), 4, device=dev), rc, policy=train, threshold=1.5,
        device=dev)
    program, penv = step_ops.serve_step_program(bat, cost, qos, policy, load,
                                                hist=hist, device=dev)
    penv.update(env, twant=(u() < 0.3).float(), streak=ri(0, 70))
    return program, penv


def offset_views(torch, env, n):
    """``env`` with every per-client (n,) tensor replaced by an equal view
    that starts 4 bytes into a larger buffer: off the 16-byte boundary the
    serve kernel's vector path needs."""
    out = dict(env)
    for k, t in env.items():
        if torch.is_tensor(t) and t.shape == (n,) and t.stride(0) == 1:
            buf = torch.empty(n + 1, dtype=t.dtype, device=t.device)
            buf[1:] = t
            out[k] = buf[1:]
    return out


def serve_step_check(torch, fs, n, gen, *, admission, train, hist, emit,
                     label, show=False, misaligned=False, **kw) -> dict:
    """``fleet_step_cuda`` on the serve program against
    ``fleet_step_plain`` on the same inputs: charge, streak and mode
    bitwise, the stats within ``fleet_step.kernel_tolerance`` of their
    float64 sums (histogram counts exact); on dyadic inputs every stat
    bitwise equal to the plain version's.  ``misaligned``: every
    per-client input a view at a 4-byte offset (the kernel's scalar
    path).  Raises on a failure."""
    program, env = serve_inputs(torch, n, gen, admission=admission,
                                train=train, hist=hist, **kw)
    if misaligned:
        env = offset_views(torch, env, n)
    from repro_torch.energy import step_ops

    got_state, got_emits, got = fs.fleet_step_cuda(program, env, n=n,
                                                   emit=emit)
    torch.cuda.synchronize()
    out, plain = step_ops.run_step(program, env, valid=env["valid"])
    same = lambda a, b: torch.equal(a.view(torch.int32), b.view(torch.int32))
    per_client = [same(got_state[k], out[k]) for k in program.state_out]
    if emit:
        per_client.append(torch.equal(got_emits["mode"], out["mode"]))
    exact = fs.stats_float64(program, out, env["valid"])
    ratios = fs.stats_error(got, exact, fs.kernel_tolerance(
        program, out, env["valid"], n))
    worst = max(ratios.values())
    err = max((got[k].double() - plain[k].double()).abs().max().item()
              for k in got)
    finite = all(bool(torch.isfinite(v).all()) for v in got.values())
    ok = all(per_client) and finite and worst <= 1.0
    if kw.get("dyadic"):
        ok = ok and all(same(got[k], plain[k]) for k in got)
    if show or not ok:
        print(f"kernel serve_step {label}: per-client outputs bitwise "
              f"{all(per_client)}; stats worst err/bound {worst:.3f}, max "
              f"|kernel - plain| {err:.3e} {'ok' if ok else 'FAIL'}",
              flush=True)
    if not ok:
        raise AssertionError(f"serve_step kernel disagrees with its plain "
                             f"version at {label}: {ratios}")
    return {"worst": worst, "err": err}


def serve_step_phase(torch, fs, seed: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    worst, err, cases = 0.0, 0.0, 0

    def record(res):
        nonlocal worst, err, cases
        worst, err = max(worst, res["worst"]), max(err, res["err"])
        cases += 1

    for n in SERVE_KERNEL_NS:
        for adm in SERVE_ADMISSIONS:
            for train in SERVE_TRAINS:
                for hist in (False, True):
                    for emit in (False, True):
                        record(serve_step_check(
                            torch, fs, n, gen, admission=adm, train=train,
                            hist=hist, emit=emit,
                            label=f"{adm} train={train} n={n} hist={hist} "
                                  f"emit={emit}"))
                record(serve_step_check(
                    torch, fs, n, gen, admission=adm, train=train, hist=True,
                    emit=True, per_client=True,
                    show=n == SERVE_KERNEL_NS[-1] and train == "sustainable",
                    label=f"{adm} train={train} n={n} per-client battery, "
                          f"prices and thresholds"))
                if n > 1:
                    record(serve_step_check(
                        torch, fs, n, gen, admission=adm, train=train,
                        hist=True, emit=True, dyadic=True,
                        show=n == SERVE_KERNEL_NS[-1] and train is None,
                        label=f"{adm} train={train} n={n} dyadic (stats "
                              f"bitwise)"))
    # the scalar path (misaligned views) and the edges of the persistent
    # grid's stride (grid x SERVE_TILE clients a sweep of the grid)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stride = fs.serve_grid(10 ** 9, sms) * fs.SERVE_TILE
    for n in SERVE_KERNEL_NS[1:] + (stride + 1,):
        for adm in SERVE_ADMISSIONS:
            record(serve_step_check(
                torch, fs, n, gen, admission=adm, train="sustainable",
                hist=True, emit=True, misaligned=True, per_client=True,
                show=adm == "battery_gated",
                label=f"{adm} train=sustainable n={n} misaligned views, "
                      f"per-client battery, prices and thresholds"))
    for n in (stride - 1, stride, stride + 1, 2 * stride - 1,
              2 * stride + 1):
        record(serve_step_check(
            torch, fs, n, gen, admission="battery_gated",
            train="sustainable", hist=True, emit=True, show=True,
            label=f"battery_gated train=sustainable n={n} (grid stride "
                  f"{stride}) hist emit"))
    n = SERVE_KERNEL_BIG
    for adm in SERVE_ADMISSIONS:
        record(serve_step_check(torch, fs, n, gen, admission=adm,
                                train="sustainable", hist=True, emit=True,
                                show=True, label=f"{adm} train=sustainable "
                                                 f"n={n} hist emit"))
    print(f"kernel serve_step: {cases} cases, worst stats err/bound "
          f"{worst:.3f}, max |kernel - plain| {err:.3e}", flush=True)
    lib = fs._serve_kernel()
    occupancy = lib.serve_step_occupancy(fs.ADMISSIONS["battery_gated"],
                                         fs.TRAINS["sustainable"], 1)
    per_sm = lib.serve_step_blocks_per_sm()
    print(f"serve_step launch shape: {per_sm} blocks an SM x {sms} SMs = "
          f"grid {sms * per_sm} at n = {n} (fleet_step.py mirrors "
          f"{fs.SERVE_BLOCKS_PER_SM}); occupancy of the main instantiation "
          f"{occupancy} blocks an SM", flush=True)
    if per_sm != fs.SERVE_BLOCKS_PER_SM:
        raise AssertionError(f"csrc/serve_step.cu runs {per_sm} blocks an "
                             f"SM, fleet_step.SERVE_BLOCKS_PER_SM says "
                             f"{fs.SERVE_BLOCKS_PER_SM}")

    # timing: the main path's instantiation (the controlled run: battery-
    # gated admission, a sustainable training load, hist, no mode output)
    program, env = serve_inputs(torch, n, gen, admission="battery_gated",
                                train="sustainable", hist=True)
    event_ms = cuda_ms(lambda: fs.fleet_step_cuda(program, env, n=n), 20,
                       torch)
    plain_ms = cuda_ms(lambda: fs.fleet_step_plain(program, env, n=n), 3,
                       torch)
    reps = 10
    prof = device_profile(torch, lambda: [
        fs.fleet_step_cuda(program, env, n=n) for _ in range(reps)],
        expect={"serve_step_kernel": reps})
    kernel_ms = sum(ms for name, ms in prof["all"]
                    if "serve_step" in name) / reps
    # the fold alone: the same code the last block runs, in a launch of
    # its own on the rows the last call left
    partials, counts = fs._serve_scratch(torch.device("cuda", 0),
                                         torch.cuda.current_stream().cuda_stream)
    sums = torch.empty(16 + fs.NBINS, device="cuda")
    stats = torch.empty(15 + fs.NBINS, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    grid = fs.serve_grid(n, sms)
    prof = device_profile(torch, lambda: [lib.serve_step_fold_only(
        partials.data_ptr(), counts.data_ptr(), sums.data_ptr(),
        stats.data_ptr(), grid, 1, stream) for _ in range(reps)],
        expect={"serve_step_fold": reps})
    fold_ms = sum(ms for name, ms in prof["all"]
                  if "serve_step_fold" in name) / reps
    parts = {"walk (the kernel less the fold alone)": kernel_ms - fold_ms,
             "fold alone (one block, its own launch)": fold_ms}
    nbytes = fs.kernel_bytes(program, env, n)
    bound_ms = nbytes / PEAK_BYTES * 1e3
    print(f"serve_step n={n} battery-gated, sustainable training, hist: "
          f"kernel {kernel_ms:.4f} ms of device time a call, one launch ("
          + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
          + f"), {event_ms:.4f} ms between CUDA events (host included); "
          f"plain {plain_ms:.4f} ms, no library call; bound {bound_ms:.4f} "
          f"ms ({nbytes / 1e6:.1f} MB at {PEAK_BYTES / 1e12} TB/s), "
          f"{bound_ms / kernel_ms:.1%} of it", flush=True)
    return {
        "name": "fleet_step (serve program)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/serve_step.cu",
        "replaces": "src/repro/kernels/fleet_step.py:102",
        "launches": None,
        "max_abs_err": err,
        "worst_err_over_bound": worst,
        "ms": kernel_ms,
        "event_ms": event_ms,
        "kernel_parts_ms": parts,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "timed_at": f"n={n}, battery-gated admission, sustainable training "
                    f"load, hist, no mode output, scalar battery, prices and "
                    f"thresholds: {nbytes} bytes; ms is device time from "
                    f"torch.profiler",
        "cases": cases,
        "grid": grid, "blocks_per_sm": per_sm, "occupancy": occupancy,
    }


def ssd_work(B, S, H, P, G, N, chunk, elsize) -> dict:
    """The chunked scan's work, per chunk: C.B over the causal pairs
    (Q(Q+1)/2 N FMAs) once a (b, group), since C_t.B_s depends on neither
    dt nor A and every head of a group shares it (on operands of x's dtype:
    bf16 products are exact in fp32), and once a (b, h) the products with
    an fp32 operand, M x over the causal pairs (Q(Q+1)/2 P), C.h and the
    state update (2 Q P N); two FLOPs an FMA.  Bytes: x, B, C, dt and A
    read once, y and the final state (fp32) written once.
    ``workspace_bytes``: what the bf16 design adds, each chunk's state
    update in fp32 and its carried state as two bf16 terms, each written
    once and read at least once; it is the design's own traffic, not the
    work's, and stays out of the bound."""
    Q, nC = chunk, S // chunk
    cb = 2 * B * G * nC * Q * (Q + 1) // 2 * N
    rest = 2 * B * H * nC * (Q * (Q + 1) // 2 * P + 2 * Q * P * N)
    nbytes = (elsize * (B * S * H * P + 2 * B * S * G * N)
              + 4 * (B * S * H + H) + 4 * (B * S * H * P + B * H * P * N))
    workspace = 2 * 4 * B * H * nC * P * N if elsize == 2 else 0
    return {"cb_flops": cb, "fp32_operand_flops": rest, "bytes": nbytes,
            "workspace_bytes": workspace}


def ssd_bound(ssd, work) -> dict:
    """The least time (ms) the card could take for ``ssd_work``'s work in
    bf16: C.B and ``ssd.SPLIT_TERMS`` bf16 terms of each product with an
    fp32 operand on the tensor cores (the card can do them no other way at
    that rate), against the bytes at 3.35 TB/s.  ``cuda_core_ms`` prices
    it as a kernel without the split would run it (the fp32-operand
    products at the fp32 rate)."""
    split = ssd.SPLIT_TERMS
    flops = work["cb_flops"] + split * work["fp32_operand_flops"]
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = work["bytes"] / PEAK_BYTES * 1e3
    cuda_core = max((work["cb_flops"] / PEAK_FLOPS["bfloat16"]
                     + work["fp32_operand_flops"] / PEAK_FLOPS["float32"])
                    * 1e3, t_bytes)
    return {"ms": max(t_ops, t_bytes),
            "by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_ms": t_ops, "bytes_ms": t_bytes, "split_terms": split,
            "flops_at_bf16_rate": flops, "bf16_rate": PEAK_FLOPS["bfloat16"],
            "fp32_rate": PEAK_FLOPS["float32"], "byte_rate": PEAK_BYTES,
            "cuda_core_ms": cuda_core}


def ssd_inputs(torch, gen, B, S, H, P, G, N, dtype):
    """The reference sweep's draws (``tests/test_kernels.py``): x ~ 0.5 N,
    dt = softplus(N), A = -exp(0.3 N), B and C ~ 0.3 N."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    return ((randn(B, S, H, P) * 0.5).to(dtype),
            torch.nn.functional.softplus(randn(B, S, H)),
            -torch.exp(randn(H) * 0.3),
            (randn(B, S, G, N) * 0.3).to(dtype),
            (randn(B, S, G, N) * 0.3).to(dtype))


def ssd_check(torch, ssd, inputs, chunk, label, show=True) -> tuple:
    """Hold ``ssd_scan_cuda`` against ``ssd_scan_plain`` on the same inputs:
    y and the final state within ``kernel_tolerance``; raises on a
    non-finite output or any element past its bound.  Returns (y, max abs
    error, largest error / bound)."""
    y, h = ssd.ssd_scan_cuda(*inputs, chunk=chunk)
    torch.cuda.synchronize()
    wy, wh = ssd.ssd_scan_plain(*inputs, chunk=chunk)
    ty, th = ssd.kernel_tolerance(*inputs, chunk=chunk)
    err, ratio, ok = 0.0, 0.0, True
    for got, want, tol in ((y, wy, ty), (h, wh, th)):
        e = (got - want).abs()
        err = max(err, e.max().item())
        ratio = max(ratio, (e / tol.clamp_min(1e-30)).max().item())
        ok = ok and bool(torch.isfinite(got).all()) and bool((e <= tol).all())
    if show or not ok:
        print(f"kernel ssd_scan {label}: max_abs_err (y, state) {err:.3e}, "
              f"worst err/bound {ratio:.4f} {'ok' if ok else 'FAIL'}",
              flush=True)
    if not ok:
        raise AssertionError(f"ssd_scan kernel disagrees with its plain "
                             f"version at {label}")
    return y, err, ratio


def ssd_scan_phase(torch, ssd, seed: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    H, P, N = SSD_WIDTHS["H"], SSD_WIDTHS["P"], SSD_WIDTHS["N"]
    worst = {"bfloat16": 0.0, "float32": 0.0}
    worst_ratio = 0.0
    cases = ([(1, S, 1, SSD_CHUNK) for S in SSD_SEQS]
             + [(2, 512, H, 16), (2, 512, SSD_GROUPS, SSD_CHUNK)])
    for B, S, G, chunk in cases:
        for dname in ("bfloat16", "float32"):
            inputs = ssd_inputs(torch, gen, B, S, H, P, G, N,
                                getattr(torch, dname))
            _, err, ratio = ssd_check(
                torch, ssd, inputs, chunk,
                f"B={B} S={S} H={H} P={P} N={N} G={G} chunk={chunk} {dname}")
            worst[dname] = max(worst[dname], err)
            worst_ratio = max(worst_ratio, ratio)

    # the reference's state-carry case at full width: a decay near 1, so
    # token 0 must reach the last chunk
    S = 1024
    x = torch.zeros((1, S, H, P), device="cuda")
    x[:, 0] = 1.0
    ones = torch.ones((1, S, 1, N), device="cuda")
    carry = (x, torch.full((1, S, H), 0.05, device="cuda"),
             torch.full((H,), -0.01, device="cuda"), ones, ones)
    y, err, ratio = ssd_check(torch, ssd, carry, SSD_CHUNK,
                              f"state carry S={S} (dt 0.05, A -0.01, impulse "
                              f"at t=0)")
    last = y[0, -1, 0, 0].item()
    print(f"kernel ssd_scan state carry: y at t={S - 1} = {last:.4f}",
          flush=True)
    if not abs(last) > 1e-3:
        raise AssertionError(f"ssd_scan: the last chunk does not see token "
                             f"0 (y = {last})")
    worst["float32"] = max(worst["float32"], err)
    worst_ratio = max(worst_ratio, ratio)

    # timing at the longest main-path prompt: S=2048, bf16, one group
    B, S, dname = 1, 2048, "bfloat16"
    inputs = ssd_inputs(torch, gen, B, S, H, P, 1, N, torch.bfloat16)
    event_ms = cuda_ms(lambda: ssd.ssd_scan_cuda(*inputs, chunk=SSD_CHUNK),
                       20, torch)
    plain_ms = cuda_ms(lambda: ssd.ssd_scan_plain(*inputs, chunk=SSD_CHUNK),
                       3, torch)
    reps = 10
    prof = device_profile(torch, lambda: [
        ssd.ssd_scan_cuda(*inputs, chunk=SSD_CHUNK) for _ in range(reps)],
        expect={f"ssd_scan_{k}_bf16": reps
                for k in ("state", "chain", "chunk")})
    parts = {name: ms / reps for name, ms in prof["all"]
             if "ssd_scan" in name}
    kernel_ms = sum(parts.values())
    work = ssd_work(B, S, H, P, 1, N, SSD_CHUNK, 2)
    bound = ssd_bound(ssd, work)
    print(f"ssd_scan S={S} bf16 H={H} P={P} N={N} G=1 chunk={SSD_CHUNK}: "
          f"kernel {kernel_ms:.4f} ms of device time, {event_ms:.4f} ms "
          f"between CUDA events; plain {plain_ms:.4f} ms; no library call",
          flush=True)
    others = [(name, ms / reps) for name, ms in prof["all"]
              if "ssd_scan" not in name]
    print("ssd_scan kernels of one call, device ms: "
          + "; ".join(f"{name} {ms:.4f}" for name, ms in parts.items())
          + "".join(f"; also on the stream: {name} {ms:.4f}"
                    for name, ms in others), flush=True)
    print(f"ssd_scan bound {bound['ms']:.4f} ms ({bound['by']}): "
          f"{work['cb_flops']:.4g} FLOP of C.B (once a group) + "
          f"{bound['split_terms']} x {work['fp32_operand_flops']:.4g} FLOP "
          f"of M x, C.h and the state "
          f"update (their fp32 operand as {bound['split_terms']} bf16 terms) "
          f"at {bound['bf16_rate']:.4g} FLOP/s = {bound['ops_ms']:.4f} ms; "
          f"{work['bytes']:.4g} B at {bound['byte_rate']:.4g} B/s = "
          f"{bound['bytes_ms']:.4f} ms; share {bound['ms'] / kernel_ms:.1%}. "
          f"Priced with the fp32-operand products at the CUDA cores' "
          f"{bound['fp32_rate']:.4g} FLOP/s: {bound['cuda_core_ms']:.4f} ms. "
          f"The design's own workspace traffic, not in the bound: "
          f"{work['workspace_bytes']:.4g} B written and read", flush=True)
    return {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:23",
        "launches": None,
        "max_abs_err": max(worst.values()),
        "max_abs_err_bf16": worst["bfloat16"],
        "max_abs_err_fp32": worst["float32"],
        "worst_err_over_bound": worst_ratio,
        "ms": kernel_ms,
        "event_ms": event_ms,
        "kernel_parts_ms": parts,
        "plain_ms": plain_ms,
        "bound_ms": bound["ms"],
        "bound_by": bound["by"],
        "bound_terms": bound,
        "library_ms": None,
        "timed_at": {"B": B, "S": S, "H": H, "P": P, "N": N, "G": 1,
                     "chunk": SSD_CHUNK, "dtype": dname, **work,
                     "ms": "device time from torch.profiler: the sum of "
                           "the kernels named ssd_scan"},
    }


# the serving-fleet phase: examples/serve_fleet.py's scenario at
# serve_scale.py's largest host-local size, the example's horizon
SERVE = dict(clients=1_000_000, epochs=192)
SERVE_CONSTANT_EPOCHS = 10          # card vs CPU, bitwise
SERVE_CPU_EPOCHS = 2                # the scenario's first epochs on the CPU
# card vs CPU on the scenario: its draws (sin, exp, log1p) are ulp-close,
# not bitwise, so a client within a few ulp of a cdf step, a threshold or a
# bin edge may land on the other side: modes at most SERVE_FLIP_FRAC of the
# fleet per epoch, each ledger count within 16 requests of each such
# client, each histogram within two bins of each; energy stats (sums of
# nonnegative terms in other orders) to FLEET_STAT_RTOL
SERVE_FLIP_FRAC = 1e-5
LEDGER_STATS = ("offered", "served_full", "served_short", "shed",
                "deadline_missed", "participants")


def serve_epoch_checks(stats, n, charge0_sum, depth) -> dict:
    """Every epoch: energy conservation (as ``conservation_check``), the
    request ledger offered == served_full + served_short + shed +
    deadline_missed exactly, and each histogram counting N."""
    s = stats
    ledger = bool(np.array_equal(
        s["offered"], s["served_full"] + s["served_short"] + s["shed"]
        + s["deadline_missed"]))
    hists = all(np.array_equal(s[k].sum(axis=1), np.full(len(s[k]), n))
                for k in ("hist_soc", "hist_spend", "hist_streak")
                if k in s)
    return {"conservation": conservation_check(s, n, charge0_sum, depth),
            "ledger": ledger, "hist_counts": hists}


def serve_compare(card, cpu, n) -> dict:
    """The card's run against the CPU's, worst over the epochs: clients
    whose mode differs; for each ledger count and histogram the absolute
    difference; for the energy stats the relative difference."""
    out = {"mode_flips": int((card.modes.cpu() != cpu.modes).sum(dim=1)
                             .max())}
    for k, v in cpu.stats.items():
        a, b = np.asarray(card.stats[k], np.float64), v.astype(np.float64)
        d = np.abs(a - b)
        if k.startswith("hist_"):
            out[k] = float(d.sum(axis=-1).max())
        elif k in LEDGER_STATS or k == "tokens_decoded":
            out[k] = float(d.max())
        elif k == "frac_depleted":
            out[k] = float(d.max()) * n
        else:
            out[k] = float((d / np.maximum(np.abs(b), 1e-30)).max())
    return out


def serve_within(diff, flips) -> bool:
    def bound(k):
        if k.startswith("hist_"):
            return 2 * flips
        if k in LEDGER_STATS or k == "frac_depleted":
            return 16 * flips if k != "participants" else flips
        if k == "tokens_decoded":
            return 16 * 256 * flips
        if k == "mode_flips":
            return flips
        return FLEET_STAT_RTOL
    return all(v <= bound(k) for k, v in diff.items())


def serve_rel(diff) -> float:
    return max(v for k, v in diff.items() if not k.startswith("hist_")
               and k not in LEDGER_STATS and k not in (
                   "mode_flips", "frac_depleted", "tokens_decoded"))


def serve_fleet_phase(torch, fs, seed: int, card: str) -> dict:
    from repro_torch import prng
    from repro_torch.core import FedConfig, Policy, simulate
    from repro_torch.energy import control
    from repro_torch.energy.arrivals import Bernoulli, MarkovSolar
    from repro_torch.energy.battery import BatteryConfig
    from repro_torch.energy.fleet import EnergyLoop, FleetConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_fleet as launch
    from repro_torch.optim import sgd
    from repro_torch.serve import Constant

    def reset():
        ops.zero_launches()
        torch.cuda.synchronize()

    def others():
        return sum(count for name, count in ops.launch_counts().items()
                   if name != "serve_step")

    n, epochs = SERVE["clients"], SERVE["epochs"]
    traffic, harvest, cost, train = launch.scenario(n, "cuda")
    charge0 = float(launch.BATTERY.init(1)[0]) * n
    depth = fs.reduction_depth(n)
    launch.run("gated", traffic, harvest, cost, train, n, 2, seed, "cuda")
    runs, results, trace = [], {}, None
    for name in launch.RUNS:
        hist = name == "controlled"
        reset()
        res, ctrl, wall, launches = launch.run(name, traffic, harvest, cost,
                                               train, n, epochs, seed, "cuda",
                                               hist=hist)
        s = res.stats
        chk = serve_epoch_checks(s, n, charge0, depth)
        finite = all(np.isfinite(v).all() for v in s.values())
        shapes = (s["offered"].shape == (epochs,)
                  and (not hist or s["hist_soc"].shape == (epochs, 32)))
        ok = (launches == epochs == fs.serve_step_cuda.launches
              and others() == 0 and chk["conservation"] <= 1.0
              and chk["ledger"] and chk["hist_counts"] and finite and shapes
              and float(res.final_charge.min()) >= 0.0)
        off = s["offered"].sum()
        served = (s["served_full"].sum() + s["served_short"].sum()) / off
        print(f"serve fleet {name}{' hist' if hist else ''}: N={n:,} x "
              f"{epochs} epochs in {wall:.3f} s = {epochs / wall:.2f} "
              f"epochs/s, {n * epochs / wall:.4g} client-epochs/s on {card}; "
              f"served {100 * served:.2f}%, shed "
              f"{100 * s['shed'].sum() / off:.2f}%, missed "
              f"{100 * s['deadline_missed'].sum() / off:.2f}%, depleted "
              f"{100 * s['frac_depleted'].mean():.2f}%, J/tok "
              f"{res.joules_per_token:.4f}; serve-program launches "
              f"{launches} (other kernels {others()}); conservation worst "
              f"err/bound {chk['conservation']:.3f}, ledger every epoch "
              f"{chk['ledger']}, hist counts sum to N {chk['hist_counts']} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"serve fleet {name}: a check failed")
        if ctrl is not None:
            trace = [t["admit"] for t in ctrl.trace]
            print(f"serve fleet controlled: admit per day {trace}",
                  flush=True)
        runs.append({"run": name, "hist": hist, "wall_s": wall,
                     "epochs_per_s": epochs / wall,
                     "client_epochs_per_s": n * epochs / wall,
                     "launches": launches, "served": float(served),
                     "joules_per_token": res.joules_per_token,
                     "conservation": chk["conservation"]})
        results[name] = res

    # card vs the chip machine's CPU: a Constant-traffic, Bernoulli-harvest
    # fleet bitwise, the scenario's first epochs within the stated bounds
    checks = {}
    rate = torch.randint(0, 7, (n,), generator=torch.Generator().manual_seed(
        seed)).float()
    on = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        on[dev] = launch.run(
            "controlled", Constant.create(n, rate, device=dev),
            Bernoulli.create(n, prob=0.3, amount=0.8, device=dev), cost,
            None, n, SERVE_CONSTANT_EPOCHS, seed, dev, hist=True,
            record_modes=True)[0]
        checks[f"constant_{dev}_s"] = time.perf_counter() - t0
    a, b = on["cuda"], on["cpu"]
    same = lambda x, y: torch.equal(x.cpu().view(torch.int32),
                                    y.view(torch.int32))
    diff = serve_compare(a, b, n)
    bitwise = (torch.equal(a.modes.cpu(), b.modes)
               and same(a.final_charge, b.final_charge)
               and same(a.final_streak, b.final_streak))
    ok = bitwise and serve_within(diff, 0)
    print(f"serve fleet card vs CPU, Constant traffic + Bernoulli harvest "
          f"N={n:,}, {SERVE_CONSTANT_EPOCHS} controlled epochs (battery-"
          f"gated, sustainable training, hist): modes, charge and streak "
          f"bitwise {bitwise}; ledger, depleted and hist counts equal "
          f"{serve_within(diff, 0)}; energy stats rel diff max "
          f"{serve_rel(diff):.3e} (tol {FLEET_STAT_RTOL}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"serve fleet: the card's Constant run differs "
                             f"from the CPU's: {diff}")
    checks["constant"] = diff
    cpu_traffic, cpu_harvest, _, cpu_train = launch.scenario(n, "cpu")
    for name in launch.RUNS:
        kw = dict(record_modes=True, hist=name == "controlled")
        a = launch.run(name, traffic, harvest, cost, train, n,
                       SERVE_CPU_EPOCHS, seed, "cuda", **kw)[0]
        t0 = time.perf_counter()
        b = launch.run(name, cpu_traffic, cpu_harvest, cost, cpu_train, n,
                       SERVE_CPU_EPOCHS, seed, "cpu", **kw)[0]
        cpu_s = time.perf_counter() - t0
        diff = serve_compare(a, b, n)
        flips = SERVE_FLIP_FRAC * n
        ok = serve_within(diff, flips)
        print(f"serve fleet card vs CPU, scenario {name}, first "
              f"{SERVE_CPU_EPOCHS} epochs (CPU {cpu_s:.1f} s): mode flips "
              f"{diff['mode_flips']} (allowed {flips:.0f}), ledger moved "
              f"{max(diff[k] for k in LEDGER_STATS):.0f} (allowed "
              f"{16 * flips:.0f}), hist moved "
              f"{max((v for k, v in diff.items() if k.startswith('hist_')), default=0):.0f}"
              f"; energy stats rel diff max {serve_rel(diff):.3e} (tol "
              f"{FLEET_STAT_RTOL}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"serve fleet {name}: the card's epochs "
                                 f"differ from the CPU's: {diff}")
        checks[name] = diff

    # the server controller on the training fleet: a short run_controlled
    # horizon and the closed loop through core.simulate, card vs CPU
    ctl_n, ctl_rounds = 20_000, 30
    horizon = {}
    for dev in ("cuda", "cpu"):
        reset()
        ctrl = control.ServerController(
            T0=6, E0=[1, 5, 10, 20], groups=np.arange(ctl_n) % 4,
            rules=(control.CadenceRule(depleted_high=0.2),
                   control.BudgetRule(depleted_high=0.2, slip=0.9)))
        res, ctrl = control.run_controlled(
            Bernoulli.create(ctl_n, prob=0.35, amount=1.25, device=dev),
            BatteryConfig(capacity=2.5, init_charge=0.5), 0.25,
            FleetConfig(num_clients=ctl_n, policy="sustainable", seed=seed),
            ctl_rounds, ctrl, control_every=10, record_masks=True, hist=True,
            device=dev)
        horizon[dev] = (res, [(t["T"], t["E_mean"]) for t in ctrl.trace],
                        fs.fleet_step_cuda.launches)
    (a, ta_, la), (b, tb_, _) = horizon["cuda"], horizon["cpu"]
    ok = (la == ctl_rounds and ta_ == tb_
          and torch.equal(a.masks.cpu(), b.masks)
          and same(a.final_charge, b.final_charge)
          and all(np.array_equal(a.stats[k], b.stats[k]) for k in
                  ("participants", "group_participants", "hist_soc")))
    print(f"run_controlled fleet (N={ctl_n:,}, {ctl_rounds} rounds, chunks "
          f"of 10, grouped cadence + budget rules): controller trajectory "
          f"{ta_}, card == CPU (masks, charge, counts) {ok}, fleet_step "
          f"launches {la} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("run_controlled on the card differs from the "
                             "CPU's")

    def closed(dev):
        C = 8
        loop = EnergyLoop(MarkovSolar.create(C, day_mean=0.6),
                          BatteryConfig(capacity=3.0, leak=0.01), 1.0,
                          controller=control.ServerController(
                              T0=4, E0=2, rules=(
                                  control.CadenceRule(depleted_high=0.25),
                                  control.BudgetRule(depleted_high=0.25,
                                                     slip=0.9))),
                          device=dev)
        target = torch.linspace(-1.0, 1.0, C, device=loop.device)

        def loss(params, batch, rng):
            return 0.5 * torch.sum((params["w"] - target[batch["client"]])
                                   ** 2)

        def batch_fn(rnd, i, steps):
            return {"client": torch.full((steps,), i, dtype=torch.long,
                                         device=loop.device)}

        fed = FedConfig(num_clients=C, local_steps=4,
                        policy=Policy.THRESHOLD, seed=seed)
        return simulate(loss, sgd(0.2), fed,
                        {"w": torch.zeros((), device=loop.device)}, batch_fn,
                        np.ones(C) / C, np.ones(C, np.int32), 24,
                        prng.PRNGKey(seed), energy=loop)

    reset()
    ha = closed("cuda").history
    loop_launches = fs.fleet_step_cuda.launches
    hb = closed("cpu").history
    keys = ("participants", "ctrl_T", "ctrl_E_mean")
    ok = (loop_launches == len(ha)
          and [[h[k] for k in keys] for h in ha]
          == [[h[k] for k in keys] for h in hb]
          and all(abs(x.get("loss", 0.0) - y.get("loss", 0.0)) <= 1e-5
                  for x, y in zip(ha, hb)))
    print(f"closed loop with a server controller (8 clients, threshold, "
          f"{len(ha)} rounds): T per round {[h['ctrl_T'] for h in ha]}, "
          f"participants and knobs card == CPU {ok}, fleet_step launches "
          f"{loop_launches} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the controlled closed loop on the card "
                             "differs from the CPU's")

    # where an epoch's time goes (the controlled run's configuration)
    last = results["controlled"]
    one = lambda: launch.run(
        "gated", traffic, harvest, cost, train, n, 1, seed, "cuda",
        state=last.final_state[:1] + last.final_state[2:],
        epoch_offset=epochs)
    prof = device_profile(torch, one, launched(torch, one))
    step_ms = sum(ms for name, ms in prof["all"] if "serve_step" in name)
    print(f"profile serving epoch (gated, sustainable training, N={n:,}): "
          f"wall {prof['wall_ms']:.3f} ms, device busy "
          f"{prof['device_ms']:.3f} ms ({prof['device_share']:.1%}), "
          f"{prof['kernels']} kernels, serve_step {step_ms:.4f} ms "
          f"({step_ms / prof['device_ms']:.2%} of busy); top: "
          + "; ".join(f"{nm} {ms:.3f} ms" for nm, ms in prof["top"][:5]),
          flush=True)
    return {"clients": n, "epochs": epochs, "runs": runs,
            "launches": sum(r["launches"] for r in runs),
            "admit_trace": trace, "card_vs_cpu": checks,
            "run_controlled_trace": ta_,
            "closed_loop_launches": loop_launches,
            "profile": {k: v for k, v in prof.items() if k != "all"},
            "profile_serve_step_ms": step_ms}


def adam_step_bound(T, b1=0.9, b2=0.999):
    """Largest |m^| / sqrt(v^) of Adam within its first T steps
    (Cauchy-Schwarz on the moment sums; tests/test_torch_round.py)."""
    worst = 0.0
    for t in range(1, T + 1):
        s = sum((1 - b1) ** 2 * b1 ** (2 * k) / ((1 - b2) * b2 ** k)
                for k in range(t))
        worst = max(worst, math.sqrt(s) * math.sqrt(1 - b2 ** t)
                    / (1 - b1 ** t))
    return worst


def tree_diff(torch, a, b):
    """(|a - b|, |a|) of two param trees, flattened into two vectors."""
    names = [(n, l) for n in a for l in a[n]]
    d = torch.cat([(a[n][l].cpu() - b[n][l].cpu()).abs().reshape(-1)
                   for n, l in names])
    w = torch.cat([a[n][l].cpu().abs().reshape(-1) for n, l in names])
    return d, w


def replayed(run, w, r, routes=None, dtype=None):
    """Round r of ``run`` from ``w`` through ``core.replay_round``: (new
    params, loss, each local step's decisions)."""
    from repro_torch.core import replay_round
    from repro_torch.models import cnn

    w_new, m, seen = replay_round(cnn.loss_and_decisions, run.optimizer,
                                  run.fed, w, run.batch_fn(r), run.p, run.E,
                                  r, routes=routes, dtype=dtype)
    return w_new, float(m["loss"]), seen


def round_check(torch, card, cpu, w, w_next, r) -> dict:
    """Round r from ``w`` (the card's params) on the card, against the CPU
    replaying the card's decisions in float32 and in float64."""
    from repro_torch.tree import tree_leaves

    to_cpu = lambda tree: _tree_map(tree, lambda t: t.cpu())
    w_card, l_card, routes = replayed(card, w, r)
    same = all(torch.equal(a, b) for a, b in
               zip(tree_leaves(w_card), tree_leaves(w_next)))
    w32, l32, _ = replayed(cpu, to_cpu(w), r, routes)
    w64, l64, _ = replayed(cpu, to_cpu(w), r, routes, torch.float64)
    d, wabs = tree_diff(torch, w32, w_next)
    d64, w64abs = tree_diff(torch, w64, w32)
    dc64, _ = tree_diff(torch, w64, w_next)
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    return {"round": r, "replay_equals_round": same,
            "loss": l_card, "loss_rel_diff": rel(l_card, l32),
            "cpu_loss_rel_diff_f64": rel(l32, l64),
            "bulk": torch.quantile(d / (1 + wabs), BULK_Q).item(),
            "cpu_bulk_f64": torch.quantile(d64 / (1 + w64abs),
                                           BULK_Q).item(),
            "max_diff": d.max().item(),
            "over_sgd_tol_f64": int((dc64 > 1e-6 + 1e-5 * w64abs).sum())}


def train_phase(torch, fa, agg, seed: int, card: str) -> dict:
    from repro_torch.core import scheduling
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    # the entry point must turn TF32 off for matmuls and convolutions
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    out = {}
    for policy, rounds in TRAIN_ROUNDS.items():
        run = train.make_run(policy=policy, seed=seed, device="cuda", **TRAIN)
        if not train.tf32_off():
            raise AssertionError("the train entry point left TF32 on")
        cpu = train.make_run(policy=policy, seed=seed, device="cpu", **TRAIN)
        w0 = run.params
        C, T = run.fed.num_clients, run.fed.local_steps
        masks = []
        real = scheduling.participation_mask

        def recorder(*a, **k):
            m = real(*a, **k)
            masks.append(m.clone())
            return m

        train.train_round(run, w0, 0)            # warm-up (allocator, cuBLAS)
        torch.cuda.synchronize()
        fa.flash_attention_cuda.launches = 0
        agg.fused_agg_cuda.launches = 0
        scheduling.participation_mask = recorder
        w, hist, trees = w0, [], [w0]
        try:
            t_run = time.perf_counter()
            for r in range(rounds):
                t0 = time.perf_counter()
                w, m = train.train_round(run, w, r)
                dt = time.perf_counter() - t0
                hist.append({"round": r, **m, "round_ms": dt * 1e3,
                             "client_steps_per_s": C * T / dt})
                trees.append(w)
            wall = time.perf_counter() - t_run
        finally:
            scheduling.participation_mask = real
        launches = agg.fused_agg_cuda.launches
        flash = fa.flash_attention_cuda.launches
        for h in hist:
            print(f"train {policy} round {h['round']}: loss {h['loss']:.4f} "
                  f"participants {h['participants']:.0f} {h['round_ms']:.2f} "
                  f"ms ({h['client_steps_per_s']:.1f} client-steps/s)",
                  flush=True)
        print(f"train {policy}: {rounds} rounds in {wall:.3f} s = "
              f"{rounds * C * T / wall:.1f} client-steps/s on {card}; "
              f"fused_agg launches {launches}, flash_attention launches "
              f"{flash}", flush=True)
        if launches != rounds:
            raise AssertionError(f"fused_agg launched {launches} times in "
                                 f"{rounds} rounds, expected one per round "
                                 f"(the whole tree)")
        want = [real(policy, seed, r, cpu.E) for r in range(rounds)]
        parts = [h["participants"] for h in hist]
        if not (len(masks) == rounds and all(
                torch.equal(a.view(torch.int32), b.view(torch.int32))
                for a, b in zip(masks, want))
                and parts == [float(m.sum()) for m in want]):
            raise AssertionError(f"train {policy}: the card's masks or "
                                 f"participants differ from the CPU's")
        for r in range(rounds):
            if parts[r] == 0 and not all(
                    torch.equal(a, b) for a, b in zip(
                        tree_leaves(trees[r + 1]), tree_leaves(trees[r]))):
                raise AssertionError(f"train {policy}: no-op round {r} "
                                     f"changed the model")

        # each round with participants again, from the card's params
        # before it, replaying the card's decisions on the CPU
        scale = scheduling.aggregation_scale(policy, run.E)
        step = 2.0 * adam_step_bound(T) * TRAIN["lr"] * T
        checks, failed = [], []
        t0 = time.perf_counter()
        for r in TRAIN_REPLAY[policy]:
            if parts[r] == 0:
                continue
            c = round_check(torch, run, cpu, trees[r], trees[r + 1], r)
            c["adam_bound"] = step * float((want[r] * (1.0 / C) * scale)
                                           .sum())
            loss_tol = max(LOSS_RTOL, c["cpu_loss_rel_diff_f64"])
            bulk_tol = max(BULK_TOL, c["cpu_bulk_f64"])
            ok = (c["replay_equals_round"] and c["loss_rel_diff"] <= loss_tol
                  and c["bulk"] <= bulk_tol
                  and c["max_diff"] <= c["adam_bound"])
            print(f"train {policy} round {r}, card vs CPU replaying its "
                  f"decisions from its params: replay equals the round "
                  f"bitwise {c['replay_equals_round']}; loss rel diff "
                  f"{c['loss_rel_diff']:.2e} (tol {loss_tol:.2e}; CPU "
                  f"float32 vs float64 {c['cpu_loss_rel_diff_f64']:.2e}); "
                  f"{BULK_Q:.0%} quantile of |d|/(1+|w|) {c['bulk']:.2e} "
                  f"(tol {bulk_tol:.2e}; CPU float32 vs float64 "
                  f"{c['cpu_bulk_f64']:.2e}); max |d| {c['max_diff']:.3e} "
                  f"(Adam bound {c['adam_bound']:.3e}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            checks.append(c)
            if not ok:
                failed.append(r)
        cpu_s = time.perf_counter() - t0
        if failed:
            raise AssertionError(f"train {policy}: rounds {failed} on the "
                                 f"card differ from the CPU's beyond the "
                                 f"stated bounds")
        live = [h["loss"] for h in hist if h["participants"] > 0]
        if policy == "sustainable" and not (
                all(math.isfinite(x) for x in live) and live[-1] < live[0]):
            raise AssertionError(f"train {policy}: loss did not fall: {live}")
        one = lambda: train.train_round(run, w, 0)
        prof = device_profile(torch, one, launched(torch, one))
        agg_ms = sum(ms for n, ms in prof["all"] if "fused_agg" in n)
        print(f"profile train round ({policy}): wall {prof['wall_ms']:.3f} "
              f"ms, device busy {prof['device_ms']:.3f} ms "
              f"({prof['device_share']:.1%}), {prof['kernels']} kernels, "
              f"fused_agg {agg_ms:.4f} ms "
              f"({agg_ms / prof['device_ms']:.2%} of busy); top: "
              + "; ".join(f"{n} {ms:.3f} ms" for n, ms in prof["top"][:5]),
              flush=True)
        steady = hist[1:]
        out[policy] = {
            "rounds": rounds, "history": hist, "wall_s": wall,
            "round_ms_steady_mean": sum(h["round_ms"] for h in steady)
            / len(steady),
            "client_steps_per_s": rounds * C * T / wall,
            "fused_agg_launches": launches, "flash_launches": flash,
            "cpu_s": cpu_s, "card_vs_cpu": checks,
            "profile": {k: v for k, v in prof.items() if k != "all"},
            "profile_fused_agg_ms": agg_ms}
    out["sgd"] = sgd_check(torch, train, seed)
    return out


def sgd_check(torch, train, seed: int) -> list:
    """SGD rounds through the same entry point, each held elementwise
    against a float64 CPU replay of the card's decisions."""
    kw = {**TRAIN, **{k: v for k, v in SGD_CHECK.items() if k != "rounds"}}
    run = train.make_run(seed=seed, device="cuda", **kw)
    cpu = train.make_run(seed=seed, device="cpu", **kw)
    w, checks = run.params, []
    for r in range(SGD_CHECK["rounds"]):
        w_next, _ = train.train_round(run, w, r)
        c = round_check(torch, run, cpu, w, w_next, r)
        ok = c["replay_equals_round"] and c["over_sgd_tol_f64"] == 0
        print(f"train sgd (lr {SGD_CHECK['lr']}) round {r}: replay equals "
              f"the round bitwise {c['replay_equals_round']}; params past "
              f"1e-6 + 1e-5 |w| of the float64 replay: "
              f"{c['over_sgd_tol_f64']} {'ok' if ok else 'FAIL'}",
              flush=True)
        checks.append(c)
        if not ok:
            raise AssertionError(f"train sgd round {r}: the card's round "
                                 f"differs from the float64 replay")
        w = w_next
    return checks


def fig1_phase(torch, seed: int) -> dict:
    from repro_torch.launch.fig1 import run_fig1

    t0 = time.perf_counter()
    res = run_fig1(rounds=FIG1_ROUNDS, policies=["sustainable", "greedy"],
                   seed=seed, eval_every=10, verbose=False, device="cuda")
    wall = time.perf_counter() - t0
    for policy, r in res.items():
        print(f"fig1 {policy}: test acc {r['test_acc']} at rounds "
              f"{r['rounds']} (chance 0.1), final loss {r['final_loss']:.4f},"
              f" participants/round {sum(r['participants']) / FIG1_ROUNDS:.2f},"
              f" {r['wall_s']} s", flush=True)
        if not r["final_acc"] > 0.12:     # 2000 test images: 0.1 + 3 sigma
            raise AssertionError(f"fig1 {policy}: accuracy {r['final_acc']} "
                                 f"is not above chance")
    return {"wall_s": wall, "results": res}


# the sharded fleet phase: the client axis over torch.distributed ranks.
# (a) one NCCL rank on the card at the scenarios' full size; (b) two gloo
# ranks sharing the card (NCCL refuses two ranks on one device) on
# exact-arithmetic fleets, the scenarios' first rounds, and counts above
# 2^24 on one rank
SHARDED = dict(clients=1_000_000, rounds=150, epochs=192)
SHARDED_WORLD = 2
SHARDED_DYADIC_N = 1_000_001        # padded to 1,000,002 over two ranks
SHARDED_DYADIC_ROUNDS = 20
SHARDED_SERVE_EPOCHS = 10           # two controlled days of 5 epochs
SHARDED_FIRST = 2                   # the scenarios' first rounds / epochs
SHARDED_BIG = 2 ** 24 + 2           # padded to 2 x (2^24 + 1): one rank
#                                     holds 2^24 + 1 valid clients, the
#                                     other one
SHARDED_DEADLINE = 480.0            # seconds for the spawned ranks
SHARDED_TIMEOUT = 180               # seconds a rank waits in a collective
SHARDED_REPS = 50                   # all-reduces timed


def digest(res) -> dict:
    """{field: sha256 of its bytes} of a FleetResult or ServeResult: its
    per-client outputs and every stat."""
    import hashlib

    sha = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()) \
        .hexdigest()
    out = {k: sha(getattr(res, k).cpu().numpy())
           for k in ("masks", "modes", "final_charge", "final_streak")
           if getattr(res, k, None) is not None}
    out.update({f"stat/{k}": sha(v) for k, v in res.stats.items()})
    return out


def bitwise_equal(torch, a, b) -> bool:
    """Two FleetResults or ServeResults equal bit for bit: per-client
    outputs (on the card) and every stat."""
    for k in ("masks", "modes", "final_charge", "final_streak"):
        x, y = getattr(a, k, None), getattr(b, k, None)
        if (x is None) != (y is None) or (x is not None and not torch.equal(
                x.view(torch.int32), y.view(torch.int32))):
            return False
    return (set(a.stats) == set(b.stats)
            and all(np.array_equal(np.asarray(v).view(np.int32),
                                   np.asarray(b.stats[k]).view(np.int32))
                    for k, v in a.stats.items()))


def sharded_cases(torch, seed: int) -> dict:
    """{name: (kind, run)}: the runs of phase 13(b), each ``run(mesh)`` ->
    (result, extra), host-local with mesh=None.  kind: "exact" (everything
    bitwise), "scenario" (per-client outputs bitwise, stats within the
    two-rank bound) or "big" (counts above 2^24 on one rank: per-client
    outputs and counts bitwise, the other stats, sums of more terms than
    float32 holds exactly, within the two-rank bound)."""
    from repro_torch.core import EnergyProfile, Policy
    from repro_torch.energy.arrivals import Bernoulli
    from repro_torch.energy.battery import BatteryConfig
    from repro_torch.energy.control import AdmissionRule, ServerController
    from repro_torch.energy.costs import DecodeCostModel
    from repro_torch.energy.fleet import FleetConfig, simulate_fleet
    from repro_torch.launch import fleet as lf
    from repro_torch.launch import serve_fleet as ls
    from repro_torch.serve import (BatteryGated, Constant, QoSSpec,
                                   ServeConfig, run_serve_controlled)

    dev = "cuda"
    n = SHARDED_DYADIC_N
    exact_bat = BatteryConfig(capacity=2.5, leak=0.0, init_charge=0.5)
    bern = lambda m: Bernoulli.create(m, prob=0.375, amount=1.25, device=dev)

    def fleet(policy):
        def run(mesh):
            cfg = FleetConfig(num_clients=n, policy=policy, threshold=1.5,
                              seed=3)
            return simulate_fleet(
                bern(n), exact_bat, 0.75, cfg, SHARDED_DYADIC_ROUNDS,
                E=EnergyProfile(n).cycles(dev),
                groups=torch.arange(n, device=dev) % FLEET_GROUPS,
                num_groups=FLEET_GROUPS, hist=True, record_masks=True,
                mesh=mesh, device=dev), {}
        return run

    def serve(mesh):
        ctrl = ServerController(T0=5, E0=4, rules=(AdmissionRule(),))
        res, ctrl = run_serve_controlled(
            Constant.create(n, rate=2.0, device=dev), bern(n), exact_bat,
            DecodeCostModel(2.0 ** -8, 2.0 ** -9, 2.0 ** -6),
            QoSSpec(64.0, 128.0, 32.0),
            BatteryGated.create(n, 1.0, 1.0, device=dev),
            ServeConfig(n, seed=3), SHARDED_SERVE_EPOCHS, ctrl,
            train_cost=0.25, control_every=SHARDED_SERVE_EPOCHS // 2,
            hist=True, record_modes=True, mesh=mesh, device=dev)
        return res, {"admit": [t["admit"] for t in ctrl.trace]}

    def scenario_fleet(mesh):
        process, _, E = lf.scenario(SHARDED["clients"], seed, dev)
        return lf.run_policy(process, E, SHARDED["clients"], SHARDED_FIRST,
                             Policy.SUSTAINABLE, 1.0, seed, True, dev,
                             record_masks=True, mesh=mesh)[0], {}

    def scenario_serve(mesh):
        traffic, harvest, cost, train = ls.scenario(SHARDED["clients"], dev)
        return ls.run("gated", traffic, harvest, cost, train,
                      SHARDED["clients"], SHARDED_FIRST, seed, dev,
                      hist=True, record_modes=True, mesh=mesh)[0], {}

    def big(mesh):
        m = SHARDED_BIG
        return simulate_fleet(
            bern(m), BatteryConfig(capacity=2.5, leak=0.0, init_charge=2.5),
            0.25, FleetConfig(num_clients=m, policy="greedy"), 1, hist=True,
            pad_to=SHARDED_WORLD * (2 ** 24 + 1), mesh=mesh,
            device=dev), {}

    cases = {f"fleet {p}": ("exact", fleet(p))
             for p in ("sustainable", "greedy", "threshold", "always")}
    cases["serve controlled"] = ("exact", serve)
    cases["scenario fleet"] = ("scenario", scenario_fleet)
    cases["scenario serve"] = ("scenario", scenario_serve)
    cases["counts above 2^24"] = ("big", big)
    return cases


class RoundTap:
    """While entered, records each round (or epoch) a run takes: its step
    program, ``n`` and ``num_groups``, with ``env`` a copy of its inputs,
    and on a mesh the row it all-reduced (the finalize's input), by
    wrapping ``kernels.ops.fleet_step`` and ``dist.collectives.
    all_reduce_row``.  The kernels' launch counts are not touched."""

    def __init__(self, env: bool = False):
        self.env, self.rounds = env, []

    def __enter__(self):
        from repro_torch.dist import collectives
        from repro_torch.kernels import ops

        self._mods = (ops, collectives)
        step, reduce = self._orig = (ops.fleet_step,
                                     collectives.all_reduce_row)

        def tapped_step(program, env, *, n, emit=False, num_groups=None,
                        mesh=None):
            rec = {"program": program, "n": n, "num_groups": num_groups,
                   "row": None}
            if self.env:
                rec["env"] = {k: v.clone() if hasattr(v, "clone") else v
                              for k, v in env.items()}
            self.rounds.append(rec)
            return step(program, env, n=n, emit=emit, num_groups=num_groups,
                        mesh=mesh)

        def tapped_reduce(row, group):
            out = reduce(row, group)
            # the wrapper allocates a row a round: holding it is a copy
            self.rounds[-1]["row"] = row
            return out

        ops.fleet_step = tapped_step
        collectives.all_reduce_row = tapped_reduce
        return self

    def __exit__(self, *exc):
        ops, collectives = self._mods
        ops.fleet_step, collectives.all_reduce_row = self._orig


def finalize_vs_plain(torch, tap: RoundTap) -> list:
    """[rounds compared, rounds that differ]: each round's finalize kernel
    (``fleet_finalize_cuda`` / ``serve_finalize_cuda``) on the row the
    round all-reduced, against its plain version ``step_ops.row_stats`` on
    the same row, bit for bit (both round each sum to float32 once and
    divide once in IEEE arithmetic)."""
    from repro_torch.energy import step_ops
    from repro_torch.kernels import fleet_step as fs

    bits = lambda t: t.reshape(-1).view(torch.int32)
    compared = differ = 0
    for rec in tap.rounds:
        prog, row, G = rec["program"], rec["row"], rec["num_groups"]
        if row is None:
            continue
        got = (fs.serve_finalize_cuda(prog, row)
               if prog.name == "serve_step"
               else fs.fleet_finalize_cuda(prog, row, G))
        want = step_ops.row_stats(prog, row, G)
        compared += 1
        differ += not (set(got) == set(want) and all(
            torch.equal(bits(got[k]), bits(want[k])) for k in want))
    return [compared, differ]


def round_bounds(torch, tap: RoundTap, world: int) -> list:
    """For each round of a host-local run recorded with ``RoundTap(env=
    True)``: its stats' exact float64 values (``stats_float64`` of
    ``step_ops.run_step``'s final env on the round's inputs) and
    ``kernel_tolerance``'s bound on one rank and on ``world`` ranks."""
    from repro_torch.energy import step_ops
    from repro_torch.kernels import fleet_step as fs

    out = []
    for rec in tap.rounds:
        prog, env, n, G = (rec["program"], rec["env"], rec["n"],
                           rec["num_groups"])
        valid, groups = env["valid"], env.get("groups")
        final, _ = step_ops.run_step(prog, env, valid=valid, groups=groups,
                                     num_groups=G)
        out.append({"exact": fs.stats_float64(prog, final, valid, groups, G),
                    "tol": {w: fs.kernel_tolerance(prog, final, valid, n,
                                                   groups, G, world=w)
                            for w in (1, world)}})
    return out


def worst_over_bound(torch, stats: dict, bounds: list, world: int) -> float:
    """Largest |stat - exact| / ``kernel_tolerance``'s bound on ``world``
    ranks over the rounds of ``bounds`` (`round_bounds`) and every stat but
    the histogram counts (held bitwise against host-local instead: a count
    above 2^24 is no exact float32)."""
    from repro_torch.kernels import fleet_step as fs

    worst = 0.0
    for r, b in enumerate(bounds):
        keys = [k for k in b["exact"] if not k.startswith("hist_")]
        got = {k: torch.tensor(np.asarray(stats[k], np.float32)[r])
               for k in keys}
        ratios = fs.stats_error(got, {k: b["exact"][k] for k in keys},
                                {k: b["tol"][world][k] for k in keys})
        worst = max([worst, *ratios.values()])
    return worst


def run_case(torch, run, mesh, keep: bool = False, envs: bool = False
             ) -> dict:
    """One case of `sharded_cases`: the kernels' launches and finalizes,
    the wall seconds, the stats, what else the case returns, and its
    digest (or, with ``keep``, the result itself and its `RoundTap`); on a
    mesh, every round's finalize held against its plain version on the
    round's all-reduced row (`finalize_vs_plain`); with ``envs`` each
    round's exact stats and bounds on 1 and SHARDED_WORLD ranks
    (`round_bounds`)."""
    from repro_torch.kernels import ops

    ops.zero_launches()
    torch.cuda.synchronize()
    with RoundTap(env=envs) as tap:
        t0 = time.perf_counter()
        res, extra = run(mesh)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    out = {"wall_s": wall_s,
           "launches": ops.launch_counts(),
           "finalizes": ops.finalize_counts(),
           "stats": {k: np.asarray(v).tolist() for k, v in res.stats.items()},
           **extra}
    if mesh is not None:
        out["finalize_vs_plain"] = finalize_vs_plain(torch, tap)
    if envs:
        out["bounds"] = round_bounds(torch, tap, SHARDED_WORLD)
    for rec in tap.rounds:
        rec.pop("env", None)
    if keep:
        out["result"], out["tap"] = res, tap
    else:
        out["digest"] = digest(res)
        del res
        torch.cuda.empty_cache()
    return out


def time_all_reduce(torch, dist, row, group, reps: int) -> float:
    """Host ms per synchronized all-reduce of ``row`` over ``group``."""
    dist.all_reduce(row, group=group)
    torch.cuda.synchronize()
    dist.barrier(group=group)
    t0 = time.perf_counter()
    for _ in range(reps):
        dist.all_reduce(row, group=group)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def sharded_child(rank: int, world: int, init: str, out_dir: str,
                  seed: int) -> None:
    """A rank of phase 13(b): every case of `sharded_cases` over a
    ("data",) mesh of gloo ranks on cuda:0, then the all-reduce of a round's
    row alone; writes out_dir/rank{rank}.json."""
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    sys.path.insert(0, SRC)
    from repro_torch.kernels import fleet_step as fs

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=init, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=SHARDED_TIMEOUT))
    mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("data",))
    record = {name: run_case(torch, run, mesh)
              for name, (_, run) in sharded_cases(torch, seed).items()}
    row = torch.zeros(8 + fs.NBINS, dtype=torch.float64, device="cuda")
    record["collective_ms"] = time_all_reduce(
        torch, dist, row, mesh.get_group("data"), SHARDED_REPS)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)
    dist.destroy_process_group()


def spawn_ranks(world: int, out_dir: str, seed: int) -> list:
    """Run `sharded_child` in ``world`` processes (this file with
    ``--sharded-child``), all started together; their records, or raise if
    a rank fails or they outlast SHARDED_DEADLINE (every rank is stopped
    either way)."""
    init = f"file://{os.path.join(out_dir, 'rendezvous')}"
    procs = []
    for rank in range(world):
        log = open(os.path.join(out_dir, f"rank{rank}.log"), "w")
        procs.append((log, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
             "--sharded-child", str(rank), str(world), init, out_dir],
            stdout=log, stderr=subprocess.STDOUT)))
    t0 = time.perf_counter()
    try:
        for rank, (log, p) in enumerate(procs):
            left = SHARDED_DEADLINE - (time.perf_counter() - t0)
            try:
                p.wait(timeout=max(left, 0.1))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"sharded: the {world} ranks outlasted "
                                     f"their {SHARDED_DEADLINE:.0f} s "
                                     f"deadline")
            log.close()
            if p.returncode != 0:
                with open(os.path.join(out_dir, f"rank{rank}.log")) as f:
                    tail = f.read()[-3000:]
                raise AssertionError(f"sharded: rank {rank} of {world} "
                                     f"exited {p.returncode}:\n{tail}")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for rank in range(world):
        with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
            out.append(json.load(f))
    return out


def sharded_phase(torch, fs, seed: int, card: str, fleet=None,
                  serve_fleet=None) -> dict:
    import datetime
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import Policy
    from repro_torch.energy import step_ops
    from repro_torch.launch import fleet as lf
    from repro_torch.launch import serve_fleet as ls

    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    n, rounds, epochs = (SHARDED["clients"], SHARDED["rounds"],
                         SHARDED["epochs"])
    out = {"clients": n, "rounds": rounds, "epochs": epochs}

    def launches_ok(rec, kernel, count):
        others = sum(v for k, v in rec["launches"].items() if k != kernel)
        fin_others = sum(v for k, v in rec["finalizes"].items()
                         if k != kernel)
        return (rec["launches"][kernel] == count
                and rec["finalizes"][kernel] == count and others == 0
                and fin_others == 0)

    # (a) one NCCL rank on cuda:0: bitwise to host-local, one step kernel
    # and one finalize a round or epoch
    dist.init_process_group(
        "nccl", init_method=f"file://{os.path.join(tmp, 'nccl')}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=SHARDED_TIMEOUT))
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        process, _, E = lf.scenario(n, seed, "cuda")
        traffic, harvest, cost, train = ls.scenario(n, "cuda")

        def fleet_run(m):
            return lf.run_policy(process, E, n, rounds, Policy.SUSTAINABLE,
                                 1.0, seed, True, "cuda", record_masks=True,
                                 mesh=m)[0], {}

        def serve_run(m):
            res, ctrl, _, _ = ls.run("controlled", traffic, harvest, cost,
                                     train, n, epochs, seed, "cuda",
                                     hist=True, record_modes=True, mesh=m)
            return res, {"admit": [t["admit"] for t in ctrl.trace]}

        last = {}
        for kind, kernel, count, run in (
                ("fleet", "fleet_step", rounds, fleet_run),
                ("serve", "serve_step", epochs, serve_run)):
            host = run_case(torch, run, None, keep=True)
            shard = run_case(torch, run, mesh, keep=True)
            same = (bitwise_equal(torch, host.pop("result"),
                                  shard.pop("result"))
                    and host.get("admit") == shard.get("admit"))
            last[kind] = shard.pop("tap").rounds[-1]
            torch.cuda.empty_cache()
            fin_same = shard["finalize_vs_plain"] == [count, 0]
            ok = same and fin_same and launches_ok(shard, kernel, count)
            unit = "rounds" if kind == "fleet" else "epochs"
            before = (fleet or {}).get("runs", [{}])[0].get("rounds_per_s") \
                if kind == "fleet" else next(
                    (r["epochs_per_s"] for r in (serve_fleet or {}).get(
                        "runs", []) if r["run"] == "controlled"), None)
            print(f"sharded (a) one NCCL rank, {kind} "
                  f"({'sustainable, hist, masks' if kind == 'fleet' else 'controlled, hist, modes'}) "
                  f"N={n:,} x {count} {unit}: every stat, "
                  f"{'mask' if kind == 'fleet' else 'mode'}, charge and count "
                  f"bitwise to host-local {same}; the finalize on each "
                  f"{unit[:-1]}'s all-reduced row bitwise to step_ops."
                  f"row_stats on it {fin_same} "
                  f"({shard['finalize_vs_plain'][0]} compared); {kernel} "
                  f"launches "
                  f"{shard['launches'][kernel]}, finalizes "
                  f"{shard['finalizes'][kernel]} (other kernels "
                  f"{sum(shard['launches'].values()) - shard['launches'][kernel]}); "
                  f"{count / shard['wall_s']:.2f} {unit}/s sharded vs "
                  f"{count / host['wall_s']:.2f} host-local in this phase"
                  + (f" and {before:.2f} in phase {8 if kind == 'fleet' else 10}"
                     f" (no {'masks' if kind == 'fleet' else 'modes'})"
                     if before else "")
                  + f" on {card} {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"sharded (a) {kind}: a check failed: "
                                     f"bitwise {same}, finalize vs plain "
                                     f"{shard['finalize_vs_plain']}, "
                                     f"{shard['launches']}, "
                                     f"{shard['finalizes']}")
            out[f"nccl1_{kind}"] = {
                "per_s": count / shard["wall_s"],
                "host_local_per_s": count / host["wall_s"],
                "launches": shard["launches"][kernel],
                "finalizes": shard["finalizes"][kernel],
                "finalize_vs_plain": shard["finalize_vs_plain"]}

        # the collective alone, and the finalize launches' device time
        group = mesh.get_group("data")
        row = torch.zeros(8 + fs.NBINS, dtype=torch.float64, device="cuda")
        host_ms = time_all_reduce(torch, dist, row, group, SHARDED_REPS)
        event_ms = cuda_ms(lambda: dist.all_reduce(row, group=group),
                           SHARDED_REPS, torch)
        reps = 10
        fin, fin_by, fin_plain, fin_bound = {}, {}, {}, {}
        for kind, name in (("fleet", "fleet_step"), ("serve", "serve_step")):
            # the last round's (epoch's) all-reduced row, full size
            prog, r = last[kind]["program"], last[kind]["row"]
            call = (lambda: fs.fleet_finalize_cuda(prog, r)) \
                if kind == "fleet" else \
                (lambda: fs.serve_finalize_cuda(prog, r))
            try:
                prof = device_profile(torch, lambda: [
                    call() for _ in range(reps)],
                    expect={f"{name}_finalize_kernel": reps})
                fin[name] = sum(ms for k, ms in prof["all"]
                                if "finalize" in k) / reps
                fin_by[name] = "torch.profiler"
            except ProfileIncomplete as e:
                print(f"sharded (a) {name} finalize: {e}", flush=True)
                fin[name] = queued_ms(torch, call, 50)
                fin_by[name] = ("CUDA events around back-to-back launches "
                                "(the profiler missed kernels of every "
                                "window)")
            fin_plain[name] = cuda_ms(lambda: step_ops.row_stats(prog, r),
                                      20, torch)
            # the float64 row read once; the float32 sums (as wide as the
            # row) and stats (one fewer: the sum of valid is no stat)
            # written once
            nbytes = r.numel() * 8 + (2 * r.numel() - 1) * 4
            fin_bound[name] = nbytes / PEAK_BYTES * 1e3
        # the kernels of one sharded round and one sharded epoch, by name
        one_round = lambda: lf.run_policy(
            process, E, n, 1, Policy.SUSTAINABLE, 1.0, seed, True, "cuda",
            mesh=mesh)
        one_epoch = lambda: ls.run("gated", traffic, harvest, cost, train, n,
                                   1, seed, "cuda", hist=True, mesh=mesh)
        per_unit = {}
        for kind, one, names in (
                ("fleet", one_round, {"step": "fleet_step_kernel",
                                      "reduce": "fleet_step_reduce",
                                      "finalize": "fleet_step_finalize"}),
                ("serve", one_epoch, {"step": "serve_step_kernel",
                                      "finalize": "serve_step_finalize"})):
            prof = device_profile(torch, one, launched(torch, one))
            counts = prof["counts"]
            per_unit[kind] = {
                label: sum(c for k, c in counts.items() if sub in k)
                for label, sub in names.items()}
            per_unit[kind]["collective"] = sum(
                c for k, c in counts.items() if "nccl" in k.lower())
            per_unit[kind]["other"] = (prof["kernels"]
                                       - sum(per_unit[kind].values()))
        per_round = per_unit["fleet"]
        print(f"sharded (a) the collective: all-reduce of a round's row "
              f"({row.numel()} float64) over one NCCL rank {host_ms:.4f} ms "
              f"a call on the host clock, {event_ms:.4f} ms between CUDA "
              f"events; finalize {fin['fleet_step']:.4f} ms (fleet_step, "
              f"{fin_by['fleet_step']}), {fin['serve_step']:.4f} ms "
              f"(serve_step, {fin_by['serve_step']}), its "
              f"plain version (step_ops.row_stats, CUDA events) "
              f"{fin_plain['fleet_step']:.4f} / {fin_plain['serve_step']:.4f}"
              f" ms, bound {fin_bound['fleet_step']:.2e} / "
              f"{fin_bound['serve_step']:.2e} ms (bytes), each on the "
              f"last all-reduced row of the runs above; the kernels of one "
              f"sharded round by name (profiler): {per_round}, of one "
              f"sharded epoch: {per_unit['serve']} ('other': the draws and "
              f"the rest of the step) on {card}", flush=True)
        out.update(nccl1_collective_ms=host_ms,
                   nccl1_collective_event_ms=event_ms, finalize_ms=fin,
                   finalize_timed_by=fin_by,
                   finalize_plain_ms=fin_plain, finalize_bound_ms=fin_bound,
                   round_kernels=per_round, epoch_kernels=per_unit["serve"])
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # (b) two gloo ranks sharing cuda:0, against host-local runs on the card
    cases = sharded_cases(torch, seed)
    host = {name: run_case(torch, run, None, envs=kind != "exact")
            for name, (kind, run) in cases.items()}
    big = host["counts above 2^24"]["stats"]
    if not all(int(sum(big[k][0])) == SHARDED_BIG
               for k in ("hist_soc", "hist_spend", "hist_streak")) \
            or max(big["hist_streak"][0]) <= 2 ** 24:
        raise AssertionError("sharded: the host-local fleet above 2^24 "
                             "clients does not count N clients in one bin")
    t0 = time.perf_counter()
    ranks = spawn_ranks(SHARDED_WORLD, tmp, seed)
    spawn_s = time.perf_counter() - t0
    failed = []
    for name, (kind, _) in cases.items():
        want = host[name]
        serve = name.startswith("serve") or name == "scenario serve"
        kernel = "serve_step" if serve else "fleet_step"
        count = (SHARDED_SERVE_EPOCHS if name == "serve controlled"
                 else SHARDED_DYADIC_ROUNDS if kind == "exact"
                 else SHARDED_FIRST if kind == "scenario" else 1)
        for rank, rec in enumerate(ranks):
            got = rec[name]
            if kind != "exact":
                bitwise = [k for k in want["digest"]
                           if not k.startswith("stat/")
                           or k.startswith("stat/hist_")]
                per_client = all(got["digest"][k] == want["digest"][k]
                                 for k in bitwise)
                worst = worst_over_bound(torch, got["stats"],
                                         want["bounds"], SHARDED_WORLD)
                worst_host = worst_over_bound(torch, want["stats"],
                                              want["bounds"], 1)
                same = per_client and worst <= 1.0 and worst_host <= 1.0
                detail = (f"per-client outputs and counts bitwise "
                          f"{per_client}, other stats within "
                          f"kernel_tolerance(world={SHARDED_WORLD}) of "
                          f"exact: worst err/bound {worst:.3f} (host-local "
                          f"{worst_host:.3f} of world=1's)")
            else:
                same = (got["digest"] == want["digest"]
                        and got.get("admit") == want.get("admit"))
                detail = (f"every stat, mask or mode, charge and count "
                          f"bitwise {same}")
            fin_same = got["finalize_vs_plain"] == [count, 0]
            detail += (f"; finalize bitwise to row_stats on each all-reduced "
                       f"row {fin_same}")
            ok = same and fin_same and launches_ok(got, kernel, count)
            if rank == 0 or not ok:
                print(f"sharded (b) {SHARDED_WORLD} gloo ranks on cuda:0, "
                      f"{name}, rank {rank}: {detail}; {kernel} launches "
                      f"{got['launches'][kernel]}, finalizes "
                      f"{got['finalizes'][kernel]} (a rank, {count} "
                      f"{'epochs' if serve else 'rounds'}) in "
                      f"{got['wall_s']:.2f} s {'ok' if ok else 'FAIL'}",
                      flush=True)
            if not ok:
                failed.append((name, rank))
    gloo_ms = [rec["collective_ms"] for rec in ranks]
    print(f"sharded (b) the collective: all-reduce of a round's row over "
          f"{SHARDED_WORLD} gloo ranks sharing the card "
          f"{max(gloo_ms):.4f} ms a call on the host clock (ranks "
          f"{', '.join(f'{v:.4f}' for v in gloo_ms)}); ranks spawned and "
          f"run in {spawn_s:.1f} s on {card}", flush=True)
    if failed:
        raise AssertionError(f"sharded (b): checks failed for {failed}")
    out.update(gloo2_collective_ms=max(gloo_ms), gloo2_spawn_s=spawn_s,
               gloo2_cases={name: {"wall_s": ranks[0][name]["wall_s"]}
                            for name in cases})
    return out


# the MoE and VLM serve phases: phase 4's workload on olmoe-1b-7b at full
# width and depth, and 3 requests with vision embeddings on internvl2-76b's
# trunk at full width, its 80 layers cut to 8 (~18 GB in bf16: the whole
# trunk, 141 GB, does not fit one 80 GB card)
MOE_ARCH = "olmoe-1b-7b"
VLM_ARCH, VLM_LAYERS = "internvl2-76b", 8
VLM_PROMPT_LENS = (2048, 777, 300)
VLM_GEN = 16
# ``moe_mode="sorted"``: the engine's batched decode routes each slot's row
# alone, so its greedy tokens equal a slot-by-slot decode (batch 1).  Held
# in fp32 (TF32 off), where the two differ by summation order only: a
# request's tokens may part only at a step whose top-2 logit margin in the
# slot-by-slot run is within LOGIT_ATOL["float32"], a near-tie.  A capacity
# shared by the slots (cap = 1 at olmoe's k = 8 of E = 64 over 4 slots)
# would drop experts and move the logits by far more.
NEAR_TIE = LOGIT_ATOL["float32"]
# ... or after a decode step of the slot-by-slot run whose router had a
# near-tie: its k-th and (k+1)-th logits within ROUTER_TIE, 100x the fp32
# noise that a batch of 4 against a batch of 1 leaves there, so that the
# two runs may route a token to different experts
ROUTER_TIE = 1e-4


class RouteTap:
    """Wraps ``models.moe._route`` (every MoE mode routes through it), one
    evaluation at a time: ``record()`` keeps each call's expert ids,
    ``replay()`` hands a later evaluation the recorded ids call by call
    (the layers route in the same order), so that two evaluations that
    differ by rounding route every token alike, as phase 5 replays the
    CNN's max-pool decisions; ``gaps()`` keeps each call's smallest margin
    between the k-th and (k+1)-th router logits.  Passes through
    otherwise."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.real = moe, moe._route
        self.mode, self.calls, self.at = None, [], 0

    def __enter__(self):
        self.moe._route = self.route
        return self

    def __exit__(self, *exc):
        self.moe._route = self.real

    def record(self):
        self.mode, self.calls = "record", []

    def replay(self):
        self.mode, self.at = "replay", 0

    def gaps(self):
        self.mode, self.calls = "gaps", []

    def route(self, cfg, p, x, idx=None):
        if self.mode == "replay":
            self.at += 1
            return self.real(cfg, p, x, self.calls[self.at - 1])
        out = self.real(cfg, p, x)
        if self.mode == "record":
            self.calls.append(out[1])
        elif self.mode == "gaps":
            top = (x.float() @ p["router"]).topk(cfg.experts_per_token + 1,
                                                 dim=-1).values
            self.calls.append((top[..., -2] - top[..., -1]).min().item())
        return out


def routes_differ(a, b) -> tuple:
    """(token-layers whose top-k expert sets differ, token-layers) between
    two recordings of the same evaluation's routes."""
    n = sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
            for x, y in zip(a, b))
    return n, sum(x[..., 0].numel() for x in a)


def serve_workload(torch, model, params, prompts, gen, cache_len,
                   extras=None) -> tuple:
    """Phase 4's drive: ``DecodeEngine.run`` over ``prompts`` (greedy,
    ``SLOTS`` slots, arrivals ``STAGGER`` steps apart), every kernel's
    count set to 0 just before and read just after.  Returns (finished
    requests, wall seconds, launch counts, engine)."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import DecodeEngine, EngineConfig, Request

    config = EngineConfig(slots=SLOTS, cache_len=cache_len, max_new=gen)
    engine = DecodeEngine(model, params, config)
    reqs = [Request(rid=i, tokens=p, max_new=gen,
                    extras=extras[i] if extras else None)
            for i, p in enumerate(prompts)]
    arrivals = [i * STAGGER for i in range(len(reqs))]
    ops.zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run(reqs, arrivals=arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return done, wall, ops.launch_counts(), engine


def check_serve_launches(label, counts, want):
    if counts != {**dict.fromkeys(counts, 0), "flash_attention": want}:
        raise AssertionError(f"{label}: kernel launches {counts}, expected "
                             f"{want} of flash_attention and no other")


def prefill_batch(torch, p, extras=None) -> dict:
    return {"tokens": torch.tensor(p, dtype=torch.long, device="cuda")[None],
            **{k: v[None] for k, v in (extras or {}).items()}}


def prefill_logit_checks(torch, label, models, params, prompts, cache_len,
                         done, extras=None) -> tuple:
    """Each request's last-position prefill logits through the kernel
    (``impl="flash"``) against the plain attention path (``impl="ref"``)
    on the same weights, in bf16 (``models[0]``, ``params[0]``) and fp32
    (``models[1]``, ``params[1]``): within ``LOGIT_ATOL``; the engine's
    first token must be the kernel prefill's argmax.  With experts, the
    plain path takes the kernel path's routes (``RouteTap``): a router
    near-tie, of which 2048 tokens x 16 layers hold many, sends a token to
    other experts on a rounding difference and moves the logits by more
    than the bound; the paths running free, and how many token-layers
    they route apart, are printed beside.  Returns (checks, bf16
    kernel-path prefill ms per request)."""
    (model, model32), (p16, p32) = models, params
    moe = model.cfg.family == "moe"
    checks, prefill_ms = [], []
    for i, p in enumerate(prompts):
        batch = prefill_batch(torch, p, extras[i] if extras else None)
        batch32 = {k: v.float() if v.is_floating_point() else v
                   for k, v in batch.items()}
        free = {}
        with RouteTap() as tap:
            tap.record()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lk, _ = model.prefill(p16, batch, cache_len=cache_len,
                                  impl="flash")
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
            if moe:
                tap.replay()
            lp, _ = model.prefill(p16, batch, cache_len=cache_len, impl="ref")
            if moe:
                routes = tap.calls
                tap.record()
                lf, _ = model.prefill(p16, batch, cache_len=cache_len,
                                      impl="ref")
                free["bf16"] = ((lf[0, -1] - lk[0, -1]).abs().max().item(),
                                routes_differ(routes, tap.calls))
            tap.record()
            lk32, _ = model32.prefill(p32, batch32, impl="flash")
            if moe:
                tap.replay()
            lp32, _ = model32.prefill(p32, batch32, impl="ref")
            if moe:
                routes = tap.calls
                tap.record()
                lf, _ = model32.prefill(p32, batch32, impl="ref")
                free["fp32"] = ((lf[0, -1] - lk32[0, -1]).abs().max().item(),
                                routes_differ(routes, tap.calls))
        if free:
            print(f"{label}: request {i} S={len(p)}, the plain path routing "
                  f"freely: logits vs the kernel path's max_abs_err "
                  + ", ".join(f"{k} {e:.4g} ({n} of {m} token-layers routed "
                              f"apart)" for k, (e, (n, m)) in free.items()),
                  flush=True)
        lk, lp, lk32, lp32 = (t[0, -1] for t in (lk, lp, lk32, lp32))
        for name, t in (("bf16", lk), ("fp32", lk32)):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{label} request {i}: non-finite "
                                     f"{name} logits")
        err = (lk - lp).abs().max().item()
        err32 = (lk32 - lp32).abs().max().item()
        noise = (lp - lp32).abs().max().item()
        top2 = lp.topk(2).values
        margin = (top2[0] - top2[1]).item()
        agree = int(lk.argmax()) == int(lp.argmax())
        tol, tol32 = LOGIT_ATOL["bfloat16"], LOGIT_ATOL["float32"]
        print(f"{label}: request {i} S={len(p)} prefill {prefill_ms[-1]:.2f}"
              f" ms; logits kernel vs plain: bf16 max_abs_err {err:.4f} (tol "
              f"{tol}; noise: plain bf16 vs fp32 {noise:.4f}), fp32 "
              f"{err32:.3e} (tol {tol32}); top-2 margin {margin:.4f}, argmax "
              f"{'agrees' if agree else 'differs'}", flush=True)
        if err > tol or err32 > tol32:
            raise AssertionError(f"{label} request {i}: prefill logits "
                                 f"through the kernel differ from the plain "
                                 f"path by {err} (bf16) / {err32} (fp32)")
        if margin > tol and not agree:
            raise AssertionError(f"{label} request {i}: argmax differs with "
                                 f"top-2 margin {margin} > {tol}")
        if int(done[i].tokens[0]) != int(lk.argmax()):
            raise AssertionError(f"{label} request {i}: the engine's first "
                                 f"token is not the kernel prefill's argmax")
        checks.append({"S": len(p), "bf16_max_abs_err": err,
                       "fp32_max_abs_err": err32, "bf16_plain_vs_fp32": noise,
                       "top2_margin": margin, "argmax_agrees": agree,
                       "routes_replayed": moe, "free_routing": free})
    return checks, prefill_ms


def solo_decode(torch, model, params, p, gen, cache_len) -> tuple:
    """One request decoded alone (batch 1), greedy: (tokens, the top-2
    logit margin at each token, the smallest router gap of the decode step
    that gave each token (``RouteTap.gaps``; inf for the prefill's))."""
    logits, cache = model.prefill(params, prefill_batch(torch, p),
                                  cache_len=cache_len)
    logits, S = logits[:, -1], len(p)
    toks, margins, gaps = [], [], [math.inf]
    with RouteTap() as tap:
        for i in range(gen):
            top2 = logits[0].topk(2).values
            margins.append((top2[0] - top2[1]).item())
            tok = logits.argmax(-1)
            toks.append(int(tok))
            if i + 1 < gen:
                tap.gaps()
                logits, cache = model.decode_step(params, tok, cache, S + i)
                gaps.append(min(tap.calls))
    return np.asarray(toks, np.int32), margins, gaps


def parting(a, b):
    """Index of the first token where ``a`` and ``b`` differ, or None."""
    diff = np.nonzero(np.asarray(a) != np.asarray(b))[0]
    return int(diff[0]) if len(diff) else None


def sorted_vs_solo(torch, label, model, params, prompts, done, cache_len,
                   held: bool) -> list:
    """Each request of an engine run against its slot-by-slot decode: the
    first token where they part, that step's top-2 margin alone and the
    smallest router gap of the decode steps up to it.  With ``held``,
    raises where they part with neither a logit near-tie (``NEAR_TIE``)
    there nor a router near-tie (``ROUTER_TIE``) before."""
    res = []
    for i, p in enumerate(prompts):
        solo, margins, gaps = solo_decode(torch, model, params, p, GEN,
                                          cache_len)
        at = parting(done[i].tokens, solo)
        margin = None if at is None else margins[at]
        gap = None if at is None else min(gaps[:at + 1])
        res.append({"S": len(p), "parts_at": at, "margin_there": margin,
                    "router_gap_before": gap, "min_margin": min(margins),
                    "min_router_gap": min(gaps)})
        if at is not None:
            tie = margin <= NEAR_TIE or gap <= ROUTER_TIE
            print(f"{label}: request {i} S={len(p)} parts from its "
                  f"slot-by-slot decode at token {at}: top-2 margin there "
                  f"{margin:.3e} (near-tie {NEAR_TIE}), smallest router gap "
                  f"up to it {gap:.3e} (near-tie {ROUTER_TIE}): "
                  f"{'a near-tie' if tie else 'no near-tie'}", flush=True)
            if held and not tie:
                raise AssertionError(f"{label} request {i}: the batched "
                                     f"engine's tokens part from a "
                                     f"slot-by-slot decode at token {at} "
                                     f"with no near-tie")
    equal = sum(r["parts_at"] is None for r in res)
    print(f"{label}: {equal} of {len(res)} requests' {GEN} greedy tokens "
          f"equal their slot-by-slot decode (batch 1); smallest top-2 "
          f"margin {min(r['min_margin'] for r in res):.3e}, smallest router "
          f"gap {min(r['min_router_gap'] for r in res):.3e}", flush=True)
    return res


def flash_share(torch, model, params, batch, cache_len) -> dict:
    """A profile of one prefill at ``batch`` and flash's share of its
    device time."""
    prefill = lambda: model.prefill(params, batch, cache_len=cache_len)
    prof = device_profile(torch, prefill, launched(torch, prefill))
    flash_ms = sum(ms for n, ms in prof["all"] if "flash_fwd" in n)
    return {"wall_ms": prof["wall_ms"], "device_ms": prof["device_ms"],
            "device_share": prof["device_share"], "kernels": prof["kernels"],
            "flash_device_ms": flash_ms,
            "top": prof["top"][:5]}


def moe_serve_phase(torch, fa, seed: int, card: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import seeded_generators
    from repro_torch.models import get_model
    from repro_torch.serve.engine import DecodeEngine, EngineConfig, Request
    from repro_torch.serve.microbench import engine_microbench

    cfg = get_config(MOE_ARCH)
    model = get_model(cfg)
    g_params, g_prompt, _ = seeded_generators(seed, torch.device("cuda"))
    t0 = time.perf_counter()
    params = model.init_params(g_params)
    torch.cuda.synchronize()
    print(f"serve moe: {cfg.name} {cfg.num_layers} layers d_model="
          f"{cfg.d_model}, {cfg.num_experts} experts top-"
          f"{cfg.experts_per_token}, H={cfg.num_heads} K={cfg.num_kv_heads} "
          f"D={cfg.head_dim}, {cfg.dtype}, moe_mode={cfg.moe_mode}, "
          f"{model.num_params(params) / 1e9:.3f} B params made on the card "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    prompts = [torch.randint(0, cfg.vocab_size, (S,), generator=g_prompt,
                             device="cuda").cpu().numpy()
               for S in PROMPT_LENS]
    cache_len = max(PROMPT_LENS) + GEN + 1
    want = len(prompts) * cfg.num_layers
    DecodeEngine(model, params, EngineConfig(
        slots=SLOTS, cache_len=cache_len, max_new=GEN)).run(
        [Request(rid="warm", tokens=prompts[4], max_new=2)])    # warm-up

    runs = {}
    done, wall, counts, engine = serve_workload(torch, model, params,
                                                prompts, GEN, cache_len)
    print(f"serve moe ({cfg.moe_mode}): DecodeEngine.run {len(prompts)} "
          f"requests x {GEN} tokens in {wall:.3f} s = "
          f"{len(prompts) * GEN / wall:.1f} tok/s ({engine.stats['steps']} "
          f"decode steps); launches {counts}", flush=True)
    check_serve_launches("serve moe", counts, want)
    runs[cfg.moe_mode] = {"wall_s": wall, "tok_s": len(prompts) * GEN / wall,
                          "flash_launches": counts["flash_attention"],
                          "stats": engine.stats}

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = get_model(cfg32)
    params32 = _tree_map(params, lambda t: t.float())
    checks, prefill_ms = prefill_logit_checks(
        torch, "serve moe", (model, model32), (params, params32), prompts,
        cache_len, done)
    served_ratio = served_kernel_check(torch, fa, model, params, prompts,
                                       cache_len, label="serve moe")
    rec = engine_microbench(model, params, slots=SLOTS,
                            prompt_len=max(PROMPT_LENS), gen=GEN, reps=3,
                            seed=seed)
    print(f"serve moe microbench on {card}: prefill (S={rec['prompt_len']}) "
          f"{rec['prefill_ms']:.3f} ms = {rec['prefill_tok_s']:.0f} tok/s; "
          f"decode step ({SLOTS} slots) {rec['decode_step_ms']:.3f} ms = "
          f"{rec['decode_tok_s']:.1f} tok/s", flush=True)
    share = flash_share(torch, model, params, prefill_batch(torch, prompts[0]),
                        cache_len)
    print(f"serve moe: flash_attention in one S=2048 prefill: "
          f"{share['flash_device_ms']:.3f} ms of {share['device_ms']:.3f} ms "
          f"of device time ({share['flash_device_ms'] / share['device_ms']:.1%}"
          f"), {share['kernels']} kernels, wall {share['wall_ms']:.3f} ms",
          flush=True)

    # the same workload with sorted dispatch: bf16 (counted, timed, its
    # tokens against a slot-by-slot decode reported), then fp32 (held)
    sorted_cfg = dataclasses.replace(cfg, moe_mode="sorted")
    model_s = get_model(sorted_cfg)
    done_s, wall_s, counts_s, engine_s = serve_workload(
        torch, model_s, params, prompts, GEN, cache_len)
    print(f"serve moe (sorted): DecodeEngine.run {len(prompts)} requests x "
          f"{GEN} tokens in {wall_s:.3f} s = {len(prompts) * GEN / wall_s:.1f}"
          f" tok/s ({engine_s.stats['steps']} decode steps); launches "
          f"{counts_s}", flush=True)
    check_serve_launches("serve moe (sorted)", counts_s, want)
    runs["sorted"] = {"wall_s": wall_s,
                      "tok_s": len(prompts) * GEN / wall_s,
                      "flash_launches": counts_s["flash_attention"],
                      "stats": engine_s.stats}
    runs["sorted"]["bf16_vs_solo"] = sorted_vs_solo(
        torch, "serve moe (sorted, bf16)", model_s, params, prompts, done_s,
        cache_len, held=False)
    model_s32 = get_model(dataclasses.replace(sorted_cfg, dtype="float32"))
    done32, _, _, _ = serve_workload(torch, model_s32, params32, prompts, GEN,
                                     cache_len)
    runs["sorted"]["fp32_vs_solo"] = sorted_vs_solo(
        torch, "serve moe (sorted, fp32)", model_s32, params32, prompts,
        done32, cache_len, held=True)
    del params32, params
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
            "prompt_lens": list(PROMPT_LENS), "gen": GEN, "slots": SLOTS,
            "stagger": STAGGER, "runs": runs,
            "flash_launches": sum(r["flash_launches"] for r in runs.values()),
            "prefill_ms": prefill_ms, "prefill_logit_checks": checks,
            "served_kernel_worst_err_over_bound": served_ratio,
            "microbench": rec, "prefill_2048_profile": share}


def vlm_serve_phase(torch, fa, seed: int, card: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import seeded_generators
    from repro_torch.models import get_model
    from repro_torch.serve.microbench import engine_microbench

    full = get_config(VLM_ARCH)
    cfg = dataclasses.replace(full, num_layers=VLM_LAYERS)
    model = get_model(cfg)
    g_params, g_prompt, _ = seeded_generators(seed, torch.device("cuda"))
    t0 = time.perf_counter()
    params = model.init_params(g_params)
    torch.cuda.synchronize()
    print(f"serve vlm: {cfg.name} trunk, {cfg.num_layers} of "
          f"{full.num_layers} layers, d_model={cfg.d_model} H="
          f"{cfg.num_heads} K={cfg.num_kv_heads} D={cfg.head_dim} d_ff="
          f"{cfg.d_ff} vocab {cfg.vocab_size}, {cfg.dtype}, "
          f"{model.num_params(params) / 1e9:.3f} B params made on the card "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    prompts = [torch.randint(0, cfg.vocab_size, (S,), generator=g_prompt,
                             device="cuda").cpu().numpy()
               for S in VLM_PROMPT_LENS]
    extras = [{"vision_embeds": torch.randn(
        (min(cfg.vision_tokens, S), cfg.d_model), generator=g_prompt,
        device="cuda").to(torch.bfloat16)} for S in VLM_PROMPT_LENS]
    cache_len = max(VLM_PROMPT_LENS) + VLM_GEN + 1
    serve_workload(torch, model, params, prompts[2:], 2, cache_len,
                   extras[2:])                                  # warm-up
    done, wall, counts, engine = serve_workload(
        torch, model, params, prompts, VLM_GEN, cache_len, extras)
    want = len(prompts) * cfg.num_layers
    print(f"serve vlm: DecodeEngine.run {len(prompts)} requests (each "
          f"{cfg.vision_tokens} vision rows through Request.extras) x "
          f"{VLM_GEN} tokens in {wall:.3f} s = "
          f"{len(prompts) * VLM_GEN / wall:.1f} tok/s "
          f"({engine.stats['steps']} decode steps); launches {counts}",
          flush=True)
    check_serve_launches("serve vlm", counts, want)

    model32 = get_model(dataclasses.replace(cfg, dtype="float32"))
    params32 = _tree_map(params, lambda t: t.float())
    checks, prefill_ms = prefill_logit_checks(
        torch, "serve vlm", (model, model32), (params, params32), prompts,
        cache_len, done, extras)
    del params32
    torch.cuda.empty_cache()
    # the vision rows reach the logits: the same prompt without them
    bare, _ = model.prefill(params, prefill_batch(torch, prompts[0]),
                            cache_len=cache_len)
    moved = (bare[0, -1] - model.prefill(
        params, prefill_batch(torch, prompts[0], extras[0]),
        cache_len=cache_len)[0][0, -1]).abs().max().item()
    print(f"serve vlm: request 0's logits move by {moved:.4f} without its "
          f"vision rows", flush=True)
    if not moved > LOGIT_ATOL["bfloat16"]:
        raise AssertionError("serve vlm: the vision embeddings do not reach "
                             "the logits")
    served_ratio = served_kernel_check(torch, fa, model, params, prompts,
                                       cache_len, extras=extras,
                                       label="serve vlm")
    rec = engine_microbench(model, params, slots=SLOTS,
                            prompt_len=max(VLM_PROMPT_LENS), gen=VLM_GEN,
                            reps=3, seed=seed)
    print(f"serve vlm microbench on {card}: prefill (S={rec['prompt_len']}) "
          f"{rec['prefill_ms']:.3f} ms = {rec['prefill_tok_s']:.0f} tok/s; "
          f"decode step ({SLOTS} slots) {rec['decode_step_ms']:.3f} ms = "
          f"{rec['decode_tok_s']:.1f} tok/s", flush=True)
    share = flash_share(torch, model, params,
                        prefill_batch(torch, prompts[0], extras[0]),
                        cache_len)
    print(f"serve vlm: flash_attention in one S=2048 prefill: "
          f"{share['flash_device_ms']:.3f} ms of {share['device_ms']:.3f} ms "
          f"of device time ({share['flash_device_ms'] / share['device_ms']:.1%}"
          f"), {share['kernels']} kernels, wall {share['wall_ms']:.3f} ms",
          flush=True)
    del params
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": cfg.num_layers,
            "layers_full": full.num_layers, "dtype": cfg.dtype,
            "prompt_lens": list(VLM_PROMPT_LENS), "gen": VLM_GEN,
            "vision_rows": cfg.vision_tokens, "wall_s": wall,
            "tok_s": len(prompts) * VLM_GEN / wall, "stats": engine.stats,
            "flash_launches": counts["flash_attention"],
            "prefill_ms": prefill_ms, "prefill_logit_checks": checks,
            "logits_moved_without_vision": moved,
            "served_kernel_worst_err_over_bound": served_ratio,
            "microbench": rec, "prefill_2048_profile": share}


# the LM train phase: granite-3-2b at full width through the train
# launcher's path, 8 clients, T = 5 Adam steps of 4 x 512 tokens, 3
# sustainable rounds; its 40 layers cut to 4, or to 2 where 4 take more
# than LM_PEAK_LIMIT of the card (8 stacked clients' bf16 params, grads and
# new params and their fp32 Adam moments)
LM_TRAIN = dict(clients=8, local_steps=5, batch=4, seq=512,
                taus=(1, 2, 4, 8), lr=1e-3)
LM_TRAIN_ROUNDS = 3
LM_LAYERS = (4, 2)
LM_PEAK_LIMIT = 70e9
# card vs CPU: one round of a smoke config from the card's params, held as
# phase 5 holds the CNN's (LOSS_RTOL, BULK_TOL, the Adam bound); the MoE
# smoke rounds' losses within the fp32 tolerance of the CPU tests
LM_SMOKE = dict(clients=4, local_steps=2, batch=2, seq=32, taus=(1, 2, 4, 8),
                lr=1e-3)
MOE_LOSS_RTOL = 1e-5


class AggTap:
    """Records the inputs and output of every ``ops.fused_agg_tree`` call
    of a round, for the check of each leaf against the plain version."""

    def __init__(self, ops):
        self.ops, self.real, self.calls = ops, ops.fused_agg_tree, []

    def __enter__(self):
        def record(w, ws, s):
            out = self.real(w, ws, s)
            self.calls.append((w, ws, s, out))
            return out
        self.ops.fused_agg_tree = record
        return self

    def __exit__(self, *exc):
        self.ops.fused_agg_tree = self.real


def flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in flat_leaves(v, f"{prefix}.{k}" if prefix else k)]
    return [(prefix, tree)]


def agg_tree_check(torch, agg, call) -> float:
    """Every leaf a round's ``fused_agg_tree`` wrote against
    ``fused_agg_plain`` on the same inputs within ``kernel_tolerance``;
    returns the largest error / bound."""
    w, ws, s, out = call
    worst = 0.0
    for (name, wl), (_, wsl), (_, ol) in zip(flat_leaves(w), flat_leaves(ws),
                                             flat_leaves(out)):
        a, b = wl.reshape(-1), wsl.reshape(wsl.shape[0], -1)
        want = agg.fused_agg_plain(a, b, s)
        err = (ol.reshape(-1).float() - want.float()).abs()
        ratio = (err / agg.kernel_tolerance(a, b, s, want)).max().item()
        if not (bool(torch.isfinite(ol).all()) and ratio <= 1.0):
            raise AssertionError(f"fused_agg on the LM tree: leaf {name} "
                                 f"{tuple(wl.shape)} {wl.dtype} at "
                                 f"{ratio:.3f} of kernel_tolerance")
        worst = max(worst, ratio)
        del want, err
    return worst


def lm_round_vs_cpu(torch, train, label, cfg, seed) -> dict:
    """Round 0 of ``cfg`` (a smoke config) on the card, and on the CPU from
    the card's params: loss within LOSS_RTOL (MoE: MOE_LOSS_RTOL), 90% of
    the params within BULK_TOL (1 + |w|), every param within one round's
    Adam bound."""
    from repro_torch.core import scheduling

    card = train.make_run(cfg=cfg, seed=seed, device="cuda", **LM_SMOKE)
    cpu = train.make_run(cfg=cfg, seed=seed, device="cpu", **LM_SMOKE)
    w0 = card.params
    w_card, m_card = train.train_round(card, w0, 0)
    w_cpu, m_cpu = train.train_round(
        cpu, _tree_map(w0, lambda t: t.cpu()), 0)
    d = torch.cat([(a.cpu() - b).abs().reshape(-1) for (_, a), (_, b) in
                   zip(flat_leaves(w_card), flat_leaves(w_cpu))])
    w = torch.cat([b.abs().reshape(-1) for _, b in flat_leaves(w_cpu)])
    C, T = card.fed.num_clients, card.fed.local_steps
    mask = scheduling.participation_mask("sustainable", seed, 0, cpu.E)
    bound = (2.0 * adam_step_bound(T) * LM_SMOKE["lr"] * T
             * float((mask * (1.0 / C) * cpu.E.float()).sum()))
    rel = abs(m_card["loss"] - m_cpu["loss"]) / abs(m_cpu["loss"])
    bulk = torch.quantile(d / (1 + w), BULK_Q).item()
    loss_tol = MOE_LOSS_RTOL if cfg.family == "moe" else LOSS_RTOL
    ok = (m_card["participants"] == m_cpu["participants"] > 0
          and rel <= loss_tol and bulk <= BULK_TOL
          and d.max().item() <= bound)
    print(f"train lm {label} round 0, card vs CPU from the card's params "
          f"(fp32): loss {m_card['loss']:.6f} vs {m_cpu['loss']:.6f}, rel "
          f"diff {rel:.2e} (tol {loss_tol:.0e}); {BULK_Q:.0%} quantile of "
          f"|d|/(1+|w|) {bulk:.2e} (tol {BULK_TOL:.0e}); max |d| "
          f"{d.max().item():.3e} (Adam bound {bound:.3e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"train lm {label}: the card's round differs "
                             f"from the CPU's beyond the stated bounds")
    return {"loss_card": m_card["loss"], "loss_cpu": m_cpu["loss"],
            "loss_rel_diff": rel, "bulk": bulk, "max_diff": d.max().item(),
            "adam_bound": bound}


def lm_train_rounds(torch, agg, train, layers, seed, last: bool) -> dict:
    """``LM_TRAIN_ROUNDS`` sustainable rounds of granite-3-2b at full width
    cut to ``layers`` layers, after a warm-up round: each round's kernel
    launches (counts set to 0 before it, read after it), its fused_agg
    leaves against the plain version, wall time and peak memory.  Unless
    ``last``, returns no rounds where the warm-up peaks above
    ``LM_PEAK_LIMIT`` or runs out of memory (the peak is then the
    allocation when it did)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(get_config("granite-3-2b"), num_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = train.make_run(cfg=cfg, policy="sustainable", seed=seed,
                         device="cuda", **LM_TRAIN)
    C, T = run.fed.num_clients, run.fed.local_steps
    w, hist, worst, tap, oom = run.params, [], [], None, False
    try:
        train.train_round(run, w, 0)           # warm-up (allocator, cuBLAS)
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as e:
        if last:
            raise
        print(f"train lm: {layers} layers do not fit the card: "
              f"{str(e).splitlines()[0]}", flush=True)
        oom = True
    peak = torch.cuda.max_memory_allocated()
    if not oom and (last or peak <= LM_PEAK_LIMIT):
        for r in range(LM_TRAIN_ROUNDS):
            ops.zero_launches()
            torch.cuda.reset_peak_memory_stats()
            with AggTap(ops) as tap:
                t0 = time.perf_counter()
                w, m = train.train_round(run, w, r)
                dt = time.perf_counter() - t0
            counts = ops.launch_counts()
            peak = max(peak, torch.cuda.max_memory_allocated())
            if counts != {**dict.fromkeys(counts, 0), "fused_agg": 2} \
                    or len(tap.calls) != 1:
                raise AssertionError(f"train lm round {r}: launches {counts} "
                                     f"in {len(tap.calls)} aggregations, "
                                     f"expected 2 of fused_agg (one a "
                                     f"dtype) in one")
            worst.append(agg_tree_check(torch, agg, tap.calls[0]))
            hist.append({"round": r, **m, "round_ms": dt * 1e3,
                         "client_steps_per_s": C * T / dt,
                         "fused_agg_launches": counts["fused_agg"],
                         "agg_worst_err_over_bound": worst[-1]})
            print(f"train lm round {r}: loss {m['loss']:.4f} participants "
                  f"{m['participants']:.0f} {dt * 1e3:.1f} ms "
                  f"({C * T / dt:.2f} client-steps/s); launches {counts}; "
                  f"fused_agg leaves vs plain: worst err/bound "
                  f"{worst[-1]:.3f} ok", flush=True)
            if r + 1 < LM_TRAIN_ROUNDS:
                tap.calls.clear()
    return {"cfg": cfg, "run": run, "params": w, "history": hist,
            "peak_bytes": peak, "oom": oom,
            "last_agg": tap.calls[0] if tap else None}


def lm_train_phase(torch, agg, seed: int, card: str) -> dict:
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    # the stacked trees are large and their sizes vary round to round:
    # growable segments keep the allocator's cache from fragmenting
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    tried = {}
    for layers in LM_LAYERS:
        res = lm_train_rounds(torch, agg, train, layers, seed,
                              last=layers == LM_LAYERS[-1])
        tried[layers] = {"peak_bytes": res["peak_bytes"], "oom": res["oom"]}
        taken = bool(res["history"])
        print(f"train lm: granite-3-2b at full width, {layers} layers: peak "
              f"torch.cuda.max_memory_allocated {res['peak_bytes'] / 1e9:.2f}"
              f" GB{' when it ran out of memory' if res['oom'] else ''} "
              f"(limit {LM_PEAK_LIMIT / 1e9:.0f} GB): "
              f"{'taken' if taken else 'cut further'}", flush=True)
        if taken:
            break
        del res
        torch.cuda.empty_cache()
    cfg, run, hist, peak = (res["cfg"], res["run"], res["history"],
                            res["peak_bytes"])
    n_params = run.model.num_params(run.params)
    live = [h["loss"] for h in hist if h["participants"] > 0]
    if not (all(math.isfinite(x) for x in live) and live[-1] < live[0]):
        raise AssertionError(f"train lm: loss did not fall: {live}")
    C, T = run.fed.num_clients, run.fed.local_steps
    wall = sum(h["round_ms"] for h in hist) / 1e3
    print(f"train lm: {cfg.name} {cfg.num_layers} layers (cut from 40; "
          f"{n_params:,} params), C={C} T={T} batch {LM_TRAIN['batch']} x "
          f"{LM_TRAIN['seq']} tokens: {len(hist)} rounds in {wall:.3f} s = "
          f"{len(hist) * C * T / wall:.2f} client-steps/s on {card}; loss "
          f"{live[0]:.4f} -> {live[-1]:.4f}", flush=True)

    # the kernel on the round's own tree: device time, bound, plain, library
    w, ws, s, _ = res["last_agg"]
    leaves = [(a.reshape(-1), b.reshape(b.shape[0], -1)) for (_, a), (_, b)
              in zip(flat_leaves(w), flat_leaves(ws))]
    del res
    launches, n_leaves = len({a.dtype for a, _ in leaves}), len(leaves)
    reps = 10
    tree = lambda: ops.fused_agg_tree(w, ws, s)
    try:
        prof = device_profile(torch, lambda: [tree() for _ in range(reps)],
                              expect={"fused_agg_kernel": reps * launches})
        kernel_ms = sum(ms for n, ms in prof["all"]
                        if "fused_agg" in n) / reps
        timed_by = "torch.profiler"
    except ProfileIncomplete as e:
        # as phase 13 times a finalize the profiler misses: the launches
        # queued behind a sleeping kernel, so that the card runs them back
        # to back (host time is ~0.1% of a 2 ms tree)
        print(f"train lm: fused_agg tree: {e}", flush=True)
        kernel_ms = queued_ms(torch, tree, reps)
        timed_by = ("CUDA events around back-to-back launches (the "
                    "profiler missed kernels of every window)")
    nbytes = (sum((C + 2) * a.numel() * a.element_size() for a, _ in leaves)
              + s.numel() * 4)
    bound = nbytes / PEAK_BYTES * 1e3
    plain_ms = cuda_ms(lambda: [agg.fused_agg_plain(a, b, s)
                                for a, b in leaves], 3, torch)
    s_of = {torch.float32: s, torch.bfloat16: s.bfloat16()}
    beta = 1.0 - float(s.sum())
    library = lambda: [torch.addmv(a, b.t(), s_of[a.dtype], beta=beta)
                       for a, b in leaves]
    library_ms = cuda_ms(library, 10, torch)
    print(f"train lm: fused_agg on the round's tree ({len(leaves)} leaves, "
          f"C={C}, {sum(a.numel() for a, _ in leaves):,} params, fp32 norms "
          f"and bf16 weights): kernel {kernel_ms:.4f} ms ({timed_by}) in "
          f"{launches} launches, plain {plain_ms:.4f} ms, library addmv "
          f"{library_ms:.4f} ms ({len(leaves)} calls, one a leaf); bound "
          f"{bound:.4f} ms ({nbytes / 1e9:.3f} GB at {PEAK_BYTES / 1e12} "
          f"TB/s), {bound / kernel_ms:.1%} of it", flush=True)
    del w, ws, leaves, run
    torch.cuda.empty_cache()

    smoke = {"granite-3-2b": lm_round_vs_cpu(
        torch, train, "granite-3-2b smoke", get_smoke_config("granite-3-2b"),
        seed)}
    for mode in ("dense", "dispatch", "sorted", "sorted_local"):
        smoke[f"olmoe-1b-7b {mode}"] = lm_round_vs_cpu(
            torch, train, f"olmoe-1b-7b smoke {mode}", dataclasses.replace(
                get_smoke_config("olmoe-1b-7b"), moe_mode=mode), seed)
    return {"arch": cfg.name, "layers": cfg.num_layers, "params": n_params,
            **LM_TRAIN, "rounds": len(hist), "history": hist,
            "peak_bytes": peak, "layers_tried": tried,
            "wall_s": wall, "client_steps_per_s": len(hist) * C * T / wall,
            "fused_agg_launches": sum(h["fused_agg_launches"] for h in hist),
            "agg_tree": {"leaves": n_leaves, "kernel_ms": kernel_ms,
                         "timed_by": timed_by,
                         "plain_ms": plain_ms, "library_ms": library_ms,
                         "library_calls": n_leaves, "bytes": nbytes,
                         "bound_ms": bound, "launches_per_call": launches},
            "card_vs_cpu": smoke}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="write the JSON record of the run here")
    ap.add_argument("--sharded-child", nargs=4,
                    metavar=("RANK", "WORLD", "INIT", "OUT_DIR"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.sharded_child:
        rank, world, init, out_dir = args.sharded_child
        sharded_child(int(rank), int(world), init, out_dir, args.seed)
        return 0

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
    from repro_torch.kernels import fleet_step as fs
    from repro_torch.kernels import fused_agg as agg
    from repro_torch.kernels import ssd_scan as ssd

    # the port is held to float32 where it computes in float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = nvidia_smi()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda},"
          f" {torch.cuda.get_device_name(0)}; allow_tf32=False", flush=True)
    t0 = time.perf_counter()
    seconds = build.build_all(["flash_attention", "fused_agg", "fleet_step",
                               "serve_step", "ssd_scan"])
    print(f"kernel library builds (in parallel, {time.perf_counter() - t0:.2f}"
          f" s): " + ", ".join(f"{n} " + (f"{t:.2f} s" if t is not None
                                         else "already built")
                               for n, t in seconds.items()), flush=True)
    for name in seconds:
        for line in build.ptxas_log(name).splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line):
                print("ptxas:", line.strip())

    kernel = kernel_phase(torch, fa, args.seed)
    agg_kernel = fused_agg_phase(torch, agg, args.seed)
    fleet_kernel = fleet_step_phase(torch, fs, args.seed)
    serve_kernel = serve_step_phase(torch, fs, args.seed)
    ssd_kernel = ssd_scan_phase(torch, ssd, args.seed)
    serve = serve_phase(torch, fa, args.seed, card)
    kernel["launches"] = serve["flash_launches"]
    mamba = mamba2_serve_phase(torch, ssd, args.seed, card)
    ssd_kernel["launches"] = mamba["ssd_launches"]
    train = train_phase(torch, fa, agg, args.seed, card)
    agg_kernel["launches"] = sum(train[policy]["fused_agg_launches"]
                                 for policy in TRAIN_ROUNDS)
    fig1 = fig1_phase(torch, args.seed)
    fleet = fleet_phase(torch, fs, args.seed, card)
    fleet_kernel["launches"] = fleet["launches"]
    serve_fleet = serve_fleet_phase(torch, fs, args.seed, card)
    serve_kernel["launches"] = serve_fleet["launches"]
    sharded = sharded_phase(torch, fs, args.seed, card, fleet, serve_fleet)
    serve_moe = moe_serve_phase(torch, fa, args.seed, card)
    serve_vlm = vlm_serve_phase(torch, fa, args.seed, card)
    train_lm = lm_train_phase(torch, agg, args.seed, card)
    kernel["launches_by_path"] = {
        "serve granite-3-2b": serve["flash_launches"],
        **{f"serve olmoe-1b-7b {mode}": r["flash_launches"]
           for mode, r in serve_moe["runs"].items()},
        "serve internvl2-76b (8 layers)": serve_vlm["flash_launches"]}
    kernel["launches"] = sum(kernel["launches_by_path"].values())
    agg_kernel["launches_by_path"] = {
        "train cifar-cnn": agg_kernel["launches"],
        "train granite-3-2b": train_lm["fused_agg_launches"]}
    agg_kernel["launches"] = sum(agg_kernel["launches_by_path"].values())
    agg_kernel["lm_tree"] = train_lm["agg_tree"]
    for k, kind, unit in ((fleet_kernel, "fleet", "round"),
                          (serve_kernel, "serve", "epoch")):
        name = "fleet_step" if kind == "fleet" else "serve_step"
        k["sharded"] = {
            "launches": sharded[f"nccl1_{kind}"]["launches"],
            "finalize_launches": sharded[f"nccl1_{kind}"]["finalizes"],
            f"kernels_per_{unit}": sharded[f"{unit}_kernels"],
            "finalize_vs_plain": sharded[f"nccl1_{kind}"]["finalize_vs_plain"],
            "finalize_ms": sharded["finalize_ms"][name],
            "finalize_timed_by": sharded["finalize_timed_by"][name],
            "finalize_plain_ms": sharded["finalize_plain_ms"][name],
            "finalize_bound_ms": sharded["finalize_bound_ms"][name],
            "collective_ms_nccl_1_rank": sharded["nccl1_collective_ms"],
            "collective_ms_gloo_2_ranks": sharded["gloo2_collective_ms"]}

    kernels = [kernel, agg_kernel, fleet_kernel, serve_kernel, ssd_kernel]
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "kernels": kernels, "serve": serve,
              "serve_mamba2": mamba, "train": train, "fig1": fig1,
              "fleet": fleet, "serve_fleet": serve_fleet,
              "sharded": sharded, "serve_moe": serve_moe,
              "serve_vlm": serve_vlm, "train_lm": train_lm}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
