"""Where the serve_step kernel's time goes: plants literal edits of
``csrc/serve_step.cu`` in copies of a checkout (``probes/plant.py``; never
in the checkout itself), builds each copy and times it at n = 10,000,000
on the serving fleet's main-path instantiation (battery-gated admission,
sustainable training, hist, no mode output; ``chip_smoke.serve_inputs``):
the device time of each of its kernels by name (``torch.profiler``, 10
calls) and CUDA events around 20 back-to-back calls (host included).  A
variant that drops work gives wrong results; it is timed, not checked.

    python3 probes/serve_variants.py [--root DIR]   # on a machine with the card

``--root`` (default: this checkout) names the checkout whose source is
planted; the variants are those written for the design that source has
(each edit of ``csrc/serve_step.cu`` unless it names its file):

``one_pass_per_tile`` (the first version: a block a 4096-client tile,
a one-block second launch over the partial rows):
  base, base_again   unchanged (twice: the spread between calls)
  no_hist_atomics    no histogram atomics
  hoist_scalars      the stride-0 operands loaded once a thread
  ldg                every input through a read-only (__ldg) load
  hoist_ldg          both of the above
  no_second_pass     the second launch left out

``persistent`` (this source: a persistent grid; each tile's streams copied
into shared memory with cp.async one tile ahead of the one computed):
  base, base_again   unchanged
  blocks_4           the grid at 4 blocks an SM, not 3 (64 registers, not 80)
  tile_1024          tiles of 1024 clients (4 a thread), not 512
  product_then_add   each sum's term as a product, then an add (two
                     roundings of which the first is exact), not one fmaf
  scalar_path        the streams copied 4 bytes a client, not 16 a thread
  general_path       every input checked per client, as for per-client
                     battery, prices and thresholds
  block_hist         one row of counts a block, not one a warp
  no_hist            no histogram counts at all
  second_launch      the fold in a second one-block launch, not the last block
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

from plant import plant

CU = os.path.join("src", "repro_torch", "kernels", "csrc", "serve_step.cu")
PY = os.path.join("src", "repro_torch", "kernels", "fleet_step.py")

OLD_LD = "auto ld = [&](int j) { return a.p[j][i * a.s[j]]; };"
HOIST = ("  float cst[N_IN];\n#pragma unroll\n  for (int j = 0; j < N_IN; ++j)"
         " cst[j] = a.p[j][0];\n  const long long base = ")
VARIANTS = {
    "one_pass_per_tile": {
        "base": [],
        "no_hist_atomics": [["if (v != 0.f) {", "if (false) {"]],
        "hoist_scalars": [
            ["  const long long base = ", HOIST],
            [OLD_LD, "auto ld = [&](int j) { return a.s[j] ? a.p[j][i] "
                     ": cst[j]; };"]],
        "ldg": [[OLD_LD, "auto ld = [&](int j) { return __ldg(a.p[j] + "
                         "i * a.s[j]); };"]],
        "hoist_ldg": [
            ["  const long long base = ", HOIST],
            [OLD_LD, "auto ld = [&](int j) { return a.s[j] ? __ldg(a.p[j] "
                     "+ i) : cst[j]; };"]],
        "no_second_pass": [["  serve_step_reduce<<<",
                            "  if (0) serve_step_reduce<<<"]],
        "base_again": [],
    },
    "persistent": {
        "base": [],
        "blocks_4": [["BLOCKS_PER_SM = 3;", "BLOCKS_PER_SM = 4;"],
                     [PY, "SERVE_BLOCKS_PER_SM = 3\n",
                      "SERVE_BLOCKS_PER_SM = 4\n"]],
        "tile_1024": [["constexpr int CPT = 2;", "constexpr int CPT = 4;"],
                      [PY, "SERVE_CPT = 2\n", "SERVE_CPT = 4\n"]],
        "product_then_add": [[
            "for (int j = 0; j < F - 1; ++j) acc[j] = __fmaf_rn(v, col[j], "
            "acc[j]);", "for (int j = 0; j < F - 1; ++j) acc[j] = __fadd_rn("
            "acc[j], __fmul_rn(v, col[j]));"]],
        "scalar_path": [["const bool vec = a.vec;", "const bool vec = false;"]],
        "general_path": [
            ["const bool streams_only = pc == stream_bits<ADM, TRAIN, HIST>();",
             "const bool streams_only = false;"]],
        "block_hist": [["int* whist = hist + warp * NBINS;",
                        "int* whist = hist;"]],
        "no_hist": [["if (v != 0.f) {                         // valid",
                     "if (false) {                         // valid"]],
        "second_launch": [
            ["if (tid == 0) last = atomicAdd(&a.counts[0], 1) == a.grid - 1;",
             "if (tid == 0) last = false;"],
            ["  return dispatch<Launch>(admission, train, hist, &a, st);",
             "  const int err = dispatch<Launch>(admission, train, hist, &a, "
             "st);\n  if (err) return err;\n  serve_step_fold<<<1, THREADS, "
             "0, st>>>(a, hist ? NBINS : 0);\n  return static_cast<int>("
             "cudaGetLastError());"]],
        "base_again": [],
    },
}

TIME = r'''
import json, os, sys, torch
sys.path[:0] = [os.path.join(sys.argv[1], "src"), sys.argv[1]]
import chip_smoke as c
from repro_torch.kernels import build, fleet_step as fs
build.build_all(["serve_step"])
gen = torch.Generator(device="cuda").manual_seed(1)
n = c.SERVE_KERNEL_BIG
program, env = c.serve_inputs(torch, n, gen, admission="battery_gated",
                              train="sustainable", hist=True)
run = lambda: fs.fleet_step_cuda(program, env, n=n)
event_ms = c.cuda_ms(run, 20, torch)
prof = c.device_profile(torch, lambda: [run() for _ in range(10)])
parts = {name.split("(")[0].split("<")[0].split("::")[-1]: ms / 10
         for name, ms in prof["all"] if "serve_step" in name}
print("RESULT " + json.dumps({"event_ms": event_ms,
                              "device_ms": sum(parts.values()), **parts}))
'''


def design(root: str) -> str:
    with open(os.path.join(root, CU)) as f:
        text = f.read()
    return "persistent" if "serve_step_fold_only" in text \
        else "one_pass_per_tile"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    root = os.path.abspath(ap.parse_args().root)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    kind = design(root)
    print(f"card: {card}; source {root} ({kind})", flush=True)
    status = 0
    for name, edits in VARIANTS[kind].items():
        with tempfile.TemporaryDirectory() as d:
            plant(d, [e if len(e) == 3 else (CU, *e) for e in edits],
                  root=root)
            out = subprocess.run([sys.executable, "-c", TIME, d],
                                 capture_output=True, text=True)
        res = [l[7:] for l in out.stdout.splitlines()
               if l.startswith("RESULT ")]
        if res:
            r = json.loads(res[0])
            print(f"{name}: " + ", ".join(f"{k} {v:.4f}" for k, v in r.items()),
                  flush=True)
        else:
            status = 1
            print(f"{name}: FAILED\n{(out.stdout + out.stderr)[-2000:]}",
                  flush=True)
    return status


if __name__ == "__main__":
    sys.exit(main())
