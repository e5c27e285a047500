"""Where the bf16 ssd_scan kernel's time goes: plants literal edits of
``csrc/ssd_scan.cu`` in copies of the checkout (``probes/plant.py``; never
in the repo itself), builds each copy and times it at the mamba2-1.3b
prefill shape (B=1, S=2048, H=64, P=64, N=128, G=1, chunk 256, bf16):
device time of each of its kernels by name (``torch.profiler``, 10 calls)
and CUDA events (20 calls).  A variant that drops work gives wrong
results; it is timed, not checked.

    python3 probes/ssd_variants.py          # on a machine with the card

Variants (each against the shipped source):
  base, base_again   unchanged (twice: the spread between calls)
  no_exp             the chunk pass's weights without exp(cum_t - cum_s) dt_s
  no_mx_lo           M x without M's second bf16 term
  no_inter           no h_prev load and no inter-chunk term
  chunk_2_blocks     the chunk pass at two blocks an SM, not three
"""
import json
import os
import subprocess
import sys
import tempfile

from plant import plant

CU = os.path.join("src", "repro_torch", "kernels", "csrc", "ssd_scan.cu")

VARIANTS = {
    "base": [],
    "no_exp": [[
        "const float m = live ? sc[i] * expf(ct[half] - cs) * ds : 0.f;",
        "const float m = live ? sc[i] : 0.f;"]],
    "no_mx_lo": [[
        "for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, ml[kk], dx + "
        "((s * BOX + kk * 16 * 128) >> 4));", ""]],
    "no_inter": [
        ["mbar_expect_tx(c_full, c > 0 ? 3 * TILE : TILE);",
         "mbar_expect_tx(c_full, TILE);"],
        ["      if (c > 0) {\n        for (int term",
         "      if (false) {\n        for (int term"],
        ["const bool inter = c > 0;", "const bool inter = false;"],
        ["if (c > 0 && t == 0) mbar_arrive(h_free);", ""]],
    "chunk_2_blocks": [[
        "__launch_bounds__(THREADS, 3)\n    ssd_scan_chunk_bf16",
        "__launch_bounds__(THREADS, 2)\n    ssd_scan_chunk_bf16"]],
    "base_again": [],
}

TIME = r'''
import json, os, sys, torch
sys.path[:0] = [os.path.join(sys.argv[1], "src"), sys.argv[1]]
import chip_smoke as c
from repro_torch.kernels import build, ssd_scan as ssd
build.build_all(["ssd_scan"])
gen = torch.Generator(device="cuda").manual_seed(3)
inputs = c.ssd_inputs(torch, gen, 1, 2048, 64, 64, 1, 128, torch.bfloat16)
run = lambda: ssd.ssd_scan_cuda(*inputs, chunk=256)
event_ms = c.cuda_ms(run, 20, torch)
prof = c.device_profile(torch, lambda: [run() for _ in range(10)])
parts = {name.split("::")[1].split("(")[0]: ms / 10
         for name, ms in prof["all"] if "ssd_scan" in name}
print("RESULT " + json.dumps({"event_ms": event_ms,
                              "device_ms": sum(parts.values()), **parts}))
'''


def main() -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    status = 0
    for name, edits in VARIANTS.items():
        with tempfile.TemporaryDirectory() as d:
            plant(d, [(CU, old, new) for old, new in edits])
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
