"""How often ``torch.profiler`` on the card misses kernels: profiles many
windows of queued launches and counts the kernels each window recorded
against the launches it queued (``chip_smoke.device_profile`` takes a
short window again, and fails after ten).

    python3 probes/profiler_drops.py [--root DIR] [--windows N] [--dist] [--nccl]

``--root`` (default: this checkout) names the checkout whose kernels are
built and profiled.  A run is one process.  It reports whether
``import torch`` alone imported ``torch.distributed.device_mesh`` and
whether the checkout's kernels package did; ``--dist`` imports
``torch.distributed.device_mesh`` before the checkout; ``--nccl`` holds a
one-rank NCCL group and a ("data",) mesh on cuda:0 while it profiles, as
``chip_smoke.py``'s phase 13 (a) does.  Then N windows (default 200) of
10 flash_attention launches at phase 2's granite-3-2b shape (B=1, S=2048,
H=32, K=8, D=64, bf16, causal) and, where the checkout has the sharded
finalizes, N windows each of 10 fleet_step and 10 serve_step finalize
launches.  Prints one JSON line: for each kind of window, how many
recorded all 10 kernels, some of them, none, or more.
"""
import argparse
import datetime
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCHES = 10


def windows(torch, fn, name: str, count: int) -> dict:
    """Profiles ``count`` windows of one call of ``fn`` (LAUNCHES kernels
    whose names hold ``name``), after a warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {"complete": 0, "short": 0, "empty": 0, "over": 0, "short_at": []}
    for i in range(count):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        got = sum(e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and name in e.key)
        kind = ("complete" if got == LAUNCHES else "empty" if got == 0
                else "short" if got < LAUNCHES else "over")
        out[kind] += 1
        if kind != "complete":
            out["short_at"].append([i, got])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--windows", type=int, default=200)
    ap.add_argument("--dist", action="store_true")
    ap.add_argument("--nccl", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)

    import torch
    by_torch = "torch.distributed.device_mesh" in sys.modules
    if args.dist:
        import torch.distributed.device_mesh  # noqa: F401
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fleet_step as fs
    by_port = "torch.distributed.device_mesh" in sys.modules
    finalizes = hasattr(fs, "fleet_finalize_cuda")
    build.build_all(["flash_attention"]
                    + (["fleet_step", "serve_step"] if finalizes else []))

    group = None
    if args.nccl:
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        dist.init_process_group(
            "nccl", init_method=f"file://{tempfile.mkdtemp()}/nccl", rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=60))
        group = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
    try:
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = ((torch.randn((1, 2048, h, 64), generator=gen,
                                device="cuda") * 0.5).to(torch.bfloat16)
                   for h in (32, 8, 8))
        kinds = {"flash_attention": (lambda: [
            fa.flash_attention_cuda(q, k, v) for _ in range(LAUNCHES)],
            "flash_fwd_bf16")}
        if finalizes:
            from repro_torch.energy import step_ops
            from repro_torch.energy.battery import BatteryConfig
            from repro_torch.energy.costs import DecodeCostModel
            from repro_torch.serve import BatteryGated, QoSSpec, TrainLoad
            fprog, _ = step_ops.fleet_step_program(
                BatteryConfig(), "sustainable", None, hist=True)
            sprog, _ = step_ops.serve_step_program(
                BatteryConfig(), DecodeCostModel(1.0, 1.0), QoSSpec(),
                BatteryGated.create(1), TrainLoad.create([1], 1.0),
                hist=True)
            frow = torch.zeros(8 + fs.NBINS, dtype=torch.float64,
                               device="cuda")
            srow = torch.zeros(16 + fs.NBINS, dtype=torch.float64,
                               device="cuda")
            kinds["fleet_step finalize"] = (lambda: [
                fs.fleet_finalize_cuda(fprog, frow)
                for _ in range(LAUNCHES)], "fleet_step_finalize")
            kinds["serve_step finalize"] = (lambda: [
                fs.serve_finalize_cuda(sprog, srow)
                for _ in range(LAUNCHES)], "serve_step_finalize")
        record = {"root": root, "torch": torch.__version__,
                  "device_mesh_imported_by_torch": by_torch,
                  "device_mesh_imported_by_the_port": by_port,
                  "dist_flag": args.dist, "nccl_group": group is not None,
                  "windows": args.windows}
        for label, (fn, name) in kinds.items():
            record[label] = windows(torch, fn, name, args.windows)
    finally:
        if group is not None:
            torch.distributed.destroy_process_group()
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
