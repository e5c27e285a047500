"""The dry run: every (arch x input shape) step bundle traced shape-only,
its counts and its roofline on the H100's spec rates (port of the JAX
package's ``launch/dryrun.py``).

    python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh card|single|multi|both] [--out DIR] [--device cuda|cpu]

Nothing is allocated and no kernel runs: a bundle's arguments are fake
tensors (``FakeTensorMode``) and the kernels reach their fake
implementations (`kernels.ops`).  A CUDA build of torch traces on fake
CUDA tensors without a card; a build without CUDA support cannot index
them, and takes ``--device cpu`` (the bundles pick the kernel path
themselves, so the counts are the same).

Meshes:

* ``card`` (default): one H100, the whole step on it.  The record holds
  ``cost.flops_per_device`` (``torch.utils.flop_counter``, each kernel at
  its own work), ``cost.bytes_per_device`` (operand plus result bytes of
  every op, unfused: views move none; an upper bound on traffic, not a
  fused count), ``memory`` (argument and output bytes exact; the
  ``temp_bytes_per_device`` is the peak of the bytes the step allocates
  beyond its arguments, outputs included), the ``roofline`` on
  `launch.mesh`'s H100 rates (collectives 0), ``model_flops``,
  ``useful_compute_ratio``, ``params_analytic`` / ``params_active`` and
  ``energy``.
* ``single`` / ``multi``: the reference's 16 x 16 and 2 x 16 x 16
  layouts (`launch.mesh.PRODUCTION_TOPOLOGY`).  The record holds the
  exact per-device argument and output bytes from the specs, after
  checking that every spec divides its dim.  The step is not partitioned
  (``"partitioned": false``): ``cost.flops_per_device`` is the whole
  step's count split evenly over the devices, and bytes, temps and
  collectives per device are null.

The reference's loop calibration has no counterpart: the port's layers
and local steps are Python loops, so every one is counted
(``loop_calibrated: false``; ``--no-calibrate`` is accepted and changes
nothing).  Its HLO collective parser has none either.  Failures land as
``<name>.json.err`` tracebacks in ``--out``; the exit code is 1 on any.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SKIPS, dryrun_pairs, get_config, get_shape
from repro_torch.energy import costs as energy_costs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.steps import StepBundle, build_step, fake_mode_of
from repro_torch.tree import tree_leaves

_FREE = ("empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_local_scalar_dense")


def _tensors(tree) -> list:
    """The distinct tensors of a tree (by identity), in tree order."""
    seen, out = set(), []
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor) and id(x) not in seen:
            seen.add(id(x))
            out.append(x)
    return out


def tree_bytes(tree, device_type: str | None = None) -> int:
    """Bytes of the distinct tensors of ``tree`` (numel x element size),
    only those on ``device_type`` if given."""
    return sum(x.numel() * x.element_size() for x in _tensors(tree)
               if device_type is None or x.device.type == device_type)


class StepCounter(TorchDispatchMode):
    """Counts what a step moves, op by op, under a fake (or real) trace:
    ``bytes``, the operand plus result bytes of every op that returns a
    tensor and is not a view (unfused: each op reads its inputs and writes
    its outputs); and
    ``temp_peak``, the peak of the live bytes of storages first made by an
    op of the step (the arguments' storages are excluded; a storage is
    freed when the tensor that made it dies)."""

    def __init__(self, args):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.temp_peak = 0
        self._known = {x.untyped_storage()._cdata for x in _tensors(args)}

    def _free(self, key, nbytes):
        self._known.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        results = _tensors(out)
        if not results:          # metadata queries (prim.device, sizes)
            return out
        self.ops += 1
        name = func.overloadpacket.__name__
        if not func.is_view and name not in _FREE:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in _tensors((args, kwargs, out)))
        for t in results:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._known:
                continue
            self._known.add(key)
            self.live += st.nbytes()
            self.temp_peak = max(self.temp_peak, self.live)
            weakref.finalize(t, self._free, key, st.nbytes())
        return out


def trace(bundle: StepBundle) -> dict:
    """Run ``bundle.fn`` on its fake arguments under a ``FlopCounterMode``
    and a `StepCounter`: {flops, flops_by_op, bytes, temp_peak, ops,
    outputs (the fake results), seconds}."""
    mode = fake_mode_of(bundle)
    t0 = time.perf_counter()
    with mode:
        with FlopCounterMode(display=False) as fc, \
                StepCounter(bundle.args) as counter:
            outputs = bundle.fn(*bundle.args)
    by_op = {str(k): int(v) for k, v in
             fc.get_flop_counts().get("Global", {}).items()}
    return {"flops": int(fc.get_total_flops()), "flops_by_op": by_op,
            "bytes": int(counter.bytes), "temp_peak": int(counter.temp_peak),
            "ops": counter.ops, "outputs": outputs,
            "seconds": time.perf_counter() - t0}


def per_device_bytes(tree, specs, mesh, device_type: str | None = None
                     ) -> int:
    """Bytes a device of ``mesh`` holds of ``tree`` laid out by ``specs``
    (a tree of `dist.sharding.P` over ``tree``'s tensors; other leaves,
    and tensors off ``device_type`` if given, ignored).  Raises where an
    axis product does not divide its dim."""
    from repro_torch.dist import sharding as shard

    total = 0
    for x, spec in zip(tree_leaves(tree), tree_leaves(specs)):
        if not isinstance(x, torch.Tensor) or (
                device_type is not None and x.device.type != device_type):
            continue
        if len(spec) > x.dim():
            raise ValueError(f"spec {spec} has more entries than the "
                             f"shape {tuple(x.shape)}")
        parts = 1
        for d, entry in enumerate(spec):
            n = shard.mesh_axis_size(mesh, entry)
            if x.shape[d] % n:
                raise ValueError(f"spec {spec}: dim {d} of "
                                 f"{tuple(x.shape)} does not divide over "
                                 f"{entry} ({n})")
            parts *= n
        total += x.numel() * x.element_size() // parts
    return total


def model_flops(cfg, shape, local_steps: int = 5) -> float:
    """6 N D with D the tokens the step processes (2 N D for serving
    steps; N the active params)."""
    n = cfg.num_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len * local_steps
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch      # decode: one token a sequence


def _mesh_of(name: str):
    """(mesh for build_step, the spec mesh, chips) of a ``--mesh`` name."""
    if name == "card":
        return None, mesh_lib.card_spec_mesh(), 1
    spec = mesh_lib.production_spec_mesh(multi_pod=name == "multi")
    chips = 1
    for n in spec.shape.values():
        chips *= n
    return spec, spec, chips


def run_one(arch: str, shape_name: str, mesh: str = "card",
            local_steps: int = 5, extra_tag: str = "", cfg=None,
            device="cuda") -> dict:
    """The record of one (arch, registry shape) on ``mesh`` (``card``,
    ``single`` or ``multi``)."""
    cfg = cfg or get_config(arch)
    shape = get_shape(shape_name)
    t0 = time.perf_counter()
    bundle = build_step(cfg, shape, _mesh_of(mesh)[0], device=device, **(
        {"local_steps": local_steps} if shape.kind == "train" else {}))
    t_build = time.perf_counter() - t0
    return make_record(cfg, shape, bundle, trace(bundle), mesh, local_steps,
                       extra_tag, build_s=t_build, arch=arch)


def make_record(cfg, shape, bundle: StepBundle, tr: dict, mesh: str = "card",
                local_steps: int = 5, extra_tag: str = "",
                build_s: float = 0.0, arch: str | None = None) -> dict:
    """The record of ``bundle`` (built for ``cfg`` / ``shape`` on ``mesh``)
    from its `trace` ``tr``: the reference's keys, which either package's
    ``from_dryrun`` reads."""
    _, spec_mesh, chips = _mesh_of(mesh)
    dev = torch.device(bundle.meta["device"])
    steps_in = local_steps if shape.kind == "train" else 1
    partitioned = mesh == "card"
    arg_bytes = tree_bytes(bundle.args, dev.type)
    out_bytes = tree_bytes(tr["outputs"], dev.type)
    if partitioned:
        dev_flops = float(tr["flops"])
        dev_bytes = float(tr["bytes"])
        coll_bytes = 0.0
        memory = {"argument_bytes_per_device": arg_bytes,
                  "output_bytes_per_device": out_bytes,
                  "temp_bytes_per_device": tr["temp_peak"],
                  "total_bytes_per_device": arg_bytes + tr["temp_peak"]}
    else:
        dev_flops = tr["flops"] / chips
        dev_bytes = coll_bytes = None
        a = per_device_bytes(bundle.args, bundle.in_specs, spec_mesh,
                             dev.type)
        o = per_device_bytes(tr["outputs"], bundle.out_specs, spec_mesh,
                             dev.type)
        memory = {"argument_bytes_per_device": a,
                  "output_bytes_per_device": o,
                  "temp_bytes_per_device": None,
                  "total_bytes_per_device": None,
                  "argument_bytes_global": arg_bytes,
                  "output_bytes_global": out_bytes}

    terms = {"compute": dev_flops / mesh_lib.PEAK_FLOPS_BF16,
             "memory": (None if dev_bytes is None
                        else dev_bytes / mesh_lib.HBM_BW),
             "collective": (None if coll_bytes is None
                            else coll_bytes / mesh_lib.NVLINK_BW)}
    known = {k: v for k, v in terms.items() if v is not None}
    mf = model_flops(cfg, shape, local_steps)
    mesh_txt = "x".join(str(n) for n in spec_mesh.shape.values())
    return {
        "arch": arch or cfg.name,
        "shape": shape.name,
        "mesh": f"{mesh_txt} ({','.join(spec_mesh.axis_names)})",
        "mesh_name": mesh,
        "multi_pod": mesh == "multi",
        "device": str(dev),
        "tag": extra_tag,
        "kind": shape.kind,
        "step_meta": bundle.meta,
        "overrides": extra_tag,
        "partitioned": partitioned,
        "trace_s": round(build_s + tr["seconds"], 2),
        "memory": memory,
        "cost": {"flops_per_device": dev_flops,
                 "bytes_per_device": dev_bytes,
                 "flops_global": float(tr["flops"]),
                 "bytes_global": float(tr["bytes"]),
                 "flops_by_op": tr["flops_by_op"],
                 "ops": tr["ops"],
                 "bytes_counted": "operand + result bytes of every op "
                                  "(views none), unfused: an upper bound "
                                  "on traffic",
                 "per_device": ("the whole step on one card" if partitioned
                                else "flops: the whole step split evenly "
                                     "over the devices (not partitioned)"),
                 "loop_calibrated": False},
        "collectives": ({"total_bytes": 0.0} if partitioned else None),
        "collective_bytes_per_device": coll_bytes,
        "roofline": {
            **{f"t_{k}_s": v for k, v in terms.items()},
            "dominant": max(known, key=known.get),
            "rates": {"peak_flops_bf16": mesh_lib.PEAK_FLOPS_BF16,
                      "hbm_bw": mesh_lib.HBM_BW,
                      "nvlink_bw": mesh_lib.NVLINK_BW,
                      "source": "NVIDIA H100 SXM data sheet (spec)"},
            "model_flops": mf,
            "useful_compute_ratio": (mf / tr["flops"] if tr["flops"]
                                     else 0.0),
        },
        "params_analytic": cfg.num_params(),
        "params_active": cfg.num_active_params(),
        "energy": energy_costs.energy_record(
            dev_flops, cfg.num_active_params(), steps_in),
    }


def _apply_overrides(cfg, overrides):
    for kv in overrides:
        k, v = kv.split("=", 1)
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            v = v.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            v = int(v)
        elif isinstance(cur, float):
            v = float(v)
        cfg = dataclasses.replace(cfg, **{k: v})
    return cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=["card", "single", "multi", "both"],
                    default="card",
                    help="card: one H100; single / multi: the 16x16 and "
                         "2x16x16 layouts (specs; both: the two)")
    ap.add_argument("--out", default="benchmarks/dryrun_results_torch")
    ap.add_argument("--local-steps", type=int, default=5)
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors (no card is used; a "
                         "torch without CUDA support needs cpu)")
    ap.add_argument("--no-calibrate", action="store_true",
                    help="accepted for the reference's command line; does "
                         "nothing: every layer and step is counted")
    ap.add_argument("--override", nargs="*", default=[],
                    help="config overrides key=value, e.g. --override "
                         "model_axis_role=dp micro_batches=8")
    args = ap.parse_args(argv)

    pairs = dryrun_pairs()
    if args.arch != "all":
        pairs = [(a, s) for a, s in pairs if a == args.arch]
    if args.shape != "all":
        pairs = [(a, s) for a, s in pairs if s == args.shape]
    meshes = {"card": ["card"], "single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape in pairs:
        for mesh in meshes:
            name = f"{arch}__{shape}__{mesh}"
            if args.tag:
                name += f"__{args.tag}"
            path = os.path.join(args.out, name + ".json")
            try:
                rec = run_one(arch, shape, mesh, args.local_steps, args.tag,
                              cfg=_apply_overrides(get_config(arch),
                                                   args.override),
                              device=args.device)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                r, m = rec["roofline"], rec["memory"]
                fmt = lambda v: "null" if v is None else f"{v:.3e}"
                print(f"OK   {name}: trace={rec['trace_s']}s "
                      f"args/dev={m['argument_bytes_per_device'] / 2**30:.2f}"
                      f"GiB t_comp={fmt(r['t_compute_s'])} "
                      f"t_mem={fmt(r['t_memory_s'])} "
                      f"t_coll={fmt(r['t_collective_s'])} "
                      f"dom={r['dominant']} "
                      f"useful={r['useful_compute_ratio']:.2f}", flush=True)
            except Exception as e:  # noqa: BLE001 — reported, run goes on
                failures += 1
                with open(path + ".err", "w") as f:
                    f.write(traceback.format_exc())
                print(f"FAIL {name}: {type(e).__name__}: {e}", flush=True)
    skipped = [f"{a}/{s}: {why}" for (a, s), why in SKIPS.items()]
    print(f"done. failures={failures}; policy-skips={skipped}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
