"""The fleet step: the Hopper kernels' wrappers and their plain PyTorch
version.

Port of ``repro/kernels/fleet_step.py`` (``fused_step``) for the two
programs of ``energy.step_ops``: the training fleet's round
(``fleet_step_program``) and the serving epoch (``serve_step_program``).
A hand-written kernel cannot run the program's op closures, so each
program has its kernel: ``csrc/fleet_step.cu``, templated on the gate
(SUSTAINABLE, THRESHOLD, GREEDY/ALWAYS), histograms, groups and mask
output; and ``csrc/serve_step.cu``, templated on the admission rule
(agnostic, battery-gated, charge-gated), the training gate (none,
SUSTAINABLE, THRESHOLD, GREEDY/ALWAYS) and histograms, with the mode
output a runtime flag.  Each wrapper checks that the program it is handed
is one of those programs (ops, reads, writes, state, emits, stat layout
and the closures' choices) and raises for any other.

* ``fleet_step_cuda`` launches a kernel and its one-block reduction on
  PyTorch's current stream; CUDA tensors only, no fallback.  A serve
  program goes to ``serve_step_cuda``, whose kernel folds its blocks'
  partial sums in the same launch.  Per-client outputs are bitwise
  equal to the plain version on any inputs.  Stats are bitwise equal on
  dyadic inputs and within ``kernel_tolerance`` of the exact sums
  otherwise; histogram counts are exact.  ``fleet_step_cuda.launches`` and
  ``serve_step_cuda.launches`` count the launches of each kernel (one per
  round or epoch).
* ``fleet_step_plain`` is ``step_ops.run_step``: what the CPU runs.
* ``fused_step_sharded`` is the reference's form under ``shard_map`` for a
  fleet sharded over ``torch.distributed`` ranks (`dist.sharding`): each
  rank runs its program's kernel on its slab with the kernel writing its
  row of pre-average sums (float64: the float32 totals and the integer
  counts held exactly) instead of the stats, the row is all-reduced once
  over the mesh's data group, and a one-block finalize
  (``fleet_finalize_cuda`` / ``serve_finalize_cuda``) forms the stats by
  the same device code as the host-local launch.  On the CPU it runs the
  plain version's arithmetic to the same row (``step_ops.stat_row``),
  all-reduces it over gloo and averages as ``step_ops.row_stats`` does.
  One rank's stats equal the host-local ones bit for bit, dyadic inputs'
  on any number of ranks; ``kernel_tolerance(..., world=)`` bounds the
  rest.  The finalize launches count on their own wrappers' ``.launches``.

Both take ``env`` holding every buffer of ``program.input_names()`` plus
``valid`` (0. or 1. per client) and, with ``num_groups``, ``groups``
(int32); each is a 0-dim tensor, a scalar expanded to (n,) (stride 0) or
an (n,) tensor.  Both return ``(state, emits, stats)``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.scheduling import Policy
from repro_torch.dist import collectives
from repro_torch.energy import battery as battery_lib
from repro_torch.energy import step_ops
from repro_torch.kernels import build
from repro_torch.obs import hist as hist_lib

# csrc/fleet_step.cu's launch shape: the reduction order follows from it
THREADS = 256
WARPS = THREADS // 32
CPT = 16                       # clients per thread
TILE = THREADS * CPT           # clients per block
REDUCE_LANES = 32              # lanes that add one column over the blocks
MAX_GROUPS = 64
NBINS = sum(s.bins for s in hist_lib.FLEET_HIST_SPECS)
GATES = {Policy.SUSTAINABLE: 0, Policy.THRESHOLD: 1, Policy.GREEDY: 2}
# csrc/serve_step.cu's launch shape: a persistent grid of SERVE_BLOCKS_PER_SM
# blocks an SM, each walking SERVE_TILE-client tiles, SERVE_CPT clients a
# thread a tile; the reduction order follows from it
SERVE_THREADS = 256
SERVE_CPT = 2
SERVE_TILE = SERVE_THREADS * SERVE_CPT
SERVE_BLOCKS_PER_SM = 3
H100_SMS = 132
# csrc/serve_step.cu's template choices and the order of its inputs
ADMISSIONS = {"agnostic": 0, "battery_gated": 1, "charge_gated": 2}
TRAINS = {"none": 0, "sustainable": 1, "threshold": 2, "greedy": 3}
SERVE_INPUTS = ("charge", "harvest", "requests", "valid", "bat_capacity",
                "bat_leak", "cost_joules_per_prefill_token",
                "cost_joules_per_decode_step",
                "cost_joules_per_response_upload", "qos_prompt_tokens",
                "qos_full_decode_tokens", "qos_short_decode_tokens",
                "pol_hi", "pol_lo", "admit", "train_round_cost",
                "train_threshold", "twant", "streak")
U32 = 2.0 ** -24               # float32 unit roundoff


def fleet_step_plain(program: step_ops.StepProgram, env: dict, *, n: int,
                     emit: bool = False, num_groups: int | None = None,
                     group=None):
    """Plain PyTorch: ``step_ops.run_step`` (its row all-reduced over
    ``group``, the ranks of a sharded fleet, where one is given).  Returns
    (state, emits, stats)."""
    out, stats = step_ops.run_step(program, env, valid=env["valid"],
                                   groups=env.get("groups") if num_groups
                                   else None, num_groups=num_groups,
                                   group=group)
    state = {nm: out[nm] for nm in program.state_out}
    emits = {nm: out[nm] for nm in program.emit} if emit else {}
    return state, emits, stats


@functools.cache
def _signatures() -> dict:
    """{program signature: (gate, hist)} of every fleet program the kernel
    runs, with and without groups."""
    table = {}
    for policy in (Policy.SUSTAINABLE, Policy.THRESHOLD, Policy.GREEDY):
        for hist in (False, True):
            for groups in (None, 1):
                program, _ = step_ops.fleet_step_program(
                    battery_lib.BatteryConfig(), policy, groups, hist=hist)
                table[program.signature()] = (GATES[policy], hist)
    return table


def program_variant(program: step_ops.StepProgram,
                    num_groups: int | None) -> tuple[int, bool]:
    """(gate, hist) of the kernel instantiation that runs ``program``;
    raises if ``program`` is not a fleet program the kernel implements."""
    found = _signatures().get(program.signature())
    if found is None:
        raise ValueError(f"fleet_step kernel: program {program.name!r} "
                         f"(ops {[op.name for op in program.ops]}) is not "
                         f"one that energy.step_ops.fleet_step_program "
                         f"builds; the kernel runs only those")
    if bool(program.group_totals) != bool(num_groups):
        raise ValueError("fleet_step kernel: the program's group stats and "
                         "num_groups must come together")
    return found


def _operand(env: dict, name: str, n: int, dtype, device):
    """(tensor, stride) for one input buffer: stride 0 for a scalar or a
    scalar expanded to (n,), 1 for a contiguous (n,) tensor."""
    t = env[name]
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"fleet_step_cuda: {name} must be a tensor, got "
                         f"{type(t).__name__}")
    if t.device != device:
        raise ValueError(f"fleet_step_cuda: {name} is on {t.device}, charge "
                         f"on {device}")
    if t.dtype != dtype:
        raise ValueError(f"fleet_step_cuda: {name} must be {dtype}, got "
                         f"{t.dtype}")
    if t.dim() == 0 or t.shape == (1,):
        return t.reshape(1), 0
    if t.shape != (n,):
        raise ValueError(f"fleet_step_cuda: {name} has shape "
                         f"{tuple(t.shape)}; expected a scalar or ({n},)")
    if t.stride(0) == 0:
        return t, 0
    if not t.is_contiguous():
        raise ValueError(f"fleet_step_cuda: {name} must be contiguous "
                         f"(stride {t.stride()})")
    return t, 1


@functools.cache
def _kernel():
    lib = build.load("fleet_step")
    fn = lib.fleet_step
    ptr, s = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = ([ptr, s] * 10 + [ptr] * 8
                   + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ptr])
    fn.restype = ctypes.c_int
    lib.fleet_step_finalize.argtypes = [ptr] * 3 + [ctypes.c_int] * 2 + [ptr]
    lib.fleet_step_finalize.restype = ctypes.c_int
    lib.fleet_step_error_string.argtypes = [ctypes.c_int]
    lib.fleet_step_error_string.restype = ctypes.c_char_p
    return lib


def stat_layout(program: step_ops.StepProgram, num_groups: int | None
                ) -> dict[str, slice | int]:
    """Where each stat lies in the kernel's ``stats`` output."""
    G = num_groups or 0
    out: dict[str, slice | int] = {}
    for i, (s, _) in enumerate(program.totals + program.averages):
        out[s] = i
    off = len(program.totals) + len(program.averages)
    if G:
        out[program.group_totals[0][0]] = slice(off, off + G)
        out[program.group_averages[0][0]] = slice(off + G, off + 2 * G)
        off += 2 * G
    for spec in program.hists:
        out[spec.name] = slice(off, off + spec.bins)
        off += spec.bins
    return out


def fleet_step_cuda(program: step_ops.StepProgram, env: dict, *, n: int,
                    emit: bool = False, num_groups: int | None = None,
                    row: bool = False):
    """Launch the Hopper kernel for one round over ``n`` clients; returns
    (state, emits, stats) as new tensors on the card, or with ``row`` (a
    rank's slab of a sharded fleet) (state, emits, row): its (F + H,)
    float64 row of sums for ``fleet_finalize_cuda``.  Raises on a program
    the kernel does not run, on inputs it does not take and on a launch
    error."""
    if program.name == "serve_step":
        if num_groups:
            raise ValueError("fleet_step_cuda: the serve program has no "
                             "group stats")
        return serve_step_cuda(program, env, n=n, emit=emit, row=row)
    gate, hist = program_variant(program, num_groups)
    G = num_groups or 0
    if n < 1 or not 0 <= G <= MAX_GROUPS:
        raise ValueError(f"fleet_step_cuda: n={n} must be at least 1 and "
                         f"num_groups={G} at most {MAX_GROUPS}")
    charge = env["charge"]
    device = charge.device
    if device.type != "cuda":
        raise ValueError(f"fleet_step_cuda: charge is on {device}; the kernel "
                         f"takes CUDA tensors")
    f32 = torch.float32
    names = ["charge", "harvest", "bat_capacity", "bat_leak", "round_cost"]
    names += ["threshold"] if gate == GATES[Policy.THRESHOLD] else [None]
    names += ["want"] if gate == GATES[Policy.SUSTAINABLE] else [None]
    names += ["valid"]
    args, keep = [], []
    for nm in names:
        if nm is None:
            args += [None, 0]
            continue
        t, s = _operand(env, nm, n, f32, device)
        keep.append(t)
        args += [t.data_ptr(), s]
    for nm, dtype, on in (("groups", torch.int32, G > 0),
                          ("streak", f32, hist)):
        if on:
            t, s = _operand(env, nm, n, dtype, device)
            keep.append(t)
            args += [t.data_ptr(), s]
        else:
            args += [None, 0]

    blocks = -(-n // TILE)
    F = 8 + 3 * G
    H = NBINS if hist else 0
    charge_out = torch.empty(n, dtype=f32, device=device)
    streak_out = torch.empty(n if hist else 1, dtype=f32, device=device)
    mask_out = torch.empty(n if emit else 1, dtype=f32, device=device)
    partials = torch.empty((F, blocks), dtype=f32, device=device)
    counts = torch.empty((max(H, 1), blocks), dtype=torch.int32,
                         device=device)
    sums = torch.empty(F + H, dtype=f32, device=device)
    stats_buf = torch.empty(7 + 2 * G + H, dtype=f32, device=device)
    row_buf = (torch.empty(F + H, dtype=torch.float64, device=device)
               if row else None)
    lib = _kernel()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.fleet_step(*args, charge_out.data_ptr(), streak_out.data_ptr(),
                         mask_out.data_ptr(), partials.data_ptr(),
                         counts.data_ptr(), sums.data_ptr(),
                         stats_buf.data_ptr(),
                         row_buf.data_ptr() if row else None, n, gate,
                         int(hist), int(emit), G, stream)
    if err != 0:
        msg = lib.fleet_step_error_string(err).decode()
        raise RuntimeError(f"fleet_step kernel launch failed ({err}: {msg}) "
                           f"for n={n}, gate={gate}, hist={hist}, groups={G}")
    fleet_step_cuda.launches += 1
    state = {"charge_out": charge_out}
    if hist:
        state["streak_out"] = streak_out
    emits = {"mask": mask_out} if emit else {}
    if row:
        return state, emits, row_buf
    stats = {k: stats_buf[v] for k, v in stat_layout(program,
                                                     num_groups).items()}
    return state, emits, stats


fleet_step_cuda.launches = 0


def _row_on_card(row: torch.Tensor, width: int, what: str) -> None:
    if (row.device.type != "cuda" or row.dtype != torch.float64
            or row.shape != (width,) or not row.is_contiguous()):
        raise ValueError(f"{what}: row must be a contiguous ({width},) "
                         f"float64 CUDA tensor, got {tuple(row.shape)} "
                         f"{row.dtype} on {row.device}")


def fleet_finalize_cuda(program: step_ops.StepProgram, row: torch.Tensor,
                        num_groups: int | None = None) -> dict:
    """The stats of a sharded round from the ranks' all-reduced row
    (``fleet_step_cuda(..., row=True)``'s layout), by one launch of
    ``fleet_step_finalize``: the host-local reduce's own averaging."""
    _, hist = program_variant(program, num_groups)
    G = num_groups or 0
    F, H = 8 + 3 * G, NBINS if hist else 0
    _row_on_card(row, F + H, "fleet_finalize_cuda")
    device = row.device
    sums = torch.empty(F + H, dtype=torch.float32, device=device)
    stats_buf = torch.empty(7 + 2 * G + H, dtype=torch.float32,
                            device=device)
    lib = _kernel()
    err = lib.fleet_step_finalize(row.data_ptr(), sums.data_ptr(),
                                  stats_buf.data_ptr(), int(hist), G,
                                  torch.cuda.current_stream(device)
                                  .cuda_stream)
    if err != 0:
        msg = lib.fleet_step_error_string(err).decode()
        raise RuntimeError(f"fleet_step_finalize launch failed ({err}: "
                           f"{msg})")
    fleet_finalize_cuda.launches += 1
    return {k: stats_buf[v] for k, v in stat_layout(program,
                                                    num_groups).items()}


fleet_finalize_cuda.launches = 0


@functools.cache
def _serve_signatures() -> dict:
    """{program signature: (admission, train, hist)} of every serve program
    csrc/serve_step.cu runs."""
    from repro_torch.energy.costs import DecodeCostModel
    from repro_torch.serve import admission
    from repro_torch.serve.fleet_serve import TrainLoad
    from repro_torch.serve.qos import QoSSpec

    policies = (admission.EnergyAgnostic(), admission.BatteryGated.create(1),
                admission.ChargeGated.create(1))
    trains = [None] + [TrainLoad.create([1], 1.0, policy=p) for p in
                       (Policy.SUSTAINABLE, Policy.THRESHOLD, Policy.GREEDY,
                        Policy.ALWAYS)]
    table = {}
    for pol in policies:
        for train in trains:
            for hist in (False, True):
                program, _ = step_ops.serve_step_program(
                    battery_lib.BatteryConfig(), DecodeCostModel(1.0, 1.0),
                    QoSSpec(), pol, train, hist=hist)
                p = dict(program.params)
                table[program.signature()] = (ADMISSIONS[p["admission"]],
                                              TRAINS[p["train"]], hist)
    return table


def serve_program_variant(program: step_ops.StepProgram
                          ) -> tuple[int, int, bool]:
    """(admission, train, hist) of the csrc/serve_step.cu instantiation
    that runs ``program``; raises if ``program`` is not a serve program the
    kernel implements."""
    found = _serve_signatures().get(program.signature())
    if found is None:
        raise ValueError(f"serve_step kernel: program {program.name!r} (ops "
                         f"{[op.name for op in program.ops]}, params "
                         f"{program.params}) is not one that "
                         f"energy.step_ops.serve_step_program builds for an "
                         f"admission rule of serve.admission; the kernel "
                         f"runs only those")
    return found


@functools.cache
def _serve_kernel():
    lib = build.load("serve_step")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.serve_step.argtypes = ([ptr, ctypes.c_uint] + [ptr] * 8
                               + [ctypes.c_longlong] + [i] * 6 + [ptr])
    lib.serve_step.restype = i
    lib.serve_step_finalize.argtypes = [ptr] * 3 + [i] + [ptr]
    lib.serve_step_finalize.restype = i
    lib.serve_step_fold_only.argtypes = [ptr] * 4 + [i] * 2 + [ptr]
    lib.serve_step_fold_only.restype = i
    lib.serve_step_occupancy.argtypes = [i] * 3
    lib.serve_step_occupancy.restype = i
    lib.serve_step_blocks_per_sm.argtypes = []
    lib.serve_step_blocks_per_sm.restype = i
    lib.serve_step_error_string.argtypes = [i]
    lib.serve_step_error_string.restype = ctypes.c_char_p
    return lib


def serve_grid(n: int, sms: int = H100_SMS) -> int:
    """Blocks of csrc/serve_step.cu's persistent grid for ``n`` clients on
    a card with ``sms`` SMs: as many as are resident, at most one a
    tile."""
    return min(-(-n // SERVE_TILE), sms * SERVE_BLOCKS_PER_SM)


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _serve_scratch(device, stream: int):
    """(partials, counts) for serve_step calls on one stream: partials
    (16, the largest grid) float32, and counts (1 + NBINS) int32 zeroed
    once, which every call leaves at 0 (the last block's ticket and the
    global bin counts)."""
    rows = _sm_count(device) * SERVE_BLOCKS_PER_SM
    return (torch.empty(16 * rows, dtype=torch.float32, device=device),
            torch.zeros(1 + NBINS, dtype=torch.int32, device=device))


def serve_step_cuda(program: step_ops.StepProgram, env: dict, *, n: int,
                    emit: bool = False, row: bool = False):
    """Launch the serve program's Hopper kernel for one epoch over ``n``
    clients; returns (state, emits, stats) as new tensors on the card, or
    with ``row`` (a rank's slab of a sharded fleet) (state, emits, row):
    its (16 + H,) float64 row of sums for ``serve_finalize_cuda``.
    Raises on a program the kernel does not run, on inputs it does not take
    and on a launch error.  Per-client inputs that all start on a 16-byte
    boundary are copied 16 bytes at a time, others (views at an offset) 4
    bytes at a time: the results are the same."""
    adm, train, hist = serve_program_variant(program)
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"serve_step_cuda: n={n} must be in [1, 2^31)")
    charge = env["charge"]
    device = charge.device
    if device.type != "cuda":
        raise ValueError(f"serve_step_cuda: charge is on {device}; the kernel "
                         f"takes CUDA tensors")
    f32 = torch.float32
    reads = set(program.input_names()) | {"valid"}
    ptrs, per_client, keep = [], 0, []
    for j, nm in enumerate(SERVE_INPUTS):
        if nm in reads:
            t, s = _operand(env, nm, n, f32, device)
            keep.append(t)
            ptrs.append(t.data_ptr())
            per_client |= s << j
        else:                       # not read by this instantiation
            ptrs.append(charge.data_ptr())
    in_arr = (ctypes.c_void_p * len(ptrs))(*ptrs)

    H = NBINS if hist else 0
    charge_out = torch.empty(n, dtype=f32, device=device)
    streak_out = torch.empty(n if hist else 1, dtype=f32, device=device)
    mode_out = torch.empty(n if emit else 1, dtype=torch.int32,
                           device=device)
    vec = all(p % 16 == 0 for j, p in enumerate(ptrs) if per_client >> j & 1)
    sums = torch.empty(16 + H, dtype=f32, device=device)
    stats_buf = torch.empty(15 + H, dtype=f32, device=device)
    row_buf = (torch.empty(16 + H, dtype=torch.float64, device=device)
               if row else None)
    stream = torch.cuda.current_stream(device).cuda_stream
    partials, counts = _serve_scratch(device, stream)
    grid = serve_grid(n, _sm_count(device))
    lib = _serve_kernel()
    err = lib.serve_step(in_arr, per_client, charge_out.data_ptr(),
                         streak_out.data_ptr(), mode_out.data_ptr(),
                         partials.data_ptr(), counts.data_ptr(),
                         sums.data_ptr(), stats_buf.data_ptr(),
                         row_buf.data_ptr() if row else None, n, grid,
                         int(vec), adm, train, int(hist), int(emit), stream)
    if err != 0:
        msg = lib.serve_step_error_string(err).decode()
        raise RuntimeError(f"serve_step kernel launch failed ({err}: {msg}) "
                           f"for n={n}, admission={adm}, train={train}, "
                           f"hist={hist}")
    serve_step_cuda.launches += 1
    state = {"charge_out": charge_out}
    if hist:
        state["streak_out"] = streak_out
    emits = {"mode": mode_out} if emit else {}
    if row:
        return state, emits, row_buf
    stats = {k: stats_buf[v] for k, v in stat_layout(program, None).items()}
    return state, emits, stats


serve_step_cuda.launches = 0


def serve_finalize_cuda(program: step_ops.StepProgram, row: torch.Tensor
                        ) -> dict:
    """The stats of a sharded epoch from the ranks' all-reduced row
    (``serve_step_cuda(..., row=True)``'s layout), by one launch of
    ``serve_step_finalize``: the fold's own averaging."""
    _, _, hist = serve_program_variant(program)
    H = NBINS if hist else 0
    _row_on_card(row, 16 + H, "serve_finalize_cuda")
    device = row.device
    sums = torch.empty(16 + H, dtype=torch.float32, device=device)
    stats_buf = torch.empty(15 + H, dtype=torch.float32, device=device)
    lib = _serve_kernel()
    err = lib.serve_step_finalize(row.data_ptr(), sums.data_ptr(),
                                  stats_buf.data_ptr(), int(hist),
                                  torch.cuda.current_stream(device)
                                  .cuda_stream)
    if err != 0:
        msg = lib.serve_step_error_string(err).decode()
        raise RuntimeError(f"serve_step_finalize launch failed ({err}: "
                           f"{msg})")
    serve_finalize_cuda.launches += 1
    return {k: stats_buf[v] for k, v in stat_layout(program, None).items()}


serve_finalize_cuda.launches = 0


def fused_step_sharded(program: step_ops.StepProgram, env: dict, *, n: int,
                       mesh, emit: bool = False,
                       num_groups: int | None = None):
    """One round (or epoch) of a fleet sharded over the ranks of ``mesh``
    (a ``DeviceMesh``; `dist.sharding`): ``n`` is the padded width of the
    whole fleet, ``env`` holds this rank's slab of ``n / ranks`` clients.
    Each rank runs the kernel on its slab and writes its row of sums; the
    row is all-reduced once over the data group and finalized into the
    stats, replicated on every rank.  On the CPU the plain version runs
    to the same row.  Returns (state, emits, stats) as the host-local
    forms do, state and emits for the slab.  Raises where ``n`` does not
    divide the data-axis product or the mesh's device type is not the
    slab's; a failing launch or collective fails the round."""
    # imported here: dist.sharding imports the energy package, which
    # imports this module
    from repro_torch.dist import sharding

    group = sharding.data_group(mesh)
    world = sharding.mesh_axis_size(mesh, sharding.data_axes(mesh))
    if n % world:
        raise ValueError(f"fused_step_sharded: n={n} must divide the "
                         f"mesh's data-axis product {world}")
    n_local = n // world
    device = env["charge"].device
    sharding.check_device(mesh, device)
    if device.type == "cpu":
        return fleet_step_plain(program, env, n=n_local, emit=emit,
                                num_groups=num_groups, group=group)
    if device.type != "cuda":
        raise ValueError(f"fused_step_sharded: no kernel for device "
                         f"{device}")
    state, emits, row = fleet_step_cuda(program, env, n=n_local, emit=emit,
                                        num_groups=num_groups, row=True)
    collectives.all_reduce_row(row, group)
    if program.name == "serve_step":
        stats = serve_finalize_cuda(program, row)
    else:
        stats = fleet_finalize_cuda(program, row, num_groups)
    return state, emits, stats


def kernel_bytes(program: step_ops.StepProgram, env: dict, n: int, *,
                 emit: bool = False) -> int:
    """The bytes a kernel of ``program`` must move for one call:
    ``step_ops.bytes_moved``'s fused count, less the training load's
    cycles ``train_E``, which the serve program's training gate lists
    among its reads (as the reference's does) but no op computes with."""
    if "train_E" in env:
        env = dict(env, train_E=torch.zeros(()))
    return step_ops.bytes_moved(program, env, n, emit=emit)["fused_bytes"]


def reduction_depth(n: int, world: int = 1) -> int:
    """The most float32 additions on any client's path to a stat in
    ``csrc/fleet_step.cu`` for a fleet of ``n`` clients over ``world``
    ranks (a slab of ceil(n / world) a rank): CPT per thread, 5 in the warp
    tree, WARPS - 1 over the warps, then ceil(blocks / 32) down a lane of
    the second pass and 5 in its warp tree; then at most world - 1 more
    over the ranks' rows (summed in float64 and rounded once: one level
    where world > 1)."""
    n_local = -(-n // world)
    blocks = -(-n_local // TILE)
    return (CPT + 5 + (WARPS - 1) + -(-blocks // REDUCE_LANES) + 5
            + world - 1)


def serve_reduction_depth(n: int, sms: int = H100_SMS, world: int = 1
                          ) -> int:
    """The most float32 additions on any client's path to a stat in
    ``csrc/serve_step.cu`` on a card with ``sms`` SMs, for a fleet of
    ``n`` clients over ``world`` ranks: SERVE_CPT a tile over each tile a
    block of the rank's slab walks, 5 in the warp tree, SERVE_THREADS / 32
    - 1 over the warps, then ceil(grid / 32) down a lane of the fold and 5
    in its warp tree; then at most world - 1 more over the ranks' rows."""
    n_local = -(-n // world)
    grid = serve_grid(n_local, sms)
    tiles = -(-n_local // SERVE_TILE)
    steps = -(-tiles // grid)
    return (SERVE_CPT * steps + 5 + (SERVE_THREADS // 32 - 1)
            + -(-grid // REDUCE_LANES) + 5 + world - 1)


def stats_float64(program: step_ops.StepProgram, env: dict, valid,
                  groups=None, num_groups: int | None = None) -> dict:
    """The stats in float64 from the per-client buffers of a round (the
    final env of ``step_ops.run_step``): what the kernel's float32 sums
    are held against."""
    v = valid.double()
    tot = lambda buf, w: (w * env[buf].double()).sum(dim=-1)
    out = {s: tot(b, v) for s, b in program.totals}
    den = v.sum()
    out.update({s: tot(b, v) / torch.clamp_min(den, 1.0)
                for s, b in program.averages})
    if num_groups:
        gw = step_ops.group_weights(valid, groups, num_groups).double()
        out.update({s: tot(b, gw) for s, b in program.group_totals})
        gden = torch.clamp_min(gw.sum(dim=1), 1.0)
        out.update({s: tot(b, gw) / gden for s, b in program.group_averages})
    for spec in program.hists:
        out[spec.name] = hist_lib.masked_bincount(env[spec.buf], valid,
                                                  spec).double()
    return out


def kernel_tolerance(program: step_ops.StepProgram, env: dict, valid, n: int,
                     groups=None, num_groups: int | None = None,
                     world: int = 1) -> dict:
    """Per-stat bound on |kernel - exact| for one round over ``n`` clients
    on ``world`` ranks (``fused_step_sharded``), given the final env of
    ``step_ops.run_step`` on the whole fleet's inputs.

    A float32 sum whose terms each pass through at most d roundings (the
    product valid * x and ``reduction_depth(n)`` additions, or
    ``serve_reduction_depth(n)`` for a serve program) is within
    gamma_d sum |valid x| of the exact sum, gamma_d = d u / (1 - d u),
    u = 2^-24, in any order; ``world`` ranks add world - 1 levels.  An
    average num / max(den, 1) adds the error of den (exact for 0/1
    weights) and one rounding of the division.  Histogram counts are exact: their bound is 0."""
    if program.name == "serve_step":
        sms = _sm_count(valid.device) if valid.is_cuda else H100_SMS
        d = serve_reduction_depth(n, sms, world) + 1
    else:
        d = reduction_depth(n, world) + 1
    gam = d * U32 / (1 - d * U32)
    v = valid.double().abs()
    absum = lambda buf, w: (w * env[buf].double().abs()).sum(dim=-1)
    out = {s: gam * absum(b, v) for s, b in program.totals}

    def avg_tol(num, num_tol, den, den_tol):
        a = (num / torch.clamp_min(den, 1.0)).abs()
        return ((num_tol + a * den_tol)
                / torch.clamp_min(den - den_tol, 1.0) + 2 * U32 * a)

    den, den_tol = valid.double().sum(), gam * v.sum()
    for s, b in program.averages:
        num = (valid.double() * env[b].double()).sum()
        out[s] = avg_tol(num, gam * absum(b, v), den, den_tol)
    if num_groups:
        gw = step_ops.group_weights(valid, groups, num_groups).double()
        for s, b in program.group_totals:
            out[s] = gam * absum(b, gw.abs())
        gden, gden_tol = gw.sum(dim=1), gam * gw.abs().sum(dim=1)
        for s, b in program.group_averages:
            num = (gw * env[b].double()).sum(dim=1)
            out[s] = avg_tol(num, gam * absum(b, gw.abs()), gden, gden_tol)
    for spec in program.hists:
        out[spec.name] = torch.zeros(spec.bins, dtype=torch.float64,
                                     device=valid.device)
    return out


def stats_error(got: dict, exact: dict, tol: dict) -> dict:
    """{stat: largest |got - exact| / bound}: at most 1 where the bound
    holds, inf where a bound of 0 (a histogram count) is broken."""
    out = {}
    for k, bound in tol.items():
        err = (got[k].double().cpu() - exact[k].cpu()).abs()
        ratio = torch.where(err == 0, torch.zeros_like(err),
                            err / bound.cpu())
        out[k] = ratio.max().item()
    return out
