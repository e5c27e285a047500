"""The fleet round step as a small op IR (port of the JAX package's
``energy/step_ops.py``, fleet program).

The physics pipeline — leak → absorb/clip → gate → drain → telemetry — is
a sequence of per-client step ops (`StepOp`: reads/writes over a named
buffer environment) plus a declarative telemetry spec (`StepProgram`'s
totals, averages, group stats and histograms).  Two executors run it:

* `run_step` — the ops as plain PyTorch on (N,) tensors, reduced through
  `dist.collectives` into one row of pre-average sums (`stat_row`) and then
  averaged (`row_stats`): the twin of the reference's ``run_step_lax``, and
  the plain version of the ``fleet_step`` kernel (`kernels.fleet_step`),
  which the CPU takes.  With ``group=`` (a rank's slab of a sharded fleet)
  the row is all-reduced over the ranks before the averages.
* the ``fleet_step`` CUDA kernel, which runs the fleet program (checked
  op by op against what `fleet_step_program` builds) in one pass over the
  clients.

Everything that draws random numbers (the harvest, the SUSTAINABLE slot
draw) stays outside the program and enters as a per-round buffer
(``harvest``, ``want``).  Battery fields are bound by field name
(``bat_capacity``, ``bat_leak``, ``bat_init_charge``) as 0-dim or (N,)
float32 tensors; the serving program binds its cost, QoS, admission and
training-load leaves the same way (``cost_joules_per_decode_step``,
``qos_prompt_tokens``, ``pol_hi``, ``train_round_cost``, ...).  The
unfused baseline (``UnfusedRunner``) is a benchmark yardstick that no
simulator runs; it is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.scheduling import Policy
from repro_torch.dist import collectives
from repro_torch.energy import battery as battery_lib
from repro_torch.obs import hist as hist_lib


@dataclasses.dataclass(frozen=True)
class StepOp:
    """One per-client op: ``fn(env) -> tuple`` of ``writes`` values.
    ``reads`` declares every buffer ``fn`` touches."""

    name: str
    reads: tuple[str, ...]
    writes: tuple[str, ...]
    fn: Callable[[dict], tuple]


@dataclasses.dataclass(frozen=True)
class StepProgram:
    """A round step: ops in dataflow order plus the telemetry/output spec.

    ``state_out`` are the per-client buffers carried to the next round,
    ``emit`` the optionally recorded per-client outputs.  ``totals`` /
    ``averages`` are ``(stat, buffer)`` pairs reduced with
    `collectives.masked_total` / `masked_average` over the ``valid``
    weight; ``group_totals`` / ``group_averages`` with group-indicator
    weights ``valid * (groups == g)``.  ``hists`` are fixed-bin histograms
    of exact counts."""

    name: str
    ops: tuple[StepOp, ...]
    state_out: tuple[str, ...]
    emit: tuple[str, ...]
    totals: tuple[tuple[str, str], ...]
    averages: tuple[tuple[str, str], ...] = ()
    group_totals: tuple[tuple[str, str], ...] = ()
    group_averages: tuple[tuple[str, str], ...] = ()
    hists: tuple[hist_lib.HistSpec, ...] = ()
    # the choices inside op closures that the reads do not show (the serve
    # program's admission rule and training gate), as (name, value) pairs
    params: tuple[tuple[str, str], ...] = ()

    def input_names(self) -> tuple[str, ...]:
        """Buffers the program consumes but never writes, in first-use
        order: op reads first, then stat buffers."""
        written: set[str] = set()
        needed: list[str] = []
        for op in self.ops:
            for nm in op.reads:
                if nm not in written and nm not in needed:
                    needed.append(nm)
            written.update(op.writes)
        for _, buf in self.totals + self.averages \
                + self.group_totals + self.group_averages:
            if buf not in written and buf not in needed:
                needed.append(buf)
        for spec in self.hists:
            if spec.buf not in written and spec.buf not in needed:
                needed.append(spec.buf)
        return tuple(needed)

    def signature(self) -> tuple:
        """Everything but the op closures: what a hand-written kernel of
        this program must match."""
        return (self.name, tuple((op.name, op.reads, op.writes)
                                 for op in self.ops),
                self.state_out, self.emit, self.totals, self.averages,
                self.group_totals, self.group_averages, self.hists,
                self.params)


def apply_ops(ops: tuple[StepOp, ...], env: dict) -> dict:
    """Run the ops in order over a copy of ``env``; returns the final env
    (inputs + every written buffer)."""
    env = dict(env)
    for op in ops:
        env.update(zip(op.writes, op.fn(env)))
    return env


BAT_NAMES = tuple(f"bat_{f}" for f in battery_lib.BatteryConfig.FIELDS)


def _bind_battery(bat: battery_lib.BatteryConfig, env: dict, device=None
                  ) -> tuple[str, ...]:
    """Put the battery's fields into ``env`` by field name."""
    env.update({f"bat_{k}": v for k, v in bat.fields(device).items()})
    return BAT_NAMES


def _hist_ops(spend_buf: str) -> list[StepOp]:
    """The distributional-telemetry ops: state of charge, this round's
    spend as a fraction of capacity, and the carried consecutive-depleted
    streak ``(streak + 1) * depleted``."""
    def soc_fn(e):
        return (e["charge_out"] / torch.clamp_min(e["bat_capacity"], 1e-20),)

    def spend_fn(e):
        return (e[spend_buf] / torch.clamp_min(e["bat_capacity"], 1e-20),)

    def streak_fn(e):
        return ((e["streak"] + 1.0) * e["depleted"],)

    return [
        StepOp("soc", ("charge_out",) + BAT_NAMES, ("soc",), soc_fn),
        StepOp("spend_frac", (spend_buf,) + BAT_NAMES, ("spend_frac",),
               spend_fn),
        StepOp("streak", ("streak", "depleted"), ("streak_out",), streak_fn),
    ]


def fleet_step_program(bat: battery_lib.BatteryConfig, policy: Policy | str,
                       num_groups: int | None = None, hist: bool = False,
                       device=None) -> tuple[StepProgram, dict]:
    """The training fleet's round step for one policy.

    Returns ``(program, env)`` with the battery fields bound in ``env`` (on
    ``device``); the caller adds ``round_cost`` / ``threshold`` and the
    per-round ``charge`` / ``harvest`` (+ ``want`` for SUSTAINABLE, + the
    carried ``streak`` with ``hist=True``)."""
    pol = Policy(policy)
    env: dict = {}
    bat_names = _bind_battery(bat, env, device)
    ops = []

    def absorb_fn(e):
        available, aux = battery_lib.absorb_fields(
            e["bat_capacity"], e["bat_leak"], e["charge"], e["harvest"])
        return available, aux["leaked"], aux["overflow"]

    ops.append(StepOp("absorb", ("charge", "harvest") + bat_names,
                      ("available", "leaked", "overflow"), absorb_fn))

    # every policy is AND-ed with physical feasibility available >= cost
    if pol == Policy.SUSTAINABLE:
        def gate_fn(e):
            feasible = e["available"] >= e["round_cost"]
            return (e["want"] * feasible.float(),)

        gate_reads = ("want", "available", "round_cost")
    elif pol == Policy.THRESHOLD:
        def gate_fn(e):
            feasible = e["available"] >= e["round_cost"]
            want = (e["available"] >= e["threshold"] * e["round_cost"]).float()
            return (want * feasible.float(),)

        gate_reads = ("available", "round_cost", "threshold")
    elif pol in (Policy.GREEDY, Policy.ALWAYS):
        def gate_fn(e):
            feasible = e["available"] >= e["round_cost"]
            return (torch.ones_like(e["available"]) * feasible.float(),)

        gate_reads = ("available", "round_cost")
    else:
        raise ValueError(
            f"policy {pol.value!r} has no battery-gated fleet variant "
            f"(supported: {['sustainable', 'greedy', 'threshold', 'always']})")
    ops.append(StepOp("fleet_gate", gate_reads, ("mask",), gate_fn))

    def drain_fn(e):
        consumed = e["mask"] * e["round_cost"]
        return battery_lib.drain(e["available"], consumed), consumed

    ops.append(StepOp("train_drain", ("mask", "round_cost", "available"),
                      ("charge_out", "consumed"), drain_fn))

    def depleted_fn(e):
        return ((e["available"] < e["round_cost"]).float(),)

    ops.append(StepOp("depleted", ("available", "round_cost"),
                      ("depleted",), depleted_fn))

    if hist:
        ops += _hist_ops("consumed")
    grouped = num_groups is not None
    program = StepProgram(
        name="fleet_step", ops=tuple(ops),
        state_out=("charge_out", "streak_out") if hist else ("charge_out",),
        emit=("mask",),
        totals=(("participants", "mask"), ("harvested", "harvest"),
                ("consumed", "consumed"), ("leaked", "leaked"),
                ("overflowed", "overflow")),
        averages=(("mean_charge", "charge_out"),
                  ("frac_depleted", "depleted")),
        group_totals=(("group_participants", "mask"),) if grouped else (),
        group_averages=(("group_frac_depleted", "depleted"),) if grouped
        else (),
        hists=hist_lib.FLEET_HIST_SPECS if hist else ())
    return program, env


# admission modes; mirrors `serve.qos` (not imported: the energy package
# must not pull in the serve package when it loads)
_SHED, _DEGRADED, _FULL = 0, 1, 2
COST_FIELDS = ("joules_per_prefill_token", "joules_per_decode_step",
               "joules_per_response_upload")
TRAIN_FIELDS = ("E", "round_cost", "threshold")


def _bind(prefix: str, obj, fields: tuple[str, ...], env: dict, device=None
          ) -> tuple[str, ...]:
    """Put ``obj``'s fields into ``env`` as ``{prefix}_{field}`` tensors
    (float32 unless already a tensor of another type, as ``TrainLoad.E``)
    and return the names."""
    names = tuple(f"{prefix}_{f}" for f in fields)
    for nm, f in zip(names, fields):
        v = getattr(obj, f)
        if not (isinstance(v, torch.Tensor) and not v.is_floating_point()):
            v = torch.as_tensor(v, dtype=torch.float32)
        env[nm] = v.to(device) if device is not None else v
    return names


def request_costs(e: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """(full, short) joules per request from the bound QoS and cost leaves:
    ``prompt * jpp + tokens * jpd + upload`` with the decode term fused,
    ``fma(tokens, jpd, prompt * jpp) + upload``, as the reference's jitted
    serving scan computes it where it prices both grades in one pass (the
    product ``prompt * jpp`` is then shared and stays rounded)."""
    pre = e["qos_prompt_tokens"] * e["cost_joules_per_prefill_token"]
    jpd = e["cost_joules_per_decode_step"]
    up = e["cost_joules_per_response_upload"]
    full = battery_lib.fma_f32(e["qos_full_decode_tokens"], jpd, pre) + up
    short = battery_lib.fma_f32(e["qos_short_decode_tokens"], jpd, pre) + up
    return full, short


def serve_step_program(bat: battery_lib.BatteryConfig, cost, qos, policy,
                       train, hist: bool = False, device=None
                       ) -> tuple[StepProgram, dict]:
    """The serving epoch's step: absorb -> price -> admission -> serve-drain
    -> ledger -> training gate and drain -> token and total accounting.

    Returns ``(program, env)`` with the battery, cost, QoS, admission policy
    and `TrainLoad` fields bound; the caller adds the ``admit`` scale and
    the epoch's ``charge`` / ``harvest`` / ``requests`` (+ ``twant`` for a
    SUSTAINABLE training load, + the carried ``streak`` with
    ``hist=True``).  ``program.params`` names the admission rule
    (``agnostic``, ``battery_gated``, ``charge_gated``, or the policy's
    class name for any other) and the training gate.

    Rounding follows the reference's jitted scan where XLA's CPU backend
    contracts a product into an add: the absorb (as the fleet program) and
    ``available - served * per_req``; the prices see `request_costs`.
    ``consumed_serve + consumed_train`` is not contracted there, nor here.
    """
    env: dict = {}
    bat_names = _bind_battery(bat, env, device)
    cost_names = _bind("cost", cost, COST_FIELDS, env, device)
    qos_names = _bind("qos", qos, type(qos).FIELDS, env, device)
    pol_cls = type(policy)
    pol_fields = tuple(getattr(pol_cls, "FIELDS", ()))
    pol_names = _bind("pol", policy, pol_fields, env, device)
    # a subclass (which may decide otherwise) is named by its own class
    admission = pol_cls.__dict__.get("KIND", pol_cls.__name__)
    ops = []

    def absorb_fn(e):
        available, aux = battery_lib.absorb_fields(
            e["bat_capacity"], e["bat_leak"], e["charge"], e["harvest"])
        return available, aux["leaked"], aux["overflow"]

    ops.append(StepOp("absorb", ("charge", "harvest") + bat_names,
                      ("available", "leaked", "overflow"), absorb_fn))

    def price_fn(e):
        shape = e["requests"].shape
        full, short = request_costs(e)
        return full.expand(shape), short.expand(shape)

    ops.append(StepOp("price", ("requests",) + qos_names + cost_names,
                      ("full_req", "short_req"), price_fn))

    def admit_fn(e):
        pol = pol_cls(**{f: e[nm] for f, nm in zip(pol_fields, pol_names)})
        mode = pol.scaled(e["admit"]).decide(
            e["available"], e["requests"] * e["full_req"],
            e["requests"] * e["short_req"])
        return (mode,)

    ops.append(StepOp("admission",
                      ("available", "requests", "full_req", "short_req",
                       "admit") + pol_names, ("mode",), admit_fn))

    def serve_drain_fn(e):
        per_req = torch.where(e["mode"] == _FULL, e["full_req"],
                              e["short_req"])
        admitted = torch.where(e["mode"] > _SHED, e["requests"], 0.0)
        affordable = torch.floor(e["available"]
                                 / torch.clamp_min(per_req, 1e-20))
        served = torch.minimum(admitted, affordable)
        consumed_serve = served * per_req
        charge_serve = battery_lib.fma_f32(-served, per_req, e["available"])
        return per_req, admitted, served, consumed_serve, charge_serve

    ops.append(StepOp("serve_drain",
                      ("mode", "requests", "available", "full_req",
                       "short_req"),
                      ("per_req", "admitted", "served", "consumed_serve",
                       "charge_serve"), serve_drain_fn))

    def ledger_fn(e):
        served_full = torch.where(e["mode"] == _FULL, e["served"], 0.0)
        served_short = torch.where(e["mode"] == _DEGRADED, e["served"], 0.0)
        shed = torch.where(e["mode"] == _SHED, e["requests"], 0.0)
        missed = e["admitted"] - e["served"]
        depleted = (e["available"] < e["short_req"]).float()
        return served_full, served_short, shed, missed, depleted

    ops.append(StepOp("ledger",
                      ("mode", "requests", "admitted", "served", "available",
                       "short_req"),
                      ("served_full", "served_short", "shed", "missed",
                       "depleted"), ledger_fn))

    if train is not None:
        train_names = _bind("train", train, TRAIN_FIELDS, env, device)
        tpol = Policy(train.policy)
        if tpol not in (Policy.SUSTAINABLE, Policy.THRESHOLD, Policy.GREEDY,
                        Policy.ALWAYS):
            raise ValueError(f"training policy {tpol.value!r} has no "
                             f"battery-gated variant")
        twant_reads = ("twant",) if tpol == Policy.SUSTAINABLE else ()

        def train_fn(e):
            rc = e["train_round_cost"]
            feasible = e["charge_serve"] >= rc
            if tpol == Policy.SUSTAINABLE:
                want = e["twant"]
            elif tpol == Policy.THRESHOLD:
                want = (e["charge_serve"] >= e["train_threshold"] * rc).float()
            else:  # GREEDY / ALWAYS
                want = torch.ones_like(e["charge_serve"])
            tmask = want * feasible.float()
            consumed_train = tmask * rc
            charge_out = battery_lib.drain(e["charge_serve"], consumed_train)
            return tmask, consumed_train, charge_out

        ops.append(StepOp("train_gate",
                          ("charge_serve",) + twant_reads + train_names,
                          ("tmask", "consumed_train", "charge_out"),
                          train_fn))
        gate = ("greedy" if tpol == Policy.ALWAYS else tpol.value)
    else:
        def train_fn(e):
            zero = torch.zeros_like(e["charge_serve"])
            return zero, zero, e["charge_serve"]

        ops.append(StepOp("train_gate", ("charge_serve",),
                          ("tmask", "consumed_train", "charge_out"),
                          train_fn))
        gate = "none"

    def tokens_fn(e):
        return (e["served_full"] * e["qos_full_decode_tokens"]
                + e["served_short"] * e["qos_short_decode_tokens"],)

    ops.append(StepOp("tokens", ("served_full", "served_short") + qos_names,
                      ("tokens",), tokens_fn))

    def total_fn(e):
        return (e["consumed_serve"] + e["consumed_train"],)

    ops.append(StepOp("consumed_total", ("consumed_serve", "consumed_train"),
                      ("consumed_total",), total_fn))

    if hist:
        ops += _hist_ops("consumed_total")
    program = StepProgram(
        name="serve_step", ops=tuple(ops),
        state_out=("charge_out", "streak_out") if hist else ("charge_out",),
        emit=("mode",),
        totals=(("participants", "tmask"), ("harvested", "harvest"),
                ("consumed", "consumed_total"), ("leaked", "leaked"),
                ("overflowed", "overflow"), ("offered", "requests"),
                ("served_full", "served_full"),
                ("served_short", "served_short"), ("shed", "shed"),
                ("deadline_missed", "missed"), ("tokens_decoded", "tokens"),
                ("consumed_serve", "consumed_serve"),
                ("consumed_train", "consumed_train")),
        averages=(("mean_charge", "charge_out"),
                  ("frac_depleted", "depleted")),
        hists=hist_lib.SERVE_HIST_SPECS if hist else (),
        params=(("admission", admission), ("train", gate)))
    return program, env


def group_weights(valid: torch.Tensor, groups: torch.Tensor,
                  num_groups: int) -> torch.Tensor:
    """(G, N) weights ``valid * (groups == g)``."""
    g = torch.arange(num_groups, dtype=torch.int32, device=groups.device)
    return valid[None] * (groups[None] == g[:, None]).float()


def _group_count(program: StepProgram, grouped: bool,
                 num_groups: int | None) -> int:
    """G when the round reduces group stats, else 0."""
    has = bool(program.group_totals or program.group_averages)
    return int(num_groups) if grouped and has and num_groups else 0


def stat_row(program: StepProgram, env: dict, valid, groups=None,
             num_groups: int | None = None) -> torch.Tensor:
    """The round's pre-average sums as one (F + H,) float64 row, in the
    kernels' layout: the totals, the average numerators and the sum of
    ``valid``; per group g the group totals, the group average numerators
    and the group's sum of weights; then the bin counts.  Each float32 sum
    and each integer count is held exactly, so the rows of the ranks of a
    sharded fleet add without a rounding of the counts below 2^53."""
    cols = [collectives.masked_total(env[buf], valid)
            for _, buf in program.totals + program.averages]
    ones = torch.ones_like(env[program.averages[0][1]] if program.averages
                           else valid, dtype=torch.float32)
    cols.append(collectives.masked_total(ones, valid))
    out = [torch.stack(cols).double()]
    if _group_count(program, groups is not None, num_groups):
        gw = group_weights(valid, groups, num_groups)
        per = [torch.sum(gw * env[buf].float()[None], dim=1)
               for _, buf in program.group_totals + program.group_averages]
        per.append(gw.sum(dim=1))
        out.append(torch.stack(per, dim=1).reshape(-1).double())
    for spec in program.hists:
        out.append(hist_lib.masked_bincount(env[spec.buf], valid, spec,
                                            dtype=torch.float64))
    return torch.cat(out)


def row_stats(program: StepProgram, row: torch.Tensor,
              num_groups: int | None = None) -> dict:
    """The stats from a `stat_row` (or the sum of the ranks' rows; pass
    ``num_groups`` when it holds group columns): each sum rounded to
    float32 once, then ``num / max(den, 1)`` for the averages.  Stats are
    0-dim tensors, (G,) per group, (bins,) per histogram."""
    f = row.float()
    nt, na = len(program.totals), len(program.averages)
    stats = {stat: f[i] for i, (stat, _) in enumerate(program.totals)}
    den = torch.clamp_min(f[nt + na], 1.0)
    stats.update({stat: f[nt + i] / den
                  for i, (stat, _) in enumerate(program.averages)})
    off = nt + na + 1
    G = _group_count(program, True, num_groups)
    if G:
        gt, ga = len(program.group_totals), len(program.group_averages)
        per = f[off:off + G * (gt + ga + 1)].reshape(G, gt + ga + 1)
        stats.update({stat: per[:, i]
                      for i, (stat, _) in enumerate(program.group_totals)})
        gden = torch.clamp_min(per[:, gt + ga], 1.0)
        stats.update({stat: per[:, gt + i] / gden
                      for i, (stat, _) in enumerate(program.group_averages)})
        off += G * (gt + ga + 1)
    for spec in program.hists:
        stats[spec.name] = f[off:off + spec.bins]
        off += spec.bins
    return stats


def run_step(program: StepProgram, env: dict, *, valid, groups=None,
             num_groups: int | None = None, group=None) -> tuple[dict, dict]:
    """Plain executor: the ops as PyTorch on (N,) tensors, their sums in one
    `stat_row` and the stats from it (`row_stats`).  With ``group`` (the
    ``torch.distributed`` process group of a sharded fleet's ranks, each
    holding its slab of clients in ``env``) the row is all-reduced once
    before the averages.  Returns ``(final env, stats)``; stats are 0-dim
    tensors, (G,) per group, (bins,) per histogram."""
    env = apply_ops(program.ops, env)
    row = stat_row(program, env, valid, groups, num_groups)
    if group is not None:
        collectives.all_reduce_row(row, group)
    return env, row_stats(program, row, num_groups if groups is not None
                          else None)


def bytes_moved(program: StepProgram, env: dict, n: int, *,
                emit: bool = False, itemsize: int = 4) -> dict:
    """Model of per-round device-memory traffic, as the reference counts it.

    Unfused: each op reads its per-client operands and writes its
    per-client outputs; each masked total re-reads (value, valid) and each
    masked average also re-reads the value for its ones-mask denominator.
    Fused: one read of every distinct per-client input, one write per
    carried state (plus the mask when ``emit``) and the partial sums.
    Broadcast scalars are not counted: a buffer counts as per-client when
    its leading dim is ``n`` and, for a tensor, its stride there is not 0
    (a scalar expanded to (n,) is read through a stride of 0)."""
    def tiled(name: str) -> bool:
        v = env.get(name)
        if v is None:          # produced by an earlier op: always per-client
            return True
        shape = tuple(getattr(v, "shape", ()))
        if not (len(shape) >= 1 and shape[0] == n):
            return False
        return not (isinstance(v, torch.Tensor) and v.stride(0) == 0
                    and n > 1)

    per = n * itemsize
    unfused = 0
    for op in program.ops:
        unfused += sum(per for r in op.reads if tiled(r))
        unfused += per * len(op.writes)
    unfused += per * 2 * len(program.totals)
    unfused += per * 4 * len(program.averages)
    unfused += per * 2 * len(program.hists)

    inputs = [nm for nm in program.input_names() if tiled(nm)] + ["valid"]
    fused = per * len(set(inputs))
    fused += per * len(program.state_out)
    if emit:
        fused += per * len(program.emit)
    n_stats = len(program.totals) + len(program.averages) + 1 \
        + sum(s.bins for s in program.hists)
    fused += n_stats * itemsize
    return {"unfused_bytes": unfused, "fused_bytes": fused,
            "ratio": unfused / max(fused, 1)}
