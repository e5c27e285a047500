"""Battery-aware server control: adapt round cadence, energy budgets and
admission from fleet telemetry (port of the JAX package's
``energy/control.py``).

The server's knobs — the round cadence ``T`` (local steps per round, which
prices a round), the per-group renewal cycles ``E`` and the serving
admission-threshold scale ``admit`` — move by a small set of composable
rules, each a pure function ``(ControlState, Telemetry, ControlBounds) ->
ControlState``, with a dead band (hysteresis) and AIMD: back off
multiplicatively when the fleet is depleted, recover additively when it
is energy-rich.  Under constant telemetry the state moves monotonically
toward a bound or holds, so the controller converges.

The control law is numpy on the host; the stats it reads come from the
card once per control period.  Consumers: `run_controlled` (chunked
`energy.fleet.simulate_fleet` horizons), ``serve.fleet_serve.
run_serve_controlled`` and ``core.simulate(..., energy=EnergyLoop(...,
controller=...))``.  Under a ``mesh`` (`run_controlled`, ``run_serve_
controlled``) the stats are replicated on every rank, so every rank's
controller takes the same decisions.  With ``obs=`` (a
`repro_torch.obs.Obs`) `run_controlled` streams at chunk boundaries: the
manifest, a ``fleet_chunk`` span a chunk, the chunk's rounds, a
``control`` event after each update and the retrace sentinel.  With
``checkpoint=`` (`repro_torch.checkpoint`) it persists chunk boundaries
and ``resume=True`` continues from the newest intact one, bit-exactly.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist import sharding
from repro_torch.energy import fleet as fleet_lib
from repro_torch.energy.arrivals import map_tensors
from repro_torch.kernels import ops
from repro_torch.obs import hist as hist_lib


@dataclasses.dataclass(frozen=True)
class ControlBounds:
    """Hard box constraints on the controllable knobs; every rule clips into
    these, so no rule composition can drive the system outside them."""

    t_min: int = 1
    t_max: int = 20
    e_min: int = 1
    e_max: int = 64
    admit_min: float = 0.25   # admission-threshold scale (serving)
    admit_max: float = 16.0


@dataclasses.dataclass(frozen=True)
class ControlState:
    """The server's controllable knobs."""

    T: int                # local steps per round (prices a round)
    E: np.ndarray         # (G,) int per-group renewal cycles
    admit: float = 1.0    # admission-threshold scale (`serve.admission`
    #                       policies apply it via ``scaled()``)


def _mean(x) -> float:
    """Mean that defines the empty-period 0/0 as 0.0 (a control period with
    zero recorded rounds must not poison the rules with NaN)."""
    x = np.asarray(x, np.float64)
    return float(x.mean()) if x.size else 0.0


def _div(num: float, den: float) -> float:
    """Ratio that defines x/0 as 0.0 — zero offered requests, zero harvest
    or zero scheduled slots mean "no signal", not a NaN/inf excursion."""
    return num / den if den > 0 else 0.0


@dataclasses.dataclass(frozen=True)
class Telemetry:
    """One control period's fleet signals, reduced from `FleetResult.stats`
    / `ServeResult.stats` (or an `EnergyLoop.step` scalar dict) to what the
    rules read.  The serving-ledger and per-group fields are populated only
    when the producing simulator emitted them.

    Degenerate periods are *defined*, not NaN: a period with zero rounds,
    zero offered requests, zero harvest, or zero-size groups reduces every
    affected average/ratio to 0.0 (hysteresis dead-bands then hold the
    knobs), so a quiet window can never destabilise the controller."""

    participation_rate: float   # mean participants / N
    frac_depleted: float        # mean fraction unable to afford a round
    overflow_frac: float        # overflowed / harvested (wasted harvest)
    mean_charge: float
    # distributional signals (DESIGN.md §14)
    p95_frac_depleted: float = 0.0   # p95 over the period's per-round
    #                                  frac_depleted values (tail rounds)
    hist_quantiles: dict[str, dict[str, float]] | None = None
    #   {"hist_soc": {"p50": .., "p95": .., "p99": ..}, ...} extracted from
    #   the period-summed streamed histogram counts, when the producing run
    #   carried hist=True telemetry
    # serving ledger (`serve.fleet_serve` stats)
    shed_rate: float = 0.0          # shed / offered requests
    deadline_miss_rate: float = 0.0  # admitted-but-unaffordable / offered
    # per-group signals (simulate_fleet(..., groups=)), each (G,)
    group_frac_depleted: np.ndarray | None = None
    group_participation_rate: np.ndarray | None = None

    @classmethod
    def from_stats(cls, stats: dict, num_clients: int,
                   group_sizes=None) -> "Telemetry":
        def arr(k):
            return np.asarray(stats[k], np.float64)

        harvested = float(arr("harvested").sum())
        overflowed = float(arr("overflowed").sum())
        extra: dict = {}
        fd = arr("frac_depleted").reshape(-1)
        extra["p95_frac_depleted"] = (
            float(np.percentile(fd, 95)) if fd.size else 0.0)
        hq = {}
        for k in stats:
            if not hist_lib.is_hist_key(k):
                continue
            spec = hist_lib.SPECS_BY_NAME.get(k)
            if spec is None:
                continue
            counts = arr(k).reshape(-1, spec.bins).sum(0)
            hq[k] = hist_lib.quantiles_from_counts(counts, spec)
        if hq:
            extra["hist_quantiles"] = hq
        if "offered" in stats:
            offered = float(arr("offered").sum())
            extra["shed_rate"] = _div(float(arr("shed").sum()), offered)
            extra["deadline_miss_rate"] = _div(
                float(arr("deadline_missed").sum()), offered)
        if "group_frac_depleted" in stats:
            # (R, G) per-round group signals -> (G,) period means
            gd = arr("group_frac_depleted")
            gd = gd.reshape(-1, gd.shape[-1])
            gp = arr("group_participants").reshape(-1, gd.shape[-1])
            zero = np.zeros(gd.shape[-1], np.float64)
            extra["group_frac_depleted"] = gd.mean(0) if gd.size else zero
            gp = gp.mean(0) if gp.size else zero
            sizes = (np.asarray(group_sizes, np.float64)
                     if group_sizes is not None
                     else np.full(gp.shape,
                                  num_clients / max(gp.shape[0], 1)))
            extra["group_participation_rate"] = np.divide(
                gp, sizes, out=np.zeros_like(gp), where=sizes > 0)
        return cls(
            participation_rate=_div(_mean(arr("participants")), num_clients),
            frac_depleted=_mean(arr("frac_depleted")),
            overflow_frac=_div(overflowed, harvested),
            mean_charge=_mean(arr("mean_charge")),
            **extra,
        )

    def depletion(self, signal: str = "mean") -> float:
        """The depletion signal a rule acts on: the period mean (default) or
        the p95 over the period's per-round ``frac_depleted`` (``"p95"`` —
        tail-aware control: a fleet whose *worst* rounds deplete a third of
        clients backs off even when the mean looks healthy)."""
        if signal == "p95":
            return self.p95_frac_depleted
        if signal != "mean":
            raise ValueError(f"unknown depletion signal {signal!r} "
                             f"(expected 'mean' or 'p95')")
        return self.frac_depleted


Rule = Callable[[ControlState, Telemetry, ControlBounds], ControlState]


@dataclasses.dataclass(frozen=True)
class CadenceRule:
    """AIMD + hysteresis on the round cadence ``T``.

    Depleted fraction above ``depleted_high`` → rounds are too expensive:
    multiplicative backoff (``T * backoff``, floored at ``t_min``).
    Depleted below ``depleted_low`` *and* overflow above ``overflow_high``
    (batteries full, harvest wasted) → the fleet can afford more local work:
    additive increase (``T + grow``).  Anywhere in between: hold.

    ``signal`` selects the depletion statistic the rule reads:
    ``"mean"`` (default, the period-mean frac_depleted) or ``"p95"``
    (`Telemetry.p95_frac_depleted` — react to the period's worst rounds,
    DESIGN.md §14).
    """

    depleted_high: float = 0.3
    depleted_low: float = 0.1
    overflow_high: float = 0.2
    backoff: float = 0.5
    grow: int = 1
    signal: str = "mean"

    def __call__(self, state: ControlState, tel: Telemetry,
                 bounds: ControlBounds) -> ControlState:
        dep = tel.depletion(self.signal)
        if dep > self.depleted_high:
            t = max(bounds.t_min, int(np.floor(state.T * self.backoff)))
        elif (dep < self.depleted_low
              and tel.overflow_frac > self.overflow_high):
            t = min(bounds.t_max, state.T + self.grow)
        else:
            t = state.T
        return dataclasses.replace(state, T=t)


@dataclasses.dataclass(frozen=True)
class BudgetRule:
    """AIMD + hysteresis on the per-group energy budget ``E``.

    ``E_k`` is group k's renewal cycle — the *inverse* of the participation
    load the server requests — so AIMD on load means: when the fleet is
    depleted above ``depleted_high`` AND clients are missing their scheduled
    slots (realized participation below ``slip`` × the asked rate
    ``mean(1/E)`` — asking a dead battery more often cannot help),
    multiplicative backoff of load (``E * grow``, capped at ``e_max``);
    energy-rich (depleted low AND overflow high) → additive recovery
    (``E − shrink``, floored at ``e_min``).  The slot-slip condition makes
    the backoff self-terminating: growing E lowers the asked rate until it
    meets what the batteries can actually sustain, then the rule holds —
    monotone under constant telemetry, hence convergent.

    With fleet-wide telemetry only, the whole vector moves together
    (preserving the relative group structure, the paper's §V profile).  When
    the telemetry carries **per-group** signals (`simulate_fleet(...,
    groups=)` → ``Telemetry.group_frac_depleted`` /
    ``group_participation_rate``, one entry per E_k), each ``E_k`` moves
    from its OWN group's depletion and slot slip instead — a drought in the
    τ=20 group no longer throttles the τ=1 group.  Each component is
    monotone under constant telemetry, so convergence is per-group.

    ``signal`` (``"mean"``/``"p95"``) selects the fleet-wide depletion
    statistic for the scalar branch, exactly as in `CadenceRule`; the
    per-group branch always reads the per-group means (group histograms are
    not carried).
    """

    depleted_high: float = 0.3
    depleted_low: float = 0.1
    overflow_high: float = 0.2
    slip: float = 0.3     # escalate only when >70% of asked slots are missed
    grow: float = 2.0
    shrink: int = 1
    signal: str = "mean"

    def __call__(self, state: ControlState, tel: Telemetry,
                 bounds: ControlBounds) -> ControlState:
        e = state.E
        gd = tel.group_frac_depleted
        if gd is not None and np.shape(gd) == e.shape:
            dep = np.asarray(gd, np.float64)
            part = np.asarray(tel.group_participation_rate, np.float64)
            asked = 1.0 / np.maximum(e, 1)
            backoff = (dep > self.depleted_high) & (part < self.slip * asked)
            recover = ((dep < self.depleted_low)
                       & (tel.overflow_frac > self.overflow_high))
            e = np.where(
                backoff,
                np.minimum(bounds.e_max, np.ceil(e * self.grow)),
                np.where(recover, np.maximum(bounds.e_min, e - self.shrink),
                         e)).astype(e.dtype)
        else:
            dep = tel.depletion(self.signal)
            asked = float(np.mean(1.0 / np.maximum(e, 1)))
            if (dep > self.depleted_high
                    and tel.participation_rate < self.slip * asked):
                e = np.minimum(bounds.e_max,
                               np.ceil(e * self.grow).astype(e.dtype))
            elif (dep < self.depleted_low
                  and tel.overflow_frac > self.overflow_high):
                e = np.maximum(bounds.e_min, e - self.shrink)
        return dataclasses.replace(state, E=e)


@dataclasses.dataclass(frozen=True)
class AdmissionRule:
    """AIMD + hysteresis on the serving admission-threshold scale ``admit``.

    The serving dual of `CadenceRule`: ``admit`` multiplies the admission
    policy's thresholds (`serve.admission` ``scaled()``), so raising it
    sheds/degrades more traffic and protects the batteries — the knob by
    which serving load yields to (or reclaims joules from) the training
    cadence sharing the fleet.  Depleted fraction above ``depleted_high`` OR
    deadline misses above ``miss_high`` (admission is writing checks the
    batteries can't cash) → multiplicative backoff of served load
    (``admit * backoff``); energy-comfortable (depleted below
    ``depleted_low``) while refusing users (shed rate above ``shed_high``)
    → additive recovery (``admit − recover``).  Dead band otherwise; moves
    are monotone under constant telemetry, hence convergent in
    ``[admit_min, admit_max]``.
    """

    depleted_high: float = 0.3
    depleted_low: float = 0.1
    miss_high: float = 0.05
    shed_high: float = 0.1
    backoff: float = 2.0
    recover: float = 0.25
    signal: str = "mean"   # depletion statistic ("mean" / "p95"), as in
    #                        CadenceRule

    def __call__(self, state: ControlState, tel: Telemetry,
                 bounds: ControlBounds) -> ControlState:
        dep = tel.depletion(self.signal)
        if (dep > self.depleted_high
                or tel.deadline_miss_rate > self.miss_high):
            a = min(bounds.admit_max, state.admit * self.backoff)
        elif (dep < self.depleted_low
              and tel.shed_rate > self.shed_high):
            a = max(bounds.admit_min, state.admit - self.recover)
        else:
            a = state.admit
        return dataclasses.replace(state, admit=a)


class ServerController:
    """Stateful wrapper: applies the rule chain to each telemetry report and
    exposes the current knobs.

    Args:
      T0: initial local steps per round.
      E0: initial per-group renewal cycles, scalar or (G,).
      bounds: `ControlBounds` box (rules clip into it).
      rules: rule chain, applied in order (default: `CadenceRule` then
        `BudgetRule`).
      groups: optional (N,) client → group assignment for `client_E` (e.g.
        ``arange(N) % G``, the paper's §V grouping).  ``None`` means E is
        already per-client (G == N) or scalar-broadcast.
    """

    def __init__(self, T0: int = 5, E0=1, *,
                 bounds: ControlBounds = ControlBounds(),
                 rules: Sequence[Rule] | None = None, groups=None,
                 admit0: float = 1.0):
        e0 = np.atleast_1d(np.asarray(E0, np.int64))
        self.bounds = bounds
        self.rules: tuple[Rule, ...] = (
            (CadenceRule(), BudgetRule()) if rules is None else tuple(rules))
        self.state = ControlState(
            T=int(np.clip(T0, bounds.t_min, bounds.t_max)),
            E=np.clip(e0, bounds.e_min, bounds.e_max),
            admit=float(np.clip(admit0, bounds.admit_min, bounds.admit_max)))
        self.groups = None if groups is None else np.asarray(groups, np.int64)
        self.trace: list[dict] = []

    @property
    def T(self) -> int:
        return self.state.T

    @property
    def E(self) -> np.ndarray:
        return self.state.E

    def client_E(self, num_clients: int | None = None) -> np.ndarray:
        """(N,) per-client cycles: the group vector expanded by ``groups``,
        or a scalar/size-1 E broadcast to ``num_clients`` — each client must
        get its OWN entry (a shared (1,) E would collapse the sustainable
        slot draw into one fleet-wide coin flip)."""
        e = self.E if self.groups is None else self.E[self.groups]
        if num_clients is not None:
            if e.size == 1:
                e = np.full((num_clients,), int(e[0]), e.dtype)
            elif e.size != num_clients:
                raise ValueError(
                    f"controller E covers {e.size} clients (E0 size "
                    f"{self.E.size}, groups "
                    f"{'set' if self.groups is not None else 'unset'}) but "
                    f"the fleet has {num_clients}")
        return e

    def group_sizes(self, num_clients: int) -> np.ndarray | None:
        """(G,) client count per group, when a grouping is configured."""
        if self.groups is not None:
            return np.bincount(self.groups, minlength=self.E.size)
        if self.E.size == num_clients:
            return np.ones(self.E.size, np.int64)  # per-client E: G == N
        return None

    def update(self, stats: dict, num_clients: int) -> ControlState:
        """Fold one control period's telemetry into the knobs."""
        tel = Telemetry.from_stats(stats, num_clients,
                                   group_sizes=self.group_sizes(num_clients))
        state = self.state
        for rule in self.rules:
            state = rule(state, tel, self.bounds)
        state = ControlState(
            T=int(np.clip(state.T, self.bounds.t_min, self.bounds.t_max)),
            E=np.clip(state.E, self.bounds.e_min, self.bounds.e_max),
            admit=float(np.clip(state.admit, self.bounds.admit_min,
                                self.bounds.admit_max)))
        self.state = state
        self.trace.append({"T": state.T, "E_mean": float(state.E.mean()),
                           "admit": state.admit, "telemetry": tel})
        return state


def run_controlled(process, bat, cost, cfg, num_rounds: int,
                   controller: ServerController, *, control_every: int = 10,
                   mesh=None, phase=None, record_masks: bool = False,
                   obs=None, pad_to: int | None = None, checkpoint=None,
                   resume: bool = False, checkpoint_every: int = 1,
                   hist: bool = False, device="cuda"):
    """Closed-loop fleet horizon: `simulate_fleet` in chunks of
    ``control_every`` rounds, with the controller adapting ``T`` (round
    pricing via ``cfg.local_steps``) and per-group ``E`` between chunks.

    The battery charge and arrival-process state flow across chunks through
    ``FleetResult.final_state`` and the absolute round index through
    ``round_offset``, so a run with a do-nothing controller equals one
    unchunked `simulate_fleet` call.  ``mesh`` shards each chunk's client
    axis over its ranks (`simulate_fleet`); the stats the controller reads
    are replicated, so every rank takes the same decisions.  A controller
    with ``groups`` gets per-group telemetry (``BudgetRule`` then moves
    each ``E_k`` from its own group).  ``hist=True`` carries the depletion
    streak and gives `Telemetry` its histogram quantiles.  ``obs`` streams
    each chunk's rounds when the controller has read them, with a
    ``fleet_chunk`` span, a ``control`` event and the retrace sentinel.

    ``checkpoint=`` (a directory or a `repro_torch.checkpoint.
    RunCheckpointer`) persists every ``checkpoint_every``-th chunk boundary
    and the last: the simulator state (gathered and unpadded under a mesh,
    written by rank 0 alone), the accumulated telemetry, the controller's
    knobs and trace, the RNG base key and a config hash (DESIGN.md §13).
    ``resume=True`` restores the newest intact boundary (on every rank) and
    continues; a kill-and-resume run equals an uninterrupted one bitwise.
    The mesh, ``pad_to`` and ``device`` are outside the hash: a run resumes
    across them.  On resume an ``obs`` stream gets a ``resume`` event, not
    a second manifest.

    Returns ``(FleetResult over the full horizon, controller)``.
    """
    if resume and checkpoint is None:
        raise ValueError("resume=True requires checkpoint=")
    dev = resolve_device(device)
    ckptr, cfg_hash, start, restored_stats, state = None, None, 0, None, None
    if checkpoint is not None:
        if record_masks:
            raise ValueError(
                "checkpoint= cannot carry record_masks=True: the (R, N) "
                "mask history is unbounded state the chunk boundary "
                "checkpoints do not persist")
        from repro_torch.checkpoint import resume as resume_lib
        from repro_torch.obs.events import pytree_hash
        ckptr = resume_lib.as_checkpointer(checkpoint)
        cfg_hash = pytree_hash((
            "fleet_controlled", process, bat, cost, cfg, phase,
            int(control_every), controller.rules, controller.bounds,
            controller.groups, bool(hist)))
        if resume:
            n = cfg.num_clients
            charge = torch.zeros((n,), dtype=torch.float32)
            state_like = ((charge, charge, process.init()) if hist
                          else (charge, process.init()))
            rc = resume_lib.restore_run(
                ckptr, kind="fleet_controlled", config_hash=cfg_hash,
                state_like=state_like, seed=cfg.seed, controller=controller)
            if rc is not None:
                state, start = rc.state, rc.round_offset
                restored_stats = rc.stats
    save = ckptr is not None and sharding.is_lead(mesh)
    sentinel = None
    if obs is not None:
        from repro_torch.obs.profile import RetraceSentinel
        if start:
            obs.event("resume", run_kind="fleet_controlled", round=start,
                      horizon=num_rounds, config_hash=cfg_hash,
                      checkpoint_dir=ckptr.directory)
        else:
            obs.write_manifest(
                "fleet_controlled", config=(process, bat, cost),
                seed=cfg.seed, backend=ops.backend(device), mesh=mesh,
                num_clients=cfg.num_clients, horizon=num_rounds,
                device=device, control_every=control_every,
                policy=cfg.policy)
        sentinel = RetraceSentinel(obs)
    chunks: list[fleet_lib.FleetResult] = []
    offset = start

    def acc_stats():
        parts = ([restored_stats] if restored_stats is not None else []) \
            + [c.stats for c in chunks]
        return ({k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
                if parts else {})

    groups = controller.groups
    num_groups = None if groups is None else controller.E.size
    chunk_i = 0
    while offset < num_rounds:
        chunk = min(control_every, num_rounds - offset)
        ccfg = dataclasses.replace(cfg, local_steps=controller.T)
        with contextlib.ExitStack() as stack:
            if obs is not None:
                stack.enter_context(obs.span("fleet_chunk"))
            res = fleet_lib.simulate_fleet(
                process, bat, cost, ccfg, chunk,
                E=controller.client_E(cfg.num_clients), phase=phase,
                record_masks=record_masks, mesh=mesh, pad_to=pad_to,
                state=state, round_offset=offset, groups=groups,
                num_groups=num_groups, hist=hist, device=device)
        state = res.final_state
        chunks.append(res)
        controller.update(res.stats, cfg.num_clients)
        if obs is not None:
            obs.rounds("fleet", offset, res.stats)
            obs.event("control", round=offset + chunk, T=controller.state.T,
                      E_mean=float(np.mean(controller.state.E)),
                      admit=controller.state.admit)
            if offset == start:
                sentinel.snapshot()
            else:
                sentinel.check(context=f"fleet chunk at round {offset}")
        offset += chunk
        chunk_i += 1
        if save and (chunk_i % max(1, checkpoint_every) == 0
                     or offset >= num_rounds):
            resume_lib.save_run(
                ckptr, kind="fleet_controlled", round_offset=offset,
                state=state, stats=acc_stats(), controller=controller,
                config_hash=cfg_hash, seed=cfg.seed)
    masks = (torch.cat([c.masks for c in chunks])
             if record_masks and chunks else None)
    if chunks:
        last = chunks[-1]
        final_charge, final_streak = last.final_charge, last.final_streak
        final_pstate = last.final_pstate
    elif state is None:
        final_charge = final_streak = final_pstate = None
    else:                       # resumed at or past the horizon
        state = map_tensors(state, lambda t: t.to(dev))
        if hist:
            final_charge, final_streak, final_pstate = state
        else:
            (final_charge, final_pstate), final_streak = state, None
    out = fleet_lib.FleetResult(stats=acc_stats(), final_charge=final_charge,
                                masks=masks, final_pstate=final_pstate,
                                final_streak=final_streak)
    return out, controller

