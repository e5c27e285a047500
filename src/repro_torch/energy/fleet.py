"""Fleet-scale battery-gated federated scheduling simulator (port of the
JAX package's ``energy/fleet.py``).

The whole fleet's state — battery charge (N,), arrival-process state and
the round's telemetry — lives on one device, and a round is a few
whole-fleet tensor operations, so N runs into the millions with no
per-client Python loop.  Per round r:

    harvest, pstate = process.sample(fold_in(key, r), r, pstate)
    want            = sustainable_schedule(seed, r, E, phase)  # SUSTAINABLE
    charge, mask, stats = fleet_step(program, env)             # one launch

The harvest and the SUSTAINABLE slot draw use global client indices
outside the step (the per-client RNG contract); everything after them is
the step program of `energy.step_ops`, run on the card by the
``fleet_step`` kernel and on the CPU by its plain version
(``kernels.ops.fleet_step``: the device picks, there is no ``backend=``).

With ``mesh=`` (a ``torch.distributed`` ``DeviceMesh``, one process a
rank, every rank calling with the same arguments) the client axis is
sharded over the mesh's data axes (`dist.sharding`): N is padded to a
multiple of the data-axis product, each rank holds its slab and draws by
its clients' global indices, and each round's stats are all-reduced once
(``fused_step_sharded``) and come back replicated.  The per-client
results are gathered once, at the end of the run, so every rank's
`FleetResult` has the host-local shapes.

Battery-gated policies: SUSTAINABLE (Algorithm 1's slot draw gated by
stored energy), GREEDY (participate whenever the battery covers the round
cost), THRESHOLD (only when ``available >= threshold * round_cost``) and
ALWAYS (as GREEDY: still physically gated).

Telemetry per round (each an (R,) array in ``FleetResult.stats``):
participants, harvested, consumed, leaked, overflowed, mean_charge and
frac_depleted; with ``groups``, (R, G) group_participants and
group_frac_depleted; with ``hist=True``, (R, bins) histogram counts.

With ``obs=`` (a `repro_torch.obs.Obs`) the run writes its manifest and
one ``round`` event a round (``hist`` events with ``hist=True``): a round
at a time from inside the loop when ``obs.tap`` is set (one host copy of
the round's stats), else from the stacked stats at the end of the run.
``obs=None`` is the un-instrumented run: no host copy, no launch.

Differences from the reference: rounds are a Python loop (no ``jit``, no
``use_jit``), so the round tap is a call in the loop, not an
``io_callback``; a mesh's ranks are processes; histogram counts are
all-reduced as exact integers; ``device`` picks the card (default) or the
CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import scheduling
from repro_torch.core.scheduling import Policy
from repro_torch.device import resolve_device
from repro_torch.dist import sharding
from repro_torch.energy import battery as battery_lib
from repro_torch.energy import step_ops
from repro_torch.energy.arrivals import map_clients, map_tensors
from repro_torch.energy.costs import DeviceCostModel
from repro_torch.kernels import ops

PyTree = Any

# policies with a battery-gated fleet implementation (fleet_mask)
FLEET_POLICIES: tuple[Policy, ...] = (
    Policy.SUSTAINABLE, Policy.GREEDY, Policy.THRESHOLD, Policy.ALWAYS)


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Fleet-simulation hyperparameters."""

    num_clients: int
    policy: Policy = Policy.SUSTAINABLE
    local_steps: int = 5                 # T, prices a round via the cost model
    seed: int = 0
    threshold: float = 1.0               # THRESHOLD margin (x round cost)


@dataclasses.dataclass
class FleetResult:
    stats: dict[str, np.ndarray]               # each (R,) (or (R, B) / (R, G))
    final_charge: torch.Tensor                 # (N,)
    masks: torch.Tensor | None = None          # (R, N) when recorded
    final_pstate: Any = None                   # arrival-process state after R
    final_streak: torch.Tensor | None = None   # (N,) with hist telemetry

    @property
    def participation_rate(self):
        n = self.final_charge.shape[0]
        return np.asarray(self.stats["participants"]) / n

    @property
    def final_state(self):
        """(charge, process state) — or (charge, streak, process state)
        after a hist run — to continue the horizon through
        ``simulate_fleet(state=, round_offset=)``."""
        if self.final_streak is not None:
            return self.final_charge, self.final_streak, self.final_pstate
        return self.final_charge, self.final_pstate


def fleet_mask(policy: Policy | str, seed, rnd, E, available, round_cost,
               threshold: float = 1.0, phase=None) -> torch.Tensor:
    """(N,) float32 battery-gated participation mask for one round: every
    policy is AND-ed with physical feasibility ``available >= round_cost``."""
    pol = Policy(policy)
    available = torch.as_tensor(available, dtype=torch.float32)
    round_cost = torch.as_tensor(round_cost, dtype=torch.float32,
                                 device=available.device)
    feasible = available >= round_cost
    if pol == Policy.SUSTAINABLE:
        want = scheduling.sustainable_schedule(
            seed, rnd, torch.as_tensor(E, device=available.device), phase)
    elif pol in (Policy.GREEDY, Policy.ALWAYS):
        want = torch.ones_like(available)
    elif pol == Policy.THRESHOLD:
        thr = torch.tensor(threshold, dtype=torch.float32,
                           device=available.device)
        want = (available >= thr * round_cost).float()
    else:
        raise ValueError(
            f"policy {pol.value!r} has no battery-gated fleet variant "
            f"(supported: {[p.value for p in FLEET_POLICIES]})")
    return want * feasible.float()


def _round_cost(cost, cfg: FleetConfig, device) -> torch.Tensor:
    """Joules per round as (N,) float32: a scalar cost stays one value read
    through a stride of 0."""
    if isinstance(cost, DeviceCostModel):
        cost = cost.round_cost(cfg.local_steps)
    return torch.as_tensor(cost, dtype=torch.float32,
                           device=device).expand(cfg.num_clients)


def _pad_clients(tree: PyTree, n: int, n_pad: int) -> PyTree:
    """Edge-pad every tensor with a leading client dim of ``n`` to ``n_pad``
    by replicating the last real client (so renewal cycles and capacities
    stay well defined on the padding lanes; their telemetry is excluded
    by ``valid``).  A replay's table is never padded (`map_clients`)."""
    if n_pad == n:
        return tree

    def leaf(x):
        if x.dim() and x.shape[0] == n:
            if x.stride(0) == 0:
                return x[:1].expand((n_pad,) + tuple(x.shape[1:]))
            return torch.cat([x, x[-1:].expand((n_pad - n,)
                                                + tuple(x.shape[1:]))])
        return x

    return map_clients(tree, leaf)


def _slice_clients(tree: PyTree, n: int, n_pad: int) -> PyTree:
    """Drop the padding lanes again."""
    if n_pad == n:
        return tree
    return map_clients(tree, lambda x: x[:n] if x.dim() and x.shape[0] == n_pad
                       else x)


class _Round:
    """One round of the fleet, shared by `simulate_fleet` and `EnergyLoop`
    so the two paths are the same program: the per-client draws, then one
    ``fleet_step`` (kernel on the card, plain version on the CPU).  Under a
    ``mesh`` the inputs are this rank's slab, clients ``[first, first +
    n_local)`` of a padded fleet of ``n_pad``."""

    def __init__(self, process, bat, policy, round_cost, E, phase, valid,
                 seed: int, threshold: float, groups, num_groups, hist: bool,
                 emit: bool, device, mesh=None, first: int = 0,
                 n_pad: int | None = None):
        self.process, self.policy = process, Policy(policy)
        self.E, self.phase, self.seed = E, phase, seed
        self.num_groups = num_groups if groups is not None else None
        self.hist, self.emit = hist, emit
        self.base_key = prng.PRNGKey(seed, device)
        self.program, self.env = step_ops.fleet_step_program(
            bat, self.policy, self.num_groups, hist=hist, device=device)
        self.env.update(round_cost=round_cost, valid=valid,
                        threshold=torch.tensor(threshold, dtype=torch.float32,
                                               device=device))
        if groups is not None:
            self.env["groups"] = groups
        self.mesh, self.first = mesh, first
        self.n = valid.shape[0] if n_pad is None else n_pad

    def __call__(self, carry, r: int):
        if self.hist:
            charge, streak, pstate = carry
        else:
            charge, pstate = carry
        harvest, pstate = self.process.sample(
            prng.fold_in(self.base_key, r), r, pstate, first=self.first)
        env = dict(self.env, charge=charge, harvest=harvest)
        if self.hist:
            env["streak"] = streak
        if self.policy == Policy.SUSTAINABLE:
            env["want"] = scheduling.sustainable_schedule(
                self.seed, r, self.E, self.phase, first=self.first)
        state, emits, stats = ops.fleet_step(
            self.program, env, n=self.n, emit=self.emit,
            num_groups=self.num_groups, mesh=self.mesh)
        carry = ((state["charge_out"], state["streak_out"], pstate)
                 if self.hist else (state["charge_out"], pstate))
        return carry, emits.get("mask"), stats


def simulate_fleet(process, bat: battery_lib.BatteryConfig, cost,
                   cfg: FleetConfig, num_rounds: int, *,
                   E=None, phase=None, record_masks: bool = False,
                   mesh=None, pad_to: int | None = None, state=None,
                   round_offset: int = 0, groups=None,
                   num_groups: int | None = None, obs=None,
                   hist: bool = False, device="cuda") -> FleetResult:
    """Simulate ``num_rounds`` global rounds of battery-gated scheduling for
    the whole fleet on ``device``.

    Args:
      process: arrival process (`energy.arrivals`) sized to the fleet.
      bat: `BatteryConfig` (scalar or per-client fields).
      cost: `DeviceCostModel` (priced at ``cfg.local_steps``) or joules per
        round, scalar or (N,).
      cfg: `FleetConfig`.
      num_rounds: R.
      E: (N,) assumed renewal cycles (SUSTAINABLE slot draw); default 1s.
      phase: optional (N,) per-client start offsets (paper footnote 1).
      record_masks: also return the (R, N) masks (O(R N) memory).
      mesh: a ``torch.distributed.device_mesh.DeviceMesh`` on ``device``'s
        type: shard the client axis over its data axes (every dim but
        ``"model"``), one slab a rank; every rank calls with the same
        arguments and gets the same result.  N is padded up to a multiple
        of the data-axis product; results equal the host-local run's
        (bitwise on exact-arithmetic configurations).
      pad_to: pad the fleet to this width (>= N; a multiple of the
        data-axis product under ``mesh``) with copies of the last client,
        excluded from the telemetry by ``valid``; results are those of the
        unpadded fleet.
      state: ``(charge, process_state)`` (or ``(charge, streak,
        process_state)`` with ``hist``) to resume from, e.g. a previous
        chunk's ``FleetResult.final_state``.
      round_offset: global index of the first round, so chunked runs keep
        the RNG stream and window arithmetic of an unchunked horizon.
      groups: optional (N,) int client -> group assignment (with
        ``num_groups``, default max + 1): the stats gain (R, G)
        ``group_participants`` / ``group_frac_depleted``.
      obs: a `repro_torch.obs.Obs`: the manifest and the round events
        (streamed a round at a time when ``obs.tap`` is set).
      hist: the fixed-bin histograms ``hist_soc``, ``hist_spend``,
        ``hist_streak`` (exact counts), carrying the per-client
        consecutive-depleted streak.
      device: where the fleet lives; "cuda" (default) runs the round step
        on the ``fleet_step`` kernel, "cpu" on its plain version.

    Returns:
      `FleetResult` with per-round telemetry as host numpy arrays.
    """
    dev = resolve_device(device)
    if mesh is not None:
        sharding.check_device(mesh, dev)
    n = cfg.num_clients
    if process.num_clients != n:
        raise ValueError(f"process is sized for {process.num_clients} "
                         f"clients, FleetConfig.num_clients={n}")
    process = map_tensors(process, lambda t: t.to(dev))
    bat = battery_lib.BatteryConfig(**bat.fields(dev))
    round_cost = _round_cost(cost, cfg, dev)
    E = (torch.ones((n,), dtype=torch.int32, device=dev) if E is None
         else torch.as_tensor(E, device=dev).to(torch.int32))
    phase = (None if phase is None
             else torch.as_tensor(phase, device=dev).to(torch.int32))
    if groups is not None:
        groups = torch.as_tensor(groups, device=dev).to(torch.int32)
        if num_groups is None:
            num_groups = int(groups.max()) + 1
    streak0 = torch.zeros((n,), dtype=torch.float32, device=dev) if hist \
        else None
    if state is None:
        charge0, pstate0 = bat.init(n, dev), process.init()
    elif hist:
        if len(state) != 3:
            raise ValueError(
                "hist=True carries the depletion streak: pass the 3-tuple "
                "state (charge, streak, process_state) from a hist run's "
                "final_state, not the 2-tuple")
        charge0, streak0, pstate0 = state
        streak0 = torch.as_tensor(streak0, dtype=torch.float32, device=dev)
    else:
        charge0, pstate0 = state
    charge0 = torch.as_tensor(charge0, dtype=torch.float32,
                              device=dev).contiguous()
    pstate0 = map_tensors(pstate0, lambda t: t.to(dev))

    if obs is not None:
        obs.write_manifest("fleet", config=(process, bat, round_cost),
                           seed=cfg.seed, backend=ops.backend(dev),
                           mesh=mesh, num_clients=n, horizon=num_rounds,
                           device=dev, policy=Policy(cfg.policy).value,
                           round_offset=round_offset, hist=bool(hist))
    tap = obs.round_tap("fleet") if obs is not None and obs.tap else None

    n_pad = padded_width(n, mesh, pad_to)
    valid = (torch.arange(n_pad, device=dev) < n).float()
    tree = _pad_clients(
        (process, bat, round_cost, E, phase, valid, charge0, streak0,
         pstate0, groups), n, n_pad)
    first, n_local = 0, n_pad
    if mesh is not None:
        tree = sharding.shard_fleet(tree, n_pad, mesh, dev)
        first, n_local = sharding.slab(n_pad, mesh)
    (process, bat, round_cost, E, phase, valid, charge0, streak0, pstate0,
     groups) = tree

    step = _Round(process, bat, cfg.policy, round_cost, E, phase, valid,
                  cfg.seed, cfg.threshold, groups, num_groups, hist,
                  record_masks, dev, mesh=mesh, first=first, n_pad=n_pad)
    carry = (charge0, streak0, pstate0) if hist else (charge0, pstate0)
    outs, masks = [], []
    for r in range(num_rounds):
        carry, mask, s = step(carry, round_offset + r)
        outs.append(s)
        if record_masks:
            masks.append(mask)
        if tap is not None:
            tap(round_offset + r, s)
    stats = {k: torch.stack([o[k] for o in outs]).cpu().numpy()
             for k in outs[0]} if outs else {}
    if obs is not None and tap is None:
        obs.rounds("fleet", round_offset, stats)
    masks = torch.stack(masks) if record_masks and masks else None
    if mesh is not None:          # the slabs, once, at the end of the run
        carry = sharding.gather_fleet(carry, n_local, mesh)
        if masks is not None:
            masks = sharding.gather_clients(masks, mesh, dim=1)
    if hist:
        charge, streak, pstate = carry
        streak = streak[:n]
    else:
        (charge, pstate), streak = carry, None
    return FleetResult(stats=stats, final_charge=charge[:n],
                       masks=masks[:, :n] if masks is not None else None,
                       final_pstate=_slice_clients(pstate, n, n_pad),
                       final_streak=streak)


def padded_width(n: int, mesh=None, pad_to: int | None = None) -> int:
    """The fleet's padded width: N, up to a multiple of the mesh's
    data-axis product, or ``pad_to`` (at least that, and a multiple of the
    product under a mesh)."""
    n_pad, axis = n, 1
    if mesh is not None:
        axis = sharding.mesh_axis_size(mesh, sharding.data_axes(mesh))
        n_pad = -(-n // axis) * axis
    if pad_to is not None:
        if pad_to < n_pad:
            raise ValueError(f"pad_to={pad_to} is below the fleet width "
                             f"{n_pad}")
        if pad_to % axis:
            raise ValueError(f"pad_to={pad_to} must be a multiple of the "
                             f"data-axis product {axis}")
        n_pad = pad_to
    return n_pad


class EnergyLoop:
    """Host-side stepping wrapper around the same fleet round, for
    `core.simulate`'s energy closed loop: the training driver asks for one
    battery-gated mask per round and the loop carries charge and process
    state between calls.  The same program as `simulate_fleet` (shared
    round).  A ``controller`` (`energy.control.ServerController`) closes
    the loop on the server's side: `core.simulate` reads its T and E each
    round and feeds the round's telemetry back."""

    def __init__(self, process, bat: battery_lib.BatteryConfig, cost,
                 threshold: float = 1.0, controller=None, device="cuda"):
        self.device = resolve_device(device)
        self.process = map_tensors(process, lambda t: t.to(self.device))
        self.bat = bat
        self.cost = cost
        self.threshold = threshold
        self.controller = controller
        self._carry = None

    def reset(self) -> None:
        self._carry = (self.bat.init(self.process.num_clients, self.device),
                       self.process.init())

    def step(self, policy: Policy | str, seed: int, rnd: int, E,
             local_steps: int, phase=None) -> tuple[np.ndarray, dict]:
        """Advance one round; returns ((N,) mask, scalar telemetry)."""
        if self._carry is None:
            self.reset()
        n = self.process.num_clients
        if np.shape(E)[0] != n:
            raise ValueError(
                f"energy loop's arrival process is sized for {n} clients but "
                f"the training run has {np.shape(E)[0]}")
        cfg = FleetConfig(num_clients=n, policy=Policy(policy),
                          local_steps=local_steps, seed=seed,
                          threshold=self.threshold)
        dev = self.device
        step = _Round(self.process, self.bat, cfg.policy,
                      _round_cost(self.cost, cfg, dev),
                      torch.as_tensor(np.asarray(E), device=dev)
                      .to(torch.int32),
                      None if phase is None else
                      torch.as_tensor(phase, device=dev).to(torch.int32),
                      torch.ones((n,), dtype=torch.float32, device=dev),
                      seed, self.threshold, None, None, False, True, dev)
        self._carry, mask, stats = step(self._carry, int(rnd))
        return mask.cpu().numpy(), {k: float(v) for k, v in stats.items()}
