"""Fleet-scale battery-gated *serving* simulator (port of the JAX package's
``serve/fleet_serve.py``).

The training-side dual of `energy.fleet.simulate_fleet`: the whole fleet's
state — battery charge (N,), traffic-process state, harvest-process state
— lives on one device, and an epoch is a few whole-fleet tensor operations
and one step-program launch.  Per epoch t:

    ekey             = fold_in(key, t)
    harvest, hstate  = harvest.sample(fold_in(ekey, 0), t, hstate)
    requests, tstate = traffic.sample(fold_in(ekey, 1), t, tstate)
    twant            = sustainable_schedule(seed, t, train.E)  # SUSTAINABLE
    charge, mode, stats = fleet_step(serve program, env)      # one launch

The serve program (`energy.step_ops.serve_step_program`) absorbs the
harvest, prices the grades, decides each client's admission mode, serves
``min(admitted, floor(available / per_request_cost))`` requests, books the
ledger and then lets an optional `TrainLoad` drain what serving left.  It
runs on the card as the serve program of the ``fleet_step`` kernel and on
the CPU as its plain version (``kernels.ops.fleet_step``: the device
picks, there is no ``backend=``).  Request conservation holds by
construction::

    offered == served_full + served_short + shed + deadline_missed

Telemetry per epoch (each an (E,) array in ``ServeResult.stats``): the
energy seven of the fleet simulator plus offered, served_full,
served_short, shed, deadline_missed, tokens_decoded, consumed_serve and
consumed_train; with ``hist=True`` the (E, bins) histogram counts.

With ``mesh=`` (a ``torch.distributed`` ``DeviceMesh``) the client axis is
sharded over the mesh's ranks as in `energy.fleet.simulate_fleet`: each
rank holds a slab, draws harvest and traffic by its clients' global
indices, all-reduces each epoch's row of sums once and gets the stats
replicated; the per-client results are gathered at the end of the run.

With ``obs=`` (a `repro_torch.obs.Obs`) `simulate_serve` writes its
manifest and one ``round`` event an epoch, as `energy.fleet.
simulate_fleet` does (a round tap under ``obs.tap``), and
`run_serve_controlled` streams at chunk boundaries: the manifest, a
``serve_chunk`` span a chunk, the chunk's epochs, a ``control`` event
after each controller update and the retrace sentinel.  ``obs=None`` is
the un-instrumented run.

Differences from the reference: epochs are a Python loop (no ``jit``, no
``use_jit``); a mesh's ranks are processes; histogram counts are
all-reduced as exact integers; ``device`` picks the card (default) or
the CPU.
"""
from __future__ import annotations

import contextlib
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
from repro_torch.energy.arrivals import map_tensors
from repro_torch.energy.costs import DecodeCostModel, DeviceCostModel
from repro_torch.energy.fleet import (_pad_clients, _slice_clients,
                                      padded_width)
from repro_torch.kernels import ops
from repro_torch.serve.qos import QoSSpec


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving-simulation hyperparameters."""

    num_clients: int
    seed: int = 0


@dataclasses.dataclass(frozen=True, eq=False)
class TrainLoad:
    """A federated-training load sharing the serving fleet's batteries: the
    battery-gated training mask (``policy`` over ``E``) is evaluated on the
    charge left after serving and drains ``round_cost`` joules per
    participant per epoch (one epoch doubles as one global round)."""

    E: torch.Tensor            # (N,) int32 renewal cycles
    round_cost: torch.Tensor   # (N,) float32 joules per participated round
    threshold: torch.Tensor = 1.0   # THRESHOLD policy margin
    policy: Policy = Policy.SUSTAINABLE

    @classmethod
    def create(cls, E, cost, local_steps: int = 5, threshold: float = 1.0,
               policy: Policy = Policy.SUSTAINABLE, device=None
               ) -> "TrainLoad":
        """Price a `DeviceCostModel` (or joules, scalar or (N,)) at
        ``local_steps``; a scalar cost is expanded to (N,) (stride 0)."""
        E = torch.as_tensor(np.asarray(E) if not isinstance(E, torch.Tensor)
                            else E, device=device).to(torch.int32)
        if isinstance(cost, DeviceCostModel):
            cost = cost.round_cost(local_steps)
        round_cost = torch.as_tensor(cost, dtype=torch.float32,
                                     device=E.device).expand(E.shape)
        return cls(E=E, round_cost=round_cost,
                   threshold=torch.tensor(threshold, dtype=torch.float32,
                                          device=E.device),
                   policy=Policy(policy))


@dataclasses.dataclass
class ServeResult:
    stats: dict[str, np.ndarray]               # each (E,) (or (E, bins))
    final_charge: torch.Tensor                 # (N,)
    modes: torch.Tensor | None = None          # (E, N) int32 when recorded
    final_tstate: Any = None                   # traffic state after E epochs
    final_hstate: Any = None                   # harvest state after E epochs
    final_streak: torch.Tensor | None = None   # (N,) with hist telemetry

    @property
    def final_state(self):
        """(charge, traffic state, harvest state) — or (charge, streak,
        traffic state, harvest state) after a hist run — to continue the
        horizon through ``simulate_serve(state=, epoch_offset=)``."""
        if self.final_streak is not None:
            return (self.final_charge, self.final_streak, self.final_tstate,
                    self.final_hstate)
        return self.final_charge, self.final_tstate, self.final_hstate

    def _rate(self, key):
        offered = np.maximum(np.asarray(self.stats["offered"], np.float64),
                             1e-12)
        return np.asarray(self.stats[key], np.float64) / offered

    @property
    def shed_rate(self):
        """(E,) fraction of offered requests refused up front."""
        return self._rate("shed")

    @property
    def deadline_miss_rate(self):
        """(E,) fraction of offered requests admitted but unaffordable."""
        return self._rate("deadline_missed")

    @property
    def served_rate(self):
        """(E,) fraction of offered requests answered (either grade)."""
        return self._rate("served_full") + self._rate("served_short")

    @property
    def joules_per_token(self):
        """Serving joules per generated token over the horizon."""
        toks = float(np.asarray(self.stats["tokens_decoded"]).sum())
        return float(np.asarray(self.stats["consumed_serve"]).sum()) \
            / max(toks, 1e-12)


def _fields_on(obj, fields, device):
    """A copy of a cost model or QoS spec with every field a float32 tensor
    on ``device`` (0-dim or (N,)), so padding and the kernel see tensors."""
    return dataclasses.replace(obj, **{
        f: battery_lib.as_field(getattr(obj, f), device) for f in fields})


class _Epoch:
    """One serving epoch: the per-client draws, then one ``fleet_step`` on
    the serve program (kernel on the card, plain version on the CPU).
    Under a ``mesh`` the inputs are this rank's slab, clients ``[first,
    first + n_local)`` of a padded fleet of ``n_pad``."""

    def __init__(self, traffic, harvest, bat, cost, qos, policy, train,
                 valid, seed: int, admit: float, hist: bool, emit: bool,
                 device, mesh=None, first: int = 0,
                 n_pad: int | None = None):
        self.traffic, self.harvest, self.train = traffic, harvest, train
        self.seed, self.hist, self.emit = seed, hist, emit
        self.base_key = prng.PRNGKey(seed, device)
        self.program, self.env = step_ops.serve_step_program(
            bat, cost, qos, policy, train, hist=hist, device=device)
        self.env.update(valid=valid, admit=torch.tensor(
            float(admit), dtype=torch.float32, device=device))
        self.sustainable = (train is not None
                            and Policy(train.policy) == Policy.SUSTAINABLE)
        self.mesh, self.first = mesh, first
        self.n = valid.shape[0] if n_pad is None else n_pad

    def __call__(self, carry, t: int):
        if self.hist:
            charge, streak, tstate, hstate = carry
        else:
            charge, tstate, hstate = carry
        ekey = prng.fold_in(self.base_key, t)
        harvest, hstate = self.harvest.sample(prng.fold_in(ekey, 0), t,
                                              hstate, first=self.first)
        requests, tstate = self.traffic.sample(prng.fold_in(ekey, 1), t,
                                               tstate, first=self.first)
        env = dict(self.env, charge=charge, harvest=harvest,
                   requests=requests.to(torch.float32))
        if self.hist:
            env["streak"] = streak
        if self.sustainable:
            env["twant"] = scheduling.sustainable_schedule(
                self.seed, t, self.train.E, None, first=self.first)
        state, emits, stats = ops.fleet_step(self.program, env, n=self.n,
                                             emit=self.emit, mesh=self.mesh)
        carry = ((state["charge_out"], state["streak_out"], tstate, hstate)
                 if self.hist else (state["charge_out"], tstate, hstate))
        return carry, emits.get("mode"), stats


def simulate_serve(traffic, harvest, bat: battery_lib.BatteryConfig,
                   cost: DecodeCostModel, qos: QoSSpec, policy,
                   cfg: ServeConfig, num_epochs: int, *,
                   train: TrainLoad | None = None, admit: float = 1.0,
                   record_modes: bool = False, mesh=None,
                   pad_to: int | None = None, state=None,
                   epoch_offset: int = 0, obs=None, hist: bool = False,
                   device="cuda") -> ServeResult:
    """Simulate ``num_epochs`` serving epochs of battery-gated admission for
    the whole fleet on ``device``.

    Args:
      traffic: request process (`serve.traffic`) sized to the fleet.
      harvest: energy-arrival process (`energy.arrivals`).
      bat: `BatteryConfig` (scalar or per-client fields).
      cost: `DecodeCostModel` pricing requests.
      qos: `QoSSpec` token budgets of the full and degraded grades.
      policy: admission policy (`serve.admission`).
      cfg: `ServeConfig`.
      num_epochs: E.
      train: optional `TrainLoad` competing for the same batteries
        (drained after serving each epoch).
      admit: the admission-threshold scale (the server controller's knob).
      record_modes: also return the (E, N) admission modes (O(E N)
        memory).
      mesh: a ``torch.distributed.device_mesh.DeviceMesh`` on ``device``'s
        type: shard the client axis over its data axes, one slab a rank,
        as `energy.fleet.simulate_fleet` does; every rank calls with the
        same arguments and gets the same result.
      pad_to: pad the fleet to this width (>= N; a multiple of the
        data-axis product under ``mesh``) with copies of the last client,
        excluded from the telemetry by ``valid``; results are those of the
        unpadded fleet.
      state: ``(charge, traffic_state, harvest_state)`` (or ``(charge,
        streak, traffic_state, harvest_state)`` with ``hist``) to resume
        from, e.g. a previous chunk's ``ServeResult.final_state``.
      epoch_offset: global index of the first epoch, so chunked runs keep
        the RNG stream and the diurnal phase of an unchunked horizon.
      obs: a `repro_torch.obs.Obs`: the manifest and the epoch events
        (streamed an epoch at a time when ``obs.tap`` is set).
      hist: the fixed-bin histograms ``hist_soc``, ``hist_spend`` (over the
        combined serve + train drain), ``hist_streak`` (exact counts),
        carrying the per-client consecutive-depleted streak.
      device: where the fleet lives; "cuda" (default) runs each epoch's
        step on the ``fleet_step`` kernel's serve program, "cpu" on its
        plain version.

    Returns:
      `ServeResult` with per-epoch telemetry as host numpy arrays.
    """
    dev = resolve_device(device)
    if mesh is not None:
        sharding.check_device(mesh, dev)
    n = cfg.num_clients
    for name, proc in (("traffic", traffic), ("harvest", harvest)):
        if proc.num_clients != n:
            raise ValueError(
                f"{name} process is sized for {proc.num_clients} clients, "
                f"ServeConfig.num_clients={n}")
    to_dev = lambda tree: map_tensors(tree, lambda t: t.to(dev))
    traffic, harvest, policy, train = (to_dev(traffic), to_dev(harvest),
                                       to_dev(policy), to_dev(train))
    bat = battery_lib.BatteryConfig(**bat.fields(dev))
    cost = _fields_on(cost, step_ops.COST_FIELDS, dev)
    qos = _fields_on(qos, QoSSpec.FIELDS, dev)
    streak0 = torch.zeros((n,), dtype=torch.float32, device=dev) if hist \
        else None
    if state is None:
        charge0, tstate0, hstate0 = bat.init(n, dev), traffic.init(), \
            harvest.init()
    elif hist:
        if len(state) != 4:
            raise ValueError(
                "hist=True carries the depletion streak: pass the 4-tuple "
                "state (charge, streak, traffic_state, harvest_state) from "
                "a hist run's final_state, not the 3-tuple")
        charge0, streak0, tstate0, hstate0 = state
        streak0 = torch.as_tensor(streak0, dtype=torch.float32, device=dev)
    else:
        charge0, tstate0, hstate0 = state
    charge0 = torch.as_tensor(charge0, dtype=torch.float32,
                              device=dev).contiguous()
    tstate0, hstate0 = to_dev(tstate0), to_dev(hstate0)

    if obs is not None:
        obs.write_manifest(
            "serve", config=(traffic, harvest, bat, cost, qos, policy, train),
            seed=cfg.seed, backend=ops.backend(dev), mesh=mesh,
            num_clients=n, horizon=num_epochs, device=dev,
            epoch_offset=epoch_offset, admit=float(admit), hist=bool(hist))
    tap = obs.round_tap("serve") if obs is not None and obs.tap else None

    n_pad = padded_width(n, mesh, pad_to)
    valid = (torch.arange(n_pad, device=dev) < n).float()
    tree = _pad_clients(
        (traffic, harvest, bat, cost, qos, policy, train, valid, charge0,
         streak0, tstate0, hstate0), n, n_pad)
    first, n_local = 0, n_pad
    if mesh is not None:
        tree = sharding.shard_fleet(tree, n_pad, mesh, dev)
        first, n_local = sharding.slab(n_pad, mesh)
    (traffic, harvest, bat, cost, qos, policy, train, valid, charge0,
     streak0, tstate0, hstate0) = tree

    step = _Epoch(traffic, harvest, bat, cost, qos, policy, train, valid,
                  cfg.seed, admit, hist, record_modes, dev, mesh=mesh,
                  first=first, n_pad=n_pad)
    carry = (charge0, streak0, tstate0, hstate0) if hist \
        else (charge0, tstate0, hstate0)
    outs, modes = [], []
    for t in range(num_epochs):
        carry, mode, s = step(carry, epoch_offset + t)
        outs.append(s)
        if record_modes:
            modes.append(mode)
        if tap is not None:
            tap(epoch_offset + t, s)
    stats = {k: torch.stack([o[k] for o in outs]).cpu().numpy()
             for k in outs[0]} if outs else {}
    if obs is not None and tap is None:
        obs.rounds("serve", epoch_offset, stats)
    modes = torch.stack(modes) if record_modes and modes else None
    if mesh is not None:          # the slabs, once, at the end of the run
        carry = sharding.gather_fleet(carry, n_local, mesh)
        if modes is not None:
            modes = sharding.gather_clients(modes, mesh, dim=1)
    if hist:
        charge, streak, tstate, hstate = carry
        streak = streak[:n]
    else:
        (charge, tstate, hstate), streak = carry, None
    return ServeResult(stats=stats, final_charge=charge[:n],
                       modes=modes[:, :n] if modes is not None else None,
                       final_tstate=_slice_clients(tstate, n, n_pad),
                       final_hstate=_slice_clients(hstate, n, n_pad),
                       final_streak=streak)


def run_serve_controlled(traffic, harvest, bat, cost: DecodeCostModel,
                         qos: QoSSpec, policy, cfg: ServeConfig,
                         num_epochs: int, controller, *, train_cost=None,
                         control_every: int = 24, mesh=None,
                         record_modes: bool = False, obs=None,
                         pad_to: int | None = None, checkpoint=None,
                         resume: bool = False, checkpoint_every: int = 1,
                         hist: bool = False, device="cuda"):
    """Closed-loop serving horizon: `simulate_serve` in chunks of
    ``control_every`` epochs, with an `energy.control.ServerController`
    adapting its knobs between chunks — the admission-threshold scale
    (``admit``), and under a ``train_cost`` (`DeviceCostModel` or joules)
    the competing training load's cadence ``T`` and cycles ``E``.  Battery,
    traffic and harvest state flow across chunks through
    ``ServeResult.final_state`` and the absolute epoch index through
    ``epoch_offset``.  Each chunk's stats reach the host once, for the
    controller (and ``obs``, which streams them with a ``serve_chunk``
    span, a ``control`` event and the retrace sentinel).  Under a ``mesh``
    each chunk is sharded (`simulate_serve`) and its stats are replicated,
    so every rank's controller takes the same decisions.

    ``checkpoint=`` / ``resume=`` / ``checkpoint_every=`` persist and
    restore chunk boundaries as in `energy.control.run_controlled`
    (DESIGN.md §13): the serve state ``(charge[, streak], traffic,
    harvest)``, the accumulated ledger, the controller's knobs and trace,
    the RNG base key and a config hash; a resumed run equals an
    uninterrupted one bitwise and re-attaches ``obs`` with a ``resume``
    event in place of a second manifest.

    Returns ``(ServeResult over the full horizon, controller)``.
    """
    n = cfg.num_clients
    if resume and checkpoint is None:
        raise ValueError("resume=True requires checkpoint=")
    dev = resolve_device(device)
    ckptr, cfg_hash, start, restored_stats, state = None, None, 0, None, None
    if checkpoint is not None:
        if record_modes:
            raise ValueError(
                "checkpoint= cannot carry record_modes=True: the (E, N) "
                "mode history is unbounded state the chunk boundary "
                "checkpoints do not persist")
        from repro_torch.checkpoint import resume as resume_lib
        from repro_torch.obs.events import pytree_hash
        ckptr = resume_lib.as_checkpointer(checkpoint)
        cfg_hash = pytree_hash((
            "serve_controlled", traffic, harvest, bat, cost, qos, policy,
            cfg, train_cost, int(control_every), controller.rules,
            controller.bounds, controller.groups, bool(hist)))
        if resume:
            charge = torch.zeros((n,), dtype=torch.float32)
            state_like = ((charge, charge, traffic.init(), harvest.init())
                          if hist else
                          (charge, traffic.init(), harvest.init()))
            rc = resume_lib.restore_run(
                ckptr, kind="serve_controlled", config_hash=cfg_hash,
                state_like=state_like, seed=cfg.seed, controller=controller)
            if rc is not None:
                state, start = rc.state, rc.round_offset
                restored_stats = rc.stats
    save = ckptr is not None and sharding.is_lead(mesh)
    sentinel = None
    if obs is not None:
        from repro_torch.obs.profile import RetraceSentinel
        if start:
            obs.event("resume", run_kind="serve_controlled", round=start,
                      horizon=num_epochs, config_hash=cfg_hash,
                      checkpoint_dir=ckptr.directory)
        else:
            obs.write_manifest(
                "serve_controlled",
                config=(traffic, harvest, bat, cost, qos, policy),
                seed=cfg.seed, backend=ops.backend(device), mesh=mesh,
                num_clients=n, horizon=num_epochs, device=device,
                control_every=control_every)
        sentinel = RetraceSentinel(obs)
    chunks: list[ServeResult] = []
    offset = start

    def acc_stats():
        parts = ([restored_stats] if restored_stats is not None else []) \
            + [c.stats for c in chunks]
        return ({k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
                if parts else {})

    chunk_i = 0
    while offset < num_epochs:
        chunk = min(control_every, num_epochs - offset)
        train = None if train_cost is None else TrainLoad.create(
            controller.client_E(n), train_cost, local_steps=controller.T,
            device=device)
        with contextlib.ExitStack() as stack:
            if obs is not None:
                stack.enter_context(obs.span("serve_chunk"))
            res = simulate_serve(
                traffic, harvest, bat, cost, qos, policy, cfg, chunk,
                train=train, admit=controller.state.admit, mesh=mesh,
                pad_to=pad_to, record_modes=record_modes, state=state,
                epoch_offset=offset, hist=hist, device=device)
        state = res.final_state
        chunks.append(res)
        controller.update(res.stats, n)
        if obs is not None:
            obs.rounds("serve", offset, res.stats)
            obs.event("control", round=offset + chunk, T=controller.state.T,
                      E_mean=float(np.mean(controller.state.E)),
                      admit=controller.state.admit)
            if offset == start:
                sentinel.snapshot()
            else:
                sentinel.check(context=f"serve chunk at epoch {offset}")
        offset += chunk
        chunk_i += 1
        if save and (chunk_i % max(1, checkpoint_every) == 0
                     or offset >= num_epochs):
            resume_lib.save_run(
                ckptr, kind="serve_controlled", round_offset=offset,
                state=state, stats=acc_stats(), controller=controller,
                config_hash=cfg_hash, seed=cfg.seed)
    modes = (torch.cat([c.modes for c in chunks])
             if record_modes and chunks else None)
    if chunks:
        last = chunks[-1]
        final_charge, final_streak = last.final_charge, last.final_streak
        final_tstate, final_hstate = last.final_tstate, last.final_hstate
    elif state is None:
        final_charge = final_streak = final_tstate = final_hstate = None
    else:                       # resumed at or past the horizon
        state = map_tensors(state, lambda t: t.to(dev))
        if hist:
            final_charge, final_streak, final_tstate, final_hstate = state
        else:
            (final_charge, final_tstate, final_hstate), final_streak = \
                state, None
    out = ServeResult(stats=acc_stats(), final_charge=final_charge,
                      modes=modes, final_tstate=final_tstate,
                      final_hstate=final_hstate, final_streak=final_streak)
    return out, controller
