"""Core: the paper's contribution, energy-aware scheduling and scaled
aggregation (port of the JAX package's ``core``).

Scheduling is stateless (assumed renewal cycles ``E``); the physical
energy layer plugs into ``simulate`` through ``energy=`` (an
``energy.fleet.EnergyLoop``).
"""
from repro_torch.core.scheduling import (
    EnergyProfile,
    Policy,
    aggregation_scale,
    always_schedule,
    energy_feasible,
    greedy_schedule,
    participation_mask,
    sustainable_schedule,
    wait_all_schedule,
)
from repro_torch.core.aggregation import (
    aggregate,
    accumulate_client_delta,
    apply_accumulated,
    fedavg_aggregate,
    scaled_delta_aggregate,
    zeros_like_fp32,
)
from repro_torch.core.round import (
    FedConfig,
    finish_sequential_round,
    local_update,
    micro_value_and_grad,
    parallel_round,
    replay_round,
    run_rounds,
    sequential_client_step,
)
from repro_torch.core.convergence import Theorem1Constants
from repro_torch.core.simulate import SimResult, simulate

__all__ = [
    "EnergyProfile", "Policy", "aggregation_scale", "always_schedule",
    "energy_feasible", "greedy_schedule", "participation_mask",
    "sustainable_schedule", "wait_all_schedule",
    "aggregate", "accumulate_client_delta", "apply_accumulated",
    "fedavg_aggregate", "scaled_delta_aggregate", "zeros_like_fp32",
    "FedConfig", "finish_sequential_round", "local_update",
    "micro_value_and_grad", "parallel_round", "replay_round", "run_rounds",
    "sequential_client_step", "Theorem1Constants", "SimResult", "simulate",
]
