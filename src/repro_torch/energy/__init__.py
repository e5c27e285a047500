"""The energy-harvesting subsystem of the port: stochastic arrivals, battery
dynamics, device cost models, the fleet round step and the fleet-scale
battery-gated scheduling simulator with its closed-loop hook for
``core.simulate``, the battery-aware server controller
(``energy.control``), and replayed harvest traces (``TraceHarvest``, from
``repro_torch.traces``)."""
from repro_torch.energy.arrivals import (
    Bernoulli,
    CompoundPoisson,
    DeterministicRenewal,
    MarkovSolar,
    Scaled,
    Sum,
    client_exponential,
    client_keys,
    client_randint,
    client_uniform,
    truncated_poisson,
)
from repro_torch.energy.battery import BatteryConfig, absorb, drain, step
from repro_torch.energy.control import (
    AdmissionRule,
    BudgetRule,
    CadenceRule,
    ControlBounds,
    ControlState,
    ServerController,
    Telemetry,
    run_controlled,
)
from repro_torch.energy.costs import (DEVICE_WATTS, JOULES_PER_BYTE_RADIO,
                                      JOULES_PER_FLOP, DecodeCostModel,
                                      DeviceCostModel, energy_record,
                                      from_dryrun, from_flops)
from repro_torch.energy.fleet import (
    FLEET_POLICIES,
    EnergyLoop,
    FleetConfig,
    FleetResult,
    fleet_mask,
    simulate_fleet,
)
from repro_torch.traces.replay import TraceHarvest

__all__ = [
    "Bernoulli", "CompoundPoisson", "DeterministicRenewal", "MarkovSolar",
    "Scaled", "Sum", "client_exponential", "client_keys", "client_randint",
    "client_uniform", "truncated_poisson",
    "BatteryConfig", "absorb", "drain", "step",
    "AdmissionRule", "BudgetRule", "CadenceRule", "ControlBounds",
    "ControlState", "ServerController", "Telemetry", "run_controlled",
    "DEVICE_WATTS", "JOULES_PER_BYTE_RADIO", "JOULES_PER_FLOP",
    "DecodeCostModel", "DeviceCostModel", "energy_record", "from_dryrun",
    "from_flops",
    "FLEET_POLICIES", "EnergyLoop", "FleetConfig", "FleetResult",
    "fleet_mask", "simulate_fleet", "TraceHarvest",
]
