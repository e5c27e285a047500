"""Serving of the port: the continuous-batching decode engine (`engine`),
its per-stage microbenchmarks (`microbench`), and the battery-gated
serving fleet — request processes (`traffic`), QoS grades and their
pricing (`qos`), admission policies (`admission`) and the fleet serving
simulator with an optional competing training load (`fleet_serve`);
replayed request logs are ``TraceTraffic`` (from ``repro_torch.traces``)."""
from repro_torch.serve.admission import BatteryGated, ChargeGated, EnergyAgnostic
from repro_torch.serve.engine import DecodeEngine, EngineConfig, Finished, Request
from repro_torch.serve.fleet_serve import (ServeConfig, ServeResult, TrainLoad,
                                           run_serve_controlled, simulate_serve)
from repro_torch.serve.microbench import engine_microbench, measured_cost
from repro_torch.serve.qos import DEGRADED, FULL, SHED, QoSSpec
from repro_torch.serve.traffic import MMPP, Constant, DiurnalPoisson
from repro_torch.traces.replay import TraceTraffic

__all__ = [
    "BatteryGated", "ChargeGated", "EnergyAgnostic",
    "DecodeEngine", "EngineConfig", "Finished", "Request",
    "engine_microbench", "measured_cost",
    "ServeConfig", "ServeResult", "TrainLoad",
    "run_serve_controlled", "simulate_serve",
    "DEGRADED", "FULL", "SHED", "QoSSpec",
    "MMPP", "Constant", "DiurnalPoisson", "TraceTraffic",
]
