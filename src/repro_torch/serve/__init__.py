"""Serving of the port: the continuous-batching decode engine (`engine`)
and its per-stage microbenchmarks (`microbench`)."""
from repro_torch.serve.engine import DecodeEngine, EngineConfig, Finished, Request
from repro_torch.serve.microbench import engine_microbench, measured_cost

__all__ = ["DecodeEngine", "EngineConfig", "Finished", "Request",
           "engine_microbench", "measured_cost"]
