"""Trace-driven scenarios of the port: bundled day profiles (`profiles`),
their replay over the fleet as arrival and traffic processes (`replay`),
and the fits of the synthetic processes to traces (`fit`)."""
from repro_torch.traces.fit import (fit_diurnal_poisson, fit_markov_solar,
                                    fit_mmpp, sample_paths)
from repro_torch.traces.profiles import (CLOUDS, REQUEST_KINDS, SEASONS,
                                         load_trace, request_day_profile,
                                         request_profile_table, rescale,
                                         solar_day_profile,
                                         solar_profile_table)
from repro_torch.traces.replay import TraceHarvest, TraceTraffic

__all__ = [
    "fit_diurnal_poisson", "fit_markov_solar", "fit_mmpp", "sample_paths",
    "CLOUDS", "REQUEST_KINDS", "SEASONS", "load_trace",
    "request_day_profile", "request_profile_table", "rescale",
    "solar_day_profile", "solar_profile_table",
    "TraceHarvest", "TraceTraffic",
]
