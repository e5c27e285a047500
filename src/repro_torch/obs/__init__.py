"""Run observability of the port: streaming JSONL telemetry and run
manifests (`events`), counters, gauges and the ``obs=`` hook (`metrics`),
profiler spans and the retrace sentinel (`profile`), the reports and the
bench-regression tripwire (`report`), and the fixed-bin fleet histograms
(`hist`).

The ``obs=`` hook of `simulate_fleet`, `simulate_serve`, `run_controlled`
and `run_serve_controlled` (and ``--obs-dir`` on the launchers) is an
`Obs`: one run directory, one ``events.jsonl``, one `RunManifest`.
``obs=None``, the default everywhere, is the un-instrumented run.

    from repro_torch.obs import Obs
    obs = Obs("runs/exp1")
    res, ctrl = run_controlled(..., obs=obs, hist=True)
    # python -m repro_torch.obs.report summary runs/exp1
    # python -m repro_torch.obs.report dist runs/exp1 --out dist.md
"""
from repro_torch.obs.events import (
    EventLog,
    RunManifest,
    git_revision,
    load_events,
    pytree_hash,
)
from repro_torch.obs.hist import (
    FLEET_HIST_SPECS,
    SERVE_HIST_SPECS,
    HistSpec,
    masked_bincount,
    quantiles_from_counts,
    sparkline,
)
from repro_torch.obs.metrics import (
    ENERGY_SEVEN,
    GROUP_KEYS,
    SERVE_LEDGER,
    Counter,
    Gauge,
    MetricStream,
    Obs,
)
from repro_torch.obs.profile import (
    RetraceSentinel,
    annotate,
    profiler_trace,
    reset_spans,
    span,
    span_totals,
)

__all__ = [
    "EventLog", "RunManifest", "git_revision", "load_events", "pytree_hash",
    "FLEET_HIST_SPECS", "SERVE_HIST_SPECS", "HistSpec", "masked_bincount",
    "quantiles_from_counts", "sparkline",
    "ENERGY_SEVEN", "GROUP_KEYS", "SERVE_LEDGER", "Counter", "Gauge",
    "MetricStream", "Obs",
    "RetraceSentinel", "annotate", "profiler_trace", "reset_spans", "span",
    "span_totals",
    "bench_diff", "dist", "render_dist", "render_summary", "summarize",
]

_REPORT = ("bench_diff", "dist", "render_dist", "render_summary", "summarize")


def __getattr__(name):
    # the report names load on first use, so `python -m
    # repro_torch.obs.report` does not find its module imported already
    if name in _REPORT:
        from repro_torch.obs import report
        return getattr(report, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
