"""Run reports and the bench-regression tripwire (port of the JAX
package's ``obs/report.py``).

    python -m repro_torch.obs.report summary <run_dir | events.jsonl>
    python -m repro_torch.obs.report dist <run_dir | events.jsonl> [--out F.md]
    python -m repro_torch.obs.report trend BENCH_history.jsonl [--bench NAME]
    python -m repro_torch.obs.report bench-diff BASELINE.json FRESH.json \\
        [--sections round_step] [--rel 0.3]

It reads the event logs of both packages (one schema).

``summary`` folds a run's event stream into one table: the manifest
header (with whichever of torch / jax the manifest names), per-scan round
counts and means of the energy seven / serve ledger (and per-group
columns), span totals, the control-knob trajectory, resume markers and
retrace warnings.  A manifest-only stream, or a ``resume`` event with no
rounds, summarises cleanly.

``dist`` is the distributional report: per-scan quantiles of the
round-scalar telemetry and, for ``hist=True`` runs, the streamed fixed-bin
histograms (whole-run sparkline, p50/p95/p99 from the summed counts and a
per-round quantile table), as markdown (``--out`` writes it to a file,
``--json`` the raw dict).

``trend`` renders a bench trajectory from a ``BENCH_history.jsonl`` (one
line a bench run): headline numbers by git revision.

``bench-diff`` compares a fresh ``BENCH_*.json`` against a baseline
section by section with per-section relative tolerances
(`SECTION_SPECS`): timings may only grow by ``rel``, ratios may only
shrink by ``rel``, and ``p95_frac_depleted`` may only grow by its
tolerance; it exits non-zero on any violation.  Records are matched by
their identity keys; sections or rows absent from the baseline are
skipped, while a section of the baseline missing from the fresh run is a
violation.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from repro_torch.obs import hist as hist_lib
from repro_torch.obs.events import load_events
from repro_torch.obs.metrics import ENERGY_SEVEN, GROUP_KEYS, SERVE_LEDGER

# ------------------------------------------------------------- summary -----


def _fmt_table(headers: list[str], rows: list[list]) -> str:
    cells = [[str(h) for h in headers]] + \
        [[str(c) for c in row] for row in rows]
    widths = [max(len(r[i]) for r in cells) for i in range(len(headers))]
    lines = ["  ".join(c.ljust(w) for c, w in zip(row, widths)).rstrip()
             for row in cells]
    lines.insert(1, "-" * len(lines[0]))
    return "\n".join(lines)


def summarize(events: list[dict]) -> dict:
    """Reduce an event stream to its report dict (also the programmatic
    API — tests and notebooks read this instead of parsing the table)."""
    manifest = next((e for e in events if e["kind"] == "manifest"), None)
    rounds: dict[str, list[dict]] = {}
    spans: dict[str, list[float]] = {}
    controls: list[dict] = []
    retraces: list[dict] = []
    resumes: list[dict] = []
    hist_counts: dict[str, dict[str, int]] = {}
    for e in events:
        if e["kind"] == "round":
            rounds.setdefault(e.get("scan", "?"), []).append(e)
        elif e["kind"] == "span":
            spans.setdefault(e["name"], []).append(float(e["ms"]))
        elif e["kind"] == "control":
            controls.append(e)
        elif e["kind"] == "retrace_warning":
            retraces.append(e)
        elif e["kind"] == "resume":
            resumes.append(e)
        elif e["kind"] == "hist":
            per = hist_counts.setdefault(e.get("scan", "?"), {})
            per[e["name"]] = per.get(e["name"], 0) + 1

    scan_stats = {}
    for scan, evs in rounds.items():
        keys = [k for k in ENERGY_SEVEN + SERVE_LEDGER if k in evs[0]]
        # min/max, not stream position: the unordered in-scan tap may land
        # events slightly out of order
        idx = [e["round"] for e in evs if "round" in e]
        scan_stats[scan] = {
            "rounds": len(evs),
            "first_round": min(idx) if idx else None,
            "last_round": max(idx) if idx else None,
            "means": {k: float(np.mean([float(e[k]) for e in evs]))
                      for k in keys},
        }
        gkeys = [k for k in GROUP_KEYS if k in evs[0]]
        if gkeys:
            # (G,) per-group means over the streamed rounds — the rows the
            # grouped BudgetRule acts on must survive into the report
            scan_stats[scan]["group_means"] = {
                k: np.mean([np.asarray(e[k], np.float64) for e in evs],
                           axis=0).tolist() for k in gkeys}
    return {
        "manifest": manifest,
        "scans": scan_stats,
        "spans": {k: {"count": len(v), "total_ms": round(sum(v), 3),
                      "mean_ms": round(sum(v) / len(v), 3)}
                  for k, v in spans.items()},
        "controls": controls,
        "retrace_warnings": retraces,
        "resumes": resumes,
        "hists": hist_counts,
        "events": len(events),
    }


_NOT_FRAMEWORKS = ("python", "numpy", "cuda")


def _framework(man: dict) -> str:
    """``<framework>=<version>`` for the array framework the manifest
    names: torch in the port's manifests, jax in the reference's."""
    packages = man.get("packages") or {}
    name = next((k for k in packages if k not in _NOT_FRAMEWORKS), None)
    return f"{name}={packages[name]}" if name else "framework=None"


def render_summary(summary: dict) -> str:
    out = []
    man = summary["manifest"]
    if man:
        out.append(f"run {man.get('run_id')}  [{man.get('run_kind')}]")
        out.append(f"  git={man.get('git_rev')}  "
                   f"{_framework(man)}  "
                   f"backend={man.get('backend')}  "
                   f"devices={man.get('device_count')}  "
                   f"mesh={man.get('mesh_shape')}  "
                   f"config_hash={man.get('config_hash')}")
    elif summary.get("resumes"):
        out.append("(no manifest event — stream starts at a resume; the "
                   "original manifest lives in the pre-crash log)")
    else:
        out.append("(no manifest event — an older or truncated log)")
    out.append(f"  events={summary['events']}")
    for r in summary.get("resumes", ()):
        out.append(f"  resumed {r.get('run_kind')} at round "
                   f"{r.get('round')}/{r.get('horizon')} from "
                   f"{r.get('checkpoint_dir')}")
    if not summary["scans"]:
        out.append("  (no round events)")
    for scan, s in summary["scans"].items():
        out.append(f"\n{scan}: rounds {s['first_round']}..{s['last_round']} "
                   f"({s['rounds']} emitted)")
        rows = [[k, f"{v:.6g}"] for k, v in s["means"].items()]
        out.append(_fmt_table(["stat (mean/round)", "value"], rows))
        for k, vec in s.get("group_means", {}).items():
            out.append(f"  {k} (per-group mean): "
                       + "  ".join(f"{v:.6g}" for v in vec))
        for name, n_ev in summary.get("hists", {}).get(scan, {}).items():
            out.append(f"  {name}: {n_ev} hist events "
                       f"(`report dist` for quantiles)")
    for scan, per in summary.get("hists", {}).items():
        if scan not in summary["scans"]:
            for name, n_ev in per.items():
                out.append(f"\n{scan}: {name}: {n_ev} hist events "
                           f"(`report dist` for quantiles)")
    if summary["spans"]:
        out.append("\nspans:")
        rows = [[name, s["count"], f"{s['total_ms']:.3f}",
                 f"{s['mean_ms']:.3f}"]
                for name, s in sorted(summary["spans"].items())]
        out.append(_fmt_table(["span", "count", "total ms", "mean ms"], rows))
    if summary["controls"]:
        out.append("\ncontrol trajectory:")
        rows = [[c.get("round"), c.get("T"), c.get("E_mean"),
                 c.get("admit")] for c in summary["controls"]]
        out.append(_fmt_table(["round", "T", "E_mean", "admit"], rows))
    for w in summary["retrace_warnings"]:
        out.append(f"\nWARNING retrace: {w.get('fn')} grew by "
                   f"{w.get('delta')} entries ({w.get('context', '')})")
    return "\n".join(out)


# ------------------------------------------------------------------ dist ----

_DIST_QS = (0.5, 0.95, 0.99)


def dist(events: list[dict], qs=_DIST_QS) -> dict:
    """Reduce an event stream to its distributional report.

    Two layers, both recomputed exactly from the stream:

    * **round-scalar quantiles** — ``np.percentile`` over each telemetry
      channel's per-round values from the ``round`` events (e.g.
      ``p95(frac_depleted)``, the depletion tail).
    * **histogram quantiles** — for ``hist=True`` runs, the ``hist`` events'
      integer counts are summed per histogram and `hist.quantiles_from_counts`
      extracts p50/p95/p99 under the stream's own ``hist_spec`` bin-edge
      contract (falling back to the canonical spec table for older streams),
      plus a per-round quantile row for each streamed round.
    """
    rounds: dict[str, list[dict]] = {}
    hist_rows: dict[tuple[str, str], list[dict]] = {}
    specs: dict[str, hist_lib.HistSpec] = {}
    manifest = None
    for e in events:
        if e["kind"] == "round":
            rounds.setdefault(e.get("scan", "?"), []).append(e)
        elif e["kind"] == "hist":
            hist_rows.setdefault((e.get("scan", "?"), e["name"]),
                                 []).append(e)
        elif e["kind"] == "hist_spec":
            specs[e["name"]] = hist_lib.HistSpec(
                e["name"], e.get("buf", "?"), float(e["lo"]), float(e["hi"]),
                int(e["bins"]))
        elif e["kind"] == "manifest" and manifest is None:
            manifest = e

    def qkey(q):
        return f"p{q * 100:g}"

    scans: dict[str, dict] = {}
    for scan, evs in sorted(rounds.items()):
        keys = [k for k in ENERGY_SEVEN + SERVE_LEDGER if k in evs[0]]
        scans.setdefault(scan, {})["scalar_quantiles"] = {
            k: {qkey(q): float(np.percentile(
                    [float(e[k]) for e in evs], q * 100)) for q in qs}
            for k in keys}
        scans[scan]["rounds"] = len(evs)
    for (scan, name), evs in sorted(hist_rows.items()):
        spec = specs.get(name) or hist_lib.SPECS_BY_NAME.get(name)
        if spec is None:
            continue
        evs = sorted(evs, key=lambda e: e.get("round", 0))
        counts = [np.asarray(e["counts"], np.float64) for e in evs]
        total = np.sum(counts, axis=0)
        entry = {
            "spec": {"buf": spec.buf, "lo": spec.lo, "hi": spec.hi,
                     "bins": spec.bins},
            "rounds": len(evs),
            "total_counts": [int(c) for c in total],
            "sparkline": hist_lib.sparkline(total),
            "quantiles": hist_lib.quantiles_from_counts(total, spec, qs),
            "per_round": [
                dict(round=e.get("round"),
                     **hist_lib.quantiles_from_counts(c, spec, qs))
                for e, c in zip(evs, counts)],
        }
        scans.setdefault(scan, {}).setdefault("hists", {})[name] = entry
    return {"manifest": manifest, "scans": scans,
            "quantiles": [qkey(q) for q in qs]}


def render_dist(report: dict) -> str:
    """Markdown rendering of a `dist` report (the CI artifact)."""
    qcols = report["quantiles"]
    out = ["# Distributional telemetry"]
    man = report.get("manifest")
    if man:
        out.append(f"\nrun `{man.get('run_id')}` [{man.get('run_kind')}] — "
                   f"git `{man.get('git_rev')}`, backend "
                   f"`{man.get('backend')}`, devices "
                   f"{man.get('device_count')}")
    if not report["scans"]:
        out.append("\n_(no round or hist events in this stream)_")
    for scan, s in report["scans"].items():
        out.append(f"\n## {scan} ({s.get('rounds', 0)} rounds)")
        sq = s.get("scalar_quantiles")
        if sq:
            out.append("\n### per-round scalar quantiles\n")
            out.append("| stat | " + " | ".join(qcols) + " |")
            out.append("|---" * (len(qcols) + 1) + "|")
            for k, qv in sq.items():
                out.append("| " + k + " | "
                           + " | ".join(f"{qv[q]:.6g}" for q in qcols)
                           + " |")
        for name, h in s.get("hists", {}).items():
            spec = h["spec"]
            out.append(f"\n### {name} — `{spec['buf']}` over "
                       f"[{spec['lo']:g}, {spec['hi']:g}) in "
                       f"{spec['bins']} bins, {h['rounds']} rounds")
            out.append(f"\n```\n{h['sparkline']}\n```")
            out.append("\nwhole-run: "
                       + ", ".join(f"{q}={h['quantiles'][q]:g}"
                                   for q in qcols))
            out.append("\n| round | " + " | ".join(qcols) + " |")
            out.append("|---" * (len(qcols) + 1) + "|")
            for row in h["per_round"]:
                out.append("| " + str(row["round"]) + " | "
                           + " | ".join(f"{row[q]:g}" for q in qcols)
                           + " |")
    return "\n".join(out)


# ------------------------------------------------------------------ trend ---

def load_history(path: str) -> list[dict]:
    """Parse a ``BENCH_history.jsonl`` trajectory (blank lines and torn
    trailing writes are skipped, like `events.load_events`)."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return records


def render_trend(records: list[dict], bench: str | None = None) -> str:
    """One table per benchmark: headline numbers by git rev, in file
    (= chronological append) order."""
    by_bench: dict[str, list[dict]] = {}
    for r in records:
        by_bench.setdefault(r.get("bench", "?"), []).append(r)
    if bench is not None:
        by_bench = {k: v for k, v in by_bench.items() if k == bench}
        if not by_bench:
            return f"(no history records for bench {bench!r})"
    if not by_bench:
        return "(empty history)"
    out = []
    for name, recs in sorted(by_bench.items()):
        cols: list[str] = []
        for r in recs:
            for k in r.get("headline", {}):
                if k not in cols:
                    cols.append(k)
        rows = [[str(r.get("git_rev", "?"))[:12],
                 r.get("recorded", "?")]
                + [(f"{r['headline'][k]:.6g}"
                    if isinstance(r.get("headline", {}).get(k), float)
                    else str(r.get("headline", {}).get(k, "-")))
                   for k in cols]
                for r in recs]
        out.append(f"{name}: {len(recs)} run(s)")
        out.append(_fmt_table(["git_rev", "recorded"] + cols, rows))
        out.append("")
    return "\n".join(out).rstrip()


# ----------------------------------------------------------- bench-diff ----

# Per-section tripwire spec: records are matched on whichever of ``match``
# keys both sides carry; ``slower`` keys fail when fresh > baseline*(1+rel)
# (timings), ``smaller`` keys fail when fresh < baseline*(1-rel) (ratios /
# quality metrics where shrinking is the regression).
SECTION_SPECS: dict[str, dict] = {
    "round_step": {
        "match": ("num_clients", "policy"),
        "slower": ("unfused_ms", "lax_fused_ms", "pallas_ms"),
        "smaller": ("speedup_fused_vs_unfused",),
        "rel": 0.30,
    },
    "results": {
        "match": ("num_clients", "policy", "process", "traffic", "scan"),
        "slower": ("run_s",),
        "smaller": (),
        "rel": 0.50,
    },
    "sharded": {
        "match": ("num_clients", "policy", "process", "traffic", "scan"),
        "slower": ("run_s",),
        "smaller": (),
        "rel": 0.50,
    },
    # decode-engine per-stage microbench: prefill / decode
    # step / slot insert, measured warm on materialized outputs.  Tolerance
    # is very loose — the stages are single-digit-ms on CI CPUs, where a
    # loaded runner alone moves them 2x — but the regressions this guards
    # against (a per-call retrace, a lost fusion) are 10-100x, so a stage
    # going 2.5x slower (or vanishing) still trips.  ``insert_ms`` rides in
    # the record untripwired: at ~0.1 ms it swings 4x+ with runner load,
    # and an insert regression shows up in decode_step_ms's cache anyway.
    "engine": {
        "match": ("arch", "slots", "cache_len"),
        "slower": ("prefill_ms", "decode_step_ms"),
        "smaller": (),
        "rel": 1.50,
    },
    # depletion-tail guard: the scale benches record
    # p95(frac_depleted) per config — a *fairness/sustainability* metric,
    # not a timing, so its tolerance is tight (the simulators are
    # deterministic per seed; growth means the physics or the schedule
    # changed, which must be deliberate)
    "percentiles": {
        "match": ("scan", "regime", "num_clients", "policy"),
        "slower": ("p95_frac_depleted",),
        "smaller": (),
        "rel": 0.25,
    },
}


def _match_key(rec: dict, keys: tuple) -> tuple:
    return tuple((k, rec[k]) for k in keys if k in rec)


def bench_diff(baseline: dict, fresh: dict, *, sections=None,
               rel: float | None = None) -> list[dict]:
    """Compare two BENCH dicts; returns the violation list (empty == pass).

    Only sections named in `SECTION_SPECS` (optionally narrowed by
    ``sections``) are compared; ``rel`` overrides every section's tolerance
    when given.  A section/row missing from the *baseline* is skipped (new
    benchmarks, older baselines); missing from the *fresh* side is a
    violation.
    """
    violations = []
    names = sections if sections else list(SECTION_SPECS)
    for name in names:
        spec = SECTION_SPECS.get(name)
        if spec is None:
            raise ValueError(f"no tripwire spec for section {name!r} "
                             f"(known: {sorted(SECTION_SPECS)})")
        base_rows = baseline.get(name)
        if not base_rows:
            continue                      # nothing committed to regress from
        tol = spec["rel"] if rel is None else rel
        fresh_rows = fresh.get(name)
        if not fresh_rows:
            violations.append({"section": name, "key": None, "metric": None,
                               "reason": "section missing from fresh run"})
            continue
        fresh_by_key = {_match_key(r, spec["match"]): r for r in fresh_rows}
        for brow in base_rows:
            key = _match_key(brow, spec["match"])
            frow = fresh_by_key.get(key)
            if frow is None:
                continue                  # row not in this (e.g. smoke) sweep
            for metric in spec["slower"]:
                if metric in brow and metric in frow \
                        and frow[metric] > brow[metric] * (1.0 + tol):
                    violations.append({
                        "section": name, "key": dict(key), "metric": metric,
                        "baseline": brow[metric], "fresh": frow[metric],
                        "rel": round(frow[metric] / max(brow[metric], 1e-12)
                                     - 1.0, 3),
                        "reason": f"regressed beyond +{tol:.0%}"})
            for metric in spec["smaller"]:
                if metric in brow and metric in frow \
                        and frow[metric] < brow[metric] * (1.0 - tol):
                    violations.append({
                        "section": name, "key": dict(key), "metric": metric,
                        "baseline": brow[metric], "fresh": frow[metric],
                        "rel": round(frow[metric] / max(brow[metric], 1e-12)
                                     - 1.0, 3),
                        "reason": f"shrank beyond -{tol:.0%}"})
    return violations


def render_diff(violations: list[dict], baseline_path: str,
                fresh_path: str) -> str:
    if not violations:
        return f"bench-diff OK: {fresh_path} within tolerance of " \
               f"{baseline_path}"
    rows = [[v["section"],
             " ".join(f"{k}={val}" for k, val in (v["key"] or {}).items()),
             v["metric"] or "-",
             v.get("baseline", "-"), v.get("fresh", "-"),
             (f"{v['rel']:+.1%}" if "rel" in v else "-"), v["reason"]]
            for v in violations]
    return (f"bench-diff FAILED: {len(violations)} regression(s) in "
            f"{fresh_path} vs {baseline_path}\n"
            + _fmt_table(["section", "record", "metric", "baseline", "fresh",
                          "delta", "reason"], rows))


# ----------------------------------------------------------------- CLI -----
def _events_path(arg: str) -> str:
    if os.path.isdir(arg):
        return os.path.join(arg, "events.jsonl")
    return arg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs.report",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("summary", help="aggregate a run's events.jsonl")
    s.add_argument("run", help="run directory or events.jsonl path")
    s.add_argument("--json", action="store_true",
                   help="emit the summary dict as JSON instead of a table")
    di = sub.add_parser("dist", help="distributional report (quantiles + "
                                     "histograms) from a run's events.jsonl")
    di.add_argument("run", help="run directory or events.jsonl path")
    di.add_argument("--json", action="store_true",
                    help="emit the dist dict as JSON instead of markdown")
    di.add_argument("--out", default=None,
                    help="also write the rendering to this file (the CI "
                         "artifact)")
    t = sub.add_parser("trend", help="bench trajectory from "
                                     "BENCH_history.jsonl")
    t.add_argument("history", help="path to BENCH_history.jsonl")
    t.add_argument("--bench", default=None,
                   help="restrict to one benchmark name")
    t.add_argument("--json", action="store_true",
                   help="emit the parsed records as JSON")
    d = sub.add_parser("bench-diff",
                       help="tripwire a fresh BENCH_*.json against a "
                            "committed baseline")
    d.add_argument("baseline")
    d.add_argument("fresh")
    d.add_argument("--sections", default=None,
                   help="comma-separated subset of sections to compare "
                        f"(default: all of {sorted(SECTION_SPECS)})")
    d.add_argument("--rel", type=float, default=None,
                   help="override every section's relative tolerance")
    args = ap.parse_args(argv)

    if args.cmd in ("summary", "dist"):
        path = _events_path(args.run)
        if not os.path.exists(path):
            print(f"error: no event stream at {path} (expected a run "
                  f"directory holding events.jsonl, or the file itself)",
                  file=sys.stderr)
            return 2
        events = load_events(path)
        if args.cmd == "summary":
            summary = summarize(events)
            print(json.dumps(summary, indent=1) if args.json
                  else render_summary(summary))
            return 0
        report = dist(events)
        text = json.dumps(report, indent=1) if args.json \
            else render_dist(report)
        print(text)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text + "\n")
        return 0

    if args.cmd == "trend":
        if not os.path.exists(args.history):
            print(f"error: no bench history at {args.history}",
                  file=sys.stderr)
            return 2
        records = load_history(args.history)
        print(json.dumps(records, indent=1) if args.json
              else render_trend(records, bench=args.bench))
        return 0

    with open(args.baseline) as f:
        baseline = json.load(f)
    with open(args.fresh) as f:
        fresh = json.load(f)
    sections = args.sections.split(",") if args.sections else None
    violations = bench_diff(baseline, fresh, sections=sections, rel=args.rel)
    print(render_diff(violations, args.baseline, args.fresh))
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
