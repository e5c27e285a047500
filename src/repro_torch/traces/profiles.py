"""Bundled, deterministic day profiles for trace-driven replay (port of the
JAX package's ``traces/profiles.py``: numpy, and bitwise the same tables).

The replay layer (`repro_torch.traces.replay`) consumes one format: a
float32 **profile table** of shape ``(T, P)`` — ``T`` slots per day (rows,
the time axis) and ``P`` profiles (columns), each column one
measured-style day.  A single
``(T,)`` trace is the ``P = 1`` degenerate case.  Values are non-negative
"rates": joules per slot for harvest tables, mean requests per slot for
traffic tables.

Two bundled generators stand in for the real datasets the ROADMAP names, so
the subsystem has zero network or file dependency:

* ``solar_profile_table`` — NSRDB-style solar-irradiance day profiles: a
  clear-sky half-sine daylight window (length and peak set by *season*)
  attenuated by a *cloud-cover* regime ("broken" adds a deterministic
  golden-angle ripple, the shape scattered-cumulus GHI traces show).
* ``request_profile_table`` — app-assistant request-log day profiles:
  morning / lunch / evening peaks over a night trough (weekday), a late
  broad weekend plateau, and a launch-day flash-crowd spike.

Everything here is a pure function of its arguments (no RNG), so golden
tests can hard-code expected values and two sessions always agree.  User
supplied measurements enter through ``load_trace`` (``.npy`` / ``.csv``) and
are validated into the same ``(T, P)`` contract; ``rescale`` matches a
table's mean rate to a target (e.g. a fleet's harvest scale in joules) so a
trace and its synthetic twin are directly comparable.
"""
from __future__ import annotations

import os

import numpy as np

SEASONS = ("winter", "equinox", "summer")
CLOUDS = ("clear", "broken", "overcast")
REQUEST_KINDS = ("weekday", "weekend", "launch")

# daylight fraction of the day and clear-sky peak scale per season
_SEASON = {"winter": (1.0 / 3.0, 0.6), "equinox": (0.5, 1.0),
           "summer": (2.0 / 3.0, 1.15)}
# mean attenuation and deterministic ripple depth per cloud regime
_CLOUD = {"clear": (1.0, 0.0), "broken": (0.6, 0.35), "overcast": (0.2, 0.05)}
_GOLDEN = 2.399963  # golden-angle increment: non-repeating ripple phase


def solar_day_profile(season: str = "equinox", cloud: str = "clear",
                      slots: int = 24, peak: float = 1.0) -> np.ndarray:
    """(T,) NSRDB-style solar harvest day profile, joules per slot.

    Clear-sky irradiance is a half-sine over the daylight window (centred on
    noon, length ``day_frac * slots``) raised to a 1.5 airmass exponent;
    the cloud regime multiplies in its mean attenuation and, for "broken",
    a deterministic golden-angle ripple standing in for scattered cumulus.
    """
    if season not in _SEASON:
        raise ValueError(f"unknown season {season!r} (have {SEASONS})")
    if cloud not in _CLOUD:
        raise ValueError(f"unknown cloud regime {cloud!r} (have {CLOUDS})")
    day_frac, season_peak = _SEASON[season]
    atten, ripple = _CLOUD[cloud]
    t = np.arange(slots, dtype=np.float64) + 0.5
    noon = slots / 2.0
    # solar-elevation proxy: cos of the hour angle, clipped at the horizon
    elev = np.cos((t - noon) * np.pi / (day_frac * slots))
    elev = np.where(np.abs(t - noon) < day_frac * slots / 2.0,
                    np.maximum(elev, 0.0), 0.0)
    ghi = peak * season_peak * atten * elev ** 1.5
    ghi = ghi * (1.0 + ripple * np.sin(_GOLDEN * np.arange(slots)))
    return np.maximum(ghi, 0.0).astype(np.float32)


def solar_profile_table(slots: int = 24, peak: float = 1.0) -> np.ndarray:
    """(T, 9) bundle of every season x cloud-regime solar day profile.

    Column order is ``SEASONS`` major, ``CLOUDS`` minor (winter/clear,
    winter/broken, ..., summer/overcast) — documented so calibration and
    golden tests can name columns.
    """
    cols = [solar_day_profile(s, c, slots=slots, peak=peak)
            for s in SEASONS for c in CLOUDS]
    return np.stack(cols, axis=1)


def _bump(slots: int, center: float, width: float, height: float):
    t = np.arange(slots, dtype=np.float64)
    # circular distance so an evening peak wraps smoothly past midnight
    d = np.minimum(np.abs(t - center), slots - np.abs(t - center))
    return height * np.exp(-0.5 * (d / width) ** 2)


def request_day_profile(kind: str = "weekday", slots: int = 24,
                        peak: float = 1.0) -> np.ndarray:
    """(T,) app-assistant request-log day profile, mean requests per slot.

    Shapes follow measured per-minute assistant/query logs: a deep night
    trough, then for *weekday* commute (8h) / lunch (12h) / evening (20h)
    peaks; *weekend* rises late into one broad afternoon plateau; *launch*
    is a weekday with a flash-crowd spike at 19h (the MMPP burst regime's
    trace-side counterpart).
    """
    base = 0.08   # night trough (scaled once with everything else below)
    if kind == "weekday":
        prof = (base + _bump(slots, 8.0 * slots / 24, 1.5 * slots / 24, 0.6)
                + _bump(slots, 12.5 * slots / 24, 1.8 * slots / 24, 0.5)
                + _bump(slots, 20.0 * slots / 24, 2.2 * slots / 24, 1.0))
    elif kind == "weekend":
        prof = (base + _bump(slots, 14.0 * slots / 24, 4.5 * slots / 24, 0.8)
                + _bump(slots, 21.0 * slots / 24, 2.0 * slots / 24, 0.6))
    elif kind == "launch":
        prof = (base + _bump(slots, 8.0 * slots / 24, 1.5 * slots / 24, 0.5)
                + _bump(slots, 19.0 * slots / 24, 0.8 * slots / 24, 3.5)
                + _bump(slots, 21.5 * slots / 24, 1.6 * slots / 24, 1.2))
    else:
        raise ValueError(f"unknown request kind {kind!r} "
                         f"(have {REQUEST_KINDS})")
    return (peak * prof).astype(np.float32)


def request_profile_table(slots: int = 24, peak: float = 1.0) -> np.ndarray:
    """(T, 3) bundle of the request day profiles, ``REQUEST_KINDS`` order."""
    cols = [request_day_profile(k, slots=slots, peak=peak)
            for k in REQUEST_KINDS]
    return np.stack(cols, axis=1)


def rescale(table, mean: float) -> np.ndarray:
    """Scale a profile table so its overall mean rate equals ``mean`` —
    matching a trace's amplitude to a scenario's energy/traffic scale so the
    replay and its calibrated synthetic twin are directly comparable."""
    table = np.asarray(table, np.float32)
    m = float(table.mean())
    if m <= 0.0:
        raise ValueError("cannot rescale an all-zero profile table")
    return (table * (float(mean) / m)).astype(np.float32)


def load_trace(path: str) -> np.ndarray:
    """Load a user-supplied trace from ``.npy`` or ``.csv`` into the
    ``(T, P)`` profile-table contract (a 1-D file becomes ``(T, 1)``).

    Validates what replay assumes: numeric, finite, non-negative, and at
    least one slot per day.  CSV rows are day slots, columns profiles
    (comma-delimited, ``#`` comments allowed) — the natural layout of an
    exported NSRDB hourly file or a per-minute request-log pivot.
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        arr = np.load(path)
    elif ext == ".csv":
        arr = np.loadtxt(path, delimiter=",", comments="#", ndmin=2)
    else:
        raise ValueError(f"unsupported trace format {ext!r} "
                         "(expected .npy or .csv)")
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 1:
        arr = arr[:, None]
    if arr.ndim != 2 or arr.shape[0] < 1 or arr.shape[1] < 1:
        raise ValueError(f"trace {path!r} must be (T,) or (T, P), "
                         f"got shape {arr.shape}")
    if not np.all(np.isfinite(arr)):
        raise ValueError(f"trace {path!r} contains non-finite values")
    if np.any(arr < 0):
        raise ValueError(f"trace {path!r} contains negative rates")
    return arr
