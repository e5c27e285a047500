"""Calibrate the synthetic processes against traces or replayed sample
paths (port of the JAX package's ``traces/fit.py``).

Each ``fit_*`` consumes a plain sample array — ``(R,)`` one path or
``(R, N)`` per-client paths, e.g. `sample_paths` over a `TraceHarvest` /
`TraceTraffic` replay or recorded per-round measurements — and returns a
ready-to-run port process (`MarkovSolar`, `DiurnalPoisson`, `MMPP`) sized
to ``num_clients``, every fitted parameter broadcast per client.  The
estimators are the reference's numpy code, so on the same paths the
fitted parameters are bitwise the reference's:

* `fit_markov_solar` — a 2-means split in log space, regime means by
  moment matching and stay probabilities by pooled transition counts,
  refined by Baum-Welch EM on the 2-state exponential-emission chain.
* `fit_diurnal_poisson` — least squares of the time-of-day bin means on
  the first Fourier harmonic: base, relative swing and phase.
* `fit_mmpp` — the 2-means initialisation and the same Baum-Welch
  machinery with Poisson emissions.

Baum-Welch runs on the host in numpy, as the reference's does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng
from repro_torch.energy.arrivals import MarkovSolar, map_device
from repro_torch.serve.traffic import MMPP, DiurnalPoisson

_EPS = 1e-6


def sample_paths(process, num_rounds: int, seed=0) -> np.ndarray:
    """(R, N) sample paths of any arrival or traffic process: round ``r``
    draws with ``fold_in(key, r)``, the fleet loop's per-round key
    derivation (`energy.fleet`), on the process's device.  (The serving
    loop folds a per-stream index on top, so its realisations differ at
    the same seed; the law, which is what the estimators read, does
    not.)"""
    dev = map_device(process)
    key = (seed.to(dev) if isinstance(seed, torch.Tensor)
           else prng.PRNGKey(seed, dev))
    state, hs = process.init(), []
    for r in range(num_rounds):
        h, state = process.sample(prng.fold_in(key, r), r, state)
        hs.append(h)
    return torch.stack(hs).cpu().numpy()


def _as_paths(x) -> np.ndarray:
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    if x.ndim != 2 or x.shape[0] < 2:
        raise ValueError(f"need (R,) or (R, N) samples with R >= 2, "
                         f"got shape {x.shape}")
    return x


def _two_means_threshold(x: np.ndarray, iters: int = 32) -> float:
    """1-D 2-means cluster boundary, started at the 10th / 90th
    percentiles."""
    lo, hi = np.percentile(x, 10.0), np.percentile(x, 90.0)
    if hi <= lo:
        return float(lo)
    for _ in range(iters):
        thr = 0.5 * (lo + hi)
        low, high = x[x <= thr], x[x > thr]
        if low.size == 0 or high.size == 0:
            break
        lo2, hi2 = float(low.mean()), float(high.mean())
        if lo2 == lo and hi2 == hi:
            break
        lo, hi = lo2, hi2
    return 0.5 * (lo + hi)


def _stay_probs(high: np.ndarray) -> tuple[float, float]:
    """Pooled transition counts on an (R, N) boolean regime labelling ->
    (p_stay_low, p_stay_high); 0.5 for a regime never visited."""
    a, b = high[:-1], high[1:]

    def stay(mask_from, mask_stay):
        total = float(mask_from.sum())
        return float((mask_from & mask_stay).sum()) / total if total else 0.5

    return stay(~a, ~b), stay(a, b)


def _regime_means(x, high) -> tuple[float, float]:
    lowv, highv = x[~high], x[high]
    hi = float(highv.mean()) if highv.size else float(x.max())
    lo = float(lowv.mean()) if lowv.size else 0.0
    return lo, hi


def _moment_init(x: np.ndarray, family: str):
    """2-means labels -> regime means and pooled stay probabilities; an
    exponential mixture is split in log space, where its regimes sit
    ``log(hi / lo)`` apart."""
    y = np.log(x + 1e-9) if family == "exponential" else x
    high = y > _two_means_threshold(y.ravel())
    lo, hi = _regime_means(x.ravel(), high.ravel())
    p_lo, p_hi = _stay_probs(high)
    return lo, hi, p_lo, p_hi


def _log_emissions(x, mean: float, family: str) -> np.ndarray:
    m = max(mean, _EPS)
    if family == "exponential":
        return -x / m - np.log(m)
    # Poisson: the x! term is the same in both states and cancels
    return x * np.log(m) - m


def _baum_welch(x: np.ndarray, lo: float, hi: float, p_lo: float,
                p_hi: float, family: str, iters: int):
    """Baum-Welch on a 2-state regime chain observed per client: ``x`` is
    (R, N), every column a path of the same pooled chain, so the scaled
    forward-backward runs vectorised over the clients and the M-step pools
    their statistics (the gamma-weighted mean for both families).  Returns
    ``(lo, hi, p_stay_lo, p_stay_hi)``."""
    R, N = x.shape
    pi = np.full(2, 0.5)
    prev = None
    for _ in range(iters):
        A = np.array([[p_lo, 1.0 - p_lo], [1.0 - p_hi, p_hi]])
        logB = np.stack([_log_emissions(x, lo, family),
                         _log_emissions(x, hi, family)], axis=-1)
        B = np.exp(logB - logB.max(axis=-1, keepdims=True))  # (R, N, 2)
        alpha = np.empty((R, N, 2))
        a = pi[None, :] * B[0]
        alpha[0] = a / np.maximum(a.sum(-1, keepdims=True), _EPS)
        for t in range(1, R):
            a = (alpha[t - 1] @ A) * B[t]
            alpha[t] = a / np.maximum(a.sum(-1, keepdims=True), _EPS)
        beta = np.empty((R, N, 2))
        beta[-1] = 1.0
        for t in range(R - 2, -1, -1):
            b = (B[t + 1] * beta[t + 1]) @ A.T
            beta[t] = b / np.maximum(b.sum(-1, keepdims=True), _EPS)
        gamma = alpha * beta
        gamma /= np.maximum(gamma.sum(-1, keepdims=True), _EPS)
        xi = (alpha[:-1, :, :, None] * A[None, None]
              * (B[1:] * beta[1:])[:, :, None, :])
        xi /= np.maximum(xi.sum((-2, -1), keepdims=True), _EPS)
        trans = xi.sum((0, 1))                      # (2, 2) pooled counts
        occ = gamma[:-1].sum((0, 1))                # (2,) pooled occupancy
        p_lo = float(trans[0, 0] / max(occ[0], _EPS))
        p_hi = float(trans[1, 1] / max(occ[1], _EPS))
        w = gamma.sum((0, 1))
        lo = float((gamma[..., 0] * x).sum() / max(w[0], _EPS))
        hi = float((gamma[..., 1] * x).sum() / max(w[1], _EPS))
        pi = gamma[0].mean(axis=0)
        if hi < lo:                                 # state 1 stays the high one
            lo, hi, p_lo, p_hi = hi, lo, p_hi, p_lo
            pi = pi[::-1]
        cur = (lo, hi, p_lo, p_hi)
        if prev is not None and max(abs(a - b)
                                    for a, b in zip(cur, prev)) < 1e-5:
            break
        prev = cur
    return lo, hi, min(p_lo, 1.0), min(p_hi, 1.0)


def fit_markov_solar(paths, num_clients: int | None = None, *,
                     em_iters: int = 25, device=None) -> MarkovSolar:
    """A `MarkovSolar` fitted to (R,) / (R, N) harvest samples."""
    x = _as_paths(paths)
    n = x.shape[1] if num_clients is None else num_clients
    night, day, p_night, p_day = _baum_welch(
        x, *_moment_init(x, "exponential"), "exponential", em_iters)
    return MarkovSolar.create(n, p_stay_day=p_day, p_stay_night=p_night,
                              day_mean=day, night_mean=night, device=device)


def fit_diurnal_poisson(counts, num_clients: int | None = None, *,
                        period: int = 24, t0: int = 0,
                        max_requests: int = 16, device=None
                        ) -> DiurnalPoisson:
    """A `DiurnalPoisson` fitted to (R,) / (R, N) request counts observed
    from epoch ``t0``: with ``rbar[tau]`` the mean count in day slot
    ``tau`` and ``theta = 2 pi tau / period``, ``base = mean(rbar)``,
    ``a = (2/P) sum rbar sin(theta)``, ``b = (2/P) sum rbar cos(theta)``,
    ``swing = sqrt(a^2 + b^2) / base`` and ``phase = (P / 2 pi) atan2(b,
    a)``."""
    x = _as_paths(counts)
    n = x.shape[1] if num_clients is None else num_clients
    tau = (t0 + np.arange(x.shape[0])) % period
    rbar = np.zeros(period)
    for s in range(period):
        sel = x[tau == s]
        rbar[s] = sel.mean() if sel.size else 0.0
    theta = 2.0 * np.pi * np.arange(period) / period
    base = float(rbar.mean())
    a = 2.0 / period * float((rbar * np.sin(theta)).sum())
    b = 2.0 / period * float((rbar * np.cos(theta)).sum())
    swing = min(1.0, float(np.hypot(a, b)) / max(base, _EPS))
    phase = float(period / (2.0 * np.pi) * np.arctan2(b, a)) % period
    return DiurnalPoisson.create(n, base=base, swing=swing, phase=phase,
                                 period=period, max_requests=max_requests,
                                 device=device)


def fit_mmpp(counts, num_clients: int | None = None, *, em_iters: int = 25,
             max_requests: int = 16, device=None) -> MMPP:
    """An `MMPP` fitted to (R,) / (R, N) request counts."""
    x = _as_paths(counts)
    n = x.shape[1] if num_clients is None else num_clients
    calm, hot, p_calm, p_burst = _baum_welch(
        x, *_moment_init(x, "poisson"), "poisson", em_iters)
    return MMPP.create(n, p_stay_calm=p_calm, p_stay_burst=p_burst,
                       calm_rate=calm, burst_rate=hot,
                       max_requests=max_requests, device=device)
