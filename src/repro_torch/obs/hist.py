"""Fixed-bin, mask-aware fleet histograms and their host-side quantile /
rendering helpers (port of the JAX package's ``obs/hist.py``).

* `HistSpec` — a fixed-bin histogram over one per-client step-op buffer.
  The bin-edge contract: ``bins`` equal-width bins over ``[lo, hi)``,
  ``edges[b] = lo + (hi - lo) * b / bins``; values below ``lo`` land in
  bin 0 and values at or above ``hi`` in bin ``bins - 1`` (clamped, never
  dropped), so counts always sum to the number of valid clients.
* `bin_index` / `masked_bincount` — the per-round reduction.  The bin index
  is the reference's float32 expression ``floor((v - lo) * f32(scale))``,
  clipped, so indices agree bit for bit; counts are exact integers.
* `quantiles_from_counts` — ``p_q`` is the upper edge of the smallest bin
  whose cumulative count reaches ``q * total``; an all-zero histogram
  reports ``lo``.
* `sparkline` and the canonical specs (``hist_soc``, ``hist_spend``,
  ``hist_streak``; dyadic bin widths, so binning is exact on the dyadic
  test configurations).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class HistSpec:
    """One fixed-bin histogram: ``bins`` equal-width bins over ``[lo, hi)``
    of the per-client step-op buffer ``buf``, reported under stat
    ``name``."""

    name: str      # stat name the counts are reported under ("hist_soc")
    buf: str       # step-op env buffer to bin ("soc", "spend_frac", ...)
    lo: float
    hi: float
    bins: int

    def edges(self) -> np.ndarray:
        """(bins + 1,) bin edges; ``edges[b]``..``edges[b+1]`` bounds bin b
        (the last bin additionally absorbs everything >= hi)."""
        return self.lo + (self.hi - self.lo) \
            * np.arange(self.bins + 1, dtype=np.float64) / self.bins


def bin_index(v: torch.Tensor, lo: float, hi: float, bins: int
              ) -> torch.Tensor:
    """(N,) float32 values -> (N,) int32 bin indices:
    ``floor((v - lo) * f32(bins / (hi - lo)))`` clipped into
    [0, bins - 1], in float32 as the reference computes it."""
    lo32 = torch.tensor(lo, dtype=torch.float32, device=v.device)
    scale = torch.tensor(np.float32(bins / (hi - lo)), device=v.device)
    idx = torch.floor((v.float() - lo32) * scale)
    return idx.clamp(0, bins - 1).to(torch.int32)


def masked_bincount(v: torch.Tensor, valid: torch.Tensor, spec: HistSpec,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(bins,) validity-weighted counts of ``v`` under ``spec`` in
    ``dtype``: padding lanes carry ``valid == 0`` and add nothing.  Summed
    in float64, so the counts of 0/1 weights are exact integers (below
    2^53), rounded once to ``dtype``."""
    idx = bin_index(v, spec.lo, spec.hi, spec.bins).long()
    counts = torch.bincount(idx, weights=valid.double(), minlength=spec.bins)
    return counts.to(dtype)


# dyadic widths (1/32, 1/32, 1) keep the binning arithmetic exact on the
# dyadic test configs; streaks clip at 64 consecutive depleted rounds
SOC_SPEC = HistSpec("hist_soc", "soc", 0.0, 1.0, 32)
SPEND_SPEC = HistSpec("hist_spend", "spend_frac", 0.0, 1.0, 32)
STREAK_SPEC = HistSpec("hist_streak", "streak_out", 0.0, 64.0, 64)

FLEET_HIST_SPECS: tuple[HistSpec, ...] = (SOC_SPEC, SPEND_SPEC, STREAK_SPEC)
SERVE_HIST_SPECS: tuple[HistSpec, ...] = (SOC_SPEC, SPEND_SPEC, STREAK_SPEC)

SPECS_BY_NAME: dict[str, HistSpec] = {
    s.name: s for s in FLEET_HIST_SPECS + SERVE_HIST_SPECS}

HIST_PREFIX = "hist_"


def is_hist_key(key: str) -> bool:
    """True for stat keys carrying histogram counts."""
    return key.startswith(HIST_PREFIX)


def quantiles_from_counts(counts, spec: HistSpec,
                          qs=(0.5, 0.95, 0.99)) -> dict[str, float]:
    """Quantiles from counts, exact up to bin resolution: ``p_q`` is the
    upper edge of the smallest bin whose cumulative count reaches
    ``q * total``; an all-zero histogram reports ``lo`` for every q."""
    counts = np.asarray(counts, np.float64).reshape(-1)
    if counts.shape[0] != spec.bins:
        raise ValueError(f"{spec.name}: got {counts.shape[0]} counts, "
                         f"spec has {spec.bins} bins")
    edges = spec.edges()
    total = counts.sum()
    out = {}
    cum = np.cumsum(counts)
    for q in qs:
        key = f"p{round(q * 100):d}" if q * 100 == round(q * 100) \
            else f"p{q * 100:g}"
        if total <= 0:
            out[key] = float(spec.lo)
            continue
        b = int(np.searchsorted(cum, q * total, side="left"))
        out[key] = float(edges[min(b, spec.bins - 1) + 1])
    return out


_BLOCKS = " ▁▂▃▄▅▆▇█"


def sparkline(counts) -> str:
    """Unicode block-character rendering of one histogram row (scaled to
    the row maximum; an all-zero row renders as spaces)."""
    counts = np.asarray(counts, np.float64).reshape(-1)
    top = counts.max()
    if top <= 0:
        return " " * counts.shape[0]
    lvl = np.ceil(counts / top * (len(_BLOCKS) - 1)).astype(int)
    return "".join(_BLOCKS[i] for i in np.clip(lvl, 0, len(_BLOCKS) - 1))
