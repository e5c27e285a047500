"""``repro_torch.obs.hist`` against the JAX package's ``obs/hist.py``: bin
indices bitwise (the same float32 expression, jitted on the reference's
side), validity-weighted counts exact, quantiles and sparklines equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.obs import hist as jhist
from repro_torch.obs import hist as thist

SPECS = [thist.SOC_SPEC, thist.SPEND_SPEC, thist.STREAK_SPEC,
         thist.HistSpec("odd", "x", -1.3, 2.7, 10)]


def _values(spec, n=200_000, seed=0):
    """Values across and beyond [lo, hi), with exact bin edges mixed in."""
    r = np.random.default_rng(seed)
    span = spec.hi - spec.lo
    v = r.uniform(spec.lo - 0.2 * span, spec.hi + 0.2 * span, n)
    v[: spec.bins + 1] = spec.edges()
    return v.astype(np.float32)


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_bin_index_bitwise(spec):
    v = _values(spec)
    want = jax.jit(jhist.bin_index, static_argnums=(1, 2, 3))(
        jnp.asarray(v), spec.lo, spec.hi, spec.bins)
    got = thist.bin_index(torch.tensor(v), spec.lo, spec.hi, spec.bins)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_masked_bincount_counts_exactly(spec):
    v = _values(spec, seed=1)
    valid = (np.arange(v.size) % 5 != 0).astype(np.float32)
    want = jax.jit(jhist.masked_bincount, static_argnums=(2,))(
        jnp.asarray(v), jnp.asarray(valid), jhist.HistSpec(*[
            getattr(spec, f) for f in ("name", "buf", "lo", "hi", "bins")]))
    got = thist.masked_bincount(torch.tensor(v), torch.tensor(valid), spec)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got.sum()) == float(valid.sum())


def test_canonical_specs_match_reference():
    for name, spec in thist.SPECS_BY_NAME.items():
        ref = jhist.SPECS_BY_NAME[name]
        assert (spec.name, spec.buf, spec.lo, spec.hi, spec.bins) == (
            ref.name, ref.buf, ref.lo, ref.hi, ref.bins)
        np.testing.assert_array_equal(spec.edges(), ref.edges())
    assert [s.name for s in thist.FLEET_HIST_SPECS] == [
        s.name for s in jhist.FLEET_HIST_SPECS]
    assert thist.is_hist_key("hist_soc") and not thist.is_hist_key("soc")


@pytest.mark.parametrize("seed", range(4))
def test_quantiles_and_sparkline_match_reference(seed):
    r = np.random.default_rng(seed)
    counts = r.integers(0, 50, 32).astype(np.float32)
    if seed == 3:
        counts[:] = 0
    qs = (0.1, 0.5, 0.95, 0.99, 0.999)
    assert thist.quantiles_from_counts(counts, thist.SOC_SPEC, qs) == \
        jhist.quantiles_from_counts(counts, jhist.SOC_SPEC, qs)
    assert thist.sparkline(counts) == jhist.sparkline(counts)
    with pytest.raises(ValueError, match="bins"):
        thist.quantiles_from_counts(counts[:5], thist.SOC_SPEC)
