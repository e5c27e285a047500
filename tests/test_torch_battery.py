"""``repro_torch.energy.battery`` against the JAX package's ``battery.py``
under ``jit``: XLA's CPU backend contracts ``charge - charge * leak`` into
one fused multiply-add, and the port makes the same contraction, so
absorb, drain and step are bitwise equal on random non-dyadic inputs at
N = 1e6; ``fma_f32`` is a correctly rounded fused multiply-add."""
from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

from repro.energy import battery as jb
from repro_torch.energy import battery as tb

N = 1_000_000


def _fleet(seed, per_client=()):
    """Random non-dyadic charge and harvest; the battery fields named in
    ``per_client`` per client, the others one value for the fleet."""
    r = np.random.default_rng(seed)
    charge = r.uniform(0, 3, N).astype(np.float32)
    harvest = r.exponential(0.7, N).astype(np.float32)
    fields = dict(capacity=2.5, leak=0.02, init_charge=0.5)
    draws = dict(capacity=(1, 3), leak=(0, 0.2), init_charge=(-1, 4))
    for f in per_client:
        fields[f] = r.uniform(*draws[f], N).astype(np.float32)
    return charge, harvest, fields


@pytest.mark.parametrize("per_client", [
    (), ("capacity",), ("capacity", "init_charge")])
def test_absorb_drain_step_bitwise_at_fleet_scale(per_client):
    """One leak for the fleet, other fields scalar or per client: bitwise
    against the jitted reference, fused multiply-add included."""
    charge, harvest, fields = _fleet(0, per_client)
    consume = np.where(np.arange(N) % 3 == 0, 0.75, 0.0).astype(np.float32)
    jcfg = jb.BatteryConfig(**fields)
    tcfg = tb.BatteryConfig(**{k: torch.as_tensor(v) for k, v in
                               fields.items()})
    ja, jaux = jax.jit(jb.absorb)(jcfg, charge, harvest)
    ta, taux = tb.absorb(tcfg, torch.tensor(charge), torch.tensor(harvest))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    for k in ("leaked", "overflow"):
        np.testing.assert_array_equal(taux[k].numpy(), np.asarray(jaux[k]))
    js, _ = jax.jit(jb.step)(jcfg, charge, harvest, consume)
    ts, _ = tb.step(tcfg, torch.tensor(charge), torch.tensor(harvest),
                    torch.tensor(consume))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tb.drain(ta, torch.tensor(consume)).numpy(),
        np.asarray(jax.jit(jb.drain)(ja, consume)))
    np.testing.assert_array_equal(
        tcfg.init(N).numpy(), np.asarray(jcfg.init(N)))


def test_a_per_client_leak_follows_the_fleet_scan():
    """Jitted on its own with a per-client leak, the reference's absorb
    keeps the product in a separate pass and does not contract; its fleet
    scan does (``tests/test_torch_fleet.py`` holds the port's per-client
    battery bitwise against that scan).  The port always contracts: on its
    own, it is at most 2 ulp from the reference's standalone absorb."""
    charge, harvest, fields = _fleet(3, ("leak",))
    cfg = jb.BatteryConfig(**fields)
    ja, _ = jax.jit(jb.absorb)(cfg, charge, harvest)
    c, h = torch.tensor(charge), torch.tensor(harvest)
    leak = torch.tensor(fields["leak"])
    two_step = torch.minimum((c - c * leak) + h, torch.tensor(2.5))
    np.testing.assert_array_equal(two_step.numpy(), np.asarray(ja))
    ta, _ = tb.absorb(tb.BatteryConfig(**{k: torch.as_tensor(v) for k, v in
                                          fields.items()}), c, h)
    fused = torch.minimum(tb.fma_f32(-c, leak, c) + h, torch.tensor(2.5))
    assert torch.equal(ta, fused)
    ulps = np.abs(ta.numpy().view(np.int32).astype(np.int64)
                  - np.asarray(ja).view(np.int32).astype(np.int64))
    assert ulps.max() <= 2


def test_the_two_step_expression_would_not_match():
    """Without the contraction the port would be off on many clients: the
    FMA site is real."""
    charge, harvest, _ = _fleet(1)
    ja, _ = jax.jit(jb.absorb)(jb.BatteryConfig(2.5, 0.02), charge, harvest)
    c, h = torch.tensor(charge), torch.tensor(harvest)
    two_step = torch.minimum((c - c * 0.02) + h, torch.tensor(2.5))
    assert int((two_step.numpy() != np.asarray(ja)).sum()) > 100


def _exact_fma32(a, b, c):
    """Correctly rounded float32 a*b + c from exact rationals."""
    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(x))            # nearest double, then nearest float
    lo, hi = sorted((f, np.nextafter(f, np.float32(np.inf) if Fraction(
        float(f)) < x else np.float32(-np.inf))))
    dl, dh = abs(Fraction(float(lo)) - x), abs(Fraction(float(hi)) - x)
    if dl != dh:
        return lo if dl < dh else hi
    return lo if int(lo.view(np.int32)) % 2 == 0 else hi


def test_fma_f32_is_correctly_rounded():
    """Against exact rational arithmetic, on random triples and on triples
    built so that a*b + c lies next to a float32 rounding midpoint (where
    rounding through float64 first could go wrong)."""
    r = np.random.default_rng(2)
    a = r.uniform(-4, 4, 3000).astype(np.float32)
    b = r.uniform(-1, 1, 3000).astype(np.float32)
    c = r.uniform(-4, 4, 3000).astype(np.float32)
    # near-midpoint cases: c = -round32(a*b) + half an ulp of it
    p = (a[:1000].astype(np.float64) * b[:1000]).astype(np.float32)
    c[:1000] = (p + np.spacing(p) / 2).astype(np.float32)
    got = tb.fma_f32(torch.tensor(a), torch.tensor(b), torch.tensor(c))
    want = np.array([_exact_fma32(x, y, z) for x, y, z in zip(a, b, c)])
    np.testing.assert_array_equal(got.numpy(), want)
    jfma = jax.jit(lambda x, y, z: x * y + z)(a, b, c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfma))


@pytest.mark.parametrize("seed", range(3))
def test_conservation_and_bounds(seed):
    """harvest - consumed - leaked - overflow == delta charge (float32
    rounding), charge within [0, capacity], over 30 feasible rounds."""
    n, rs = 64, np.random.RandomState(seed)
    cap = 2.0
    cfg = tb.BatteryConfig(capacity=cap, leak=0.05,
                           init_charge=torch.tensor(rs.uniform(0, cap, n),
                                                    dtype=torch.float32))
    charge = cfg.init(n)
    cost = torch.tensor(rs.uniform(0.1, 1.0, n), dtype=torch.float32)
    for r in range(30):
        harvest = torch.tensor(rs.exponential(0.7, n), dtype=torch.float32)
        avail, aux = tb.absorb(cfg, charge, harvest)
        consume = torch.where(avail >= cost, cost, 0.0) * torch.tensor(
            rs.uniform(size=n) < 0.7)
        new = tb.drain(avail, consume)
        lhs = harvest - consume - aux["leaked"] - aux["overflow"]
        np.testing.assert_allclose(lhs.numpy(), (new - charge).numpy(),
                                   atol=1e-5)
        charge = new
        assert bool((charge >= 0).all()) and bool((charge <= cap).all())
