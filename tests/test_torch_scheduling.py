"""The port's schedules against the JAX package's: every mask bitwise, for
all four policies, with and without per-client phases, over 200+ rounds
with E in {1, ..., 20}; plus the dispatch's errors and the helpers."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scheduling as js
from repro_torch.core import scheduling as ts

ROUNDS = 240


def _cycles(n=20, seed=0):
    """E covering 1..20 (every value at least once), shuffled."""
    r = np.random.default_rng(seed)
    return r.permutation(np.arange(1, n + 1)).astype(np.int32)


def _masks(mod, policy, seed, E, phase, rounds=ROUNDS):
    out = []
    for r in range(rounds):
        if mod is js:
            m = js.participation_mask(
                policy, seed, jnp.int32(r), jnp.asarray(E),
                phase=None if phase is None else jnp.asarray(phase))
            out.append(np.asarray(m))
        else:
            m = ts.participation_mask(
                policy, seed, r, torch.tensor(E),
                phase=None if phase is None else torch.tensor(phase))
            assert m.dtype == torch.float32
            out.append(m.numpy())
    return np.stack(out)


@pytest.mark.parametrize("policy", ["sustainable", "greedy", "wait_all",
                                    "always"])
@pytest.mark.parametrize("seed", [0, 3, 99991])
def test_masks_bitwise_without_phase(policy, seed):
    E = _cycles(seed=seed)
    want = _masks(js, policy, seed, E, None)
    got = _masks(ts, policy, seed, E, None)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.sum() > 0


@pytest.mark.parametrize("policy", ["sustainable", "greedy", "always"])
@pytest.mark.parametrize("seed", [0, 7])
def test_masks_bitwise_with_phase(policy, seed):
    E = _cycles(seed=seed + 1)
    phase = np.random.default_rng(seed).integers(0, 20, E.shape
                                                 ).astype(np.int32)
    want = _masks(js, policy, seed, E, phase)
    got = _masks(ts, policy, seed, E, phase)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_paper_profile_masks_bitwise():
    """§V: N=40, taus (1, 5, 10, 20)."""
    Ej = js.EnergyProfile(40, (1, 5, 10, 20)).cycles()
    Et = ts.EnergyProfile(40, (1, 5, 10, 20)).cycles()
    np.testing.assert_array_equal(Et.numpy(), np.asarray(Ej))
    assert Et.dtype == torch.int32
    E = np.asarray(Ej)
    for policy in ("sustainable", "wait_all"):
        np.testing.assert_array_equal(_masks(ts, policy, 0, E, None),
                                      _masks(js, policy, 0, E, None))


def test_wait_all_with_phase_raises():
    E = torch.tensor([1, 2, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match="phase"):
        ts.participation_mask("wait_all", 0, 0, E, phase=torch.zeros(3))


def test_threshold_names_the_fleet_entry_point():
    with pytest.raises(ValueError, match=r"energy\.fleet\.fleet_mask"):
        ts.participation_mask("threshold", 0, 0, torch.ones(3))
    assert [p.value for p in ts.Policy] == [p.value for p in js.Policy]


@pytest.mark.parametrize("policy", ["sustainable", "greedy", "wait_all"])
def test_aggregation_scale_and_feasibility(policy):
    E = _cycles(8, seed=2)
    np.testing.assert_array_equal(
        ts.aggregation_scale(policy, torch.tensor(E)).numpy(),
        np.asarray(js.aggregation_scale(policy, jnp.asarray(E))))
    m = _masks(ts, policy, 5, E, None, rounds=120)
    want = bool(js.energy_feasible(jnp.asarray(m), jnp.asarray(E)))
    assert ts.energy_feasible(torch.tensor(m), torch.tensor(E)) is want
    if policy != "wait_all":
        assert want


def test_energy_feasible_with_phase_and_infeasible_masks():
    E = np.array([2, 3, 5], np.int32)
    phase = np.array([1, 2, 4], np.int32)
    m = _masks(ts, "sustainable", 1, E, phase, rounds=60)
    for masks in (m, np.ones_like(m)):
        want = bool(js.energy_feasible(jnp.asarray(masks), jnp.asarray(E),
                                       phase=jnp.asarray(phase)))
        assert ts.energy_feasible(torch.tensor(masks), torch.tensor(E),
                                  phase=torch.tensor(phase)) is want
    assert not ts.energy_feasible(torch.ones(10, 3), torch.tensor(E))


def test_energy_profile_fields_match():
    assert (dataclasses.asdict(ts.EnergyProfile())
            == dataclasses.asdict(js.EnergyProfile()))
