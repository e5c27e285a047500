"""``repro_torch.serve.qos`` and ``serve.admission`` against the JAX
package's: request prices and decoded-token counts, and the three admission
policies' modes (``decide`` after ``scaled``), bitwise on random float32
inputs, with scalar and per-client thresholds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.energy.costs import DecodeCostModel as JCost
from repro.serve import admission as jad
from repro.serve import qos as jqos
from repro_torch.energy.costs import DecodeCostModel as TCost
from repro_torch.serve import admission as tad
from repro_torch.serve import qos as tqos


def _eq(got, want, label):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and np.array_equal(got, want), label


def test_modes_and_qos_constants():
    assert (tqos.SHED, tqos.DEGRADED, tqos.FULL) == (jqos.SHED, jqos.DEGRADED,
                                                     jqos.FULL)


@pytest.mark.parametrize("per_client", [False, True])
def test_request_cost_and_decoded_tokens_match_reference(per_client):
    r = np.random.default_rng(0)
    n = 1000
    pick = lambda lo, hi: (r.uniform(lo, hi, n).astype(np.float32)
                           if per_client else float(r.uniform(lo, hi)))
    cost = (pick(1e-3, 3e-3), pick(1e-3, 3e-3), pick(1e-5, 1e-4))
    toks = (pick(50, 200), pick(100, 300), pick(10, 40))
    jq, tq = jqos.QoSSpec(*toks), tqos.QoSSpec(*toks)
    for degraded in (False, True):
        _eq(tq.request_cost(TCost(*cost), degraded),
            jq.request_cost(JCost(*cost), degraded), f"price {degraded}")
    for model in ("from_params", "from_microbench"):
        args = (1e8,) if model == "from_params" else (3e-4, 2e-3)
        _eq(tq.request_cost(getattr(TCost, model)(*args)),
            jq.request_cost(getattr(JCost, model)(*args)), model)
    sf = r.integers(0, 9, n).astype(np.float32)
    ss = r.integers(0, 9, n).astype(np.float32)
    _eq(tq.decoded_tokens(sf, ss), jq.decoded_tokens(sf, ss), "tokens")


def _policies(mod, kind, n, r, per_client):
    if kind == "agnostic":
        return mod.EnergyAgnostic()
    cls = mod.BatteryGated if kind == "battery" else mod.ChargeGated
    if per_client:
        hi = r.uniform(0.5, 3.0, n).astype(np.float32)
        lo = r.uniform(0.1, 1.0, n).astype(np.float32)
    else:
        hi, lo = 1.7, 0.6
    return cls.create(n, hi=hi, lo=lo)


@pytest.mark.parametrize("kind", ["agnostic", "battery", "charge"])
@pytest.mark.parametrize("per_client", [False, True])
@pytest.mark.parametrize("admit", [1.0, 0.5, 2.75, 1.3])
def test_decide_after_scaled_matches_reference(kind, per_client, admit):
    """Modes from the same available charge and offered epoch costs, the
    thresholds scaled by the admission knob first (``hi * admit``, then
    the comparison with that times the epoch's cost)."""
    n = 4000
    r = np.random.default_rng(1)
    avail = r.uniform(0, 6, n).astype(np.float32)
    req = r.integers(0, 8, n).astype(np.float32)
    full = np.float32(0.768051)
    short = np.float32(0.3200512)
    state = np.random.default_rng(2)
    jp = _policies(jad, kind, n, state, per_client)
    state = np.random.default_rng(2)
    tp = _policies(tad, kind, n, state, per_client)
    jm = jp.scaled(admit).decide(jnp.asarray(avail), jnp.asarray(req * full),
                                 jnp.asarray(req * short))
    tm = tp.scaled(admit).decide(torch.tensor(avail), torch.tensor(req * full),
                                 torch.tensor(req * short))
    _eq(tm, jm, "modes")
    assert tm.dtype == torch.int32
    if kind != "agnostic":
        assert len(set(tm.tolist())) == 3       # every mode occurs


def test_create_broadcasts_scalars_without_copies():
    p = tad.BatteryGated.create(10, hi=2.0, lo=1.5)
    assert p.hi.shape == (10,) and p.hi.stride() == (0,)
    c = tad.ChargeGated.create(3, hi=[1.0, 2.0, 3.0])
    assert c.hi.tolist() == [1.0, 2.0, 3.0] and c.lo.tolist() == [0.25] * 3
    agn = tad.EnergyAgnostic()
    assert agn.scaled(3.0) is agn
