"""The LM local update of the port against the JAX package's: the token
cross-entropy, each family's ``loss_fn`` and its gradient, and whole
client-stacked rounds (``core.parallel_round``) on the smoke configs in
fp32, with the JAX ``init_params`` trees carried across by
``repro_torch.convert``.

Tolerances, with their reasons:

* losses and aux: 1e-5 (fp32 matmuls and sums in other orders through two
  layers; observed ~1e-6);
* gradients: 1e-4 relative and absolute (the same, through the backward);
* one SGD round: every param within 1e-6 + 1e-5 |w|;
* one Adam round: the hard per-element bound of ``test_torch_round``'s
  ``adam_bound`` (Adam turns float32 noise in a near-zero gradient into a
  step of up to lr on the first step), and 90% of the params within
  1e-6 (1 + |w|).
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

from repro import core as jcore
from repro import optim as jopt
from repro.configs import get_smoke_config as jax_smoke
from repro.models import get_model as jax_model
from repro.models import layers as jlayers
from repro_torch import core as tcore
from repro_torch import optim as topt
from repro_torch import prng
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import get_model
from repro_torch.models import layers as tlayers
from test_torch_round import adam_step_bound

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
BULK_Q, BULK_TOL = 0.9, 1e-6
# (arch, config overrides): every family the port trains, MoE in each mode
# with a capacity small enough that tokens drop
CASES = [("granite-3-2b", {}), ("mamba2-1.3b", {})] + [
    ("olmoe-1b-7b", {"moe_mode": m, "capacity_factor": 0.5})
    for m in ("dense", "dispatch", "sorted", "sorted_local")] + [
    ("internvl2-76b", {})]


def _models(arch, **over):
    jcfg = dataclasses.replace(jax_smoke(arch), **over)
    tcfg = dataclasses.replace(get_smoke_config(arch), **over)
    jm, tm = jax_model(jcfg), get_model(tcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    return jm, tm, jp, params_from_numpy(jp, device="cpu")


def _batch(cfg, lead, S=16, seed=1):
    """Tokens (*lead, S) and, for a VLM, vision_embeds (*lead, n_vis, d)."""
    r = np.random.default_rng(seed)
    b = {"tokens": r.integers(0, cfg.vocab_size, lead + (S,)).astype(
        np.int32)}
    if cfg.family == "vlm":
        b["vision_embeds"] = r.standard_normal(
            lead + (cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return b


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.detach() if torch.is_tensor(tree)
                               else tree, dtype=np.float32)}


@pytest.mark.parametrize("valid", [515, 640])
@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_reference(valid, masked):
    """Logits padded to 640 columns (valid 515: the pad is masked) or not
    padded, with and without a token mask (one row fully masked out)."""
    r = np.random.default_rng(0)
    logits = (3 * r.standard_normal((3, 7, 640))).astype(np.float32)
    labels = r.integers(0, valid, (3, 7)).astype(np.int32)
    mask = (r.random((3, 7)) < 0.6).astype(np.float32)
    mask[1] = 0.0
    m = mask if masked else None
    want = jlayers.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                None if m is None else jnp.asarray(m),
                                valid_vocab=valid)
    got = tlayers.softmax_xent(torch.tensor(logits), torch.tensor(labels),
                               None if m is None else torch.tensor(m),
                               valid_vocab=valid)
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    all_masked = tlayers.softmax_xent(torch.tensor(logits),
                                      torch.tensor(labels),
                                      torch.zeros(3, 7), valid_vocab=valid)
    assert float(all_masked) == 0.0          # max(sum(mask), 1) denominator


@pytest.mark.parametrize("arch,over", CASES,
                         ids=[f"{a}-{o.get('moe_mode', '')}".rstrip("-")
                              for a, o in CASES])
def test_loss_and_grad_match_reference(arch, over):
    jm, tm, jp, tp = _models(arch, **over)
    b = _batch(tm.cfg, (2,))
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tb = {k: torch.tensor(v) for k, v in b.items()}
    tloss = tm.loss_fn(tp, tb)
    tgrads = grad(tm.loss_fn)(tp, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), **LOSS_TOL)
    want, got = _flat(jgrads), _flat(tgrads)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GRAD_TOL)
    if tm.cfg.family == "moe":
        _, aux = tm.forward(tp, tb)
        _, jaux = jm.forward(jp, {k: jnp.asarray(v) for k, v in b.items()})
        assert float(aux) > 0.0
        np.testing.assert_allclose(float(aux), float(jaux), **LOSS_TOL)


C, T, BC = 4, 2, 2
E = np.array([1, 2, 4, 8], np.int32)
P = np.full(C, 1.0 / C, np.float32)


@pytest.mark.parametrize("arch,opt", [("granite-3-2b", "adam"),
                                      ("olmoe-1b-7b", "sgd")])
def test_parallel_round_matches_reference(arch, opt):
    """One sustainable round of C=4 clients, T=2 local steps: the same
    participants, the loss within 1e-5 and the new global model as the
    module docstring states (Adam, the launcher's optimizer, on granite;
    SGD, held elementwise, on olmoe)."""
    jm, tm, jp, tp = _models(arch)
    b = _batch(tm.cfg, (C, T, BC))
    lr = 1e-2 if opt == "sgd" else 1e-3
    jo, to = ((jopt.sgd(lr), topt.sgd(lr)) if opt == "sgd"
              else (jopt.adam(lr), topt.adam(lr)))
    rnd = 0
    wj, mj = jax.jit(partial(
        jcore.parallel_round, lambda p, x, k: jm.loss_fn(p, x), jo,
        jcore.FedConfig(num_clients=C, local_steps=T)))(
        jp, {k: jnp.asarray(v) for k, v in b.items()}, jnp.asarray(P),
        jnp.asarray(E), jnp.int32(rnd), jax.random.PRNGKey(rnd))
    wt, mt = tcore.parallel_round(
        lambda p, x, k: tm.loss_fn(p, x), to,
        tcore.FedConfig(num_clients=C, local_steps=T), tp,
        {k: torch.tensor(v) for k, v in b.items()}, torch.tensor(P),
        torch.tensor(E), rnd, prng.PRNGKey(rnd))
    assert float(mt["participants"]) == float(mj["participants"]) > 0
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               **LOSS_TOL)
    want, got = _flat(wj), _flat(wt)
    d = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    w = np.concatenate([np.abs(want[k]).ravel() for k in want])
    if opt == "sgd":
        assert (d <= 1e-6 + 1e-5 * w).all(), d.max()
    else:
        mask = np.asarray(jcore.participation_mask(
            "sustainable", 0, jnp.int32(rnd), jnp.asarray(E)))
        s = float((mask * P * E).sum())
        assert d.max() <= 2.0 * adam_step_bound(T) * lr * T * s, d.max()
        assert np.quantile(d / (1 + w), BULK_Q) <= BULK_TOL
