"""The port's optimizers and schedules against the JAX package's, over one
fixed gradient sequence made with numpy.

Tolerances: both packages run the same float32 expressions on the same
gradients, so params agree to a few float32 ulps: rtol 2e-6 with atol 1e-7
for SGD.  Adam divides by sqrt(v) + eps and takes b ** t with the
backends' own pow, a 1-ulp difference in sqrt(v) moves the step by one
ulp relative, so it is held at rtol 1e-5, atol 1e-7 on params that move by
up to lr per step.  (Adam's amplification of gradient noise near g = 0 —
``test_torch_round.py`` — does not arise here: the gradients are the same
arrays on both sides.)
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim as topt

STEPS = 40


def _grads(shape, steps=STEPS, seed=0):
    r = np.random.default_rng(seed)
    g = r.standard_normal((steps,) + shape).astype(np.float32)
    g[:, :2] *= 1e-7                    # a few near-zero gradients
    return g


def _run(opt, params, grads, offset, pkg):
    s = opt.init(params)
    for t, g in enumerate(grads):
        gt = {"w": jnp.asarray(g)} if pkg == "jax" else {"w": torch.tensor(g)}
        params, s = opt.update(gt, s, params, offset + t)
    return params, s


def _pair(name, lr):
    if name == "sgd":
        return jopt.sgd(lr), topt.sgd(lr)
    if name == "sgd_momentum":
        return jopt.sgd(lr, momentum=0.9), topt.sgd(lr, momentum=0.9)
    return jopt.adam(lr), topt.adam(lr)


SCHEDULES = {
    "constant": (lambda m: m.constant(0.05)),
    "cosine": (lambda m: m.cosine(0.05, 60, floor=0.001)),
    "warmup_cosine": (lambda m: m.warmup_cosine(0.05, 10, 60)),
    "theorem1": (lambda m: m.paper_theorem1(mu=0.5, L=4.0, T=5)),
}


@pytest.mark.parametrize("sched", list(SCHEDULES))
def test_schedules_match(sched):
    js, ts = SCHEDULES[sched](jopt), SCHEDULES[sched](topt)
    for step in range(0, 90, 3):
        want = np.asarray(js(jnp.int32(step)), np.float32)
        got = ts(step)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["sgd", "sgd_momentum", "adam"])
@pytest.mark.parametrize("sched", ["constant", "theorem1"])
@pytest.mark.parametrize("offset", [0, 25])
def test_optimizer_matches_over_gradient_sequence(name, sched, offset):
    jo, to = (_pair(name, SCHEDULES[sched](m)) for m in (jopt, topt))
    jo, to = jo[0], to[1]
    grads = _grads((5, 7))
    w0 = np.random.default_rng(1).standard_normal((5, 7)).astype(np.float32)
    wj, sj = _run(jo, {"w": jnp.asarray(w0)}, grads, offset, "jax")
    wt, st = _run(to, {"w": torch.tensor(w0)}, grads, offset, "torch")
    rtol = 1e-5 if name == "adam" else 2e-6
    np.testing.assert_allclose(wt["w"].numpy(), np.asarray(wj["w"]),
                               rtol=rtol, atol=1e-7)
    assert float(np.abs(wt["w"].numpy() - w0).max()) > 1e-3   # it moved
    if name == "adam":
        assert st["t"].dtype == torch.float32 and float(st["t"]) == STEPS
        for k in ("m", "v"):
            np.testing.assert_allclose(st[k]["w"].numpy(),
                                       np.asarray(sj[k]["w"]),
                                       rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("name", ["sgd_momentum", "adam"])
def test_state_is_float32_for_bf16_params(name):
    _, to = _pair(name, 0.01)
    jo, _ = _pair(name, 0.01)
    w0 = np.random.default_rng(2).standard_normal((16,)).astype(np.float32)
    grads = _grads((16,), steps=5, seed=3)
    wt, st = _run(to, {"w": torch.tensor(w0).bfloat16()}, grads, 0, "torch")
    wj, _ = _run(jo, {"w": jnp.asarray(w0).astype(jnp.bfloat16)}, grads, 0,
                 "jax")
    assert wt["w"].dtype == torch.bfloat16
    state = st["m"]["w"] if name == "adam" else st["w"]
    assert state.dtype == torch.float32
    # bf16 params: one bf16 rounding per step on both sides
    np.testing.assert_allclose(wt["w"].float().numpy(),
                               np.asarray(wj["w"], np.float32),
                               rtol=2 ** -7, atol=1e-3)


def test_adam_first_step_is_lr_sized():
    """Bias correction on the internal counter: the first step moves by lr
    in the gradient's direction whatever the global step index."""
    opt = topt.adam(0.1)
    p = {"w": torch.zeros(3)}
    s = opt.init(p)
    g = {"w": torch.tensor([2.0, -0.5, 1e-3])}
    p1, s1 = opt.update(g, s, p, 1000)
    np.testing.assert_allclose(p1["w"].numpy(), [-0.1, 0.1, -0.1], rtol=1e-4)
    assert float(s1["t"]) == 1.0


def test_make_optimizer_names():
    cfg = topt.OptimizerConfig
    assert topt.make_optimizer(cfg(name="adam")).init(
        {"w": torch.zeros(2)})["t"].dtype == torch.float32
    assert topt.make_optimizer(cfg(name="sgd")).init({"w": torch.zeros(2)}) == ()
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer(cfg(name="lion"))
