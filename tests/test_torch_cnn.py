"""The port's CIFAR CNN against the JAX package's, on the reference's
params (carried across by ``convert.cnn_params_from_numpy``) and numpy
inputs: logits, loss, gradients and accuracy.

Tolerance: both compute in float32 and sum up to 4096 products per output
(fc1) in other orders; relative errors of that are ~1e-6, and 1e-4 of the
largest magnitude (logits ~10 at He init) with rtol 1e-4 leaves room for
the 5 layers they pass through.  Gradients are held the same way against
the largest gradient of each leaf.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import get_model as jget_model
from repro_torch.configs import get_config
from repro_torch.convert import cnn_params_from_numpy, cnn_params_to_numpy
from repro_torch.models import cnn, get_model

TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jm = jget_model(jget_config("cifar-cnn"))
    tm = get_model(get_config("cifar-cnn"))
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = cnn_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, tm, jp, tp


def _batch(B=6, seed=0):
    r = np.random.default_rng(seed)
    return {"images": r.standard_normal((B, 32, 32, 3)).astype(np.float32),
            "labels": r.integers(0, 10, B).astype(np.int32)}


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


def test_param_count_and_layouts(models):
    jm, tm, jp, tp = models
    assert tm.num_params(tp) == jm.num_params(jp) == 1_702_794
    assert tp["conv1"]["w"].shape == (32, 3, 5, 5)           # OIHW
    assert tp["fc1"]["w"].shape == (4096, 384)               # (d_in, d_out)
    back = cnn_params_to_numpy(tp)
    for k in back:
        for kk in back[k]:
            np.testing.assert_array_equal(back[k][kk], np.asarray(jp[k][kk]))
    fresh = tm.init_params(torch.Generator().manual_seed(0))
    for k in fresh:
        for kk in fresh[k]:
            assert fresh[k][kk].shape == tp[k][kk].shape
            assert fresh[k][kk].dtype == torch.float32
    std = float(fresh["fc1"]["w"].std())
    assert abs(std - (2.0 / 4096) ** 0.5) < 1e-3               # He init


@pytest.mark.parametrize("B,seed", [(1, 0), (6, 1), (17, 2)])
def test_logits_loss_accuracy(models, B, seed):
    jm, tm, jp, tp = models
    b = _batch(B, seed)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.tensor(v) for k, v in b.items()}
    want, _ = jm.forward(jp, jb)
    got, aux = tm.forward(tp, tb)
    assert got.shape == (B, 10) and float(aux) == 0.0
    _close(got, want)
    _close(tm.loss_fn(tp, tb), jm.loss_fn(jp, jb))
    from repro.models import cnn as jcnn
    assert float(cnn.accuracy(tp, tb)) == float(jcnn.accuracy(jp, jb))


def test_gradients(models):
    jm, tm, jp, tp = models
    b = _batch(8, 3)
    jg = jax.grad(lambda p: jm.loss_fn(p, {k: jnp.asarray(v)
                                           for k, v in b.items()}))(jp)
    tg = torch.func.grad(lambda p: tm.loss_fn(
        p, {k: torch.tensor(v) for k, v in b.items()}))(tp)
    tg = cnn_params_to_numpy(tg)
    for k in tg:
        for kk in tg[k]:
            _close(tg[k][kk], jg[k][kk])


def test_flatten_is_nhwc(models):
    """The fc1 rows follow the reference's NHWC flatten: permuting fc1's
    rows to NCHW order changes the logits (so the test above would catch
    a port that flattened NCHW)."""
    jm, tm, jp, tp = models
    tb = {k: torch.tensor(v) for k, v in _batch(4, 4).items()}
    swapped = {k: dict(v) for k, v in tp.items()}
    w = tp["fc1"]["w"].reshape(8, 8, 64, 384).permute(2, 0, 1, 3)
    swapped["fc1"]["w"] = w.reshape(4096, 384)
    a, _ = tm.forward(tp, tb)
    c, _ = tm.forward(swapped, tb)
    assert float((a - c).abs().max()) > 1e-2


@pytest.mark.parametrize("B,I,O,H", [(1, 3, 32, 32), (5, 32, 64, 16),
                                     (2, 4, 6, 8)])
def test_conv_same_matches_conv2d_in_float64(B, I, O, H):
    """The im2col convolution, alone and mapped over stacked client
    weights, against ``F.conv2d`` in float64 (to 1e-12 of the largest
    output), and in float32 to 1e-5 of it."""
    r = np.random.default_rng(B * 100 + I)
    x = torch.tensor(r.standard_normal((3, B, I, H, H)))
    w = torch.tensor(r.standard_normal((3, O, I, 5, 5)))
    b = torch.tensor(r.standard_normal((3, O)))
    want = torch.stack([torch.nn.functional.conv2d(x[c], w[c], b[c],
                                                   padding=2)
                        for c in range(3)])
    scale = want.abs().max()
    got = torch.func.vmap(cnn.conv_same)(x, w, b)
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 1e-12 * scale
    assert (cnn.conv_same(x[0], w[0], b[0]) - want[0]).abs().max() <= (
        1e-12 * scale)
    got32 = torch.func.vmap(cnn.conv_same)(x.float(), w.float(), b.float())
    assert (got32.double() - want).abs().max() <= 1e-5 * scale


def test_features_replay_their_own_decisions(models):
    """``loss_and_decisions`` is ``loss_fn`` bit for bit; fed its own
    pre-activations as routes, the forward takes the same decisions (to
    float32 rounding, 1e-6 of the largest logit); other routes change
    them."""
    _, tm, _, tp = models
    b = {k: torch.tensor(v) for k, v in _batch(5, 3).items()}
    loss, pre = cnn.loss_and_decisions(tp, b)
    assert torch.equal(loss, tm.loss_fn(tp, b))
    logits, _ = cnn.features(tp, b["images"])
    replayed, _ = cnn.features(tp, b["images"], pre)
    assert (replayed - logits).abs().max() <= 1e-6 * logits.abs().max()
    other = {k: torch.tensor(v) for k, v in _batch(5, 4).items()}
    _, pre_other = cnn.loss_and_decisions(tp, other)
    moved, _ = cnn.features(tp, b["images"], pre_other)
    assert (moved - logits).abs().max() > 1e-2 * logits.abs().max()
