"""Per-layer remat (``models/remat.py``) on the smoke configs of every LM
family: ``remat=True`` against ``remat=False`` in the port, and against
the JAX package's ``jax.checkpoint`` layers; the MoE recomputation's
routes; the encoder's gradient through the decoder's rematerialised
cross-attention (nonzero, in the on-against-off tests); and the bytes the
graph keeps a layer.

Tolerances, with their reasons:

* remat on against off: the loss and every gradient bitwise (the
  recomputation runs the same ops on the same inputs), except the
  encoder-decoder's encoder: its memory feeds every decoder layer, and
  with remat the layers' cotangents for it are summed in another order,
  so its leaves are held to 1e-6 of the leaf's largest |g| (observed
  ~2e-7) and, after an SGD round, to 1e-6 |w| + 1e-9;
* against the reference: ``test_torch_lm_train``'s 1e-5 on the loss and
  1e-4 on the gradients (fp32 matmuls and sums in other orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value

from repro_torch import core as tcore
from repro_torch import optim as topt
from repro_torch import prng
from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model
from repro_torch.models import moe as moe_mod
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path
from test_torch_lm_train import GRAD_TOL, LOSS_TOL, _batch, _flat, _models

ARCHS = ("granite-3-2b", "olmoe-1b-7b", "internvl2-76b", "mamba2-1.3b",
         "recurrentgemma-2b", "whisper-tiny")
ENC_GRAD_TOL = 1e-6            # of the leaf's largest |g|
ENC_PARAM_TOL = dict(rtol=1e-6, atol=1e-9)


def _pair(arch, **over):
    """The arch's smoke model with remat on and off, and one set of params."""
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    on = get_model(dataclasses.replace(cfg, remat=True))
    off = get_model(dataclasses.replace(cfg, remat=False))
    return on, off, on.init_params(torch.Generator().manual_seed(0))


def _tbatch(cfg, lead, seed=1):
    return {k: torch.tensor(v)
            for k, v in _batch(cfg, lead, seed=seed).items()}


def _paths(tree):
    out = []
    tree_map_with_path(lambda p, _: out.append("/".join(p)), tree)
    return out


def _assert_same(paths, got, want, encdec, what):
    """Bitwise, or for an encoder leaf within ENC_GRAD_TOL of its largest
    |g| (``what="grad"``) or ENC_PARAM_TOL (``what="param"``).  An encoder
    leaf's gradient must not be zero: the memory is an input of each
    decoder layer's Function, so the cross-attention's gradient reaches
    the encoder."""
    for name, g, w in zip(paths, got, want):
        if encdec and name.startswith("enc_"):
            if what == "grad":
                assert w.abs().max().item() > 0.0, name
                tol = ENC_GRAD_TOL * w.abs().max().item()
                assert (g - w).abs().max().item() <= tol, name
            else:
                torch.testing.assert_close(g, w, **ENC_PARAM_TOL, msg=name)
        else:
            assert torch.equal(g, w), name


def _requiring_grad(params):
    return tree_map(lambda t: t.detach().clone().requires_grad_(), params)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_plain_under_autograd(arch):
    """Plain autograd: the loss and every gradient with remat on equal
    those with remat off."""
    on, off, params = _pair(arch)
    b = _tbatch(on.cfg, (2,))
    results = []
    for model in (on, off):
        p = _requiring_grad(params)
        loss = model.loss_fn(p, b)
        results.append((loss, torch.autograd.grad(loss, tree_leaves(p))))
    (l_on, g_on), (l_off, g_off) = results
    assert torch.equal(l_on, l_off)
    _assert_same(_paths(params), g_on, g_off, on.cfg.family == "encdec",
                 "grad")


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_plain_under_vmap(arch):
    """One SGD round of two clients through ``core.parallel_round`` (the
    local step is ``vmap(grad_and_value)`` over the stacked clients): with
    remat on, the loss, each client's gradients (recorded as the optimizer
    receives them) and the new global model equal remat off's."""
    on, off, params = _pair(arch)
    C = 2
    batches = _tbatch(on.cfg, (C, 1, 2), seed=3)
    fed = tcore.FedConfig(num_clients=C, local_steps=1)
    sgd, rounds = topt.sgd(1e-2), []
    for m in (on, off):
        seen = []

        def update(grads, state, p, step, seen=seen):
            seen.append(grads)
            return sgd.update(grads, state, p, step)

        w, metrics = tcore.parallel_round(
            lambda p, x, k, m=m: m.loss_fn(p, x),
            topt.Optimizer(sgd.init, update), fed, params, batches,
            torch.full((C,), 1.0 / C), torch.tensor([1, 2]), 0,
            prng.PRNGKey(0))
        rounds.append((w, metrics, seen[0]))
    (w_on, m_on, g_on), (w_off, m_off, g_off) = rounds
    encdec = on.cfg.family == "encdec"
    assert float(m_on["participants"]) == float(m_off["participants"]) > 0
    assert torch.equal(m_on["loss"], m_off["loss"])
    _assert_same(_paths(params), tree_leaves(g_on), tree_leaves(g_off),
                 encdec, "grad")
    _assert_same(_paths(params), tree_leaves(w_on), tree_leaves(w_off),
                 encdec, "param")


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_matches_reference_remat(arch):
    """The port with remat against the JAX package with remat (its
    ``jax.checkpoint`` layers) on the same params and batch: the loss and
    the gradients within the LM parity tolerances."""
    jm, tm, jp, tp = _models(arch, remat=True)
    assert jm.cfg.remat and tm.cfg.remat
    b = _batch(tm.cfg, (2,))
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tloss, tgrads = grad_and_value(tm.loss_fn)(
        tp, {k: torch.tensor(v) for k, v in b.items()})[::-1]
    np.testing.assert_allclose(float(tloss), float(jloss), **LOSS_TOL)
    want, got = _flat(jgrads), _flat(tgrads)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("mode", moe_mod.MODES)
def test_moe_recomputation_routes_as_the_forward(mode, monkeypatch):
    """Each layer's router runs twice with remat, once in the forward and
    once in the backward's recomputation, and picks the same experts;
    the router's aux loss carries a gradient to it."""
    on, off, params = _pair("olmoe-1b-7b", moe_mode=mode,
                            capacity_factor=0.5)
    seen, real = [], moe_mod._route

    def route(cfg, p, x, idx=None):
        out = real(cfg, p, x, idx)
        seen.append(out[1].detach().clone())
        return out

    monkeypatch.setattr(moe_mod, "_route", route)
    p = _requiring_grad(params)
    loss = on.loss_fn(p, _tbatch(on.cfg, (2,)))
    n = len(seen)
    grads = torch.autograd.grad(loss, tree_leaves(p))
    L = on.cfg.num_layers
    per_layer = 2 if mode == "sorted_local" else 1   # one a batch row
    assert n == len(seen) - n == L * per_layer
    fwd, bwd = seen[:n], seen[n:]
    for i in range(L):             # the backward recomputes the last first
        for j in range(per_layer):
            assert torch.equal(fwd[i * per_layer + j],
                               bwd[(L - 1 - i) * per_layer + j])
    router = dict(zip(_paths(params), grads))["layers/moe/router"]
    assert router.abs().max().item() > 0.0
    monkeypatch.setattr(moe_mod, "_route", real)
    aux_grads = []
    for model in (on, off):        # the aux loss alone, an output of each
        p = _requiring_grad(params)    # layer's Function
        aux = model.forward(p, _tbatch(on.cfg, (2,)))[1]
        aux_grads.append(torch.autograd.grad(
            aux, p["layers"]["moe"]["router"]))
    assert aux_grads[0][0].abs().max().item() > 0.0
    assert torch.equal(aux_grads[0][0], aux_grads[1][0])


def _saved_bytes(cfg, B=2, S=16):
    """Bytes of the distinct storages that ``loss_fn``'s graph saves under
    plain autograd, the params' own storages left out: (floating,
    integer)."""
    model = get_model(cfg)
    params = tree_map(lambda t: t.requires_grad_(),
                      model.init_params(torch.Generator().manual_seed(0)))
    own = {t.untyped_storage().data_ptr() for t in tree_leaves(params)}
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in own:
            seen[st.data_ptr()] = (st.nbytes(), t.dtype.is_floating_point)
        return t

    b = _tbatch(cfg, (B,))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model.loss_fn(params, b)
    return (sum(n for n, fl in seen.values() if fl),
            sum(n for n, fl in seen.values() if not fl))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_keeps_one_residual_a_layer(arch):
    """Depth L against L + 1 (the hybrid: L + 3, one more block), so that
    the embedding and the logits cancel: with remat the graph keeps exactly
    one more (B, S, d_model) residual in the model's dtype and no more
    integer bytes; without it, more than ten times that."""
    cfg = get_smoke_config(arch)
    step = 3 if cfg.family == "hybrid" else 1
    B, S = 2, 16
    residual = B * S * cfg.d_model * torch.finfo(
        getattr(torch, cfg.dtype)).bits // 8
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        lo = _saved_bytes(c, B, S)
        hi = _saved_bytes(dataclasses.replace(
            c, num_layers=cfg.num_layers + step), B, S)
        if remat:
            assert (hi[0] - lo[0], hi[1] - lo[1]) == (residual, 0)
        else:
            assert hi[0] - lo[0] > 10 * residual


def test_adam_update_in_chunks_equals_one_pass(monkeypatch):
    """Adam updates a large leaf in chunks of its leading axis (so that a
    full-depth round's float32 temporaries fit beside its state): two
    steps with tiny chunks give bitwise the params and moments of the
    update in one pass, on bf16 and fp32 leaves, stacked and scalar."""
    from repro_torch.optim import adam, optimizers

    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(5, 7, 3, generator=gen).bfloat16(),
              "b": torch.randn(6, generator=gen), "s": torch.tensor(0.5)}
    grads = [tree_map(lambda t: torch.randn(t.shape, generator=gen).to(
        t.dtype), params) for _ in range(2)]
    results = []
    for chunk in (optimizers._CHUNK, 8):
        monkeypatch.setattr(optimizers, "_CHUNK", chunk)
        opt = adam(1e-2)
        p, state = params, opt.init(params)
        for t, g in enumerate(grads):
            p, state = opt.update(g, state, p, t)
        results.append(tree_leaves((p, state)))
    for a, b in zip(*results):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_no_library_checkpoint_and_no_fallback():
    """The port rematerialises through its own Function only: no module
    calls ``torch.utils.checkpoint``, and ``models/remat.py`` has no
    ``try`` that could carry on without remat."""
    import ast
    import os

    pkg = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src", "repro_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            for n in ast.walk(ast.parse(open(os.path.join(root, f)).read())):
                if isinstance(n, ast.ImportFrom):
                    names = {a.name for a in n.names}
                    assert not (n.module or "").startswith(
                        "torch.utils.checkpoint"), f
                    assert not (n.module == "torch.utils"
                                and "checkpoint" in names), f
                elif isinstance(n, ast.Import):
                    assert not any(a.name.startswith("torch.utils.checkpoint")
                                   for a in n.names), f
                elif isinstance(n, ast.Attribute):
                    assert not (n.attr == "checkpoint"
                                and isinstance(n.value, ast.Attribute)
                                and n.value.attr == "utils"), f
    tree = ast.parse(open(os.path.join(pkg, "models", "remat.py")).read())
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))


def _func_peak(cfg, B=4, S=64):
    """The peak of the bytes a ``grad_and_value`` of ``loss_fn`` allocates
    beyond its arguments (`launch.dryrun.StepCounter` on real tensors)."""
    from repro_torch.launch.dryrun import StepCounter

    model = get_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    b = {"tokens": torch.tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S)))}
    with StepCounter((params, b)) as counter:
        grad_and_value(model.loss_fn)(params, b)
    return counter.temp_peak


def test_remat_frees_each_layer_under_torch_func():
    """``torch.func.grad`` runs the backward with create_graph=True; the
    Function's recomputation must not be recorded into that graph, or
    every layer's activations stay alive to the end.  At 4 layers of
    granite-3-2b's smoke config the peak with remat is under half the
    peak without (observed 0.30, mamba2-1.3b's 0.19; 1.0 when the
    recomputation is recorded).  One family: the Function is the same in
    all four."""
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), num_layers=4)
    on, off = (_func_peak(dataclasses.replace(cfg, remat=remat))
               for remat in (True, False))
    assert 0 < on < 0.5 * off, (on, off)
