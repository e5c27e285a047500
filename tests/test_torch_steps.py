"""The port's step bundles (``repro_torch.launch.steps``) against the JAX
package's, on the smoke configs in fp32 with the JAX ``init_params``
trees carried across by ``repro_torch.convert``.

* prefill and decode: the port's bundle ``fn`` on the CPU (the kernels'
  plain versions: ``flash_attention_plain`` in the prefill of the
  attention families, ``ssd_scan_plain`` in Mamba2's) against the
  reference's bundle jitted on ``make_local_mesh()``; logits and every
  cache leaf within 2e-5 + 2e-5 |want| (fp32 sums in other orders
  through two layers, and online against one-pass softmax);
* train, parallel and sequential: the port's bundle against the
  reference's host-local ``parallel_round`` / ``sequential_client_step``
  called directly (its own train bundles raise under jax 0.9.0); the loss
  within 1e-5, every param (or the delta accumulator) within one round's
  Adam bound and 90% within 1e-6 (1 + |w|), as ``test_torch_lm_train``;
* the reference's failing integration tests, as port-only tests: a round
  executes, dp == tp, blocked == naive attention, micro_batches 2 == 1,
  and a decode bundle executes.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_smoke_config as jax_smoke
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import get_model as jax_model
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.convert import params_from_numpy
from repro_torch.core.aggregation import apply_accumulated
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import get_model
from repro_torch.tree import tree_leaves, tree_map
from test_torch_round import adam_step_bound

PREFILL = InputShape("tiny_prefill", seq_len=32, global_batch=2,
                     kind="prefill")
DECODE = InputShape("tiny_decode", seq_len=16, global_batch=2,
                    kind="decode")
TRAIN = InputShape("tiny_train", seq_len=16, global_batch=4, kind="train")
T = 2                       # local steps
SERVE_TOL = dict(rtol=2e-5, atol=2e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
BULK_Q, BULK_TOL = 0.9, 1e-6
SERVE_ARCHS = ["granite-3-2b", "mamba2-1.3b", "recurrentgemma-2b",
               "whisper-tiny"]


def _np_flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_np_flat(v, f"{pre}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {pre: tree.detach().float().numpy()}
    return {pre: np.asarray(tree, dtype=np.float32)}


def _pair(arch, **over):
    jcfg = dataclasses.replace(jax_smoke(arch), **over)
    tcfg = dataclasses.replace(get_smoke_config(arch), **over)
    jp = jax_model(jcfg).init_params(jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_numpy(jp, device="cpu")


def _batch(cfg, lead, S, seed=1):
    r = np.random.default_rng(seed)
    b = {"tokens": r.integers(0, cfg.vocab_size, lead + (S,)).astype(
        np.int32)}
    if cfg.family == "vlm":
        b["vision_embeds"] = r.standard_normal(
            lead + (cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        b["frames"] = r.standard_normal(
            lead + (cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return b


def _meta(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_meta(v, f"{pre}/{k}"))
        return out
    return {pre: (tuple(tree.shape), tree.dtype)}


def _real(fake_tree, real_tree):
    """``real_tree`` after checking that it has the bundle's leaves, shapes
    and dtypes."""
    assert _meta(fake_tree) == _meta(real_tree)
    return real_tree


def _close(got, want, **tol):
    g, w = _np_flat(got), _np_flat(want)
    assert set(g) == set(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **tol)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_bundle_matches_reference(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    b = _batch(tcfg, (PREFILL.global_batch,), PREFILL.seq_len)
    mesh = jmesh.make_local_mesh()
    with mesh:
        jb = jsteps.build_step(jcfg, PREFILL, mesh)
        jlog, jcache = jax.jit(jb.fn, in_shardings=jb.in_shardings,
                               out_shardings=jb.out_shardings)(
            jp, {k: jnp.asarray(v) for k, v in b.items()})
    tb = tsteps.build_step(tcfg, PREFILL, None, device="cpu")
    assert tb.meta["impl"] == tsteps.kernel_impl(tcfg)
    batch = _real(tb.args[1], {k: torch.tensor(v) for k, v in b.items()})
    tlog, tcache = tb.fn(_real(tb.args[0], tp), batch)
    _close(tlog, np.asarray(jlog), **SERVE_TOL)
    _close(tcache, jax.tree.map(np.asarray, jcache), **SERVE_TOL)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_decode_bundle_matches_reference(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    mesh = jmesh.make_local_mesh()
    tb = tsteps.build_step(tcfg, DECODE, None, device="cpu")
    r = np.random.default_rng(2)
    cache = tree_map(lambda x: (0.5 * r.standard_normal(tuple(x.shape)))
                     .astype(np.float32), tb.args[2])
    tok = r.integers(0, tcfg.vocab_size, (DECODE.global_batch,)).astype(
        np.int32)
    pos = int(tb.args[3])
    with mesh:
        jb = jsteps.build_step(jcfg, DECODE, mesh)
        jlog, jcache = jax.jit(jb.fn, in_shardings=jb.in_shardings,
                               out_shardings=jb.out_shardings)(
            jp, jnp.asarray(tok), jax.tree.map(jnp.asarray, cache),
            jnp.int32(pos))
    assert tb.meta["cache_len"] == jb.meta["cache_len"]
    tcache = _real(tb.args[2], tree_map(torch.tensor, cache))
    tlog, tcache = tb.fn(_real(tb.args[0], tp), torch.tensor(tok), tcache,
                         tb.args[3])
    _close(tlog, np.asarray(jlog), **SERVE_TOL)
    _close(tcache, jax.tree.map(np.asarray, jcache), **SERVE_TOL)


def _adam_check(got, want, start, coeff):
    """``got`` within one round's Adam bound of ``want`` (moves from
    ``start`` scaled by ``coeff``), and 90% within 1e-6 (1 + |w|)."""
    g, w, s = _np_flat(got), _np_flat(want), _np_flat(start)
    d = np.concatenate([np.abs(g[k] - w[k]).ravel() for k in w])
    mag = np.concatenate([np.abs(s[k]).ravel() for k in w])
    lr = 1e-4                                  # make_optimizer_for's
    assert d.max() <= 2.0 * adam_step_bound(T) * lr * T * coeff, d.max()
    assert np.quantile(d / (1 + mag), BULK_Q) <= BULK_TOL


@pytest.mark.parametrize("arch", ["granite-3-2b", "whisper-tiny"])
def test_parallel_train_bundle_matches_reference_round(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    tb = tsteps.build_step(tcfg, TRAIN, None, device="cpu", local_steps=T)
    assert tb.meta["mode"] == "parallel" and tb.meta["client_groups"] == 1
    C, bc = 1, TRAIN.global_batch
    b = _batch(tcfg, (C, T, bc), TRAIN.seq_len)
    jm = jax_model(jcfg)
    fed = jcore.FedConfig(num_clients=C, local_steps=T,
                          micro_batches=jcfg.micro_batches)
    wj, mj = jax.jit(partial(
        jcore.parallel_round, lambda p, x, k: jm.loss_fn(p, x),
        jsteps.make_optimizer_for(jcfg), fed))(
        jp, {k: jnp.asarray(v) for k, v in b.items()}, jnp.ones((C,)),
        jnp.ones((C,), jnp.int32), jnp.int32(0), jax.random.PRNGKey(0))
    _, _, p, E, rnd, key = tb.args
    wt, mt = tb.fn(_real(tb.args[0], tp),
                   _real(tb.args[1], {k: torch.tensor(v)
                                      for k, v in b.items()}),
                   p, E, rnd, key)
    assert float(mt["participants"]) == float(mj["participants"]) == 1.0
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               **LOSS_TOL)
    _adam_check(wt, jax.tree.map(np.asarray, wj), tp, 1.0)


def test_sequential_train_bundle_matches_reference_client_step():
    jcfg, tcfg, jp, tp = _pair("granite-3-2b", fed_mode="sequential")
    tb = tsteps.build_step(tcfg, TRAIN, None, device="cpu", local_steps=T)
    assert tb.meta["mode"] == "sequential"
    b = _batch(tcfg, (T, TRAIN.global_batch), TRAIN.seq_len)
    jm = jax_model(jcfg)
    fed = jcore.FedConfig(num_clients=1, local_steps=T, mode="sequential",
                          micro_batches=jcfg.micro_batches)
    acc0 = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), jp)
    one = jnp.float32(1.0)
    accj, lossj = jax.jit(partial(
        jcore.sequential_client_step, lambda p, x, k: jm.loss_fn(p, x),
        jsteps.make_optimizer_for(jcfg), fed))(
        jp, acc0, {k: jnp.asarray(v) for k, v in b.items()}, one, one, one,
        jax.random.PRNGKey(0), jnp.int32(0))
    acc = _real(tb.args[1], tree_map(
        lambda x: torch.zeros(x.shape, dtype=torch.float32), tp))
    acct, losst = tb.fn(_real(tb.args[0], tp), acc,
                        _real(tb.args[2], {k: torch.tensor(v)
                                           for k, v in b.items()}),
                        *tb.args[3:])
    np.testing.assert_allclose(float(losst), float(lossj), **LOSS_TOL)
    _adam_check(acct, jax.tree.map(np.asarray, accj), tp, 1.0)


# ------------------------------------------------ the reference's failing --
def _run_train(cfg, mesh=None, seed=0):
    """The port's train bundle executed on the CPU from the port's own
    init; returns (new global model, metrics)."""
    tb = tsteps.build_step(cfg, TRAIN, mesh, device="cpu", local_steps=T)
    params = get_model(cfg).init_params(torch.Generator().manual_seed(seed))
    C = tb.meta.get("client_groups", 1)
    bc = tb.meta.get("batch_per_client", TRAIN.global_batch)
    b = _batch(cfg, (C, T, bc), TRAIN.seq_len, seed=seed + 1)
    batch = _real(tb.args[1], {k: torch.tensor(v) for k, v in b.items()})
    return tb.fn(_real(tb.args[0], params), batch, *tb.args[2:])


def test_parallel_round_step_executes():
    w, m = _run_train(get_smoke_config("granite-3-2b"))
    assert np.isfinite(float(m["loss"]))
    assert float(m["participants"]) >= 1


def test_dp_mode_matches_tp_mode():
    """model_axis_role=dp changes the layout only: the same numbers, and on
    the production layout other specs (weights off the model axis, the
    per-client batch split over it)."""
    cfg_tp = get_smoke_config("granite-3-2b")
    cfg_dp = dataclasses.replace(cfg_tp, model_axis_role="dp")
    w1, m1 = _run_train(cfg_tp)
    w2, m2 = _run_train(cfg_dp)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for a, b in zip(tree_leaves(w1), tree_leaves(w2)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=2e-4, atol=2e-4)
    big = InputShape("b", 16, 256, "train")
    single = tmesh.production_spec_mesh()
    tp_b = tsteps.build_step(cfg_tp, big, single, device="cpu",
                             local_steps=1)
    dp_b = tsteps.build_step(cfg_dp, big, single, device="cpu",
                             local_steps=1)
    assert tp_b.in_specs[0]["layers"]["attn"]["wq"][2] == "model"
    assert dp_b.in_specs[0]["layers"]["attn"]["wq"][2] is None
    assert dp_b.in_specs[1]["tokens"][:3] == ("data", None, "model")
    assert tp_b.in_specs[1]["tokens"][:3] == ("data", None, None)


def test_blocked_attention_matches_naive_in_round():
    cfg = get_smoke_config("starcoder2-7b")
    cfg_b = dataclasses.replace(cfg, attn_blocked=True, attn_block_k=8)
    _, m1 = _run_train(cfg)
    _, m2 = _run_train(cfg_b)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-4)


def test_micro_batches_match_full_batch():
    """Gradient accumulation is exact for mean losses (linear in grads)."""
    cfg = get_smoke_config("granite-8b")
    cfg_mb = dataclasses.replace(cfg, micro_batches=2)
    w1, m1 = _run_train(cfg)
    w2, m2 = _run_train(cfg_mb)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for a, b in zip(tree_leaves(w1), tree_leaves(w2)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=2e-4, atol=2e-4)


def test_decode_step_bundle_executes():
    cfg = get_smoke_config("mamba2-1.3b")
    tb = tsteps.build_step(cfg, DECODE, None, device="cpu")
    model = get_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    cache = model.init_cache(DECODE.global_batch, 0, device="cpu")
    tok = torch.zeros((DECODE.global_batch,), dtype=torch.int32)
    logits, cache = tb.fn(params, tok, _real(tb.args[2], cache),
                          torch.tensor(3, dtype=torch.int32))
    assert tuple(logits.shape) == (DECODE.global_batch, cfg.vocab_size)
    assert torch.isfinite(logits).all()


def test_sequential_round_equals_parallel_round_at_one_client():
    """Linearity of eq. 13: the sequential bundle's accumulator applied to
    the global model is the parallel bundle's round at C = 1."""
    cfg = get_smoke_config("granite-3-2b")
    w_par, m_par = _run_train(cfg)
    seq = dataclasses.replace(cfg, fed_mode="sequential")
    tb = tsteps.build_step(seq, TRAIN, None, device="cpu", local_steps=T)
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0))
    b = _batch(cfg, (1, T, TRAIN.global_batch), TRAIN.seq_len, seed=1)
    acc = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32),
                   params)
    acc, loss = tb.fn(params, acc, {k: torch.tensor(v[0])
                                    for k, v in b.items()}, *tb.args[3:])
    np.testing.assert_allclose(float(loss), float(m_par["loss"]),
                               rtol=1e-5)
    _adam_check(apply_accumulated(params, acc), w_par, params, 1.0)
