"""Step bundles: the train, prefill and decode steps of an (architecture,
input shape, mesh), with shape-only example arguments and the specs of
their inputs and outputs (port of the JAX package's ``launch/steps.py``).

* ``train``   — one federated global round (Algorithm 1) in the arch's fed
  mode: ``parallel`` (``core.round.parallel_round``, one client group a
  slice of the data axes: C = the data-axis size, 1 on the card alone) or
  ``sequential`` (``sequential_client_step``: one client over the whole
  mesh, a float32 delta accumulator, FSDP specs).
* ``prefill`` — the prompt pass: last-position logits and the filled cache,
  through the kernels (``flash_attention`` for the attention families,
  ``ssd_scan`` for Mamba2's chunk-divisible prompts).
* ``decode``  — one token against a ``seq_len`` cache; archs without a
  sub-quadratic serving path take the sliding-window variant past 100k
  tokens (``_serve_variant``).

A bundle's ``args`` are fake tensors (``FakeTensorMode``, the counterpart of
``jax.eval_shape``) on the target device, made by one fake mode
(``fake_mode_of``), beside real CPU values where the step reads a number
on the host (the round index, the step offset) and for the small
scheduling inputs (p, E, the key).  `launch.dryrun` traces a bundle with
them; a caller that executes ``fn`` passes real tensors of the same shapes
and dtypes.  ``mesh`` is None (the card alone, a 1 x 1 layout), a
``launch.mesh.SpecMesh`` (a layout, for its specs) or a ``DeviceMesh``;
the specs are `dist.sharding`'s.

`execute` runs a bundle: with no mesh it calls ``fn`` as it is; with a
``DeviceMesh`` (one process a rank, the bundle built for that mesh) it
places the arguments by ``in_specs``, runs ``fn`` once on the DTensors
under ``implicit_replication`` and returns the outputs at ``out_specs``,
the port's ``jax.jit(fn, in_shardings, out_shardings)``.  The kernels run
on each rank's local shard through their sharding rules
(`kernels.ops.register_sharding_rules`), the parallel round's aggregation
on each rank's client rows (`core.aggregation.aggregate`).
"""
from __future__ import annotations

import dataclasses
import warnings
from functools import partial
from typing import Any

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from repro_torch import prng
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.round import (FedConfig, parallel_round,
                                    sequential_client_step)
from repro_torch.dist import sharding as shard
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import card_spec_mesh
from repro_torch.models import get_model
from repro_torch.models.layers import dtype_of
from repro_torch.optim import adam, sgd
from repro_torch.tree import tree_leaves, tree_map

F32 = torch.float32
I32 = torch.int32
P = shard.P


@dataclasses.dataclass(frozen=True)
class StepBundle:
    kind: str
    fn: Any
    args: tuple
    in_specs: tuple
    out_specs: Any
    meta: dict


def fake_mode_of(bundle: StepBundle) -> FakeTensorMode:
    """The fake mode that made a bundle's fake arguments: trace ``fn``
    under it."""
    for x in tree_leaves(bundle.args):
        if isinstance(x, FakeTensor):
            return x.fake_mode
    raise ValueError("the bundle holds no fake tensor")


def _spec_mesh(mesh):
    return card_spec_mesh() if mesh is None else mesh


def _eval_params(model, mode: FakeTensorMode, device):
    with mode:
        return model.init_params(torch.Generator(device=device)
                                 .manual_seed(0))


def _fake(mode: FakeTensorMode, shape, dtype, device):
    with mode:
        return torch.empty(shape, dtype=dtype, device=device)


def _batch_struct(cfg: ModelConfig, lead: tuple, seq: int, mode, device):
    """The model inputs with leading dims ``lead`` (e.g. (C, T, B)): int32
    tokens, and the vlm's ``vision_embeds`` / the encdec's ``frames`` in
    the model dtype."""
    b = {"tokens": _fake(mode, lead + (seq,), I32, device)}
    if cfg.family == "vlm":
        b["vision_embeds"] = _fake(mode, lead + (cfg.vision_tokens,
                                                 cfg.d_model),
                                   dtype_of(cfg), device)
    if cfg.family == "encdec":
        b["frames"] = _fake(mode, lead + (cfg.encoder_seq, cfg.d_model),
                            dtype_of(cfg), device)
    return b


def _batch_specs(batch, mesh, batch_dim: int, batch_size: int):
    return {k: shard.batch_spec(mesh, v.dim(), batch_dim, batch_size)
            for k, v in batch.items()}


def make_optimizer_for(cfg: ModelConfig, name: str | None = None,
                       lr: float = 1e-4):
    name = name or cfg.optimizer
    if name == "adam":
        return adam(lr)
    if name == "sgd_momentum":
        return sgd(lr, momentum=0.9)
    return sgd(lr)


# ------------------------------------------------------------- training ----
def build_train_step(cfg: ModelConfig, shape: InputShape, mesh=None,
                     local_steps: int = 5, optimizer: str | None = None,
                     device="cuda") -> StepBundle:
    dp_mode = cfg.model_axis_role == "dp"
    if dp_mode and cfg.shard_logits_vocab:
        # the vocab-over-model logits hint conflicts with batch-over-model
        cfg = dataclasses.replace(cfg, shard_logits_vocab=False)
    model = get_model(cfg)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    params = _eval_params(model, mode, device)
    opt = make_optimizer_for(cfg, optimizer)
    smesh = _spec_mesh(mesh)
    daxes = shard.data_axes(smesh)
    C = shard.mesh_axis_size(smesh, daxes)   # client groups (parallel mode)
    model_axis = None if dp_mode else "model"

    def loss_fn(p, batch, rng):
        return model.loss_fn(p, batch)

    if cfg.fed_mode == "parallel":
        if shape.global_batch % C:
            raise ValueError(f"global batch {shape.global_batch} does not "
                             f"divide into {C} client groups")
        bc = shape.global_batch // C
        fed = FedConfig(num_clients=C, local_steps=local_steps,
                        policy="sustainable",
                        micro_batches=cfg.micro_batches)
        batches = _batch_struct(cfg, (C, local_steps, bc), shape.seq_len,
                                mode, device)
        args = (params, batches,
                torch.full((C,), 1.0 / C, dtype=F32),       # p_i
                torch.ones((C,), dtype=I32),                # E_i
                0,                                          # round index
                prng.PRNGKey(0))                            # this round's key
        p_specs = shard.param_specs(params, smesh, model_axis=model_axis)
        if dp_mode:
            # the per-client batch dim also split over the model axis
            # (weights replicated there), where it divides
            msplit = "model" if bc % shard.mesh_axis_size(smesh, "model") \
                == 0 else None
            lead = daxes if len(daxes) > 1 else daxes[0]
            b_specs = {k: P(lead, None, msplit, *((None,) * (v.dim() - 3)))
                       for k, v in batches.items()}
        else:
            b_specs = _batch_specs(batches, smesh, 0, C)
        in_specs = (p_specs, b_specs, P(), P(), P(), P())
        out_specs = (p_specs, {"loss": P(), "participants": P()})
        zero = "model" if (dp_mode and cfg.zero_opt_over_model) else None
        fn = partial(parallel_round, loss_fn, opt, fed,
                     constrain=shard.stacked_constrainer(
                         mesh, model_axis=model_axis),
                     constrain_opt=shard.stacked_constrainer(
                         mesh, model_axis=model_axis, zero_axis=zero))
        meta = dict(mode="parallel", client_groups=C, batch_per_client=bc,
                    local_steps=local_steps,
                    model_axis_role=cfg.model_axis_role,
                    micro_batches=cfg.micro_batches,
                    zero_opt=cfg.zero_opt_over_model)
    else:
        fed = FedConfig(num_clients=C, local_steps=local_steps,
                        policy="sustainable",
                        micro_batches=cfg.micro_batches)
        batches = _batch_struct(cfg, (local_steps, shape.global_batch),
                                shape.seq_len, mode, device)
        with mode:
            acc = tree_map(lambda x: torch.empty(x.shape, dtype=F32,
                                                 device=x.device), params)
        one = torch.ones((), dtype=F32)
        args = (params, acc, batches, one, one, one,  # p_i, E_i, alpha_i
                prng.PRNGKey(0),
                0)                                    # step_offset (rnd * T)
        p_specs = shard.param_specs(params, smesh, fsdp=True)
        in_specs = (p_specs, p_specs,
                    _batch_specs(batches, smesh, 1, shape.global_batch),
                    P(), P(), P(), P(), P())
        out_specs = (p_specs, P())
        fn = partial(sequential_client_step, loss_fn, opt, fed)
        meta = dict(mode="sequential", local_steps=local_steps,
                    micro_batches=cfg.micro_batches)
    return StepBundle("train", fn, args, in_specs, out_specs,
                      dict(meta, device=str(torch.device(device))))


# -------------------------------------------------------------- serving ----
def _serve_variant(cfg: ModelConfig, shape: InputShape) -> dict:
    """Cache length / ring / window of this (arch, shape)."""
    if cfg.family in ("ssm",):
        return dict(cache_len=0, ring=False, window=None)
    if cfg.family == "hybrid":
        return dict(cache_len=cfg.local_window, ring=True, window=None)
    native_w = cfg.sliding_window
    if native_w:
        W = min(native_w, shape.seq_len)
        return dict(cache_len=W, ring=True, window=native_w)
    if shape.seq_len > 100_000:
        # the long-context serving variant of full-attention archs
        W = cfg.serve_swa_window
        return dict(cache_len=W, ring=True, window=W, swa_variant=True)
    return dict(cache_len=shape.seq_len, ring=False, window=None)


def kernel_impl(cfg: ModelConfig) -> str | None:
    """The prefill's ``impl`` that goes through the kernels: ``"flash"``
    for the attention families; None for Mamba2, whose chunked path is
    ``ops.ssd_scan`` (``"ref"`` is each family's plain path)."""
    return None if cfg.family == "ssm" else "flash"


def build_prefill_step(cfg: ModelConfig, shape: InputShape, mesh=None,
                       device="cuda") -> StepBundle:
    model = get_model(cfg)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    params = _eval_params(model, mode, device)
    var = _serve_variant(cfg, shape)
    smesh = _spec_mesh(mesh)
    B = shape.global_batch

    def fn(p, batch, impl=kernel_impl(cfg)):
        return model.prefill(p, batch, cache_len=var["cache_len"] or None,
                             window=var["window"], impl=impl)

    batch = _batch_struct(cfg, (B,), shape.seq_len, mode, device)
    with mode:
        logits_s, cache_s = fn(params, batch)
    in_specs = (shard.param_specs(params, smesh),
                _batch_specs(batch, smesh, 0, B))
    out_specs = (shard.batch_spec(smesh, logits_s.dim(), 0, B),
                 shard.cache_specs(cache_s, smesh))
    return StepBundle("prefill", fn, (params, batch), in_specs, out_specs,
                      dict(var, impl=kernel_impl(cfg),
                           device=str(torch.device(device))))


def build_decode_step(cfg: ModelConfig, shape: InputShape, mesh=None,
                      device="cuda") -> StepBundle:
    model = get_model(cfg)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    params = _eval_params(model, mode, device)
    var = _serve_variant(cfg, shape)
    smesh = _spec_mesh(mesh)
    B = shape.global_batch
    cache_len = var["cache_len"] or shape.seq_len

    def fn(p, token, cache, pos):
        return model.decode_step(p, token, cache, pos, ring=var["ring"],
                                 window=var["window"])

    with mode:
        cache = model.init_cache(B, cache_len, device=device)
    token = _fake(mode, (B,), I32, device)
    pos = torch.tensor(cache_len - 1, dtype=I32)     # the cache's last slot
    with mode:
        logits_s, _ = fn(params, token, cache, pos)
    cache_sp = shard.cache_specs(cache, smesh)
    in_specs = (shard.param_specs(params, smesh),
                shard.batch_spec(smesh, 1, 0, B), cache_sp, P())
    out_specs = (shard.batch_spec(smesh, logits_s.dim(), 0, B), cache_sp)
    return StepBundle("decode", fn, (params, token, cache, pos), in_specs,
                      out_specs,
                      dict(cache_len=cache_len, **{k: v for k, v in var.items()
                                                   if k != "cache_len"},
                           device=str(torch.device(device))))


def build_step(cfg: ModelConfig, shape: InputShape, mesh=None, *,
               device="cuda", **kw) -> StepBundle:
    if shape.kind == "train":
        return build_train_step(cfg, shape, mesh, device=device, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh, device=device)
    if shape.kind == "decode":
        return build_decode_step(cfg, shape, mesh, device=device)
    raise ValueError(shape.kind)


# ------------------------------------------------------------ execution ----
def execute(bundle: StepBundle, args: tuple, mesh=None):
    """Run ``bundle.fn`` on ``args`` (real tensors of the bundle's shapes
    and dtypes, the same full values on every rank).  ``mesh`` None: the
    call as it is.  A ``DeviceMesh``: each argument placed by its
    ``in_specs`` (`dist.sharding.shard_tree`), but for the host-side
    inputs, the arguments at a bare ``P()`` (p, E, the round index, the
    key, a position, a client's weights and step offset), which pass as
    they are; ``fn`` run once under ``implicit_replication`` (those
    inputs, and tensors the step makes itself, positions and masks, are
    read as replicated); the outputs redistributed to ``out_specs``
    (DTensors; `dist.sharding.gather_tree` gathers them)."""
    if mesh is None:
        return bundle.fn(*args)
    from torch.distributed.tensor.experimental import implicit_replication

    shard.check_mesh(mesh)
    if len(args) != len(bundle.in_specs):
        raise ValueError(f"execute: {len(args)} arguments, the bundle's "
                         f"fn takes {len(bundle.in_specs)}")
    kops.register_sharding_rules()
    placed = tuple(a if spec == P() else shard.shard_tree(a, spec, mesh)
                   for a, spec in zip(args, bundle.in_specs))
    with implicit_replication(), warnings.catch_warnings():
        # a (1,) tensor (p, E, the mask at C = 1) read as replicated is
        # what implicit replication is for
        warnings.filterwarnings("ignore", message="Found a non-scalar tensor")
        out = bundle.fn(*placed)
    return shard.redistribute_tree(out, bundle.out_specs, mesh)
