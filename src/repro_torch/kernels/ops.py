"""Device dispatch for the kernels: a CUDA tensor launches the kernel (or
the wrapper raises), a CPU tensor takes the kernel's plain version.  There
is no fallback from one to the other.

``flash_attention``, ``ssd_scan``, ``fused_agg`` and ``fused_agg_tree`` go
through ``torch.library`` custom ops (``torch.ops.repro_torch.*``), so
that a shape-only trace (``FakeTensorMode``, `launch.dryrun`) reaches
each op's fake implementation, which allocates its outputs and launches
nothing, and ``torch.utils.flop_counter.FlopCounterMode`` prices each op
at the kernel's own work (causal and windowed attention at the pairs the
mask keeps; the scan's chunked products; 2 C M for an aggregation), not
at its plain version's.  On a real tensor an op's implementation is the
dispatch by device above; only a launch there adds to a kernel's
``launches``.  The ops have no autograd formula: the training path runs
on the plain functions (``impl="ref"``), as the reference trains.

**On DTensors** (``torch.distributed.tensor``, a step run across ranks by
`launch.steps.execute`) each op has a sharding rule
(`register_sharding_rules`, registered the first time a wrapper meets a
DTensor): the placements a rank can compute from its own shards alone,
one mesh dim at a time (DTensor expands them over the mesh).  DTensor
picks the rule that moves least, redistributes the inputs to it, and
calls the op on each rank's local tensors, so the kernel (on the CPU its
plain version) runs on the local shard; a placement that no rule lists
is redistributed to one that does, never computed elsewhere.
``fused_agg`` / ``fused_agg_tree`` list ``Replicate()`` only: the split
of a round's client axis over ranks is `core.aggregation.aggregate`'s."""
from __future__ import annotations

import functools

import torch
from torch.library import custom_op
from torch.utils.flop_counter import register_flop_formula

from repro_torch.device import is_dtensor
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fleet_step as _fleet
from repro_torch.kernels import fused_agg as _agg
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.tree import tree_leaves, tree_map

Tensor = torch.Tensor


def _on_kernel_device(name: str, t: Tensor) -> None:
    """Raise for a device that has neither the kernel nor its plain version
    (e.g. ``meta``; a fake tensor reports the device it stands for)."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: no kernel for device {t.device}")


# ---------------------------------------------------------------- flash ----
@custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: Tensor, k: Tensor, v: Tensor, causal: bool,
              window: int) -> Tensor:
    if q.device.type == "cuda":
        return _fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        return _fa.flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


@_flash_op.register_fake
def _(q, k, v, causal, window):
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _(q_shape, k_shape, v_shape, causal, window, *args, out_shape=None,
      **kwargs) -> int:
    B, Sq, H, D = q_shape
    return _fa.work_flops(B, Sq, k_shape[1], H, D, causal, window)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B, Sq, H, D); k, v (B, Skv, K, D) with H % K == 0 (GQA mapped
    inside).  Returns (B, Sq, H, D) in q's dtype."""
    _on_kernel_device("flash_attention", q)
    if is_dtensor(q):
        register_sharding_rules()
        q, k, v = _split_replicated(flash_placements(q, k, v, causal, window),
                                    q, k, v)
    return _flash_op(q, k, v, bool(causal), int(window))


# ------------------------------------------------------------- ssd_scan ----
@custom_op("repro_torch::ssd_scan", mutates_args=())
def _ssd_op(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
            chunk: int) -> tuple[Tensor, Tensor]:
    if x.device.type == "cuda":
        return _ssd.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=chunk)
    if x.device.type == "cpu":
        return _ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
    raise ValueError(f"ssd_scan: no kernel for device {x.device}")


@_ssd_op.register_fake
def _(x, dt, A, Bm, Cm, chunk):
    B, S, H, P = x.shape
    f32 = torch.float32
    return (x.new_empty((B, S, H, P), dtype=f32),
            x.new_empty((B, H, P, Bm.shape[3]), dtype=f32))


@register_flop_formula(torch.ops.repro_torch.ssd_scan)
def _(x_shape, dt_shape, A_shape, B_shape, C_shape, chunk, *args,
      out_shape=None, **kwargs) -> int:
    B, S, H, P = x_shape
    return _ssd.work_flops(B, S, H, P, B_shape[2], B_shape[3], chunk)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int):
    """Chunked SSD scan: x (B, S, H, P), dt (B, S, H) fp32, A (H,) fp32,
    Bm / Cm (B, S, G, N) with H % G == 0 (groups mapped inside).  Returns
    (y (B, S, H, P) fp32, final state (B, H, P, N) fp32)."""
    _on_kernel_device("ssd_scan", x)
    if is_dtensor(x):
        register_sharding_rules()
        x, dt, A, Bm, Cm = _split_replicated(
            ssd_placements(x, dt, A, Bm, Cm, chunk), x, dt, A, Bm, Cm)
    return _ssd_op(x, dt, A, Bm, Cm, int(chunk))


def ssd_scan_y(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """``ssd_scan`` with the JAX package kernel's signature and result:
    Bm / Cm may be pre-repeated to heads, and only y comes back, in x's
    dtype."""
    return ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)[0].to(x.dtype)


# ------------------------------------------------------------ fused_agg ----
@custom_op("repro_torch::fused_agg", mutates_args=())
def _agg_op(w: Tensor, w_stack: Tensor, s: Tensor) -> Tensor:
    if w.device.type == "cuda":
        return _agg.fused_agg_cuda(w, w_stack, s)
    if w.device.type == "cpu":
        return _agg.fused_agg_plain(w, w_stack, s)
    raise ValueError(f"fused_agg: no kernel for device {w.device}")


@_agg_op.register_fake
def _(w, w_stack, s):
    return w.new_empty(w.shape)


@register_flop_formula(torch.ops.repro_torch.fused_agg)
def _(w_shape, ws_shape, s_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * ws_shape[0] * ws_shape[1]


def fused_agg(w, w_stack, s):
    """w (M,), w_stack (C, M), s (C,) float32 -> (M,) in w's dtype:
    w (1 - sum s) + s @ w_stack, i.e. w + sum_c s_c (w_stack[c] - w)."""
    _on_kernel_device("fused_agg", w)
    if is_dtensor(w):
        register_sharding_rules()
    return _agg_op(w, w_stack, s)


@custom_op("repro_torch::fused_agg_tree", mutates_args=())
def _agg_tree_op(ws: list[Tensor], w_stacks: list[Tensor],
                 s: Tensor) -> list[Tensor]:
    dev = ws[0].device
    if dev.type == "cuda":
        return _agg.fused_agg_tree_cuda(ws, w_stacks, s)
    if dev.type == "cpu":
        return [_agg.fused_agg_plain(w.reshape(-1),
                                     st.reshape(st.shape[0], -1), s)
                .reshape(w.shape) for w, st in zip(ws, w_stacks)]
    raise ValueError(f"fused_agg: no kernel for device {dev}")


@_agg_tree_op.register_fake
def _(ws, w_stacks, s):
    return [w.new_empty(w.shape) for w in ws]


@register_flop_formula(torch.ops.repro_torch.fused_agg_tree)
def _(ws_shapes, ws_stack_shapes, s_shape, *args, out_shape=None,
      **kwargs) -> int:
    return sum(2 * st.numel() for st in ws_stack_shapes)


def fused_agg_tree(w_global, w_stack, s):
    """``fused_agg`` over a tree, each leaf flattened: w_global's leaves
    (...), w_stack's (C, ...).  On the card one launch per tree (per
    dtype); on the CPU leaf by leaf."""
    ws, stacks = tree_leaves(w_global), tree_leaves(w_stack)
    if not ws or len(ws) != len(stacks):
        raise ValueError(f"fused_agg_tree: w_global has {len(ws)} leaves, "
                         f"w_stack {len(stacks)}")
    _on_kernel_device("fused_agg", ws[0])
    if is_dtensor(ws[0]):
        register_sharding_rules()
    outs = iter(_agg_tree_op(ws, stacks, s))
    return tree_map(lambda w: next(outs), w_global)


# ------------------------------------------------------ sharding rules ----
def _divides(n: int, spec) -> bool:
    """True where ``n`` splits evenly over every dim of the mesh of
    ``spec`` (DTensor's spec of an argument, or a DTensor) at once, so
    over any mesh dims a head split lands on."""
    mesh = getattr(spec, "mesh", None) or spec.device_mesh
    return n % mesh.size() == 0


def _split_replicated(rules, *ts):
    """DTensor inputs of an op, contiguous (the kernels' wrappers read
    local tensors through pointers), each mesh dim of more than one rank
    over which every one of them is replicated split by the op's first
    split rule: a local slice, no collective, so that each rank's kernel
    takes its shard and not the whole tensor (DTensor itself keeps a
    replicated call replicated, the cheapest).  Other mesh dims are left
    to DTensor and the rules."""
    from torch.distributed.tensor import Replicate

    ts = tuple(t.contiguous() for t in ts)
    mesh, first = ts[0].device_mesh, rules[1][1]
    whole = [mesh.size(i) > 1
             and all(isinstance(t.placements[i], Replicate) for t in ts)
             and all(pl is None or pl.is_replicate()
                     or t.shape[pl.dim] >= mesh.size(i)  # no empty shard
                     for t, pl in zip(ts, first))
             for i in range(mesh.ndim)]
    out = []
    for t, pl in zip(ts, first):
        want = [pl if w else p for w, p in zip(whole, t.placements)]
        out.append(t if want == list(t.placements)
                   else t.redistribute(mesh, want))
    return tuple(out)


def flash_placements(q, k, v, causal, window):
    """One mesh dim's placements of flash_attention (out, then q, k, v):
    replicated; heads (dim 2) where H and K both split evenly, whose
    contiguous head blocks keep each query head with its KV head
    (h // (H / K) on the full tensor is j // (H / K) on a block); batch
    (dim 0).  Replicated comes first: DTensor takes the first of the
    cheapest, and a mesh dim of one rank stays replicated (a batch of one
    "split" there could not be viewed away after the op); the wrappers
    split replicated inputs over the dims that have ranks to split over
    (`_split_replicated`)."""
    from torch.distributed.tensor import Replicate, Shard

    R, S0, S2 = Replicate(), Shard(0), Shard(2)
    rules = [([R], [R, R, R, None, None]),
             ([S0], [S0, S0, S0, None, None])]
    if _divides(q.shape[2], q) and _divides(k.shape[2], q):
        rules.insert(1, ([S2], [S2, S2, S2, None, None]))
    return rules


def ssd_placements(x, dt, A, Bm, Cm, chunk):
    """One mesh dim's placements of ssd_scan (y, state, then x, dt, A, Bm,
    Cm): replicated; heads (x and dt on dim 2, A on dim 0, y on 2, the
    state on 1) with Bm / Cm split on their groups where G splits evenly
    and replicated where G = 1 (every head reads group 0); batch; in that
    order, as for flash.  The sequence is never split: the scan carries
    its state along it."""
    from torch.distributed.tensor import Replicate, Shard

    R, S0, S1, S2 = Replicate(), Shard(0), Shard(1), Shard(2)
    rules = [([R, R], [R, R, R, R, R, None]),
             ([S0, S0], [S0, S0, R, S0, S0, None])]
    if _divides(x.shape[2], x):
        G = Bm.shape[2]
        if _divides(G, x):
            rules.insert(1, ([S2, S1], [S2, S2, S0, S2, S2, None]))
        elif G == 1:
            rules.insert(1, ([S2, S1], [S2, S2, S0, R, R, None]))
    return rules


def agg_placements(w, w_stack, s):
    """fused_agg: replicated only (the client split is `aggregate`'s)."""
    from torch.distributed.tensor import Replicate

    return [([Replicate()], [Replicate()] * 3)]


def agg_tree_placements(ws, w_stacks, s):
    """fused_agg_tree: replicated only, a placement a leaf (outputs, then
    the leaves of w_global, of w_stack, and s, flattened)."""
    from torch.distributed.tensor import Replicate

    R = Replicate()
    return [([R] * len(ws), [R] * (len(ws) + len(w_stacks) + 1))]


def squeeze_dims_placements(x, dims):
    """One mesh dim's placements of ``aten.squeeze.dims`` (the gradient of
    a broadcast under ``torch.func.grad``), for a DTensor that has no
    strategy for it (torch 2.11's): replicated, partial, and a split
    of any dim the call does not name, renumbered past the dims it
    drops (a named dim is never split: its local size could be 1 where
    its global size is not)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    nd = len(x.shape)
    named = {d % nd for d in dims} if nd else set()
    gone = {d for d in named if x.shape[d] == 1}
    kept = [d for d in range(nd) if d not in gone]
    rules = [([Replicate()], [Replicate(), None]),
             ([Partial()], [Partial(), None])]
    rules += [([Shard(i)], [Shard(d), None])
              for i, d in enumerate(kept) if d not in named]
    return rules


def _register_rule(op, rule, static_argnum: int = 100) -> None:
    """``register_sharding(op)(rule)`` with the schema's non-tensor
    arguments from ``static_argnum`` on in DTensor's cache key
    (``register_sharding`` keys on int arguments only, not on a list of
    them), and a list output counted one output an entry
    (``register_sharding`` counts a returned list as one)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor._ops.utils import \
        expand_to_full_mesh_op_strategy

    def strategy(op_schema):
        acceptable = rule(*(getattr(a, "children", a)
                            for a in op_schema.args_schema))
        out = expand_to_full_mesh_op_strategy(
            op_schema.get_mesh_from_args(), op_schema,
            [list(out) + list(inp) for out, inp in acceptable],
            input_index=len(acceptable[0][0]))
        if op._schema.returns[0].type.kind() == "ListType":
            for spec in out.strategies:   # a list of one is still a list
                if not isinstance(spec.output_specs, tuple):
                    spec.output_specs = (spec.output_specs,)
        return out

    DTensor._op_dispatcher.sharding_propagator.register_op_strategy(
        op, strategy, RuntimeSchemaInfo(static_argnum, needs_pytree=True))


def _has_strategy(op) -> bool:
    from torch.distributed.tensor import DTensor

    prop = DTensor._op_dispatcher.sharding_propagator
    return any(op in getattr(prop, name, {}) for name in (
        "op_strategy_funcs", "op_single_dim_strategy_funcs", "op_to_rules"))


@functools.cache
def register_sharding_rules() -> dict:
    """Register each custom op's rule with DTensor (once a process), and
    ``squeeze_dims_placements`` where DTensor has no strategy for
    ``aten.squeeze.dims``; returns the rules registered, by op name."""
    from torch.distributed.tensor.experimental import register_sharding

    rules = {"flash_attention": flash_placements,
             "ssd_scan": ssd_placements,
             "fused_agg": agg_placements}
    for name, rule in rules.items():
        register_sharding(getattr(torch.ops.repro_torch, name).default)(rule)
    _register_rule(torch.ops.repro_torch.fused_agg_tree.default,
                   agg_tree_placements)
    rules["fused_agg_tree"] = agg_tree_placements
    squeeze = torch.ops.aten.squeeze.dims
    if not _has_strategy(squeeze):
        _register_rule(squeeze, squeeze_dims_placements, static_argnum=1)
        rules["aten.squeeze.dims"] = squeeze_dims_placements
    return rules


def fleet_step(program, env, *, n: int, emit: bool = False,
               num_groups: int | None = None, mesh=None):
    """One round of the fleet's step program over ``n`` clients (``env``
    as ``kernels.fleet_step`` takes it): (state, emits, stats).  With a
    ``mesh`` the fleet is sharded over its ranks: ``n`` is the padded
    width of the whole fleet and ``env`` this rank's slab
    (``fused_step_sharded``)."""
    if mesh is not None:
        return _fleet.fused_step_sharded(program, env, n=n, mesh=mesh,
                                         emit=emit, num_groups=num_groups)
    dev = env["charge"].device
    if dev.type == "cuda":
        return _fleet.fleet_step_cuda(program, env, n=n, emit=emit,
                                      num_groups=num_groups)
    if dev.type == "cpu":
        return _fleet.fleet_step_plain(program, env, n=n, emit=emit,
                                       num_groups=num_groups)
    raise ValueError(f"fleet_step: no kernel for device {dev}")


def backend(device) -> str:
    """The executor of the port's kernels on ``device`` (a run manifest's
    ``backend``): ``"cuda"``, the hand-written kernels, on the card and
    ``"plain"``, their plain versions, on the CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "plain"


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port, by kernel name.  Each adds one to
    its ``.launches`` where it launches its kernel, and nowhere else (the
    serve program of fleet_step has its own wrapper and count;
    ``fused_agg_tree_cuda`` launches the fused_agg kernel and counts on
    ``fused_agg_cuda.launches``)."""
    return {"flash_attention": _fa.flash_attention_cuda,
            "fused_agg": _agg.fused_agg_cuda,
            "fleet_step": _fleet.fleet_step_cuda,
            "serve_step": _fleet.serve_step_cuda,
            "ssd_scan": _ssd.ssd_scan_cuda}


def finalize_wrappers() -> dict:
    """The sharded fleet's finalize wrappers, by the kernel whose library
    holds them; each counts its one-block launches on ``.launches``, apart
    from the kernel's main launches."""
    return {"fleet_step": _fleet.fleet_finalize_cuda,
            "serve_step": _fleet.serve_finalize_cuda}


def launch_counts() -> dict:
    """Each kernel's launches so far, by kernel name."""
    return {name: w.launches for name, w in kernel_wrappers().items()}


def finalize_counts() -> dict:
    """Each finalize's launches so far, by kernel name."""
    return {name: w.launches for name, w in finalize_wrappers().items()}


def zero_launches():
    for wrapper in (list(kernel_wrappers().values())
                    + list(finalize_wrappers().values())):
        wrapper.launches = 0
