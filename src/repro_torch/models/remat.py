"""Per-layer rematerialisation, the port's counterpart of ``jax.checkpoint``.

``remat(fn)`` turns a layer function ``fn(x, p, *extra) -> out`` (``out`` a
tensor or a tuple of tensors) into one that keeps only its inputs for the
backward pass: the forward runs without recording a graph, and the
backward runs ``fn`` again under ``torch.func.vjp`` to pull the cotangents
back.  A model applies it where the reference applies ``jax.checkpoint``,
when ``cfg.remat`` is set.

It is a ``torch.autograd.Function`` with ``generate_vmap_rule``, so that
it runs under the client-stacked round's ``torch.func.vmap(grad(...))``,
where ``torch.utils.checkpoint`` cannot (its saved-tensor hooks are not
supported by the ``torch.func`` transforms).  Every tensor the layer reads
goes in as an input of the Function: ``x``, the leaves of ``p`` (flattened
with ``repro_torch.tree`` and rebuilt inside) and every tensor among
``extra``; only the tree's structure and the non-tensor arguments are
closed over.  So a tensor batched under ``vmap``, or one that needs a
gradient (an encoder's memory), is never captured.
"""
from __future__ import annotations

import torch
from torch.func import vjp

from repro_torch.tree import tree_leaves, tree_map


class _Remat(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(body, *tensors):
        return body(*tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.body = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *cotangents):
        # detached: ``torch.func.grad`` runs the backward with
        # create_graph=True, and a recomputation recorded into that graph
        # would keep every layer's activations alive until the transform
        # returns
        saved = [t.detach() for t in ctx.saved_tensors]
        cotangents = tuple(t.detach() for t in cotangents)
        wanted = [i for i, need in enumerate(ctx.needs_input_grad[1:])
                  if need]

        def pulled(*primals):
            args = list(saved)
            for i, t in zip(wanted, primals):
                args[i] = t
            return ctx.body(*args)

        with torch.enable_grad():
            _, pullback = vjp(pulled, *(saved[i] for i in wanted))
        grads = pullback(cotangents if len(cotangents) > 1 else cotangents[0])
        out = [None] * len(saved)
        for i, g in zip(wanted, grads):
            out[i] = g
        return (None, *out)


def remat(fn):
    """``fn(x, p, *extra)`` rematerialised: the same outputs, with only
    ``x``, the leaves of the tree ``p`` and the tensors among ``extra``
    saved for the backward pass."""
    def wrapped(x, p, *extra):
        leaves = tree_leaves(p)
        shape = tree_map(lambda _: None, p)
        slots = [i for i, e in enumerate(extra) if isinstance(e, torch.Tensor)]
        fixed = [None if i in slots else e for i, e in enumerate(extra)]
        n = len(leaves)

        def body(x, *tensors):
            it = iter(tensors[:n])
            rest = list(fixed)
            for i, t in zip(slots, tensors[n:]):
                rest[i] = t
            return fn(x, tree_map(lambda _: next(it), shape), *rest)

        return _Remat.apply(body, x, *leaves, *(extra[i] for i in slots))

    return wrapped
