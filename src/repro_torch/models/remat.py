"""Rematerialization that composes with ``torch.func`` (the reference's
``jax.checkpoint``).

``torch.utils.checkpoint`` works by saved-tensor hooks, which
``torch.func.grad`` and ``vjp`` refuse. :func:`checkpoint` is a
``torch.autograd.Function`` instead: its forward runs the block and keeps
nothing but the block's inputs; its backward runs the block again under
``torch.func.vjp`` and pulls the output gradients back through it. It
has a generated ``vmap`` rule, so it runs under
``torch.func.vmap(grad_and_value(...))`` (the PoFEL trainer's
``local_step``, the batched FEL engine), and the kernels' own Functions
inside the block fold the vmapped axis as they do without it: the flash
and wkv6 forward launch once in the forward and once more in the
backward, before their backward kernels.

The forward's outputs are those of the block run without it, bit for
bit. Gradients may differ in the last float32 bit: the vjp of the
re-run block adds up a weight's uses inside the block in an order of its
own.

On DTensors (the mesh path, which differentiates with
``torch.autograd.grad``: ``torch.func`` takes no DTensor) it is
``torch.utils.checkpoint``'s non-reentrant checkpoint, which keeps the
same inputs and re-runs the block under autograd.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.kernels._dtensor import is_dtensor


class _Remat(torch.autograd.Function):
    """``run(*tensors)`` → a tuple of tensors, with only ``tensors``
    saved for the backward."""

    generate_vmap_rule = True

    @staticmethod
    def forward(run, *tensors):
        return run(*tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.run = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *grads):
        tensors = ctx.saved_tensors
        diff = [i for i, t in enumerate(tensors) if t.is_floating_point()]

        def again(*floats):
            full = list(tensors)
            for i, t in zip(diff, floats):
                full[i] = t
            return ctx.run(*full)

        outs, pull = torch.func.vjp(again, *(tensors[i] for i in diff))
        pulled = pull(tuple(torch.zeros_like(o) if g is None else g
                            for o, g in zip(outs, grads)))
        res = [None] * len(tensors)
        for i, g in zip(diff, pulled):
            res[i] = g
        return (None, *res)


def checkpoint(fn: Callable, *args):
    """``fn(*args)``, rematerialized in the backward. ``args`` are trees
    (dicts, tuples, lists) of tensors and other values; ``fn`` returns a
    tensor or a tuple of tensors, which is what this returns. Nothing
    computed inside ``fn`` is kept for the backward."""
    leaves, spec = tree_flatten(args)
    is_tensor = [isinstance(x, torch.Tensor) for x in leaves]
    if any(is_dtensor(x) for x in leaves):
        from torch.utils.checkpoint import checkpoint as torch_checkpoint
        return torch_checkpoint(fn, *args, use_reentrant=False)
    others = [x for x, t in zip(leaves, is_tensor) if not t]
    returned = {}

    def run(*tensors):
        ts, os_ = iter(tensors), iter(others)
        full = [next(ts) if t else next(os_) for t in is_tensor]
        out = fn(*tree_unflatten(full, spec))
        returned["tensor"] = isinstance(out, torch.Tensor)
        return (out,) if returned["tensor"] else tuple(out)

    out = _Remat.apply(run, *(x for x, t in zip(leaves, is_tensor) if t))
    return out[0] if returned["tensor"] else out


__all__ = ["checkpoint"]
