"""The models' mesh path: DTensor redistributions where the reference
pins a layout.

The reference pins a tensor's layout with ``with_sharding_constraint``
and leaves the collectives to GSPMD. Here each pin is a DTensor
redistribution to the placements of the same partition spec, and each
is the identity on a plain tensor, so that the one-card path runs
exactly as before. An op DTensor has no sharding strategy for (the MoE
routing's ``searchsorted``, for one) runs on the whole tensor, as GSPMD
replicates what it cannot partition.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels._dtensor import is_dtensor

__all__ = ["constrain", "contiguous_stride", "first_dim_only", "grad_first_dim_only",
           "grad_replicated", "implicit_replication", "is_dtensor",
           "on_mesh", "replicated", "whole"]


@contextlib.contextmanager
def implicit_replication():
    """DTensor's context in which a plain tensor next to a DTensor counts
    as replicated (positions, masks, the routing's indices: every rank
    computes the same). It nests: inside an open one (this or DTensor's
    own) it does nothing, since DTensor's exit would close the outer."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import \
        implicit_replication as dtensor_implicit_replication
    if DTensor._op_dispatcher._allow_implicit_replication:
        yield
        return
    with dtensor_implicit_replication():
        yield


def on_mesh(tree):
    """:func:`implicit_replication` if a leaf of ``tree`` (a tensor or
    nested dicts, tuples and lists of them) is a DTensor, else a context
    that does nothing."""
    from torch.utils._pytree import tree_leaves
    if any(is_dtensor(t) for t in tree_leaves(tree)):
        return implicit_replication()
    return contextlib.nullcontext()


def constrain(t: torch.Tensor, *entries) -> torch.Tensor:
    """``t`` laid out by the partition spec ``entries`` (one a dim: None,
    an axis name or a tuple of them) on its own mesh; a plain tensor as
    it is. An axis the mesh lacks is dropped, as a spec names axes of
    the reference's production meshes."""
    if not is_dtensor(t):
        return t
    from repro_torch.models.sharding import PSpec, placements
    mesh = t.device_mesh
    names = set(mesh.mesh_dim_names)

    def keep(e):
        if e is None:
            return None
        axes = tuple(a for a in (e if isinstance(e, tuple) else (e,))
                     if a in names)
        return axes or None

    want = placements(PSpec(*(keep(e) for e in entries)), mesh)
    if tuple(t.placements) == tuple(want):
        return t
    return t.redistribute(mesh, want)


def first_dim_only(t: torch.Tensor) -> torch.Tensor:
    """A DTensor sharded on its first dim at most (any other shard
    gathered, any partial sum added), so that its leading dims can be
    flattened: DTensor (torch 2.11) refuses a view that merges a sharded
    dim past the first of the merged ones. A plain tensor as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    want = [p if p == Shard(0) else Replicate() for p in t.placements]
    if want == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, want)


class _GradLayout(torch.autograd.Function):
    """The identity, its gradient brought to a layout by ``fix``."""

    @staticmethod
    def forward(ctx, t, fix):
        ctx.fix = fix
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.fix(grad), None


def grad_first_dim_only(t: torch.Tensor) -> torch.Tensor:
    """``t`` as it is, its gradient sharded on its first dim at most: the
    backward of a product flattens the gradient's leading dims (see
    :func:`first_dim_only`), and a gradient may come back sharded on the
    sequence. A plain tensor as it is (no autograd node)."""
    return _GradLayout.apply(t, first_dim_only) if is_dtensor(t) else t


def grad_replicated(t: torch.Tensor) -> torch.Tensor:
    """``t`` as it is, its gradient whole on every rank: the backward of
    an index (``t = u[idx]``) adds the gradient's rows into ``u``'s, and
    torch 2.11's DTensor mis-sizes that for a gradient sharded on its
    rows. A plain tensor as it is (no autograd node)."""
    return _GradLayout.apply(t, replicated) if is_dtensor(t) else t


def contiguous_stride(shape: tuple) -> tuple:
    """The strides of a contiguous tensor of ``shape`` (a DTensor's global
    strides where ``from_local`` is given its global shape)."""
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def replicated(t: torch.Tensor) -> torch.Tensor:
    """``t`` whole on every rank of its mesh; a plain tensor as it is."""
    return constrain(t, *([None] * t.ndim))


def whole(t: torch.Tensor) -> torch.Tensor:
    """The full plain tensor of a DTensor (for integer ops DTensor has no
    strategy for; every rank computes the same); a plain tensor as it
    is."""
    return t.full_tensor() if is_dtensor(t) else t
