"""The collectives of a DTensor step, by kind, count, bytes and mesh axis
(the roofline's collective term, ``launch.roofline``).

The reference parses its compiled program's collectives out of XLA's HLO
text, each scaled by the trip count of the scan it sits in
(``repro.launch.roofline.parse_collectives``). A torch step on a mesh
is a DTensor program with no such text, so here the step is run and its
collectives are recorded as they are issued: :class:`CollectiveCounter`
is a ``TorchDispatchMode`` that sees every ``_c10d_functional`` (and
``c10d``, and DTensor's own ``_dtensor.shard_dim_alltoall``) collective
with its operand and its process group, and adds
the operand's bytes (one device's, as the reference counts) to the
kind's count and bytes and to the bytes of the mesh axis whose group it
ran over.

Method: the step is *planned*, not run. :func:`plan_step` runs the
step's DTensor program on its abstract arguments (DTensors over meta
tensors, ``launch.specs``), so every redistribution that the step plans
is issued and recorded and no data moves; on the production meshes that
is the fake process group, whose steps ``specs`` refuses to run. A
scalar read of a meta tensor (the BTSV tally's leader, ``int(argmax)``)
reads 0: no collective the step plans depends on its value. Every layer
runs in Python, so a planned run counts every layer and needs no trip
count; but a full-depth plan of a 32-layer trainer round takes tens of
seconds of DTensor dispatch on the host. :func:`count_collectives`
therefore plans the step again at two cut depths (the setup built anew
on its config with fewer layers), ``p + r`` and ``2p + r``
layers (``p`` the layer pattern's period: Zamba2's ``attn_every``, the
vision models' ``cross_attn_every``, else 1; ``r`` the full depth's
remainder), and adds the difference, one period's collectives, for each
further period: count and bytes are linear in the number of periods,
since each period issues the same collectives and a stacked (L, ...)
leaf's bytes grow with L. This is the reference's trip-count scaling
with the period as the loop body. Zamba2's Mamba2 scan runs a Python loop
a token, so its train and prefill steps are also planned at two cut
lengths (``SCAN_SEQ``) and the four plans extended bilinearly.
A collective is put on a mesh axis (or a join of axes, which DTensor
reduces over at once) by its group's ranks. ``tests/test_torch_launch_mesh.py``
holds the extensions to a plan of the full step, and
``launch.mesh_check`` holds the plan to the collectives measured on a
(2, 2) mesh of four processes, kind by kind, in count and in bytes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# op name (without overload) -> (the reference's kind, operand argument)
KINDS = {
    "all_gather_into_tensor": ("all-gather", 0),
    "all_gather_into_tensor_coalesced": ("all-gather", 0),
    "allgather_": ("all-gather", 1),
    "allgather_coalesced_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "all_reduce": ("all-reduce", 0),
    "all_reduce_coalesced": ("all-reduce", 0),
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "all_to_all_single": ("all-to-all", 0),
    "shard_dim_alltoall": ("all-to-all", 0),   # DTensor's, not on a CPU mesh
    "alltoall_": ("all-to-all", 1),
    "alltoall_base_": ("all-to-all", 1),
    "isend": ("collective-permute", 0),
    "send": ("collective-permute", 0),
}
NAMESPACES = ("_c10d_functional", "c10d", "_dtensor")
OTHER_AXIS = "other"        # a group that is no single axis of the mesh


@dataclass
class CollectiveStats:
    """The reference's ``CollectiveStats`` (kind → bytes, kind → count),
    with each device's bytes by mesh axis beside them."""
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)
    bytes_by_axis: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def add(self, kind: str, nbytes: int, mult: int,
            axis: str = OTHER_AXIS) -> None:
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) \
            + nbytes * mult
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + mult
        self.bytes_by_axis[axis] = self.bytes_by_axis.get(axis, 0) \
            + nbytes * mult

    def as_dict(self) -> dict:
        return {"count_by_kind": dict(self.count_by_kind),
                "bytes_by_kind": dict(self.bytes_by_kind),
                "bytes_by_axis": dict(self.bytes_by_axis)}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    return 0


def _group_ranks(arg):
    """The ranks of the process group an op argument names (a
    ``_c10d_functional`` op takes the group's name, a ``c10d`` op the
    boxed group), sorted; None for any other argument."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    try:
        if isinstance(arg, str):
            pg = _resolve_process_group(arg)
        elif isinstance(arg, torch.ScriptObject):
            pg = torch._C._distributed_c10d.ProcessGroup.unbox(arg)
        else:
            return None
        return tuple(sorted(dist.get_process_group_ranks(pg)))
    except (RuntimeError, ValueError, KeyError, AttributeError):
        return None


def axis_ranks(mesh) -> Dict[str, tuple]:
    """Each axis of ``mesh``, and each set of two or more axes joined by
    ``+`` (DTensor flattens dims to reduce over them at once), → the
    sorted ranks of this process's group along it. A collective is put
    on an axis by its group's ranks, not its name: a group made for an
    earlier mesh of the same layout has the same ranks under another
    name."""
    import itertools
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    out = {}
    for n in range(1, len(names) + 1):
        for dims in itertools.combinations(range(len(names)), n):
            index = tuple(slice(None) if d in dims else coord[d]
                          for d in range(len(names)))
            ranks = tuple(sorted(mesh.mesh[index].flatten().tolist()))
            if len(ranks) > 1:
                out.setdefault(ranks, "+".join(names[d] for d in dims))
    return {name: ranks for ranks, name in out.items()}


class CollectiveCounter(TorchDispatchMode):
    """Records every collective issued under it into ``self.stats``.

    ``mesh`` names the axes (:func:`axis_ranks`; a collective over
    another group counts under ``OTHER_AXIS``). With ``meta_scalars``, a scalar read of a meta
    tensor gives 0 instead of raising (a planned step)."""

    def __init__(self, mesh=None, meta_scalars: bool = False):
        super().__init__()
        self.stats = CollectiveStats()
        self.axes = {ranks: name for name, ranks in
                     (axis_ranks(mesh) if mesh is not None else {}).items()}
        self.meta_scalars = meta_scalars

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor desugar the op into local ops and collectives
            # first, with this mode still on (as ``CommDebugMode`` does)
            return NotImplemented
        kwargs = kwargs or {}
        if func.namespace in NAMESPACES:
            name = func._schema.name.split("::")[-1]
            if name in KINDS:
                kind, arg = KINDS[name]
                groups = [_group_ranks(a) for a in (*args, *kwargs.values())]
                axis = next((self.axes[g] for g in groups if g in self.axes),
                            OTHER_AXIS)
                self.stats.add(kind, _nbytes(args[arg]), 1, axis)
        if (self.meta_scalars
                and func is torch.ops.aten._local_scalar_dense.default
                and args[0].device.type == "meta"):
            return False if args[0].dtype == torch.bool else 0
        return func(*args, **kwargs)


def plan_step(setup) -> CollectiveStats:
    """The collectives that ``setup``'s step plans on its abstract
    arguments, all of them issued on meta tensors: nothing moves."""
    with CollectiveCounter(setup.mesh, meta_scalars=True) as counter:
        setup.plan()
    return counter.stats


def layer_period(cfg) -> int:
    """Layers in one repeat of the layer pattern."""
    if cfg.family == "hybrid" and cfg.attn_every:
        return cfg.attn_every
    if cfg.cross_attn_every > 1:
        return cfg.cross_attn_every
    return 1


# the hybrid's Mamba2 scan runs a Python loop a token (models/mamba2.py),
# so its train and prefill steps are planned at these two sequence lengths
# and extrapolated, linearly, to the shape's
SCAN_SEQ = (16, 32)


def per_token_scan(cfg, shape) -> bool:
    return cfg.family == "hybrid" and shape.kind in ("train", "prefill")


def _combine(v00, v10, v01, v11, x: int, y: int) -> CollectiveStats:
    """The bilinear extension of four plans, at (depth, length) points
    0 and 1 on each axis, to the point (x, y): v00 + x·Δdepth +
    y·Δlength + x·y·Δboth."""
    out = CollectiveStats()
    for name in ("bytes_by_kind", "count_by_kind", "bytes_by_axis"):
        a, b, c, d = (getattr(v, name) for v in (v00, v10, v01, v11))
        for k in sorted(set(a) | set(b) | set(c) | set(d)):
            w = [m.get(k, 0) for m in (a, b, c, d)]
            v = (w[0] + x * (w[1] - w[0]) + y * (w[2] - w[0])
                 + x * y * (w[3] - w[2] - w[1] + w[0]))
            if v < 0:
                raise ValueError(f"collective {k}: {w} extrapolate to {v}")
            if v:
                getattr(out, name)[k] = v
    return out


def count_collectives(setup, build: Callable[[object, object], object],
                      shape) -> CollectiveStats:
    """The collectives of ``setup``'s step, built for ``shape`` (an
    ``InputShape`` of ``configs.shapes``): planned on setups that
    ``build(cfg, shape)`` makes of ``setup.cfg`` cut to ``p + r`` and
    ``2p + r`` layers, and extrapolated to ``setup.cfg.n_layers`` (the
    module docstring); planned on ``setup`` itself where the depth is
    under three periods, which the cut plans would not shorten. Where
    the step scans token by token in Python (``per_token_scan``), each
    depth is planned at the two lengths of ``SCAN_SEQ`` too, and the
    plans are extended bilinearly in depth and length: per-token work
    issues its collectives a token, and the activations' bytes grow
    with the length."""
    p = layer_period(setup.cfg)
    q, r = divmod(setup.cfg.n_layers, p)
    scan = per_token_scan(setup.cfg, shape)
    if q < 3 and not scan:
        return plan_step(setup)
    depths = (p + r, 2 * p + r) if q >= 3 else (setup.cfg.n_layers,)
    lengths = SCAN_SEQ if scan else (shape.seq_len,)
    plans = {(d, n): plan_step(build(
                 dataclasses.replace(setup.cfg, n_layers=d),
                 dataclasses.replace(shape, seq_len=n)))
             for d in depths for n in lengths}
    y = 0
    if scan:
        s1, s2 = SCAN_SEQ
        y, rem = divmod(shape.seq_len - s1, s2 - s1)
        if rem:
            raise ValueError(f"{shape.name}: {shape.seq_len} tokens are not "
                             f"{s1} + a multiple of {s2 - s1}")
    d1, d2 = depths[0], depths[-1]
    x = q - 1 if q >= 3 else 0
    return _combine(plans[d1, lengths[0]], plans[d2, lengths[0]],
                    plans[d1, lengths[-1]], plans[d2, lengths[-1]], x, y)


__all__ = ["CollectiveCounter", "CollectiveStats", "KINDS", "OTHER_AXIS",
           "SCAN_SEQ", "axis_ranks",
           "count_collectives", "layer_period", "per_token_scan",
           "plan_step"]
