"""Partition specs of parameters, batches and caches, and their DTensor
placements (port of ``repro.models.sharding``).

2-D sharding strategy, the reference's rules unchanged:
  * ``model`` axis (TP, 16-way): column-parallel up-projections (output
    dim), row-parallel down-projections (input dim), expert axis for MoE
    stacks, vocab axis for embed/lm_head.
  * ``data`` axis (FSDP, 16-way): the complementary large dim of each
    weight.
  * ``pod`` axis: pure data parallelism: params replicated, batch sharded.

Rules are name and shape based and skip any dim not exactly divisible by
the axis size. A spec is a :class:`PSpec`: a tuple with one entry per
tensor dim, each ``None``, an axis name or a tuple of axis names, as
JAX's ``PartitionSpec``. Paths are the keystr strings of
``repro_torch.core.serialization.leaves_with_paths`` (``['layers']['attn']
['wq']``, ``.k``), which the rules match on substrings as the reference
does.

:func:`placements` turns a spec into DTensor placements on a
``DeviceMesh``: ``Shard(d)`` on each mesh dim the spec names for tensor
dim d, ``Replicate()`` elsewhere. A tuple entry such as
``("pod", "data")`` shards one tensor dim over both mesh dims, the first
named major, as in JAX; it must name them in the mesh's order.
"""

from __future__ import annotations

import math
from typing import Any, Optional

from repro_torch.core.serialization import leaves_with_paths, rebuild


def _entry(e):
    """An entry as JAX's ``PartitionSpec`` keeps it: a tuple of one axis
    is that axis, an empty tuple None."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


class PSpec(tuple):
    """JAX's ``PartitionSpec`` as a tuple: ``PSpec("data", None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"PSpec{tuple.__repr__(self)}"


# leading stacked-layer dims to leave unsharded, by path substring
_STACK_DEPTH = (
    ("mamba_groups", 2),
    ("mamba_tail", 1),
    ("cross_layers", 1),
    ("layers", 1),      # dense/moe/audio/rwkv stacks (vlm handled below)
)

# weights whose INPUT dim is model-sharded (row-parallel)
_ROW_PARALLEL = {"w_down", "wo", "wv_ffn", "out_proj", "w_lora_b"}
_REPLICATE = {"router", "gate_attn", "gate_mlp"}
# attention projection weights (incl. cross/shared attention)
_ATTN_NAMES = {"wq", "wk", "wv", "wo", "bq", "bk", "bv"}
PROFILES = ("baseline", "sp_attn", "zero3")


def _stack_dims(path: str, vlm: bool) -> int:
    for key, depth in _STACK_DEPTH:
        if key in path:
            if vlm and key == "layers" and "cross_layers" not in path:
                return 2            # vlm self-layers are (n_groups, spg, ...)
            return depth
    return 0


def _leaf_spec(path: str, shape: tuple, tp: int, fsdp: int, vlm: bool,
               tp_axis: str = "model", fsdp_axis: str = "data",
               profile: str = "baseline") -> PSpec:
    name = path.rsplit("'")[-2] if "'" in path else path
    strip = _stack_dims(path, vlm)
    spec: list = [None] * len(shape)
    dims = list(range(strip, len(shape)))
    if not dims or any(n in path for n in _REPLICATE):
        return PSpec(*spec)
    if len(dims) == 1:
        return PSpec(*spec)   # vectors: replicate

    if "moe" in path and len(dims) == 3:        # an expert stack
        e_dim = dims[0]
        if shape[e_dim] % tp == 0:
            spec[e_dim] = tp_axis
        rest = [d for d in dims[1:] if fsdp > 1 and shape[d] % fsdp == 0]
        if rest and profile != "zero3":
            big = max(rest, key=lambda d: shape[d])
            spec[big] = fsdp_axis
        return PSpec(*spec)

    if profile == "sp_attn" and (name in _ATTN_NAMES
                                 or "shared_attn" in path):
        # sequence-parallel attention: its weights keep FSDP only, no TP
        # (for the zamba2 hybrid, the whole shared block)
        ddim = max(dims, key=lambda d: shape[d])
        if fsdp > 1 and shape[ddim] % fsdp == 0:
            spec[ddim] = fsdp_axis
        return PSpec(*spec)

    if profile == "zero3":
        # storage: model axis on the largest divisible dim; the data axis
        # is the cluster dim's
        cands = [d for d in dims if shape[d] % tp == 0]
        if cands:
            spec[max(cands, key=lambda d: shape[d])] = tp_axis
        return PSpec(*spec)

    if name in _ROW_PARALLEL:
        mdim, ddim = dims[-2], dims[-1]
    else:
        mdim, ddim = dims[-1], dims[-2]
    if tp > 1 and shape[mdim] % tp == 0:
        spec[mdim] = tp_axis
    if fsdp > 1 and shape[ddim] % fsdp == 0:
        spec[ddim] = fsdp_axis
    return PSpec(*spec)


def _map_paths(fn, tree: Any) -> Any:
    """``fn(path, leaf)`` over the leaves of ``tree``, in its shape; a
    None leaf stays None (JAX drops it from the flattened tree)."""
    return rebuild(tree, {p: None if leaf is None else fn(p, leaf)
                          for p, leaf in leaves_with_paths(tree)})


def param_pspecs(abstract: Any, tp: int, fsdp: int, family: str,
                 tp_axis: str = "model", fsdp_axis: str = "data",
                 profile: str = "baseline") -> Any:
    """A :class:`PSpec` tree matching ``abstract`` (tensors, e.g. on the
    meta device). profile: 'baseline' (2-D TP×FSDP), 'sp_attn'
    (attention weights FSDP-only), 'zero3' (model-axis storage; the
    cluster dim carries the data axis)."""
    if profile not in PROFILES:
        raise ValueError(f"unknown profile {profile!r}")
    vlm = family == "vlm"
    return _map_paths(lambda path, leaf: _leaf_spec(
        path, tuple(leaf.shape), tp, fsdp, vlm, tp_axis, fsdp_axis, profile),
        abstract)


def batch_pspec(batch_size: int, dp_total: int, dp_axes: tuple,
                rank: int = 2) -> PSpec:
    """Shard the batch dim over the data axes when divisible, else
    replicate."""
    if batch_size % dp_total == 0:
        return PSpec(dp_axes) if rank == 1 else PSpec(dp_axes,
                                                      *([None] * (rank - 1)))
    return PSpec(*([None] * rank))


def cache_pspecs(abstract_cache: Any, batch: int, dp_total: int,
                 dp_axes: tuple, tp: int, seq_axis_shard: bool,
                 tp_axis: str = "model", seq_shard_tp: bool = False) -> Any:
    """KV/state cache specs, the reference's rules: a batch that divides
    shards "the first dim equal to batch" (with the reference's quirk:
    where the layer count equals the batch, as yi-6b's 32 layers at
    B = 32, that is the layer axis); long-context (batch 1) shards the
    sequence dim of attention caches over the data axes instead;
    ``seq_shard_tp`` (serve_tp) shards it over ``model``; otherwise the
    trailing feature (or kv-head) dim is model-sharded when divisible."""
    def spec_of(path: str, leaf) -> PSpec:
        shape = tuple(leaf.shape)
        spec: list = [None] * len(shape)
        bdim = next((i for i, s in enumerate(shape) if s == batch), None)
        if bdim is not None and batch % dp_total == 0 and batch > 1:
            spec[bdim] = dp_axes
        elif seq_axis_shard and len(shape) >= 3 and ("k" in path
                                                     or "v" in path):
            # attention cache (L, B, S, Hk, hd): shard S (dim -3)
            sdim = len(shape) - 3
            if shape[sdim] % dp_total == 0:
                spec[sdim] = dp_axes
        is_attn_cache = len(shape) >= 4 and ("k" in path or "v" in path)
        if seq_shard_tp and is_attn_cache:
            sdim = len(shape) - 3
            if spec[sdim] is None and shape[sdim] % tp == 0:
                spec[sdim] = tp_axis
                return PSpec(*spec)
        if len(shape) >= 2 and shape[-1] % tp == 0 and spec[-1] is None:
            spec[-1] = tp_axis
        elif len(shape) >= 2 and shape[-2] % tp == 0 and spec[-2] is None:
            spec[-2] = tp_axis
        return PSpec(*spec)

    return _map_paths(spec_of, abstract_cache)


# ---------------------------------------------------------------------------
# specs on a mesh
# ---------------------------------------------------------------------------

def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (or anything with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def local_shape(shape: tuple, spec: PSpec, mesh) -> tuple:
    """The shape of one device's shard of a ``shape`` tensor laid out by
    ``spec`` on ``mesh`` (the first device's, when a dim does not divide:
    the ceiling, as JAX's ``shard_shape`` pads)."""
    sizes = mesh_sizes(mesh)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than {shape} dims")
    out = list(shape)
    for d, entry in enumerate(spec):
        n = math.prod(sizes[a] for a in _axes(entry))
        out[d] = -(-shape[d] // n)
    return tuple(out)


def placements(spec: PSpec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(d)`` where the spec names that mesh dim for tensor dim d,
    ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} names mesh dims out of "
                             f"the mesh's order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh dim {names[i]!r} shards two dims")
            out[i] = Shard(d)
    return tuple(out)


def with_cluster_dim(specs: Any, axis: Optional[str | tuple]) -> Any:
    """Each spec of ``specs`` with a leading entry ``axis`` (the
    replicas' cluster dim)."""
    return _map_paths(lambda _, sp: PSpec(axis, *sp), specs)


__all__ = ["PROFILES", "PSpec", "batch_pspec", "cache_pspecs", "local_shape",
           "mesh_sizes", "param_pspecs", "placements", "with_cluster_dim"]
