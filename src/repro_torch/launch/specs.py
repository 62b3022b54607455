"""Per-(arch × input-shape × mesh) step construction for the dry run and
the launchers (port of ``repro.launch.specs``): abstract arguments and
the step that takes them.

An abstract argument is a DTensor over a meta tensor: the global shape
and dtype, the reference's sharding as placements on the given
``DeviceMesh`` (``repro_torch.models.sharding``), one device's shard as
its local shape, and nothing allocated. Three step kinds, per the
assigned input shapes:
  train    → ``pofel_round``  (local FEL step + PoFEL consensus)
  prefill  → ``Model.prefill``
  decode   → ``Model.decode_step`` (one token against a seq_len KV cache)

``StepSetup.step`` (the reference's ``jitted``) runs the step as a
DTensor program: it takes DTensors of the abstract arguments' global
shapes, dtypes and placements, and the train step gives its new state
back in the state argument's placements (the reference's
``out_shardings``). Every mesh lever and ``cluster_axis`` runs. On a
mesh of one device it also takes plain tensors of those shapes, and
then runs the one-card path. A step given meta arguments, or built on
the fake process group, raises ``ValueError``: the fake group moves no
data. ``StepSetup.plan`` runs the same DTensor program on the abstract
arguments themselves, so that every collective the step plans is issued
on meta tensors and nothing moves (``launch.collectives``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import INPUT_SHAPES, LONG_CONTEXT_WINDOW, InputShape
from repro_torch.core.serialization import leaves_with_paths, rebuild
from repro_torch.fl import pofel_trainer as pt
from repro_torch.launch.mesh import mesh_axes
from repro_torch.models.config import ArchConfig
from repro_torch.models.model_api import Model
from repro_torch.models.sharding import (PSpec, cache_pspecs, local_shape,
                                         param_pspecs, placements,
                                         with_cluster_dim)
from repro_torch.models.mesh_ops import (contiguous_stride,
                                         implicit_replication)
from repro_torch.models.transformer import FwdOptions

@dataclass
class StepSetup:
    name: str
    step: Callable              # runs the step on the mesh
    abstract_args: tuple        # DTensors over meta tensors
    model: Model
    cfg: ArchConfig
    plan: Callable              # the step's program on abstract_args
    mesh: Any


def abstract_dtensor(shape: tuple, dtype: torch.dtype, spec: PSpec, mesh):
    """A DTensor of global ``shape`` laid out by ``spec`` on ``mesh``,
    over a meta tensor of this device's local shape."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    local = torch.empty(local_shape(shape, spec, mesh), dtype=dtype,
                        device="meta")
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def _shard_tree(mesh, tree_specs, tree_abstract):
    """DTensors of every tensor of ``tree_abstract`` (None stays None)."""
    specs = dict(leaves_with_paths(tree_specs))
    return rebuild(tree_abstract, {
        p: None if a is None else abstract_dtensor(tuple(a.shape), a.dtype,
                                                   specs[p], mesh)
        for p, a in leaves_with_paths(tree_abstract)})


def arg_bytes_per_device(args: tuple) -> int:
    """Bytes of one device's shards of every abstract argument."""
    return sum(math.prod(a.to_local().shape) * a.element_size()
               for arg in args for _, a in leaves_with_paths(arg)
               if a is not None)


def serving_config(cfg: ArchConfig, shape: InputShape) -> ArchConfig:
    """long_500k runs full-attention archs with a sliding window; SSM
    archs are already O(1)-state."""
    if shape.needs_subquadratic and not cfg.rwkv and cfg.family != "ssm":
        return cfg.with_sliding_window(LONG_CONTEXT_WINDOW)
    return cfg


def distribute_like(values: Any, abstract: Any) -> Any:
    """Plain tensors (whole, the same on every rank) as DTensors laid out
    as their abstract arguments: rank 0's values, scattered. On a mesh of
    one device each tensor is its own local tensor, views (the replicas'
    ``expand``) included: nothing is copied."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(t, w):
        if w.device_mesh.size() == 1:
            return DTensor.from_local(t, w.device_mesh, w.placements,
                                      run_check=False)
        return distribute_tensor(t.contiguous(), w.device_mesh,
                                 w.placements)

    want = dict(leaves_with_paths(abstract))
    return rebuild(values, {p: None if t is None else one(t, want[p])
                            for p, t in leaves_with_paths(values)})


def _runnable(mesh) -> None:
    """Refuse a step on the fake process group, which moves no data."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_backend() == "fake":
        raise ValueError(
            f"a step on a mesh of the fake process group "
            f"{dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))}: the fake "
            f"group moves no data (build on make_host_mesh() or on the "
            f"ranks of run_on_ranks)")


def _checked(arg: Any, abstract: Any, mesh, where: str) -> bool:
    """``arg`` checked leaf by leaf against its abstract argument: a
    DTensor's global shape, dtype, mesh and placements, or (on a mesh of
    one device) a plain tensor's shape and dtype. Whether its leaves are
    DTensors."""
    from torch.distributed.tensor import DTensor
    want = dict(leaves_with_paths(abstract))
    got = dict(leaves_with_paths(arg))
    if set(got) != set(want):
        raise ValueError(f"{where}: leaves {sorted(set(got) ^ set(want))} "
                         f"are not the step's")
    kinds = set()
    for p, a in got.items():
        w = want[p]
        if (a is None) != (w is None):
            raise ValueError(f"{where}{p}: got {a!r}, want {w!r}")
        if a is None:
            continue
        if a.device.type == "meta" or (isinstance(a, DTensor) and
                                       a.to_local().device.type == "meta"):
            raise ValueError(f"{where}{p}: a meta tensor; the fake group "
                             f"moves no data, and a step needs the data")
        spelled = (tuple(a.shape), a.dtype)
        if spelled != (tuple(w.shape), w.dtype):
            raise ValueError(f"{where}{p}: got {spelled}, want "
                             f"{(tuple(w.shape), w.dtype)}")
        if isinstance(a, DTensor):
            if a.device_mesh != mesh or tuple(a.placements) != tuple(
                    w.placements):
                raise ValueError(f"{where}{p}: placements {a.placements} "
                                 f"on {a.device_mesh}, want {w.placements} "
                                 f"on {mesh}")
            kinds.add(True)
        else:
            if mesh.size() > 1:
                raise ValueError(f"{where}{p}: a plain tensor on a mesh of "
                                 f"{mesh.size()} devices; the step takes "
                                 f"DTensors there")
            kinds.add(False)
    if len(kinds) > 1:
        raise ValueError(f"{where}: DTensors and plain tensors mixed")
    return kinds == {True}


def _relayout(tree: Any, abstract: Any) -> Any:
    """Each DTensor of ``tree`` in its abstract argument's placements."""
    from torch.distributed.tensor import DTensor
    want = dict(leaves_with_paths(abstract))

    def one(p, t):
        if not isinstance(t, DTensor) or want.get(p) is None:
            return t
        w = want[p].placements
        return t if tuple(t.placements) == tuple(w) else \
            t.redistribute(t.device_mesh, w)

    return rebuild(tree, {p: one(p, t) for p, t in leaves_with_paths(tree)})


def _make_step(mesh, abstract_args: tuple, run: Callable,
               relayout_first: bool = False) -> tuple[Callable, Callable]:
    """The step: arguments checked, the DTensor program run with plain
    tensors beside DTensors taken as replicated, and (train) the new
    state in its argument's placements. And its plan: the same program
    on the abstract arguments, unchecked, on any process group."""
    def program(*args):
        with implicit_replication():
            out = run(*args)
            if relayout_first:
                out = (_relayout(out[0], abstract_args[0]), *out[1:])
        return out

    def step(*args):
        _runnable(mesh)
        if len(args) != len(abstract_args):
            raise TypeError(f"the step takes {len(abstract_args)} "
                            f"arguments, got {len(args)}")
        on_mesh = False
        for i, (a, w) in enumerate(zip(args, abstract_args)):
            on_mesh |= _checked(a, w, mesh, f"argument {i}")
        return program(*args) if on_mesh else run(*args)

    return step, lambda: program(*abstract_args)


def _setup(name: str, mesh, args: tuple, run: Callable, model: Model,
           cfg: ArchConfig, relayout_first: bool = False) -> StepSetup:
    step, plan = _make_step(mesh, args, run, relayout_first)
    return StepSetup(name, step, args, model, cfg, plan, mesh)


# ---------------------------------------------------------------------------
# train: PoFEL round
# ---------------------------------------------------------------------------

def default_profile_config(profile: str, mesh, n_clusters_baseline: int = 8
                           ) -> tuple[pt.PoFELTrainConfig, FwdOptions]:
    """Per-profile PoFEL/forward defaults, the reference's:

    baseline — 2-D TP×FSDP params, C=8 unsharded clusters
    sp_attn  — sequence-parallel attention: attention weights FSDP-only,
               parallel-q, explicit KV gather
    zero3    — C=16 clusters sharded over `data` (32 over (pod, data)),
               model-axis weight storage with per-layer gather,
               parallel-q, KV gather, expert-parallel MoE buffers
    """
    ax = mesh_axes(mesh)
    dp_axes = ax["dp_axes"]
    if profile == "baseline":
        return (pt.PoFELTrainConfig(n_clusters=n_clusters_baseline),
                FwdOptions(seq_shard_axis="model", dp_axes=dp_axes,
                           remat=True))
    if profile == "sp_attn":
        return (pt.PoFELTrainConfig(n_clusters=n_clusters_baseline),
                FwdOptions(seq_shard_axis="model", dp_axes=dp_axes,
                           remat=True, parallel_q=True, gather_kv=True))
    if profile == "zero3":
        n_c = 2 * 16 if "pod" in dp_axes else 16
        axis = dp_axes if len(dp_axes) > 1 else dp_axes[0]
        return (pt.PoFELTrainConfig(n_clusters=n_c, cluster_axis=axis),
                FwdOptions(seq_shard_axis="model", dp_axes=(),
                           remat=True, parallel_q=True, gather_kv=True,
                           weight_gather=True, expert_axis="model"))
    raise ValueError(f"unknown profile {profile!r}")


def build_train_setup(arch_id: str, mesh, shape: InputShape,
                      tcfg: pt.PoFELTrainConfig | None = None,
                      opts: FwdOptions | None = None,
                      profile: str = "baseline",
                      cfg: ArchConfig | None = None) -> StepSetup:
    """The PoFEL round of ``arch_id`` (at ``cfg`` where given, else its
    config) on ``mesh`` for ``shape``."""
    assert shape.kind == "train"
    cfg = cfg or get_config(arch_id)
    model = Model(cfg, device=mesh.device_type)
    ax = mesh_axes(mesh)
    dp_axes, dp_total, tp = ax["dp_axes"], ax["dp_total"], ax["tp"]
    d_tcfg, d_opts = default_profile_config(profile, mesh)
    tcfg = tcfg or d_tcfg
    opts = opts or d_opts
    C = tcfg.n_clusters

    # --- state specs ---------------------------------------------------------
    single_specs = param_pspecs(model.abstract_params(), tp, dp_total,
                                cfg.family, profile=profile)
    cluster_dim = tcfg.cluster_axis  # None or "data"
    abstract_state = pt.abstract_train_state(model, tcfg)
    state_specs = pt.PoFELTrainState(
        cluster_params=with_cluster_dim(single_specs, cluster_dim),
        global_params=single_specs,
        outer_momentum=single_specs,
        btsv_history=PSpec(),
        round=PSpec(),
    )
    state_arg = _shard_tree(mesh, state_specs, abstract_state)

    # --- batch specs -----------------------------------------------------------
    B, S = shape.global_batch, shape.seq_len
    assert B % C == 0, f"global batch {B} must divide n_clusters {C}"
    bc = B // C
    if cluster_dim is not None:
        bspec = PSpec(cluster_dim, None, None)
        ctx_spec = PSpec(cluster_dim, None, None, None)
    elif bc % dp_total == 0:
        bspec = PSpec(None, dp_axes, None)
        ctx_spec = PSpec(None, dp_axes, None, None)
    else:
        bspec = PSpec(None, None, None)
        ctx_spec = PSpec()
    meta = dict(device="meta")
    batch_abstract = {
        "tokens": torch.empty((C, bc, S), dtype=torch.int32, **meta),
        "labels": torch.empty((C, bc, S), dtype=torch.int32, **meta),
    }
    batch_specs = {"tokens": bspec, "labels": bspec}
    if model.needs_context():
        batch_abstract["context"] = torch.empty(
            (C, bc, cfg.n_context_tokens, cfg.d_model), dtype=torch.bfloat16,
            **meta)
        batch_specs["context"] = ctx_spec
    batch_arg = _shard_tree(mesh, batch_specs, batch_abstract)
    lambdas_arg = abstract_dtensor((C,), torch.float32, PSpec(), mesh)
    args = (state_arg, batch_arg, lambdas_arg)

    def run(state, batch, lambdas):
        return pt.pofel_round(model, state, batch, lambdas, tcfg, opts)

    return _setup(f"{arch_id}/{shape.name}", mesh, args, run, model, cfg,
                  relayout_first=True)


def build_local_step_setup(arch_id: str, mesh, shape: InputShape,
                           tcfg: pt.PoFELTrainConfig | None = None,
                           opts: FwdOptions | None = None,
                           profile: str = "baseline") -> StepSetup:
    """Plain FEL iteration (no consensus): the baseline of the
    consensus-overhead measurement."""
    setup = build_train_setup(arch_id, mesh, shape, tcfg, opts, profile)
    d_tcfg, d_opts = default_profile_config(profile, mesh)
    tcfg = tcfg or d_tcfg
    opts = opts or d_opts
    model = setup.model
    args = setup.abstract_args[:2]

    def run(state, batch):
        return pt.train_step(model, state, batch, tcfg, opts)

    return _setup(f"{arch_id}/{shape.name}/local", mesh, args, run, model,
                  setup.cfg, relayout_first=True)


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------

def _serving_params_arg(model: Model, mesh, tp, dp_total,
                        profile: str = "baseline"):
    abstract = model.abstract_params()
    if profile == "serve_tp":
        # pure Megatron TP: col/row-parallel over `model`, replicated
        # over data (serving keeps no optimizer state to shard)
        specs = param_pspecs(abstract, tp, 1, model.cfg.family,
                             profile="baseline")
    else:
        specs = param_pspecs(abstract, tp, dp_total, model.cfg.family,
                             profile=profile)
    return _shard_tree(mesh, specs, abstract)


def build_prefill_setup(arch_id: str, mesh, shape: InputShape,
                        opts: FwdOptions | None = None,
                        profile: str = "baseline",
                        cfg: ArchConfig | None = None) -> StepSetup:
    assert shape.kind == "prefill"
    cfg = serving_config(cfg or get_config(arch_id), shape)
    model = Model(cfg, device=mesh.device_type)
    ax = mesh_axes(mesh)
    dp_axes, dp_total, tp = ax["dp_axes"], ax["dp_total"], ax["tp"]
    if opts is None:
        opts = FwdOptions(seq_shard_axis="model", dp_axes=dp_axes,
                          remat=False)
        if profile in ("sp_attn", "zero3"):
            opts = opts._replace(parallel_q=True, gather_kv=True,
                                 weight_gather=(profile == "zero3"),
                                 expert_axis="model")
        elif profile == "serve_tp":
            opts = opts._replace(
                parallel_q=True, gather_kv=True,
                expert_axis=None if cfg.family == "moe" else "model")

    B, S = shape.global_batch, shape.seq_len
    params_arg = _serving_params_arg(model, mesh, tp, dp_total, profile)
    bspec = PSpec(dp_axes, None) if B % dp_total == 0 else PSpec(None, None)
    meta = dict(device="meta")
    batch_abstract = {"tokens": torch.empty((B, S), dtype=torch.int32,
                                            **meta)}
    batch_specs = {"tokens": bspec}
    if model.needs_context():
        batch_abstract["context"] = torch.empty(
            (B, cfg.n_context_tokens, cfg.d_model), dtype=torch.bfloat16,
            **meta)
        batch_specs["context"] = (PSpec(dp_axes, None, None)
                                  if B % dp_total == 0 else PSpec())
    batch_arg = _shard_tree(mesh, batch_specs, batch_abstract)
    args = (params_arg, batch_arg)

    def run(params, batch):
        return model.prefill(params, batch, opts)

    return _setup(f"{arch_id}/{shape.name}", mesh, args, run, model, cfg)


def build_decode_setup(arch_id: str, mesh, shape: InputShape,
                       profile: str = "baseline",
                       cfg: ArchConfig | None = None) -> StepSetup:
    assert shape.kind == "decode"
    cfg = serving_config(cfg or get_config(arch_id), shape)
    model = Model(cfg, device=mesh.device_type)
    ax = mesh_axes(mesh)
    dp_axes, dp_total, tp = ax["dp_axes"], ax["dp_total"], ax["tp"]

    B, S = shape.global_batch, shape.seq_len
    params_arg = _serving_params_arg(model, mesh, tp, dp_total, profile)
    abstract_cache = model.abstract_cache(B, S)
    c_specs = cache_pspecs(abstract_cache, B, dp_total, dp_axes, tp,
                           seq_axis_shard=(B == 1),
                           seq_shard_tp=(profile == "serve_tp"))
    cache_arg = _shard_tree(mesh, c_specs, abstract_cache)
    tspec = PSpec(dp_axes, None) if B % dp_total == 0 else PSpec(None, None)
    tokens_arg = abstract_dtensor((B, 1), torch.int32, tspec, mesh)
    pos_arg = abstract_dtensor((), torch.int32, PSpec(), mesh)
    args = (params_arg, cache_arg, tokens_arg, pos_arg)

    def run(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos)

    return _setup(f"{arch_id}/{shape.name}", mesh, args, run, model, cfg)


def build_setup(arch_id: str, shape: str | InputShape, mesh,
                **kw) -> StepSetup:
    """The step of ``arch_id`` for ``shape`` (an ``InputShape`` or the
    name of one of ``INPUT_SHAPES``); ``cfg=`` builds on another config
    of the arch (a cut depth, a reduced width)."""
    if isinstance(shape, str):
        shape = INPUT_SHAPES[shape]
    if shape.kind == "train":
        return build_train_setup(arch_id, mesh, shape, **kw)
    if shape.kind == "prefill":
        return build_prefill_setup(arch_id, mesh, shape, **kw)
    return build_decode_setup(arch_id, mesh, shape, **kw)


def input_specs(arch_id: str, shape_name: str, mesh, **kw) -> tuple:
    """Abstract stand-ins (DTensors over meta tensors: shardable, no
    allocation) for every input of the step built for (arch × shape):
    train → (state, batch, λ); prefill → (params, batch);
    decode → (params, cache, tokens, pos)."""
    return build_setup(arch_id, shape_name, mesh, **kw).abstract_args


__all__ = ["StepSetup", "distribute_like", "abstract_dtensor",
           "arg_bytes_per_device", "build_decode_setup",
           "build_local_step_setup", "build_prefill_setup", "build_setup",
           "build_train_setup", "default_profile_config", "input_specs",
           "serving_config"]
