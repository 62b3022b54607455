"""The port's sharding rules (``repro_torch.models.sharding``), its
abstract parameters, caches and train state, against the reference's
(``repro.models.sharding``, ``Model.abstract_params`` /
``abstract_cache``, ``fl.pofel_trainer.abstract_train_state``), on the
CPU, at the full configs (nothing is allocated on either side).

Specs are compared entry for entry at every keystr path. Local shard
shapes are the port's on a fake process group's 16 × 16 and 2 × 16 × 16
``DeviceMesh`` (``launch.mesh``) against JAX's
``NamedSharding(AbstractMesh, spec).shard_shape``; where a tensor dim is
sharded over two mesh dims (``("pod", "data")``), the global offsets of
DTensor's placements are held to the tile assignment of JAX's
``HloSharding`` at a few devices, so the order is pinned, not only the
sizes. The last three tests are the port's counterparts of
``tests/test_sharding_specs.py``'s spec tests.

The reference's ``abstract_params`` traces its init (deepseek-moe-16b
~11 s on the CPU), so it is computed once an arch.
"""

import functools
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro.configs import ARCH_IDS, get_config as j_get_config
from repro.fl import pofel_trainer as jpt
from repro.models import sharding as jsh
from repro.models.model_api import Model as JModel
from repro_torch.configs import get_config
from repro_torch.core.serialization import leaves_with_paths
from repro_torch.fl import pofel_trainer as pt
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.specs import abstract_dtensor
from repro_torch.models import sharding as tsh
from repro_torch.models.model_api import Model

LLM_ARCHS = [a for a in ARCH_IDS if a != "mnist-mlp"]
TP, FSDP = 16, 16
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
DTYPES = {torch.bfloat16: "bfloat16", torch.float32: "float32",
          torch.int32: "int32"}


@functools.lru_cache(maxsize=None)
def ref_abstract(arch):
    return JModel(j_get_config(arch)).abstract_params()


@functools.lru_cache(maxsize=None)
def port_model(arch):
    return Model(get_config(arch), device="meta")


@pytest.fixture(scope="module")
def meshes():
    """Both production meshes on one fake group of 512 ranks; the group
    is destroyed after the module."""
    import torch.distributed as dist
    tmesh.fake_process_group(512)
    yield {name: tmesh.make_production_mesh(multi_pod=(name == "2x16x16"),
                                            device_type="cpu")
           for name in MESHES}
    dist.destroy_process_group()


def _jax_specs(tree):
    """(keystr, spec as a tuple) of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return [(jax.tree_util.keystr(kp), tuple(s)) for kp, s in flat]


def _port_specs(tree):
    return [(p, tuple(s)) for p, s in leaves_with_paths(tree)
            if s is not None]


def _jax_leaves(tree):
    return [(jax.tree_util.keystr(kp), tuple(x.shape), str(x.dtype))
            for kp, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_leaves(tree):
    return [(p, tuple(x.shape), DTYPES[x.dtype])
            for p, x in leaves_with_paths(tree) if x is not None]


@pytest.mark.parametrize("arch", LLM_ARCHS)
def test_abstract_params_match_reference(arch):
    m = port_model(arch)
    got = m.abstract_params()
    assert all(x.device.type == "meta" for _, x in leaves_with_paths(got))
    assert _port_leaves(got) == _jax_leaves(ref_abstract(arch))
    assert m.n_params() == sum(math.prod(x.shape)
                               for x in jax.tree.leaves(ref_abstract(arch)))


@pytest.mark.parametrize("tp,fsdp", [(16, 16), (4, 2), (1, 1)])
@pytest.mark.parametrize("profile", ["baseline", "sp_attn", "zero3"])
@pytest.mark.parametrize("arch", LLM_ARCHS)
def test_param_pspecs_match_reference(arch, profile, tp, fsdp):
    cfg = get_config(arch)
    got = tsh.param_pspecs(port_model(arch).abstract_params(), tp, fsdp,
                           cfg.family, profile=profile)
    want = jsh.param_pspecs(ref_abstract(arch), tp, fsdp, cfg.family,
                            profile=profile)
    assert _port_specs(got) == _jax_specs(want)


def test_model_param_pspecs_is_the_baseline():
    m = port_model("yi-6b")
    assert _port_specs(m.param_pspecs(TP, FSDP)) == _jax_specs(
        jsh.param_pspecs(ref_abstract("yi-6b"), TP, FSDP, "dense"))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("batch", [1, 8, 32, 128])
@pytest.mark.parametrize("arch", LLM_ARCHS)
def test_cache_pspecs_match_reference(arch, batch, mesh_name):
    """Every (seq_axis_shard, seq_shard_tp) at this batch and mesh's data
    axes; the dense families' ``ctx_k``/``ctx_v`` are None and JAX drops
    them, as the port's specs leave them out."""
    shape, names = MESHES[mesh_name]
    dp_axes = names[:-1]
    dp_total = math.prod(shape[:-1])
    seq = 4096
    jcache = JModel(j_get_config(arch)).abstract_cache(batch, seq)
    tcache = port_model(arch).abstract_cache(batch, seq)
    assert _port_leaves(tcache) == _jax_leaves(jcache)
    for seq_shard in (False, True):
        for seq_tp in (False, True):
            got = tsh.cache_pspecs(tcache, batch, dp_total, dp_axes, TP,
                                   seq_shard, seq_shard_tp=seq_tp)
            want = jsh.cache_pspecs(jcache, batch, dp_total, dp_axes, TP,
                                    seq_shard, seq_shard_tp=seq_tp)
            assert _port_specs(got) == _jax_specs(want), (seq_shard, seq_tp)


def test_cache_pspecs_shard_the_layer_axis_where_it_equals_the_batch():
    """The reference's quirk, mirrored: "the first dim equal to batch" is
    yi-6b's 32-layer axis at B = 32, and the batch axis at B = 128."""
    m = port_model("yi-6b")
    specs = {b: dict(_port_specs(tsh.cache_pspecs(
        m.abstract_cache(b, 4096), b, 16, ("data",), TP, False)))
        for b in (32, 128)}
    assert specs[32][".k"] == ("data", None, None, None, "model")
    assert specs[128][".k"] == (None, "data", None, None, "model")


@pytest.mark.parametrize("rank", [1, 2, 3])
@pytest.mark.parametrize("dp", [(16, ("data",)), (32, ("pod", "data"))])
def test_batch_pspec_matches_reference(dp, rank):
    dp_total, dp_axes = dp
    for batch in (1, 8, 32, 128, 256):
        assert tuple(tsh.batch_pspec(batch, dp_total, dp_axes, rank)) == \
            tuple(jsh.batch_pspec(batch, dp_total, dp_axes, rank))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", LLM_ARCHS)
def test_local_shapes_match_jax_shard_shape(arch, mesh_name, meshes):
    """Every parameter under each profile (zero3's also with the
    replicas' cluster dim on the data axes, as its train state has it),
    and every decode cache leaf: the port's local shape, and its abstract
    DTensor's, equal JAX's shard shape."""
    mesh = meshes[mesh_name]
    amesh = AbstractMesh(*MESHES[mesh_name])
    dp_axes = MESHES[mesh_name][1][:-1]
    m = port_model(arch)
    params = m.abstract_params()
    cases = []
    for profile in ("baseline", "sp_attn", "zero3"):
        specs = dict(leaves_with_paths(tsh.param_pspecs(
            params, TP, 16, m.cfg.family, profile=profile)))
        for path, x in leaves_with_paths(params):
            cases.append((tuple(x.shape), specs[path]))
            if profile == "zero3":
                cases.append(((32,) + tuple(x.shape),
                              tsh.PSpec(dp_axes, *specs[path])))
    cache = m.abstract_cache(128, 4096)
    cspecs = dict(leaves_with_paths(tsh.cache_pspecs(
        cache, 128, math.prod(MESHES[mesh_name][0][:-1]), dp_axes, TP,
        False)))
    cases += [(tuple(x.shape), cspecs[p]) for p, x in leaves_with_paths(cache)
              if x is not None]
    for shape, spec in cases:
        want = NamedSharding(amesh, P(*spec)).shard_shape(shape)
        assert tsh.local_shape(shape, spec, mesh) == want, (shape, spec)
    for shape, spec in cases[:8]:
        d = abstract_dtensor(shape, torch.bfloat16, spec, mesh)
        assert tuple(d.shape) == shape
        assert tuple(d.to_local().shape) == tsh.local_shape(shape, spec,
                                                            mesh)


@pytest.mark.parametrize("spec", [(("pod", "data"), None),
                                  (None, ("pod", "data"), "model"),
                                  ("data", "model"),
                                  (("pod", "data"), None, "model")])
def test_placements_shard_in_jax_device_order(spec, meshes):
    """Global offsets of DTensor's placements at a few mesh coordinates
    equal those of JAX's tile assignment for the same device: a dim on
    ("pod", "data") is split pod-major."""
    from torch.distributed.tensor._utils import (
        _compute_local_shape_and_global_offset)
    shape_of = {2: (64, 4096), 3: (64, 256, 4096)}
    mesh_shape, names = MESHES["2x16x16"]
    shape = shape_of[len(spec)]
    pl = tsh.placements(tsh.PSpec(*spec), meshes["2x16x16"])
    hlo = NamedSharding(AbstractMesh(mesh_shape, names),
                        P(*spec))._to_xla_hlo_sharding(len(shape))
    tiles = hlo.tile_assignment_dimensions()
    order = list(hlo.tile_assignment_devices())
    local = NamedSharding(AbstractMesh(mesh_shape, names),
                          P(*spec)).shard_shape(shape)
    for dev in (0, 17, 255, 256, 300, 511):
        coord = [int(c) for c in np.unravel_index(dev, mesh_shape)]
        got_shape, got_off = _compute_local_shape_and_global_offset(
            shape, mesh_shape, coord, pl)
        tile = np.unravel_index(order.index(dev), tiles)
        want_off = tuple(int(tile[d]) * local[d] for d in range(len(shape)))
        assert tuple(got_shape) == tuple(local)
        assert tuple(got_off) == want_off, (dev, coord)


def test_placements_refuse_what_dtensor_cannot_say(meshes):
    with pytest.raises(ValueError, match="order"):
        tsh.placements(tsh.PSpec(("data", "pod"), None), meshes["2x16x16"])
    with pytest.raises(ValueError, match="two dims"):
        tsh.placements(tsh.PSpec("data", "data"), meshes["16x16"])


@pytest.mark.parametrize("clusters", [8, 16])
@pytest.mark.parametrize("arch", ["yi-6b", "rwkv6-1.6b", "zamba2-7b",
                                  "llama-3.2-vision-90b"])
def test_abstract_train_state_matches_reference(arch, clusters):
    want = jpt.abstract_train_state(JModel(j_get_config(arch)),
                                    jpt.PoFELTrainConfig(n_clusters=clusters))
    got = pt.abstract_train_state(port_model(arch),
                                  pt.PoFELTrainConfig(n_clusters=clusters))
    assert _port_leaves(got) == _jax_leaves(want)
    assert all(x.device.type == "meta" for _, x in leaves_with_paths(got))


# -- the port's counterparts of tests/test_sharding_specs.py ------------------

@pytest.mark.parametrize("arch", LLM_ARCHS)
def test_pspec_tree_matches_params(arch):
    abstract = port_model(arch).abstract_params()
    specs = tsh.param_pspecs(abstract, TP, FSDP, get_config(arch).family)
    assert [p for p, _ in leaves_with_paths(specs)] == \
        [p for p, _ in leaves_with_paths(abstract)]
    for (_, s), (_, x) in zip(leaves_with_paths(specs),
                              leaves_with_paths(abstract)):
        assert isinstance(s, tsh.PSpec) and len(s) == x.dim()


@pytest.mark.parametrize("arch", LLM_ARCHS)
def test_pspec_dims_divide_evenly(arch):
    """Every sharded dim divides exactly by its axes' size."""
    sizes = {"model": TP, "data": FSDP, "pod": 2}
    abstract = port_model(arch).abstract_params()
    specs = dict(leaves_with_paths(tsh.param_pspecs(
        abstract, TP, FSDP, get_config(arch).family)))
    for path, x in leaves_with_paths(abstract):
        for dim, names in enumerate(specs[path]):
            if names is None:
                continue
            names = names if isinstance(names, tuple) else (names,)
            total = math.prod(sizes[n] for n in names)
            assert x.shape[dim] % total == 0, (arch, path, dim)


@pytest.mark.parametrize("arch", ["yi-6b", "phi3.5-moe-42b-a6.6b"])
def test_big_weights_are_sharded(arch):
    """No leaf over 256 MiB stays fully replicated."""
    abstract = port_model(arch).abstract_params()
    specs = dict(leaves_with_paths(tsh.param_pspecs(
        abstract, TP, FSDP, get_config(arch).family)))
    for path, x in leaves_with_paths(abstract):
        if x.numel() * x.element_size() > 256 * 2 ** 20:
            assert any(s is not None for s in specs[path]), (arch, path)
