"""The port's mesh launchers (``repro_torch.launch``: ``mesh``, ``costs``,
``roofline``, ``specs``, ``dryrun``, ``hillclimb``) against the
reference's (``repro.launch``), on the CPU.

* ``step_cost`` and ``model_flops_estimate``: the same floats for every
  arch × input shape.
* The abstract arguments of ``build_setup`` for yi-6b, deepseek-moe-16b,
  zamba2-7b and llama-3.2-vision-90b, for each input shape under each
  profile it takes, on both production meshes: every leaf's path, global
  shape and dtype, and its local shape against JAX's shard shape. The
  reference builds on a ``jax.sharding.AbstractMesh`` (no devices), the
  port on a fake process group's ``DeviceMesh``.
* ``python -m repro_torch.launch.dryrun`` and ``hillclimb`` as processes.
* ``input_specs`` for yi-6b against the reference's, every input shape.
* Steps on the host mesh (a world-size-1 gloo group): a PoFEL round, a
  plain FEL step and a decode step equal the direct calls bit for bit,
  the baseline profile's lever and a sharded cluster axis included; a
  step on the fake group raises, since it moves no data.

The reference's ``Model.abstract_params`` traces its full init
(deepseek-moe-16b ~11 s), and its ``abstract_train_state`` traces
``init`` again; both are given the arch's abstract parameters computed
once (``init`` returns zeros of those shapes under ``eval_shape``; a
serving window changes no weight, so long_500k's config shares them),
as the reference's own mini test patches ``get_config``.
"""

import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.launch.specs as jspecs
from repro.configs import ARCH_IDS, get_config as j_get_config
from repro.configs.shapes import INPUT_SHAPES as J_SHAPES
from repro.launch import costs as jcosts
from repro.launch import roofline as jroof
from repro.models.model_api import Model as JModel
from repro_torch.configs import get_config
from repro_torch.configs.shapes import INPUT_SHAPES, InputShape
from repro_torch.core.serialization import leaves_with_paths
from repro_torch.fl import pofel_trainer as pt
from repro_torch.launch import costs, mesh as tmesh, roofline, specs
from repro_torch.models.model_api import Model
from repro_torch.models.transformer import FwdOptions

ROOT = Path(__file__).resolve().parents[1]
LLM_ARCHS = [a for a in ARCH_IDS if a != "mnist-mlp"]
SETUP_ARCHS = ["yi-6b", "deepseek-moe-16b", "zamba2-7b",
               "llama-3.2-vision-90b"]
PROFILES = {"train_4k": ["baseline", "sp_attn", "zero3"],
            "prefill_32k": ["baseline", "sp_attn", "zero3", "serve_tp"],
            "decode_32k": ["baseline", "serve_tp"],
            "long_500k": ["baseline", "serve_tp"]}
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
DTYPES = {torch.bfloat16: "bfloat16", torch.float32: "float32",
          torch.int32: "int32"}

_J_INIT = JModel.init


@functools.lru_cache(maxsize=None)
def _abstract_of(cfg):
    """The reference's ``abstract_params``, with its own ``init``."""
    return jax.eval_shape(lambda: _J_INIT(JModel(cfg), jax.random.key(0)))


def _full_attention(cfg):
    """The config without its serving window: the weights are the same."""
    return cfg.with_sliding_window(0)


@pytest.fixture(scope="module", autouse=True)
def cached_reference():
    """The reference's abstract parameters once a config; its ``init``
    as zeros of those shapes (only ever traced, under ``eval_shape``)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(JModel, "abstract_params", lambda self: _abstract_of(
        _full_attention(self.cfg)))
    mp.setattr(JModel, "init", lambda self, key: jax.tree.map(
        lambda s: jnp.zeros(s.shape, s.dtype),
        _abstract_of(_full_attention(self.cfg))))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def meshes():
    """Both production meshes on one fake group of 512 ranks."""
    tmesh.fake_process_group(512)
    yield {name: tmesh.make_production_mesh(multi_pod=(name == "2x16x16"),
                                            device_type="cpu")
           for name in MESHES}
    _destroy()


def _destroy():
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def port_model(arch):
    return Model(get_config(arch), device="meta")


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", LLM_ARCHS)
def test_step_cost_and_model_flops_match_reference(arch, shape):
    tm, jm = port_model(arch), JModel(j_get_config(arch))
    for clusters in (8, 16):
        got = costs.step_cost(tm, INPUT_SHAPES[shape], clusters)
        want = jcosts.step_cost(jm, J_SHAPES[shape], clusters)
        assert (got.flops, got.hbm_bytes, got.notes) == \
            (want.flops, want.hbm_bytes, want.notes)
    s = INPUT_SHAPES[shape]
    args = (s.kind, s.global_batch, s.seq_len)
    assert roofline.model_flops_estimate(tm.n_active_params(), *args) == \
        jroof.model_flops_estimate(jm.n_active_params(), *args)


def _port_leaves(args):
    out = []
    for i, arg in enumerate(args):
        for p, x in leaves_with_paths(arg):
            if x is not None:
                out.append((f"[{i}]{p}", tuple(x.shape), DTYPES[x.dtype],
                            tuple(x.to_local().shape)))
    return out


def _jax_leaves(args):
    return [(jax.tree_util.keystr(kp), tuple(x.shape), str(x.dtype),
             tuple(x.sharding.shard_shape(x.shape)))
            for kp, x in jax.tree_util.tree_flatten_with_path(args)[0]]


@functools.lru_cache(maxsize=None)
def _reference_args(arch, shape, profile, mesh_name):
    return _jax_leaves(jspecs.build_setup(
        arch, shape, AbstractMesh(*MESHES[mesh_name]),
        profile=profile).abstract_args)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape,profile", [(s, p) for s, ps in
                                           PROFILES.items() for p in ps])
@pytest.mark.parametrize("arch", SETUP_ARCHS)
def test_setup_arguments_match_reference_shards(arch, shape, profile,
                                                mesh_name, meshes):
    setup = specs.build_setup(arch, shape, meshes[mesh_name],
                              profile=profile)
    assert _port_leaves(setup.abstract_args) == _reference_args(
        arch, shape, profile, mesh_name)


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_input_specs_match_reference(shape, meshes):
    """``input_specs`` gives the reference's stand-ins: every leaf's path,
    global shape, dtype and local shape on the 16 × 16 mesh."""
    got = specs.input_specs("yi-6b", shape, meshes["16x16"])
    want = jspecs.input_specs("yi-6b", shape, AbstractMesh(*MESHES["16x16"]))
    assert _port_leaves(got) == _jax_leaves(want)


def _reference_row_keys():
    stats = jroof.CollectiveStats()
    row = jroof.Roofline("a", "s", "m", 1.0, 1.0, 0.0, stats, 1.0, 1).row()
    return set(row) | {"lower_s", "compile_s", "memory_analysis"}


def _run(*argv, tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, "-m", *argv], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_dryrun_process_rows(tmp_path):
    """One row: the reference's row keys plus ``build_s`` and
    ``collective_axes``; ``arg_gb_per_dev`` the sum of the reference's
    shard bytes; the terms at the H100 SXM5 rates; the collective term
    each axis's planned bytes over its link's rate (InfiniBand for both
    axes of the 16 × 16 mesh: each spans nodes of 8), the three terms
    deciding ``dominant``."""
    out = tmp_path / "rows.json"
    done = _run("repro_torch.launch.dryrun", "--device", "cpu", "--arch",
                "yi-6b", "--shape", "train_4k", "--json", str(out),
                tmp_path=tmp_path)
    assert done.returncode == 0, done.stderr[-3000:]
    assert "1 combos OK, 0 failed" in done.stdout
    (row,) = json.loads(out.read_text())
    assert set(row) == _reference_row_keys() | {"build_s", "collective_axes"}
    ref = jspecs.build_setup("yi-6b", "train_4k",
                             AbstractMesh(*MESHES["16x16"])).abstract_args
    shard_bytes = sum(math.prod(x.sharding.shard_shape(x.shape))
                      * x.dtype.itemsize for x in jax.tree.leaves(ref))
    assert row["arg_gb_per_dev"] == shard_bytes / 1e9
    cost = jcosts.step_cost(JModel(j_get_config("yi-6b")),
                            J_SHAPES["train_4k"])
    assert row["compute_s"] == cost.flops / (256 * 989e12)
    assert row["memory_s"] == cost.hbm_bytes / (256 * 3.35e12)
    axes = row["collective_axes"]
    assert {"data", "model"} <= set(axes) <= {"data", "model", "data+model"}
    assert all(v["link"] == "infiniband" for v in axes.values())
    assert row["collective_s"] == sum(v["bytes"] / 50e9
                                      for v in axes.values()) > 0
    assert sum(v["bytes"] for v in axes.values()) == \
        sum(row["collective_bytes"].values())
    assert set(row["collective_counts"]) <= set(jroof._COLLECTIVES)
    assert row["collective_counts"]["all-gather"] > 0
    terms = {k: row[k + "_s"] for k in ("compute", "memory", "collective")}
    assert row["dominant"] == max(terms, key=terms.get)
    for key in ("raw_cost_flops_per_dev", "raw_cost_bytes_per_dev",
                "lower_s", "compile_s", "memory_analysis"):
        assert row[key] is None


def test_hillclimb_process_records_its_override(tmp_path):
    out = tmp_path / "rows.json"
    done = _run("repro_torch.launch.hillclimb", "--device", "cpu", "--arch",
                "yi-6b", "--shape", "train_4k", "--profile", "zero3",
                "--override", "gather_kv=False", "--json", str(out),
                tmp_path=tmp_path)
    assert done.returncode == 0, done.stderr[-3000:]
    (row,) = json.loads(out.read_text())
    assert row["profile"] == "zero3"
    assert row["opts_overrides"] == {"gather_kv": False}
    assert row["collective_s"] > 0 and row["collective_counts"]


def test_axis_links_by_node():
    """An axis (or a join of axes, which DTensor reduces over at once) runs
    at the NVLink rate where every group of it lies in one node of 8
    ranks, else at InfiniBand's; a collective over no axis at
    InfiniBand's."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.collectives import CollectiveStats
    tmesh.fake_process_group(16)
    try:
        mesh = init_device_mesh("cpu", (4, 4),
                                mesh_dim_names=("data", "model"))
        links = roofline.axis_links(mesh)
        assert links == {"data": "infiniband", "model": "nvlink",
                         "data+model": "infiniband"}
        one_node = init_device_mesh("cpu", (2, 4),
                                    mesh_dim_names=("data", "model"))
        assert roofline.axis_links(one_node) == {
            "data": "nvlink", "model": "nvlink", "data+model": "nvlink"}
    finally:
        _destroy()
    stats = CollectiveStats()
    stats.add("all-gather", 900, 1, "model")
    stats.add("all-reduce", 100, 2, "data")
    stats.add("all-gather", 50, 1, "other")
    roof = roofline.Roofline("a", "s", "m", 0.0, 0.0, stats, 0.0, 16,
                             links=links)
    assert roof.collective_s == 900 / 450e9 + 200 / 50e9 + 50 / 50e9
    assert roof.dominant == "collective"
    assert roof.bound_time_s == roof.collective_s
    row = roof.row()
    assert row["collective_counts"] == {"all-gather": 2, "all-reduce": 2}
    assert row["collective_axes"]["model"] == {
        "bytes": 900, "link": "nvlink", "bytes_per_s": 450e9}


@pytest.mark.parametrize("arch,layers", [("yi-6b", 5), ("zamba2-7b", 7),
                                         ("llama-3.2-vision-90b", 6)])
def test_depth_extrapolated_collectives_equal_the_full_plan(arch, layers):
    """``count_collectives``'s plans at cut depths (and, for the hybrid's
    per-token scan, at two cut lengths), extended to the full step, give
    the full step's planned collectives exactly: reduced configs on a
    fake (2, 2) mesh, deeper than the cut plans."""
    import dataclasses
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import collectives as co
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=layers)
    shape = InputShape("mini_train", 48, 4, "train")    # C = 2, 2 a cluster
    tcfg = pt.PoFELTrainConfig(n_clusters=2)
    tmesh.fake_process_group(4)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))

        def build(cfg, shape):
            return specs.build_setup(arch, shape, mesh, tcfg=tcfg, cfg=cfg)
        setup = build(cfg, shape)
        assert setup.cfg.n_layers == layers
        assert co.layer_period(setup.cfg) == (cfg.attn_every
                                              or cfg.cross_attn_every or 1)
        got = co.count_collectives(setup, build, shape)
        want = co.plan_step(setup)
    finally:
        _destroy()
    assert got == want and want.count_by_kind


def test_launchers_default_to_the_card(tmp_path):
    done = _run("repro_torch.launch.dryrun", "--arch", "yi-6b", "--shape",
                "train_4k", tmp_path=tmp_path)
    assert done.returncode != 0 and "no CUDA device" in done.stderr


def test_new_modules_import_no_jax(tmp_path):
    code = ("import sys\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.hillclimb\n"
            "import repro_torch.models.sharding, repro_torch.models.remat\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')]\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized()\n"
            "print('CLEAN' if not bad else bad)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    done = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert done.stdout.strip() == "CLEAN", done.stdout + done.stderr[-2000:]


def test_a_step_on_the_fake_group_moves_no_data():
    from torch.distributed.device_mesh import init_device_mesh
    tmesh.fake_process_group(2)
    try:
        mesh = init_device_mesh("cpu", (2, 1),
                                mesh_dim_names=("data", "model"))
        setup = specs.build_train_setup(
            "yi-6b", mesh, INPUT_SHAPES["train_4k"],
            opts=FwdOptions(remat=True))
        with pytest.raises(ValueError, match="moves no data"):
            setup.step(*setup.abstract_args)
    finally:
        _destroy()


# -- steps on the host mesh --------------------------------------------------

@pytest.fixture
def host_mesh(monkeypatch):
    """A 1 × 1 gloo mesh, and the setup builders on the reduced configs."""
    _destroy()
    monkeypatch.setattr(specs, "get_config",
                        lambda arch: get_config(arch).reduced())
    yield tmesh.make_host_mesh("cpu")
    _destroy()


MINI_TRAIN = InputShape("mini_train", 16, 8, "train")


def test_host_steps_run_the_baseline_and_a_cluster_axis(host_mesh):
    """The baseline profile's step (its seq_shard_axis lever) and a step
    with the clusters sharded over ``data`` run on the host mesh and are
    ``pofel_round`` with the same options bit for bit; the same state as
    DTensors on the 1 × 1 mesh gives the same round too (within float32
    rounding: the DTensor path takes the clusters one at a time)."""
    from torch.distributed.tensor import DTensor
    rng = np.random.default_rng(1)
    tok = torch.from_numpy(rng.integers(0, 500, (2, 4, 16)).astype(np.int32))
    batch = {"tokens": tok, "labels": tok.roll(1, -1)}
    lam = torch.tensor([1.0, 2.0])
    for tcfg, opts in (
            (pt.PoFELTrainConfig(n_clusters=2, inner_lr=1e-2), None),
            (pt.PoFELTrainConfig(n_clusters=2, inner_lr=1e-2,
                                 cluster_axis="data"),
             FwdOptions(remat=True))):
        setup = specs.build_train_setup("yi-6b", host_mesh, MINI_TRAIN,
                                        tcfg, opts)
        run_opts = opts or specs.default_profile_config(
            "baseline", host_mesh)[1]
        state = pt.init_train_state(setup.model, tcfg,
                                    torch.Generator().manual_seed(0))
        s1, m1 = setup.step(state, batch, lam)
        s2, m2 = pt.pofel_round(setup.model, state, batch, lam, tcfg,
                                run_opts)
        assert torch.equal(m1.similarities, m2.similarities)
        assert torch.equal(m1.loss, m2.loss)
        for (p, a), (_, b) in zip(leaves_with_paths(s1.global_params),
                                  leaves_with_paths(s2.global_params)):
            assert torch.equal(a, b), p
        args = [specs.distribute_like(v, a) for v, a in
                zip((state, batch, lam), setup.abstract_args)]
        s3, m3 = setup.step(*args)
        assert isinstance(s3.global_params["embed"], DTensor)
        np.testing.assert_allclose(m3.loss.numpy(), m2.loss.numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(m3.similarities.numpy(),
                                   m2.similarities.numpy(), atol=1e-6)


@pytest.mark.parametrize("arch", ["yi-6b", "rwkv6-1.6b"])
def test_host_train_step_is_the_pofel_round(host_mesh, arch):
    """The host mesh's step with remat, on materialized arguments, is
    ``pofel_round`` bit for bit; an argument of another shape raises."""
    tcfg = pt.PoFELTrainConfig(n_clusters=2, inner_lr=1e-2)
    setup = specs.build_train_setup(arch, host_mesh, MINI_TRAIN, tcfg,
                                    FwdOptions(remat=True))
    model = setup.model
    state = pt.init_train_state(model, tcfg,
                                torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, 500, (2, 4, 16)).astype(np.int32))
    batch = {"tokens": tok, "labels": tok.roll(1, -1)}
    lam = torch.ones((2,))
    s1, m1 = setup.step(state, batch, lam)
    s2, m2 = pt.pofel_round(model, state, batch, lam, tcfg,
                            FwdOptions(remat=True))
    assert torch.equal(m1.similarities, m2.similarities)
    assert torch.equal(m1.loss, m2.loss)
    for (p, a), (_, b) in zip(leaves_with_paths(s1.global_params),
                              leaves_with_paths(s2.global_params)):
        assert torch.equal(a, b), p
    bad = {"tokens": tok[:, :1], "labels": tok[:, :1]}
    with pytest.raises(ValueError, match="labels"):
        setup.step(state, bad, lam)


@pytest.mark.parametrize("arch", ["yi-6b", "rwkv6-1.6b"])
def test_host_local_step_is_the_train_step(host_mesh, arch):
    """``build_local_step_setup``'s step on the host mesh, with remat, on
    materialized arguments, is ``train_step`` bit for bit; the arguments
    it takes are the train setup's state and batch."""
    tcfg = pt.PoFELTrainConfig(n_clusters=2, inner_lr=1e-2)
    opts = FwdOptions(remat=True)
    setup = specs.build_local_step_setup(arch, host_mesh, MINI_TRAIN, tcfg,
                                         opts)
    train = specs.build_train_setup(arch, host_mesh, MINI_TRAIN, tcfg, opts)
    assert _port_leaves(setup.abstract_args) == \
        _port_leaves(train.abstract_args[:2])
    model = setup.model
    state = pt.init_train_state(model, tcfg,
                                torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    tok = torch.from_numpy(rng.integers(0, 500, (2, 4, 16)).astype(np.int32))
    batch = {"tokens": tok, "labels": tok.roll(1, -1)}
    s1, l1 = setup.step(state, batch)
    s2, l2 = pt.train_step(model, state, batch, tcfg, opts)
    assert torch.equal(l1, l2)
    assert torch.equal(s1.round, s2.round)
    for (p, a), (_, b) in zip(leaves_with_paths(s1.cluster_params),
                              leaves_with_paths(s2.cluster_params)):
        assert torch.equal(a, b), p


def test_host_decode_step_is_the_models(host_mesh):
    setup = specs.build_decode_setup(
        "yi-6b", host_mesh, InputShape("mini_decode", 32, 2, "decode"))
    model = setup.model
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.tensor([[3], [7]], dtype=torch.int32)
    pos = torch.tensor(5, dtype=torch.int32)
    got, _ = setup.step(params, model.init_cache(2, 32), tokens, pos)
    want, _ = model.decode_step(params, model.init_cache(2, 32), tokens, 5)
    assert torch.equal(got, want)
