"""The port's batched FEL engine (``repro_torch.fl.batched_fel``) on the
CPU, against the port's own reference loop and against the JAX engine.

Against the port's loop, every case of ``tests/test_batched_fel.py`` at
that file's tolerances: same seeds → (all-but-)identical parameters every
round and the identical leader sequence, including ragged and empty
client shards and the plagiarist path, with the MLP's dropout on (the
engine draws the loop's own masks). Against the JAX ``BatchedFELEngine``:
the same hierarchy and data, dropout 0 and the reference's init carried
across with ``params_from_jax``; each round's W within rtol 1e-5 /
atol 1e-6 (float32 GEMMs on two CPU backends over a few SGD steps:
observed at most 0.12 of that bound), the similarities within 3e-6
(two float32 sums of 10^5 terms: observed at most 2.1e-6) and the
leaders equal. A leader is decided by the top-2 similarity margin, so
each round first asserts that margin exceeds twice the similarity
tolerance (then two similarity vectors within the tolerance elect the
same node): the cases train with label-skewed shards or ragged sizes at
lr 0.05-0.15, where the margins are 2.4e-5 or more; at lr 1e-3 all N
similarities lie within float32 rounding of each other and the leader
is that rounding's pick. ``_batch_plan`` is exactly equal.
"""

import jax
import numpy as np
import pytest
import torch

from repro.data.synthetic import make_mnist_like as j_mnist
from repro.fl.client import Client as JClient
from repro.fl.hfl_runtime import BHFLConfig as JConfig
from repro.fl.hfl_runtime import BHFLRuntime as JRuntime
from repro.fl.hierarchy import FELCluster as JCluster
from repro.fl.hierarchy import build_hierarchy as j_build
from repro.models.mlp import MLPConfig as JMLPConfig
from repro_torch.core.serialization import flatten_pytree
from repro_torch.data.synthetic import make_mnist_like
from repro_torch.fl.adapters import MLPAdapter, params_from_jax
from repro_torch.fl.client import Client
from repro_torch.fl.hfl_runtime import BHFLConfig, BHFLRuntime
from repro_torch.fl.hierarchy import FELCluster, build_hierarchy
from repro_torch.models.mlp import MLPConfig

JAX_TOL = dict(rtol=1e-5, atol=1e-6)
SIM_ATOL = 3e-6


@pytest.fixture
def one_thread():
    """The loop against the engine runs on one CPU thread. MKL's float32
    GEMM rounds a product differently with the thread count (the loop's
    single 32-row product is split across threads, while the engine's
    batched product gives each client one thread), so only on one thread
    do both compute every client's products alike; the similarities of
    these small runs lie within a few float32 ulps of each other, where
    that rounding picks the leader."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _global_flat(rt: BHFLRuntime) -> np.ndarray:
    if rt._global_flat is not None:
        return rt._global_flat.numpy()
    return flatten_pytree(rt.global_params).numpy()


def _run_both(make_runtime, rounds=3, **kw):
    ref = make_runtime("reference", **kw)
    bat = make_runtime("batched", **kw)
    assert ref.engine == "reference" and bat.engine == "batched"
    out = []
    for _ in range(rounds):
        m_ref = ref.run_round()
        m_bat = bat.run_round()
        out.append((m_ref, m_bat, _global_flat(ref), _global_flat(bat)))
    return out


# ---------------------------------------------------------------------------
# against the port's reference loop: uniform IID shards
# ---------------------------------------------------------------------------

def test_parity_uniform_iid(one_thread):
    train, test = make_mnist_like(n_train=720, n_test=60)

    def make(engine):
        cfg = BHFLConfig(n_nodes=3, clients_per_node=2, fel_iterations=2,
                         engine=engine)
        return BHFLRuntime(build_hierarchy(train, 3, 2, "iid"), cfg, test,
                           device="cpu")

    for r, (m_ref, m_bat, g_ref, g_bat) in enumerate(_run_both(make, rounds=3)):
        assert m_ref.leader_id == m_bat.leader_id, f"leader diverged @ round {r}"
        np.testing.assert_allclose(g_ref, g_bat, rtol=1e-6, atol=1e-7)
        assert m_ref.test_accuracy == pytest.approx(m_bat.test_accuracy,
                                                    abs=1e-6)
        np.testing.assert_allclose(np.asarray(m_ref.consensus.similarities),
                                   np.asarray(m_bat.consensus.similarities),
                                   rtol=1e-6, atol=1e-7)


def test_parity_multi_epoch_and_multi_batch(one_thread):
    """Several SGD steps per iteration (epochs × batches) keep the dropout
    draws and the lr-decay step count aligned."""
    train, _ = make_mnist_like(n_train=600, n_test=10)

    def make(engine):
        cfg = BHFLConfig(n_nodes=2, clients_per_node=2, fel_iterations=2,
                         local_epochs=2, batch_size=32, engine=engine)
        return BHFLRuntime(build_hierarchy(train, 2, 2, "iid"), cfg, None,
                           device="cpu")

    for r, (m_ref, m_bat, g_ref, g_bat) in enumerate(_run_both(make, rounds=3)):
        assert m_ref.leader_id == m_bat.leader_id
        np.testing.assert_allclose(g_ref, g_bat, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# ragged / empty shards
# ---------------------------------------------------------------------------

def _ragged_clusters(train, sizes, client=Client, cluster=FELCluster):
    clusters, cid, off = [], 0, 0
    for nid, row in enumerate(sizes):
        clients = []
        for s in row:
            idx = np.arange(off, off + s)
            off += s
            clients.append(client(cid, train.subset(idx)))
            cid += 1
        clusters.append(cluster(nid, clients))
    return clusters


def test_parity_ragged_and_empty_shards(one_thread):
    """Ragged client sizes, an empty client, and a fully dataless cluster:
    the masked batched reduction must agree with the skip-empty loop (the
    dataless cluster keeps the incoming global model)."""
    train, _ = make_mnist_like(n_train=400, n_test=10)
    sizes = [[70, 37, 0], [12, 90, 3], [0, 0, 0]]

    def make(engine):
        cfg = BHFLConfig(n_nodes=3, clients_per_node=3, fel_iterations=2,
                         engine=engine)
        return BHFLRuntime(_ragged_clusters(train, sizes), cfg, None,
                           device="cpu")

    for r, (m_ref, m_bat, g_ref, g_bat) in enumerate(_run_both(make, rounds=3)):
        assert m_ref.leader_id == m_bat.leader_id
        np.testing.assert_allclose(g_ref, g_bat, rtol=1e-5, atol=1e-6)


def test_dataless_cluster_keeps_global_model():
    train, _ = make_mnist_like(n_train=200, n_test=10)
    sizes = [[50, 50], [0, 0]]
    cfg = BHFLConfig(n_nodes=2, clients_per_node=2, fel_iterations=2,
                     engine="batched")
    bat = BHFLRuntime(_ragged_clusters(train, sizes), cfg, None, device="cpu")
    start = bat._global_flat.numpy().copy()
    W = bat._engine.run_round(bat._global_flat, round_seed=1)
    np.testing.assert_array_equal(W[1].numpy(), start)
    assert not np.array_equal(W[0].numpy(), start)


# ---------------------------------------------------------------------------
# plagiarist attack path
# ---------------------------------------------------------------------------

def test_parity_plagiarist_path(one_thread):
    train, _ = make_mnist_like(n_train=600, n_test=10)

    def make(engine):
        cfg = BHFLConfig(n_nodes=3, clients_per_node=2, fel_iterations=1,
                         engine=engine)
        rt = BHFLRuntime(build_hierarchy(train, 3, 2, "iid"), cfg, None,
                         device="cpu")
        rt.plagiarists = {1}
        return rt

    for r, (m_ref, m_bat, g_ref, g_bat) in enumerate(_run_both(make, rounds=3)):
        assert m_ref.leader_id == m_bat.leader_id
        np.testing.assert_allclose(g_ref, g_bat, rtol=1e-6, atol=1e-7)
        # HCDS flags the byte-identical copy identically on both paths
        assert m_ref.consensus.rejected == m_bat.consensus.rejected
        assert "plagiarized-model" in m_bat.consensus.rejected.values()


# ---------------------------------------------------------------------------
# engine selection / fallback
# ---------------------------------------------------------------------------

class _NoBatchAdapter:
    """Minimal adapter without batched_train_spec (protocol minimum)."""

    name = "no-batch"
    device = torch.device("cpu")
    init_device = "cpu"

    def __init__(self):
        self._inner = MLPAdapter(cfg=MLPConfig(hidden=8), device="cpu")

    def init(self, generator):
        return self._inner.init(generator)

    def local_train(self, params, client, *, seed=0):
        return self._inner.local_train(params, client, seed=seed)

    def evaluate(self, params, dataset):
        return self._inner.evaluate(params, dataset)

    def flatten(self, params):
        return self._inner.flatten(params)

    def unflatten(self, flat, template):
        return self._inner.unflatten(flat, template)


def test_engine_flag_validation_and_fallback():
    train, _ = make_mnist_like(n_train=200, n_test=10)
    clusters = build_hierarchy(train, 2, 2, "iid")
    cfg = BHFLConfig(n_nodes=2, clients_per_node=2, engine="nope")
    with pytest.raises(ValueError, match="unknown engine"):
        BHFLRuntime(clusters, cfg, None, device="cpu")

    cfg = BHFLConfig(n_nodes=2, clients_per_node=2,
                     mlp=MLPConfig(hidden=8), engine="batched")
    with pytest.raises(ValueError, match="batched_train_spec"):
        BHFLRuntime(build_hierarchy(train, 2, 2, "iid"), cfg, None,
                    adapter=_NoBatchAdapter(), device="cpu")

    cfg = BHFLConfig(n_nodes=2, clients_per_node=2,
                     mlp=MLPConfig(hidden=8), engine="auto")
    rt = BHFLRuntime(build_hierarchy(train, 2, 2, "iid"), cfg, None,
                     adapter=_NoBatchAdapter(), device="cpu")
    assert rt.engine == "reference"
    rt.run_round()     # fallback path still completes a round

    cfg = BHFLConfig(n_nodes=2, clients_per_node=2,
                     mlp=MLPConfig(hidden=8), engine="auto")
    rt = BHFLRuntime(build_hierarchy(train, 2, 2, "iid"), cfg, None,
                     device="cpu")
    assert rt.engine == "batched"

    # a hierarchy with no data at all: 'auto' falls back, 'batched' raises
    empty = _ragged_clusters(train, [[0, 0], [0, 0]])
    cfg = BHFLConfig(n_nodes=2, clients_per_node=2,
                     mlp=MLPConfig(hidden=8), engine="auto")
    assert BHFLRuntime(empty, cfg, None, device="cpu").engine == "reference"
    cfg = BHFLConfig(n_nodes=2, clients_per_node=2,
                     mlp=MLPConfig(hidden=8), engine="batched")
    with pytest.raises(ValueError, match="non-empty"):
        BHFLRuntime(empty, cfg, None, device="cpu")


def test_global_params_setter_keeps_the_flat_state_in_sync():
    train, _ = make_mnist_like(n_train=200, n_test=10)
    cfg = BHFLConfig(n_nodes=2, clients_per_node=2,
                     mlp=MLPConfig(hidden=8), engine="batched")
    rt = BHFLRuntime(build_hierarchy(train, 2, 2, "iid"), cfg, None,
                     device="cpu")
    warm = {k: v + 1.0 for k, v in rt.global_params.items()}
    rt.global_params = warm
    assert torch.equal(rt._global_flat, flatten_pytree(warm))


def test_lm_adapter_batched_engine_runs():
    """LM adapters opt in to the batched engine; bf16 params mean the two
    engines only track loosely (the loop promotes to f32 after step 1, the
    engine trains in f32 throughout), so this is a smoke + shape test."""
    from repro_torch.data.tokens import make_token_dataset
    from repro_torch.fl.adapters import transformer_adapter

    train, test = make_token_dataset(n_seqs=64, seq_len=8, vocab_size=32)
    cfg = BHFLConfig(n_nodes=2, clients_per_node=2, fel_iterations=1,
                     engine="batched")
    # d_model 32: two heads of 16 (the reference's 16 gives heads of 8,
    # below the flash kernel's smallest head dim)
    ad = transformer_adapter(vocab_size=32, d_model=32, n_layers=1,
                             device="cpu")
    rt = BHFLRuntime(build_hierarchy(train, 2, 2, "iid"), cfg, test,
                     adapter=ad, device="cpu")
    m = rt.run_round()
    assert np.isfinite(m.test_loss)
    assert rt._global_flat.shape[0] == flatten_pytree(rt.global_params).shape[0]


# ---------------------------------------------------------------------------
# shape bucketing
# ---------------------------------------------------------------------------

def test_shape_bucketing_is_bit_exact():
    """Bucketing pads the client, sample, step and batch axes to powers of
    two (3 clients → 4, 96 samples → 128, 3 steps → 4); the padding is
    masked, so the padded round's W is bit-identical to the exact one.
    (The reference also pins its jit cache here; eager torch compiles
    nothing.)"""
    adapter = MLPAdapter(cfg=MLPConfig(hidden=8), device="cpu")

    def runtime(clients, per_client, bucketing=True):
        train, _ = make_mnist_like(n_train=2 * clients * per_client,
                                   n_test=10)
        cfg = BHFLConfig(n_nodes=2, clients_per_node=clients,
                         fel_iterations=1, mlp=MLPConfig(hidden=8),
                         engine="batched", shape_bucketing=bucketing)
        return BHFLRuntime(build_hierarchy(train, 2, clients, "iid"), cfg,
                           None, adapter=adapter, device="cpu")

    rt1 = runtime(3, 96)
    assert rt1._engine.n_clients_padded == 4
    assert rt1._engine.n_max == 128
    assert rt1._engine.steps_per_iteration == 4
    assert not rt1._engine._uniform
    rt1.run_round()

    exact = runtime(3, 96, bucketing=False)
    assert exact._engine._uniform
    start = exact._global_flat
    W_exact = exact._engine.run_round(start, 1).numpy()
    W_bucket = rt1._engine.run_round(start, 1).numpy()
    np.testing.assert_array_equal(W_exact, W_bucket)


def test_api_engine_kwarg():
    from repro_torch import api
    for engine in ("batched", "auto"):
        run = api.run_bhfl(model="mlp", n_nodes=2, clients_per_node=2,
                           fel_iterations=1, rounds=2, engine=engine,
                           device="cpu")
        assert run.runtime.engine == "batched"
        assert run.chain_valid and run.chain_height == 2


def test_fel_dispatch_is_traced():
    from repro_torch import api
    from repro_torch.obs import TraceRecorder, use_recorder
    rec = TraceRecorder("t")
    with use_recorder(rec):
        api.run_bhfl(model="mlp", n_nodes=2, clients_per_node=2,
                     fel_iterations=1, rounds=2, engine="batched",
                     device="cpu", mlp=MLPConfig(hidden=8))
    assert [s.name for s in rec.spans].count("fel.dispatch") == 2
    fel = [s for s in rec.spans if s.name == "fel"]
    assert [s.attrs.get("engine") for s in fel] == ["batched"] * 2
    snap = rec.metrics_snapshot()
    assert snap["counters"]["fel.dispatches"] == 2


# ---------------------------------------------------------------------------
# against the JAX engine
# ---------------------------------------------------------------------------

def _capture_W(rt, key):
    """Wrap ``rt``'s engine so that each round's W lands in a list."""
    seen = []
    run = rt._engine.run_round

    def wrapped(flat, round_seed):
        W = run(flat, round_seed)
        seen.append(np.asarray(W, np.float32).copy() if key == "jax"
                    else W.numpy().copy())
        return W
    rt._engine.run_round = wrapped
    return seen


def _both_engines(sizes=None, **common):
    """A JAX and a port runtime, both batched, over one hierarchy and the
    reference's init; dropout 0."""
    n_nodes, per = common.pop("n_nodes"), common.pop("clients_per_node")
    jtr, _ = j_mnist(n_train=common.pop("n_train"), n_test=10)
    ttr, _ = make_mnist_like(n_train=jtr.x.shape[0], n_test=10)
    np.testing.assert_array_equal(jtr.x, ttr.x)
    if sizes is None:
        jcl = j_build(jtr, n_nodes, per, "label")
        tcl = build_hierarchy(ttr, n_nodes, per, "label")
    else:
        jcl = _ragged_clusters(jtr, sizes, JClient, JCluster)
        tcl = _ragged_clusters(ttr, sizes)
    jrt = JRuntime(jcl, JConfig(n_nodes=n_nodes, clients_per_node=per,
                                mlp=JMLPConfig(dropout=0.0),
                                engine="batched", **common))
    trt = BHFLRuntime(tcl, BHFLConfig(n_nodes=n_nodes, clients_per_node=per,
                                      mlp=MLPConfig(dropout=0.0),
                                      engine="batched", **common),
                      None, device="cpu")
    trt.global_params = params_from_jax(
        {k: np.asarray(v) for k, v in jrt.global_params.items()},
        device="cpu")
    return jrt, trt


ENGINE_CASES = {
    "uniform": dict(n_train=720, n_nodes=3, clients_per_node=2,
                    fel_iterations=2, lr=0.1),
    "multi_epoch": dict(n_train=600, n_nodes=3, clients_per_node=2,
                        fel_iterations=2, local_epochs=2, lr=0.05),
    "ragged": dict(n_train=400, n_nodes=3, clients_per_node=3,
                   fel_iterations=2, lr=0.15,
                   sizes=[[70, 37, 0], [12, 90, 3], [0, 0, 0]]),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_matches_the_jax_engine(case):
    jrt, trt = _both_engines(**dict(ENGINE_CASES[case]))
    Wj, Wt = _capture_W(jrt, "jax"), _capture_W(trt, "torch")
    for r in range(3):
        mj, mt = jrt.run_round(), trt.run_round()
        np.testing.assert_allclose(Wt[r], Wj[r], **JAX_TOL)
        sj = np.asarray(mj.consensus.similarities)
        np.testing.assert_allclose(mt.consensus.similarities, sj,
                                   rtol=0, atol=SIM_ATOL)
        top2 = np.sort(sj)[-2:]
        assert top2[1] - top2[0] > 2 * SIM_ATOL
        assert mt.leader_id == mj.leader_id, f"leader diverged @ round {r}"
        np.testing.assert_allclose(_global_flat(trt),
                                   np.asarray(jrt._global_flat), **JAX_TOL)


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
@pytest.mark.parametrize("bucket", [False, True])
def test_batch_plan_equals_the_jax_engine(case, bucket):
    jrt, trt = _both_engines(**dict(ENGINE_CASES[case],
                                    shape_bucketing=bucket))
    je, te = jrt._engine, trt._engine
    assert (te.n_clients_padded, te.n_max, te.steps_per_iteration,
            te.batch_pad, te._uniform) == (
        je.n_clients_padded, je.n_max, je.steps_per_iteration,
        je.batch_pad, je._uniform)
    np.testing.assert_array_equal(te._stepmask.numpy(),
                                  np.asarray(je._stepmask))
    for round_seed in (1, 7):
        ti, ts = te._batch_plan(round_seed)
        ji, js = je._batch_plan(round_seed)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ts, js)
        assert ti.dtype == ji.dtype and ts.dtype == js.dtype


def test_int32_seed_check_matches_the_jax_engine():
    jrt, trt = _both_engines(**dict(ENGINE_CASES["uniform"]))
    big = 2 ** 31 // 1000 + 1
    for eng, flat in ((jrt._engine, jrt._global_flat),
                      (trt._engine, trt._global_flat)):
        with pytest.raises(ValueError, match="overflows int32"):
            eng.run_round(flat, big)
