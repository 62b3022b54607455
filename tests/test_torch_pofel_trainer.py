"""The PoFEL trainer of the port (``repro_torch.fl.pofel_trainer``) against
the reference's (``repro.fl.pofel_trainer``), on the CPU at the reduced
configs, the seven tests of ``tests/test_pofel_trainer.py`` each holding
the port to the reference as well as to its own invariants.

Both packages start from the reference's initial state
(``train_state_from_jax``: ``jax.random`` draws cannot be reproduced in
torch) and take the same numpy batch; the vlm and audio models get the
launcher's stand-in context (``0.1 * ones`` bfloat16), so their
cross-attention is differentiated with keys of their own length (the
plain backward on the CPU). The reference runs under ``jax.jit``, one
program an arch; the port on one CPU thread.

Replicas that one FedSGD step moved apart agree to ~1e-6, so their
similarities all lie within ~1e-6 of 1 and would not tell a right Eq. 2
from a wrong one. Eq. 2, the consensus and the rounds whose similarities
and leader are compared therefore start from replicas made to differ:
seeded noise on every leaf, relative size DIVERGE[c] for cluster c,
added in float32 and cast to the leaf's dtype, the same arrays given to
both packages. Every such test asserts that the similarities spread over
more than 10 × SIM_ATOL and that the top two differ by more than
2 × SIM_ATOL, then compares the leader exactly.

At that spread the reference's jitted float32 Eq. 2 lies 2.5-3.8e-4
above a float64 evaluation of the same arrays, every cluster alike (run
op by op, ~6e-5 below; a CPU measurement): more than the similarity
tolerance. The port's similarities are therefore held against Eq. 2
evaluated in float64 on the reference's own replicas and aggregate
(``_eq2_64``), and its leader against the reference's leader.

Tolerances are those of ``tests/test_torch_lm_round.py`` for the models'
own bfloat16: losses within 5e-2, weights after a FedSGD step within
rtol 1e-2 / atol 1e-3, similarities within 1e-4; the port's per-leaf
kernel partials land ~2e-7 from float64 on its own arrays, which the
test of Eq. 2 checks at 1e-5. Eq. 1 on the same replicas: the
reference's kernel tolerances (tests/test_kernels.py:19-21) in each
leaf's dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.fl import pofel_trainer as jpt
from repro.models.model_api import Model as JModel
from repro.models.transformer import FwdOptions as JFwdOptions
from repro_torch.configs import get_config
from repro_torch.core.model_eval import cosine_similarities
from repro_torch.core.serialization import flatten_pytree, leaves_with_paths
from repro_torch.fl import pofel_trainer as pt
from repro_torch.models.model_api import Model
from repro_torch.models.transformer import FwdOptions

ARCHS = ["yi-6b", "musicgen-medium", "llama-3.2-vision-90b"]
J_OPTS, OPTS = JFwdOptions(remat=False), FwdOptions(remat=False)
LOSS_TOL = 5e-2
WEIGHT_TOL = dict(rtol=1e-2, atol=1e-3)
SIM_ATOL = 1e-4
C, B, S = 4, 2, 16
LAM_SIMS, LAM_EQ1 = [1.0, 2.0, 3.0, 4.0], [3.0, 1.0, 1.0, 1.0]
DIVERGE = np.array([0.15, 0.03, 0.09, 0.21], np.float32)


def _kernel_tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
            else dict(rtol=2e-5, atol=2e-6))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    return [leaf for _, leaf in leaves_with_paths(tree)]


def _assert_tree_close(port, ref, **tol):
    for (path, a), b in zip(leaves_with_paths(port), jax.tree.leaves(ref)):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   err_msg=path, **tol)


def _big(tree):
    """A leaf that every step moves: the embedding (the reference's test
    takes leaf 3, which at the vlm's reduced config is a norm's scale
    that a bfloat16 step leaves as it was)."""
    return tree["embed"]


def _diverged(cluster_params, seed=1):
    """The replicas with seeded noise on every leaf: relative size
    DIVERGE[c] of the leaf's rms (at least 1e-2) for cluster c, added in
    float32 and cast back to the leaf's dtype."""
    rng = np.random.default_rng(seed)

    def leaf(x):
        x32 = np.asarray(x, np.float32)
        rms = max(float(np.sqrt(np.mean(x32[0] ** 2))), 1e-2)
        scale = (DIVERGE * rms).reshape((-1,) + (1,) * (x32.ndim - 1))
        noise = rng.standard_normal(x32.shape, dtype=np.float32)
        return jnp.asarray(x32 + scale * noise).astype(x.dtype)
    return jax.tree.map(leaf, cluster_params)


def _eq2_64(replicas, gw):
    """Eq. 2 in float64 on the reference's numpy replicas (C, ...) and
    aggregate, over the leaves in its flatten order."""
    W = np.concatenate([np.asarray(w, np.float64).reshape(C, -1)
                        for w in jax.tree.leaves(replicas)], axis=1)
    g = np.concatenate([np.asarray(x, np.float64).reshape(-1)
                        for x in jax.tree.leaves(gw)])
    return (W @ g) / (np.linalg.norm(W, axis=1) * np.linalg.norm(g))


def _assert_sims_match(port_sims, port_leader, ref_sims, ref_leader):
    """Similarities within SIM_ATOL of ``ref_sims`` (``_eq2_64``) and the
    reference's leader, on similarities that spread far enough for both
    checks to mean something."""
    top = np.sort(ref_sims)[::-1]
    assert top[0] - top[-1] > 10 * SIM_ATOL, ref_sims
    assert top[0] - top[1] > 2 * SIM_ATOL, ref_sims
    np.testing.assert_allclose(np.asarray(port_sims, np.float64), ref_sims,
                               rtol=0, atol=SIM_ATOL)
    assert int(port_leader) == int(ref_leader) == int(np.argmax(ref_sims))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's side on one CPU thread: its ops are small, and the test
    workers share the machine's cores with the reference's XLA threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    """Both packages' inputs of one arch, and the reference's results
    from one jitted program: a local step and Eq. 1 on its replicas;
    Eq. 1, Eq. 2, the consensus and a round of each outer update from
    the diverged replicas; and five sgd1 rounds from the initial
    state."""
    arch = request.param
    jm = JModel(j_get_config(arch).reduced())
    tm = Model(get_config(arch).reduced(), device="cpu")
    jcfg = jpt.PoFELTrainConfig(n_clusters=C, inner_lr=1e-2)
    tcfg = pt.PoFELTrainConfig(n_clusters=C, inner_lr=1e-2)
    js = jax.jit(lambda key: jpt.init_train_state(jm, jcfg, key))(
        jax.random.key(0))
    ts = pt.train_state_from_jax(_np(js), tm)
    rng = np.random.default_rng(0)
    tok = rng.integers(0, 500, (C, B, S)).astype(np.int32)
    lab = rng.integers(0, 500, (C, B, S)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    tb = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
    if tm.needs_context():
        shape = (C, B, tm.cfg.n_context_tokens, tm.cfg.d_model)
        jb["context"] = 0.1 * jnp.ones(shape, jnp.bfloat16)
        tb["context"] = 0.1 * torch.ones(shape, dtype=torch.bfloat16)
    ones = jnp.ones((C,), jnp.float32)
    nesterov = jpt.PoFELTrainConfig(n_clusters=C, inner_lr=1e-2,
                                    outer="nesterov")
    jdiv = js._replace(cluster_params=_diverged(js.cluster_params))

    @jax.jit
    def reference(state, div, batch):
        local = jpt.local_step(jm, state.cluster_params, batch, jcfg, J_OPTS)
        gw = jpt._weighted_global(div.cluster_params, jnp.asarray(LAM_SIMS))
        return {"local": local, "gw": gw,
                "sims": jpt._similarities(div.cluster_params, gw),
                "consensus": jpt.consensus(div.cluster_params,
                                           jnp.asarray(LAM_SIMS),
                                           div.btsv_history, jcfg),
                "eq1": {dt: jpt._weighted_global(local[0],
                                                 jnp.asarray(LAM_EQ1), dt)
                        for dt in ("float32", "bfloat16")},
                "sgd1": jpt.pofel_round(jm, state, batch, ones, jcfg, J_OPTS),
                "div_local": jpt.local_step(jm, div.cluster_params, batch,
                                            jcfg, J_OPTS)[0],
                "div_sgd1": jpt.pofel_round(jm, div, batch, ones, jcfg,
                                            J_OPTS),
                "div_nesterov": jpt.pofel_round(jm, div, batch, ones,
                                                nesterov, J_OPTS)}

    first = reference(js, jdiv, jb)
    ref, s = dict(first), js
    ref["rounds"] = []
    for k in range(5):
        out = first if k == 0 else reference(s, jdiv, jb)
        s = out["sgd1"][0]
        ref["rounds"].append(out["sgd1"])
    jdiv = _np(jdiv)
    return dict(arch=arch, tm=tm, tcfg=tcfg, js=js, ts=ts, tb=tb, jdiv=jdiv,
                tdiv=pt.train_state_from_jax(jdiv, tm),
                ref=jax.tree.map(np.asarray, ref))


def _carried_replicas(run, params):
    """The reference's replicas as the port's tensors."""
    return pt.train_state_from_jax(
        run["js"]._replace(cluster_params=params), run["tm"]).cluster_params


def test_local_step_diverges_clusters(run):
    new_params, losses = pt.local_step(run["tm"], run["ts"].cluster_params,
                                       run["tb"], run["tcfg"], OPTS)
    assert losses.shape == (4,)
    assert torch.isfinite(losses).all()
    # different data per cluster ⇒ different replicas after one step
    leaf = _big(new_params)
    assert not torch.equal(leaf[0], leaf[1])
    ref_params, ref_losses = run["ref"]["local"]
    np.testing.assert_allclose(losses.numpy(), ref_losses, atol=LOSS_TOL)
    _assert_tree_close(new_params, ref_params, **WEIGHT_TOL)
    # the state the step was given is untouched
    _assert_tree_close(run["ts"].cluster_params,
                       _np(run["js"].cluster_params), rtol=0, atol=0)


def test_similarities_match_core_model_eval(run):
    """The per-leaf partial-term decomposition equals flatten-and-dot, and
    the reference's Eq. 2 on the same diverged replicas."""
    replicas = run["tdiv"].cluster_params
    gw = pt._weighted_global(replicas, torch.tensor(LAM_SIMS))
    sims = pt._similarities(replicas, gw)
    W = torch.stack([flatten_pytree(pt._map(lambda t: t[c], replicas))
                     for c in range(4)])
    want = cosine_similarities(W, flatten_pytree(gw))
    np.testing.assert_allclose(sims.numpy(), np.clip(want.numpy(), -1, 1),
                               atol=2e-3)
    W64, g64 = W.double(), flatten_pytree(gw).double()
    exact = (W64 @ g64) / (W64.norm(dim=1) * g64.norm())
    np.testing.assert_allclose(sims.numpy(), exact.numpy(), atol=1e-5)
    _assert_sims_match(sims, torch.argmax(sims),
                       _eq2_64(run["jdiv"].cluster_params, run["ref"]["gw"]),
                       np.argmax(run["ref"]["sims"]))
    for (path, a), b in zip(leaves_with_paths(gw),
                            jax.tree.leaves(run["ref"]["gw"])):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), err_msg=path,
                                   **_kernel_tol(a.dtype))


def test_consensus_matches_reference(run):
    """Alg. 1 lines 2-5 on the diverged replicas: the aggregate, the
    similarities, the leader, the vote weights, the BTS scores and the
    new history, each against the reference."""
    div = run["tdiv"]
    gw, hist, m = pt.consensus(div.cluster_params, torch.tensor(LAM_SIMS),
                               div.btsv_history, run["tcfg"])
    ref_gw, ref_hist, ref_m = run["ref"]["consensus"]
    _assert_sims_match(m.similarities, m.leader,
                       _eq2_64(run["jdiv"].cluster_params, ref_gw),
                       ref_m.leader)
    assert m.leader.dtype == torch.int32
    for (path, a), b in zip(leaves_with_paths(gw), jax.tree.leaves(ref_gw)):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), err_msg=path,
                                   **_kernel_tol(a.dtype))
    np.testing.assert_allclose(m.vote_weights.numpy(), ref_m.vote_weights,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m.scores.numpy(), ref_m.scores, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(hist.numpy(), ref_hist, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted_global_matches_eq1(run, dtype):
    ref_params, _ = run["ref"]["local"]
    replicas = _carried_replicas(run, ref_params)
    lambdas = torch.tensor(LAM_EQ1)
    gw = pt._weighted_global(replicas, lambdas, dtype)
    leaf = _leaves(replicas)[3].float()
    expect = torch.einsum("c,c...->...", lambdas / lambdas.sum(), leaf)
    got = _leaves(gw)[3].float()
    np.testing.assert_allclose(got.numpy(), expect.numpy(), atol=2e-2,
                               rtol=2e-2)
    for (path, a), b, w in zip(leaves_with_paths(gw),
                               jax.tree.leaves(run["ref"]["eq1"][dtype]),
                               _leaves(replicas)):
        assert a.dtype == w.dtype and a.shape == w.shape[1:], path
        tol = _kernel_tol(torch.bfloat16 if dtype == "bfloat16" else a.dtype)
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), err_msg=path,
                                   **tol)


def test_pofel_round_redistributes_global(run):
    new_state, metrics = pt.pofel_round(run["tm"], run["tdiv"], run["tb"],
                                        torch.ones((4,)), run["tcfg"], OPTS)
    assert int(new_state.round) == 1
    assert new_state.round.dtype == torch.int32
    assert 0 <= int(metrics.leader) < 4
    assert torch.isfinite(metrics.similarities).all()
    # all clusters hold the new global after redistribution
    for leaf in _leaves(new_state.cluster_params):
        for c in range(1, 4):
            assert torch.equal(leaf[0], leaf[c])
    ref_state, ref_m = run["ref"]["div_sgd1"]
    np.testing.assert_allclose(metrics.loss.numpy(), ref_m.loss,
                               atol=LOSS_TOL)
    _assert_sims_match(metrics.similarities, metrics.leader,
                       _eq2_64(run["ref"]["div_local"],
                               ref_state.global_params), ref_m.leader)
    _assert_tree_close(new_state.global_params, ref_state.global_params,
                       **WEIGHT_TOL)
    np.testing.assert_allclose(new_state.btsv_history.numpy(),
                               ref_state.btsv_history, atol=1e-4)


def test_rounds_decrease_loss(run):
    state, lambdas = run["ts"], torch.ones((4,))
    losses = []
    for k in range(5):
        state, metrics = pt.pofel_round(run["tm"], state, run["tb"], lambdas,
                                        run["tcfg"], OPTS)
        losses.append(float(torch.mean(metrics.loss)))
        ref_m = run["ref"]["rounds"][k][1]
        assert abs(losses[-1] - float(np.mean(ref_m.loss))) < LOSS_TOL
    assert losses[-1] < losses[0]


def test_nesterov_outer_differs_from_sgd1(run):
    lam = torch.ones((4,))
    cfg1 = pt.PoFELTrainConfig(n_clusters=4, inner_lr=1e-2, outer="sgd1")
    cfg2 = pt.PoFELTrainConfig(n_clusters=4, inner_lr=1e-2, outer="nesterov")
    s1, _ = pt.pofel_round(run["tm"], run["tdiv"], run["tb"], lam, cfg1,
                           OPTS)
    s2, m2 = pt.pofel_round(run["tm"], run["tdiv"], run["tb"], lam, cfg2,
                            OPTS)
    assert not torch.equal(_big(s1.global_params), _big(s2.global_params))
    ref_state, ref_m = run["ref"]["div_nesterov"]
    _assert_tree_close(s2.global_params, ref_state.global_params,
                       **WEIGHT_TOL)
    _assert_tree_close(s2.outer_momentum, ref_state.outer_momentum,
                       **WEIGHT_TOL)
    # the outer update follows the consensus: Eq. 2 is sgd1's
    _assert_sims_match(m2.similarities, m2.leader,
                       _eq2_64(run["ref"]["div_local"],
                               run["ref"]["div_sgd1"][0].global_params),
                       ref_m.leader)


def test_train_step_no_consensus_keeps_divergence(run):
    s1, losses = pt.train_step(run["tm"], run["ts"], run["tb"], run["tcfg"],
                               OPTS)
    leaf = _big(s1.cluster_params)
    assert not torch.equal(leaf[0], leaf[1])
    assert int(s1.round) == 0  # round counter only advances at consensus
    ref_params, ref_losses = run["ref"]["local"]
    np.testing.assert_allclose(losses.numpy(), ref_losses, atol=LOSS_TOL)
    _assert_tree_close(s1.cluster_params, ref_params, **WEIGHT_TOL)


def test_trainer_refuses_what_one_card_does_not_run(run):
    """remat, the mesh levers and a sharded cluster axis name ROADMAP
    item 15 instead of running something else."""
    tm, ts, tb = run["tm"], run["ts"], run["tb"]
    with pytest.raises(NotImplementedError, match="item 15"):
        pt.local_step(tm, ts.cluster_params, tb, run["tcfg"], FwdOptions())
    with pytest.raises(NotImplementedError, match="item 15"):
        pt.local_step(tm, ts.cluster_params, tb, run["tcfg"],
                      FwdOptions(remat=False, gather_kv=True))
    with pytest.raises(NotImplementedError, match="item 15"):
        pt.local_step(tm, ts.cluster_params, tb, pt.PoFELTrainConfig(
            n_clusters=4, cluster_axis="data"), OPTS)
