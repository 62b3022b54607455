"""ME (Eq. 1-2, Alg. 3) of the port against the reference: the cases of
tests/test_model_eval.py run through ``repro_torch.core.model_eval``, and
the same inputs through both packages.

Tolerances: float32 sums in another order, rtol 2e-5 / atol 2e-6 (the
reference's, tests/test_kernels.py:19-21) unless a case states its own.
Votes and predictions compare exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import model_eval as jme
from repro_torch.core import model_eval as tme
from repro_torch.core.serialization import flatten_pytree

FP32 = dict(rtol=2e-5, atol=2e-6)


def test_aggregate_matches_manual_and_reference(rng):
    W = rng.normal(size=(4, 64)).astype(np.float32)
    sizes = np.array([10, 20, 30, 40], np.float32)
    gw = tme.aggregate_global(torch.from_numpy(W), torch.from_numpy(sizes))
    manual = (W * (sizes / sizes.sum())[:, None]).sum(0)
    np.testing.assert_allclose(gw.numpy(), manual, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        gw.numpy(), np.asarray(jme.aggregate_global(jnp.asarray(W),
                                                    jnp.asarray(sizes))),
        **FP32)


def test_cosine_similarity_range_and_self(rng):
    W = rng.normal(size=(5, 128)).astype(np.float32)
    sims = tme.cosine_similarities(torch.from_numpy(W),
                                   torch.from_numpy(W[2])).numpy()
    assert np.all(sims <= 1.0 + 1e-6) and np.all(sims >= -1.0 - 1e-6)
    np.testing.assert_allclose(sims[2], 1.0, atol=1e-6)
    ref = np.asarray(jme.cosine_similarities(jnp.asarray(W),
                                             jnp.asarray(W[2])))
    np.testing.assert_allclose(sims, ref, **FP32)


def test_vote_goes_to_most_similar(rng):
    gw_dir = rng.normal(size=(64,)).astype(np.float32)
    W = rng.normal(size=(6, 64)).astype(np.float32)
    W[3] = 50.0 * gw_dir + 0.01 * W[3]
    res = tme.model_evaluation(torch.from_numpy(W), torch.ones(6))
    assert int(res.vote) == 3


@pytest.mark.parametrize("n,vote", [(50, 2), (4, 0), (1, 0)])
def test_predictions_match_reference(n, vote):
    """Alg. 3 rows sum to one, G_max on the vote; n == 1 is one-hot."""
    preds = tme.make_predictions(vote, n, g_max=0.99)
    ref = np.asarray(jme.make_predictions(jnp.asarray(vote), n, g_max=0.99))
    np.testing.assert_array_equal(preds.numpy(), ref)
    np.testing.assert_allclose(float(preds.sum()), 1.0, atol=1e-5)
    assert float(preds[vote]) == pytest.approx(0.99 if n > 1 else 1.0)


def test_pytree_path_equals_stacked(rng):
    models = [{"a": rng.normal(size=(4, 3)).astype(np.float32),
               "b": rng.normal(size=(5,)).astype(np.float32)}
              for _ in range(3)]
    sizes = [1.0, 2.0, 3.0]
    tmodels = [{k: torch.from_numpy(v) for k, v in m.items()} for m in models]
    res_tree = tme.model_evaluation_pytrees(tmodels, sizes)
    W = torch.stack([flatten_pytree(m) for m in tmodels])
    res_stack = tme.model_evaluation(W, torch.tensor(sizes))
    np.testing.assert_allclose(res_tree.similarities.numpy(),
                               res_stack.similarities.numpy(), rtol=1e-6)
    ref = jme.model_evaluation_pytrees(models, sizes)
    np.testing.assert_allclose(res_tree.similarities.numpy(),
                               np.asarray(ref.similarities), **FP32)
    np.testing.assert_allclose(res_tree.global_model.numpy(),
                               np.asarray(ref.global_model), **FP32)
    assert int(res_tree.vote) == int(ref.vote)


@pytest.mark.parametrize("n,d", [(6, 2000), (50, 101_770)])
def test_model_evaluation_matches_reference(n, d):
    """Full ME at a small size and at the paper's 50 × 101,770."""
    r = np.random.default_rng(n + d)
    base = r.normal(size=(d,)).astype(np.float32)
    # per-row noise scales spread the similarities, so the vote has a
    # margin far above the tolerance
    scale = np.linspace(0.3, 0.8, n)[:, None]
    W = (base + scale * r.normal(size=(n, d))).astype(np.float32)
    sizes = r.integers(50, 150, size=n).astype(np.float32)
    res = tme.model_evaluation(torch.from_numpy(W), torch.from_numpy(sizes))
    ref = jme.model_evaluation(jnp.asarray(W), jnp.asarray(sizes))
    np.testing.assert_allclose(res.global_model.numpy(),
                               np.asarray(ref.global_model), **FP32)
    np.testing.assert_allclose(res.similarities.numpy(),
                               np.asarray(ref.similarities), **FP32)
    top2 = np.sort(np.asarray(ref.similarities))[-2:]
    assert top2[1] - top2[0] > 10 * FP32["rtol"]   # the vote is decided
    assert int(res.vote) == int(ref.vote)
    np.testing.assert_array_equal(res.predictions.numpy(),
                                  np.asarray(ref.predictions))


def test_partial_decomposition_matches_full_and_reference():
    """The sharded-consensus decomposition: per-shard (dot, ‖w‖², ‖gw‖²)
    sums combine to the full-vector similarity."""
    for n, d, n_shards in [(2, 8, 1), (5, 64, 2), (8, 64, 4), (3, 17, 1)]:
        r = np.random.default_rng(n * 100 + d)
        W = r.normal(size=(n, d)).astype(np.float32)
        gw = r.normal(size=(d,)).astype(np.float32)
        full = tme.cosine_similarities(torch.from_numpy(W),
                                       torch.from_numpy(gw)).numpy()
        for m in range(n):
            terms = [tme.partial_terms(torch.from_numpy(a),
                                       torch.from_numpy(b))
                     for a, b in zip(np.split(W[m], n_shards),
                                     np.split(gw, n_shards))]
            summed = tme.PartialTerms(*(sum(t[i] for t in terms)
                                        for i in range(3)))
            s = float(tme.similarity_from_partials(summed))
            np.testing.assert_allclose(s, full[m], rtol=2e-5, atol=2e-6)
            jt = jme.partial_terms(jnp.asarray(W[m]), jnp.asarray(gw))
            np.testing.assert_allclose(
                s, float(jme.similarity_from_partials(jt)), rtol=2e-5,
                atol=2e-6)


def test_weighted_aggregation_favors_larger_dataset():
    W = torch.stack([torch.ones(8), -torch.ones(8)])
    gw = tme.aggregate_global(W, torch.tensor([90.0, 10.0]))
    assert bool(torch.all(gw > 0.5))
