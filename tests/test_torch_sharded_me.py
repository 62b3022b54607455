"""The port's sharded Model Evaluation (``repro_torch.fl.sharded_consensus``)
against the reference's (``repro.fl.sharded_consensus``) on the same numpy
W, on the CPU: gw and the similarities within the reference's kernel
tolerances (tests/test_kernels.py: float32 rtol 2e-5 / atol 2e-6; two
float32 backends sum each shard's partials in their own order), the
votes equal; and against the port's dense ME, as the reference's
tests/test_phases.py holds its own pair (rtol 1e-5; for gw also atol
2e-7, a few float32 ulps at the entries' scale of ~0.5: on the CPU the
plain Eq. 1 of a shard sums its rows in another blocking than the whole
W's, which shows only in the relative error of entries near zero).
"""

import numpy as np
import pytest
import torch

from repro.fl.sharded_consensus import shard_flat as j_shard_flat
from repro.fl.sharded_consensus import \
    sharded_model_evaluation as j_sharded_me
from repro_torch.core.consensus import PoFELConsensus
from repro_torch.core.model_eval import model_evaluation
from repro_torch.fl.sharded_consensus import (ShardedModelEvaluation,
                                              shard_flat,
                                              sharded_model_evaluation)

TOL = dict(rtol=2e-5, atol=2e-6)
GW_ATOL = 2e-7


@pytest.mark.parametrize("N, D, n_shards", [(5, 103, 4), (8, 1000, 3),
                                            (3, 64, 1), (6, 7, 7)])
def test_matches_the_reference(rng, N, D, n_shards):
    W = rng.normal(size=(N, D)).astype(np.float32)
    sizes = rng.uniform(1.0, 50.0, size=N).astype(np.float32)
    j = j_sharded_me(j_shard_flat(W, n_shards), sizes)
    t = sharded_model_evaluation(shard_flat(torch.from_numpy(W), n_shards),
                                 torch.from_numpy(sizes))
    np.testing.assert_allclose(t.global_model.numpy(),
                               np.asarray(j.global_model), **TOL)
    np.testing.assert_allclose(t.similarities.numpy(),
                               np.asarray(j.similarities), **TOL)
    assert int(t.vote) == int(j.vote)
    np.testing.assert_allclose(t.predictions.numpy(),
                               np.asarray(j.predictions), **TOL)


def test_shards_split_as_numpy_does(rng):
    W = rng.normal(size=(3, 11)).astype(np.float32)
    for n in (1, 2, 3, 4, 11):
        got = shard_flat(torch.from_numpy(W), n)
        want = np.array_split(W, n, axis=1)
        assert [tuple(s.shape) for s in got] == [s.shape for s in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b)


def test_matches_dense_functionally(rng):
    W = torch.from_numpy(rng.normal(size=(5, 103)).astype(np.float32))
    sizes = torch.tensor([10.0, 20.0, 5.0, 8.0, 13.0])
    dense = model_evaluation(W, sizes)
    sh = sharded_model_evaluation(shard_flat(W, 4), sizes)
    np.testing.assert_allclose(dense.similarities.numpy(),
                               sh.similarities.numpy(), rtol=1e-5)
    np.testing.assert_allclose(dense.global_model.numpy(),
                               sh.global_model.numpy(), rtol=1e-5,
                               atol=GW_ATOL)
    assert int(dense.vote) == int(sh.vote)


def test_replace_phase_with_sharded_me_same_leader(rng):
    models = [{"w": torch.from_numpy(rng.normal(size=(97,)).astype(
        np.float32))} for _ in range(6)]
    sizes = [7.0, 3.0, 9.0, 4.0, 5.0, 6.0]
    dense = PoFELConsensus(6)
    sharded = PoFELConsensus(6)
    sharded.replace_phase("model_evaluation", ShardedModelEvaluation(4))
    r1 = dense.run_round(models, sizes)
    r2 = sharded.run_round(models, sizes)
    assert r1.leader_id == r2.leader_id
    np.testing.assert_allclose(np.asarray(r1.similarities),
                               np.asarray(r2.similarities), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(r1.global_model),
                               np.asarray(r2.global_model), rtol=1e-5,
                               atol=GW_ATOL)


def test_shard_count_is_validated_and_recorded():
    with pytest.raises(ValueError, match="n_shards"):
        ShardedModelEvaluation(0)
    from repro_torch.core.phases import RoundContext
    ctx = RoundContext(round=0, models=[torch.ones(3), torch.arange(3.0)],
                       data_sizes=[1.0, 2.0], n_nodes=2)
    ShardedModelEvaluation(8).run(ctx)
    assert ctx.extra["me_n_shards"] == 3       # at most one column a shard
    assert tuple(ctx.evaluation.global_model.shape) == (3,)
