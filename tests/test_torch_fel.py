"""FEL of the port against the reference: data and partitions (bit for
bit), SGD, one client's ``local_train``, ``fedavg`` and a cluster's
``_run_fel``, all from one shared init with dropout 0; plus the port's
own dropout, which cannot match ``jax.random``.

Tolerances: float32 GEMMs on two CPU backends, compounded over a few SGD
steps at lr 0.05: rtol 1e-4 / atol 1e-5 on parameters.
"""

import jax
import numpy as np
import pytest
import torch

from repro.data import partition as jpart
from repro.data.synthetic import make_mnist_like as j_mnist
from repro.fl.client import Client as JClient
from repro.fl.client import local_train as j_local_train
from repro.fl.fedavg import fedavg as j_fedavg
from repro.fl.hfl_runtime import BHFLConfig as JConfig
from repro.fl.hfl_runtime import BHFLRuntime as JRuntime
from repro.fl.hierarchy import build_hierarchy as j_build
from repro.models.mlp import MLPConfig as JMLPConfig
from repro.models.mlp import mlp_init as j_mlp_init
from repro.optim.sgd import sgd_init as j_sgd_init
from repro.optim.sgd import sgd_update as j_sgd_update
from repro_torch.data import partition as tpart
from repro_torch.data.synthetic import make_mnist_like as t_mnist
from repro_torch.fl.adapters import params_from_jax
from repro_torch.fl.client import Client as TClient
from repro_torch.fl.client import local_train as t_local_train
from repro_torch.fl.fedavg import fedavg as t_fedavg
from repro_torch.fl.hfl_runtime import BHFLConfig as TConfig
from repro_torch.fl.hfl_runtime import BHFLRuntime as TRuntime
from repro_torch.fl.hierarchy import build_hierarchy as t_build
from repro_torch.models.mlp import MLPConfig, dropout_mask, mlp_apply
from repro_torch.models.mlp import step_generator
from repro_torch.optim.sgd import sgd_init, sgd_update

TOL = dict(rtol=1e-4, atol=1e-5)
HIDDEN = 24


def _init(seed=0):
    p = j_mlp_init(JMLPConfig(hidden=HIDDEN), jax.random.key(seed))
    ref = {k: np.asarray(v) for k, v in p.items()}
    return p, params_from_jax(ref, MLPConfig(hidden=HIDDEN), device="cpu")


def _assert_params_close(t, j):
    assert set(t) == set(j)
    for k in t:
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), **TOL)


def test_data_and_partitions_bit_identical():
    jtr, jte = j_mnist(300, 50, seed=4)
    ttr, tte = t_mnist(300, 50, seed=4)
    for a, b in ((jtr, ttr), (jte, tte)):
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)
    for jf, tf, kw in ((jpart.partition_iid, tpart.partition_iid, {}),
                       (jpart.partition_label_limited,
                        tpart.partition_label_limited,
                        {"labels_per_part": 3}),
                       (jpart.partition_dirichlet, tpart.partition_dirichlet,
                        {"alpha": 0.5})):
        for a, b in zip(jf(jtr, 6, seed=2, **kw), tf(ttr, 6, seed=2, **kw)):
            np.testing.assert_array_equal(a.x, b.x)
            np.testing.assert_array_equal(a.y, b.y)


def test_sgd_update_matches_reference(rng):
    jp, tp = _init()
    for step in range(3):
        grads = {k: rng.normal(size=v.shape).astype(np.float32)
                 for k, v in tp.items()}
        if step == 0:
            jstate, tstate = j_sgd_init(jp), sgd_init(tp)
        jp, jstate = j_sgd_update({k: jax.numpy.asarray(v)
                                   for k, v in grads.items()},
                                  jstate, jp, lr=0.05, momentum=0.9,
                                  decay=0.1)
        sgd_update({k: torch.from_numpy(v) for k, v in grads.items()},
                   tstate, tp, lr=0.05, momentum=0.9, decay=0.1)
    assert tstate.step == int(jstate.step) == 3
    for k in tp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)


def test_local_train_matches_reference():
    jp, tp = _init()
    jtr, _ = j_mnist(80, 10, seed=1)
    ttr, _ = t_mnist(80, 10, seed=1)
    kw = dict(epochs=2, batch_size=16, lr=0.05, momentum=0.9, decay=5e-4,
              seed=7)
    jnew, jloss = j_local_train(jp, JClient(0, jtr),
                                JMLPConfig(hidden=HIDDEN, dropout=0.0), **kw)
    tnew, tloss = t_local_train(tp, TClient(0, ttr),
                                MLPConfig(hidden=HIDDEN, dropout=0.0), **kw)
    _assert_params_close(tnew, jnew)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    # the input params are left untouched
    assert all(torch.equal(tp[k], v) for k, v in
               params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                               MLPConfig(hidden=HIDDEN),
                               device="cpu").items())


def test_fedavg_matches_reference(rng):
    models = [{k: rng.normal(size=s).astype(np.float32)
               for k, s in (("a", (3, 4)), ("b", (5,)))} for _ in range(3)]
    sizes = [10.0, 30.0, 60.0]
    t = t_fedavg([{k: torch.from_numpy(v) for k, v in m.items()}
                  for m in models], sizes)
    j = j_fedavg([{k: jax.numpy.asarray(v) for k, v in m.items()}
                  for m in models], sizes)
    for k in t:
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                   rtol=2e-5, atol=2e-6)


def test_run_fel_matches_reference():
    jp, tp = _init(3)
    jtr, _ = j_mnist(160, 20, seed=2)
    ttr, _ = t_mnist(160, 20, seed=2)
    common = dict(n_nodes=2, clients_per_node=2, fel_iterations=2,
                  batch_size=16, lr=0.05, seed=5)
    jrt = JRuntime(j_build(jtr, 2, 2, seed=5),
                   JConfig(mlp=JMLPConfig(hidden=HIDDEN, dropout=0.0),
                           **common))
    trt = TRuntime(t_build(ttr, 2, 2, seed=5),
                   TConfig(mlp=MLPConfig(hidden=HIDDEN, dropout=0.0),
                           **common), device="cpu")
    for c_j, c_t in zip(jrt.clusters, trt.clusters):
        out_j = jrt._run_fel(c_j, jp, round_seed=1)
        out_t = trt._run_fel(c_t, tp, round_seed=1)
        _assert_params_close(out_t, out_j)


# ---------------------------------------------------------------------------
# The port's own dropout
# ---------------------------------------------------------------------------

def test_dropout_keep_rate_and_determinism():
    keep = 0.8
    mask = dropout_mask(step_generator(3, 0, "cpu"), keep, (256, 128), "cpu")
    # 32,768 Bernoulli(0.8) draws: std of the mean is ~0.0022
    assert abs(float(mask.float().mean()) - keep) < 0.01
    again = dropout_mask(step_generator(3, 0, "cpu"), keep, (256, 128), "cpu")
    assert torch.equal(mask, again)
    other = dropout_mask(step_generator(3, 1, "cpu"), keep, (256, 128), "cpu")
    assert not torch.equal(mask, other)
    assert not torch.equal(
        mask, dropout_mask(step_generator(4, 0, "cpu"), keep, (256, 128),
                           "cpu"))


def test_dropout_scales_kept_units():
    cfg = MLPConfig(in_dim=6, hidden=64, n_classes=3, dropout=0.25)
    params = {"w1": torch.eye(6, 64), "b1": torch.ones(64),
              "w2": torch.eye(64, 3), "b2": torch.zeros(3)}
    x = torch.zeros(64, 6)
    gen = step_generator(0, 0, "cpu")
    # with w2 = identity on the first 3 units, the logits are the hidden
    # units themselves: 1/keep where kept, 0 where dropped
    logits = mlp_apply(params, x, cfg=cfg, train=True, generator=gen)
    kept = logits[logits != 0]
    assert 0 < kept.numel() < logits.numel()
    torch.testing.assert_close(kept, torch.full_like(kept, 1 / 0.75))
    assert torch.equal(mlp_apply(params, x, cfg=cfg), torch.ones(64, 3))
    with pytest.raises(ValueError, match="generator"):
        mlp_apply(params, x, cfg=cfg, train=True)
