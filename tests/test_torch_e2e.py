"""The slice end to end: BHFL rounds of the port against the reference.

Both runtimes get the same clusters (numpy, bit-identical), the
reference's initial MLP and dropout 0. Leaders and votes compare exactly,
after the test checks that the top-2 similarity margin is at least ten
times the similarity tolerance; similarities agree to atol 1e-5 (two
float32 backends, a few SGD steps: observed ~5e-7), test accuracy to
atol 1e-6. Where the weights are bit-identical, the block's model digests
and gw digest compare exactly. Block hashes never compare: HCDS nonces
are ``os.urandom``.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.consensus import PoFELConsensus as JConsensus
from repro.data.synthetic import make_mnist_like as j_mnist
from repro.fl.hfl_runtime import BHFLConfig as JConfig
from repro.fl.hfl_runtime import BHFLRuntime as JRuntime
from repro.fl.hierarchy import build_hierarchy as j_build
from repro.models.mlp import MLPConfig as JMLPConfig
from repro_torch import api
from repro_torch.core.consensus import PoFELConsensus as TConsensus
from repro_torch.data.synthetic import make_mnist_like as t_mnist
from repro_torch.fl.adapters import params_from_jax
from repro_torch.fl.hfl_runtime import BHFLConfig as TConfig
from repro_torch.fl.hfl_runtime import BHFLRuntime as TRuntime
from repro_torch.fl.hierarchy import build_hierarchy as t_build
from repro_torch.kernels import ops
from repro_torch.models.mlp import MLPConfig

REPO = Path(__file__).resolve().parents[1]
SIM_ATOL = 1e-5
HIDDEN = 32


def test_two_rounds_match_reference():
    seed = 0
    jtr, jte = j_mnist(240, 60, seed=seed)
    ttr, tte = t_mnist(240, 60, seed=seed)
    common = dict(n_nodes=4, clients_per_node=2, fel_iterations=1,
                  batch_size=16, lr=0.3, seed=seed)
    jrt = JRuntime(j_build(jtr, 4, 2, "label", seed=seed),
                   JConfig(mlp=JMLPConfig(hidden=HIDDEN, dropout=0.0),
                           **common), jte)
    trt = TRuntime(t_build(ttr, 4, 2, "label", seed=seed),
                   TConfig(mlp=MLPConfig(hidden=HIDDEN, dropout=0.0),
                           **common), tte, device="cpu")
    trt.global_params = params_from_jax(
        {k: np.asarray(v) for k, v in jrt.global_params.items()},
        MLPConfig(hidden=HIDDEN), device="cpu")
    for _ in range(2):
        mj, mt = jrt.run_round(), trt.run_round()
        sj = np.asarray(mj.consensus.similarities)
        st = mt.consensus.similarities
        np.testing.assert_allclose(st, sj, rtol=0, atol=SIM_ATOL)
        top2 = np.sort(sj)[-2:]
        assert top2[1] - top2[0] >= 10 * SIM_ATOL
        assert mt.leader_id == mj.leader_id
        np.testing.assert_array_equal(mt.consensus.votes,
                                      np.asarray(mj.consensus.votes))
        np.testing.assert_allclose(mt.test_accuracy, mj.test_accuracy,
                                   atol=1e-6)
        np.testing.assert_allclose(mt.test_loss, mj.test_loss, rtol=1e-4)
    for led in trt.consensus.ledgers:
        assert led.verify_chain() and led.height == 2


def test_consensus_digests_match_reference_on_identical_weights(rng):
    """Models whose Eq. 1 aggregate is exact in float32 (equal data sizes,
    small integers): gw is bit-identical in both packages, so are the
    block's model digests and gw digest, and the votes."""
    n = 4
    models = [{"w": rng.integers(-8, 8, size=(6, 5)).astype(np.float32),
               "b": rng.integers(-8, 8, size=(5,)).astype(np.float32)}
              for _ in range(n)]
    models[2]["w"] += 16.0     # a clear vote
    sizes = [25.0] * n
    jrec = JConsensus(n).run_round(
        [{k: jnp.asarray(v) for k, v in m.items()} for m in models], sizes)
    trec = TConsensus(n).run_round(
        [{k: torch.from_numpy(v) for k, v in m.items()} for m in models],
        sizes)
    np.testing.assert_array_equal(trec.global_model.numpy(),
                                  np.asarray(jrec.global_model))
    assert trec.block.model_digests == jrec.block.model_digests
    assert trec.block.global_model_digest == jrec.block.global_model_digest
    assert trec.leader_id == jrec.leader_id
    np.testing.assert_array_equal(trec.votes, np.asarray(jrec.votes))
    assert trec.block.votes == jrec.block.votes
    np.testing.assert_allclose(trec.similarities,
                               np.asarray(jrec.similarities), rtol=1e-6)


def test_port_imports_neither_jax_nor_reference():
    code = ("import sys; import repro_torch.api; "
            "bad = [m for m in sys.modules if m in ('jax', 'repro') or "
            "m.startswith(('jax.', 'repro.'))]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={**os.environ,
                              "PYTHONPATH": str(REPO / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_jax_or_reference_import_in_port_sources():
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)
    files = list((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 30
    assert [str(f) for f in files if pat.search(f.read_text())] == []


def test_run_bhfl_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.run_bhfl(n_nodes=2, clients_per_node=1, rounds=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.run_bhfl(n_nodes=2, clients_per_node=1, rounds=1,
                     device="cuda")


def test_run_bhfl_on_cpu():
    counts = ops.launch_counts()
    run = api.run_bhfl(model="mlp", n_nodes=3, clients_per_node=2,
                       fel_iterations=1, rounds=2, seed=1, device="cpu",
                       engine="auto", data=api.make_mnist_like(200, 40))
    # "auto" takes the batched engine: the MLP adapter has a train spec
    assert run.runtime.engine == "batched"
    assert run.chain_valid and run.chain_height == 2
    assert len(run.history) == 2
    assert all(np.isfinite(m.test_loss) for m in run.history)
    assert sum(run.leader_counts.values()) == 2
    assert run.runtime.global_params["w1"].shape == (784, 128)
    assert ops.launch_counts() == counts     # plain versions on the CPU


@pytest.mark.parametrize("kw,err", [
    (dict(scenario="byzantine_third", faults=object()), ValueError),
    (dict(scenario="no_such_scenario"), KeyError),
    (dict(faults=object(), committees=2), ValueError),
    (dict(model="transformer", distribution="label", data=None),
     ValueError),
    (dict(model=api.transformer_adapter(vocab_size=32, device="cpu"),
          data=api.make_token_dataset(16, 8, 64)), ValueError),
    (dict(model="cnn"), ValueError),
    (dict(engine="nope"), ValueError),
    (dict(shape_buckets=True), TypeError),
])
def test_run_bhfl_refuses_what_is_not_ported(kw, err):
    args = dict(n_nodes=2, clients_per_node=1, rounds=1, device="cpu",
                data=api.make_mnist_like(40, 10))
    args.update(kw)
    with pytest.raises(err):
        api.run_bhfl(**args)
