"""The port's ME kernels (``repro_torch.kernels``) against the reference.

On the CPU: the port's plain versions against ``repro.kernels.ref`` (up
to the paper's 50 × 101,770 scale) and against the Pallas kernels in
interpret mode (small shapes: interpret mode is too slow for paper
scale), the wrappers' CPU dispatch and input checks, and the build
plumbing. The CUDA kernels themselves are held against their plain
versions on the card by tests/test_torch_kernels_cuda.py.

Tolerances: float32 sums taken in another order agree to rtol 2e-5 /
atol 2e-6 (the reference's own, tests/test_kernels.py:19-21); the fused
partials to rtol 1e-4 (tests/test_kernels.py:36-39); bfloat16 inputs are
cast identically by both frameworks and compared at rtol/atol 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.cosine_sim import cosine_partials as pallas_partials
from repro.kernels.ops import batched_cosine_similarity as j_batched_cos
from repro.kernels.weighted_agg import weighted_aggregate as pallas_agg
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as tref

FP32 = dict(rtol=2e-5, atol=2e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _inputs(n, d, seed, dtype="float32"):
    r = np.random.default_rng(seed)
    W = r.normal(size=(n, d)).astype(np.float32)
    gw = r.normal(size=(d,)).astype(np.float32)
    w = r.uniform(1, 100, size=(n,)).astype(np.float32)
    tW, tg = torch.from_numpy(W), torch.from_numpy(gw)
    jW, jg = jnp.asarray(W), jnp.asarray(gw)
    if dtype == "bfloat16":
        tW, tg = tW.to(torch.bfloat16), tg.to(torch.bfloat16)
        jW, jg = jW.astype(jnp.bfloat16), jg.astype(jnp.bfloat16)
    return (tW, tg, torch.from_numpy(w)), (jW, jg, jnp.asarray(w))


SHAPES = [(1, 64), (3, 100), (8, 512), (7, 33), (16, 1537)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", SHAPES)
def test_ref_matches_reference_oracles(n, d, dtype):
    (tW, tg, tw), (jW, jg, jw) = _inputs(n, d, n * 100 + d, dtype)
    tol = FP32 if dtype == "float32" else BF16
    for t, j in zip(tref.cosine_partials_ref(tW, tg),
                    jref.cosine_partials_ref(jW, jg)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(tref.cosine_similarity_ref(tW, tg).numpy(),
                               np.asarray(jref.cosine_similarity_ref(jW, jg)),
                               **tol)
    np.testing.assert_allclose(tref.weighted_aggregate_ref(tW, tw).numpy(),
                               np.asarray(jref.weighted_aggregate_ref(jW, jw)),
                               **tol)


def test_ref_matches_reference_at_paper_scale():
    """50 BCFL nodes × MLP(784-128-10) = 101,770 parameters."""
    (tW, tg, tw), (jW, jg, jw) = _inputs(50, 101_770, 7)
    np.testing.assert_allclose(tref.cosine_similarity_ref(tW, tg).numpy(),
                               np.asarray(jref.cosine_similarity_ref(jW, jg)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tref.weighted_aggregate_ref(tW, tw).numpy(),
                               np.asarray(jref.weighted_aggregate_ref(jW, jw)),
                               **FP32)


@pytest.mark.parametrize("n,d", [(3, 100), (8, 512), (9, 1100)])
def test_cpu_ops_match_pallas_interpret(n, d):
    (tW, tg, tw), (jW, jg, jw) = _inputs(n, d, n + d)
    for t, j in zip(ops.cosine_partials(tW, tg), pallas_partials(jW, jg)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(ops.weighted_aggregate(tW, tw).numpy(),
                               np.asarray(pallas_agg(jW, jw)), **FP32)
    np.testing.assert_allclose(ops.batched_cosine_similarity(tW, tg).numpy(),
                               np.asarray(j_batched_cos(jW, jg)), **FP32)


def test_cpu_dispatch_is_plain_version_and_launches_nothing():
    (tW, tg, tw), _ = _inputs(5, 300, 1)
    before = ops.launch_counts()
    for a, b in zip(ops.cosine_partials(tW, tg),
                    tref.cosine_partials_ref(tW, tg)):
        assert torch.equal(a, b)
    assert torch.equal(ops.weighted_aggregate(tW, tw),
                       tref.weighted_aggregate_ref(tW, tw))
    assert ops.launch_counts() == before


def test_self_similarity_is_one():
    (tW, _, _), _ = _inputs(4, 333, 2)
    s = ops.batched_cosine_similarity(tW, tW[1])
    assert float(s[1]) == pytest.approx(1.0, abs=1e-5)


def test_equal_weights_is_mean():
    (tW, _, _), _ = _inputs(6, 128, 3)
    np.testing.assert_allclose(ops.weighted_aggregate(tW, torch.ones(6)),
                               tW.mean(0), **FP32)


@pytest.mark.parametrize("bad", ["ndim", "mismatch", "empty", "dtype"])
def test_wrappers_check_inputs(bad):
    W, gw, w = torch.ones(3, 4), torch.ones(4), torch.ones(3)
    err = ValueError
    if bad == "ndim":
        W = torch.ones(12)
    elif bad == "mismatch":
        gw, w = torch.ones(5), torch.ones(2)
    elif bad == "empty":
        W, gw, w = torch.ones(0, 4), torch.ones(4), torch.ones(0)
    else:
        W, err = W.to(torch.float64), TypeError
    with pytest.raises(err):
        ops.cosine_partials(W, gw)
    with pytest.raises(err):
        ops.weighted_aggregate(W, w)


def test_splits_depend_on_d_only():
    from repro_torch.kernels.cosine_sim import splits_for
    assert splits_for(1) == 1
    assert splits_for(101_770) == 50
    assert splits_for(10 ** 9) == 1024


def test_build_plumbing(monkeypatch):
    h = _build.source_hash()
    assert len(h) == 16 and h == _build.source_hash()
    assert _build.build_dir().parts[-3:] == ("build", "repro_torch_kernels",
                                             h)
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
    monkeypatch.setattr(_build.shutil, "which", lambda *_: "/x/nvcc")
    monkeypatch.setattr(_build.os.path, "exists", lambda *_: True)
    cmd = _build.nvcc_command("weighted_agg", _build.build_dir() / "lib.so")
    assert cmd[0] == "/x/nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1].endswith("csrc/weighted_agg.cu")
    assert {"-shared", "-O3"} <= set(cmd)


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda *_: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda *_: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


@pytest.mark.parametrize("fails", [False, True])
def test_build_all_runs_one_compiler_per_source(tmp_path, monkeypatch, fails):
    """A stand-in compiler: build_all starts one process per source, keeps
    its output as the build log, and renames each library into place, or
    raises with the log when a compile fails."""
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)

    def fake_nvcc(name, out):
        script = f'echo "ptxas info {name}"; ' + (
            "exit 2" if fails and name == "weighted_agg" else f'touch "{out}"')
        return ["sh", "-c", script]

    monkeypatch.setattr(_build, "nvcc_command", fake_nvcc)
    if fails:
        with pytest.raises(RuntimeError, match="ptxas info weighted_agg"):
            _build.build_all()
        return
    seconds = _build.build_all()
    assert set(seconds) == set(_build.SOURCES)
    for name in _build.SOURCES:
        assert (_build.build_dir() / f"lib{name}.so").is_file()
        assert _build.build_log(name).strip() == f"ptxas info {name}"
    assert _build.build_all() == {}     # built once per source hash
