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


# --- WKV6 recurrence -------------------------------------------------------
# Tolerance atol 1e-5, the reference's own (tests/test_kernels_wkv6.py):
# float32 sums over K taken in another order.

from repro.kernels.ops import wkv6_recurrence as j_wkv6_recurrence
from repro.kernels.wkv6 import wkv6 as pallas_wkv6


def _wkv6_flat(seed, BH, S, K):
    """(BH, S, K) inputs as the reference's tests draw them."""
    r = np.random.default_rng(seed)
    arrs = (r.normal(size=(BH, S, K)), r.normal(size=(BH, S, K)),
            r.normal(size=(BH, S, K)), r.uniform(0.2, 0.99, size=(BH, S, K)),
            r.normal(size=(BH, K)), 0.1 * r.normal(size=(BH, K, K)))
    return [a.astype(np.float32) for a in arrs]


def _wkv6_bshk(seed, B, S, H, K, zero_state=False):
    """(B, S, H, K) inputs, u (H, K), s0 (B, H, K, K)."""
    r = np.random.default_rng(seed)
    arrs = (r.normal(size=(B, S, H, K)), r.normal(size=(B, S, H, K)),
            r.normal(size=(B, S, H, K)),
            r.uniform(0.2, 0.99, size=(B, S, H, K)), r.normal(size=(H, K)),
            np.zeros((B, H, K, K)) if zero_state
            else 0.1 * r.normal(size=(B, H, K, K)))
    return [a.astype(np.float32) for a in arrs]


@pytest.mark.parametrize("shape", [(1, 16, 8), (4, 64, 16), (2, 96, 32),
                                   (3, 5, 64)])
def test_wkv6_ref_matches_reference_and_pallas(shape):
    BH, S, K = shape
    arrs = _wkv6_flat(BH * S + K, BH, S, K)
    o, sf = tref.wkv6_ref(*map(torch.from_numpy, arrs))
    jarrs = list(map(jnp.asarray, arrs))
    for jo, jsf in (jref.wkv6_ref(*jarrs),
                    pallas_wkv6(*jarrs, chunk=min(16, S) if S % 16 else 16)):
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-5)
        np.testing.assert_allclose(sf.numpy(), np.asarray(jsf), atol=1e-5)


@pytest.mark.parametrize("s,k", [(1, 8), (2, 16), (17, 8), (32, 16),
                                 (33, 8), (70, 16)])
def test_wkv6_ops_cpu_matches_reference_wrapper(s, k):
    """The port's (B, S, H, K) op on the CPU against the reference's padded
    Pallas wrapper (interpret mode), S from 1 to 70 as the reference's
    property test draws it: one chunk or less, a chunk boundary, and
    lengths that pad, each head size on every other length."""
    B, H = 2, 3
    arrs = _wkv6_bshk(s * 10 + k, B, s, H, k, zero_state=(s % 2 == 0))
    o, sf = ops.wkv6_recurrence(*map(torch.from_numpy, arrs))
    jo, jsf = j_wkv6_recurrence(*map(jnp.asarray, arrs), chunk=32)
    assert o.shape == (B, s, H, k) and sf.shape == (B, H, k, k)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(sf.numpy(), np.asarray(jsf), atol=1e-5)


def test_wkv6_state_threading():
    """Two calls threading the state ≡ one call over the whole sequence."""
    r, k, v, w, u, s0 = map(torch.from_numpy, _wkv6_bshk(5, 2, 64, 3, 8))
    o_full, s_full = ops.wkv6_recurrence(r, k, v, w, u, s0)
    o1, s_mid = ops.wkv6_recurrence(r[:, :32], k[:, :32], v[:, :32],
                                    w[:, :32], u, s0)
    o2, s_end = ops.wkv6_recurrence(r[:, 32:], k[:, 32:], v[:, 32:],
                                    w[:, 32:], u, s_mid)
    torch.testing.assert_close(torch.cat([o1, o2], dim=1), o_full,
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(s_end, s_full, rtol=0, atol=1e-5)


def test_wkv6_cpu_dispatch_is_plain_version_and_launches_nothing():
    B, S, H, K = 2, 7, 3, 16
    r, k, v, w, u, s0 = map(torch.from_numpy, _wkv6_bshk(1, B, S, H, K))
    before = ops.launch_counts()
    o, sf = ops.wkv6_recurrence(r, k, v, w, u, s0)
    flat = lambda t: t.transpose(1, 2).reshape(B * H, S, K)
    ro, rsf = tref.wkv6_ref(flat(r), flat(k), flat(v), flat(w),
                            u.repeat(B, 1), s0.reshape(B * H, K, K))
    assert torch.equal(flat(o), ro)
    assert torch.equal(sf.reshape(B * H, K, K), rsf)
    assert ops.launch_counts() == before
    assert before.keys() == {"cosine_partials", "weighted_aggregate", "wkv6",
                             "flash_attention", "wkv6_backward",
                             "flash_attention_backward", "moe_grouped",
                             "moe_grouped_rows"}


@pytest.mark.parametrize("bad", ["dtype", "head_size", "shape", "state",
                                 "empty", "ndim", "device"])
def test_wkv6_checks_inputs(bad):
    r, k, v, w, u, s0 = map(torch.from_numpy, _wkv6_bshk(2, 1, 4, 2, 8))
    err = ValueError
    if bad == "dtype":
        w, err = w.to(torch.bfloat16), TypeError
    elif bad == "head_size":
        r, k, v, w = (torch.ones(1, 4, 2, 12) for _ in range(4))
        u, s0 = torch.ones(2, 12), torch.ones(1, 2, 12, 12)
    elif bad == "shape":
        v = v[:, :3]
    elif bad == "state":
        s0 = s0[:, :1]
    elif bad == "empty":
        r, k, v, w = (t[:, :0] for t in (r, k, v, w))
    elif bad == "ndim":
        r = r[0]
    else:
        meta = [t.to("meta") for t in (r, k, v, w, u, s0)]
        with pytest.raises(ValueError, match="no wkv6 kernel"):
            ops.wkv6_recurrence(*meta)  # on a device without a kernel
        u = meta[4]                     # mixed devices
    with pytest.raises(err):
        ops.wkv6_recurrence(r, k, v, w, u, s0)
