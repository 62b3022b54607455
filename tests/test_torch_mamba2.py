"""The port's Mamba2 block and Zamba2 hybrid (``repro_torch.models.mamba2``,
the hybrid half of ``repro_torch.models.ssm_models``, its serving branch)
against the reference, on the CPU at small sizes: a Mamba2 block of
d_model 64 (d_state 16, heads of 32) and the reduced Zamba2-7B (2 layers =
one group of a Mamba2 block and the shared block, d_model 256, 4 heads of
32, Mamba2 d_state 16 and heads of 32, vocab 512).

Both packages get the same numpy inputs and the same weights: the
reference's init, carried over bit for bit by ``hybrid_params_from_jax``.
On the CPU the shared block's attention is the flash kernel's plain
version; the reference runs its jnp ``blockwise_attention``.

Tolerances (tests/test_kernels.py:19-21): float32 rtol 2e-5 / atol 2e-6,
bfloat16 rtol/atol 2e-2; the bfloat16 model's logits within 0.125
absolute and 0.02 on average, the rule of tests/test_torch_transformer.py
(a bf16 ulp is 0.0156 at magnitudes in [2, 4), and XLA's CPU fuses where
torch rounds each operation). The flash plain version at hd 112: float32
rtol/atol 2e-5 (the reference's flash tolerance, tests/test_kernels.py:
141-179).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import serialization as jser
from repro.kernels import flash_attention as j_flash
from repro.models import mamba2 as jm2
from repro.models.model_api import Model as JModel
from repro.serving import GenerationRequest as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.core import serialization as tser
from repro_torch.kernels import ops
from repro_torch.models import mamba2 as tm2
from repro_torch.models.model_api import Model
from repro_torch.models.ssm_models import (HybridCache, hybrid_group_shape,
                                           hybrid_init_params,
                                           hybrid_params_from_jax)
from repro_torch.serving import GenerationRequest, ServingEngine

FP32 = dict(rtol=2e-5, atol=2e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)
FLASH_FP32 = dict(rtol=2e-5, atol=2e-5)
LOGIT_ATOL, LOGIT_MEAN = 0.125, 0.02
MARGIN = 2 * LOGIT_ATOL
MCFG = dict(d_model=64, d_state=16, head_dim=32)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_model_close(t, j):
    t, j = _f32(t), _f32(j)
    assert t.shape == j.shape
    diff = np.abs(t - j)
    assert diff.max() <= LOGIT_ATOL, diff.max()
    assert diff.mean() <= LOGIT_MEAN, diff.mean()


def _tensor(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _block():
    """(reference config, port config, numpy params) of one block, the
    reference's init with random biases, dt bias and D so that every
    parameter adds something."""
    jcfg = jm2.Mamba2Config(**MCFG)
    p = jax.tree.map(np.array, jm2.mamba2_init(jcfg, jax.random.key(0)))
    r = np.random.default_rng(5)
    for name in ("conv_b", "dt_bias", "D", "norm"):
        p[name] = (p[name] + 0.3 * r.normal(size=p[name].shape)
                   ).astype(np.float32)
    return jcfg, tm2.Mamba2Config(**MCFG), p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_prefix", [False, True])
def test_causal_conv_matches_reference(dtype, with_prefix):
    r = np.random.default_rng(int(with_prefix))
    u = r.normal(size=(2, 20, 24)).astype(np.float32)
    w = (0.3 * r.normal(size=(4, 24))).astype(np.float32)
    b = r.normal(size=(24,)).astype(np.float32)
    prefix = r.normal(size=(2, 3, 24)).astype(np.float32) if with_prefix \
        else None
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    t_out, t_state = tm2._causal_conv(
        _tensor(u, tdt), torch.from_numpy(w), torch.from_numpy(b),
        None if prefix is None else torch.from_numpy(prefix))
    j_out, j_state = jm2._causal_conv(
        jnp.asarray(u, jdt), jnp.asarray(w), jnp.asarray(b),
        None if prefix is None else jnp.asarray(prefix))
    tol = FP32 if dtype == "float32" else BF16
    assert t_out.dtype == tdt and t_state.dtype == tdt
    np.testing.assert_allclose(_f32(t_out), _f32(j_out), **tol)
    np.testing.assert_allclose(_f32(t_state), _f32(j_state), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_apply_matches_reference(dtype, with_state):
    """(2, 20, 64) through one block, from zero or a random state: the
    output, the final SSM state and the conv state."""
    jcfg, tcfg, p = _block()
    r = np.random.default_rng(7 + int(with_state))
    x = r.normal(size=(2, 20, 64)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    jstate = tstate = None
    if with_state:
        ssm = (0.5 * r.normal(size=(2, tcfg.n_heads, 32, 16))).astype(
            np.float32)
        conv = r.normal(size=(2, 3, tcfg.d_inner + 32)).astype(np.float32)
        jstate = jm2.Mamba2State(jnp.asarray(ssm), jnp.asarray(conv))
        tstate = tm2.Mamba2State(torch.from_numpy(ssm),
                                 torch.from_numpy(conv))
    jo, js = jm2.mamba2_apply(jax.tree.map(jnp.asarray, p),
                              jnp.asarray(x, jdt), jcfg, jstate)
    to, ts = tm2.mamba2_apply({k: torch.from_numpy(v) for k, v in p.items()},
                              _tensor(x, tdt), tcfg, tstate)
    assert to.dtype == tdt and ts.ssm.dtype == torch.float32
    assert ts.conv.dtype == tdt        # in x's dtype, as the reference's
    if dtype == "float32":
        np.testing.assert_allclose(_f32(to), _f32(jo), **FP32)
        np.testing.assert_allclose(_f32(ts.ssm), _f32(js.ssm), **FP32)
    else:
        _assert_model_close(to, jo)
        _assert_model_close(ts.ssm, js.ssm)
    np.testing.assert_allclose(_f32(ts.conv), _f32(js.conv), **BF16)


def test_mamba2_split_sequence_equals_one_call():
    """S = 20 in calls of 13 and 7, the state carried, against one call
    of the reference: the recurrence and the conv's trailing inputs carry
    over (the inputs are in_proj's products, summed in another order)."""
    jcfg, tcfg, p = _block()
    x = np.random.default_rng(9).normal(size=(2, 20, 64)).astype(np.float32)
    jo, js = jm2.mamba2_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              jcfg)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xt = torch.from_numpy(x)
    o1, s1 = tm2.mamba2_apply(tp, xt[:, :13], tcfg)
    o2, s2 = tm2.mamba2_apply(tp, xt[:, 13:], tcfg, s1)
    np.testing.assert_allclose(_f32(torch.cat([o1, o2], 1)), _f32(jo), **FP32)
    np.testing.assert_allclose(_f32(s2.ssm), _f32(js.ssm), **FP32)
    np.testing.assert_allclose(_f32(s2.conv), _f32(js.conv), **FP32)


def test_mamba2_init_layout_and_state():
    jcfg, tcfg, _ = _block()
    jp = jax.eval_shape(lambda: jm2.mamba2_init(jcfg, jax.random.key(0)))
    tp = tm2.mamba2_init(tcfg, torch.Generator().manual_seed(0))
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in tp.items()} == \
        {k: (v.shape, "torch.float32") for k, v in jp.items()}
    np.testing.assert_allclose(
        tp["A_log"].numpy(),
        np.asarray(jm2.mamba2_init(jcfg, jax.random.key(0))["A_log"]),
        rtol=1e-6)
    js = jm2.mamba2_init_state(jcfg, 3)
    ts = tm2.mamba2_init_state(tcfg, 3, "cpu")
    for t, j in zip(ts, js):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
        assert not t.any()


# ---------------------------------------------------------------------------
# the flash plain version at Zamba2-7B's head dim
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_version_at_hd_112(dtype):
    """32 heads of 112 in Zamba2-7B; here 4 heads, causal, over a ragged
    length, against the reference's Pallas kernel in interpret mode."""
    r = np.random.default_rng(112)
    q, k, v = (r.normal(size=(2, 70, 4, 112)).astype(np.float32)
               for _ in range(3))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    before = ops.launch_counts()
    out = ops.flash_attention(*(_tensor(a, tdt) for a in (q, k, v)),
                              causal=True)
    assert ops.launch_counts() == before
    ref = j_flash(*(jnp.asarray(a, jdt) for a in (q, k, v)), causal=True)
    np.testing.assert_allclose(_f32(out), _f32(ref),
                               **(FLASH_FP32 if dtype == "float32" else BF16))


# ---------------------------------------------------------------------------
# the reduced Zamba2-7B
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reduced():
    """(reference model, reference params, port model, port params)."""
    jcfg = j_get_config("zamba2-7b").reduced()
    jm = JModel(jcfg)
    npp = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(0)))
    cfg = get_config("zamba2-7b").reduced()
    m = Model(cfg, device="cpu")
    return (jm, jax.tree.map(jnp.asarray, npp), m,
            hybrid_params_from_jax(npp, cfg, device="cpu"))


@functools.lru_cache(maxsize=None)
def _jit(jm):
    return (jax.jit(lambda p, t: jm.forward(p, {"tokens": t})),
            jax.jit(jm.decode_step))


def test_hybrid_group_shape_of_zamba2():
    """Zamba2-7B: 13 groups of 5 Mamba2 blocks and the shared block, then
    3 Mamba2 blocks; the reduced config one group of one."""
    from repro.models.ssm_models import hybrid_group_shape as j_shape
    assert hybrid_group_shape(get_config("zamba2-7b")) == (13, 5, 3) == \
        j_shape(j_get_config("zamba2-7b"))
    assert hybrid_group_shape(get_config("zamba2-7b").reduced()) == \
        (1, 1, 0) == j_shape(j_get_config("zamba2-7b").reduced())


def test_hybrid_forward_and_loss_match_reference():
    jm, jp, m, tp = _reduced()
    toks = np.random.default_rng(1).integers(0, 512, (3, 24)).astype(np.int32)
    jl, jaux = _jit(jm)[0](jp, jnp.asarray(toks))
    before = ops.launch_counts()
    tl, taux = m.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert ops.launch_counts() == before            # the CPU runs no kernel
    assert tl.dtype == torch.bfloat16 and float(taux) == float(jaux) == 0.0
    _assert_model_close(tl, jl)
    labels = np.random.default_rng(2).integers(0, 512, (3, 24))
    loss = m.loss(tp, {"tokens": torch.from_numpy(toks),
                       "labels": torch.from_numpy(labels)})
    jloss = jax.jit(jm.loss)(jp, {"tokens": jnp.asarray(toks),
                                  "labels": jnp.asarray(labels)})
    assert abs(float(loss) - float(jloss)) <= 1e-2


def test_hybrid_prefill_matches_reference():
    """The hybrid prefill: the last position's logits and a fresh cache of
    the prompt's length, as the reference's."""
    jm, jp, m, tp = _reduced()
    toks = np.random.default_rng(3).integers(0, 512, (2, 13)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}))(
        jp, jnp.asarray(toks))
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (2, 1, 512)
    _assert_model_close(tl, jl)
    assert isinstance(tc, HybridCache)
    for t, j in zip(jax.tree.leaves(tc), jax.tree.leaves(jc)):
        assert tuple(t.shape) == j.shape and not t.any()


def test_hybrid_decode_chain_matches_reference():
    """Decode steps from an empty cache: logits at every step, then every
    cache leaf (the conv states in bfloat16 after a step, as the
    reference's); the last step against the last position of a forward."""
    jm, jp, m, tp = _reduced()
    B, S = 3, 12
    toks = np.random.default_rng(4).integers(0, 512, (B, S)).astype(np.int32)
    jc, tc = jm.init_cache(B, S), m.init_cache(B, S)
    jdec = _jit(jm)[1]
    for i in range(S):
        jl, jc = jdec(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                      jnp.asarray(i, jnp.int32))
        tl, tc = m.decode_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]), i)
        _assert_model_close(tl, jl)
    assert isinstance(tc, HybridCache) and tc.mamba_tail is None
    assert tc.mamba_groups.conv.dtype == torch.bfloat16
    assert tc.mamba_groups.ssm.dtype == torch.float32
    for t, j in zip(jax.tree.leaves(tc), jax.tree.leaves(jc)):
        assert tuple(t.shape) == j.shape
        assert t.dtype == (torch.bfloat16 if j.dtype == jnp.bfloat16
                           else torch.float32)
        _assert_model_close(t, j)
    tf, _ = m.forward(tp, {"tokens": torch.from_numpy(toks)})
    _assert_model_close(tl[:, 0], tf[:, -1])


def test_generate_greedy_matches_reference():
    """The engine replays the prompts through decode steps (no prefill,
    no cache growth) and decodes greedily: the same tokens as the
    reference's engine wherever its top-2 margin is clear of the bf16
    rule, teacher-forced logits within it at every step."""
    jm, jp, m, tp = _reduced()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (5, 9, 14)]
    budgets = [6, 4, 6]
    ref = JEngine(jm, jp).generate(
        [JRequest(i, p, n) for i, (p, n) in enumerate(zip(prompts, budgets))])
    before = ops.launch_counts()
    port = ServingEngine(m, tp, device="cpu").generate(
        [GenerationRequest(i, p, n) for i, (p, n) in
         enumerate(zip(prompts, budgets))])
    assert ops.launch_counts() == before
    assert [len(c.tokens) for c in port] == budgets
    # teacher-forced along the reference's tokens
    P = max(len(p) for p in prompts)
    n = max(budgets)
    padded = np.zeros((3, P), np.int32)
    for i, p in enumerate(prompts):
        padded[i, P - len(p):] = p
    forced = np.zeros((3, n), np.int32)
    for i, c in enumerate(ref):
        forced[i, :len(c.tokens)] = c.tokens
    feed = np.concatenate([padded, forced], 1)
    jdec = _jit(jm)[1]
    jc, tc = jm.init_cache(3, P + n), m.init_cache(3, P + n)
    clear = [True] * 3
    for i in range(P + n - 1):
        jl, jc = jdec(jp, jc, jnp.asarray(feed[:, i:i + 1]),
                      jnp.asarray(i, jnp.int32))
        tl, tc = m.decode_step(tp, tc, torch.from_numpy(feed[:, i:i + 1]), i)
        _assert_model_close(tl, jl)
        step = i - (P - 1)
        if step < 0:
            continue
        j = _f32(jl[:, -1])
        top2 = np.sort(j, axis=-1)[:, -2:]
        for r, c in enumerate(ref):
            if step >= len(c.tokens):
                continue
            assert int(np.argmax(j[r])) == c.tokens[step]
            clear[r] &= bool(top2[r, 1] - top2[r, 0] > MARGIN)
            if clear[r]:
                assert port[r].tokens[step] == c.tokens[step]


def test_hybrid_params_from_jax_bytes_identical():
    _, jp, m, tp = _reduced()
    assert tser.serialize_pytree(tp) == \
        jser.serialize_pytree(jax.tree.map(np.asarray, jp))
    assert tp["mamba_groups"]["in_proj"].dtype == torch.float32
    assert tp["mamba_groups"]["in_proj"].shape == (1, 1, 256, 1072)
    assert tp["shared_attn"]["wq"].dtype == torch.bfloat16
    p = jax.tree.map(np.asarray, jp)
    p["mamba_groups"]["conv_w"] = p["mamba_groups"]["conv_w"][:, :, :2]
    with pytest.raises(ValueError):
        hybrid_params_from_jax(p, m.cfg, device="cpu")
    p = jax.tree.map(np.asarray, jp)
    p["mamba_tail"] = p["mamba_groups"]
    with pytest.raises(ValueError):
        hybrid_params_from_jax(p, m.cfg, device="cpu")


@pytest.mark.parametrize("cut", [None, dict(n_layers=5)],
                         ids=["reduced", "with_a_tail"])
def test_hybrid_init_has_reference_layout(cut):
    """The port's init: the reference's names, shapes and dtypes (a tail
    of Mamba2 blocks where n_layers leaves one), repeatable from a seed;
    the parameter counts equal the reference's."""
    jcfg = j_get_config("zamba2-7b").reduced(**(cut or {}))
    cfg = get_config("zamba2-7b").reduced(**(cut or {}))
    jp = jax.eval_shape(lambda: JModel(jcfg).init(jax.random.key(0)))
    tp = hybrid_init_params(cfg, torch.Generator().manual_seed(0))
    jleaves = {jax.tree_util.keystr(k): (v.shape, np.dtype(v.dtype).str)
               for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tleaves = {k: (tuple(v.shape), "<V2" if v.dtype == torch.bfloat16
                   else v.numpy().dtype.str)
               for k, v in tser._sorted_leaves(tp)}
    assert tleaves == jleaves
    assert ("mamba_tail" in tp) == (cut is not None)
    again = hybrid_init_params(cfg, torch.Generator().manual_seed(0))
    assert tser.serialize_pytree(again) == tser.serialize_pytree(tp)
    m = Model(cfg, device="cpu")
    assert m.n_params() == JModel(jcfg).n_params()
    assert m.n_active_params() == m.n_params()


def test_zamba2_full_size_counts():
    """Zamba2-7B at full size, from its config alone: 68 Mamba2 blocks of
    78.0 M float32 parameters, and the reference's parameter count."""
    from repro_torch.models.mamba2 import mamba2_param_shapes
    from repro_torch.models.ssm_models import mamba_cfg_of
    cfg = get_config("zamba2-7b")
    n_groups, mpg, n_tail = hybrid_group_shape(cfg)
    assert n_groups * mpg + n_tail == 68
    block = sum(int(np.prod(s)) for s in
                mamba2_param_shapes(mamba_cfg_of(cfg)).values())
    assert round(block / 1e6, 1) == 78.0
    assert Model(cfg, device="cpu").n_params() == \
        JModel(j_get_config("zamba2-7b")).n_params()
