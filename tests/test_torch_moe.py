"""The port's MoE FFN (``repro_torch.models.moe``) and the MoE family of
``repro_torch.models.transformer`` against the reference, on the CPU:
the FFN at (T, D) = (64, 16) with 8 experts, and the reduced
DeepSeek-MoE-16B (4 routed experts top-2 and one shared expert of 128)
and Phi-3.5-MoE (4 experts top-2, no shared expert), 2 layers of d_model
256, vocab 512.

Both packages get the same numpy inputs and the same weights (the
reference's init, carried over by ``transformer_params_from_jax``).

Tolerances (tests/test_kernels.py:19-21): float32 rtol 2e-5 / atol 2e-6,
bfloat16 rtol/atol 2e-2; routing indices, positions in expert and the
kept/dropped pattern exactly. The bfloat16 models' logits within 0.125
absolute and 0.02 on average, the rule of tests/test_torch_transformer.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import serialization as jser
from repro.models import moe as jmoe
from repro.models.model_api import Model as JModel
from repro_torch.configs import get_config
from repro_torch.core import serialization as tser
from repro_torch.kernels import ops
from repro_torch.models import moe as tmoe
from repro_torch.models.model_api import Model
from repro_torch.models.transformer import (DecodeCache, init_params,
                                            transformer_params_from_jax)

FP32 = dict(rtol=2e-5, atol=2e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)
LOGIT_ATOL, LOGIT_MEAN = 0.125, 0.02
MOE = ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b"]


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


def _ffn_params(seed, E=8, D=16, F=32, shared=False):
    """numpy float32 FFN weights, as tests/test_layers_moe.py draws them."""
    r = np.random.default_rng(seed)
    p = {"router": r.normal(size=(D, E)),
         "w_gate": 0.1 * r.normal(size=(E, D, F)),
         "w_up": 0.1 * r.normal(size=(E, D, F)),
         "w_down": 0.1 * r.normal(size=(E, F, D))}
    if shared:
        p["shared"] = {"w_gate": 0.1 * r.normal(size=(D, 2 * F)),
                       "w_up": 0.1 * r.normal(size=(D, 2 * F)),
                       "w_down": 0.1 * r.normal(size=(2 * F, D))}
    return jax.tree.map(lambda a: a.astype(np.float32), p)


def _as(tree, to, dtype):
    """A numpy tree as torch or jnp arrays: the router stays float32, the
    expert weights take ``dtype``."""
    def leaf(path, a):
        dt = "float32" if "router" in jax.tree_util.keystr(path) else dtype
        if to == "torch":
            return torch.from_numpy(np.array(a)).to(getattr(torch, dt))
        return jnp.asarray(a, getattr(jnp, dt))
    return jax.tree_util.tree_map_with_path(leaf, tree)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,k", [(8, 2), (64, 6), (16, 2)])
def test_router_topk_matches_reference(E, k):
    r = np.random.default_rng(E + k)
    x = r.normal(size=(48, 32)).astype(np.float32)
    w = r.normal(size=(32, E)).astype(np.float32)
    cfg_t, cfg_j = tmoe.MoEConfig(E, k), jmoe.MoEConfig(E, k)
    tg, ti, tp = tmoe.router_topk(torch.from_numpy(x), torch.from_numpy(w),
                                  cfg_t)
    jg, ji, jp = jmoe.router_topk(jnp.asarray(x), jnp.asarray(w), cfg_j)
    assert ti.dtype == torch.int32 and tg.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **FP32)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **FP32)


def test_position_in_expert_reference_case():
    """tests/test_layers_moe.py's case: expert 0 takes tokens 0, 2, 3 in
    that order, expert 1 tokens 1 and 4."""
    idx = [[0], [1], [0], [0], [1]]
    pos = tmoe.position_in_expert(torch.tensor(idx, dtype=torch.int32), 2)
    assert pos.dtype == torch.int32
    assert pos[:, 0].tolist() == [0, 0, 1, 2, 1]
    np.testing.assert_array_equal(
        pos.numpy(), np.asarray(jmoe.position_in_expert(jnp.asarray(idx), 2)))


@pytest.mark.parametrize("T,k,E", [(64, 2, 8), (37, 6, 64), (5, 1, 3)])
def test_position_in_expert_matches_reference(T, k, E):
    r = np.random.default_rng(T)
    idx = np.stack([r.permutation(E)[:k] for _ in range(T)]).astype(np.int32)
    np.testing.assert_array_equal(
        tmoe.position_in_expert(torch.from_numpy(idx), E).numpy(),
        np.asarray(jmoe.position_in_expert(jnp.asarray(idx), E)))


def test_capacity_is_the_reference_rule():
    """C = max(ceil(T·k/E·1.25), k): DeepSeek-MoE-16B's (8, 512) forward
    gives 480 slots an expert, a decode step of batch 8 gives 6."""
    ds = tmoe.MoEConfig(64, 6)
    assert tmoe.capacity(8 * 512, ds) == 480
    assert tmoe.capacity(8, ds) == 6
    assert tmoe.capacity(40, tmoe.MoEConfig(2, 1, 0.1)) == 2


# ---------------------------------------------------------------------------
# the FFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("combine", ["gather", "scatter"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [False, True])
def test_moe_ffn_matches_reference(combine, dtype, shared):
    """Output and aux loss against both of the reference's combine modes
    (bit-identical to each other there)."""
    p = _ffn_params(3 + int(shared), shared=shared)
    x = np.random.default_rng(4).normal(size=(64, 16)).astype(np.float32)
    cfg_t, cfg_j = tmoe.MoEConfig(8, 2), jmoe.MoEConfig(8, 2)
    to, ta = tmoe.moe_ffn(torch.from_numpy(x).to(getattr(torch, dtype)),
                          _as(p, "torch", dtype), cfg_t)
    jo, ja = jmoe.moe_ffn(jnp.asarray(x, getattr(jnp, dtype)),
                          _as(p, "jax", dtype), cfg_j, combine=combine)
    assert to.dtype == getattr(torch, dtype) and ta.dtype == torch.float32
    np.testing.assert_allclose(_f32(to), _f32(jo),
                               **(FP32 if dtype == "float32" else BF16))
    np.testing.assert_allclose(float(ta), float(ja), **FP32)


def test_overflow_tokens_dropped_not_corrupted():
    """Capacity factor 0.1: 40 identical tokens, 2 experts top-1, 2 slots
    an expert; the overflow goes to the trash row. The same rows are kept
    as in the reference, and they hold the expert's output."""
    p = _ffn_params(2, E=2, D=8, F=16)
    x = np.ones((40, 8), np.float32)
    cfg_t = tmoe.MoEConfig(2, 1, capacity_factor=0.1)
    cfg_j = jmoe.MoEConfig(2, 1, capacity_factor=0.1)
    to, _ = tmoe.moe_ffn(torch.from_numpy(x), _as(p, "torch", "float32"),
                         cfg_t)
    jo, _ = jmoe.moe_ffn(jnp.asarray(x), _as(p, "jax", "float32"), cfg_j)
    to, jo = to.numpy(), np.asarray(jo)
    assert np.all(np.isfinite(to))
    kept = np.abs(to).sum(axis=1) > 0
    np.testing.assert_array_equal(kept, np.abs(jo).sum(axis=1) > 0)
    assert kept.sum() == 2                   # one expert, its two slots
    np.testing.assert_allclose(to, jo, **FP32)


def test_moe_ffn_runs_under_vmap_and_grad():
    """The batched FEL engine's route: ``vmap`` over members equals the
    members one at a time, and ``vmap(grad)`` the gradients one at a
    time (float32; the same kernels on the CPU, so equal to rounding)."""
    from torch.func import grad, vmap
    p = _as(_ffn_params(6, shared=True), "torch", "float32")
    xs = torch.from_numpy(np.random.default_rng(7).normal(
        size=(3, 24, 16)).astype(np.float32))
    cfg = tmoe.MoEConfig(8, 2)
    out, aux = vmap(lambda x: tmoe.moe_ffn(x, p, cfg))(xs)
    for i in range(3):
        o, a = tmoe.moe_ffn(xs[i], p, cfg)
        torch.testing.assert_close(out[i], o, **FP32)
        torch.testing.assert_close(aux[i], a, **FP32)

    def loss(params, x):
        o, a = tmoe.moe_ffn(x, params, cfg)
        return (o ** 2).sum() + 0.01 * a

    g = vmap(grad(loss), in_dims=(None, 0))(p, xs)
    for i in range(3):
        gi = grad(loss)(p, xs[i])
        for name in ("router", "w_gate", "w_down"):
            torch.testing.assert_close(g[name][i], gi[name], **FP32)
        torch.testing.assert_close(g["shared"]["w_up"][i],
                                   gi["shared"]["w_up"], **FP32)


def test_moe_ffn_gradients_match_reference():
    """``jax.grad`` of the reference's gather combine against autograd,
    float32."""
    p = _ffn_params(8, E=4)
    x = np.random.default_rng(9).normal(size=(32, 16)).astype(np.float32)
    cfg_j = jmoe.MoEConfig(4, 2)

    def jloss(params):
        o, a = jmoe.moe_ffn(jnp.asarray(x), params, cfg_j)
        return jnp.sum(o ** 2) + 0.01 * a

    jg = jax.grad(jloss)(_as(p, "jax", "float32"))
    tp = {k: v.requires_grad_(True) for k, v in
          _as(p, "torch", "float32").items()}
    o, a = tmoe.moe_ffn(torch.from_numpy(x), tp, tmoe.MoEConfig(4, 2))
    ((o ** 2).sum() + 0.01 * a).backward()
    for k in tp:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the reduced models
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reduced(name):
    jcfg = j_get_config(name).reduced()
    jm = JModel(jcfg)
    npp = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(0)))
    cfg = get_config(name).reduced()
    m = Model(cfg, device="cpu")
    return (jm, jax.tree.map(jnp.asarray, npp), m,
            transformer_params_from_jax(npp, cfg, device="cpu"))


@functools.lru_cache(maxsize=None)
def _jit(jm):
    return (jax.jit(lambda p, t: jm.forward(p, {"tokens": t})),
            jax.jit(lambda p, t: jm.prefill(p, {"tokens": t})),
            jax.jit(jm.decode_step))


@pytest.mark.parametrize("name", MOE)
def test_forward_aux_and_loss_match_reference(name):
    jm, jp, m, tp = _reduced(name)
    toks = np.random.default_rng(1).integers(0, 512, (3, 24)).astype(np.int32)
    jl, jaux = _jit(jm)[0](jp, jnp.asarray(toks))
    before = ops.launch_counts()
    tl, taux = m.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert ops.launch_counts() == before            # the CPU runs no kernel
    assert tl.dtype == torch.bfloat16 and taux.dtype == torch.float32
    _assert_model_close(tl, jl)
    assert float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-3)
    labels = np.random.default_rng(2).integers(0, 512, (3, 24))
    loss = m.loss(tp, {"tokens": torch.from_numpy(toks),
                       "labels": torch.from_numpy(labels)})
    jloss = jax.jit(jm.loss)(jp, {"tokens": jnp.asarray(toks),
                                  "labels": jnp.asarray(labels)})
    assert abs(float(loss) - float(jloss)) <= 1e-2


@pytest.mark.parametrize("name", MOE)
def test_prefill_matches_reference(name):
    jm, jp, m, tp = _reduced(name)
    toks = np.random.default_rng(3).integers(0, 512, (2, 13)).astype(np.int32)
    jl, jc = _jit(jm)[1](jp, jnp.asarray(toks))
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (2, 1, 512) and isinstance(tc, DecodeCache)
    _assert_model_close(tl, jl)
    for t, j in ((tc.k, jc.k), (tc.v, jc.v)):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == j.shape
        _assert_model_close(t, j)


@pytest.mark.parametrize("name", MOE)
def test_decode_chain_matches_reference(name):
    """Decode steps from an empty cache (the FFN routes the batch's B
    tokens of each step), then the last step against a forward's last
    position."""
    jm, jp, m, tp = _reduced(name)
    B, S = 3, 12
    toks = np.random.default_rng(4).integers(0, 512, (B, S)).astype(np.int32)
    jc, tc = jm.init_cache(B, S), m.init_cache(B, S)
    jdec = _jit(jm)[2]
    for i in range(S):
        jl, jc = jdec(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                      jnp.asarray(i, jnp.int32))
        tl, tc = m.decode_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]), i)
        _assert_model_close(tl, jl)
    _assert_model_close(tc.k, jc.k)
    _assert_model_close(tc.v, jc.v)


@pytest.mark.parametrize("name", MOE)
def test_moe_params_from_jax_and_init_layout(name):
    """Bytes-identical weights; the port's own init in the reference's
    layout (float32 router, (E, ·, ·) bfloat16 expert stacks, the shared
    experts where the config has them), repeatable from a seed."""
    jm, jp, m, tp = _reduced(name)
    assert tser.serialize_pytree(tp) == \
        jser.serialize_pytree(jax.tree.map(np.asarray, jp))
    moe = tp["layers"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["w_gate"].shape == (2, 4, 256, m.cfg.moe_d_ff or 512)
    assert ("shared" in moe) == (name == "deepseek-moe-16b")
    jshape = jax.eval_shape(lambda: jm.init(jax.random.key(0)))
    tinit = init_params(m.cfg, torch.Generator().manual_seed(0))
    jleaves = {jax.tree_util.keystr(k): (v.shape, np.dtype(v.dtype).str)
               for k, v in jax.tree_util.tree_flatten_with_path(jshape)[0]}
    tleaves = {k: (tuple(v.shape), "<V2" if v.dtype == torch.bfloat16
                   else v.numpy().dtype.str)
               for k, v in tser._sorted_leaves(tinit)}
    assert tleaves == jleaves
    again = init_params(m.cfg, torch.Generator().manual_seed(0))
    assert tser.serialize_pytree(again) == tser.serialize_pytree(tinit)
    bad = jax.tree.map(np.asarray, jp)
    bad["layers"]["moe"]["router"] = bad["layers"]["moe"]["router"].astype(
        jnp.bfloat16)
    with pytest.raises(TypeError):
        transformer_params_from_jax(bad, m.cfg, device="cpu")


@pytest.mark.parametrize("name", MOE)
def test_parameter_counts_match_reference(name):
    """n_params and n_active_params (routed experts count k of E), at the
    reduced and the full configs."""
    for jcfg, cfg in ((j_get_config(name).reduced(),
                       get_config(name).reduced()),
                      (j_get_config(name), get_config(name))):
        jm, m = JModel(jcfg), Model(cfg, device="cpu")
        assert m.n_params() == jm.n_params()
        assert m.n_active_params() == jm.n_active_params()
