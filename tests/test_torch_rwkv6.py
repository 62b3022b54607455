"""The port's RWKV-6 (``repro_torch.models``) against the reference
(``repro.models``), on the CPU at small sizes.

Both packages get the same numpy inputs and the same weights: the
reference's init, carried over bit for bit by ``rwkv_params_from_jax``.

Tolerances:
- float32 time mix and block: atol 2e-4 / rtol 2e-3, the reference's own
  for its two recurrence backends (tests/test_kernels_wkv6.py:71-74);
  the state atol 1e-4 as there.
- the bfloat16 model (the reference's compute dtype): logits within
  0.125 absolute and 0.02 on average. bfloat16 keeps 8 mantissa bits, so
  one ulp is 0.03125 for a logit in [4, 8); XLA's CPU dots and fused
  elementwise ops keep float32 between operations where torch rounds
  each one, so r, k, v differ by an ulp here and there, and that reaches
  the logits through the layers. Measured: at most 0.0625 (two ulps) on
  logits of magnitude ≤ 4.1, mean 0.007. The float32 wkv state sums
  those inputs over time: within 2 % of its largest entry.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import serialization as jser
from repro.models import rwkv6 as jrwkv
from repro.models.model_api import Model as JModel
from repro.models.model_api import _token_ce_loss as j_ce
from repro_torch.configs import get_config
from repro_torch.models.config import PORT_ONLY
from repro_torch.core import serialization as tser
from repro_torch.kernels import ops
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models.model_api import Model, _token_ce_loss
from repro_torch.models.ssm_models import (rwkv_init_params,
                                           rwkv_params_from_jax)

FP32 = dict(atol=2e-4, rtol=2e-3)
LOGIT_ATOL, LOGIT_MEAN = 0.125, 0.02


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _reduced():
    """(reference model, reference params, port model, port params) at the
    reduced config: 2 layers, d_model 256, 4 heads of 64, vocab 512."""
    jcfg = j_get_config("rwkv6-1.6b").reduced()
    jm = JModel(jcfg)
    jp = jax.jit(jm.init)(jax.random.key(0))
    cfg = get_config("rwkv6-1.6b").reduced()
    m = Model(cfg, device="cpu")
    return jm, jp, m, rwkv_params_from_jax(_np_tree(jp), cfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _block_init(jcfg):
    """The reference's block init, compiled once per config."""
    return jax.jit(functools.partial(jrwkv.rwkv_block_init, jcfg))


def _block(d_model, head_size, seed):
    jcfg = jrwkv.RWKVConfig(d_model=d_model, head_size=head_size)
    jp = _np_tree(_block_init(jcfg)(jax.random.key(seed)))
    # a nonzero bonus u and varied mixes, so every term of the recurrence
    # is exercised (the init has u = 0 and mu = 0.5)
    r = np.random.default_rng(seed)
    jp["u"] = r.normal(size=jp["u"].shape).astype(np.float32)
    jp["mu"] = r.uniform(0, 1, size=jp["mu"].shape).astype(np.float32)
    tcfg = trwkv.RWKVConfig(d_model=d_model, head_size=head_size)
    return jcfg, jp, tcfg, _to_torch(jp)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().to(torch.float32).numpy(),
                               np.asarray(jnp.asarray(j, jnp.float32)), **tol)


# the reference's Pallas path (interpret mode) on the shape with every
# term: the model's head size, a carried state and shift
@pytest.mark.parametrize("d_model,head_size,S,carry,use_pallas", [
    (64, 16, 40, False, False), (128, 64, 9, True, False),
    (64, 16, 1, True, False), (128, 64, 9, True, True)])
def test_time_mix_fp32_matches_reference(d_model, head_size, S, carry,
                                         use_pallas):
    jcfg, jp, tcfg, tp = _block(d_model, head_size, S)
    r = np.random.default_rng(S + d_model)
    B, H = 2, d_model // head_size
    x = r.normal(size=(B, S, d_model)).astype(np.float32)
    state = shift = None
    if carry:
        state = 0.1 * r.normal(size=(B, H, head_size, head_size))
        state = state.astype(np.float32)
        shift = r.normal(size=(B, d_model)).astype(np.float32)
    jout = jax.jit(functools.partial(
        jrwkv.rwkv_time_mix, cfg=jcfg, use_pallas=use_pallas))(
        jp, jnp.asarray(x),
        state=None if state is None else jnp.asarray(state),
        shift_state=None if shift is None else jnp.asarray(shift))
    tout = trwkv.rwkv_time_mix(
        tp, torch.from_numpy(x), tcfg,
        state=None if state is None else torch.from_numpy(state),
        shift_state=None if shift is None else torch.from_numpy(shift))
    _close(tout[0], jout[0], **FP32)
    _close(tout[1], jout[1], atol=1e-4, rtol=0)
    _close(tout[2], jout[2], atol=0, rtol=0)


@pytest.mark.parametrize("carry,use_pallas", [(False, False), (True, False),
                                              (True, True)])
def test_block_apply_fp32_matches_reference(carry, use_pallas, monkeypatch):
    if use_pallas:   # the reference's block calls the scan; send it to Pallas
        monkeypatch.setattr(jrwkv, "rwkv_time_mix", functools.partial(
            jrwkv.rwkv_time_mix, use_pallas=True))
    jcfg, jp, tcfg, tp = _block(128, 64, 3)
    r = np.random.default_rng(7)
    B, S = 2, 12
    x = r.normal(size=(B, S, 128)).astype(np.float32)
    jst = tst = None
    if carry:
        st = [(0.1 * r.normal(size=(B, 2, 64, 64))).astype(np.float32),
              r.normal(size=(B, 128)).astype(np.float32),
              r.normal(size=(B, 128)).astype(np.float32)]
        jst = jrwkv.RWKVBlockState(*map(jnp.asarray, st))
        tst = trwkv.RWKVBlockState(*map(torch.from_numpy, st))
    jx, jnew = jax.jit(functools.partial(jrwkv.rwkv_block_apply, cfg=jcfg))(
        jp, jnp.asarray(x), state=jst)
    tx, tnew = trwkv.rwkv_block_apply(tp, torch.from_numpy(x), tcfg,
                                      state=tst)
    _close(tx, jx, **FP32)
    _close(tnew.wkv, jnew.wkv, atol=1e-4, rtol=0)
    _close(tnew.shift_tm, jnew.shift_tm, **FP32)
    _close(tnew.shift_cm, jnew.shift_cm, **FP32)


def _assert_logits_close(t, j):
    t = t.to(torch.float32).numpy()
    j = np.asarray(jnp.asarray(j, jnp.float32))
    assert t.shape == j.shape
    diff = np.abs(t - j)
    assert diff.max() <= LOGIT_ATOL, diff.max()
    assert diff.mean() <= LOGIT_MEAN, diff.mean()


def test_forward_logits_match_reference():
    jm, jp, m, tp = _reduced()
    toks = np.random.default_rng(1).integers(0, 512, (3, 24)).astype(np.int32)
    jl, jaux = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    tl, taux = m.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.bfloat16 and float(taux) == float(jaux) == 0.0
    _assert_logits_close(tl, jl)
    labels = np.random.default_rng(2).integers(0, 512, (3, 24))
    loss = m.loss(tp, {"tokens": torch.from_numpy(toks),
                       "labels": torch.from_numpy(labels)})
    jloss = jax.jit(jm.loss)(jp, {"tokens": jnp.asarray(toks),
                                  "labels": jnp.asarray(labels)})
    assert abs(float(loss) - float(jloss)) <= 1e-2


def test_token_ce_loss_matches_reference():
    r = np.random.default_rng(3)
    logits = r.normal(size=(2, 5, 17)).astype(np.float32)
    labels = r.integers(0, 17, (2, 5))
    np.testing.assert_allclose(
        float(_token_ce_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels))),
        float(j_ce(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)


def test_decode_chain_matches_reference():
    """A chain of decode steps: logits at every step, then the carried
    state of every layer."""
    jm, jp, m, tp = _reduced()
    B, S = 3, 12
    toks = np.random.default_rng(4).integers(0, 512, (B, S)).astype(np.int32)
    jc, tc = jm.init_cache(B, S), m.init_cache(B, S)
    jdec = jax.jit(jm.decode_step)
    before = ops.launch_counts()
    for i in range(S):
        jl, jc = jdec(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                      jnp.asarray(i, jnp.int32))
        tl, tc = m.decode_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]), i)
        _assert_logits_close(tl, jl)
    assert ops.launch_counts() == before           # the CPU runs no kernel
    assert tc.wkv.shape == (2, B, 4, 64, 64) and tc.wkv.dtype == torch.float32
    jwkv = np.asarray(jc.wkv)
    assert np.abs(tc.wkv.numpy() - jwkv).max() <= 0.02 * np.abs(jwkv).max()
    for t, j in ((tc.shift_tm, jc.shift_tm), (tc.shift_cm, jc.shift_cm)):
        assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
        _close(t, j, atol=0.0625, rtol=0)
    # the last decode step equals the last position of a forward
    tf, _ = m.forward(tp, {"tokens": torch.from_numpy(toks)})
    torch.testing.assert_close(tl[:, 0], tf[:, -1], rtol=0, atol=0)


def test_prefill_returns_last_logits_and_fresh_cache():
    jm, jp, m, tp = _reduced()
    toks = np.random.default_rng(5).integers(0, 512, (2, 7)).astype(np.int32)
    tl, cache = m.prefill(tp, {"tokens": torch.from_numpy(toks)})
    jl, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    assert tl.shape == (2, 1, 512)
    _assert_logits_close(tl, jl)
    for t, j in zip(cache, jcache):
        assert tuple(t.shape) == j.shape and not t.any()


def test_params_from_jax_bytes_identical():
    _, jp, _, tp = _reduced()
    assert tser.serialize_pytree(tp) == jser.serialize_pytree(_np_tree(jp))
    assert tp["embed"].dtype == tp["lm_head"].dtype == torch.bfloat16
    assert tp["layers"]["wr"].shape == (2, 256, 256)


@pytest.mark.parametrize("bad", ["name", "layer_name", "shape", "dtype",
                                 "bf16_dtype"])
def test_params_from_jax_checks(bad):
    _, jp, m, _ = _reduced()
    p = _np_tree(jp)
    p["layers"] = dict(p["layers"])
    err = ValueError
    if bad == "name":
        p["head"] = p.pop("lm_head")
    elif bad == "layer_name":
        p["layers"]["w1"] = p["layers"].pop("wr")
    elif bad == "shape":
        p["layers"]["wk"] = p["layers"]["wk"][:1]
    elif bad == "dtype":
        p["final_norm"], err = p["final_norm"].astype(np.float64), TypeError
    else:
        p["embed"], err = p["embed"].astype(np.float32), TypeError
    with pytest.raises(err):
        rwkv_params_from_jax(p, m.cfg, device="cpu")


def test_init_has_reference_layout():
    """The port's own init: the reference's names, shapes and dtypes, and
    truncated-normal weights inside ±2 scales."""
    jp = jax.eval_shape(lambda: JModel(j_get_config("rwkv6-1.6b").reduced())
                        .init(jax.random.key(0)))
    cfg = get_config("rwkv6-1.6b").reduced()
    tp = rwkv_init_params(cfg, torch.Generator().manual_seed(0))
    jleaves = {jax.tree_util.keystr(k): (v.shape, np.dtype(v.dtype).str)
               for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tleaves = {k: (tuple(v.shape), "<V2" if v.dtype == torch.bfloat16
                   else v.numpy().dtype.str)
               for k, v in tser._sorted_leaves(tp)}
    assert tleaves == jleaves
    assert float(tp["embed"].float().abs().max()) <= 2 * 0.02 + 1e-3
    assert float(tp["lm_head"].float().abs().max()) <= 2 / 16 + 1e-3
    assert float(tp["embed"].float().std()) == pytest.approx(0.02 * 0.88,
                                                             rel=0.05)
    again = rwkv_init_params(cfg, torch.Generator().manual_seed(0))
    assert tser.serialize_pytree(again) == tser.serialize_pytree(tp)


def test_unported_families_name_their_roadmap_item():
    """Every reference id is registered. The cross-attention families
    (item 11c) build a ``Model`` whose parameter count, from
    ``param_shapes`` with nothing allocated, is the reference's; the
    hybrid and MoE families are ported; ``mnist-mlp``'s config is the
    reference's, and ``Model`` refuses its family, naming ``run_bhfl``."""
    want = {"llama-3.2-vision-90b": 87_666_794_536,
            "musicgen-medium": 2_271_438_336}
    for arch, n in want.items():
        m = Model(get_config(arch), device="cpu")
        assert m.cfg == get_config(arch) and m.needs_context()
        assert m.n_params() == JModel(j_get_config(arch)).n_params() == n
    for arch in ("zamba2-7b", "deepseek-moe-16b", "phi3.5-moe-42b-a6.6b"):
        assert Model(get_config(arch), device="cpu").cfg.name == arch
    with pytest.raises(KeyError):
        get_config("gpt-5")
    assert dataclasses.asdict(get_config("mnist-mlp")) == dict(
        dataclasses.asdict(j_get_config("mnist-mlp")), **PORT_ONLY)
    with pytest.raises(NotImplementedError, match="run_bhfl"):
        Model(get_config("mnist-mlp"), device="cpu")


def test_entry_points_default_to_the_card():
    """device=None means the CUDA card: with none, they raise instead of
    falling back to the CPU."""
    from repro_torch.fl.adapters import MLPAdapter, params_from_jax
    from repro_torch.models.mlp import MLPConfig, mlp_init
    from repro_torch.models.transformer import transformer_params_from_jax
    from repro_torch.serving import ServingEngine
    _, jp, m, tp = _reduced()
    mlp = {k: np.zeros(s, np.float32) for k, s in
           (("w1", (784, 4)), ("b1", (4,)), ("w2", (4, 10)), ("b2", (10,)))}
    dense = get_config("yi-6b").reduced()
    dense_np = jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(JModel(j_get_config("yi-6b").reduced()).init,
                       jax.random.key(0)))
    builds = [lambda: Model(m.cfg).device,
              lambda: Model(dense).device,
              lambda: rwkv_params_from_jax(_np_tree(jp), m.cfg)["embed"].device,
              lambda: transformer_params_from_jax(dense_np, dense)[
                  "embed"].device,
              lambda: params_from_jax(mlp, MLPConfig(hidden=4))["w1"].device,
              lambda: ServingEngine(Model(m.cfg), None).device,
              lambda: MLPAdapter().device,
              lambda: mlp_init(MLPConfig(hidden=4),
                               torch.Generator().manual_seed(0))["w1"].device]
    for build in builds:
        if torch.cuda.is_available():
            assert build().type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build()
    assert MLPAdapter(device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="engine runs on"):
        ServingEngine(m, tp, device="meta")
