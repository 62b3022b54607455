"""The cross-attention families of the port (``repro_torch.models.
transformer``'s vlm and audio branches, their ``Model`` and serving
paths) and flash attention with keys of their own length, against the
reference, on the CPU.

Flash attention with Skv != Sq: ``ops.flash_attention`` on the CPU is the
kernel's plain version; the reference computes cross-attention in its
jnp ``blockwise_attention(q, k, v, causal=False, window=0)``
(src/repro/models/transformer.py:_cross_attention), masking keys by
k < Skv. Both get the same numpy inputs.

The models: the reduced Llama-3.2-Vision (2 layers: one group of one
self-attention layer and one gated cross-attention block) and the
reduced MusicGen (2 layers, cross-attention in each), d_model 256, 4
heads of 32, 16 context tokens, vocab 512. Both packages get the same
weights (the reference's init, carried over bit for bit by
``transformer_params_from_jax``), with the vlm tanh gates set to nonzero
values (the reference starts them at 0, where the cross blocks add
nothing), and the same context.

Tolerances (tests/test_kernels.py:19-21): float32 rtol 2e-5 / atol 2e-6,
bfloat16 rtol/atol 2e-2. The bfloat16 models' logits and caches within
0.125 absolute and 0.02 on average, the rule of
tests/test_torch_transformer.py; greedy tokens equal where the
reference's top-2 margin is clear of twice that.
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
from repro.models import layers as jlayers
from repro.models.model_api import Model as JModel
from repro.serving import GenerationRequest as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.core import serialization as tser
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers
from repro_torch.models.model_api import Model
from repro_torch.models.transformer import (DecodeCache, init_params,
                                            transformer_params_from_jax)
from repro_torch.serving import GenerationRequest, ServingEngine, grow_cache

FP32 = dict(rtol=2e-5, atol=2e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)
LOGIT_ATOL, LOGIT_MEAN = 0.125, 0.02
MARGIN = 2 * LOGIT_ATOL
CROSS = ["llama-3.2-vision-90b", "musicgen-medium"]


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


# ---------------------------------------------------------------------------
# flash attention with keys of their own length
# ---------------------------------------------------------------------------

def _qkv(seed, B, Sq, Skv, Hq, Hk, hd):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, Sq, Hq, hd)).astype(np.float32),
            r.normal(size=(B, Skv, Hk, hd)).astype(np.float32),
            r.normal(size=(B, Skv, Hk, hd)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hk,hd", [
    (2, 9, 16, 4, 4, 32),        # the reduced models: Sq < Skv < one tile
    (1, 70, 16, 4, 2, 32),       # Sq > Skv, G = 2
    (2, 13, 100, 8, 1, 16),      # a ragged Skv past one 64-key tile, G = 8
    (1, 5, 130, 6, 2, 64),       # three key tiles, G = 3
])
def test_flash_keys_of_their_own_length(B, Sq, Skv, Hq, Hk, hd, dtype):
    arrs = _qkv(Sq * Skv + hd, B, Sq, Skv, Hq, Hk, hd)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    before, shapes = ops.launch_counts(), ops.flash_launch_shapes()
    out = ops.flash_attention(*(torch.from_numpy(a).to(tdt) for a in arrs),
                              causal=False)
    assert ops.launch_counts() == before            # the CPU runs no kernel
    assert ops.flash_launch_shapes() == shapes
    assert out.dtype == tdt and tuple(out.shape) == (B, Sq, Hq, hd)
    ref = jlayers.blockwise_attention(*(jnp.asarray(a, jdt) for a in arrs),
                                      causal=False, window=0)
    np.testing.assert_allclose(_f32(out), _f32(ref),
                               **(FP32 if dtype == "float32" else BF16))
    # the model-layer entry is the same op
    lay = layers.blockwise_attention(
        *(torch.from_numpy(a).to(tdt) for a in arrs), causal=False)
    assert torch.equal(lay, out)


def test_flash_keys_of_their_own_length_lse_and_backward():
    """The plain forward, its row logsumexp L and the backward (through
    the autograd Function, as on the card) against the reference's
    blockwise attention, its scores' logsumexp and ``jax.grad``."""
    B, Sq, Skv, Hq, Hk, hd = 2, 11, 37, 4, 2, 32
    q, k, v = _qkv(5, B, Sq, Skv, Hq, Hk, hd)
    d_o = np.random.default_rng(6).normal(size=(B, Sq, Hq, hd)).astype(
        np.float32)

    def jloss(q, k, v):
        o = jlayers.blockwise_attention(q, k, v, causal=False, window=0)
        return jnp.sum(o * jnp.asarray(d_o))

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    scores = jnp.einsum("bqhd,bkhd->bhqk", jq,
                        jnp.repeat(jk, Hq // Hk, axis=2)) / np.sqrt(hd)
    jlse = jax.nn.logsumexp(scores, axis=-1)

    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, causal=False)
    o.backward(torch.from_numpy(d_o))
    lse = tref.flash_attention_lse_ref(tq.detach(), tk.detach(),
                                       causal=False)
    assert tuple(lse.shape) == (B, Hq, Sq)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FP32)
    np.testing.assert_allclose(
        o.detach().numpy(),
        np.asarray(jlayers.blockwise_attention(jq, jk, jv, causal=False,
                                               window=0)), **FP32)
    for t, j in zip((tq.grad, tk.grad, tv.grad), jgrads):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **FP32)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 3),
                                           (True, 5)])
def test_flash_refuses_masks_with_keys_of_their_own_length(causal, window):
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 8, 12, 2, 2, 16))
    with pytest.raises(ValueError, match="Skv 12 != Sq 8"):
        ops.flash_attention(q, k, v, causal=causal, window=window)
    with pytest.raises(ValueError, match="one shape"):
        ops.flash_attention(q, k, v[:, :11], causal=False)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_reference(dtype, bias):
    r = np.random.default_rng(3)
    x = r.normal(size=(2, 5, 64)).astype(np.float32)
    ws = [(r.normal(size=s) / 8).astype(np.float32)
          for s in ((64, 96), (96, 64))]
    bs = [r.normal(size=(96,)).astype(np.float32),
          r.normal(size=(64,)).astype(np.float32)] if bias else []
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    t = layers.gelu_mlp(*(torch.from_numpy(a).to(tdt) for a in [x] + ws + bs))
    j = jlayers.gelu_mlp(*(jnp.asarray(a, jdt) for a in [x] + ws + bs))
    assert t.dtype == tdt
    np.testing.assert_allclose(_f32(t), _f32(j),
                               **(FP32 if dtype == "float32" else BF16))


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reduced(name):
    """(reference model, reference params, port model, port params) at the
    reduced config of ``name``; the vlm gates set to nonzero values."""
    jm = JModel(j_get_config(name).reduced())
    npp = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(0)))
    if "cross_layers" in npp:
        cl = npp["cross_layers"]
        cl["gate_attn"] = np.full_like(cl["gate_attn"], 0.7)
        cl["gate_mlp"] = np.full_like(cl["gate_mlp"], -0.4)
    cfg = get_config(name).reduced()
    return (jm, jax.tree.map(jnp.asarray, npp), Model(cfg, device="cpu"),
            transformer_params_from_jax(npp, cfg, device="cpu"))


@functools.lru_cache(maxsize=None)
def _jit(jm):
    """The reference's forward, prefill and decode step, compiled once."""
    return (jax.jit(lambda p, t, c: jm.forward(p, {"tokens": t,
                                                   "context": c})),
            jax.jit(lambda p, t, c: jm.prefill(p, {"tokens": t,
                                                   "context": c})),
            jax.jit(jm.decode_step))


def _context(m, B, seed=7):
    return np.random.default_rng(seed).normal(
        size=m.context_shape(B)).astype(np.float32)


@pytest.mark.parametrize("name", CROSS)
def test_forward_and_loss_match_reference(name):
    jm, jp, m, tp = _reduced(name)
    toks = np.random.default_rng(1).integers(0, 512, (3, 24)).astype(np.int32)
    ctx = _context(m, 3)
    jl, _ = _jit(jm)[0](jp, jnp.asarray(toks), jnp.asarray(ctx))
    batch = {"tokens": torch.from_numpy(toks),
             "context": torch.from_numpy(ctx)}
    tl, taux = m.forward(tp, batch)
    assert tl.dtype == torch.bfloat16 and float(taux) == 0.0
    _assert_model_close(tl, jl)
    labels = np.random.default_rng(2).integers(0, 512, (3, 24))
    loss = m.loss(tp, {**batch, "labels": torch.from_numpy(labels)})
    jloss = jax.jit(jm.loss)(jp, {"tokens": jnp.asarray(toks),
                                  "context": jnp.asarray(ctx),
                                  "labels": jnp.asarray(labels)})
    assert abs(float(loss) - float(jloss)) <= 1e-2


def test_without_a_context_vlm_raises_and_audio_skips_its_cross_attention():
    """As the reference's LM rounds see it (its ``LMAdapter`` passes no
    context): vlm refuses, audio runs its self-attention only."""
    toks = np.random.default_rng(4).integers(0, 512, (2, 10)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    jm, jp, m, tp = _reduced("llama-3.2-vision-90b")
    with pytest.raises(AssertionError):
        jm.loss(jp, {"tokens": jnp.asarray(toks),
                     "labels": jnp.asarray(labels)})
    with pytest.raises(ValueError, match="needs its context"):
        m.loss(tp, {"tokens": torch.from_numpy(toks),
                    "labels": torch.from_numpy(labels)})
    with pytest.raises(ValueError, match="needs its context"):
        m.prefill(tp, {"tokens": torch.from_numpy(toks)})
    jm, jp, m, tp = _reduced("musicgen-medium")
    jloss = jax.jit(jm.loss)(jp, {"tokens": jnp.asarray(toks),
                                  "labels": jnp.asarray(labels)})
    loss = m.loss(tp, {"tokens": torch.from_numpy(toks),
                       "labels": torch.from_numpy(labels)})
    assert abs(float(loss) - float(jloss)) <= 1e-2
    with_ctx = m.loss(tp, {"tokens": torch.from_numpy(toks),
                           "labels": torch.from_numpy(labels),
                           "context": torch.from_numpy(_context(m, 2))})
    assert float(with_ctx) != float(loss)


@pytest.mark.parametrize("name", CROSS)
def test_prefill_and_decode_chain_match_reference(name):
    """The prompt through ``prefill`` with the context (self and context
    K/V), then a chain of decode steps on the cache grown along its
    sequence axis: logits at every step, then the cache."""
    jm, jp, m, tp = _reduced(name)
    B, P, n = 2, 13, 6
    r = np.random.default_rng(3)
    toks = r.integers(0, 512, (B, P + n)).astype(np.int32)
    ctx = _context(m, B)
    _, jpre, jdec = _jit(jm)
    jl, jc = jpre(jp, jnp.asarray(toks[:, :P]), jnp.asarray(ctx))
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks[:, :P]),
                            "context": torch.from_numpy(ctx)})
    assert isinstance(tc, DecodeCache) and tl.shape == (B, 1, 512)
    _assert_model_close(tl, jl)
    Lc = 1 if m.cfg.family == "vlm" else 2
    assert tuple(tc.ctx_k.shape) == (Lc, B, 16, 4, 32)
    for t, j in zip(tc, jc):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == j.shape
        _assert_model_close(t, j)
    pad = ((0, 0), (0, 0), (0, n), (0, 0), (0, 0))
    jc = jc._replace(k=jnp.pad(jc.k, pad), v=jnp.pad(jc.v, pad))
    tc = grow_cache(tc, n)
    for i in range(P, P + n):
        jl, jc = jdec(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                      jnp.asarray(i, jnp.int32))
        tl, tc = m.decode_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]), i)
        _assert_model_close(tl, jl)
    for t, j in zip(tc, jc):
        _assert_model_close(t, j)
    tf, _ = m.forward(tp, {"tokens": torch.from_numpy(toks),
                           "context": torch.from_numpy(ctx)})
    _assert_model_close(tl[:, 0], tf[:, -1])


def test_grow_cache_leaves_the_context_alone():
    k = torch.arange(2 * 3 * 4 * 1 * 2, dtype=torch.float32).reshape(
        2, 3, 4, 1, 2)
    ck = torch.randn(2, 3, 4, 1, 2)
    grown = grow_cache(DecodeCache(k, -k, ck, -ck), 5)
    assert isinstance(grown, DecodeCache)
    assert grown.k.shape == (2, 3, 9, 1, 2) == grown.v.shape
    assert torch.equal(grown.k[:, :, :4], k) and not grown.k[:, :, 4:].any()
    assert grown.ctx_k is ck and grown.ctx_v.shape == (2, 3, 4, 1, 2)


@pytest.mark.parametrize("name", CROSS)
def test_generate_greedy_matches_reference(name):
    """``ServingEngine.generate`` with the reference's ``0.1 * ones``
    context: the reference's greedy tokens, teacher-forced through the
    port, within the tolerance at every step; the port's own tokens equal
    until the reference's top-2 margin is within 2 * LOGIT_ATOL."""
    jm, jp, m, tp = _reduced(name)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (5, 9, 14)]
    budgets = [6, 4, 6]
    ref = JEngine(jm, jp).generate(
        [JRequest(i, p, n) for i, (p, n) in enumerate(zip(prompts,
                                                           budgets))])
    before = ops.launch_counts()
    port = ServingEngine(m, tp, device="cpu").generate(
        [GenerationRequest(i, p, n) for i, (p, n) in
         enumerate(zip(prompts, budgets))])
    assert ops.launch_counts() == before
    assert [len(c.tokens) for c in port] == budgets

    # teacher-forced along the reference's tokens
    P, n = 14, max(budgets)
    padded = np.zeros((3, P), np.int32)
    for i, p in enumerate(prompts):
        padded[i, P - len(p):] = p
    forced = np.zeros((3, n), np.int32)
    for i, c in enumerate(ref):
        forced[i, :len(c.tokens)] = c.tokens
    ctx = 0.1 * np.ones(m.context_shape(3), np.float32)
    _, jpre, jdec = _jit(jm)
    jl, jc = jpre(jp, jnp.asarray(padded), jnp.asarray(ctx))
    pad = ((0, 0), (0, 0), (0, n), (0, 0), (0, 0))
    jc = jc._replace(k=jnp.pad(jc.k, pad), v=jnp.pad(jc.v, pad))
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(padded),
                            "context": torch.from_numpy(ctx)})
    tc = grow_cache(tc, n)
    clear = [True] * 3
    for step in range(n):
        if step:
            tok = forced[:, step - 1:step]
            jl, jc = jdec(jp, jc, jnp.asarray(tok),
                          jnp.asarray(P + step - 1, jnp.int32))
            tl, tc = m.decode_step(tp, tc, torch.from_numpy(tok),
                                   P + step - 1)
        _assert_model_close(tl, jl)
        j = _f32(jl)[:, -1]
        top2 = np.sort(j, axis=-1)[:, -2:]
        for i, c in enumerate(ref):
            if step >= len(c.tokens):
                continue
            assert int(np.argmax(j[i])) == c.tokens[step]
            clear[i] &= bool(top2[i, 1] - top2[i, 0] > MARGIN)
            if clear[i]:
                assert port[i].tokens[step] == c.tokens[step]


@pytest.mark.parametrize("name", CROSS)
def test_params_bytes_and_init_layout_match_reference(name):
    """The carried weights serialize to the reference's bytes (the vlm
    layers on their (n_groups, spg) axes); the port's own init has the
    reference's names, shapes and dtypes and repeats from one seed."""
    jm, jp, _, tp = _reduced(name)
    assert tser.serialize_pytree(tp) == \
        jser.serialize_pytree(jax.tree.map(np.asarray, jp))
    cfg = get_config(name).reduced()
    own = init_params(cfg, torch.Generator().manual_seed(0))
    jshape = jax.eval_shape(lambda: jm.init(jax.random.key(0)))
    jleaves = {jax.tree_util.keystr(k): (v.shape, np.dtype(v.dtype).str)
               for k, v in jax.tree_util.tree_flatten_with_path(jshape)[0]}
    tleaves = {k: (tuple(v.shape), "<V2" if v.dtype == torch.bfloat16
                   else v.numpy().dtype.str)
               for k, v in tser._sorted_leaves(own)}
    assert tleaves == jleaves
    again = init_params(cfg, torch.Generator().manual_seed(0))
    assert tser.serialize_pytree(again) == tser.serialize_pytree(own)
    if cfg.family == "vlm":
        assert own["layers"]["attn"]["wq"].shape == (1, 1, 256, 128)
        assert not own["cross_layers"]["gate_attn"].any()
    else:
        assert "bq" not in own["layers"]["xattn"]


@pytest.mark.parametrize("name", CROSS + ["mnist-mlp"])
def test_cross_and_mlp_configs_are_the_references(name):
    assert dataclasses.asdict(get_config(name)) == \
        dataclasses.asdict(j_get_config(name))
