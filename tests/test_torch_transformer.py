"""The port's dense transformer (``repro_torch.models.transformer``, its
layers and its serving branch) against the reference, on the CPU at the
reduced configs: 2 layers, d_model 256, 4 heads of 32, vocab 512 —
Yi-6B (4 KV heads, no biases) and StarCoder2-3B (2 KV heads, so GQA with
groups of 2, and QKV biases, set to random values here so that the bias
branch adds something).

Both packages get the same numpy inputs and the same weights: the
reference's init, carried over bit for bit by
``transformer_params_from_jax``.

Tolerances:
- float32 layers: the reference's flash tolerance, rtol/atol 2e-5
  (tests/test_kernels.py:141-179); RoPE atol 1e-4 at positions up to 600,
  since the two frameworks' pow may differ by an ulp in a frequency and
  the angle multiplies it by the position.
- bfloat16 layers: rtol/atol 2e-2 (tests/test_kernels.py:19-21).
- the bfloat16 model: logits, and the cached k and v, within 0.125
  absolute and 0.02 on average, the rule of tests/test_torch_rwkv6.py:
  a bf16 ulp is 0.0156 at magnitudes in [2, 4), and the second layer
  sees the first one's rounding differences. Besides torch rounding each
  operation where XLA's CPU fuses, the reference's ``blockwise_attention``
  rounds the scaled q and the probabilities to bfloat16 where the port's
  flash attention keeps float32.
"""

import collections
import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

from repro.configs import get_config as j_get_config
from repro.core import serialization as jser
from repro.models import layers as jlayers
from repro.models.model_api import Model as JModel
from repro.serving import GenerationRequest as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.models.config import PORT_ONLY
from repro_torch.core import serialization as tser
from repro_torch.kernels import ops
from repro_torch.models import layers, transformer
from repro_torch.models.model_api import Model
from repro_torch.models.transformer import (DecodeCache, FwdOptions,
                                            init_params,
                                            transformer_params_from_jax)
from repro_torch.serving import GenerationRequest, ServingEngine, grow_cache

FP32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
LOGIT_ATOL, LOGIT_MEAN = 0.125, 0.02
MARGIN = 2 * LOGIT_ATOL
DENSE = ["yi-6b", "starcoder2-3b", "qwen2.5-14b", "mistral-nemo-12b"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _reduced(name, window=0):
    """(reference model, reference params, port model, port params) at the
    reduced config of ``name``, with random QKV biases where it has them."""
    jcfg = j_get_config(name).reduced().with_sliding_window(window)
    jm = JModel(jcfg)
    npp = _np_tree(jax.jit(jm.init)(jax.random.key(0)))
    r = np.random.default_rng(1)
    for b in ("bq", "bk", "bv"):
        if b in npp["layers"]["attn"]:
            x = r.normal(size=npp["layers"]["attn"][b].shape)
            npp["layers"]["attn"][b] = np.asarray(jnp.asarray(x, jnp.bfloat16))
    cfg = get_config(name).reduced().with_sliding_window(window)
    m = Model(cfg, device="cpu")
    return (jm, jax.tree.map(jnp.asarray, npp), m,
            transformer_params_from_jax(npp, cfg, device="cpu"))


@functools.lru_cache(maxsize=None)
def _jit(jm):
    """The reference's forward, prefill and decode step, compiled once."""
    return (jax.jit(lambda p, t: jm.forward(p, {"tokens": t})),
            jax.jit(lambda p, t: jm.prefill(p, {"tokens": t})),
            jax.jit(jm.decode_step))


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
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("theta", [10000.0, 5000000.0])
def test_apply_rope_matches_reference(theta):
    r = np.random.default_rng(0)
    x = r.normal(size=(2, 5, 3, 32)).astype(np.float32)
    pos = r.integers(0, 600, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        layers.rope_frequencies(32, theta).numpy(),
        np.asarray(jlayers.rope_frequencies(32, theta)), rtol=1e-6, atol=0)
    t = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    j = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-4)
    t = layers.apply_rope(torch.from_numpy(x).to(torch.bfloat16),
                          torch.from_numpy(pos), theta)
    j = jlayers.apply_rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos),
                           theta)
    assert t.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(t), _f32(j), **BF16)


@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_reference(window, dtype):
    """Masked over the whole cache: slots after ``pos`` hold values that
    must not leak in."""
    r = np.random.default_rng(window)
    q = r.normal(size=(2, 1, 4, 32)).astype(np.float32)
    kc = r.normal(size=(2, 11, 2, 32)).astype(np.float32)
    vc = r.normal(size=(2, 11, 2, 32)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    for pos in (0, 6, 10):
        t = layers.decode_attention(
            *(torch.from_numpy(a).to(tdt) for a in (q, kc, vc)), pos,
            window=window)
        j = jlayers.decode_attention(*(jnp.asarray(a, jdt)
                                       for a in (q, kc, vc)),
                                     jnp.asarray(pos, jnp.int32),
                                     window=window)
        assert t.dtype == tdt and t.shape == (2, 1, 4, 32)
        np.testing.assert_allclose(_f32(t), _f32(j),
                                   **(FP32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_mlp_matches_reference(dtype):
    r = np.random.default_rng(2)
    x = r.normal(size=(2, 5, 64)).astype(np.float32)
    ws = [(r.normal(size=s) / 8).astype(np.float32)
          for s in ((64, 96), (64, 96), (96, 64))]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    t = layers.swiglu_mlp(*(torch.from_numpy(a).to(tdt) for a in [x] + ws))
    j = jlayers.swiglu_mlp(*(jnp.asarray(a, jdt) for a in [x] + ws))
    np.testing.assert_allclose(_f32(t), _f32(j),
                               **(FP32 if dtype == "float32" else BF16))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,window", [("yi-6b", 0), ("starcoder2-3b", 0),
                                         ("yi-6b", 8)])
def test_forward_and_loss_match_reference(name, window):
    jm, jp, m, tp = _reduced(name, window)
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


@pytest.mark.parametrize("name", ["yi-6b", "starcoder2-3b"])
def test_prefill_matches_reference(name):
    jm, jp, m, tp = _reduced(name)
    toks = np.random.default_rng(3).integers(0, 512, (2, 13)).astype(np.int32)
    jl, jc = _jit(jm)[1](jp, jnp.asarray(toks))
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (2, 1, 512)
    _assert_model_close(tl, jl)
    for t, j in ((tc.k, jc.k), (tc.v, jc.v)):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == j.shape
        _assert_model_close(t, j)


@pytest.mark.parametrize("name,window", [("yi-6b", 0), ("starcoder2-3b", 0),
                                         ("starcoder2-3b", 5)])
def test_decode_chain_matches_reference(name, window):
    """A chain of decode steps from an empty cache: logits at every step,
    then the cache; the last step against the last position of a
    forward."""
    jm, jp, m, tp = _reduced(name, window)
    B, S = 3, 12
    toks = np.random.default_rng(4).integers(0, 512, (B, S)).astype(np.int32)
    jc, tc = jm.init_cache(B, S), m.init_cache(B, S)
    jdec = _jit(jm)[2]
    for i in range(S):
        jl, jc = jdec(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                      jnp.asarray(i, jnp.int32))
        tl, tc = m.decode_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]), i)
        _assert_model_close(tl, jl)
    assert isinstance(tc, DecodeCache) and tc.k.shape == (2, B, S, m.cfg.
                                                          n_kv_heads, 32)
    _assert_model_close(tc.k, jc.k)
    _assert_model_close(tc.v, jc.v)
    tf, _ = m.forward(tp, {"tokens": torch.from_numpy(toks)})
    _assert_model_close(tl[:, 0], tf[:, -1])


def test_params_from_jax_bytes_identical():
    for name in ("yi-6b", "starcoder2-3b"):
        _, jp, _, tp = _reduced(name)
        assert tser.serialize_pytree(tp) == \
            jser.serialize_pytree(_np_tree(jp))
    assert tp["layers"]["attn"]["wq"].shape == (2, 256, 128)
    assert tp["layers"]["attn"]["bk"].dtype == torch.bfloat16
    assert tp["layers"]["ln1"].dtype == torch.float32


@pytest.mark.parametrize("bad", ["name", "layer_name", "nested_name",
                                 "no_bias", "shape", "dtype", "bf16_dtype"])
def test_params_from_jax_checks(bad):
    _, jp, m, _ = _reduced("starcoder2-3b")
    p = _np_tree(jp)
    attn = p["layers"]["attn"]
    err = ValueError
    if bad == "name":
        p["head"] = p.pop("lm_head")
    elif bad == "layer_name":
        p["layers"]["norm1"] = p["layers"].pop("ln1")
    elif bad == "nested_name":
        attn["wqkv"] = attn.pop("wq")
    elif bad == "no_bias":
        del attn["bq"]
    elif bad == "shape":
        p["layers"]["mlp"]["w_up"] = p["layers"]["mlp"]["w_up"][:1]
    elif bad == "dtype":
        p["layers"]["ln2"], err = p["layers"]["ln2"].astype(np.float64), \
            TypeError
    else:
        attn["wo"], err = attn["wo"].astype(np.float32), TypeError
    with pytest.raises(err):
        transformer_params_from_jax(p, m.cfg, device="cpu")


def test_init_has_reference_layout():
    """The port's own init: the reference's names, shapes and dtypes (the
    bias branch included), zero biases, unit norms, truncated-normal
    weights inside ±2 scales; and repeatable from one seed."""
    for name in ("yi-6b", "starcoder2-3b"):
        jp = jax.eval_shape(lambda: JModel(j_get_config(name).reduced())
                            .init(jax.random.key(0)))
        cfg = get_config(name).reduced()
        tp = init_params(cfg, torch.Generator().manual_seed(0))
        jleaves = {jax.tree_util.keystr(k): (v.shape, np.dtype(v.dtype).str)
                   for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
        tleaves = {k: (tuple(v.shape), "<V2" if v.dtype == torch.bfloat16
                       else v.numpy().dtype.str)
                   for k, v in tser._sorted_leaves(tp)}
        assert tleaves == jleaves
    attn = tp["layers"]["attn"]
    assert not attn["bq"].any() and bool((tp["layers"]["ln1"] == 1).all())
    assert float(attn["wq"].float().abs().max()) <= 2 / 16 + 1e-3
    assert float(tp["embed"].float().abs().max()) <= 2 * 0.02 + 1e-3
    again = init_params(cfg, torch.Generator().manual_seed(0))
    assert tser.serialize_pytree(again) == tser.serialize_pytree(tp)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _padded(prompts):
    P = max(len(p) for p in prompts)
    out = np.zeros((len(prompts), P), np.int32)
    for i, p in enumerate(prompts):
        out[i, P - len(p):] = p
    return out


def _j_grow(cache, n):
    """The reference's cache with n zero slots on its sequence axis (its
    own ``_grow_cache`` may pad another axis)."""
    pad = ((0, 0), (0, 0), (0, n), (0, 0), (0, 0))
    return cache._replace(k=jnp.pad(cache.k, pad), v=jnp.pad(cache.v, pad))


def _forced_logits(jm, jp, m, tp, padded, forced):
    """Both packages fed the left-padded prompts, then ``forced`` (B, n) a
    token a step, as the engine feeds its own tokens: per step, the
    (reference, port) logits (B, V). The reference's cache is grown on its
    sequence axis by hand (its ``_grow_cache`` may pick another axis)."""
    n = forced.shape[1]
    _, jpre, jdec = _jit(jm)
    jl, jc = jpre(jp, jnp.asarray(padded))
    jc = _j_grow(jc, n)
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(padded)})
    tc = grow_cache(tc, n)
    out = [(jl[:, -1], tl[:, -1])]
    P = padded.shape[1]
    for j in range(n - 1):
        jl, jc = jdec(jp, jc, jnp.asarray(forced[:, j:j + 1]),
                      jnp.asarray(P + j, jnp.int32))
        tl, tc = m.decode_step(tp, tc, torch.from_numpy(forced[:, j:j + 1]),
                               P + j)
        out.append((jl[:, -1], tl[:, -1]))
    return out


def _hold_against(ref_tokens, port, jm, jp, m, tp, prompts):
    """The port's greedy completions against the reference's greedy
    tokens ``ref_tokens`` (one list a request): teacher-forced logits
    within the tolerance at every step, and the same tokens until the
    reference's top-2 margin is within 2 * LOGIT_ATOL (a near-tie that
    bfloat16 may break either way). Returns the requests that never met a
    near-tie."""
    n = max(len(t) for t in ref_tokens)
    forced = np.zeros((len(prompts), n), np.int32)
    for i, t in enumerate(ref_tokens):
        forced[i, :len(t)] = t
    steps = _forced_logits(jm, jp, m, tp, _padded(prompts), forced)
    clear_all = [True] * len(prompts)
    for step, (j, t) in enumerate(steps):
        _assert_model_close(t, j)
        j = _f32(j)
        top2 = np.sort(j, axis=-1)[:, -2:]
        for i, toks in enumerate(ref_tokens):
            if step >= len(toks):
                continue
            assert int(np.argmax(j[i])) == toks[step]
            clear_all[i] &= bool(top2[i, 1] - top2[i, 0] > MARGIN)
            if clear_all[i]:
                assert port[i].tokens[step] == toks[step]
    return clear_all


@pytest.mark.parametrize("name,eos", [("yi-6b", None),
                                      ("starcoder2-3b", "third")])
def test_generate_greedy_matches_reference(name, eos):
    """Mixed prompt lengths and budgets; with ``eos`` the third token the
    reference generates for request 1 ends that request."""
    jm, jp, m, tp = _reduced(name)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (5, 9, 14)]
    budgets = [6, 4, 6]
    eos_tok = None
    if eos:
        first = JEngine(jm, jp).generate(
            [JRequest(i, p, n) for i, (p, n) in enumerate(zip(prompts,
                                                               budgets))])
        eos_tok = first[1].tokens[2]
    ref = JEngine(jm, jp).generate(
        [JRequest(i, p, n, eos_tok) for i, (p, n) in
         enumerate(zip(prompts, budgets))])
    before = ops.launch_counts()
    port = ServingEngine(m, tp, device="cpu").generate(
        [GenerationRequest(i, p, n, eos_tok) for i, (p, n) in
         enumerate(zip(prompts, budgets))])
    assert ops.launch_counts() == before
    assert [c.request_id for c in port] == [0, 1, 2]
    assert all(len(c.tokens) <= n for c, n in zip(port, budgets))
    clear = _hold_against([c.tokens for c in ref], port, jm, jp, m, tp,
                          prompts)
    for i, (c, r) in enumerate(zip(port, ref)):
        if clear[i]:
            assert (c.tokens, c.finished_by) == (r.tokens, r.finished_by)
    if eos and clear[1]:
        assert port[1].finished_by == "eos"


@pytest.mark.parametrize("lens", [(2, 1, 2), (3, 1, 2)],
                         ids=["max_prompt_is_n_layers", "max_prompt_is_batch"])
def test_grow_cache_on_the_sequence_axis(lens):
    """Prompts whose longest length equals the layer count (2) or the
    batch size (3): the reference's ``_grow_cache`` pads the wrong axis
    and its engine raises; the port grows axis 2 and serves. Its greedy
    tokens are held against the reference's prefill and decode steps
    driven by hand, the cache grown on axis 2."""
    jm, jp, m, tp = _reduced("yi-6b")
    rng = np.random.default_rng(sum(lens))
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in lens]
    with pytest.raises((TypeError, ValueError)):
        JEngine(jm, jp).generate([JRequest(i, p, 4)
                                  for i, p in enumerate(prompts)])
    port = ServingEngine(m, tp, device="cpu").generate(
        [GenerationRequest(i, p, 4) for i, p in enumerate(prompts)])
    assert [len(c.tokens) for c in port] == [4, 4, 4]

    # the reference, greedy, by hand
    padded = _padded(prompts)
    _, jpre, jdec = _jit(jm)
    jl, jc = jpre(jp, jnp.asarray(padded))
    jc = _j_grow(jc, 4)
    tok = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    ref = [tok]
    for j in range(3):
        jl, jc = jdec(jp, jc, tok, jnp.asarray(padded.shape[1] + j,
                                               jnp.int32))
        tok = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        ref.append(tok)
    ref = np.concatenate([np.asarray(t) for t in ref], axis=1)
    _hold_against([list(map(int, r)) for r in ref], port, jm, jp, m, tp,
                  prompts)


def test_grow_cache_pads_axis_2_only():
    k = torch.arange(2 * 3 * 2 * 1 * 4, dtype=torch.float32).reshape(
        2, 3, 2, 1, 4)
    grown = grow_cache(DecodeCache(k, -k), 5)
    assert isinstance(grown, DecodeCache)
    assert grown.k.shape == (2, 3, 7, 1, 4) == grown.v.shape
    assert torch.equal(grown.k[:, :, :2], k) and not grown.k[:, :, 2:].any()
    assert torch.equal(grown.v[:, :, :2], -k)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", DENSE)
def test_dense_configs_are_the_references(name):
    port, ref = (dataclasses.asdict(c(name)) for c in (get_config,
                                                       j_get_config))
    assert port == dict(ref, **PORT_ONLY)
    assert get_config(name).family == "dense"


# ---------------------------------------------------------------------------
# the walk over the stacked layers under the trainer's vmap(grad)
# ---------------------------------------------------------------------------

# One family of each kind, at depths that walk more than one layer of
# each stack: vlm in 2 groups of 2 self layers, the hybrid in 2 groups of
# 2 Mamba2 blocks and a tail of 1.
WALK_CONFIGS = {
    "audio": ("musicgen-medium", 3, {}),
    "dense": ("yi-6b", 3, {}),
    "moe": ("deepseek-moe-16b", 3, {}),
    "vlm": ("llama-3.2-vision-90b", 6, {"cross_attn_every": 3}),
    "rwkv6": ("rwkv6-1.6b", 3, {}),
    "hybrid": ("zamba2-7b", 7, {"attn_every": 3}),
}
STACKS = ("layers", "cross_layers", "mamba_groups", "mamba_tail")


@pytest.fixture
def one_thread():
    """One intra-op thread: these shapes are tiny, and beside the suite's
    other workers a pool of threads a process made them ~20× slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _walk_case(kind):
    """(model, two replicas stacked on a leading axis, their batch)."""
    name, n_layers, extra = WALK_CONFIGS[kind]
    cfg = dataclasses.replace(get_config(name).reduced(n_layers=n_layers),
                              **extra)
    m = Model(cfg, device="cpu")
    stacked = tree_map(lambda a, b: torch.stack([a, b]),
                       *(m.init(torch.Generator().manual_seed(s))
                         for s in (0, 1)))
    g = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 2, 8), generator=g)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=-1)}
    if m.needs_context():
        batch["context"] = torch.randn((2,) + m.context_shape(2),
                                       generator=g)
    return m, stacked, batch


def _trainer_grads(m, params, batch, opts=None):
    """The PoFEL trainer's ``local_step`` differentiation: (grads, losses)
    of ``Model.loss`` under ``vmap(grad_and_value)`` over the replicas."""
    def one(p, b):
        return torch.func.grad_and_value(m.loss)(p, b, opts)
    return torch.func.vmap(one)(params, batch)


def _stacked_leaves(m, params):
    """(stacked leaf, number of leading layer axes) of each stack."""
    lead = {"vlm": {"layers": 2}, "hybrid": {"mamba_groups": 2}}.get(
        m.cfg.family, {})
    return [(t, lead.get(k, 1)) for k in STACKS if k in params
            for _, t in tser.leaves_with_paths(params[k])]


class _BackwardOps(TorchDispatchMode):
    """The ``select_backward`` and ``stack`` calls autograd makes in the
    backward: (input sizes, dim) of each select, the shape of each
    stack."""

    def __init__(self):
        super().__init__()
        self.selects, self.stacks = [], collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if torch._C._current_autograd_node() is not None:
            if func is torch.ops.aten.select_backward.default:
                self.selects.append((tuple(args[1]), args[2]))
            elif func is torch.ops.aten.stack.default:
                self.stacks[tuple(out.shape)] += 1
        return out


@pytest.mark.parametrize("kind", list(WALK_CONFIGS))
def test_backward_writes_each_stack_once(kind, one_thread):
    """The backward takes no layer out of a stacked leaf by index (no
    stack-sized zero-filled gradient a layer to add up) and writes each
    stack's gradient with at most one ``stack``. Selects of other
    tensors (the loss's label gather, the Mamba2 time loop) stay."""
    m, params, batch = _walk_case(kind)
    ops = _BackwardOps()
    with ops:
        _trainer_grads(m, params, batch)
    leaves = _stacked_leaves(m, params)
    # a stack (C, L, ...) or (C, G, spg, ...) and, of the latter, a group
    stack_shapes = {t.shape[:1] + t.shape[1 + k:] for t, lead in leaves
                    for k in range(lead)}
    assert [s for s in ops.selects
            if s[1] == 1 and s[0] in stack_shapes] == []
    flat = collections.Counter(
        (t.shape[0], t.shape[1:lead + 1].numel()) + tuple(t.shape[lead + 1:])
        for t, lead in leaves)
    assert flat, kind
    for shape, n in flat.items():
        assert ops.stacks[shape] <= n, (shape, ops.stacks[shape], n)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("kind", list(WALK_CONFIGS))
def test_unbound_walk_bit_identical_to_index_walk(kind, remat, monkeypatch,
                                                  one_thread):
    """The loss and every gradient of the walk through ``unbind`` equal
    those of the walk that indexes each layer (``t[i]``, the walk before
    it), bit for bit: each element of a stack's gradient gets one nonzero
    term either way."""
    m, params, batch = _walk_case(kind)
    opts = FwdOptions(remat=remat)
    grads, losses = _trainer_grads(m, params, batch, opts)
    monkeypatch.setattr(
        transformer, "layer_slices", lambda t, lead=1: [
            t[i] for i in itertools.product(*map(range, t.shape[:lead]))])
    old_grads, old_losses = _trainer_grads(m, params, batch, opts)
    assert torch.equal(losses, old_losses)
    new = tser.leaves_with_paths(grads)
    old = tser.leaves_with_paths(old_grads)
    assert [p for p, _ in new] == [p for p, _ in old]
    for (path, g), (_, h) in zip(new, old):
        assert g.shape == h.shape and g.dtype == h.dtype, path
        assert torch.equal(g, h), path
