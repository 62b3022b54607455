"""The port's serving engine and samplers (``repro_torch.serving``) against
the reference (``repro.serving``), on the CPU.

- Greedy generation of RWKV-6 at the reduced config (2 layers, d_model
  256, 4 heads of 64, vocab 512) from the reference's weights. The model
  computes in bfloat16, where the two frameworks round in different
  places (tests/test_torch_rwkv6.py: logits within 0.125), so a token may
  differ only where the reference's top-2 logit margin is at most twice
  that, 0.25. Checked by teacher forcing: both models are fed the
  reference's tokens, so one near-tie does not cascade.
- The stopping rules (length, EOS, the budget of each request), on a
  stand-in model whose next token is a fixed function of the last one:
  the two engines must return identical completions.
- ``sample_token`` with top-k / top-p draws only tokens inside the set
  the reference keeps for the same logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models.model_api import Model as JModel
from repro.serving import GenerationRequest as JRequest
from repro.serving import SamplerConfig as JSamplerConfig
from repro.serving import ServingEngine as JEngine
from repro.serving import sampler as jsampler
from repro_torch.configs import get_config
from repro_torch.models.model_api import Model
from repro_torch.models.ssm_models import rwkv_params_from_jax
from repro_torch.serving import (GenerationRequest, SamplerConfig,
                                 ServingEngine, sample_token, serve_batch)

MARGIN = 0.25         # twice the logits tolerance of tests/test_torch_rwkv6


def _models():
    jcfg = j_get_config("rwkv6-1.6b").reduced()
    jm = JModel(jcfg)
    jp = jax.jit(jm.init)(jax.random.key(1))
    m = Model(get_config("rwkv6-1.6b").reduced(), device="cpu")
    return jm, jp, m, rwkv_params_from_jax(jax.tree.map(np.asarray, jp),
                                           m.cfg, device="cpu")


def _forced_logits(decode, cache, padded, forced):
    """Logits of every generation step when the model is fed ``forced``
    (B, n) after replaying the left-padded prompts ``padded`` (B, P), as
    the engine does: (B, n, V) float32."""
    out = []
    logits = None
    for i in range(padded.shape[1]):
        logits, cache = decode(cache, padded[:, i:i + 1], i)
    out.append(logits[:, -1])
    for j in range(forced.shape[1] - 1):
        logits, cache = decode(cache, forced[:, j:j + 1], padded.shape[1] + j)
        out.append(logits[:, -1])
    return out


def test_generate_greedy_matches_reference():
    jm, jp, m, tp = _models()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (3, 9, 14)]
    n_new = 6
    ref = JEngine(jm, jp).generate(
        [JRequest(i, p, n_new) for i, p in enumerate(prompts)])
    port = ServingEngine(m, tp, device="cpu").generate(
        [GenerationRequest(i, p, n_new) for i, p in enumerate(prompts)])
    assert [c.request_id for c in port] == [0, 1, 2]
    assert all(c.finished_by == "length" and len(c.tokens) == n_new
               for c in port)

    P = max(len(p) for p in prompts)
    padded = np.zeros((3, P), np.int32)
    for i, p in enumerate(prompts):
        padded[i, P - len(p):] = p
    forced = np.asarray([c.tokens for c in ref], np.int32)
    jdec = jax.jit(jm.decode_step)
    jl = _forced_logits(
        lambda c, t, pos: jdec(jp, c, jnp.asarray(t),
                               jnp.asarray(pos, jnp.int32)),
        jm.init_cache(3, P + n_new), padded, forced)
    tl = _forced_logits(
        lambda c, t, pos: m.decode_step(tp, c, torch.from_numpy(t), pos),
        m.init_cache(3, P + n_new), padded, forced)
    diverged = [False] * 3
    for step, (j, t) in enumerate(zip(jl, tl)):
        j = np.asarray(j, np.float32)
        t = t.to(torch.float32).numpy()
        assert np.abs(j - t).max() <= MARGIN / 2
        top2 = np.sort(j, axis=-1)[:, -2:]
        for i in range(3):
            clear = top2[i, 1] - top2[i, 0] > MARGIN
            assert int(np.argmax(j[i])) == forced[i, step]
            if clear:
                assert int(np.argmax(t[i])) == forced[i, step]
            # the free-running port follows the reference until a near-tie
            diverged[i] |= not clear
            if not diverged[i]:
                assert port[i].tokens[step] == forced[i, step]


class _Counter:
    """A stand-in model: the next token is (3·token + pos + 1) mod V,
    as one-hot logits; its only state is the last token."""

    V = 16

    class cfg:
        rwkv = True
        family = "ssm"


class _JCounter(_Counter):
    def needs_context(self):
        return False

    def init_cache(self, batch, seq_len):
        return jnp.zeros((batch,), jnp.int32)

    def decode_step(self, params, cache, tokens, pos):
        nxt = (3 * tokens[:, 0] + pos + 1) % self.V
        return 10.0 * jax.nn.one_hot(nxt, self.V)[:, None], cache


class _TCounter(_Counter):
    device = torch.device("cpu")

    def init_cache(self, batch, seq_len):
        return torch.zeros((batch,), dtype=torch.int32)

    def decode_step(self, params, cache, tokens, pos):
        nxt = (3 * tokens[:, 0].long() + pos + 1) % self.V
        return 10.0 * torch.nn.functional.one_hot(nxt, self.V)[:, None], cache


@pytest.mark.parametrize("eos", [None, 0, 9, 13, "first"])
def test_stopping_rules_match_reference(eos):
    """Per-request budgets and EOS, including an EOS that is the first
    token (the reference does not check the first token for EOS)."""
    prompts = [np.asarray(p, np.int32) for p in ([1, 2], [7], [3, 3, 3])]
    budgets = [1, 4, 9]
    if eos == "first":
        eos = (3 * 3 + 2 + 1) % 16          # request 2's first token
    ref = JEngine(_JCounter(), None).generate(
        [JRequest(i, p, n, eos) for i, (p, n) in
         enumerate(zip(prompts, budgets))])
    port = ServingEngine(_TCounter(), None, device="cpu").generate(
        [GenerationRequest(i, p, n, eos) for i, (p, n) in
         enumerate(zip(prompts, budgets))])
    assert [(c.request_id, c.tokens, c.finished_by) for c in port] == \
        [(c.request_id, c.tokens, c.finished_by) for c in ref]
    assert all(len(c.tokens) <= n for c, n in zip(port, budgets))
    if eos is not None:
        assert any(c.finished_by == "eos" for c in port)
    with pytest.raises(ValueError, match="at least one request"):
        ServingEngine(_TCounter(), None, device="cpu").generate([])


def test_serve_batch_matches_engine():
    prompts = [[1, 2, 3], [4]]
    out = serve_batch(_TCounter(), None, prompts, max_new_tokens=5,
                      device="cpu")
    ref = [c.tokens for c in JEngine(_JCounter(), None).generate(
        [JRequest(i, np.asarray(p, np.int32), 5)
         for i, p in enumerate(prompts)])]
    assert out == ref


def _reference_kept(logits, cfg, monkeypatch):
    """The tokens the reference's sample_token may draw: the finite
    entries of the logits it hands to ``jax.random.categorical``."""
    seen = {}

    def categorical(key, filtered):
        seen["logits"] = np.asarray(filtered)
        return jnp.argmax(filtered, axis=-1)

    with monkeypatch.context() as mp:
        mp.setattr(jsampler.jax.random, "categorical", categorical)
        jsampler.sample_token(jnp.asarray(logits), jax.random.key(0),
                              JSamplerConfig(*cfg))
    return np.isfinite(seen["logits"])


@pytest.mark.parametrize("cfg", [(1.0, 3, 1.0), (0.7, 0, 0.5),
                                 (1.0, 5, 0.8), (1.5, 0, 1.0),
                                 (0.5, 1, 1.0)])
def test_sample_token_draws_inside_reference_kept_set(cfg, monkeypatch):
    logits = 2.0 * np.random.default_rng(8).normal(size=(8, 40))
    logits = logits.astype(np.float32)
    kept = _reference_kept(logits, cfg, monkeypatch)
    gen = torch.Generator().manual_seed(0)
    t = torch.from_numpy(logits)
    draws = np.stack([sample_token(t, gen, SamplerConfig(*cfg)).numpy()
                      for _ in range(300)], axis=1)           # (8, 300)
    assert draws.dtype == np.int32
    for i in range(8):
        assert kept[i, draws[i]].all()
        assert kept[i, np.argmax(logits[i])]
        if kept[i].sum() >= 2:   # it samples, and not only the argmax
            assert len(set(draws[i])) >= 2


def test_greedy_sample_is_reference_argmax():
    logits = np.random.default_rng(9).normal(size=(4, 50)).astype(np.float32)
    port = sample_token(torch.from_numpy(logits), None, SamplerConfig())
    ref = jsampler.sample_token(jnp.asarray(logits), jax.random.key(0),
                                JSamplerConfig())
    assert port.dtype == torch.int32
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_sampled_generation_is_seeded():
    _, _, m, tp = _models()
    req = [GenerationRequest(0, np.arange(5, dtype=np.int32), 6)]
    cfg = SamplerConfig(temperature=1.0, top_k=20)
    a = ServingEngine(m, tp, cfg, seed=3, device="cpu").generate(req)
    b = ServingEngine(m, tp, cfg, seed=3, device="cpu").generate(req)
    assert a[0].tokens == b[0].tokens and len(a[0].tokens) == 6
