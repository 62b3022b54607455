"""The port's serving launcher (``repro_torch.launch.serve``) against the
reference's (``repro.launch.serve``), on the CPU.

The port serves with the reference's own weights (its ``model.init``
under ``jax.random.key(seed)``, converted) and the same seeded prompts.
The greedy tokens the reference prints for req0/req1 are compared as
``tests/test_torch_serving.py`` compares: both models teacher-forced
along the reference's tokens, down the reference launcher's path, give
logits within MARGIN / 2; the reference's argmax is its printed token;
the port's argmax agrees wherever the reference's top-2 margin exceeds
MARGIN; and the port's own free run equals the reference's tokens until
the first step whose margin is under it.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch import serve as jserve
from repro.models.model_api import Model as JModel
from repro.models.transformer import FwdOptions as JFwdOptions
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models.model_api import Model
from repro_torch.models.ssm_models import rwkv_params_from_jax
from repro_torch.models.transformer import transformer_params_from_jax
from repro_torch.serving import grow_cache

MARGIN = 0.25         # twice the logits tolerance of the serving tests
BATCH, GEN, SEED = 4, 8, 0

# (arch, prompt length): a dense, a recurrent and a cross-attention family.
# The reference's ``grow`` pads the first cache axis of the prompt's
# extent, so its MusicGen serves neither at 16 (the context K/V's Nc) nor
# at 32 (their head dim); 24 is clear of both
CASES = [("starcoder2-3b", 16), ("rwkv6-1.6b", 16), ("musicgen-medium", 24)]


def _recurrent(cfg) -> bool:
    return cfg.rwkv or cfg.family == "hybrid"


def _printed_tokens(text: str) -> dict:
    return {int(m[1]): [int(t) for t in m[2].split(",")]
            for m in re.finditer(r"req(\d+): \[([0-9, ]+)\]", text)}


def _reference(arch: str):
    """The reference's model and weights (as its launcher makes them),
    and the port's params converted from those weights."""
    jm = JModel(j_get_config(arch).reduced())
    jp = jm.init(jax.random.key(SEED))
    npp = jax.tree.map(np.asarray, jp)
    cfg = get_config(arch).reduced()
    conv = rwkv_params_from_jax if cfg.rwkv else transformer_params_from_jax
    return jm, jp, conv(npp, cfg, device="cpu")


def _prompts(vocab: int, prompt_len: int) -> np.ndarray:
    return np.random.default_rng(SEED).integers(
        0, vocab, size=(BATCH, prompt_len)).astype(np.int32)


def _reference_forced(jm, jp, prompts, forced):
    """(B, n, V) float32 logits of the reference launcher's path fed
    ``forced`` (B, n): the eager prefill, its ``grow`` (or, recurrent, the
    prompt replayed through decode steps), then the jitted decode step,
    as ``repro.launch.serve.serve_reduced`` runs them. The replay is
    jitted here (the launcher's is eager, and recompiles its scans every
    step)."""
    B, P = prompts.shape
    n = forced.shape[1]
    toks = jnp.asarray(prompts)
    b = {"tokens": toks}
    if jm.needs_context():
        b["context"] = 0.1 * jnp.ones(jm.context_shape(B), jnp.float32)
    logits, cache = jm.prefill(jp, b, JFwdOptions(remat=False))

    def grow(leaf):
        for ax, s in enumerate(leaf.shape):
            if s == P and leaf.ndim >= 3:
                pad = [(0, 0)] * leaf.ndim
                pad[ax] = (0, n)
                return jnp.pad(leaf, pad)
        return leaf

    decode = jax.jit(jm.decode_step)
    if not _recurrent(jm.cfg):
        cache = jax.tree.map(grow, cache)
    else:
        cache = jm.init_cache(B, P + n)
        for i in range(P):
            logits, cache = decode(jp, cache, toks[:, i:i + 1],
                                   jnp.asarray(i, jnp.int32))
    out = [logits[:, -1]]
    for j in range(n - 1):
        logits, cache = decode(jp, cache, jnp.asarray(forced[:, j:j + 1]),
                               jnp.asarray(P + j, jnp.int32))
        out.append(logits[:, -1])
    return np.stack([np.asarray(x, np.float32) for x in out], 1)


def _port_forced(model, params, prompts, forced):
    """The same for the port's launcher path."""
    B, P = prompts.shape
    n = forced.shape[1]
    toks = torch.from_numpy(prompts)
    b = {"tokens": toks}
    if model.needs_context():
        b["context"] = model.stub_context(B)
    with torch.inference_mode():
        logits, cache = model.prefill(params, b)
        if not _recurrent(model.cfg):
            cache = grow_cache(cache, n)
        else:
            cache = model.init_cache(B, P + n)
            for i in range(P):
                logits, cache = model.decode_step(params, cache,
                                                  toks[:, i:i + 1], i)
        out = [logits[:, -1]]
        ft = torch.from_numpy(forced)
        for j in range(n - 1):
            logits, cache = model.decode_step(params, cache, ft[:, j:j + 1],
                                              P + j)
            out.append(logits[:, -1])
    return torch.stack(out, 1).to(torch.float32).numpy()


@pytest.mark.parametrize("arch,prompt_len", CASES)
def test_greedy_tokens_match_reference(arch, prompt_len, capsys):
    jm, jp, params = _reference(arch)
    jserve.serve_reduced(arch, BATCH, prompt_len, GEN, SEED, 0.0)
    ref_tokens = _printed_tokens(capsys.readouterr().out)
    run = serve.serve_reduced(arch, BATCH, prompt_len, GEN, SEED, 0.0,
                              device="cpu", params=params)
    printed = capsys.readouterr().out
    assert printed.startswith(f"arch={arch} reduced | prefill {prompt_len} "
                              f"toks × {BATCH} reqs: ")
    assert run.tokens.shape == (BATCH, GEN) and run.tokens.dtype == np.int32
    assert _printed_tokens(printed) == {r: run.tokens[r].tolist()
                                        for r in (0, 1)}
    assert sorted(ref_tokens) == [0, 1]

    model = Model(get_config(arch).reduced(), device="cpu")
    prompts = _prompts(model.cfg.vocab_size, prompt_len)
    # rows 2-3 are fed the port's tokens: rows do not mix in these models
    forced = run.tokens.copy()
    forced[:2] = [ref_tokens[0], ref_tokens[1]]
    j = _reference_forced(jm, jp, prompts, forced)
    t = _port_forced(model, params, prompts, forced)
    for i in (0, 1):
        assert np.abs(j[i] - t[i]).max() <= MARGIN / 2, (arch, i)
        diverged = False
        for step in range(GEN):
            top2 = np.sort(j[i, step])[-2:]
            clear = top2[1] - top2[0] > MARGIN
            assert int(np.argmax(j[i, step])) == forced[i, step]
            if clear:
                assert int(np.argmax(t[i, step])) == forced[i, step]
            # the free-running port follows the reference until a near-tie
            diverged |= not clear
            if not diverged:
                assert run.tokens[i, step] == forced[i, step], (arch, i, step)


@pytest.mark.parametrize("arch,batch,prompt_len", [
    ("starcoder2-3b", 4, 2),        # the reference pads the layer axis
    ("starcoder2-3b", 4, 4),        # ... the batch axis
    ("musicgen-medium", 4, 16),     # ... the context K/V's Nc axis
    ("musicgen-medium", 2, 32),     # ... the context K/V's head dim
])
def test_cache_grows_along_its_sequence_axis(arch, batch, prompt_len, capsys):
    run = serve.serve_reduced(arch, batch, prompt_len, 5, 1, 0.0,
                              device="cpu")
    vocab = get_config(arch).reduced().vocab_size
    assert run.tokens.shape == (batch, 5)
    assert ((run.tokens >= 0) & (run.tokens < vocab)).all()
    assert run.prefill_s > 0 and run.decode_s > 0


def test_reference_pads_the_wrong_axis_at_prompt_len_2():
    with pytest.raises((ValueError, TypeError)):
        jserve.serve_reduced("starcoder2-3b", 4, 2, 4, 0, 0.0)


def test_temperature_sampling_is_seeded(capsys):
    runs = [serve.serve_reduced("rwkv6-1.6b", 3, 6, 7, 5, 0.9,
                                device="cpu").tokens for _ in range(2)]
    np.testing.assert_array_equal(runs[0], runs[1])
    greedy = serve.serve_reduced("rwkv6-1.6b", 3, 6, 7, 5, 0.0, device="cpu")
    # the first token is the prefill's argmax, as in the reference
    np.testing.assert_array_equal(runs[0][:, 0], greedy.tokens[:, 0])
    assert not np.array_equal(runs[0], greedy.tokens)
    other = serve.serve_reduced("rwkv6-1.6b", 3, 6, 7, 6, 0.9, device="cpu")
    assert not np.array_equal(runs[0][:, 1:], other.tokens[:, 1:])


def test_main_runs_on_the_cpu_when_asked(capsys):
    serve.main(["--arch", "zamba2-7b", "--batch", "2", "--prompt-len", "5",
                "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("arch=zamba2-7b reduced | prefill 5 toks × 2 reqs")
    assert sorted(_printed_tokens(out)) == [0, 1]
    with pytest.raises(SystemExit):
        serve.main(["--arch", "mnist-mlp", "--device", "cpu"])


def test_main_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--gen", "2"])


def test_launch_and_optim_import_neither_jax_nor_reference():
    code = ("import sys; import repro_torch.launch.serve, "
            "repro_torch.optim, repro_torch.configs; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; print(bad); sys.exit(1 if bad else 0)")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    env = {**os.environ, "PYTHONPATH": src}
    done = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stdout + done.stderr
