"""The plain reference against the program (``repro_torch``) on the CPU
at a reduced size. The program runs its CPU path (the kernels' plain
versions) with its compute dtype set to float32 for these tests, so the
two agree to float32 rounding; only this file imports the program."""

import numpy as np
import pytest
import torch

from perfbench.harness import weights as W
from perfbench.reference import chain as ref_chain
from perfbench.reference import pofel as ref_pofel
from perfbench.reference import transformer as ref_tf

AUDIO = dict(name="tiny-audio", reference="transformer", family="audio",
             n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
             d_ff=96, vocab_size=97, cross_attn_every=1, n_context_tokens=5,
             norm_eps=1e-5, rope_theta=10000.0)


@pytest.fixture
def fp32_program(monkeypatch):
    """The program's models with float32 activations."""
    from repro_torch.models import model_api, transformer
    for mod in (model_api, transformer):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
    from repro_torch.models.config import ArchConfig
    from repro_torch.models.model_api import Model

    def model(arch):
        fields = ArchConfig.__dataclass_fields__
        return Model(ArchConfig(**{k: v for k, v in arch.items()
                                   if k in fields}), device="cpu")
    return model


def _f32(tree):
    return {k: _f32(v) if isinstance(v, dict) else v.to(torch.float32)
            for k, v in tree.items()}


def _batch(arch, B=2, S=21, seed=0):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, arch["vocab_size"], (B, S + 1), generator=g)
    ctx = torch.randn((B, arch["n_context_tokens"], arch["d_model"]),
                      generator=g).to(torch.bfloat16)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "context": ctx}


def _perturb(params, seed=1):
    """Weights off their init constants (the norms' ones), so every
    leaf's gradient is exercised."""
    g = torch.Generator().manual_seed(seed)
    return {k: _perturb(v, seed + 1) if isinstance(v, dict) else
            v + 0.05 * torch.randn(v.shape, generator=g).to(v.dtype)
            for k, v in params.items()}


@pytest.mark.parametrize("seed", [3, 4])
def test_loss_and_gradients_match_program(fp32_program, seed):
    arch = AUDIO
    model = fp32_program(arch)
    params = _f32(_perturb(W.make_weights(arch, seed, "cpu")))
    batch = _batch(arch, seed=seed)
    loss, grads = ref_tf.loss_and_grads(params, batch, arch)

    def f(p):
        return model.loss(p, batch, None, 0.0)

    want_g, want = torch.func.grad_and_value(f)(params)
    assert abs(float(loss) - float(want)) < 1e-5 * abs(float(want))
    got, exp = W.flatten(grads), W.flatten(want_g)
    assert sorted(got) == sorted(exp)
    # every leaf is held to its own scale or the median leaf's
    med = float(np.median([float(t.abs().max()) for t in exp.values()]))
    for path in exp:
        scale = max(float(exp[path].abs().max()), med)
        err = float((got[path] - exp[path]).abs().max())
        assert err <= 2e-4 * scale, (path, err, scale)


@pytest.mark.parametrize("apart", [False, True],
                         ids=["from-global", "replicas-apart"])
def test_round_matches_program(fp32_program, apart):
    """FedSGD, Eq. 1, Eq. 2 and the tally of one round against
    ``pofel_round`` (float32 leaves, so both keep every update), the
    clusters starting from the global model or from replicas apart."""
    from repro_torch.core.btsv import BTSVConfig, init_history
    from repro_torch.fl import pofel_trainer as pt
    arch, C = AUDIO, 3
    model = fp32_program(arch)
    params = _f32(_perturb(W.make_weights(arch, 5, "cpu")))
    batches = [_batch(arch, B=2, S=13, seed=s) for s in range(C)]
    pofel = {"g_max": 0.99, "btsv": dict(BTSVConfig()._asdict())}
    tcfg = pt.PoFELTrainConfig(n_clusters=C, inner_lr=0.5)
    start = W.diverged(params, 6, C, 0.05) if apart else None
    replicas = start if apart else {
        p: t[None].expand(C, *t.shape)
        for p, t in W.flatten(params).items()}
    state = pt.PoFELTrainState(
        W.nest(replicas), params, None, init_history(C),
        torch.zeros((), dtype=torch.int32))
    stacked = {k: torch.stack([b[k] for b in batches])
               for k in batches[0]}
    new, m = pt.pofel_round(model, state, stacked, torch.ones(C), tcfg,
                            None)
    gw, out = ref_pofel.fedsgd_round(None if apart else params, batches,
                                     ref_tf.loss_and_grads, arch, 0.5,
                                     ref_pofel.Products(), start)
    if apart:   # the spread sets the similarities apart
        assert np.ptp(out.sims) > 1e-4
    np.testing.assert_allclose(out.losses, m.loss.numpy(), rtol=1e-5)
    for path, t in W.flatten(new.global_params).items():
        torch.testing.assert_close(W.flatten(gw)[path], t, rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(out.sims, m.similarities.numpy(), atol=1e-6)
    votes = np.full(C, int(np.argmax(m.similarities.numpy())))
    t = ref_pofel.btsv_tally(votes, np.zeros((20, C)), pofel)
    np.testing.assert_allclose(t["weights"], m.vote_weights.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(t["scores"], m.scores.numpy(), atol=1e-6)
    assert t["leader"] == int(m.leader)


def test_chain_checks_accept_the_programs_blocks_and_catch_a_change():
    from dataclasses import asdict
    from repro_torch.blockchain.ledger import Ledger
    from repro_torch.core import crypto
    from repro_torch.fl.pofel_trainer import ConsensusMetrics
    from repro_torch.launch.train import append_round_block
    seed = b"perfbench-7"
    kp = crypto.ECDSAKeyPair.generate(seed)
    pk = ref_chain.public_key(seed)
    assert pk == (kp.public_key[0], kp.public_key[1])
    ledger = Ledger(0)
    recs = []
    for k in range(3):
        sims = np.array([0.9, 0.95 + 0.01 * k, 0.93], np.float32)
        wv = np.full(3, 1.008, np.float32)
        m = ConsensusMetrics(torch.zeros(3), torch.from_numpy(sims),
                             torch.tensor(1), torch.from_numpy(wv),
                             torch.zeros(3))
        append_round_block(ledger, kp, k, m)
        recs.append((sims, wv))
    prev = ref_chain.GENESIS
    for k, b in enumerate(ledger.blocks):
        d = asdict(b)
        sims, wv = recs[k]
        exp = ref_chain.expected_fields(k, sims, 1, wv)
        assert ref_chain.check_block(d, k, prev, pk, exp) == []
        prev = ref_chain.block_hash(d)
    d = asdict(ledger.blocks[1])
    d["vote_weights"] = {**d["vote_weights"], 0: 1.5}
    assert ref_chain.check_block(d, 1, ref_chain.block_hash(
        asdict(ledger.blocks[0])), pk, {})
