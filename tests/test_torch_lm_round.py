"""The LM workloads of a BHFL round in the port (``repro_torch.data.
tokens``, ``repro_torch.fl.adapters.LMAdapter``, ``run_bhfl(model=
"rwkv6" | "transformer")``) against the reference, on the CPU at the
reference's tiny configs (d_model 64, 2 layers, heads of 32).

Both packages get the same token data (numpy, bit for bit), the same
clusters and the reference's initial weights (``jax.random`` draws
cannot be reproduced in torch). Each comparison runs twice:

- with the models computing in float32 (``COMPUTE_DTYPE`` patched in
  both packages' model modules): the algorithm pin. One ``local_train``
  (two SGD steps) from float32 weights within rtol 1e-4 / atol 1e-5 of
  the reference's and the loss within 1e-4; two rounds (the bfloat16
  embed and head kept, so the SGD's promotion runs) with similarities
  within 1e-4 and test losses within 1e-3 (two float32 backends:
  observed ~1e-5 and ~1e-4). The tiny RWKV-6 is ill-conditioned at these
  weights: two float32 backends' gradients, 1e-5 apart (of a leaf's
  largest entry) at the first step, are 1e-4 apart at the second and 10 %
  at the third; likewise, over more rounds, the bfloat16 rounding of the
  adopted global model flips an ulp here and there and training carries
  it on (a third RWKV-6 round differs by 0.05 in test loss). CPU
  measurements.
- in the models' own bfloat16: dtypes equal, and the loss and round
  metrics within what bfloat16 gradients allow. XLA keeps float32
  between fused operations where torch rounds each one
  (tests/test_torch_rwkv6.py); for the tiny RWKV-6 both packages'
  bfloat16 gradients lie 1-28 % (of their largest entry) from the
  float32 gradient, the port's the closer in most leaves (a CPU
  measurement). So: one ``local_train`` with the loss within 5e-2, the
  dense transformer's weights within rtol 1e-2 / atol 1e-3 of the
  reference's, and the RWKV-6's held to the float32 trajectory as the
  arbiter (``_rwkv6_bf16_update_check``); two rounds with similarities within 1e-4 and test losses
  within 0.1 (observed 0.063 for RWKV-6).

Leaders are compared wherever the reference's top-2 similarity margin
exceeds the similarity tolerance (the tiny models' similarities are all
~1 - 1e-5, so often none is).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.ssm_models as j_ssm
import repro.models.transformer as j_tf
import repro_torch.models.ssm_models as t_ssm
import repro_torch.models.transformer as t_tf

from repro.configs import get_config as j_get_config
from repro.data.tokens import make_token_dataset as j_tokens
from repro.fl import adapters as jad
from repro.fl.client import Client as JClient
from repro.fl.hfl_runtime import BHFLConfig as JConfig
from repro.fl.hfl_runtime import BHFLRuntime as JRuntime
from repro.fl.hierarchy import build_hierarchy as j_build
from repro_torch import api
from repro_torch.configs import get_config
from repro_torch.data.tokens import make_token_dataset
from repro_torch.fl import adapters as tad
from repro_torch.fl.client import Client
from repro_torch.fl.hfl_runtime import BHFLConfig as TConfig
from repro_torch.fl.hfl_runtime import BHFLRuntime as TRuntime
from repro_torch.fl.hierarchy import build_hierarchy as t_build
from repro_torch.kernels import ops
from repro_torch.models.ssm_models import (hybrid_params_from_jax,
                                           rwkv_params_from_jax)
from repro_torch.models.transformer import transformer_params_from_jax

SIM_ATOL = 1e-4
FAMILIES = ["rwkv6", "transformer"]
LOSS_TOL = {"float32": dict(train=1e-4, test=1e-3),
            "bfloat16": dict(train=5e-2, test=0.1)}


@pytest.fixture(params=["float32", "bfloat16"])
def compute(request, monkeypatch):
    """The models' compute dtype in both packages; the reference's jitted
    SGD step is traced anew on each side of the patch."""
    patched = request.param == "float32"
    if patched:
        for mod in (j_ssm, j_tf):
            monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
        for mod in (t_ssm, t_tf):
            monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
        jad._lm_sgd_step.clear_cache()
    yield request.param
    if patched:
        jad._lm_sgd_step.clear_cache()


def _adapters(family, vocab):
    j = {"rwkv6": jad.rwkv6_adapter,
         "transformer": jad.transformer_adapter}[family](vocab_size=vocab)
    t = {"rwkv6": tad.rwkv6_adapter,
         "transformer": tad.transformer_adapter}[family](vocab_size=vocab,
                                                           device="cpu")
    return j, t


def _port_params(family, jparams, cfg):
    npp = jax.tree.map(np.asarray, jparams)
    load = (rwkv_params_from_jax if family == "rwkv6"
            else transformer_params_from_jax)
    return load(npp, cfg, device="cpu")


def _flat_np(tree):
    """{"a/b": float32 array} of a port or reference parameter tree."""
    return {k: (v.float().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v, np.float32))
            for k, v in tad._flat(tree).items()}


@pytest.mark.parametrize("n,seq,vocab,seed", [(256, 16, 256, 0),
                                              (64, 16, 64, 3),
                                              (9, 5, 7, 11)])
def test_token_data_and_batch_order_bit_equal(n, seq, vocab, seed):
    jtr, jte = j_tokens(n, seq, vocab, seed=seed)
    ttr, tte = make_token_dataset(n, seq, vocab, seed=seed)
    np.testing.assert_array_equal(ttr.tokens, jtr.tokens)
    np.testing.assert_array_equal(tte.tokens, jte.tokens)
    assert ttr.tokens.dtype == np.int32 and ttr.vocab_size == vocab
    assert len(ttr) == n and ttr.seq_len == seq
    for bs, s in ((8, 0), (3, 5)):
        got = list(ttr.batches(bs, seed=s))
        want = list(jtr.batches(bs, seed=s))
        assert len(got) == len(want) == n // bs
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["tokens"], w["tokens"])
            np.testing.assert_array_equal(g["labels"], w["labels"])
    sub = np.array([4, 1, 2])
    np.testing.assert_array_equal(ttr.subset(sub).tokens,
                                  jtr.subset(sub).tokens)
    with pytest.raises(ValueError, match="batch_size must be positive"):
        next(ttr.batches(0))


@pytest.mark.parametrize("family", FAMILIES)
def test_local_train_matches_reference(family, compute):
    """One client of 16 rows, batch 8: two SGD steps from the
    reference's init (the first promotes the bfloat16 leaves, the second
    their momentum); bfloat16 leaves come out float32 in both."""
    jtr, _ = j_tokens(16, 16, 64, seed=5)
    ttr, _ = make_token_dataset(16, 16, 64, seed=5)
    ja, ta = _adapters(family, 64)
    jp = ja.init(jax.random.key(1))
    tp = _port_params(family, jp, ta.arch)
    if compute == "float32":     # every leaf too: no bfloat16 rounding
        jp = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
        tp = _tree_float(tp)
    jout, jloss = ja.local_train(jp, JClient(0, jtr), seed=7)
    before = {k: v.clone() for k, v in tad._flat(tp).items()}
    tout, tloss = ta.local_train(tp, Client(0, ttr), seed=7)
    assert abs(tloss - jloss) <= LOSS_TOL[compute]["train"]
    jf, tf, j0 = _flat_np(jout), _flat_np(tout), _flat_np(jp)
    assert set(jf) == set(tf)
    if compute == "bfloat16" and family == "rwkv6":
        _rwkv6_bf16_update_check(ta, tp, ttr, jf, tf, j0)
    for k in jf:
        if compute == "float32":
            np.testing.assert_allclose(tf[k], jf[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        elif family == "transformer":
            np.testing.assert_allclose(tf[k], jf[k], rtol=1e-2, atol=1e-3,
                                       err_msg=k)
    assert {k: str(v.dtype).removeprefix("torch.")
            for k, v in tad._flat(tout).items()} == \
        {k: str(v.dtype) for k, v in tad._flat(jout).items()}
    # the caller's params are untouched
    for k, v in tad._flat(tp).items():
        assert torch.equal(v, before[k]), k


def _rwkv6_bf16_update_check(ta, tp, ttr, jf, tf, j0):
    """The tiny RWKV-6's bfloat16 weights against the float32 trajectory
    from the same start (the port in float32 compute, pinned to the
    reference above): every leaf's distance within 0.8 of the norm of its
    float32 update, and in all the port no farther than the reference
    (measured: the port 0.05-0.74 of a leaf's update, the reference
    0.08-1.03)."""
    orig = t_ssm.COMPUTE_DTYPE
    t_ssm.COMPUTE_DTYPE = torch.float32
    try:
        f32, _ = ta.local_train(_tree_float(tp), Client(0, ttr), seed=7)
    finally:
        t_ssm.COMPUTE_DTYPE = orig
    ff = _flat_np(f32)
    port = ref = 0.0
    for k in ff:
        step = np.linalg.norm(ff[k] - j0[k])
        dp = np.linalg.norm(tf[k] - ff[k])
        assert dp <= 0.8 * step, k
        port += dp ** 2
        ref += np.linalg.norm(jf[k] - ff[k]) ** 2
    assert port <= ref


def _tree_float(tree):
    return {k: _tree_float(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def _two_rounds(ja, ta, load, compute):
    """Two rounds of both packages from the reference's init (``load``
    carries it over): similarities, leaders where the margin is clear,
    test losses, the chains."""
    seed = 0
    jtr, jte = j_tokens(64, 16, 64, seed=seed)
    ttr, tte = make_token_dataset(64, 16, 64, seed=seed)
    common = dict(n_nodes=3, clients_per_node=2, fel_iterations=1,
                  seed=seed)
    jrt = JRuntime(j_build(jtr, 3, 2, "iid", seed=seed), JConfig(**common),
                   jte, adapter=ja)
    trt = TRuntime(t_build(ttr, 3, 2, "iid", seed=seed), TConfig(**common),
                   tte, adapter=ta, device="cpu")
    trt.global_params = load(jax.tree.map(np.asarray, jrt.global_params),
                             ta.arch, device="cpu")
    before = ops.launch_counts()
    for _ in range(2):
        mj, mt = jrt.run_round(), trt.run_round()
        sj = np.asarray(mj.consensus.similarities, np.float64)
        st = np.asarray(mt.consensus.similarities, np.float64)
        np.testing.assert_allclose(st, sj, rtol=0, atol=SIM_ATOL)
        top2 = np.sort(sj)[-2:]
        if top2[1] - top2[0] > SIM_ATOL:
            assert mt.leader_id == mj.leader_id
        assert abs(mt.test_loss - mj.test_loss) <= LOSS_TOL[compute]["test"]
        assert np.isfinite(mt.test_loss)
    for led in trt.consensus.ledgers:
        assert led.verify_chain() and led.height == 2
    assert ops.launch_counts() == before        # the CPU runs no kernel


@pytest.mark.parametrize("family", FAMILIES)
def test_two_lm_rounds_match_reference(family, compute):
    ja, ta = _adapters(family, 64)
    _two_rounds(ja, ta, rwkv_params_from_jax if family == "rwkv6"
                else transformer_params_from_jax, compute)


def _arch_adapters(name):
    """The reference's and the port's LMAdapter over the reduced
    ``name`` at d_model 64 and vocab 64 (heads of 32; Zamba2: one group of
    a Mamba2 block, 4 SSM heads of 32, and the shared block;
    DeepSeek-MoE: 4 experts top-2 and one shared expert)."""
    return (jad.LMAdapter(j_get_config(name).reduced(d_model=64, vocab=64)),
            tad.LMAdapter(get_config(name).reduced(d_model=64, vocab=64),
                          device="cpu"))


@pytest.mark.parametrize("name", ["zamba2-7b", "deepseek-moe-16b"])
def test_two_hybrid_and_moe_rounds_match_reference(name, compute):
    """``run_bhfl(model=LMAdapter(cfg))``'s rounds for the hybrid and MoE
    families on the loop, at the tolerances above. In bfloat16 an expert
    choice may flip with a rounding where the router's top-k margin is
    thin, which the test-loss tolerance covers."""
    ja, ta = _arch_adapters(name)
    _two_rounds(ja, ta, hybrid_params_from_jax if name == "zamba2-7b"
                else transformer_params_from_jax, compute)


def test_audio_rounds_match_reference_without_a_context(compute):
    """The reference's ``LMAdapter`` passes no context: an audio round
    (the reduced MusicGen) runs the self-attention only and leaves the
    cross-attention weights to their zero gradient and weight decay, as
    ``jax.grad`` does; a vlm round refuses in both packages."""
    ja, ta = _arch_adapters("musicgen-medium")
    _two_rounds(ja, ta, transformer_params_from_jax, compute)
    ttr, _ = make_token_dataset(16, 16, 64, seed=0)
    vlm = tad.LMAdapter(get_config("llama-3.2-vision-90b").reduced(
        d_model=64, vocab=64), device="cpu")
    params = vlm.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="needs its context"):
        vlm.local_train(params, Client(0, ttr))
    jvlm = jad.LMAdapter(j_get_config("llama-3.2-vision-90b").reduced(
        d_model=64, vocab=64))
    with pytest.raises(AssertionError):
        jvlm.local_train(jvlm.init(jax.random.key(0)),
                         JClient(0, j_tokens(16, 16, 64, seed=0)[0]))


def test_hybrid_batched_engine_matches_the_loop(monkeypatch):
    """The batched engine (``torch.func.vmap(vmap(grad))`` through the
    Mamba2 time loop and the shared block's attention) against the port's
    loop, everything in float32 on one CPU thread (the batched and the
    single products then round alike): a round's global model within
    rtol 1e-5 / atol 1e-6 (observed 3e-8), the leader equal where the
    similarity margin is clear of float32 rounding (1e-6). One round: in
    the second the two engines part by ~5e-4 in every LM family, the
    reference's own engines too (a CPU measurement of its tiny
    transformer), so the second round holds nothing of the hybrid."""
    monkeypatch.setattr(t_ssm, "COMPUTE_DTYPE", torch.float32)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ttr, tte = make_token_dataset(64, 16, 64, seed=0)
        ja, ta = _arch_adapters("zamba2-7b")
        start = _tree_float(hybrid_params_from_jax(
            jax.tree.map(np.asarray, ja.init(jax.random.key(0))), ta.arch,
            device="cpu"))
        runs = []
        for engine in ("reference", "batched"):
            rt = TRuntime(t_build(ttr, 3, 2, "iid", seed=0),
                          TConfig(n_nodes=3, clients_per_node=2,
                                  fel_iterations=1, seed=0, engine=engine),
                          tte, adapter=ta, device="cpu")
            rt.global_params = start
            assert rt.engine == engine
            runs.append([(rt.run_round(), tad._flat(rt.global_params))])
    finally:
        torch.set_num_threads(threads)
    for (mr, pr), (mb, pb) in zip(*runs):
        sims = np.asarray(mr.consensus.similarities, np.float64)
        np.testing.assert_allclose(mb.consensus.similarities, sims, rtol=0,
                                   atol=1e-6)
        top2 = np.sort(sims)[-2:]
        if top2[1] - top2[0] > 1e-6:
            assert mb.leader_id == mr.leader_id
        for k in pr:
            np.testing.assert_allclose(pb[k].numpy(), pr[k].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("family", FAMILIES)
def test_run_bhfl_lm_on_cpu(family):
    data = make_token_dataset(64, 16, 64)
    run = api.run_bhfl(model=family, device="cpu", n_nodes=3,
                       clients_per_node=2, fel_iterations=1, rounds=2,
                       data=data)
    assert run.chain_valid and run.chain_height == 2
    assert run.runtime.adapter.arch.vocab_size == 64
    assert isinstance(run.runtime.adapter, api.LMAdapter)
    assert all(np.isfinite(m.test_loss) for m in run.history)
    emb = run.runtime.global_params["embed"]
    assert emb.device.type == "cpu" and emb.shape == (64, 64)


def test_empty_client_shards_do_not_crash_training():
    """More clients than sequences leaves some shards empty; those clients
    contribute nothing instead of crashing batches(0)."""
    data = make_token_dataset(n_seqs=4, seq_len=8, vocab_size=32)
    run = api.run_bhfl(model="transformer", data=data, rounds=1, n_nodes=2,
                       clients_per_node=4, fel_iterations=1, device="cpu")
    assert run.chain_height == 1 and run.chain_valid
    assert np.isfinite(run.history[-1].test_loss)
    assert any(c.data_size == 0 for cl in run.runtime.clusters
               for c in cl.clients)
    ta = tad.transformer_adapter(vocab_size=32, device="cpu")
    with pytest.raises(ValueError, match="batch_size must be positive"):
        ta.local_train(run.runtime.global_params,
                       Client(9, data[0].subset(np.arange(0))))


def test_lm_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (tad.rwkv6_adapter, tad.transformer_adapter):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.run_bhfl(model="rwkv6", rounds=1)


def test_make_adapter_resolution():
    assert isinstance(tad.make_adapter("mlp", device="cpu"), tad.MLPAdapter)
    lm = tad.make_adapter("rwkv6", vocab_size=48, device="cpu")
    assert isinstance(lm, tad.LMAdapter) and lm.arch.vocab_size == 48
    assert lm.arch.rwkv and lm.arch.rwkv_head_size == 32
    assert isinstance(lm, tad.ModelAdapter)
    assert tad.make_adapter(lm) is lm
    assert (lm.batch_size, lm.lr, lm.momentum, lm.decay) == \
        (8, 1e-2, 0.9, 5e-4)
    with pytest.raises(ValueError, match="unknown model"):
        tad.make_adapter("cnn")
    with pytest.raises(TypeError):
        tad.make_adapter(3)
