"""The mesh levers of the port (``FwdOptions``' ``seq_shard_axis``,
``parallel_q``, ``gather_kv``, ``weight_gather``, ``expert_axis``;
``PoFELTrainConfig.cluster_axis``) against the reference's, on the CPU,
in one process.

* The PoFEL round as a DTensor step (``launch.specs`` on
  ``make_host_mesh("cpu")``, a world-size-1 gloo group) under the zero3
  options (C = 2 over ``data``, every lever on) and the sp_attn options
  (C = 4), for the six families (reduced), against the reference's
  ``pofel_round`` under ``jax.make_mesh((1, 1), ("data", "model"))``
  with Auto axes and the same options. On one device every pin is a
  layout and changes no number. XLA:CPU refuses the reference's
  ``parallel_q`` in bfloat16 ("Unsupported element type for
  DotThunk::Execute: BF16 x BF16 = F32"), so the reference runs those
  rounds with it off and the port with it on (the query blocks at once,
  ``layers.parallel_q_attention``). Both start from the reference's
  initial state with replicas made to differ (seeded noise, as
  ``tests/test_torch_pofel_trainer.py``) and take the same batch.
  Tolerances are that file's: losses within 5e-2, weights within rtol
  1e-2 / atol 1e-3, similarities within 1e-4 of Eq. 2 in float64 on the
  reference's own replicas and aggregate, the reference's leader where
  the top two are clear. The weights are also held to the port's own
  round without levers on plain tensors (the same rule). The reduced
  RWKV-6's bfloat16 round is ill-conditioned (``tests/test_torch_lm_round.py``;
  traced in ``tests/test_torch_rwkv6_grad_parity.py``: the group norm of
  the recurrence's first nonzero output, where a head's variance falls
  below its eps, turns rounding into gradient): the port's round without
  levers already lies outside the weight rule of the reference's (u in
  71 elements, up to 0.0104; embed in 4, up to 0.0017; a CPU
  measurement), so for it the reference's round with levers is held to
  the reference's without, and the port's to the port's, each by the
  weight rule.
* ``parallel_q`` in float32 against the reference's
  ``blockwise_attention(parallel_q=True)`` at ``tests/test_layers_moe.py``'s
  shapes (the kernel tolerances, rtol 2e-5 / atol 2e-6), and in bfloat16
  against the port's own attention (its flash op's plain version; 2e-2).
* The MoE ``scatter`` combine against ``gather``: results and gradients
  bit for bit in float32, as the reference pins its two modes, and
  against the reference's ``scatter``.
* Mamba2 ``sharded=True`` identical to ``sharded=False``, on plain
  tensors and on DTensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_config as j_get_config
from repro.fl import pofel_trainer as jpt
from repro.models import moe as jmoe
from repro.models.layers import blockwise_attention as j_blockwise
from repro.models.model_api import Model as JModel
from repro.models.transformer import FwdOptions as JFwdOptions
from repro_torch.configs.shapes import InputShape
from repro_torch.core.serialization import leaves_with_paths
from repro_torch.fl import pofel_trainer as pt
from repro_torch.launch import mesh as tmesh, specs
from repro_torch.launch.mesh_check import reduced_configs
from repro_torch.models import layers, mamba2, moe as tmoe
from repro_torch.models.transformer import FwdOptions

ARCHS = ["yi-6b", "deepseek-moe-16b", "rwkv6-1.6b", "zamba2-7b",
         "musicgen-medium", "llama-3.2-vision-90b"]
ILL_CONDITIONED = ("rwkv6-1.6b",)
LOSS_TOL = 5e-2
WEIGHT_TOL = dict(rtol=1e-2, atol=1e-3)
SIM_ATOL = 1e-4
FP32 = dict(rtol=2e-5, atol=2e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)
B, S = 2, 16
DIVERGE = np.array([0.15, 0.03, 0.09, 0.21], np.float32)
LEVERS = dict(seq_shard_axis="model", remat=True, gather_kv=True)
PROFILES = {
    # profile: (C, cluster_axis, the port's options)
    "zero3": (2, "data", FwdOptions(dp_axes=(), parallel_q=True,
                                    weight_gather=True, expert_axis="model",
                                    **LEVERS)),
    "sp_attn": (4, None, FwdOptions(dp_axes=("data",), parallel_q=True,
                                    **LEVERS)),
}


def _reference_options(opts: FwdOptions) -> JFwdOptions:
    """The same options for the reference, parallel_q off (XLA:CPU)."""
    return JFwdOptions(**{**opts._asdict(), "parallel_q": False})


@pytest.fixture(scope="module")
def host_mesh():
    """The 1 × 1 gloo mesh, the port's side on one CPU thread."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tmesh.make_host_mesh("cpu")
    dist.destroy_process_group()
    torch.set_num_threads(n)


def _diverged(cluster_params, C, seed=1):
    """Seeded noise on every replica: relative size DIVERGE[c] of the
    leaf's rms (at least 1e-2), added in float32, in the leaf's dtype."""
    rng = np.random.default_rng(seed)

    def leaf(x):
        x32 = np.asarray(x, np.float32)
        rms = max(float(np.sqrt(np.mean(x32[0] ** 2))), 1e-2)
        scale = (DIVERGE[:C] * rms).reshape((-1,) + (1,) * (x32.ndim - 1))
        noise = rng.standard_normal(x32.shape, dtype=np.float32)
        return jnp.asarray(x32 + scale * noise).astype(x.dtype)
    return jax.tree.map(leaf, cluster_params)


def _eq2_64(replicas, gw, C):
    """Eq. 2 in float64 on the reference's replicas and aggregate."""
    W = np.concatenate([np.asarray(w, np.float64).reshape(C, -1)
                        for w in jax.tree.leaves(replicas)], axis=1)
    g = np.concatenate([np.asarray(x, np.float64).reshape(-1)
                        for x in jax.tree.leaves(gw)])
    return (W @ g) / (np.linalg.norm(W, axis=1) * np.linalg.norm(g))


@pytest.mark.parametrize("profile", ["zero3", "sp_attn"])
@pytest.mark.parametrize("arch", ARCHS)
def test_round_with_levers_matches_the_reference(host_mesh, arch, profile):
    C, axis, opts = PROFILES[profile]
    jm = JModel(j_get_config(arch).reduced())
    jcfg = jpt.PoFELTrainConfig(n_clusters=C, inner_lr=1e-2,
                                cluster_axis=axis)
    tcfg = pt.PoFELTrainConfig(n_clusters=C, inner_lr=1e-2,
                               cluster_axis=axis)
    js = jax.jit(lambda key: jpt.init_train_state(jm, jcfg, key))(
        jax.random.key(0))
    js = js._replace(cluster_params=_diverged(js.cluster_params, C))
    rng = np.random.default_rng(0)
    tok = rng.integers(0, 500, (C, B, S)).astype(np.int32)
    lab = rng.integers(0, 500, (C, B, S)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    tb = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
    if jm.needs_context():
        shape = (C, B, jm.cfg.n_context_tokens, jm.cfg.d_model)
        jb["context"] = 0.1 * jnp.ones(shape, jnp.bfloat16)
        tb["context"] = 0.1 * torch.ones(shape, dtype=torch.bfloat16)
    lam = np.array([1.0, 2.0, 3.0, 4.0][:C], np.float32)
    j_opts = _reference_options(opts)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)

    plain_cfg = jpt.PoFELTrainConfig(n_clusters=C, inner_lr=1e-2)

    @jax.jit
    def reference(state, batch):
        local = jpt.local_step(jm, state.cluster_params, batch, jcfg,
                               j_opts)[0]
        return local, jpt.pofel_round(jm, state, batch, jnp.asarray(lam),
                                      jcfg, j_opts)

    with mesh:
        ref_local, (ref_state, ref_m) = jax.tree.map(np.asarray,
                                                     reference(js, jb))

    with reduced_configs():
        setup = specs.build_train_setup(
            arch, host_mesh, InputShape("mini_train", S, B * C, "train"),
            tcfg, opts, profile=profile)
    ts = pt.train_state_from_jax(jax.tree.map(np.asarray, js), setup.model)
    args = [specs.distribute_like(v, a) for v, a in
            zip((ts, tb, torch.from_numpy(lam)), setup.abstract_args)]
    state, metrics = setup.step(*args)
    plain, _ = pt.pofel_round(setup.model, ts, tb, torch.from_numpy(lam),
                              pt.PoFELTrainConfig(n_clusters=C,
                                                  inner_lr=1e-2),
                              FwdOptions(remat=True))

    np.testing.assert_allclose(metrics.loss.numpy(), ref_m.loss,
                               atol=LOSS_TOL)
    port = [a.full_tensor().float().numpy()
            for _, a in leaves_with_paths(state.global_params)]
    pairs = [(port, [a.float().numpy() for _, a in
                     leaves_with_paths(plain.global_params)])]
    if arch in ILL_CONDITIONED:
        ref_plain = jax.jit(lambda st, b: jpt.pofel_round(
            jm, st, b, jnp.asarray(lam), plain_cfg,
            JFwdOptions(remat=True))[0])(js, jb)
        pairs.append((jax.tree.leaves(ref_state.global_params),
                      jax.tree.leaves(ref_plain.global_params)))
    else:
        pairs.append((port, jax.tree.leaves(ref_state.global_params)))
    paths = [p for p, _ in leaves_with_paths(state.global_params)]
    for got, want in pairs:
        for path, a, b in zip(paths, got, want):
            np.testing.assert_allclose(np.asarray(a, np.float32),
                                       np.asarray(b, np.float32),
                                       err_msg=path, **WEIGHT_TOL)
    sims64 = _eq2_64(ref_local, ref_state.global_params, C)
    top = np.sort(sims64)[::-1]
    assert top[0] - top[-1] > 10 * SIM_ATOL, sims64
    np.testing.assert_allclose(metrics.similarities.numpy(), sims64,
                               rtol=0, atol=SIM_ATOL)
    if top[0] - top[1] > 2 * SIM_ATOL:
        assert int(metrics.leader) == int(ref_m.leader) == int(
            np.argmax(sims64))
    np.testing.assert_allclose(state.btsv_history.full_tensor().numpy(),
                               ref_state.btsv_history, atol=1e-4)


# ---------------------------------------------------------------------------
# parallel_q
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("shape", [(1, 64, 2, 8), (2, 300, 4, 16)])
def test_parallel_q_float32_matches_the_reference(shape, window):
    Bq, Sq, H, hd = shape
    r = np.random.default_rng(Sq + window)
    q = r.normal(size=shape).astype(np.float32)
    k = r.normal(size=(Bq, Sq, 2, hd)).astype(np.float32)
    v = r.normal(size=(Bq, Sq, 2, hd)).astype(np.float32)
    want = j_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=True, window=window, q_block=64, kv_block=128,
                       parallel_q=True)
    got = layers.blockwise_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, window=window, q_block=64, kv_block=128,
        parallel_q=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


@pytest.mark.parametrize("s,qb,kb", [(3, 16, 32), (67, 64, 32),
                                     (130, 16, 64)])
def test_parallel_q_ragged_blocks_match_the_reference(s, qb, kb):
    """The reference's property cases: sequence lengths that no block
    divides (padded queries and keys)."""
    r = np.random.default_rng(s)
    q, k, v = (r.normal(size=(1, s, 2, 8)).astype(np.float32)
               for _ in range(3))
    want = j_blockwise(*map(jnp.asarray, (q, k, v)), q_block=qb,
                       kv_block=kb, parallel_q=True)
    got = layers.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                     q_block=qb, kv_block=kb,
                                     parallel_q=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


@pytest.mark.parametrize("causal,window,skv", [(True, 0, 96),
                                               (True, 32, 96),
                                               (False, 0, 40)])
def test_parallel_q_bfloat16_matches_the_port_attention(causal, window,
                                                        skv):
    """bfloat16 at a model's head dim, GQA, keys of their own length for
    cross-attention: the query blocks at once against the flash op's
    plain version (2e-2), and their gradients by the bfloat16 rule of
    ``tests/test_torch_kernels_cuda.py`` (relative to each gradient's
    scale s = max |g|: largest difference at most 0.125 s, mean at most
    0.02 s), since two bfloat16 backward passes round apart."""
    g = torch.Generator().manual_seed(skv + window)
    q = torch.randn(2, 96, 4, 32, generator=g).to(torch.bfloat16)
    k, v = (torch.randn(2, skv, 2, 32, generator=g).to(torch.bfloat16)
            for _ in range(2))
    outs, grads = [], []
    for parallel_q in (True, False):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        o = layers.blockwise_attention(*ins, causal=causal, window=window,
                                       q_block=32, kv_block=64,
                                       parallel_q=parallel_q)
        grads.append(torch.autograd.grad((o.float() ** 2).sum(), ins))
        outs.append(o)
    torch.testing.assert_close(outs[0], outs[1], **BF16)
    for a, b in zip(*grads):
        scale = float(b.float().abs().max())
        diff = (a.float() - b.float()).abs()
        assert float(diff.max()) <= 0.125 * scale
        assert float(diff.mean()) <= 0.02 * scale


# ---------------------------------------------------------------------------
# the MoE combine modes
# ---------------------------------------------------------------------------

def _moe_params(seed, E, D=16, F=32):
    r = np.random.default_rng(seed)
    return {"router": r.normal(size=(D, E)).astype(np.float32),
            "w_gate": (0.1 * r.normal(size=(E, D, F))).astype(np.float32),
            "w_up": (0.1 * r.normal(size=(E, D, F))).astype(np.float32),
            "w_down": (0.1 * r.normal(size=(E, F, D))).astype(np.float32)}


@pytest.mark.parametrize("E,T", [(8, 64), (4, 32)])
def test_moe_scatter_combine_is_gather_bit_for_bit(E, T):
    p = _moe_params(E, E)
    x = np.random.default_rng(T).normal(size=(T, 16)).astype(np.float32)
    cfg = tmoe.MoEConfig(E, 2)
    outs, grads = {}, {}
    for mode in ("gather", "scatter"):
        tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
        xt = torch.from_numpy(x).requires_grad_()
        o, aux = tmoe.moe_ffn(xt, tp, cfg, combine=mode)
        outs[mode] = (o, aux)
        grads[mode] = torch.autograd.grad((o ** 2).sum() + 0.01 * aux,
                                          [xt, *tp.values()])
    assert torch.equal(outs["gather"][0], outs["scatter"][0])
    assert torch.equal(outs["gather"][1], outs["scatter"][1])
    for a, b in zip(grads["gather"], grads["scatter"]):
        assert torch.equal(a, b)
    jo, _ = jmoe.moe_ffn(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                         jmoe.MoEConfig(E, 2), combine="scatter")
    np.testing.assert_allclose(outs["scatter"][0].detach().numpy(),
                               np.asarray(jo), **FP32)


def test_expert_axis_takes_the_scatter_combine(host_mesh):
    """``expert_axis`` on DTensors of the 1 × 1 mesh pins the expert
    buffers and combines by scatter: the plain scatter's bits."""
    from torch.distributed.tensor import distribute_tensor, Replicate
    p = _moe_params(3, 4)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(32, 16)).astype(np.float32))
    cfg = tmoe.MoEConfig(4, 2)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    want, _ = tmoe.moe_ffn(x, tp, cfg, combine="scatter")
    rep = [Replicate(), Replicate()]
    got, _ = tmoe.moe_ffn(
        distribute_tensor(x, host_mesh, rep),
        {k: distribute_tensor(v, host_mesh, rep) for k, v in tp.items()},
        cfg, expert_axis="model", combine="scatter")
    assert torch.equal(got.full_tensor(), want)


# ---------------------------------------------------------------------------
# Mamba2 sharded=
# ---------------------------------------------------------------------------

def test_mamba2_sharded_is_unsharded(host_mesh):
    from torch.distributed.tensor import distribute_tensor, Replicate, Shard
    cfg = mamba2.Mamba2Config(64, d_state=16, head_dim=16)
    params = mamba2.mamba2_init(cfg, torch.Generator().manual_seed(0))
    x = torch.randn(2, 12, 64,
                    generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    want, wstate = mamba2.mamba2_apply(params, x, cfg)
    got, gstate = mamba2.mamba2_apply(params, x, cfg, sharded=True)
    assert torch.equal(want, got) and torch.equal(wstate.ssm, gstate.ssm)
    dparams = {k: distribute_tensor(v, host_mesh, [Replicate()] * 2)
               for k, v in params.items()}
    dx = distribute_tensor(x, host_mesh, [Shard(0), Replicate()])
    dout, dstate = mamba2.mamba2_apply(dparams, dx, cfg, sharded=True)
    assert torch.equal(dout.full_tensor(), want)
    assert torch.equal(dstate.ssm.full_tensor(), wstate.ssm)
