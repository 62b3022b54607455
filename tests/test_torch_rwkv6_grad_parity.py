"""Where the reduced RWKV-6's float32 gradients of the two packages part,
and why (ROADMAP Queue 3 item 12), on the CPU.

Both packages compute in float32 (``COMPUTE_DTYPE`` patched, every leaf
float32) from the reference's initial weights on ``B, S = 2, 16`` tokens
drawn with ``np.random.default_rng(seed)``; a float64 evaluation of the
same model, written out below, is the arbiter.

* Walked layer by layer and op by op, each op of the port, given the
  reference's float32 inputs to that op, returns the reference's
  outputs at the kernel tolerance (rtol 2e-5 / atol 2e-6,
  ``tests/test_kernels.py``, atol taken of the op's largest entry where
  it exceeds 1): the token shift, the five lerps' projections and the
  decay ``w = exp(-exp(·))``, the recurrence (``wkv6_recurrence_ref``
  against ``repro.kernels.ref.wkv6_ref``) and its gradient
  (``wkv6_backward_ref`` against ``jax.vjp`` of the scan), the group
  norm, both mixes and the logits. No op parts by more than rounding,
  and neither side casts to bfloat16.
* The gradients part where the model is ill-conditioned. At init
  ``u = 0``, so the recurrence's first output is 0 and its second is
  rank one, ``o_1 = (r_1·k_0) v_0`` per head. Where ``r_1·k_0`` cancels
  (|c| ~ 1/300 of Σ|r_i k_i|), ``o_1``'s variance over the head falls
  below ``_group_norm``'s eps (64e-5) and the norm's output and its
  gradient follow ``|c|`` itself. That head (layer 0, batch 0, head 1
  at seed 0: variance 0.24 eps) turns half an ulp of ``r_1`` into up to
  4e-4 of a leaf's largest gradient entry; the same noise on any step
  from 3 on moves it by less than 1e-6.
* So at seed 0 the two packages' float32 gradients lie up to ~7e-4 of a
  leaf's largest entry apart (the gap ``tests/test_torch_remat.py`` and
  the lever tests record), the reference's 6.1e-4 from float64 and the
  port's 8.9e-5. At seeds whose first-step variances all exceed 10 eps
  both lie within 5e-5 of float64 and of each other. The gap is the
  reference's ``repro.models.rwkv6._group_norm`` amplifying float32
  rounding at that head, a property of the model at these weights, not
  a fault of either package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.models.model_api as j_api
import repro.models.rwkv6 as jr
import repro.models.ssm_models as j_ssm
import repro.models.transformer as j_tf
import repro_torch.models.model_api as t_api
import repro_torch.models.rwkv6 as tr
import repro_torch.models.ssm_models as t_ssm
import repro_torch.models.transformer as t_tf
from repro.configs import get_config as j_get_config
from repro.kernels.ref import wkv6_ref as j_wkv6_ref
from repro.models.layers import rms_norm as j_rms_norm
from repro.models.model_api import Model as JModel
from repro.models.transformer import FwdOptions as JFwdOptions
from repro_torch.configs import get_config
from repro_torch.core.serialization import leaves_with_paths
from repro_torch.kernels.ref import wkv6_backward_ref, wkv6_recurrence_ref
from repro_torch.models.layers import rms_norm
from repro_torch.models.model_api import Model
from repro_torch.models.params_io import tree_from_numpy
from repro_torch.models.transformer import FwdOptions

ARCH = "rwkv6-1.6b"
B, S = 2, 16
FP32 = dict(rtol=2e-5, atol=2e-6)
GN_EPS = 64e-5
ILL_SEED = 0               # a first-step head below the group norm's eps
WELL_SEEDS = (1, 7)        # every first-step head above 10 eps
HALF_ULP = 2.0 ** -24


@pytest.fixture(scope="module", autouse=True)
def float32_compute():
    mp = pytest.MonkeyPatch()
    for mod in (j_ssm, j_tf, j_api):
        mp.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
    for mod in (t_ssm, t_tf, t_api):
        mp.setattr(mod, "COMPUTE_DTYPE", torch.float32)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    mp.undo()


@pytest.fixture(scope="module")
def models():
    return _models()


def _models():
    cfg = j_get_config(ARCH).reduced()
    jm = JModel(cfg)
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      jm.init(jax.random.key(0)))
    tm = Model(get_config(ARCH).reduced(), device="cpu")
    spec = torch.utils._pytree.tree_map(
        lambda sd: (sd[0], torch.float32), tm.param_shapes(),
        is_leaf=lambda x: isinstance(x, tuple) and isinstance(x[0], tuple))
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), spec, "cpu")
    return cfg, jm, jp, tm, tp


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 500, (B, S)).astype(np.int32),
            "labels": rng.integers(0, 500, (B, S)).astype(np.int32)}


def _layer(tree, i):
    return {k: v[i] for k, v in tree["layers"].items()}


# ---------------------------------------------------------------------------
# the float64 arbiter
# ---------------------------------------------------------------------------

def _shift(x):
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _time_mix64(lp, h, K, nudge=None):
    Bh, Sh, D = h.shape
    H = D // K
    lerp = h[None] + (_shift(h) - h)[None] * lp["mu"][:, None, None, :]
    r, k, v, g = (lerp[i] @ lp[n] for i, n in
                  enumerate(("wr", "wk", "wv", "wg")))
    dd = torch.tanh(lerp[4] @ lp["w_lora_a"]) @ lp["w_lora_b"]
    w = torch.exp(-torch.exp(lp["w0"] + dd))
    if nudge is not None:
        r = nudge(r)
    r, k, v, w = (t.reshape(Bh, Sh, H, K) for t in (r, k, v, w))
    state = torch.zeros((Bh, H, K, K), dtype=h.dtype)
    outs = []
    for t in range(Sh):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 state + lp["u"][None, :, :, None] * kv))
        state = w[:, t, :, :, None] * state + kv
    o = torch.stack(outs, 1)
    o = (o - o.mean(-1, keepdim=True)) * torch.rsqrt(
        o.var(-1, keepdim=True, correction=0) + GN_EPS)
    o = o.reshape(Bh, Sh, D) * lp["ln_x"] * F.silu(g)
    return o @ lp["wo"], o


def _channel_mix64(lp, h):
    d = _shift(h) - h
    kk = torch.relu((h + d * lp["mu_ffn"][0]) @ lp["wk_ffn"]) ** 2
    rr = torch.sigmoid((h + d * lp["mu_ffn"][1]) @ lp["wr_ffn"])
    return rr * (kk @ lp["wv_ffn"])


def _rms64(x, gamma):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * gamma


def _loss64(params, tokens, labels, cfg, nudge=None, first_outputs=None):
    """The reduced RWKV-6's mean token cross entropy in float64;
    ``nudge(layer, r)`` may change each layer's r, and ``first_outputs``
    collects each layer's recurrence output before its group norm."""
    K = cfg.rwkv_head_size
    x = params["embed"][tokens]
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        tm, _ = _time_mix64(lp, _rms64(x, lp["norm1"]), K,
                            None if nudge is None
                            else (lambda r, i=i: nudge(i, r)))
        if first_outputs is not None:
            first_outputs.append(_recurrence_out64(lp, _rms64(
                x, lp["norm1"]), K))
        x = x + tm
        x = x + _channel_mix64(lp, _rms64(x, lp["norm2"]))
    logits = _rms64(x, params["final_norm"]) @ params["lm_head"]
    gold = logits.gather(-1, labels[..., None])[..., 0]
    return (torch.logsumexp(logits, -1) - gold).mean()


def _recurrence_out64(lp, h, K):
    """(B, S, H, K) recurrence output of one layer, before the norm."""
    Bh, Sh, D = h.shape
    lerp = h[None] + (_shift(h) - h)[None] * lp["mu"][:, None, None, :]
    r, k, v = (lerp[i] @ lp[n] for i, n in enumerate(("wr", "wk", "wv")))
    r, k, v = (t.reshape(Bh, Sh, D // K, K) for t in (r, k, v))
    # u = 0 at init: o_0 = 0 and o_1 = (r_1·k_0) v_0
    assert not lp["u"].any()
    return torch.einsum("bhk,bhk->bh", r[:, 1], k[:, 0])[..., None] * v[:, 0]


def _params64(tp):
    return torch.utils._pytree.tree_map(lambda t: t.to(torch.float64), tp)


def _grads(models, seed):
    """Leaf paths and the (reference, port, float64) gradients."""
    cfg, jm, jp, tm, tp = models
    b = _batch(seed)
    jg = jax.jit(jax.grad(lambda p, bb: jm.loss(
        p, bb, JFwdOptions(remat=False))))(jp, jax.tree.map(jnp.asarray, b))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tg = torch.func.grad(tm.loss)(tp, tb, FwdOptions(remat=False))
    g64 = torch.func.grad(_loss64)(_params64(tp), tb["tokens"].long(),
                                   tb["labels"].long(), cfg)
    paths = [p for p, _ in leaves_with_paths(tg)]
    ref = [np.asarray(x, np.float64) for x in jax.tree.leaves(jg)]
    port = [x.numpy().astype(np.float64) for _, x in leaves_with_paths(tg)]
    exact = [x.numpy() for _, x in leaves_with_paths(g64)]
    return paths, ref, port, exact


def _gap(a, b, scale):
    """Largest |a - b| of each leaf over the leaf's largest |scale|."""
    return [float(np.abs(x - y).max() / np.abs(s).max())
            for x, y, s in zip(a, b, scale)]


def _min_first_step_var(models, seed):
    cfg, _, _, _, tp = models
    outs = []
    tb = _batch(seed)
    with torch.no_grad():
        _loss64(_params64(tp), torch.from_numpy(tb["tokens"]).long(),
                torch.from_numpy(tb["labels"]).long(), cfg,
                first_outputs=outs)
    return min(float(o.var(-1, correction=0).min()) for o in outs)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_the_float64_arbiter_is_the_model(models):
    cfg, jm, jp, tm, tp = models
    b = _batch(ILL_SEED)
    want = float(jm.loss(jp, jax.tree.map(jnp.asarray, b),
                         JFwdOptions(remat=False)))
    got = float(_loss64(_params64(tp), torch.from_numpy(b["tokens"]).long(),
                        torch.from_numpy(b["labels"]).long(), cfg))
    assert abs(got - want) < 1e-5


def test_every_op_agrees_at_rounding_on_the_same_inputs(models):
    """Layer by layer at seed 0, each op of the port is given the
    reference's float32 inputs to that op and returns the reference's
    outputs, and so does the recurrence's gradient on one cotangent, at
    the kernel tolerance with atol taken of the op's largest entry
    where that exceeds 1 (the recurrence's outputs reach ~10 and its
    gradients ~50: an ulp of 10 is ~1e-6)."""
    cfg, _, jp, _, tp = models
    rj = jr.RWKVConfig(cfg.d_model, head_size=cfg.rwkv_head_size,
                       d_ff=cfg.d_ff)
    rt = tr.RWKVConfig(cfg.d_model, head_size=cfg.rwkv_head_size,
                       d_ff=cfg.d_ff)
    H, K = rj.n_heads, rj.head_size
    tok = _batch(ILL_SEED)["tokens"]

    def t(a):
        return torch.from_numpy(np.array(a))

    def same(a, b, what):
        a = np.asarray(a)
        np.testing.assert_allclose(
            b.detach().numpy(), a, err_msg=what, rtol=FP32["rtol"],
            atol=FP32["atol"] * max(1.0, float(np.abs(a).max())))

    def heads(a):
        return a.reshape(B, S, H, K)

    def flat(a):
        return jnp.transpose(heads(a), (0, 2, 1, 3)).reshape(B * H, S, K)

    def unflat(a):
        return jnp.transpose(a.reshape(B, H, S, K), (0, 2, 1, 3))

    x = jp["embed"][jnp.asarray(tok)]
    same(x, tp["embed"][torch.from_numpy(tok).long()], "embed")
    s0 = jnp.zeros((B * H, K, K), jnp.float32)
    for i in range(cfg.n_layers):
        lj, lt = _layer(jp, i), _layer(tp, i)
        h = j_rms_norm(x, lj["norm1"])
        same(h, rms_norm(t(x), lt["norm1"]), f"layer {i} norm1")
        sh = jr._token_shift(h)
        same(sh, tr._token_shift(t(h)), f"layer {i} token shift")
        ins = jr._time_mix_inputs(lj, h, sh, rj)
        for name, a, b in zip("rkvgw", ins,
                              tr._time_mix_inputs(lt, t(h), t(sh), rt)):
            same(a, b, f"layer {i} {name}")
        rkvw = [ins[n] for n in (0, 1, 2, 4)]
        uj = jnp.broadcast_to(lj["u"][None], (B, H, K)).reshape(B * H, K)
        o, _ = j_wkv6_ref(*map(flat, rkvw), uj, s0)
        o = unflat(o)
        same(o, wkv6_recurrence_ref(*(heads(t(a)) for a in rkvw), lt["u"],
                                    torch.zeros((B, H, K, K)))[0],
             f"layer {i} recurrence")
        do = np.random.default_rng(i).standard_normal(
            (B, S, H, K)).astype(np.float32)
        _, vjp = jax.vjp(
            lambda r, k, v, w, u: j_wkv6_ref(r, k, v, w, u, s0)[0],
            *map(flat, rkvw), uj)
        want = vjp(flat(jnp.asarray(do)))
        got = wkv6_backward_ref(*(heads(t(a)) for a in rkvw), lt["u"],
                                torch.zeros((B, H, K, K)),
                                torch.from_numpy(do))
        for name, a, b in zip("rkvw", want[:4], got[:4]):
            same(unflat(a), b, f"layer {i} d{name}")
        same(want[4].reshape(B, H, K).sum(0), got[4], f"layer {i} du")
        o = o.reshape(B, S, -1)
        same(jr._group_norm(o, lj["ln_x"], H),
             tr._group_norm(t(o), lt["ln_x"], H), f"layer {i} group norm")
        tm, _, _ = jr.rwkv_time_mix(lj, h, rj)
        same(tm, tr.rwkv_time_mix(lt, t(h), rt)[0], f"layer {i} time mix")
        x = x + tm
        h = j_rms_norm(x, lj["norm2"])
        same(h, rms_norm(t(x), lt["norm2"]), f"layer {i} norm2")
        cm, _ = jr.rwkv_channel_mix(lj, h, rj)
        same(cm, tr.rwkv_channel_mix(lt, t(h), rt)[0],
             f"layer {i} channel mix")
        x = x + cm
    h = j_rms_norm(x, jp["final_norm"])
    same(h, rms_norm(t(x), tp["final_norm"]), "final norm")
    same(jnp.einsum("bsd,dv->bsv", h, jp["lm_head"]),
         t(h) @ tp["lm_head"], "logits")


def test_gradients_part_only_at_the_ill_conditioned_head(models):
    """Seed 0 has a first-step head below the group norm's eps: the
    packages' gradients part by ~7e-4 of a leaf's largest entry, the
    reference the further from float64. Seeds 1 and 7 have none: both
    within 5e-5 of float64 and of each other."""
    assert _min_first_step_var(models, ILL_SEED) < 0.5 * GN_EPS
    paths, ref, port, exact = _grads(models, ILL_SEED)
    ref_err = _gap(ref, exact, exact)
    port_err = _gap(port, exact, exact)
    gap = _gap(ref, port, exact)
    assert max(gap) > 3e-4, dict(zip(paths, gap))
    assert max(port_err) < 2e-4, dict(zip(paths, port_err))
    assert max(ref_err) < 1e-3, dict(zip(paths, ref_err))
    assert max(ref_err) > 3 * max(port_err)
    for seed in WELL_SEEDS:
        assert _min_first_step_var(models, seed) > 10 * GN_EPS
        paths, ref, port, exact = _grads(models, seed)
        for name, err in (("reference", _gap(ref, exact, exact)),
                          ("port", _gap(port, exact, exact)),
                          ("gap", _gap(ref, port, exact))):
            assert max(err) < 5e-5, (seed, name, dict(zip(paths, err)))


@pytest.mark.parametrize("steps,moves", [((1,), True), ((0,), False),
                                         (tuple(range(3, S)), False)])
def test_half_an_ulp_of_r_at_the_first_output_moves_the_gradient(
        models, steps, moves):
    """In float64, relative noise of half a float32 ulp on r at the
    given steps (three draws): at step 1 the gradient moves by more than
    1e-4 of some leaf's largest entry, elsewhere by less than 1e-6."""
    cfg, _, _, _, tp = models
    b = _batch(ILL_SEED)
    tok = torch.from_numpy(b["tokens"]).long()
    lab = torch.from_numpy(b["labels"]).long()
    p64 = _params64(tp)
    base = torch.func.grad(_loss64)(p64, tok, lab, cfg)
    worst = 0.0
    for draw in range(3):
        gen = torch.Generator().manual_seed(draw)
        mask = torch.zeros(S, dtype=torch.float64)
        mask[list(steps)] = 1.0

        def nudge(layer, r, gen=gen, mask=mask):
            noise = 2 * torch.rand(r.shape, generator=gen,
                                   dtype=torch.float64) - 1
            return r * (1 + HALF_ULP * mask[None, :, None] * noise)

        moved = torch.func.grad(_loss64)(p64, tok, lab, cfg, nudge)
        worst = max(worst, max(_gap(
            [x.numpy() for _, x in leaves_with_paths(moved)],
            [x.numpy() for _, x in leaves_with_paths(base)],
            [x.numpy() for _, x in leaves_with_paths(base)])))
    if moves:
        assert worst > 1e-4, worst
    else:
        assert worst < 1e-6, worst
