"""The plain backward versions of the port's two model kernels
(``repro_torch.kernels.ref``), against torch autograd of the plain
forward versions and against ``jax`` gradients of the reference, on the
CPU at small sizes; and the autograd Functions, which on the CPU route to
them. The reference has no Pallas backward: its gradients are those of
``lax.scan`` (``repro.kernels.ref.wkv6_ref``) and of the jnp
``repro.models.layers.blockwise_attention``.

Tolerances, and why:
- WKV6, float32: rtol 1e-4 / atol 1e-4 against autograd of the plain
  forward (the same float32 products, summed in another order) and
  against ``jax.vjp`` of the reference (another backend's float32), with
  gradients of magnitude up to ~30 here. Where the reference misses,
  float64 (autograd of a float64 loop) is the arbiter: the port must be
  within rtol 1e-4 / atol 1e-4 of it.
- flash attention, float32: rtol 1e-4 / atol 1e-5 against both, the
  same reason. bfloat16: the port computes in float32 from the bfloat16
  inputs but takes D = Σ dO·O from the bfloat16 output o (as a flash
  backward does), while the reference's blockwise attention rounds the
  scaled q and p to bfloat16 on the way; their bits differ, so float64
  of the same bfloat16 inputs is the arbiter, and both are held to it at
  the reference's bfloat16 tolerance (rtol/atol 2e-2,
  tests/test_kernels.py:19-21). Measured on these cases: both within
  0.016 of float64, the port at most 1.06x the reference's distance.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import wkv6_ref as j_wkv6_ref
from repro.models.layers import blockwise_attention as j_blockwise
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import wkv6 as twkv

F32 = dict(rtol=1e-4, atol=1e-4)
FLASH_F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)

# decay ranges: mid, near 0 (down to 1e-30, the model's exp(-exp(.))),
# near 1
DECAYS = {"mid": (0.2, 0.99), "near0": (1e-30, 1e-2), "near1": (0.99, 0.999)}


def _wkv6_inputs(seed, B=2, S=40, H=2, K=32, decay="mid"):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, K)).astype(np.float32)
               for _ in range(3))
    lo, hi = DECAYS[decay]
    x = rng.random((B, S, H, K))
    w = np.exp(np.log(lo) + (np.log(hi) - np.log(lo)) * x).astype(np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32)
    s0 = (0.1 * rng.standard_normal((B, H, K, K))).astype(np.float32)
    d_o = rng.standard_normal((B, S, H, K)).astype(np.float32)
    d_s = (0.1 * rng.standard_normal((B, H, K, K))).astype(np.float32)
    return (r, k, v, w, u, s0), d_o, d_s


def _wkv6_f64(r, k, v, w, u, s0):
    """The recurrence in float64 (autograd's arbiter), op layout."""
    B, S, H, K = r.shape
    state = s0
    outs = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]        # (B, H, K, K)
        outs.append(torch.einsum("bhi,bhij->bhj", r[:, t],
                                 state + u[None, :, :, None] * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(outs, dim=1), state


def _autograd(fn, inputs, d_o, d_s, dtype):
    leaves = [torch.tensor(x, dtype=dtype, requires_grad=True)
              for x in inputs]
    o, s = fn(*leaves)
    torch.autograd.backward((o, s), (torch.tensor(d_o, dtype=dtype),
                                     torch.tensor(d_s, dtype=dtype)))
    return [leaf.grad for leaf in leaves]


def _jax_wkv6_grads(inputs, d_o, d_s):
    """jax.vjp of the reference's oracle, in its (B·H, S, K) layout, back
    in the op's."""
    r, k, v, w, u, s0 = inputs
    B, S, H, K = r.shape

    def flat(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, S, K)

    def fn(r, k, v, w, u, s0):
        ub = jnp.broadcast_to(u[None], (B, H, K)).reshape(B * H, K)
        o, s = j_wkv6_ref(flat(r), flat(k), flat(v), flat(w), ub,
                          s0.reshape(B * H, K, K))
        return o.reshape(B, H, S, K).transpose(0, 2, 1, 3), \
            s.reshape(B, H, K, K)

    _, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in inputs))
    return [np.asarray(g) for g in vjp((jnp.asarray(d_o), jnp.asarray(d_s)))]


NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


@pytest.mark.parametrize("decay", sorted(DECAYS))
def test_wkv6_backward_ref_matches_autograd_and_jax(decay):
    """(2, 40, 2, 32): two full 16-step chunks and a ragged one."""
    inputs, d_o, d_s = _wkv6_inputs(1, decay=decay)
    port = tref.wkv6_backward_ref(*(torch.from_numpy(x) for x in inputs),
                                  torch.from_numpy(d_o),
                                  torch.from_numpy(d_s))
    auto = _autograd(tref.wkv6_recurrence_ref, inputs, d_o, d_s,
                     torch.float32)
    f64 = _autograd(_wkv6_f64, inputs, d_o, d_s, torch.float64)
    jgrads = _jax_wkv6_grads(inputs, d_o, d_s)
    for name, p, a, j, x in zip(NAMES, port, auto, jgrads, f64):
        assert p.dtype == torch.float32 and p.shape == a.shape, name
        torch.testing.assert_close(p, a, **F32, msg=name)
        torch.testing.assert_close(p.double(), x, **F32, msg=name)
        jt = torch.from_numpy(j.copy())
        if not torch.allclose(p, jt, **F32):
            # the reference's float32 misses: float64 decides, and the
            # port is the closer of the two
            assert (p.double() - x).abs().max() <= \
                (jt.double() - x).abs().max(), name


def test_wkv6_backward_ref_matches_the_reference_time_mix():
    """jax.grad through the reference's lax.scan time mix
    (``rwkv_time_mix(use_pallas=False)``) against the port's time mix,
    whose recurrence is the autograd Function (the plain backward on the
    CPU): one float32 block input, reference weights."""
    from repro.models import rwkv6 as jrwkv
    from repro_torch.models import rwkv6 as trwkv
    cfg_j = jrwkv.RWKVConfig(64, head_size=32, decay_lora=16)
    cfg_t = trwkv.RWKVConfig(64, head_size=32, decay_lora=16)
    jp = jrwkv.rwkv_block_init(cfg_j, jax.random.key(0))
    jp = {k: v.astype(jnp.float32) for k, v in jp.items()}
    x = np.random.default_rng(2).standard_normal((2, 21, 64)).astype(
        np.float32)

    def jloss(params, x):
        out, state, _ = jrwkv.rwkv_time_mix(params, x, cfg_j)
        return jnp.sum(out * out) + jnp.sum(state)

    jg = jax.grad(jloss)(jp, jnp.asarray(x))
    tp = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in jp.items()}
    out, state, _ = trwkv.rwkv_time_mix(tp, torch.from_numpy(x), cfg_t)
    (torch.sum(out * out) + torch.sum(state)).backward()
    for name in ("wr", "wk", "wv", "w0", "w_lora_a", "w_lora_b", "u", "wg",
                 "wo", "mu"):
        got, want = tp[name].grad, torch.from_numpy(np.array(jg[name]))
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4 * scale,
                                   msg=name)


def _attn64(q, k, v, causal, window):
    B, S, Hq, hd = q.shape
    G = Hq // k.shape[2]
    qt = q.transpose(1, 2)
    kt = torch.repeat_interleave(k.transpose(1, 2), G, dim=1)
    vt = torch.repeat_interleave(v.transpose(1, 2), G, dim=1)
    s = qt @ kt.transpose(2, 3) / math.sqrt(hd)
    pos = torch.arange(S)
    mask = torch.ones((S, S), dtype=torch.bool)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window > 0:
        mask &= pos[:, None] - pos[None, :] < window
    p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    return (p @ vt).transpose(1, 2)


MASKS = [(True, 0), (True, 5), (False, 0), (False, 7)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_backward_ref_matches_autograd_and_jax(causal, window, G,
                                                     dtype):
    B, S, Hk, hd = 2, 37, 2, 16
    Hq = Hk * G
    rng = np.random.default_rng(G * 10 + window)
    q, k, v, d_o = (rng.standard_normal(s).astype(np.float32) for s in
                    ((B, S, Hq, hd), (B, S, Hk, hd), (B, S, Hk, hd),
                     (B, S, Hq, hd)))
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, d_o))
    o = tref.flash_attention_gqa_ref(tq, tk, tv, causal=causal,
                                     window=window)
    lse = tref.flash_attention_lse_ref(tq, tk, causal=causal, window=window)
    port = tref.flash_attention_backward_ref(tq, tk, tv, o, lse, tdo,
                                             causal=causal, window=window)
    # float64 of the same (rounded) inputs
    leaves = [x.double().requires_grad_(True) for x in (tq, tk, tv)]
    _attn64(*leaves, causal, window).backward(tdo.double())
    f64 = [x.grad for x in leaves]
    # the reference, in the same dtype
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jin = [jnp.asarray(x.float().numpy()).astype(jdt) for x in (tq, tk, tv)]
    _, vjp = jax.vjp(lambda a, b, c: j_blockwise(a, b, c, causal=causal,
                                                 window=window), *jin)
    jgrads = [torch.from_numpy(np.array(g.astype(jnp.float32)))
              for g in vjp(jnp.asarray(tdo.float().numpy()).astype(jdt))]
    for name, p, x, j in zip(("dq", "dk", "dv"), port, f64, jgrads):
        assert p.dtype == tdt and p.shape == j.shape, name
        if dtype == "float32":
            leaves2 = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
            tref.flash_attention_gqa_ref(*leaves2, causal=causal,
                                         window=window).backward(tdo)
            torch.testing.assert_close(p, leaves2["qkv".index(name[1])].grad,
                                       **FLASH_F32, msg=name)
            torch.testing.assert_close(p, j, **FLASH_F32, msg=name)
        else:
            torch.testing.assert_close(p.double(), x, **BF16, msg=name)
            torch.testing.assert_close(j.double(), x, **BF16, msg=name)


def test_autograd_functions_route_to_the_plain_backward_on_the_cpu(
        monkeypatch):
    calls = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(twkv, "wkv6_backward_ref",
                        spy("wkv6", tref.wkv6_backward_ref))
    monkeypatch.setattr(tflash, "flash_attention_backward_ref",
                        spy("flash", tref.flash_attention_backward_ref))
    before = ops.launch_counts()
    inputs, d_o, d_s = _wkv6_inputs(3, S=9, K=8)
    leaves = [torch.tensor(x, requires_grad=True) for x in inputs]
    o, s = ops.wkv6_recurrence(*leaves)
    assert o.grad_fn is not None and s.grad_fn is not None
    torch.autograd.backward((o, s), (torch.from_numpy(d_o),
                                     torch.from_numpy(d_s)))
    want = tref.wkv6_backward_ref(*(torch.from_numpy(x) for x in inputs),
                                  torch.from_numpy(d_o),
                                  torch.from_numpy(d_s))
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    q = torch.randn(1, 11, 2, 16, requires_grad=True)
    kv = [torch.randn(1, 11, 1, 16, requires_grad=True) for _ in range(2)]
    out = ops.flash_attention(q, *kv, causal=True, window=4)
    out.sum().backward()
    assert calls == ["wkv6", "flash"]
    assert ops.launch_counts() == before        # the CPU runs no kernel
    # no gradient wanted: no Function, the output has no graph
    with torch.no_grad():
        assert ops.wkv6_recurrence(*leaves)[0].grad_fn is None
    assert ops.flash_attention(q.detach(), *(t.detach() for t in kv)
                               ).grad_fn is None
