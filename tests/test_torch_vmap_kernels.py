"""The ``torch.func.vmap`` rules of the wkv6 and flash attention Functions
(``repro_torch.kernels.wkv6``, ``repro_torch.kernels.flash_attention``)
on the CPU, where the ops run their plain versions. No JAX.

A vmapped call folds the vmapped axis into a kernel axis (wkv6: the
heads; flash: the batch) and runs the op once for the whole batch; vmap
over vmap folds twice. ``vmap(vmap(grad(loss)))`` through the ops must
equal the per-client loop of ``torch.autograd.grad`` within 1e-5 of
each gradient's largest entry (plus 1e-5 absolute): the folded plain
versions make the same products per (b, h), but the wkv6 backward's
batched matmuls over another batch count round a few sums differently
(observed ≤ 1.1e-7 of the scale; the flash cases and the tiny models'
bfloat16 gradients came out bit-identical). The folded call runs the
op's plain version once forward and once backward (counted by wrapping
the plain versions), and no-grad vmapped calls go through the Functions
too.
"""

import pytest
import torch
from torch.func import grad, vmap

import repro_torch.kernels.flash_attention as kf
import repro_torch.kernels.wkv6 as kw
from repro_torch.fl.adapters import (_flat, _nested, tiny_rwkv6_config,
                                     tiny_transformer_config)
from repro_torch.kernels import ops
from repro_torch.kernels._fold import front, is_wrapped
from repro_torch.models.model_api import Model

REL = 1e-5


def _close(got, want, rel=REL):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * (1.0 + scale), f"max abs err {err}, scale {scale}"


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts of the plain versions' calls, with the shapes each got."""
    calls = {"wkv6": [], "wkv6_backward": [], "flash": [],
             "flash_backward": []}

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name].append(tuple(a[0].shape))
            return fn(*a, **k)
        return wrapped

    for mod, attr, name in ((kw, "wkv6_recurrence_ref", "wkv6"),
                            (kw, "wkv6_backward_ref", "wkv6_backward"),
                            (kf, "flash_attention_gqa_ref", "flash"),
                            (kf, "flash_attention_backward_ref",
                             "flash_backward")):
        monkeypatch.setattr(mod, attr, counted(name, getattr(mod, attr)))
    return calls


def _wkv6_inputs(gen, N, C, B, S, H, K):
    def randn(*shape):
        return torch.randn(*shape, generator=gen)
    r, k, v = randn(N, C, B, S, H, K), randn(N, C, B, S, H, K), \
        randn(N, C, B, S, H, K)
    w = 0.1 + 0.85 * torch.rand(N, C, B, S, H, K, generator=gen)
    return r, k, v, w, randn(N, C, H, K)


def _wkv6_loss(p, r, k, v, w):
    """u batched (a client's own), s0 unbatched (zeros made inside)."""
    B, S, H, K = r.shape
    s0 = torch.zeros(B, H, K, K)
    o, s_fin = ops.wkv6_recurrence(r * p["a"], k, v, w, p["u"], s0)
    return torch.sum(o * o) + torch.sum(torch.tanh(s_fin))


@pytest.mark.parametrize("shape", [(3, 2, 2, 5, 2, 8), (2, 3, 1, 17, 1, 32)])
def test_wkv6_vmap_vmap_grad_equals_the_per_client_loop(plain_calls, shape):
    N, C, B, S, H, K = shape
    gen = torch.Generator().manual_seed(0)
    r, k, v, w, u = _wkv6_inputs(gen, N, C, B, S, H, K)
    p = {"a": 1.0 + 0.1 * torch.randn(N, C, 1, generator=gen), "u": u}
    g = vmap(vmap(grad(_wkv6_loss)))(p, r, k, v, w)
    # one plain call each, at the folded shape (B, S, N·C·H, K)
    assert plain_calls["wkv6"] == [(B, S, N * C * H, K)]
    assert plain_calls["wkv6_backward"] == [(B, S, N * C * H, K)]
    for n in range(N):
        for c in range(C):
            pp = {name: t[n, c].clone().requires_grad_(True)
                  for name, t in p.items()}
            want = torch.autograd.grad(
                _wkv6_loss(pp, r[n, c], k[n, c], v[n, c], w[n, c]),
                [pp["a"], pp["u"]])
            _close(g["a"][n, c], want[0])
            _close(g["u"][n, c], want[1])


def test_wkv6_grad_of_every_input_under_vmap():
    """The gradient of each of r, k, v, w, u and s0 (here batched) through
    a vmapped call equals the one of a per-client call."""
    gen = torch.Generator().manual_seed(1)
    V, B, S, H, K = 3, 2, 6, 2, 8
    r, k, v, w, u = (t[0] for t in _wkv6_inputs(gen, 1, V, B, S, H, K))
    s0 = 0.1 * torch.randn(V, B, H, K, K, generator=gen)

    def loss(r, k, v, w, u, s0):
        o, s_fin = ops.wkv6_recurrence(r, k, v, w, u, s0)
        return torch.sum(o * torch.cos(o)) + torch.sum(s_fin * s_fin)

    args = (r, k, v, w, u, s0)
    g = vmap(grad(loss, argnums=tuple(range(6))))(*args)
    for i in range(V):
        leaves = [t[i].clone().requires_grad_(True) for t in args]
        want = torch.autograd.grad(loss(*leaves), leaves)
        for got, ref in zip(g, want):
            _close(got[i], ref)


def test_wkv6_no_grad_vmap_folds_once(plain_calls):
    gen = torch.Generator().manual_seed(2)
    r, k, v, w, u = (t[0] for t in _wkv6_inputs(gen, 1, 4, 2, 5, 2, 16))
    s0 = torch.zeros(2, 2, 16, 16)
    with torch.no_grad():
        o, s_fin = vmap(ops.wkv6_recurrence,
                        in_dims=(0, 0, 0, 0, 0, None))(r, k, v, w, u, s0)
    assert plain_calls["wkv6"] == [(2, 5, 4 * 2, 16)]
    assert not plain_calls["wkv6_backward"]
    for i in range(4):
        want = ops.wkv6_recurrence(r[i], k[i], v[i], w[i], u[i], s0)
        _close(o[i], want[0])
        _close(s_fin[i], want[1])


def _flash_inputs(gen, N, C, B, S, Hq, Hk, hd, dtype=torch.float32):
    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dtype)
    return (randn(N, C, B, S, Hq, hd), randn(N, C, B, S, Hk, hd),
            randn(N, C, B, S, Hk, hd))


@pytest.mark.parametrize("causal, window", [(True, 0), (False, 0),
                                            (True, 3)])
def test_flash_vmap_vmap_grad_equals_the_per_client_loop(plain_calls, causal,
                                                         window):
    N, C, B, S, Hq, Hk, hd = 3, 2, 2, 7, 4, 2, 16
    gen = torch.Generator().manual_seed(3)
    q, k, v = _flash_inputs(gen, N, C, B, S, Hq, Hk, hd)
    a = 1.0 + 0.1 * torch.randn(N, C, generator=gen)

    def loss(a, q, k, v):
        o = ops.flash_attention(q * a, k * a, v, causal=causal, window=window)
        return torch.sum(o * o)

    g = vmap(vmap(grad(loss)))(a, q, k, v)
    assert plain_calls["flash"] == [(N * C * B, S, Hq, hd)]
    assert plain_calls["flash_backward"] == [(N * C * B, S, Hq, hd)]
    for n in range(N):
        for c in range(C):
            aa = a[n, c].clone().requires_grad_(True)
            want, = torch.autograd.grad(loss(aa, q[n, c], k[n, c], v[n, c]),
                                        [aa])
            _close(g[n, c], want)


def test_flash_grad_of_every_input_under_vmap_bf16():
    """bfloat16 q, k, v (the models' compute dtype): the vmapped gradient
    of each equals a per-client call's (the plain version computes in
    float32 per (b, h) and rounds once)."""
    gen = torch.Generator().manual_seed(4)
    V = 3
    q, k, v = (t[0] for t in _flash_inputs(gen, 1, V, 2, 9, 4, 2, 32,
                                             torch.bfloat16))

    def loss(q, k, v):
        return torch.sum(ops.flash_attention(q, k, v).float() ** 2)

    g = vmap(grad(loss, argnums=(0, 1, 2)))(q, k, v)
    for i in range(V):
        leaves = [t[i].clone().requires_grad_(True) for t in (q, k, v)]
        want = torch.autograd.grad(loss(*leaves), leaves)
        for got, ref in zip(g, want):
            assert got.dtype == torch.bfloat16
            _close(got[i].float(), ref.float())


def test_flash_no_grad_vmap_folds_once(plain_calls):
    gen = torch.Generator().manual_seed(5)
    q, k, v = _flash_inputs(gen, 2, 3, 2, 5, 2, 2, 16)
    with torch.no_grad():
        o = vmap(vmap(ops.flash_attention))(q, k, v)
    assert plain_calls["flash"] == [(2 * 3 * 2, 5, 2, 16)]
    assert not plain_calls["flash_backward"]
    for n in range(2):
        for c in range(3):
            _close(o[n, c], ops.flash_attention(q[n, c], k[n, c], v[n, c]))


@pytest.mark.parametrize("family", ["rwkv6", "transformer"])
def test_model_loss_vmap_vmap_grad_one_call_a_layer(plain_calls, family):
    """The tiny LM configs' ``Model.loss`` under vmap(vmap(grad)) over
    (2 clusters, 3 clients) of their own weights and rows: one plain call
    of the model's op a layer forward and backward, and the gradients of
    the per-client loop."""
    cfg = (tiny_rwkv6_config(vocab_size=64) if family == "rwkv6"
           else tiny_transformer_config(vocab_size=64))
    model = Model(cfg, device="cpu")
    N, C = 2, 3
    gen = torch.Generator().manual_seed(6)
    params = [_flat(model.init(gen)) for _ in range(N * C)]
    stacked = {name: torch.stack([p[name].float() for p in params]
                                 ).reshape(N, C, *params[0][name].shape)
               for name in params[0]}
    rows = torch.randint(0, 64, (N, C, 2, 9), generator=gen)

    def loss(p, rows):
        return model.loss(_nested(p), {"tokens": rows[:, :-1],
                                       "labels": rows[:, 1:]})

    g = vmap(vmap(grad(loss)))(stacked, rows)
    op = "wkv6" if family == "rwkv6" else "flash"
    assert len(plain_calls[op]) == cfg.n_layers
    assert len(plain_calls[op + "_backward"]) == cfg.n_layers
    for n in range(N):
        for c in range(C):
            leaves = {name: t[n, c].clone().requires_grad_(True)
                      for name, t in stacked.items()}
            want = torch.autograd.grad(loss(leaves, rows[n, c]),
                                       list(leaves.values()))
            for name, ref in zip(leaves, want):
                _close(g[name][n, c], ref)


def test_fold_helpers():
    t = torch.arange(24.0).reshape(2, 3, 4)
    assert torch.equal(front(t, 1, 3), t.movedim(1, 0))
    e = front(t, None, 5)
    assert e.shape == (5, 2, 3, 4) and torch.equal(e[4], t)
    assert not is_wrapped(t, None, 3)
    seen = []
    vmap(lambda x: seen.append(is_wrapped(x)) or x)(t)
    assert seen == [True]
    # wkv6's fold is a permutation of the heads: unfold inverts it
    x = torch.randn(3, 2, 5, 4, 8)          # (V, B, S, H, K)
    folded = kw._fold(x, 0, 3)
    assert folded.shape == (2, 5, 12, 8) and folded.is_contiguous()
    assert torch.equal(kw._unfold(folded, 3), x)
    s = torch.randn(3, 2, 4, 8, 8)          # (V, B, H, K, K)
    assert torch.equal(kw._unfold_state(kw._fold_state(s, 0, 3), 3), s)
    y = torch.randn(2, 3, 5, 4, 16).transpose(0, 1)   # vmapped dim 1 → 0
    assert torch.equal(kf._unfold(kf._fold(y, 0, 3), 3), y)
