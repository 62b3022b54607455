"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions. Every test here is marked ``cuda`` and skips where no
CUDA device is present; on a machine with one (it needs neither JAX nor
the reference package):

    PYTHONPATH=src python3 -m pytest -q tests/test_torch_kernels_cuda.py

Tolerances are the reference's (tests/test_kernels.py): float32
aggregate rtol 2e-5 / atol 2e-6, bfloat16 2e-2; the fused partials rtol
1e-4 (dot atol 1e-2, sums of 10^5 terms in another order). The WKV6
recurrence: rtol 1e-5 / atol 1e-4 — float32, sums over K in another
order, carried through up to 512 steps of the state. The RWKV-6 model on
the card against the CPU: logits within 0.125 and 0.02 on average, the
bfloat16 rule of tests/test_torch_rwkv6.py (cuBLAS rounds its bfloat16
products in other places than the CPU); the same rule for the dense
transformer. Flash attention: the reference's flash tolerances
(tests/test_kernels.py:141-179), float32 rtol/atol 2e-5 and bfloat16
2e-2 — both versions compute scores and softmax in float32 and differ in
the order of their sums; the bfloat16 kernel also rounds p to bfloat16
for its P·V product on the tensor cores, which the plain version does
not.

The backward kernels against the plain backward versions: WKV6 rtol 1e-4
/ atol 1e-3 — float32 sums over K and over up to 513 steps of the walk
in another order (the plain version's own float32 is within 5e-4 of a
float64 run at these shapes, du largest: it sums B·S terms); flash
attention float32 rtol/atol 1e-4 (the forward's sums, then dP - D and
the products over up to 513 keys or queries in another order) and
bfloat16 2e-2 (the tensor-core kernels take P and dS into their wgmma
products as two bfloat16 parts, ~16 bits, the plain version in float32;
both round the result to bfloat16 once). Model gradients on the card against the
CPU's: the bfloat16 rule above, taken relative to each parameter's
gradient scale s = max |g_cpu|: max |g_card - g_cpu| <= 0.125 s and the
mean <= 0.02 s.
"""

import math
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import api
from repro_torch.core.model_eval import model_evaluation
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

FP32 = dict(rtol=2e-5, atol=2e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(gen, dev, *shape):
    return torch.randn(*shape, generator=gen, device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(1, 64), (7, 33), (8, 101_770),
                                 (50, 101_770), (3, 2049)])
def test_kernels_match_plain(cuda_device, n, d, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(n + d)
    W = _randn(gen, cuda_device, n, d).to(dtype)
    gw = _randn(gen, cuda_device, d).to(dtype)
    w = torch.rand(n, generator=gen, device=cuda_device) + 0.5
    before = ops.launch_counts()
    dot, wsq, gsq = ops.cosine_partials(W, gw)
    rdot, rwsq, rgsq = tref.cosine_partials_ref(W, gw)
    torch.testing.assert_close(dot, rdot, rtol=1e-4, atol=1e-2)
    torch.testing.assert_close(wsq, rwsq, rtol=1e-4, atol=0)
    torch.testing.assert_close(gsq, rgsq, rtol=1e-4, atol=0)
    tol = BF16 if dtype == torch.bfloat16 else FP32
    torch.testing.assert_close(ops.weighted_aggregate(W, w),
                               tref.weighted_aggregate_ref(W, w), **tol)
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after} == \
        {"cosine_partials": 1, "weighted_aggregate": 1, "wkv6": 0,
         "flash_attention": 0, "wkv6_backward": 0,
         "flash_attention_backward": 0}


# leaves past 2^31 bytes (float32) and past 2^31 elements (bfloat16): the
# trainer's Eq. 1 and Eq. 2 run on (C, n) views of whole stacked leaves
@pytest.mark.parametrize("n,d,dtype", [(2, 2 ** 28 + 64, torch.float32),
                                       (4, 2 ** 29 + 2048, torch.bfloat16)])
def test_kernels_match_plain_past_2_31(cuda_device, n, d, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(31)
    W = _randn(gen, cuda_device, n, d).to(dtype)
    assert W.numel() * W.element_size() > 2 ** 31
    w = torch.arange(1, n + 1, device=cuda_device, dtype=torch.float32)
    gw = ops.weighted_aggregate(W, w)
    want = tref.weighted_aggregate_ref(W, w)
    torch.testing.assert_close(gw, want, **FP32)
    # the last columns, where a 32-bit offset would wrap
    assert torch.equal(gw[-4096:], ops.weighted_aggregate(
        W[:, -4096:].contiguous(), w))
    del want
    g = gw.to(dtype)
    dot, wsq, gsq = ops.cosine_partials(W, g)
    rdot, rwsq, rgsq = tref.cosine_partials_ref(W, g)
    torch.testing.assert_close(dot, rdot, rtol=1e-4, atol=1e-2)
    torch.testing.assert_close(wsq, rwsq, rtol=1e-4, atol=0)
    torch.testing.assert_close(gsq, rgsq, rtol=1e-4, atol=0)


def _agg_views(dev, n, d, dtype, view):
    """W (n, d) as asked: "whole" a tensor of its own, "row" the rows
    big[1:] of an (n + 1, d) tensor, "elem" a view one element into a flat
    buffer (its base aligned to one element only)."""
    gen = torch.Generator(device=dev).manual_seed(n * 7 + d)
    big = _randn(gen, dev, n * d + d + 1).to(dtype)
    if view == "whole":
        W = big[:n * d].clone().view(n, d)
    elif view == "row":
        W = big[:(n + 1) * d].view(n + 1, d)[1:]
    else:
        W = big[1:1 + n * d].view(n, d)
    return W, torch.rand(n, generator=gen, device=dev) + 0.5


# D odd (1 column a thread), D = 2 mod 4 (2), D = 0 mod 8 (4 fp32, 8 bf16)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("view", ["whole", "row", "elem"])
@pytest.mark.parametrize("d", [1001, 1002, 1024])
@pytest.mark.parametrize("n", [1, 8, 50])
def test_weighted_aggregate_vector_widths(cuda_device, n, d, view, dtype):
    from repro_torch.kernels.weighted_agg import vector_width
    W, w = _agg_views(cuda_device, n, d, dtype, view)
    assert W.is_contiguous()
    vec = vector_width(d, W.data_ptr(), W.element_size())
    if view == "elem":
        assert vec == 1
    elif d == 1024:
        assert vec == 16 // W.element_size()
    before = ops.launch_counts()["weighted_aggregate"]
    out = ops.weighted_aggregate(W, w)
    assert ops.launch_counts()["weighted_aggregate"] == before + 1
    tol = BF16 if dtype == torch.bfloat16 else FP32
    torch.testing.assert_close(out, tref.weighted_aggregate_ref(W, w), **tol)
    assert torch.equal(out, ops.weighted_aggregate(W, w))


def test_weighted_aggregate_launches_one_kernel(cuda_device):
    """λ is normalized in the kernel: with float32 weights the wrapper puts
    exactly one kernel on the card."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    W = _randn(gen, cuda_device, 8, 101_770)
    w = torch.rand(8, generator=gen, device=cuda_device) + 0.5
    ops.weighted_aggregate(W, w)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ops.weighted_aggregate(W, w)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "weighted_agg" in kernels[0], kernels


# N rows at 1, 8 (the main path), 50 and 200; D odd, ≡ 2 mod 4 (the MLP's
# 101,770) and past one 2 Mi-element chunk (two tiles a block); every mix
# of float32 and bfloat16
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(1, 1001), (8, 101_770), (50, 101_770),
                                 (200, 4099), (2, 2 ** 21 + 6)])
def test_cosine_partials_shapes_and_types(cuda_device, n, d, w_dtype,
                                          g_dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(n * 3 + d)
    W = _randn(gen, cuda_device, n, d).to(w_dtype)
    gw = _randn(gen, cuda_device, d).to(g_dtype)
    before = ops.launch_counts()["cosine_partials"]
    dot, wsq, gsq = ops.cosine_partials(W, gw)
    assert ops.launch_counts()["cosine_partials"] == before + 1
    rdot, rwsq, rgsq = tref.cosine_partials_ref(W, gw)
    torch.testing.assert_close(dot, rdot, rtol=1e-4, atol=1e-2)
    torch.testing.assert_close(wsq, rwsq, rtol=1e-4, atol=0)
    torch.testing.assert_close(gsq, rgsq, rtol=1e-4, atol=0)
    # a view one element in reads with narrower loads, in the same order
    big = torch.empty(n * d + 1, device=cuda_device, dtype=w_dtype)
    Wv = big[1:].view(n, d).copy_(W)
    assert all(torch.equal(a, b) for a, b in
               zip(ops.cosine_partials(Wv, gw), (dot, wsq, gsq)))


def test_cosine_partials_ticket_resets(cuda_device):
    """100 back-to-back calls give the same bits: the last block's ticket
    is back at 0 after every launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    W = _randn(gen, cuda_device, 8, 101_770)
    gw = _randn(gen, cuda_device, 101_770)
    first = ops.cosine_partials(W, gw)
    outs = [ops.cosine_partials(W, gw) for _ in range(100)]
    assert all(torch.equal(a, b) for o in outs for a, b in zip(first, o))


def test_cosine_partials_on_two_streams(cuda_device):
    """Calls on two streams at once draw tickets of their own."""
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    W = _randn(gen, cuda_device, 50, 101_770)
    gw = _randn(gen, cuda_device, 101_770)
    want = ops.cosine_partials(W, gw)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    for _ in range(10):
        for st in streams:
            with torch.cuda.stream(st):
                outs.append(ops.cosine_partials(W, gw))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for o in outs for a, b in zip(want, o))


def test_cosine_partials_launches_one_kernel(cuda_device):
    """One launch per call: the last block folds the partials."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=cuda_device).manual_seed(15)
    W = _randn(gen, cuda_device, 8, 101_770)
    gw = _randn(gen, cuda_device, 101_770)
    ops.cosine_partials(W, gw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ops.cosine_partials(W, gw)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "cosine_partials" in kernels[0], kernels


def test_kernels_bit_identical_on_repeat(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    W = _randn(gen, cuda_device, 8, 101_770)
    gw = _randn(gen, cuda_device, 101_770)
    w = torch.rand(8, generator=gen, device=cuda_device)
    first = ops.cosine_partials(W, gw) + (ops.weighted_aggregate(W, w),)
    for _ in range(3):
        again = ops.cosine_partials(W, gw) + (ops.weighted_aggregate(W, w),)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_wrappers_refuse_strided_and_mixed_input(cuda_device):
    W = torch.ones(4, 64, device=cuda_device)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        ops.cosine_partials(W, torch.ones(32, device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        ops.weighted_aggregate(W, torch.ones(4, device=cuda_device))
    W = torch.ones(4, 32, device=cuda_device)
    with pytest.raises(ValueError, match="is on cuda"):
        ops.cosine_partials(W, torch.ones(32))
    with pytest.raises(ValueError, match="is on cuda"):
        ops.weighted_aggregate(W, torch.ones(4))


def test_model_evaluation_on_card_matches_cpu(cuda_device):
    gen = torch.Generator().manual_seed(1)
    base = torch.randn(101_770, generator=gen)
    scale = torch.linspace(0.3, 0.8, 8)[:, None]
    W = base + scale * torch.randn(8, 101_770, generator=gen)
    sizes = torch.tensor([100.0, 120, 80, 100, 90, 110, 100, 95])
    cpu = model_evaluation(W, sizes)
    card = model_evaluation(W.to(cuda_device), sizes.to(cuda_device))
    torch.testing.assert_close(card.global_model.cpu(), cpu.global_model,
                               **FP32)
    torch.testing.assert_close(card.similarities.cpu(), cpu.similarities,
                               **FP32)
    assert int(card.vote) == int(cpu.vote)
    assert torch.equal(card.predictions.cpu(), cpu.predictions)
    again = model_evaluation(W.to(cuda_device), sizes.to(cuda_device))
    assert torch.equal(card.global_model, again.global_model)
    assert torch.equal(card.similarities, again.similarities)


def test_run_bhfl_on_card_goes_through_kernels(cuda_device):
    before = ops.launch_counts()
    run = api.run_bhfl(model="mlp", n_nodes=3, clients_per_node=2,
                       fel_iterations=1, rounds=2, seed=2,
                       data=api.make_mnist_like(200, 40))
    after = ops.launch_counts()
    assert run.chain_valid and run.chain_height == 2
    assert run.runtime.global_params["w1"].is_cuda
    assert {k: after[k] - before[k] for k in after} == \
        {"cosine_partials": 2, "weighted_aggregate": 2, "wkv6": 0,
         "flash_attention": 0, "wkv6_backward": 0,
         "flash_attention_backward": 0}


WKV6 = dict(rtol=1e-5, atol=1e-4)


def _wkv6_inputs(gen, dev, B, S, H, K):
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    w = 0.2 + 0.79 * torch.rand(B, S, H, K, generator=gen, device=dev)
    return (randn(B, S, H, K), randn(B, S, H, K), randn(B, S, H, K), w,
            randn(H, K), 0.1 * randn(B, H, K, K))


@pytest.mark.parametrize("B,S,H,K", [(8, 1, 32, 64), (8, 512, 32, 64),
                                     (1, 16, 2, 8), (4, 64, 2, 16),
                                     (2, 96, 3, 32), (2, 70, 3, 8)])
def test_wkv6_matches_plain(cuda_device, B, S, H, K):
    gen = torch.Generator(device=cuda_device).manual_seed(B * S + K)
    args = _wkv6_inputs(gen, cuda_device, B, S, H, K)
    before = ops.launch_counts()["wkv6"]
    o, sf = ops.wkv6_recurrence(*args)
    assert ops.launch_counts()["wkv6"] == before + 1
    ro, rsf = tref.wkv6_recurrence_ref(*args)
    torch.testing.assert_close(o, ro, **WKV6)
    torch.testing.assert_close(sf, rsf, **WKV6)
    again = ops.wkv6_recurrence(*args)
    assert torch.equal(o, again[0]) and torch.equal(sf, again[1])


def _low_decay(gen, dev, B, S, H, K):
    """w log-uniform from 1e-30 up to 0.999: the model's exp(-exp(.)) can
    come that close to 0."""
    lo, hi = math.log(1e-30), math.log(0.999)
    return torch.exp(lo + (hi - lo) * torch.rand(B, S, H, K, generator=gen,
                                                 device=dev))


# every head size; S below, at and past one staged chunk of T steps and
# past two (the ring's ragged last chunk); B·H = 15, so the grid does not
# divide the 132 SMs evenly
@pytest.mark.parametrize("decay", ["mid", "low"])
@pytest.mark.parametrize("s_of_t", ["1", "T-1", "T", "T+1", "2T+3"])
@pytest.mark.parametrize("K", [8, 16, 32, 64])
def test_wkv6_chunks_and_decays(cuda_device, K, s_of_t, decay):
    from repro_torch.kernels.wkv6 import launch_shape
    T = launch_shape(3, 5, K).t
    S = {"1": 1, "T-1": T - 1, "T": T, "T+1": T + 1, "2T+3": 2 * T + 3}[s_of_t]
    B, H = 3, 5
    gen = torch.Generator(device=cuda_device).manual_seed(K * 100 + S)
    r, k, v, w, u, s0 = _wkv6_inputs(gen, cuda_device, B, S, H, K)
    if decay == "low":
        w = _low_decay(gen, cuda_device, B, S, H, K)
    o, sf = ops.wkv6_recurrence(r, k, v, w, u, s0)
    ro, rsf = tref.wkv6_recurrence_ref(r, k, v, w, u, s0)
    torch.testing.assert_close(o, ro, **WKV6)
    torch.testing.assert_close(sf, rsf, **WKV6)
    again = ops.wkv6_recurrence(r, k, v, w, u, s0)
    assert torch.equal(o, again[0]) and torch.equal(sf, again[1])


def test_wkv6_bits_do_not_depend_on_the_batch(cuda_device):
    """One (b, h) slice gives the same bits alone (B = 1) as inside B = 5:
    the grid changes, the order of sums does not."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    B, S, H, K = 5, 45, 4, 64
    r, k, v, w, u, s0 = _wkv6_inputs(gen, cuda_device, B, S, H, K)
    o, sf = ops.wkv6_recurrence(r, k, v, w, u, s0)
    for b in (0, 3):
        one = [t[b:b + 1].contiguous() for t in (r, k, v, w)]
        o1, s1 = ops.wkv6_recurrence(*one, u, s0[b:b + 1].contiguous())
        assert torch.equal(o1[0], o[b]) and torch.equal(s1[0], sf[b])


@pytest.mark.parametrize("offset", [0, 1])
def test_wkv6_reads_fused_projection_views(cuda_device, offset):
    """r, k, v, w as slices of one (B, S, 4·H·K) projection (16-byte copies),
    or of a buffer one float off (4-byte copies), give the bits of
    contiguous copies."""
    from repro_torch.kernels.wkv6 import copy_width
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    B, S, H, K = 2, 37, 4, 64
    flat = _randn(gen, cuda_device, B * S * 4 * H * K + offset)
    buf = flat[offset:].view(B, S, 4 * H * K)
    r, k, v, w = (t.view(B, S, H, K) for t in buf.split(H * K, dim=2))
    w.copy_(torch.sigmoid(w))
    u = _randn(gen, cuda_device, H, K)
    s0 = 0.1 * _randn(gen, cuda_device, B, H, K, K)
    assert not r.is_contiguous()
    want = 1 if offset else 4
    assert copy_width([t.data_ptr() for t in (r, k, v, w)], r.stride(),
                      r.shape) == want
    o, sf = ops.wkv6_recurrence(r, k, v, w, u, s0)
    o2, s2 = ops.wkv6_recurrence(*(t.contiguous() for t in (r, k, v, w)),
                                 u, s0)
    assert torch.equal(o, o2) and torch.equal(sf, s2)
    ro, rsf = tref.wkv6_recurrence_ref(r, k, v, w, u, s0)
    torch.testing.assert_close(o, ro, **WKV6)


def test_wkv6_reads_strided_inputs(cuda_device):
    """r, k, v, w as (B, H, S, K) buffers seen through a transpose give the
    same bits as contiguous copies."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    B, S, H, K = 2, 33, 4, 64
    r, k, v, w, u, s0 = _wkv6_inputs(gen, cuda_device, B, S, H, K)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (r, k, v, w)]
    assert not views[0].is_contiguous()
    o1, s1 = ops.wkv6_recurrence(*views, u, s0)
    o2, s2 = ops.wkv6_recurrence(r, k, v, w, u, s0)
    assert torch.equal(o1, o2) and torch.equal(s1, s2)


def test_wkv6_refuses_what_it_cannot_run(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    r, k, v, w, u, s0 = _wkv6_inputs(gen, cuda_device, 1, 4, 2, 16)
    with pytest.raises(TypeError, match="float32"):
        ops.wkv6_recurrence(r.half(), k, v, w, u, s0)
    with pytest.raises(ValueError, match="strides"):
        ops.wkv6_recurrence(r, k.transpose(1, 2).contiguous().transpose(1, 2),
                            v, w, u, s0)
    with pytest.raises(ValueError, match="is on"):
        ops.wkv6_recurrence(r, k, v, w, u.cpu(), s0)
    with pytest.raises(ValueError, match="K in"):
        ops.wkv6_recurrence(*(torch.ones(1, 4, 2, 12, device=cuda_device)
                              for _ in range(4)),
                            torch.ones(2, 12, device=cuda_device),
                            torch.ones(1, 2, 12, 12, device=cuda_device))


def test_rwkv_serving_on_card_goes_through_wkv6(cuda_device):
    """The reduced RWKV-6 on the card: one wkv6 launch per layer per
    decode step, and logits that agree with the same weights on the CPU."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.model_api import Model
    from repro_torch.serving import GenerationRequest, ServingEngine
    cfg = get_config("rwkv6-1.6b").reduced()
    card = Model(cfg)
    params = card.init(torch.Generator(device=cuda_device).manual_seed(0))
    cpu = Model(cfg, device="cpu")
    cpu_params = {k: ({n: t.cpu() for n, t in v.items()}
                      if isinstance(v, dict) else v.cpu())
                  for k, v in params.items()}
    prompts = [np.arange(n, dtype=np.int32) * 7 % 512 for n in (3, 11, 6)]
    before = ops.launch_counts()
    out = ServingEngine(card, params).generate(
        [GenerationRequest(i, p, 5) for i, p in enumerate(prompts)])
    after = ops.launch_counts()
    assert after["wkv6"] - before["wkv6"] == (11 + 5 - 1) * cfg.n_layers
    assert [len(c.tokens) for c in out] == [5, 5, 5]
    assert all(0 <= t < cfg.vocab_size for c in out for t in c.tokens)
    toks = torch.from_numpy(np.stack([np.arange(24) * 5 % 512] * 2))
    lc, _ = card.forward(params, {"tokens": toks.to(cuda_device)})
    lh, _ = cpu.forward(cpu_params, {"tokens": toks})
    diff = (lc.float().cpu() - lh.float()).abs()
    assert torch.isfinite(lc).all()
    assert float(diff.max()) <= 0.125 and float(diff.mean()) <= 0.02


FLASH_CASES = [
    # (B, S, Hq, Hk, hd, dtype, causal, window)
    (8, 57, 32, 4, 128, torch.bfloat16, True, 0),     # Yi-6B serving prefill
    (8, 512, 32, 4, 128, torch.bfloat16, True, 0),    # Yi-6B forward
    (8, 512, 32, 4, 128, torch.float32, True, 0),
    (1, 1000, 8, 2, 64, torch.bfloat16, True, 256),
    (2, 130, 4, 4, 32, torch.bfloat16, False, 0),
    (1, 16, 2, 2, 16, torch.float32, True, 0),
    (1, 150, 2, 2, 16, torch.float32, True, 7),
    (1, 130, 8, 1, 16, torch.float32, True, 1),
    (2, 77, 4, 2, 64, torch.float32, False, 9),
    (3, 33, 6, 3, 32, torch.float32, True, 40),
]


def _flash_inputs(gen, dev, B, S, Hq, Hk, hd, dtype):
    return (_randn(gen, dev, B, S, Hq, hd).to(dtype),
            _randn(gen, dev, B, S, Hk, hd).to(dtype),
            _randn(gen, dev, B, S, Hk, hd).to(dtype))


@pytest.mark.parametrize("B,S,Hq,Hk,hd,dtype,causal,window", FLASH_CASES)
def test_flash_matches_plain(cuda_device, B, S, Hq, Hk, hd, dtype, causal,
                             window):
    gen = torch.Generator(device=cuda_device).manual_seed(B * S + hd)
    q, k, v = _flash_inputs(gen, cuda_device, B, S, Hq, Hk, hd, dtype)
    before = ops.launch_counts()["flash_attention"]
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert o.dtype == dtype and o.shape == q.shape
    ref = tref.flash_attention_gqa_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(o, ref, **(BF16 if dtype == torch.bfloat16
                                          else FP32))
    again = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert torch.equal(o, again)


# bf16 on the tensor cores: every hd, S below, at and above the 64-key
# tile, G 1 and 8
@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("S", [1, 57, 64, 130, 513])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_flash_bf16_tensor_core_shapes(cuda_device, hd, S, G):
    # G 8 as one batch over one kv head: dims of extent 1 in the tensor map
    B, Hk = (1, 1) if G == 8 else (2, 2)
    gen = torch.Generator(device=cuda_device).manual_seed(S * hd + G)
    q, k, v = _flash_inputs(gen, cuda_device, B, S, Hk * G, Hk, hd,
                            torch.bfloat16)
    o = ops.flash_attention(q, k, v)
    ref = tref.flash_attention_gqa_ref(q, k, v)
    torch.testing.assert_close(o, ref, **BF16)
    assert torch.equal(o, ops.flash_attention(q, k, v))


# windows shorter and longer than the 64-key tile, and non-causal runs
@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("causal,window", [(True, 7), (True, 40),
                                           (True, 100), (True, 300),
                                           (False, 0), (False, 50)])
def test_flash_bf16_windows_and_non_causal(cuda_device, hd, causal,
                                           window):
    gen = torch.Generator(device=cuda_device).manual_seed(hd + window)
    q, k, v = _flash_inputs(gen, cuda_device, 2, 333, 8, 2, hd,
                            torch.bfloat16)
    kw = dict(causal=causal, window=window)
    o = ops.flash_attention(q, k, v, **kw)
    torch.testing.assert_close(
        o, tref.flash_attention_gqa_ref(q, k, v, **kw), **BF16)
    assert torch.equal(o, ops.flash_attention(q, k, v, **kw))


def test_flash_bf16_refuses_what_tma_cannot_read(cuda_device):
    """A base or a stride that is not a multiple of 16 bytes raises before
    any launch; fp32 (CUDA cores) takes the same layouts."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    B, S, H, hd = 1, 40, 2, 32
    flat = _randn(gen, cuda_device, B * S * H * hd + 1).to(torch.bfloat16)
    shifted = flat[1:].view(B, S, H, hd)                 # base + 2 bytes
    padded = _randn(gen, cuda_device, B, S, H, hd + 4).to(
        torch.bfloat16)[..., :hd]                       # rows of 72 bytes
    ok = _randn(gen, cuda_device, B, S, H, hd).to(torch.bfloat16)
    before = ops.launch_counts()["flash_attention"]
    for bad in (shifted, padded):
        with pytest.raises(ValueError, match="TMA"):
            ops.flash_attention(bad, ok, ok)
        with pytest.raises(ValueError, match="TMA"):
            ops.flash_attention(ok, ok, bad)
    assert ops.launch_counts()["flash_attention"] == before
    flat32 = _randn(gen, cuda_device, B * S * H * hd + 1)
    okf = ok.float()
    for f in (flat32[1:].view(B, S, H, hd),                 # base + 4 bytes
              _randn(gen, cuda_device, B, S, H, hd + 3)[..., :hd]):
        o = ops.flash_attention(f, okf, okf)
        torch.testing.assert_close(
            o, tref.flash_attention_gqa_ref(f, okf, okf), **FP32)


def test_flash_reads_strided_inputs(cuda_device):
    """q, k, v as slices of one fused (B, S, Hq + 2 Hk, hd) buffer, and
    as (B, H, S, hd) buffers seen through a transpose, give the bits of
    contiguous copies."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    B, S, Hq, Hk, hd = 2, 70, 8, 2, 64
    qkv = _randn(gen, cuda_device, B, S, Hq + 2 * Hk, hd).to(torch.bfloat16)
    q, k, v = qkv.split([Hq, Hk, Hk], dim=2)
    assert not q.is_contiguous()
    want = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(ops.flash_attention(q, k, v), want)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (q, k, v)]
    assert torch.equal(ops.flash_attention(*views), want)


def test_flash_refuses_what_it_cannot_run(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v = _flash_inputs(gen, cuda_device, 1, 8, 4, 2, 32, torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="is torch"):
        ops.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="unit stride"):
        ops.flash_attention(q, k, v.transpose(1, 3).contiguous()
                            .transpose(1, 3))
    with pytest.raises(ValueError, match="is on"):
        ops.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="hd in"):
        ops.flash_attention(q[..., :24], k[..., :24], v[..., :24])
    with pytest.raises(ValueError, match="multiple of Hk"):
        ops.flash_attention(q, k[:, :, :1].expand(1, 8, 3, 32),
                            v[:, :, :1].expand(1, 8, 3, 32))


def test_dense_serving_on_card_goes_through_flash(cuda_device):
    """The reduced Yi-6B on the card: one flash launch per layer in the one
    prefill of ``generate`` and none while decoding, one per layer in a
    forward, and logits that agree with the same weights on the CPU."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.model_api import Model
    from repro_torch.serving import GenerationRequest, ServingEngine
    cfg = get_config("yi-6b").reduced()
    card = Model(cfg)
    params = card.init(torch.Generator(device=cuda_device).manual_seed(0))
    cpu = Model(cfg, device="cpu")
    cpu_params = {k: ({n: ({m: t.cpu() for m, t in u.items()}
                           if isinstance(u, dict) else u.cpu())
                       for n, u in v.items()}
                      if isinstance(v, dict) else v.cpu())
                  for k, v in params.items()}
    prompts = [np.arange(n, dtype=np.int32) * 7 % 512 for n in (3, 11, 6)]
    before = ops.launch_counts()["flash_attention"]
    out = ServingEngine(card, params).generate(
        [GenerationRequest(i, p, 5) for i, p in enumerate(prompts)])
    assert ops.launch_counts()["flash_attention"] - before == cfg.n_layers
    assert [len(c.tokens) for c in out] == [5, 5, 5]
    assert all(0 <= t < cfg.vocab_size for c in out for t in c.tokens)
    toks = torch.from_numpy(np.stack([np.arange(24) * 5 % 512] * 2))
    before = ops.launch_counts()["flash_attention"]
    lc, _ = card.forward(params, {"tokens": toks.to(cuda_device)})
    assert ops.launch_counts()["flash_attention"] - before == cfg.n_layers
    lh, _ = cpu.forward(cpu_params, {"tokens": toks})
    diff = (lc.float().cpu() - lh.float()).abs()
    assert torch.isfinite(lc).all()
    assert float(diff.max()) <= 0.125 and float(diff.mean()) <= 0.02


# --- backward kernels (training) -------------------------------------------

WKV6_GRAD = dict(rtol=1e-4, atol=1e-3)
FLASH_GRAD = {torch.float32: dict(rtol=1e-4, atol=1e-4),
              torch.bfloat16: BF16}


def _wkv6_grad_inputs(gen, dev, B, S, H, K, decay):
    args = list(_wkv6_inputs(gen, dev, B, S, H, K))
    if decay == "low":
        args[3] = _low_decay(gen, dev, B, S, H, K)
    d_o = _randn(gen, dev, B, S, H, K)
    d_state = 0.1 * _randn(gen, dev, B, H, K, K)
    return args, d_o, d_state


def _wkv6_kernel_grads(args, d_o, d_state):
    """The training forward (saving its chunk states), then the backward
    kernels; counts one launch of each."""
    from repro_torch.kernels import wkv6 as kw
    before = ops.launch_counts()
    _, _, ckpt = kw._forward(*args, save=True)
    grads = kw.wkv6_backward(*args, d_o, d_state, ckpt)
    after = ops.launch_counts()
    assert after["wkv6"] - before["wkv6"] == 1
    assert after["wkv6_backward"] - before["wkv6_backward"] == 1
    return grads


# every head size; S of one step, around one 16-step chunk, several
# chunks and a ragged last chunk; decays mid and down to 1e-30
@pytest.mark.parametrize("decay", ["mid", "low"])
@pytest.mark.parametrize("S", [1, 15, 16, 17, 64, 513])
@pytest.mark.parametrize("K", [8, 16, 32, 64])
def test_wkv6_backward_matches_plain(cuda_device, K, S, decay):
    B, H = 2, 3
    gen = torch.Generator(device=cuda_device).manual_seed(K * 1000 + S)
    args, d_o, d_state = _wkv6_grad_inputs(gen, cuda_device, B, S, H, K,
                                           decay)
    grads = _wkv6_kernel_grads(args, d_o, d_state)
    want = tref.wkv6_backward_ref(*args, d_o, d_state)
    for name, got, ref in zip(("dr", "dk", "dv", "dw", "du", "ds0"), grads,
                              want):
        assert got.shape == ref.shape, name
        torch.testing.assert_close(got, ref, **WKV6_GRAD, msg=name)
    again = _wkv6_kernel_grads(args, d_o, d_state)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


# grids smaller than one wave of clusters (B·H of 1 and 2), over several
# chunks and a ragged last one, decays down to 1e-30
@pytest.mark.parametrize("B,H", [(1, 1), (1, 2)])
@pytest.mark.parametrize("K", [8, 16, 32, 64])
def test_wkv6_backward_small_grids(cuda_device, B, H, K):
    S = 513
    gen = torch.Generator(device=cuda_device).manual_seed(K + 10 * H)
    args, d_o, d_state = _wkv6_grad_inputs(gen, cuda_device, B, S, H, K,
                                           "low")
    grads = _wkv6_kernel_grads(args, d_o, d_state)
    want = tref.wkv6_backward_ref(*args, d_o, d_state)
    for name, got, ref in zip(("dr", "dk", "dv", "dw", "du", "ds0"), grads,
                              want):
        torch.testing.assert_close(got, ref, **WKV6_GRAD, msg=name)
    again = _wkv6_kernel_grads(args, d_o, d_state)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


def test_wkv6_backward_takes_unaligned_inputs(cuda_device):
    """Bases 4 bytes off a 16-byte boundary: the chunks are copied 4 bytes
    at a time, and the order of sums, so the bits, are those of aligned
    copies of the same values."""
    B, S, H, K = 2, 40, 3, 64
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    args, d_o, d_state = _wkv6_grad_inputs(gen, cuda_device, B, S, H, K,
                                           "mid")

    def shifted(t):
        flat = torch.empty(t.numel() + 1, device=cuda_device)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        assert out.data_ptr() % 16
        return out

    moved = [shifted(a) for a in args[:4]] + list(args[4:])
    got = _wkv6_kernel_grads(moved, shifted(d_o), d_state)
    want = _wkv6_kernel_grads(args, d_o, d_state)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("S", [1, 17])
def test_wkv6_training_forward_gives_the_serving_bits(cuda_device, S):
    """Saving the chunk states changes neither o nor the final state."""
    from repro_torch.kernels import wkv6 as kw
    gen = torch.Generator(device=cuda_device).manual_seed(S)
    args = _wkv6_inputs(gen, cuda_device, 2, S, 3, 64)
    o, sf, ckpt = kw._forward(*args, save=True)
    so, ssf = ops.wkv6_recurrence(*args)
    assert torch.equal(o, so) and torch.equal(sf, ssf)
    assert torch.equal(ckpt[:, :, 0], args[5])      # the first is s0


def test_wkv6_backward_reads_strided_d_o(cuda_device):
    B, S, H, K = 2, 40, 3, 32
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    args, d_o, d_state = _wkv6_grad_inputs(gen, cuda_device, B, S, H, K,
                                           "mid")
    wide = _randn(gen, cuda_device, B, S, H + 2, K)
    view = wide[:, :, 1:H + 1]
    assert not view.is_contiguous()
    got = _wkv6_kernel_grads(args, view, d_state)
    want = _wkv6_kernel_grads(args, view.contiguous(), d_state)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_wkv6_autograd_on_card(cuda_device):
    """The op under autograd: the kernels forward and backward, grads of
    every input against the plain backward."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    args, d_o, d_state = _wkv6_grad_inputs(gen, cuda_device, 2, 33, 2, 32,
                                           "mid")
    leaves = [a.clone().requires_grad_(True) for a in args]
    before = ops.launch_counts()
    o, sf = ops.wkv6_recurrence(*leaves)
    torch.autograd.backward((o, sf), (d_o, d_state))
    after = ops.launch_counts()
    assert after["wkv6"] - before["wkv6"] == 1
    assert after["wkv6_backward"] - before["wkv6_backward"] == 1
    want = tref.wkv6_backward_ref(*args, d_o, d_state)
    for leaf, ref in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, ref, **WKV6_GRAD)


@pytest.mark.parametrize("op", ["wkv6", "flash"])
def test_autograd_takes_the_expanded_grad_of_a_sum(cuda_device, op):
    """``out.sum().backward()`` hands the backward a d_o whose strides
    are all 0; the Function copies it, and the gradient is the plain
    backward's of a ones d_o."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    if op == "wkv6":
        args = _wkv6_inputs(gen, cuda_device, 2, 19, 2, 32)
        leaves = [a.clone().requires_grad_(True) for a in args]
        ops.wkv6_recurrence(*leaves)[0].sum().backward()
        want = tref.wkv6_backward_ref(*args, torch.ones_like(args[0]))
        got = [t.grad for t in leaves]
        tol = WKV6_GRAD
    else:
        q, k, v = _flash_inputs(gen, cuda_device, 2, 40, 4, 2, 32,
                                torch.bfloat16)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ops.flash_attention(*leaves).sum().backward()
        from repro_torch.kernels import flash_attention as kf
        o, lse = kf._forward(q, k, v, True, 0, want_lse=True)
        want = tref.flash_attention_backward_ref(q, k, v, o, lse,
                                                 torch.ones_like(q))
        got = [t.grad for t in leaves]
        tol = BF16
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), **tol)


def _flash_grads(q, k, v, d_o, causal, window):
    """(kernel grads, plain grads) from the kernel's forward outputs."""
    from repro_torch.kernels import flash_attention as kf
    before = ops.launch_counts()
    o, lse = kf._forward(q, k, v, causal, window, want_lse=True)
    got = kf.flash_attention_backward(q, k, v, o, lse, d_o, causal=causal,
                                      window=window)
    after = ops.launch_counts()
    assert after["flash_attention"] - before["flash_attention"] == 1
    assert (after["flash_attention_backward"]
            - before["flash_attention_backward"]) == 1
    torch.testing.assert_close(
        lse, tref.flash_attention_lse_ref(q, k, causal=causal,
                                          window=window),
        rtol=1e-5, atol=1e-4)
    want = tref.flash_attention_backward_ref(q, k, v, o, lse, d_o,
                                             causal=causal, window=window)
    return got, want


# every hd, S around the 32- and 64-row tiles and 513, in both types,
# GQA G = 4, causal
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 31, 32, 33, 64, 513])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_flash_backward_matches_plain(cuda_device, hd, S, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(hd * 1000 + S)
    q, k, v = _flash_inputs(gen, cuda_device, 2, S, 8, 2, hd, dtype)
    d_o = _randn(gen, cuda_device, 2, S, 8, hd).to(dtype)
    got, want = _flash_grads(q, k, v, d_o, True, 0)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        torch.testing.assert_close(a.float(), b.float(), **FLASH_GRAD[dtype],
                                   msg=name)
    again, _ = _flash_grads(q, k, v, d_o, True, 0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("causal,window", [(True, 7), (True, 40),
                                           (False, 0), (False, 9)])
def test_flash_backward_masks(cuda_device, causal, window, G, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(G * 100 + window)
    q, k, v = _flash_inputs(gen, cuda_device, 2, 130, 2 * G, 2, 64, dtype)
    d_o = _randn(gen, cuda_device, 2, 130, 2 * G, 64).to(dtype)
    got, want = _flash_grads(q, k, v, d_o, causal, window)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), **FLASH_GRAD[dtype])


# the bfloat16 backward's edges: G = 1, 3, 4 and 8 (at G = 3 the cluster's
# cut of a key tile's (head, query tile) pairs falls inside a head); S off
# the 64-row tile; causal, a window shorter than a tile, and one longer
@pytest.mark.parametrize("S", [1, 63, 65, 513])
@pytest.mark.parametrize("G", [1, 3, 4, 8])
def test_flash_backward_bf16_cluster_edges(cuda_device, G, S):
    gen = torch.Generator(device=cuda_device).manual_seed(G * 1000 + S)
    q, k, v = _flash_inputs(gen, cuda_device, 2, S, 2 * G, 2, 64,
                            torch.bfloat16)
    d_o = _randn(gen, cuda_device, 2, S, 2 * G, 64).to(torch.bfloat16)
    for causal, window in ((True, 0), (True, 9), (True, 100)):
        got, want = _flash_grads(q, k, v, d_o, causal, window)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            torch.testing.assert_close(a.float(), b.float(), **BF16,
                                       msg=f"{name} window {window}")
        again, _ = _flash_grads(q, k, v, d_o, causal, window)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_reads_strided_d_o(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v = _flash_inputs(gen, cuda_device, 2, 70, 4, 2, 32, dtype)
    wide = _randn(gen, cuda_device, 2, 70, 6, 32).to(dtype)
    view = wide[:, :, 2:]
    assert not view.is_contiguous()
    got, _ = _flash_grads(q, k, v, view, True, 0)
    want, _ = _flash_grads(q, k, v, view.contiguous(), True, 0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_flash_backward_bf16_refuses_unaligned_d_o(cuda_device):
    """The tensor-core backward copies 16-byte pieces of dO; the autograd
    Function hands it a contiguous copy of anything else."""
    from repro_torch.kernels import flash_attention as kf
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v = _flash_inputs(gen, cuda_device, 1, 40, 2, 2, 32,
                            torch.bfloat16)
    flat = _randn(gen, cuda_device, 1 * 40 * 2 * 32 + 1).to(torch.bfloat16)
    d_o = flat[1:].view(1, 40, 2, 32)            # base off by 2 bytes
    o, lse = kf._forward(q, k, v, True, 0, want_lse=True)
    with pytest.raises(ValueError, match="16-byte"):
        kf.flash_attention_backward(q, k, v, o, lse, d_o)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ops.flash_attention(*leaves).backward(d_o)
    want = kf.flash_attention_backward(q, k, v, o, lse, d_o.clone())
    assert all(torch.equal(a.grad, b) for a, b in zip(leaves, want))


def _loss_grads(model, params, batch):
    from repro_torch.fl.adapters import _flat, _nested
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in _flat(params).items()}
    loss = model.loss(_nested(leaves), batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


def _tree_to(tree, dev):
    return {k: _tree_to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


@pytest.mark.parametrize("family", ["rwkv6", "transformer"])
def test_model_loss_gradients_on_card_match_cpu(cuda_device, family):
    """Every parameter gets a gradient through the kernels on the card,
    and it agrees with the CPU's (the pin of the graphless kernel
    outputs): the reduced RWKV-6 (1 layer, d_model 64, 2 heads of 32) and
    the tiny dense transformer."""
    import numpy as np
    from repro_torch.fl.adapters import (tiny_rwkv6_config,
                                         tiny_transformer_config)
    from repro_torch.models.model_api import Model
    cfg = (tiny_rwkv6_config(n_layers=1) if family == "rwkv6"
           else tiny_transformer_config())
    cpu = Model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    rows = np.random.default_rng(0).integers(0, min(cfg.vocab_size, 512),
                                             (4, 17)).astype(np.int64)
    batch = {"tokens": torch.from_numpy(rows[:, :-1]),
             "labels": torch.from_numpy(rows[:, 1:])}
    card = Model(cfg, device=cuda_device)
    before = ops.launch_counts()
    loss_c, g_card = _loss_grads(card, _tree_to(params, cuda_device),
                                 _tree_to(batch, cuda_device))
    after = ops.launch_counts()
    kernel = "wkv6" if family == "rwkv6" else "flash_attention"
    assert after[kernel] - before[kernel] == cfg.n_layers
    assert (after[kernel + "_backward"] - before[kernel + "_backward"]
            == cfg.n_layers)
    loss_h, g_cpu = _loss_grads(cpu, params, batch)
    assert abs(loss_c - loss_h) <= 0.02
    assert set(g_card) == set(g_cpu)
    for name, gh in g_cpu.items():
        gc = g_card[name].float().cpu()
        assert torch.isfinite(gc).all(), name
        scale = float(gh.float().abs().max())
        diff = (gc - gh.float()).abs()
        assert float(diff.max()) <= 0.125 * scale, name
        assert float(diff.mean()) <= 0.02 * scale, name


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "yi-6b", "zamba2-7b",
                                  "deepseek-moe-16b", "musicgen-medium",
                                  "llama-3.2-vision-90b"])
def test_remat_gradients_on_card(cuda_device, arch):
    """``FwdOptions(remat=True)`` under ``torch.func.vmap`` of
    ``grad_and_value`` over 2 replicas on the card: the losses equal
    those without remat bit for bit, and so does every gradient leaf (the
    re-run block computes as the first run did, with the same kernels;
    ``tests/test_torch_remat.py`` holds the CPU alike); each rematerialized
    block launches its forward kernel once more, in the backward, and
    the backward kernel once, as without remat."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.serialization import leaves_with_paths
    from repro_torch.models.model_api import Model
    from repro_torch.models.transformer import FwdOptions
    model = Model(get_config(arch).reduced(), device=cuda_device)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    rows = np.random.default_rng(0).integers(0, 500, (2, 2, 17))
    batch = {"tokens": torch.from_numpy(rows[..., :-1]).to(cuda_device),
             "labels": torch.from_numpy(rows[..., 1:]).to(cuda_device)}
    if model.needs_context():
        batch["context"] = 0.1 * torch.ones(
            (2,) + model.context_shape(2), dtype=torch.bfloat16,
            device=cuda_device)
    reps = {k: v for k, v in params.items()}
    reps = torch.utils._pytree.tree_map(
        lambda t: t[None].expand(2, *t.shape), reps)
    got = {}
    for remat in (False, True):
        opts = FwdOptions(remat=remat)
        before = ops.launch_counts()
        got[remat] = torch.func.vmap(torch.func.grad_and_value(
            lambda p, b: model.loss(p, b, opts)))(reps, batch)
        after = ops.launch_counts()
        got[remat] += ({k: after[k] - before[k] for k in after},)
    (g0, l0, n0), (g1, l1, n1) = got[False], got[True]
    assert torch.equal(l0, l1)
    assert [p for p, _ in leaves_with_paths(g0)] == \
        [p for p, _ in leaves_with_paths(g1)]
    for (name, a), (_, b) in zip(leaves_with_paths(g0),
                                 leaves_with_paths(g1)):
        assert torch.isfinite(b).all(), name
        assert torch.equal(a, b), name
    cfg = model.cfg
    kernel = "wkv6" if cfg.rwkv else "flash_attention"
    # the hybrid's shared attention block is not rematerialized
    again = 0 if cfg.family == "hybrid" else n0[kernel]
    assert n1[kernel] == n0[kernel] + again
    assert n1[kernel + "_backward"] == n0[kernel + "_backward"] > 0


@pytest.mark.parametrize("model", ["rwkv6", "transformer"])
def test_run_bhfl_lm_on_card_goes_through_kernels(cuda_device, model):
    """An LM round on the card: every SGD step launches the forward and
    the backward kernel once a layer, every evaluation the forward."""
    data = api.make_token_dataset(32, 16, 64, seed=1)
    before = ops.launch_counts()
    run = api.run_bhfl(model=model, n_nodes=2, clients_per_node=2,
                       fel_iterations=1, rounds=1, seed=1, data=data)
    after = ops.launch_counts()
    assert run.chain_valid and run.chain_height == 1
    assert all(math.isfinite(m.test_loss) for m in run.history)
    layers = run.runtime.adapter.arch.n_layers
    steps = sum(c.data_size // min(8, c.data_size)
                for cl in run.runtime.clusters for c in cl.clients
                if c.data_size)
    kernel = "wkv6" if model == "rwkv6" else "flash_attention"
    assert after[kernel + "_backward"] - before[kernel + "_backward"] == \
        layers * steps
    assert after[kernel] - before[kernel] == layers * (steps + 1)


# ---------------------------------------------------------------------------
# the kernels under torch.func.vmap, and the batched FEL engine
# ---------------------------------------------------------------------------

def _counts_delta(before):
    after = ops.launch_counts()
    return {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("V,B,S,H,K", [(24, 8, 16, 2, 32), (3, 2, 33, 2, 64),
                                       (2, 1, 17, 1, 8)])
def test_wkv6_folded_launch_is_v_launches(cuda_device, V, B, S, H, K):
    """A vmapped call folds the V batch members into the heads: one
    forward and one backward launch, bit-identical to V separate launches
    (the geometry and every sum's order depend on K alone; du's fold over
    b runs per head)."""
    from torch.func import vmap
    from repro_torch.kernels import wkv6 as kw
    gen = torch.Generator(device=cuda_device).manual_seed(V * S + K)
    r, k, v, d_o = (_randn(gen, cuda_device, V, B, S, H, K) for _ in range(4))
    w = 0.2 + 0.79 * torch.rand(V, B, S, H, K, generator=gen,
                                device=cuda_device)
    u = _randn(gen, cuda_device, V, H, K)
    s0 = torch.zeros(B, H, K, K, device=cuda_device)     # unbatched
    before = ops.launch_counts()
    o, s_fin, ckpt = vmap(kw._Recurrence.apply,
                          in_dims=(0, 0, 0, 0, 0, None, None))(
        r, k, v, w, u, s0, True)
    grads = vmap(kw._RecurrenceBackward.apply,
                 in_dims=(0, 0, 0, 0, 0, None, 0, None, 0))(
        r, k, v, w, u, s0, d_o, None, ckpt)
    delta = _counts_delta(before)
    assert delta["wkv6"] == 1 and delta["wkv6_backward"] == 1
    for i in range(V):
        oi, si, ci = kw._forward(r[i], k[i], v[i], w[i], u[i], s0, save=True)
        assert torch.equal(o[i], oi) and torch.equal(s_fin[i], si)
        assert torch.equal(ckpt[i], ci)
        gi = kw.wkv6_backward(r[i], k[i], v[i], w[i], u[i], s0, d_o[i],
                              None, ci)
        for got, want in zip(grads, gi):
            assert torch.equal(got[i], want)


@pytest.mark.parametrize("V,B,S,Hq,Hk,hd", [(24, 8, 16, 2, 2, 32),
                                            (4, 2, 512, 32, 4, 128),
                                            (3, 2, 65, 4, 1, 64)])
def test_flash_folded_launch_is_v_launches(cuda_device, V, B, S, Hq, Hk, hd):
    """A vmapped call folds the V batch members into the batch: one
    forward and one backward launch (bfloat16, the models' dtype),
    bit-identical to V separate launches."""
    from torch.func import vmap
    from repro_torch.kernels import flash_attention as kf
    gen = torch.Generator(device=cuda_device).manual_seed(V * S + hd)
    q, d_o = (_randn(gen, cuda_device, V, B, S, Hq, hd).to(torch.bfloat16)
              for _ in range(2))
    k, v = (_randn(gen, cuda_device, V, B, S, Hk, hd).to(torch.bfloat16)
            for _ in range(2))
    before = ops.launch_counts()
    o, lse = vmap(kf._Attention.apply, in_dims=(0, 0, 0, None, None, None))(
        q, k, v, True, 0, True)
    grads = vmap(kf._AttentionBackward.apply,
                 in_dims=(0, 0, 0, 0, 0, 0, None, None))(
        q, k, v, o, lse, d_o, True, 0)
    delta = _counts_delta(before)
    assert delta["flash_attention"] == 1
    assert delta["flash_attention_backward"] == 1
    for i in range(V):
        oi, li = kf._forward(q[i], k[i], v[i], True, 0, want_lse=True)
        assert torch.equal(o[i], oi) and torch.equal(lse[i], li)
        gi = kf.flash_attention_backward(q[i], k[i], v[i], oi, li, d_o[i])
        for got, want in zip(grads, gi):
            assert torch.equal(got[i], want)


def test_me_kernels_under_the_sharded_phase(cuda_device):
    """Sharded ME on the card: two launches a shard, gw bit-identical to
    the dense ME's (Eq. 1 sums each column over N in one order whatever
    the shard), similarities within rtol 1e-5, the same vote."""
    from repro_torch.fl.sharded_consensus import (shard_flat,
                                                  sharded_model_evaluation)
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    W = _randn(gen, cuda_device, 8, 101_770)
    sizes = torch.rand(8, generator=gen, device=cuda_device) * 99 + 1
    dense = model_evaluation(W, sizes)
    before = ops.launch_counts()
    sh = sharded_model_evaluation(shard_flat(W, 4), sizes)
    delta = _counts_delta(before)
    assert delta["cosine_partials"] == 4 and delta["weighted_aggregate"] == 4
    assert torch.equal(sh.global_model, dense.global_model)
    torch.testing.assert_close(sh.similarities, dense.similarities,
                               rtol=1e-5, atol=0)
    assert int(sh.vote) == int(dense.vote)


def test_run_bhfl_batched_mlp_matches_the_loop_on_card(cuda_device):
    """engine="batched" against engine="reference" on the card, dropout
    on (the engine draws the loop's masks): the same leaders, gw within
    rtol 1e-5 / atol 1e-6 every round (cuBLAS may round a batched product
    and a single one differently). Label-skewed shards at lr 0.05 keep
    the top-2 similarity margin far above float32 rounding, so the
    leader is the data's pick, not the rounding's."""
    from repro_torch.models.mlp import MLPConfig
    kw = dict(model="mlp", n_nodes=4, clients_per_node=3, fel_iterations=2,
              rounds=2, seed=2, mlp=MLPConfig(hidden=64),
              distribution="label", lr=0.05,
              data=api.make_mnist_like(720, 60, seed=2))
    ref = api.run_bhfl(engine="reference", **kw)
    bat = api.run_bhfl(engine="batched", **kw)
    assert bat.runtime.engine == "batched" and bat.chain_valid
    assert [m.leader_id for m in bat.history] == \
        [m.leader_id for m in ref.history]
    for mr, mb in zip(ref.history, bat.history):
        torch.testing.assert_close(mb.consensus.global_model,
                                   mr.consensus.global_model,
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("model", ["rwkv6", "transformer"])
def test_run_bhfl_batched_lm_launches_once_a_layer_a_step(cuda_device, model):
    """A batched LM round on the card: every vmapped SGD step launches the
    forward and the backward kernel once a layer for all the clients,
    every evaluation the forward once a layer."""
    data = api.make_token_dataset(48, 16, 64, seed=1)
    before = ops.launch_counts()
    run = api.run_bhfl(model=model, n_nodes=2, clients_per_node=3,
                       fel_iterations=2, rounds=1, seed=1, data=data,
                       engine="batched")
    delta = _counts_delta(before)
    assert run.runtime.engine == "batched"
    assert run.chain_valid and run.chain_height == 1
    assert all(math.isfinite(m.test_loss) for m in run.history)
    layers = run.runtime.adapter.arch.n_layers
    eng = run.runtime._engine
    steps = eng.fel_iterations * eng.steps_per_iteration
    kernel = "wkv6" if model == "rwkv6" else "flash_attention"
    assert delta[kernel + "_backward"] == layers * steps
    assert delta[kernel] == layers * (steps + 1)


# -- the simulator and the consortium on the card -------------------------

def _completed(history):
    return sum(1 for m in history if m.consensus is not None)


def test_run_bhfl_scenario_on_card_launches_me_once_a_round(cuda_device):
    """``byzantine_third`` on the card: live, safe, and each ME kernel
    launched once per completed round."""
    before = ops.launch_counts()
    run = api.run_bhfl(scenario="byzantine_third", seed=0)
    delta = _counts_delta(before)
    rep = run.scenario_report
    assert rep.liveness and rep.safety_violations == 0 and rep.converged
    assert run.runtime.global_params["w1"].is_cuda
    n = _completed(run.history)
    assert n == rep.completed_rounds == 6
    assert delta["cosine_partials"] == delta["weighted_aggregate"] == n


def _mini(device):
    from repro_torch.sim import Scenario
    sc = Scenario(name="consortium_mini",
                  description="3 committees of 4 on a clean bus",
                  rounds=2, n_nodes=12, clients_per_node=1, committees=3,
                  checkpoint_interval=1, n_train=96, n_test=32)
    return api.run_bhfl(scenario=sc, seed=0, device=device)


def test_mini_consortium_on_card_matches_cpu(cuda_device):
    """3 committees of 4: each ME kernel once per completed shard round;
    the report's structure equals the same run's on the CPU (which
    committees, rounds, checkpoints, heights, traffic), the head hashes
    and the leaders aside (HCDS nonces; float32 ties between cuBLAS and
    the CPU)."""
    before = ops.launch_counts()
    card = _mini(None)
    delta = _counts_delta(before)
    cpu = _mini("cpu")
    n = _completed(card.history)
    assert n == 6
    assert delta["cosine_partials"] == delta["weighted_aggregate"] == n
    rc, rp = card.scenario_report, cpu.scenario_report
    for field in ("n_nodes", "quorum", "committees", "completed_rounds",
                  "aborted_rounds", "liveness", "safety_violations",
                  "converged", "top_chain_height", "top_chain_converged",
                  "cross_shard_checkpoints", "final_heights", "net_stats",
                  "rejected_envelopes", "retransmits", "recoveries"):
        assert getattr(rc, field) == getattr(rp, field), field
    assert [(c.committee_id, c.members, c.completed_rounds,
             c.checkpoints_emitted, c.checkpoints_merged, c.final_height)
            for c in rc.committee_reports] == \
        [(c.committee_id, c.members, c.completed_rounds,
          c.checkpoints_emitted, c.checkpoints_merged, c.final_height)
         for c in rp.committee_reports]
    assert [(r.round, r.committee, r.aborted, r.available, r.rejected)
            for r in rc.rounds] == \
        [(r.round, r.committee, r.aborted, r.available, r.rejected)
         for r in rp.rounds]
    assert card.runtime.verify_chains()
    for shard in card.runtime.shards:
        assert shard.global_params["w1"].is_cuda


def test_edge_churn_batched_on_card_keeps_the_down_row(cuda_device,
                                                        monkeypatch):
    """``edge_churn`` on the batched engine: while node 5 is down its row
    of W(k) is the global model it went down with, on the card."""
    from repro_torch.fl.hfl_runtime import BHFLRuntime
    real = BHFLRuntime._fel_models_batched
    seen = []

    def spy(self, round_seed, down=None):
        before = self._global_flat.clone()
        models = real(self, round_seed, down=down)
        for i in sorted(down or ()):
            seen.append((self.consensus.round, i,
                         torch.equal(models[i], before), models[i].is_cuda))
        return models

    monkeypatch.setattr(BHFLRuntime, "_fel_models_batched", spy)
    run = api.run_bhfl(scenario="edge_churn", seed=0, engine="batched")
    rep = run.scenario_report
    assert run.runtime.engine == "batched"
    assert seen == [(2, 5, True, True), (3, 5, True, True)]
    assert rep.liveness and rep.safety_violations == 0 and rep.converged


# ---------------------------------------------------------------------------
# the hybrid and MoE families: flash at head dim 112, the models on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hk", [(8, 512, 32, 32), (8, 64, 32, 32),
                                       (2, 1, 2, 2), (2, 57, 4, 4),
                                       (1, 130, 8, 1), (2, 513, 4, 2)])
def test_flash_hd112_matches_plain(cuda_device, B, S, Hq, Hk, dtype):
    """Zamba2-7B's shared attention (32 query and kv heads of 112) and
    ragged lengths, G 1, 2 and 8: within tolerance of the plain version,
    bit-identical on repeat, one launch each."""
    gen = torch.Generator(device=cuda_device).manual_seed(B * S + Hq)
    q, k, v = _flash_inputs(gen, cuda_device, B, S, Hq, Hk, 112, dtype)
    before = ops.launch_counts()["flash_attention"]
    o = ops.flash_attention(q, k, v)
    assert ops.launch_counts()["flash_attention"] == before + 1
    torch.testing.assert_close(o, tref.flash_attention_gqa_ref(q, k, v),
                               **(BF16 if dtype == torch.bfloat16 else FP32))
    assert torch.equal(o, ops.flash_attention(q, k, v))


@pytest.mark.parametrize("causal,window", [(True, 40), (False, 0),
                                           (False, 50)])
def test_flash_hd112_windows_and_non_causal(cuda_device, causal, window):
    gen = torch.Generator(device=cuda_device).manual_seed(window + 1)
    q, k, v = _flash_inputs(gen, cuda_device, 2, 333, 8, 2, 112,
                            torch.bfloat16)
    kw = dict(causal=causal, window=window)
    o = ops.flash_attention(q, k, v, **kw)
    torch.testing.assert_close(
        o, tref.flash_attention_gqa_ref(q, k, v, **kw), **BF16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_hd112_autograd_matches_plain(cuda_device, dtype):
    """Autograd through the op at hd 112 launches the backward pair once
    and matches the plain backward."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (t.requires_grad_(True) for t in
               _flash_inputs(gen, cuda_device, 1, 64, 2, 2, 112, dtype))
    o = ops.flash_attention(q, k, v)
    before = ops.launch_counts()["flash_attention_backward"]
    o.sum().backward()
    assert ops.launch_counts()["flash_attention_backward"] == before + 1
    lse = tref.flash_attention_lse_ref(q.detach(), k.detach())
    want = tref.flash_attention_backward_ref(
        q.detach(), k.detach(), v.detach(), o.detach(), lse,
        torch.ones_like(o))
    for a, b in zip((q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(a.float(), b.float(), **FLASH_GRAD[dtype])


# Zamba2-7B's shared attention (32 heads of 112) and ragged lengths, G 1,
# 2 and 8, causal and windowed, in both types
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hk,causal,window", [
    (8, 512, 32, 32, True, 0), (8, 64, 32, 32, True, 0),
    (2, 1, 2, 2, True, 0), (2, 57, 4, 4, True, 0), (1, 130, 8, 1, True, 0),
    (2, 513, 4, 2, True, 0), (2, 333, 8, 2, True, 40),
    (2, 100, 4, 4, False, 0)])
def test_flash_backward_hd112_matches_plain(cuda_device, B, S, Hq, Hk,
                                            causal, window, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(B * S + Hq + 112)
    q, k, v = _flash_inputs(gen, cuda_device, B, S, Hq, Hk, 112, dtype)
    d_o = _randn(gen, cuda_device, B, S, Hq, 112).to(dtype)
    got, want = _flash_grads(q, k, v, d_o, causal, window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        torch.testing.assert_close(a.float(), b.float(), **FLASH_GRAD[dtype],
                                   msg=name)
    again, _ = _flash_grads(q, k, v, d_o, causal, window)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("name", ["zamba2-7b", "deepseek-moe-16b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_hybrid_and_moe_forward_on_card_match_cpu(cuda_device, name):
    """The reduced models with one set of weights on the card and the
    CPU: one flash launch a shared block (hybrid) or a layer (MoE), logits
    within the bfloat16 rule, the MoE aux loss within the bfloat16
    tolerance (a float32 router over the bfloat16 hidden states, which
    the two backends round apart). The MoE card run takes the CPU run's
    expert choices
    (``chip_smoke.RoutingTape``; bfloat16 rounding flips a choice where
    the router is near a tie, and a flipped expert moves that token's
    logits far beyond the rule), and its own choices must agree where the
    CPU's router margin is clear."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.model_api import Model
    from repro_torch.models.ssm_models import hybrid_group_shape
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import RoutingTape
    cfg = get_config(name).reduced()
    card = Model(cfg)
    params = card.init(torch.Generator(device=cuda_device).manual_seed(0))
    cpu = Model(cfg, device="cpu")
    toks = torch.from_numpy(np.stack([np.arange(24) * 5 % 512,
                                      np.arange(24) * 11 % 512]))
    tape = RoutingTape()
    with tape:
        lh, ah = cpu.forward(_tree_to(params, "cpu"), {"tokens": toks})
    before = ops.launch_counts()["flash_attention"]
    with tape:
        lc, ac = card.forward(params, {"tokens": toks.to(cuda_device)})
    want = (hybrid_group_shape(cfg)[0] if cfg.family == "hybrid"
            else cfg.n_layers)
    assert ops.launch_counts()["flash_attention"] - before == want
    assert tape.at == len(tape.tape) == (cfg.n_layers if cfg.n_experts
                                         else 0)
    assert tape.mismatched == 0
    diff = (lc.float().cpu() - lh.float()).abs()
    assert torch.isfinite(lc).all()
    assert float(diff.max()) <= 0.125 and float(diff.mean()) <= 0.02
    torch.testing.assert_close(ac.cpu(), ah, **BF16)


@pytest.mark.parametrize("name", ["zamba2-7b", "deepseek-moe-16b"])
def test_run_bhfl_hybrid_and_moe_on_card_go_through_kernels(cuda_device,
                                                           name):
    """An LM round of the reduced hybrid or MoE model on the card: every
    SGD step launches the forward and the backward kernel once an
    attention layer, every evaluation the forward."""
    from repro_torch.configs import get_config
    from repro_torch.models.ssm_models import hybrid_group_shape
    cfg = get_config(name).reduced()
    data = api.make_token_dataset(32, 16, cfg.vocab_size, seed=1)
    before = ops.launch_counts()
    run = api.run_bhfl(model=api.LMAdapter(cfg), n_nodes=2,
                       clients_per_node=2, fel_iterations=1, rounds=1,
                       seed=1, data=data)
    after = ops.launch_counts()
    assert run.chain_valid and run.chain_height == 1
    assert all(math.isfinite(m.test_loss) for m in run.history)
    layers = (hybrid_group_shape(cfg)[0] if cfg.family == "hybrid"
              else cfg.n_layers)
    steps = sum(c.data_size // min(8, c.data_size)
                for cl in run.runtime.clusters for c in cl.clients
                if c.data_size)
    assert after["flash_attention_backward"] - \
        before["flash_attention_backward"] == layers * steps
    assert after["flash_attention"] - before["flash_attention"] == \
        layers * (steps + 1)


# keys of their own length (cross-attention), non-causal: (B, Sq, Skv, Hq,
# Hk, hd, dtype) at chip_smoke.py's FLASH_CROSS_CASES (Llama-3.2-Vision's
# and MusicGen's prefill and forward), a ragged Skv in a G = 4 group, and
# Sq > Skv
CROSS_CASES = [
    (8, 57, 1024, 64, 8, 128, torch.bfloat16),
    (8, 512, 1024, 64, 8, 128, torch.bfloat16),
    (8, 57, 256, 24, 24, 64, torch.bfloat16),
    (8, 512, 256, 24, 24, 64, torch.bfloat16),
    (8, 512, 256, 24, 24, 64, torch.float32),
    (2, 57, 100, 8, 2, 64, torch.bfloat16),
    (2, 57, 100, 8, 2, 64, torch.float32),
    (2, 512, 16, 8, 8, 32, torch.bfloat16),
    (3, 5, 70, 4, 1, 112, torch.bfloat16),
]


def _cross_inputs(gen, dev, B, Sq, Skv, Hq, Hk, hd, dtype):
    return (_randn(gen, dev, B, Sq, Hq, hd).to(dtype),
            _randn(gen, dev, B, Skv, Hk, hd).to(dtype),
            _randn(gen, dev, B, Skv, Hk, hd).to(dtype))


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hk,hd,dtype", CROSS_CASES)
def test_flash_keys_of_their_own_length_match_plain(cuda_device, B, Sq, Skv,
                                                    Hq, Hk, hd, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(Sq * Skv + hd)
    q, k, v = _cross_inputs(gen, cuda_device, B, Sq, Skv, Hq, Hk, hd, dtype)
    before = ops.launch_counts()["flash_attention"]
    o = ops.flash_attention(q, k, v, causal=False)
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert o.dtype == dtype and o.shape == q.shape
    ref = tref.flash_attention_gqa_ref(q, k, v, causal=False)
    torch.testing.assert_close(o, ref, **(BF16 if dtype == torch.bfloat16
                                          else FP32))
    assert torch.equal(o, ops.flash_attention(q, k, v, causal=False))


def test_flash_keys_of_their_own_length_fold_under_vmap(cuda_device):
    """A vmapped cross-attention folds the V batch members into the batch:
    one launch, bit-identical to V separate ones."""
    from torch.func import vmap
    from repro_torch.kernels import flash_attention as kf
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    V, B, Sq, Skv, Hq, Hk, hd = 4, 2, 33, 80, 4, 2, 64
    q = _randn(gen, cuda_device, V, B, Sq, Hq, hd).to(torch.bfloat16)
    k, v = (_randn(gen, cuda_device, V, B, Skv, Hk, hd).to(torch.bfloat16)
            for _ in range(2))
    before = ops.launch_counts()
    o, _ = vmap(kf._Attention.apply, in_dims=(0, 0, 0, None, None, None))(
        q, k, v, False, 0, False)
    assert _counts_delta(before)["flash_attention"] == 1
    for i in range(V):
        assert torch.equal(o[i], ops.flash_attention(q[i], k[i], v[i],
                                                     causal=False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_own_keys_autograd_matches_plain(cuda_device, dtype):
    """Autograd through a cross-attention (Skv != Sq) launches the
    backward pair once, dk and dv of the keys' length, within tolerance
    of the plain backward. A causal mask with Skv != Sq stays refused."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v = _cross_inputs(gen, cuda_device, 1, 64, 256, 2, 2, 64, dtype)
    for t in (q, k, v):
        t.requires_grad_(True)
    o = ops.flash_attention(q, k, v, causal=False)
    before = ops.launch_counts()["flash_attention_backward"]
    o.sum().backward()
    assert ops.launch_counts()["flash_attention_backward"] == before + 1
    assert k.grad.shape == k.shape and v.grad.shape == v.shape
    lse = tref.flash_attention_lse_ref(q.detach(), k.detach(), causal=False)
    want = tref.flash_attention_backward_ref(
        q.detach(), k.detach(), v.detach(), o.detach(), lse,
        torch.ones_like(o), causal=False)
    for a, b in zip((q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(a.float(), b.float(), **FLASH_GRAD[dtype])
    with pytest.raises(ValueError, match="Skv 256 != Sq 64"):
        ops.flash_attention(q, k, v, causal=True)


# the trainer's cross-attention shapes (Llama-3.2-Vision, MusicGen, the
# folded (8, 64 -> 256) of four clusters), ragged Skv, Sq > Skv
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hk,hd,dtype", [
    (8, 512, 1024, 64, 8, 128, torch.bfloat16),
    (8, 512, 256, 24, 24, 64, torch.bfloat16),
    (8, 512, 256, 24, 24, 64, torch.float32),
    (8, 64, 256, 24, 24, 64, torch.bfloat16),
    (2, 57, 100, 8, 2, 64, torch.bfloat16),
    (2, 57, 100, 8, 2, 64, torch.float32),
    (2, 512, 16, 8, 8, 32, torch.bfloat16),
    (2, 512, 16, 8, 8, 32, torch.float32),
    (3, 5, 70, 4, 1, 112, torch.bfloat16),
    (3, 5, 70, 4, 1, 112, torch.float32)])
def test_flash_backward_keys_of_their_own_length_match_plain(
        cuda_device, B, Sq, Skv, Hq, Hk, hd, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(Sq * Skv + hd + 7)
    q, k, v = _cross_inputs(gen, cuda_device, B, Sq, Skv, Hq, Hk, hd, dtype)
    d_o = _randn(gen, cuda_device, B, Sq, Hq, hd).to(dtype)
    got, want = _flash_grads(q, k, v, d_o, False, 0)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        torch.testing.assert_close(a.float(), b.float(), **FLASH_GRAD[dtype],
                                   msg=name)
    again, _ = _flash_grads(q, k, v, d_o, False, 0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_flash_backward_keys_of_their_own_length_fold_under_vmap(
        cuda_device):
    """A vmapped cross-attention backward folds the V batch members into
    the batch: one backward call, bit-identical to V separate ones."""
    from torch.func import vmap
    from repro_torch.kernels import flash_attention as kf
    gen = torch.Generator(device=cuda_device).manual_seed(22)
    V, B, Sq, Skv, Hq, Hk, hd = 4, 2, 64, 256, 4, 2, 64
    q = _randn(gen, cuda_device, V, B, Sq, Hq, hd).to(torch.bfloat16)
    k, v = (_randn(gen, cuda_device, V, B, Skv, Hk, hd).to(torch.bfloat16)
            for _ in range(2))
    d_o = _randn(gen, cuda_device, V, B, Sq, Hq, hd).to(torch.bfloat16)
    o, lse = vmap(kf._Attention.apply, in_dims=(0, 0, 0, None, None, None))(
        q, k, v, False, 0, True)
    before = ops.launch_counts()
    grads = vmap(kf._AttentionBackward.apply,
                 in_dims=(0, 0, 0, 0, 0, 0, None, None))(
        q, k, v, o, lse, d_o, False, 0)
    assert _counts_delta(before)["flash_attention_backward"] == 1
    for i in range(V):
        one = kf.flash_attention_backward(q[i], k[i], v[i], o[i], lse[i],
                                          d_o[i], causal=False)
        assert all(torch.equal(a[i], b) for a, b in zip(grads, one))


@pytest.mark.parametrize("name", ["llama-3.2-vision-90b", "musicgen-medium"])
def test_cross_attention_forward_on_card_matches_cpu(cuda_device, name):
    """The reduced cross-attention models with one set of weights (the vlm
    gates nonzero) and one context on the card and the CPU: one flash
    launch a self- and a cross-attention, logits within the bfloat16
    rule."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.model_api import Model
    cfg = get_config(name).reduced()
    card = Model(cfg)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = card.init(gen)
    for g in ("gate_attn", "gate_mlp"):
        if g in params.get("cross_layers", {}):
            params["cross_layers"][g] = torch.randn(
                params["cross_layers"][g].shape, generator=gen,
                device=cuda_device)
    toks = torch.from_numpy(np.stack([np.arange(24) * 5 % 512,
                                      np.arange(24) * 11 % 512]))
    ctx = torch.randn(card.context_shape(2), generator=gen,
                      device=cuda_device)
    lh, _ = Model(cfg, device="cpu").forward(
        _tree_to(params, "cpu"), {"tokens": toks, "context": ctx.cpu()})
    before = ops.launch_counts()["flash_attention"]
    shapes = ops.flash_launch_shapes()
    lc, _ = card.forward(params, {"tokens": toks.to(cuda_device),
                                  "context": ctx})
    # vlm: one group of a self-attention layer and a cross block; audio:
    # two layers, each with its cross-attention
    want = 2 if cfg.family == "vlm" else 4
    assert ops.launch_counts()["flash_attention"] - before == want
    # half of them causal over the tokens, half to the Nc context keys
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.hd, "bfloat16")
    self_key = (2, 24, 24, *heads, True, 0)
    cross_key = (2, 24, cfg.n_context_tokens, *heads, False, 0)
    after = ops.flash_launch_shapes()
    assert {k: n - shapes.get(k, 0) for k, n in after.items()
            if n != shapes.get(k, 0)} == {self_key: want // 2,
                                          cross_key: want // 2}
    diff = (lc.float().cpu() - lh.float()).abs()
    assert torch.isfinite(lc).all()
    assert float(diff.max()) <= 0.125 and float(diff.mean()) <= 0.02


# ---------------------------------------------------------------------------
# the kernels as torch.library custom ops, and on DTensors
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card_mesh():
    """The card's 1 × 1 NCCL mesh (``make_host_mesh``), destroyed after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    if dist.is_initialized():
        dist.destroy_process_group()
    yield make_host_mesh("cuda")
    dist.destroy_process_group()


def _op_cases(dev):
    """(name, op, args, plain version) of each custom op at a model's
    shapes: bfloat16 flash with GQA, the fp32 wkv6, the ME pair."""
    from repro_torch.kernels import cosine_sim, flash_attention as kf, \
        weighted_agg, wkv6 as kw
    gen = torch.Generator(device=dev).manual_seed(25)
    q, d_o = (_randn(gen, dev, 2, 128, 8, 64).to(torch.bfloat16)
              for _ in range(2))
    k, v = (_randn(gen, dev, 2, 128, 2, 64).to(torch.bfloat16)
            for _ in range(2))
    o, lse = kf.flash_op(q, k, v, 0, True, True)
    r, kk, vv, go = (_randn(gen, dev, 2, 40, 4, 64) for _ in range(4))
    w = 0.2 + 0.79 * torch.rand(2, 40, 4, 64, generator=gen, device=dev)
    u = _randn(gen, dev, 4, 64)
    s0 = torch.zeros(2, 4, 64, 64, device=dev)
    _, _, ckpt = kw.wkv6_op(r, kk, vv, w, u, s0, 1)
    W = _randn(gen, dev, 6, 4096)
    gw = _randn(gen, dev, 4096)
    lam = torch.rand(6, generator=gen, device=dev) + 0.5
    return [
        ("flash_attention", kf.flash_op, (q, k, v, 0, True, True),
         lambda: (tref.flash_attention_gqa_ref(q, k, v, causal=True),
                  tref.flash_attention_lse_ref(q, k, causal=True)), BF16),
        ("flash_attention_backward", kf.flash_backward_op,
         (q, k, v, o, lse, d_o, 0, True),
         lambda: tref.flash_attention_backward_ref(q, k, v, o, lse, d_o,
                                                   causal=True), BF16),
        ("wkv6", kw.wkv6_op, (r, kk, vv, w, u, s0, 0),
         lambda: tref.wkv6_recurrence_ref(r, kk, vv, w, u, s0),
         dict(rtol=1e-5, atol=1e-4)),
        ("wkv6_backward", kw.wkv6_backward_op,
         (r, kk, vv, w, u, s0, go, None, ckpt),
         lambda: tref.wkv6_backward_ref(r, kk, vv, w, u, s0, go, None),
         dict(rtol=1e-4, atol=1e-3)),
        ("cosine_partials", cosine_sim.cosine_partials_op, (W, gw),
         lambda: tref.cosine_partials_ref(W, gw), dict(rtol=1e-4,
                                                       atol=1e-2)),
        ("weighted_aggregate", weighted_agg.weighted_aggregate_op, (W, lam),
         lambda: tref.weighted_aggregate_ref(W, lam), FP32),
    ]


@pytest.mark.parametrize("index", range(6))
def test_custom_op_on_card_matches_plain(cuda_device, index):
    """Each ``repro_torch::`` op launches its kernel (counted once) and
    agrees with its plain version."""
    name, op, args, plain, tol = _op_cases(cuda_device)[index]
    before = ops.launch_counts()
    got = op(*args)
    assert _counts_delta(before)[name] == 1
    want = plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        if g.numel():
            torch.testing.assert_close(g, w.to(g.dtype), **tol)


@pytest.mark.parametrize("index", range(6))
def test_custom_op_on_a_card_dtensor_is_the_plain_call(cuda_device,
                                                       card_mesh, index):
    """The same op on DTensors of the card's 1 × 1 mesh runs its kernel
    on the local tensors: the plain-tensor call's bits."""
    from torch.distributed.tensor import DTensor, distribute_tensor, \
        Replicate
    from repro_torch.kernels._dtensor import ensure_rules
    name, op, args, _, _ = _op_cases(cuda_device)[index]
    rep = [Replicate(), Replicate()]
    dargs = [distribute_tensor(a, card_mesh, rep)
             if isinstance(a, torch.Tensor) else a for a in args]
    ensure_rules(dargs[0])
    want = op(*args)
    before = ops.launch_counts()
    got = op(*dargs)
    assert _counts_delta(before)[name] == 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert isinstance(g, DTensor)
        assert torch.equal(g.full_tensor(), w)


def test_model_round_on_the_card_mesh_launches_as_plain(cuda_device,
                                                        card_mesh):
    """A reduced yi-6b round as a DTensor step on the card's mesh goes
    through the flash and ME ops: per cluster one flash forward and
    backward launch a layer, the ME pair once a leaf; the vmapped plain
    round folds the clusters into one launch a layer, as before."""
    from repro_torch.launch import mesh_check as mc
    from repro_torch.launch import specs
    from repro_torch.core.serialization import leaves_with_paths
    setup, state, batch, lam = mc.train_inputs("yi-6b", "baseline",
                                               card_mesh)
    C, L = 4, setup.cfg.n_layers
    n_leaves = len(leaves_with_paths(state.global_params))
    before = ops.launch_counts()
    setup.step(state, batch, lam)
    plain = _counts_delta(before)
    assert plain["flash_attention"] == L
    assert plain["flash_attention_backward"] == L
    args = [specs.distribute_like(v, a) for v, a in
            zip((state, batch, lam), setup.abstract_args)]
    before = ops.launch_counts()
    setup.step(*args)
    mesh = _counts_delta(before)
    assert mesh["flash_attention"] == C * L
    assert mesh["flash_attention_backward"] == C * L
    assert mesh["weighted_aggregate"] == plain["weighted_aggregate"] \
        == n_leaves
    assert mesh["cosine_partials"] == plain["cosine_partials"] == n_leaves


# ---------------------------------------------------------------------------
# the RLC ladder of the limb crypto backend
# ---------------------------------------------------------------------------

def _ladder_items(n: int, forged=(), seed: int = 0) -> list:
    """``n`` signed (tag, PK, digest) triples (those in ``forged`` with
    another digest) and one more whose nonce point R is its public key."""
    from repro_torch.core import crypto
    from repro_torch.core.crypto import curve
    out = []
    for i in range(n):
        kp = crypto.ECDSAKeyPair.generate(b"ladder-%d-%d" % (seed, i))
        d = crypto.sha256_digest(b"m", bytes([seed, i]))
        tag = crypto.dsign(d, kp.private_key)
        if i in forged:
            d = crypto.sha256_digest(b"forged", bytes([seed, i]))
        out.append((tag, kp.public_key, d))
    pk = crypto.ECDSAKeyPair.generate(b"ladder-pk-is-r").public_key
    out.append((crypto.Signature(pk[0] % curve.N, 12345, pk[1] & 1), pk,
                crypto.sha256_digest(b"pk-is-r")))
    return out


def _ladder_group(items) -> list:
    from repro_torch.core import crypto
    from repro_torch.core.crypto import curve
    out = []
    for tag, pk, d in items:
        w = pow(tag.s, -1, curve.N)
        out.append((crypto._bits2int(d) * w % curve.N, tag.r * w % curve.N,
                    pk, crypto._recover_R(tag)))
    return out


@pytest.mark.parametrize("lanes", [2, 8, 64])
def test_rlc_ladder_matches_plain_bit_for_bit(cuda_device, lanes):
    """The kernel's limbs are the plain version's, a PK = R lane (a
    combination slot at infinity) and a forged one included."""
    from repro_torch.core.crypto.backends import limb
    from repro_torch.kernels.rlc_ladder import rlc_ladder
    items = _ladder_items(lanes - 1, forged=(0,), seed=lanes)
    _sg, sx, sy, su = limb.prepare(_ladder_group(items))
    args = [torch.from_numpy(a).to(cuda_device) for a in (sx, sy, su)]
    from repro_torch.kernels import rlc_ladder as rl
    before = rl.launches
    got = rlc_ladder(*args)
    torch.cuda.synchronize()
    assert rl.launches == before + 1
    want = limb.rlc_ladder_ref(*[a.cpu() for a in args])
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and g.shape == (lanes, 8)
        assert torch.equal(g.cpu(), w)


def test_rlc_ladder_refuses_what_it_does_not_take(cuda_device):
    from repro_torch.kernels.rlc_ladder import rlc_ladder
    x = torch.zeros((130, 4, 8), dtype=torch.int64, device=cuda_device)
    use = torch.zeros((130, 4), dtype=torch.bool, device=cuda_device)
    with pytest.raises(TypeError):
        rlc_ladder(x.to(torch.int32), x, use)
    with pytest.raises(ValueError):
        rlc_ladder(x, x, use.cpu())
    with pytest.raises(ValueError):
        rlc_ladder(x[:, :2], x, use)


@pytest.mark.parametrize("forged", [(), (1, 4)], ids=["valid", "forged"])
def test_torch_backend_rlc_check_runs_the_kernel(cuda_device, forged,
                                                 monkeypatch):
    """``verify_batch`` under the ``torch`` backend on the card decides as
    ``batch`` does, through the kernel: its launch count moves and the
    plain ladder is never called."""
    from repro_torch.core import crypto
    from repro_torch.core.crypto.backends import limb
    from repro_torch.kernels import rlc_ladder as rl

    def refuse(*a, **k):
        raise AssertionError("the plain ladder ran on the card path")
    monkeypatch.setattr(limb, "rlc_ladder_ref", refuse)
    items = _ladder_items(8, forged=forged, seed=9)
    before = rl.launches
    got = crypto.verify_batch(items, backend="torch")
    assert rl.launches > before
    assert got.bad == crypto.verify_batch(items, backend="batch").bad \
        == tuple(sorted(set(forged) | {8}))
