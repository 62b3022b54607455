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
"""

import math

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
         "flash_attention": 0}


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
         "flash_attention": 0}


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
