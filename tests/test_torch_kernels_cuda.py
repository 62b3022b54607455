"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions. Every test here is marked ``cuda`` and skips where no
CUDA device is present; on a machine with one (it needs neither JAX nor
the reference package):

    PYTHONPATH=src python3 -m pytest -q tests/test_torch_kernels_cuda.py

Tolerances are the reference's (tests/test_kernels.py): float32
aggregate rtol 2e-5 / atol 2e-6, bfloat16 2e-2; the fused partials rtol
1e-4 (dot atol 1e-2, sums of 10^5 terms in another order).
"""

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
        {"cosine_partials": 1, "weighted_aggregate": 1}


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
        {"cosine_partials": 2, "weighted_aggregate": 2}
