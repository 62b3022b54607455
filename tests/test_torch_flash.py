"""The port's flash attention (``repro_torch.kernels``) and its model-layer
entry ``layers.blockwise_attention`` against the reference, on the CPU.

On the CPU ``ops.flash_attention`` is the kernel's plain version; the
reference runs its Pallas kernel in interpret mode, as
tests/test_kernels.py does. Both get the same numpy inputs.

Tolerances are the reference's own: bfloat16 rtol/atol 2e-2
(tests/test_kernels.py:19-21), float32 rtol/atol 2e-5 (its flash tests,
tests/test_kernels.py:141-179). Sums run in another order in the two
packages; that is all that separates them in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as j_flash
from repro.kernels.ref import flash_attention_ref as j_flash_ref
from repro.models import layers as jlayers
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers

BF16 = dict(rtol=2e-2, atol=2e-2)
FP32 = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, B, S, Hq, Hk, hd):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, S, Hq, hd)).astype(np.float32),
            r.normal(size=(B, S, Hk, hd)).astype(np.float32),
            r.normal(size=(B, S, Hk, hd)).astype(np.float32))


def _port(arrs, dtype, **kw):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrs)
    return ops.flash_attention(q, k, v, **kw).to(torch.float32).numpy()


def _ref(arrs, dtype, **kw):
    q, k, v = (jnp.asarray(a, dtype) for a in arrs)
    return np.asarray(j_flash(q, k, v, **kw), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    (1, 16, 2, 16),       # tiny
    (2, 128, 4, 32),      # one block exactly
    (1, 200, 4, 64),      # the padding path
    (2, 300, 8, 32),      # multi-block
])
def test_flash_matches_reference_kernel(shape, dtype):
    B, S, H, hd = shape
    arrs = _inputs(sum(shape), B, S, H, H, hd)
    tol = BF16 if dtype == "bfloat16" else FP32
    before = ops.launch_counts()
    out = _port(arrs, getattr(torch, dtype))
    assert ops.launch_counts() == before            # the CPU runs no kernel
    np.testing.assert_allclose(out, _ref(arrs, getattr(jnp, dtype),
                                         causal=True), **tol)


@pytest.mark.parametrize("hq,hk", [(4, 4), (4, 2), (8, 1)])
def test_flash_gqa_groups(hq, hk):
    arrs = _inputs(hq + hk, 1, 130, hq, hk, 16)
    np.testing.assert_allclose(_port(arrs, torch.float32),
                               _ref(arrs, jnp.float32, causal=True), **FP32)


@pytest.mark.parametrize("window", [1, 7, 64])
def test_flash_sliding_window(window):
    arrs = _inputs(window, 1, 150, 2, 2, 16)
    np.testing.assert_allclose(
        _port(arrs, torch.float32, window=window),
        _ref(arrs, jnp.float32, causal=True, window=window), **FP32)


def test_flash_non_causal():
    arrs = _inputs(70, 1, 70, 2, 2, 16)
    np.testing.assert_allclose(_port(arrs, torch.float32, causal=False),
                               _ref(arrs, jnp.float32, causal=False), **FP32)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0), (False, 3)])
def test_plain_flash_matches_reference_oracle(causal, window):
    """``ref.flash_attention_ref`` on (B, H, S, hd) against the
    reference's, in float32 and bfloat16."""
    r = np.random.default_rng(window + causal)
    arrs = [r.normal(size=(2, 3, 33, 32)).astype(np.float32)
            for _ in range(3)]
    for tdt, jdt, tol in ((torch.float32, jnp.float32, FP32),
                          (torch.bfloat16, jnp.bfloat16, BF16)):
        t = tref.flash_attention_ref(
            *(torch.from_numpy(a).to(tdt) for a in arrs), causal=causal,
            window=window)
        j = j_flash_ref(*(jnp.asarray(a, jdt) for a in arrs), causal=causal,
                        window=window)
        assert t.dtype == tdt
        np.testing.assert_allclose(t.to(torch.float32).numpy(),
                                   np.asarray(j, np.float32), **tol)


@pytest.mark.parametrize("window", [0, 9])
def test_blockwise_attention_matches_reference_layer(window):
    """The port's model-layer attention (the flash op) against the
    reference's jnp ``blockwise_attention``, with GQA and several tiles."""
    arrs = _inputs(100 + window, 2, 100, 4, 2, 32)
    t = layers.blockwise_attention(*(torch.from_numpy(a) for a in arrs),
                                   causal=True, window=window)
    j = jlayers.blockwise_attention(*(jnp.asarray(a) for a in arrs),
                                    causal=True, window=window, q_block=32,
                                    kv_block=64)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **FP32)


def test_blockwise_attention_bf16_matches_reference_layer():
    """The model's working type: the reference rounds the scaled q and the
    probabilities to bfloat16 where the port keeps float32, so bfloat16's
    tolerance."""
    arrs = _inputs(5, 2, 57, 8, 2, 32)
    t = layers.blockwise_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in arrs))
    j = jlayers.blockwise_attention(*(jnp.asarray(a, jnp.bfloat16)
                                      for a in arrs))
    assert t.dtype == torch.bfloat16
    np.testing.assert_allclose(t.to(torch.float32).numpy(),
                               np.asarray(j, np.float32), **BF16)


@pytest.mark.parametrize("bad", ["rank", "kv_shape", "groups", "hd",
                                 "dtype", "mixed_dtype", "window", "device"])
def test_flash_refuses_what_the_kernel_cannot_run(bad):
    """The wrapper's checks hold on every device, so the CPU refuses what
    the card's kernel would."""
    q, k, v = (torch.ones(1, 8, 4, 32), torch.ones(1, 8, 2, 32),
               torch.ones(1, 8, 2, 32))
    kw, err = {}, ValueError
    if bad == "rank":
        q = q[0]
    elif bad == "kv_shape":
        k = torch.ones(1, 7, 2, 32)
    elif bad == "groups":
        k = v = torch.ones(1, 8, 3, 32)
    elif bad == "hd":
        q, k, v = q[..., :24], k[..., :24], v[..., :24]
    elif bad == "dtype":
        q, k, v, err = q.half(), k.half(), v.half(), TypeError
    elif bad == "mixed_dtype":
        v, err = v.to(torch.bfloat16), TypeError
    elif bad == "window":
        kw = {"window": -1}
    else:
        q, k, v = q.to("meta"), k.to("meta"), v.to("meta")
    with pytest.raises(err):
        ops.flash_attention(q, k, v, **kw)
