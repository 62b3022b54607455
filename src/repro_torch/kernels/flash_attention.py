"""Flash attention — the dense transformer's prefill and forward attention.

Port of ``repro.kernels.ops.flash_attention`` (the Pallas
``_flash_kernel``): blocked online-softmax attention with GQA, causal and
sliding-window masks, scores and softmax in float32. The forward also
takes keys of a length of their own, Skv ≠ Sq, for cross-attention (the
reference's ``blockwise_attention(q, k, v, causal=False, window=0)``,
query and key positions both from 0): unmasked but for k < Skv. A causal
or windowed call with Skv ≠ Sq is refused; no caller makes one.

For a CUDA tensor the wrapper launches a hand-written Hopper kernel in
``csrc/flash_attention.cu`` and counts one launch. Both kernels walk the
KV tiles in order for each (b, query head, 64-query tile), take the kv
head by index and read q, k, v in place through their strides (the
design notes are in the source). bfloat16 runs on the tensor cores
(``wgmma``, K/V tiles brought by TMA into a two-stage ring, two query
heads of one kv group a block), reading every operand through a tensor
map: each base address and each stride of a dim of extent > 1 must be a
multiple of 16 bytes (:func:`tma_refusal`). float32 runs on CUDA cores.
For a CPU tensor it runs
:func:`repro_torch.kernels.ref.flash_attention_gqa_ref`. Inputs are
float32 or bfloat16, all three the same, and hd is 16, 32, 64, 112
(Zamba2-7B's shared attention) or 128.

When a gradient is wanted (grad mode on and an input that requires it)
the op is a ``torch.autograd.Function``: on the card the forward kernel
also writes each row's logsumexp L, and the backward is a pair of
kernels (:func:`flash_attention_backward`: dQ, then dK and dV summed
over each kv head's query heads in order; bfloat16 on the tensor cores
with ``wgmma``, tiles by TMA, the dK/dV work of a key tile shared by the
blocks of a thread-block cluster (:func:`dkdv_cluster`) and folded in
rank order, the same 16-byte rule for q, k, v and dO as the forward;
float32 on CUDA cores), counted in ``backward_launches``; on the CPU
the forward and backward are the plain versions
(``ref.flash_attention_backward_ref``). The backward takes every head
dim and mask the forward takes, keys of their own length (Skv ≠ Sq, dk
and dv of Skv rows) and hd 112 included. Serving never takes that route:
one launch a layer, no L written. Under ``torch.func.vmap`` (the batched
FEL engine, the PoFEL trainer's clusters) both Functions fold the
vmapped axis into the batch, k and v with their own length, and launch
once for the whole batch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._fold import front, is_wrapped
from repro_torch.kernels.ref import (flash_attention_backward_ref,
                                     flash_attention_gqa_ref,
                                     flash_attention_lse_ref)

HEAD_DIMS = (16, 32, 64, 112, 128)     # forward and backward alike
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_YZ = 65_535         # the kernel's grid is (Sq / 64, Hq, B)
TMA_ALIGN = 16               # bytes: TMA's base and stride granule
NO_ENCODER = -1000           # the C entry's code for a missing libcuda call

launches = 0            # forward kernel launches
backward_launches = 0   # backward calls (each the dQ and the dK/dV kernel)
# forward kernel launches by call: (B, Sq, Skv, Hq, Hk, hd, dtype name,
# causal, window) → count; backward calls the same way
shape_launches: dict = {}
backward_shape_launches: dict = {}


def _call_key(q, k, causal: bool, window: int) -> tuple:
    B, S, Hq, hd = q.shape
    return (B, S, k.shape[1], Hq, k.shape[2], hd,
            str(q.dtype).split(".")[-1], bool(causal), int(window))


def _check(q, k, v, causal, window) -> None:
    if q.ndim != 4:
        raise ValueError(f"flash_attention needs q of shape (B, S, Hq, hd); "
                         f"got {tuple(q.shape)}")
    B, S, Hq, hd = q.shape
    if k.ndim != 4 or k.shape[0] != B or k.shape[3] != hd \
            or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} needs k and v "
                         f"of one shape ({B}, Skv, Hk, {hd}); got k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    Skv, Hk = k.shape[1], k.shape[2]
    if min(B, S, Skv, Hk) < 1 or Hq % Hk:
        raise ValueError(f"flash_attention needs B, Sq, Skv, Hk >= 1 and Hq "
                         f"a multiple of Hk; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes hd in {HEAD_DIMS}; got {hd}")
    if not isinstance(window, int) or window < 0:
        raise ValueError(f"flash_attention takes a window >= 0 (0: none); "
                         f"got {window!r}")
    if Skv != S and (causal or window > 0):
        raise ValueError(f"flash_attention takes keys of their own length "
                         f"(Skv {Skv} != Sq {S}) only with causal=False and "
                         f"window 0; got causal={causal}, window={window}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"q is {q.dtype} but {name} is {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"q is on {q.device} but {name} is on "
                             f"{t.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16; got "
                        f"{q.dtype}")


def tma_refusal(name: str, t: torch.Tensor) -> str | None:
    """Why the tensor-core kernel cannot read ``t`` (B, S, H, hd) through a
    tensor map, or None: its base and the (b, s, h) strides of every dim
    of extent > 1 must be multiples of 16 bytes."""
    size = t.element_size()
    if t.data_ptr() % TMA_ALIGN:
        return (f"{name} starts at an address that is not a multiple of "
                f"{TMA_ALIGN} bytes")
    for dim in range(3):
        if t.shape[dim] > 1 and (t.stride(dim) * size) % TMA_ALIGN:
            return (f"{name} has strides {t.stride()}: stride {dim} is not "
                    f"a multiple of {TMA_ALIGN} bytes")
    return None


TILE = 64                    # queries and keys of a backward tile
MAX_CLUSTER = 4              # blocks of a bfloat16 dK/dV cluster


def dkdv_cluster(S: int, G: int, causal: bool, window: int,
                 Skv: int | None = None) -> int:
    """Blocks of a cluster of the bfloat16 dK/dV kernel
    (csrc/flash_attention.cu: dkdv_cluster): the (head, query tile) pairs
    that see a key tile are cut into this many runs, as many as the
    longest key tile has pairs, up to :data:`MAX_CLUSTER`. Key tiles of
    ``Skv`` keys (default S), query tiles of S queries."""
    Skv = S if Skv is None else Skv
    most = 0
    for kt in range(-(-Skv // TILE)):
        k0 = kt * TILE
        k_last = min(k0 + TILE, Skv) - 1
        qt_begin = k0 // TILE if causal else 0
        q_end = min(S, k_last + window) if window > 0 else S
        most = max(most, G * (-(-q_end // TILE) - qt_begin))
    return MAX_CLUSTER if most >= MAX_CLUSTER else 2 if most >= 2 else 1


def backward_scratch_floats(B: int, S: int, Hq: int) -> int:
    """Floats of the backward's scratch: (L log2 e, D) pairs of every row,
    S padded to whole tiles (float32 uses the first B·Hq·S for D)."""
    return 2 * B * Hq * (-(-S // TILE) * TILE)


def _forward(q, k, v, causal: bool, window: int, want_lse: bool):
    """(o, L (B, Hq, Sq) float32 or None)."""
    B, S, Hq, hd = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    if q.device.type == "cpu":
        o = flash_attention_gqa_ref(q, k, v, causal=causal, window=window)
        return o, (flash_attention_lse_ref(q, k, causal=causal,
                                           window=window)
                   if want_lse else None)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash attention kernel needs a unit stride "
                             f"over hd; {name} has strides {t.stride()}")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            why = tma_refusal(name, t)
            if why is not None:
                raise ValueError(f"bfloat16 flash attention kernel reads "
                                 f"through TMA tensor maps: {why}")
    if max(B, Hq) > MAX_GRID_YZ:
        raise ValueError(f"flash attention kernel takes B and Hq up to "
                         f"{MAX_GRID_YZ}; got B {B}, Hq {Hq}")
    global launches
    fn = _build.entry_point("flash_attention")
    o = torch.empty((B, S, Hq, hd), device=q.device, dtype=q.dtype)
    lse = (torch.empty((B, Hq, S), device=q.device, dtype=torch.float32)
           if want_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 0 if lse is None else lse.data_ptr(),
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 B, S, Skv, Hq, Hk, hd, int(causal), window,
                 DTYPES[q.dtype], stream)
    if err == NO_ENCODER:
        raise RuntimeError("flash attention kernel: libcuda has no "
                           "cuTensorMapEncodeTiled")
    if err < 0:
        raise RuntimeError(f"flash attention kernel: a tensor map could not "
                           f"be encoded (CUresult {-err})")
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    key = _call_key(q, k, causal, window)
    shape_launches[key] = shape_launches.get(key, 0) + 1
    return o, lse


def flash_attention_backward(q, k, v, o, lse, d_o, *, causal: bool = True,
                             window: int = 0):
    """The gradient of :func:`flash_attention`: (dq, dk, dv) in q's dtype,
    from the forward's output ``o`` and row logsumexp ``lse`` (B, Hq, Sq)
    and the output gradient ``d_o`` (B, Sq, Hq, hd); dk and dv have the
    keys' own length Skv."""
    B, S, Hq, hd = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    if Skv != S and (causal or window > 0):
        raise ValueError(f"flash_attention_backward takes keys of their own "
                         f"length (Skv {Skv} != Sq {S}) only with "
                         f"causal=False and window 0")
    if q.device.type == "cpu":
        return flash_attention_backward_ref(q, k, v, o, lse, d_o,
                                            causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for {q.device}")
    if d_o.shape != q.shape or d_o.dtype != q.dtype or d_o.stride(3) != 1:
        raise ValueError(f"flash attention backward kernel needs d_o of "
                         f"shape {tuple(q.shape)} and dtype {q.dtype} with "
                         f"a unit stride over hd; got {tuple(d_o.shape)} "
                         f"{d_o.dtype} strides {d_o.stride()}")
    if not (o.is_contiguous() and lse.is_contiguous()):
        raise ValueError("flash attention backward kernel needs the "
                         "forward's contiguous o and lse")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash attention kernel needs a unit stride "
                             f"over hd; {name} has strides {t.stride()}")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v), ("d_o", d_o)):
            why = tma_refusal(name, t)
            if why is not None:
                raise ValueError(f"bfloat16 flash attention backward kernel "
                                 f"reads through TMA tensor maps (16-byte "
                                 f"granules): {why}")
    global backward_launches
    fn = _build.entry_point("flash_attention_backward")
    dq = torch.empty((B, S, Hq, hd), device=q.device, dtype=q.dtype)
    dk = torch.empty((B, Skv, Hk, hd), device=q.device, dtype=q.dtype)
    dv = torch.empty_like(dk)
    delta = torch.empty(backward_scratch_floats(B, S, Hq), device=q.device,
                        dtype=torch.float32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), d_o.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *d_o.stride()[:3], B, S, Skv, Hq, Hk, hd, int(causal),
                 window, DTYPES[q.dtype], stream)
    if err == NO_ENCODER:
        raise RuntimeError("flash attention backward kernel: libcuda has no "
                           "cuTensorMapEncodeTiled")
    if err < 0:
        raise RuntimeError(f"flash attention backward kernel: a tensor map "
                           f"could not be encoded (CUresult {-err})")
    if err != 0:
        raise RuntimeError(f"flash attention backward kernel launch failed: "
                           f"CUDA error {err}")
    backward_launches += 1
    key = _call_key(q, k, causal, window)
    backward_shape_launches[key] = backward_shape_launches.get(key, 0) + 1
    return dq, dk, dv


def _fold(t, dim, V):
    """(V, B, ...) → (V·B, ...), contiguous: the vmapped axis becomes
    part of the batch."""
    t = front(t, dim, V)
    return t.reshape(V * t.shape[1], *t.shape[2:]).contiguous()


def _unfold(t, V):
    """(V·B, ...) → (V, B, ...)."""
    return t.reshape(V, t.shape[0] // V, *t.shape[1:])


class _Attention(torch.autograd.Function):
    """The op as a ``torch.func``-ready Function: the kernels on the
    card, the plain versions on the CPU. Its outputs are (o, the row
    logsumexp L the backward reads; empty when ``save`` is off). Under
    ``torch.func.vmap`` the vmapped axis is folded into the batch and the
    op runs once for the whole batch."""

    @staticmethod
    def forward(q, k, v, causal, window, save):
        o, lse = _forward(q, k, v, causal, window, want_lse=save)
        if lse is None:
            lse = q.new_empty((q.shape[0], q.shape[2], 0),
                              dtype=torch.float32)
        return o, lse

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, _ = inputs
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(q, k, v, *output)
        ctx.mask = (causal, window)

    @staticmethod
    def backward(ctx, d_o, _):
        q, k, v, o, lse = ctx.saved_tensors
        return (*_AttentionBackward.apply(q, k, v, o, lse, d_o, *ctx.mask),
                None, None, None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, save):
        V = info.batch_size
        o, lse = _Attention.apply(
            *(_fold(t, d, V) for t, d in zip((q, k, v), in_dims)), causal,
            window, save)
        return (_unfold(o, V), _unfold(lse, V)), (0, 0)


class _AttentionBackward(torch.autograd.Function):
    """:func:`flash_attention_backward` as a Function of its own, so that
    under ``torch.func`` the backward is folded and launched once too.
    It has no gradient of its own."""

    @staticmethod
    def forward(q, k, v, o, lse, d_o, causal, window):
        # e.g. the expanded grad of a sum; the bf16 kernel also wants
        # 16-byte aligned rows, which a fresh copy has
        if d_o.stride(3) != 1 or (d_o.dtype == torch.bfloat16
                                  and tma_refusal("d_o", d_o)):
            d_o = d_o.clone(memory_format=torch.contiguous_format)
        return flash_attention_backward(q, k, v, o, lse, d_o, causal=causal,
                                        window=window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the flash attention backward has no "
                                  "gradient")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, lse, d_o, causal, window):
        V = info.batch_size
        grads = _AttentionBackward.apply(
            *(_fold(t, d, V) for t, d in zip((q, k, v, o, lse, d_o),
                                             in_dims)), causal, window)
        return tuple(_unfold(g, V) for g in grads), (0, 0, 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, Hq, hd), k and v (B, Skv, Hk, hd) with Hq a multiple of
    Hk → (B, Sq, Hq, hd) in q's dtype. ``window`` > 0 keeps the keys with
    q - k < window; Skv ≠ Sq (cross-attention) only with causal=False and
    window 0. Differentiable when an input requires grad. Inputs
    wrapped by ``torch.func`` (vmap, grad) go through the Function, whose
    vmap rule folds the vmapped axis into the batch: one launch for the
    batch."""
    _check(q, k, v, causal, window)
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    if grad or is_wrapped(q, k, v):
        return _Attention.apply(q, k, v, causal, window, grad)[0]
    return _forward(q, k, v, causal, window, want_lse=False)[0]
