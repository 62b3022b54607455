"""Flash attention — the dense transformer's prefill and forward attention.

Port of ``repro.kernels.ops.flash_attention`` (the Pallas
``_flash_kernel``): blocked online-softmax attention with GQA, causal and
sliding-window masks, scores and softmax in float32.

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
float32 or bfloat16, all three the same, and hd is 16, 32, 64 or 128.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_gqa_ref

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_YZ = 65_535         # the kernel's grid is (S / 64, Hq, B)
TMA_ALIGN = 16               # bytes: TMA's base and stride granule
NO_ENCODER = -1000           # the C entry's code for a missing libcuda call

launches = 0     # kernel launches


def _check(q, k, v, window) -> None:
    if q.ndim != 4:
        raise ValueError(f"flash_attention needs q of shape (B, S, Hq, hd); "
                         f"got {tuple(q.shape)}")
    B, S, Hq, hd = q.shape
    if k.ndim != 4 or tuple(k.shape[:2]) != (B, S) or k.shape[3] != hd \
            or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} needs k and v "
                         f"of shape ({B}, {S}, Hk, {hd}); got k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    Hk = k.shape[2]
    if min(B, S, Hk) < 1 or Hq % Hk:
        raise ValueError(f"flash_attention needs B, S, Hk >= 1 and Hq a "
                         f"multiple of Hk; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes hd in {HEAD_DIMS}; got {hd}")
    if not isinstance(window, int) or window < 0:
        raise ValueError(f"flash_attention takes a window >= 0 (0: none); "
                         f"got {window!r}")
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, S, Hq, hd), k and v (B, S, Hk, hd) with Hq a multiple of Hk →
    (B, S, Hq, hd) in q's dtype. ``window`` > 0 keeps the keys with
    q - k < window."""
    _check(q, k, v, window)
    B, S, Hq, hd = q.shape
    Hk = k.shape[2]
    if q.device.type == "cpu":
        return flash_attention_gqa_ref(q, k, v, causal=causal, window=window)
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
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 B, S, Hq, Hk, hd, int(causal), window, DTYPES[q.dtype],
                 stream)
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
    return o
