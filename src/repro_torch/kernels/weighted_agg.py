"""Weighted model aggregation — paper Eq. 1 as a single pass over W.

Port of ``repro.kernels.weighted_agg.weighted_aggregate``:
gw[d] = Σ_n λ_n W[n, d] with λ = weights / Σ weights, in float32.

For a CUDA tensor the wrapper launches the hand-written Hopper kernel in
``csrc/weighted_agg.cu`` (each thread owns :func:`vector_width`
consecutive columns read with one wide load, n summed in order, λ
normalized in the kernel — the design note is in the source) and counts
one launch; it launches nothing else where the weights are float32
already. For a CPU tensor it computes the same aggregate with
:func:`repro_torch.kernels.ref.weighted_aggregate_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import weighted_aggregate_ref

DTYPES = (torch.float32, torch.bfloat16)
LOAD_BYTES = 16      # the widest load of one thread

launches = 0     # kernel launches


def vector_width(D: int, data_ptr: int, element_size: int) -> int:
    """Columns a thread reads with one load: the widest power of two up to
    16 bytes that divides D and the base address, so every row start
    (base + n·D·size) is aligned to the load too."""
    v = LOAD_BYTES // element_size
    while v > 1 and (D % v or data_ptr % (v * element_size)):
        v //= 2
    return v


def _check(W: torch.Tensor, weights: torch.Tensor) -> None:
    if W.ndim != 2 or weights.shape != (W.shape[0],):
        raise ValueError(f"weighted_aggregate needs W (N, D) and weights "
                         f"(N,); got {tuple(W.shape)} and "
                         f"{tuple(weights.shape)}")
    if W.shape[0] < 1 or W.shape[1] < 1:
        raise ValueError(f"weighted_aggregate needs N, D >= 1; got "
                         f"{tuple(W.shape)}")
    if W.dtype not in DTYPES:
        raise TypeError(f"W must be float32 or bfloat16, got {W.dtype}")
    if not weights.is_floating_point():
        raise TypeError(f"weights must be floating point, got "
                        f"{weights.dtype}")
    if W.device != weights.device:
        raise ValueError(f"W is on {W.device} but weights are on "
                         f"{weights.device}")


def weighted_aggregate(W: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(N, D), (N,) → (D,) normalized weighted aggregate in float32."""
    _check(W, weights)
    if W.device.type == "cpu":
        return weighted_aggregate_ref(W, weights)
    if W.device.type != "cuda":
        raise ValueError(f"no weighted_aggregate kernel for {W.device}")
    if not W.is_contiguous():
        raise ValueError("weighted_aggregate kernel needs a contiguous W")
    global launches
    N, D = W.shape
    fn = _build.entry_point("weighted_agg")
    w = weights.to(torch.float32).contiguous()   # no launch if fp32 already
    vec = vector_width(D, W.data_ptr(), W.element_size())
    out = torch.empty(D, device=W.device, dtype=torch.float32)
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        err = fn(W.data_ptr(), int(W.dtype == torch.bfloat16), w.data_ptr(),
                 out.data_ptr(), N, D, vec, stream)
    if err != 0:
        raise RuntimeError(f"weighted_aggregate kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out
