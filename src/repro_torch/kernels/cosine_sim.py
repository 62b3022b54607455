"""Fused batched cosine-similarity partials — the ME hot spot (paper §7.3).

Port of ``repro.kernels.cosine_sim.cosine_partials``. One pass over the
stacked FEL models W (N, D) and the global model gw (D,) gives the three
reductions of Eq. 2:

    dot_n = Σ_d W[n,d]·gw[d],   wsq_n = Σ_d W[n,d]²,   gsq = Σ_d gw[d]²

For a CUDA tensor the wrapper launches the hand-written Hopper kernel in
``csrc/cosine_partials.cu`` (two launches, fixed-order reductions, no
atomics — the design note is in the source) and counts one launch. For a
CPU tensor it computes the same partials with
:func:`repro_torch.kernels.ref.cosine_partials_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import cosine_partials_ref

DTYPES = (torch.float32, torch.bfloat16)
# elements of D per pass-1 block: 8 per thread of the kernel's 256
_CHUNK = 2048
_MAX_SPLITS = 1024

launches = 0     # kernel launches (pass 1 + pass 2 count one)


def splits_for(D: int) -> int:
    """D-splits of pass 1; a function of D alone, so the reduction order
    (and hence every bit of the result) is fixed for a given shape."""
    return max(1, min(_MAX_SPLITS, -(-D // _CHUNK)))


def _check(W: torch.Tensor, gw: torch.Tensor) -> None:
    if W.ndim != 2 or gw.ndim != 1 or W.shape[1] != gw.shape[0]:
        raise ValueError(f"cosine_partials needs W (N, D) and gw (D,); got "
                         f"{tuple(W.shape)} and {tuple(gw.shape)}")
    if W.shape[0] < 1 or W.shape[1] < 1:
        raise ValueError(f"cosine_partials needs N, D >= 1; got "
                         f"{tuple(W.shape)}")
    for name, t in (("W", W), ("gw", gw)):
        if t.dtype not in DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
    if W.device != gw.device:
        raise ValueError(f"W is on {W.device} but gw is on {gw.device}")


def cosine_partials(W: torch.Tensor, gw: torch.Tensor):
    """(N, D), (D,) → (dot (N,), wsq (N,), gsq ()) in float32."""
    _check(W, gw)
    if W.device.type == "cpu":
        return cosine_partials_ref(W, gw)
    if W.device.type != "cuda":
        raise ValueError(f"no cosine_partials kernel for {W.device}")
    if not (W.is_contiguous() and gw.is_contiguous()):
        raise ValueError("cosine_partials kernel needs contiguous W and gw")
    if W.shape[0] >= 65535:      # pass 1 puts the N + 1 rows on grid.y
        raise ValueError(f"cosine_partials kernel takes N < 65535 rows, "
                         f"got {W.shape[0]}")
    global launches
    N, D = W.shape
    splits = splits_for(D)
    fn = _build.entry_point("cosine_partials")
    f32 = dict(device=W.device, dtype=torch.float32)
    part = torch.empty(2 * (N + 1) * splits, **f32)
    dot = torch.empty(N, **f32)
    wsq = torch.empty(N, **f32)
    gsq = torch.empty(1, **f32)
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        err = fn(W.data_ptr(), gw.data_ptr(), int(W.dtype == torch.bfloat16),
                 int(gw.dtype == torch.bfloat16), part.data_ptr(),
                 dot.data_ptr(), wsq.data_ptr(), gsq.data_ptr(), N, D,
                 splits, stream)
    if err != 0:
        raise RuntimeError(f"cosine_partials kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return dot, wsq, gsq[0]
