"""Fused batched cosine-similarity partials — the ME hot spot (paper §7.3).

Port of ``repro.kernels.cosine_sim.cosine_partials``. One pass over the
stacked FEL models W (N, D) and the global model gw (D,) gives the three
reductions of Eq. 2:

    dot_n = Σ_d W[n,d]·gw[d],   wsq_n = Σ_d W[n,d]²,   gsq = Σ_d gw[d]²

For a CUDA tensor the wrapper launches the hand-written Hopper kernel in
``csrc/cosine_partials.cu`` (one launch: each block a chunk of D for all
rows, the last block to finish folds the partials in a fixed order; no
atomics on floats — the design note is in the source) and counts one
launch. For a CPU tensor it computes the same partials with
:func:`repro_torch.kernels.ref.cosine_partials_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import cosine_partials_ref
from repro_torch.kernels.weighted_agg import vector_width

DTYPES = (torch.float32, torch.bfloat16)
# elements of D in a tile, the unit a block takes at a time
_CHUNK = 2048
_MAX_SPLITS = 1024

launches = 0     # kernel launches

# The int32 ticket that elects the folding block, one per (device,
# stream): launches on one stream run in turn, so none shares its ticket
# with a running launch. Each device gets one zeroed buffer of _SLOTS
# tickets at its first call (which must not be under CUDA-graph capture);
# every launch leaves its ticket at 0 again. A graph keeps the ticket of
# the stream it was captured on.
_SLOTS = 256
_TICKETS: dict = {}      # device index -> (buffer, {stream: slot})


def chunk_for(D: int) -> int:
    """Elements of D a block takes: whole tiles of 2048, as few as keep
    the blocks at most 1024. A function of D alone, so the reduction order
    (and hence every bit of the result) is fixed for a given shape."""
    tiles = -(-max(1, -(-D // _CHUNK)) // _MAX_SPLITS)
    return tiles * _CHUNK


def splits_for(D: int) -> int:
    """Blocks of the kernel, one a chunk of D (see :func:`chunk_for`)."""
    return -(-D // chunk_for(D))


def _ticket(device: torch.device, stream: int) -> int:
    """Address of the ticket of ``stream`` on ``device``."""
    if device.index not in _TICKETS:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("cosine_partials: call it once outside CUDA "
                               "graph capture first (its ticket buffer is "
                               "zeroed then)")
        buf = torch.zeros(_SLOTS, device=device, dtype=torch.int32)
        torch.cuda.synchronize(device)   # zero before any stream reads it
        _TICKETS[device.index] = (buf, {})
    buf, slots = _TICKETS[device.index]
    if stream not in slots:
        if len(slots) == _SLOTS:
            raise RuntimeError(f"cosine_partials: more than {_SLOTS} streams "
                               f"on {device}")
        slots[stream] = len(slots)
    return buf.data_ptr() + 4 * slots[stream]


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
    global launches
    N, D = W.shape
    fn = _build.entry_point("cosine_partials")
    f32 = dict(device=W.device, dtype=torch.float32)
    part = torch.empty(2 * (N + 1) * splits_for(D), **f32)
    dot = torch.empty(N, **f32)
    wsq = torch.empty(N, **f32)
    gsq = torch.empty(1, **f32)
    # a lane's elements come in 8-byte groups: at most a group a load
    vec = min(8 // W.element_size(),
              vector_width(D, W.data_ptr(), W.element_size()))
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        ticket = _ticket(W.device, stream)
        err = fn(W.data_ptr(), gw.data_ptr(), int(W.dtype == torch.bfloat16),
                 int(gw.dtype == torch.bfloat16), vec, part.data_ptr(),
                 dot.data_ptr(), wsq.data_ptr(), gsq.data_ptr(),
                 ticket, N, D, chunk_for(D), stream)
    if err != 0:
        raise RuntimeError(f"cosine_partials kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return dot, wsq, gsq[0]
