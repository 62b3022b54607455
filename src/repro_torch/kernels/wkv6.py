"""WKV6 recurrence — the RWKV-6 time-mixing hot spot (forward only).

Port of ``repro.kernels.ops.wkv6_recurrence`` (the Pallas ``wkv6``
kernel). Per batch b and head h, with a K × K float32 state S:

    o_t = r_t · (S + diag(u) · k_tᵀ v_t)
    S  ← diag(w_t) · S + k_tᵀ v_t

For a CUDA tensor the wrapper launches the hand-written Hopper kernel in
``csrc/wkv6.cu`` (one block per (b, h) looping over t, the state in
registers, r/k/v/w read in place through their strides — the design note
is in the source) and counts one launch. For a CPU tensor it runs
:func:`repro_torch.kernels.ref.wkv6_recurrence_ref`. Inputs are float32
only (the model casts to float32 first) and K is 8, 16, 32 or 64.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import wkv6_recurrence_ref

HEAD_SIZES = (8, 16, 32, 64)

launches = 0     # kernel launches


def _check(r, k, v, w, u, s0) -> None:
    if r.ndim != 4:
        raise ValueError(f"wkv6_recurrence needs r, k, v, w of shape "
                         f"(B, S, H, K); got r {tuple(r.shape)}")
    B, S, H, K = r.shape
    want = {"k": (k, r.shape), "v": (v, r.shape), "w": (w, r.shape),
            "u": (u, (H, K)), "s0": (s0, (B, H, K, K))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"wkv6_recurrence: {name} has shape "
                             f"{tuple(t.shape)}; r {tuple(r.shape)} needs "
                             f"{tuple(shape)}")
    if min(B, S, H) < 1:
        raise ValueError(f"wkv6_recurrence needs B, S, H >= 1; got "
                         f"{tuple(r.shape)}")
    if K not in HEAD_SIZES:
        raise ValueError(f"wkv6_recurrence takes K in {HEAD_SIZES}; got {K}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("s0", s0)):
        if t.dtype != torch.float32:
            raise TypeError(f"wkv6_recurrence takes float32 only; {name} is "
                            f"{t.dtype}")
        if t.device != r.device:
            raise ValueError(f"r is on {r.device} but {name} is on "
                             f"{t.device}")


def wkv6_recurrence(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """r, k, v, w (B, S, H, K), u (H, K), s0 (B, H, K, K), all float32 →
    (o (B, S, H, K), final state (B, H, K, K)) in float32."""
    _check(r, k, v, w, u, s0)
    B, S, H, K = r.shape
    if r.device.type == "cpu":
        return wkv6_recurrence_ref(r, k, v, w, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"no wkv6 kernel for {r.device}")
    strides = r.stride()
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.stride() != strides:
            raise ValueError(f"wkv6 kernel needs r, k, v, w with one set of "
                             f"strides; r has {strides}, {name} "
                             f"{t.stride()}")
    if strides[3] != 1:
        raise ValueError(f"wkv6 kernel needs a unit stride over K; got "
                         f"strides {strides}")
    if not (u.is_contiguous() and s0.is_contiguous()):
        raise ValueError("wkv6 kernel needs contiguous u and s0")
    global launches
    fn = _build.entry_point("wkv6")
    o = torch.empty((B, S, H, K), device=r.device, dtype=torch.float32)
    s_fin = torch.empty((B, H, K, K), device=r.device, dtype=torch.float32)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 strides[0], strides[1], strides[2], u.data_ptr(),
                 s0.data_ptr(), o.data_ptr(), s_fin.data_ptr(), B, S, H, K,
                 stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err}")
    launches += 1
    return o, s_fin
