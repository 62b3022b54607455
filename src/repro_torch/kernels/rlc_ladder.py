"""The RLC batch equation's joint GLV ladder as a kernel.

Port of the ladder in ``repro.core.crypto.backends.jax._rlc_kernel``, a
jitted ``lax.fori_loop``, not a Pallas kernel (so it is no row of the
TPU kernels' table). For a CUDA tensor the wrapper launches the
hand-written Hopper kernel in ``csrc/rlc_ladder.cu`` (one thread a lane,
its X, Y, Z in registers as 8 × 32-bit limbs; the design note is in the
source) and counts one launch. For a CPU tensor it runs the plain torch
version, :func:`repro_torch.core.crypto.backends.limb.rlc_ladder_ref`.
The two are bit-identical: every field op reduces fully, so the limbs
are canonical. There is no other route: a failed build or launch
raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

LIMBS = 8

launches = 0     # kernel launches (no model path reaches the ladder, so it
#                  is not among ``ops.launch_counts``, whose callers
#                  compare the model kernels' counts whole)


def _check(step_x: torch.Tensor, step_y: torch.Tensor,
           step_use: torch.Tensor) -> None:
    if (step_x.ndim != 3 or step_x.shape[-1] != LIMBS
            or step_y.shape != step_x.shape
            or step_use.shape != step_x.shape[:2]):
        raise ValueError(f"rlc_ladder needs addends (S, L, {LIMBS}) twice "
                         f"and a mask (S, L); got {tuple(step_x.shape)}, "
                         f"{tuple(step_y.shape)}, {tuple(step_use.shape)}")
    if step_x.dtype != torch.int64 or step_y.dtype != torch.int64:
        raise TypeError(f"rlc_ladder's addends must be int64 (32-bit limbs), "
                        f"got {step_x.dtype}, {step_y.dtype}")
    if step_use.dtype != torch.bool:
        raise TypeError(f"rlc_ladder's mask must be bool, got "
                        f"{step_use.dtype}")
    if not (step_x.device == step_y.device == step_use.device):
        raise ValueError(f"rlc_ladder's inputs lie on {step_x.device}, "
                         f"{step_y.device} and {step_use.device}")


def rlc_ladder(step_x: torch.Tensor, step_y: torch.Tensor,
               step_use: torch.Tensor):
    """(S, L, 8) int64 addends twice and an (S, L) bool mask → each
    lane's Jacobian (X, Y, Z) limbs after S double-and-add steps, (L, 8)
    int64 each."""
    _check(step_x, step_y, step_use)
    if step_x.device.type == "cpu":
        from repro_torch.core.crypto.backends.limb import rlc_ladder_ref
        return rlc_ladder_ref(step_x, step_y, step_use)
    if step_x.device.type != "cuda":
        raise ValueError(f"no rlc_ladder kernel for {step_x.device}")
    if not (step_x.is_contiguous() and step_y.is_contiguous()
            and step_use.is_contiguous()):
        raise ValueError("rlc_ladder kernel needs contiguous inputs")
    global launches
    S, L, _ = step_x.shape
    fn = _build.entry_point("rlc_ladder")
    out = torch.empty((3, L, LIMBS), dtype=torch.int64, device=step_x.device)
    with torch.cuda.device(step_x.device):
        stream = torch.cuda.current_stream(step_x.device).cuda_stream
        err = fn(step_x.data_ptr(), step_y.data_ptr(), step_use.data_ptr(),
                 S, L, out[0].data_ptr(), out[1].data_ptr(),
                 out[2].data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rlc_ladder kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out[0], out[1], out[2]


__all__ = ["launches", "rlc_ladder"]
