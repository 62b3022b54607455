"""The reference's products: float32 with TF32 off, or, for the control
that must come out not correct, float8 (e4m3) operands with a scale per
tensor (the step below the configurations' bfloat16 products that would
tempt a later change)."""

from __future__ import annotations

import torch

FP8_MAX = 448.0   # float8_e4m3fn's largest finite value


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under a per-tensor scale, back in float32; the
    gradient passes through unchanged (straight-through)."""
    scale = torch.clamp(x.detach().abs().amax(), min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) \
        * scale
    return x + (q - x.detach())


class Products:
    """``mm(a, b)`` = a @ b in the reference's precision."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision is float32 or fp8; got "
                             f"{precision!r}")
        self.precision = precision
        no_tf32()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            return fp8_round(a) @ fp8_round(b)
        return a @ b
