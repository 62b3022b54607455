"""repro_torch — the PyTorch/CUDA port of the PoFEL BHFL system.

It sits beside the JAX package ``repro``, which stays the reference:
module paths mirror it (``repro_torch.core.model_eval``,
``repro_torch.kernels.ops``, …), and the port imports neither ``jax``
nor any module of ``repro``. Entry points take an explicit ``device``;
``None`` means the CUDA card, and the CPU is used only when the caller
asks for it.

The reference's MLP GEMMs are full float32, so importing the port turns
TF32 off for both cuBLAS matmuls and cuDNN convolutions.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` is the CUDA card, and
    a CUDA device that is not there raises instead of falling back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' to run on the CPU")
    return dev
