"""Curve-arithmetic backends behind the ``crypto.set_backend`` seam.

``python`` hosts the pure-Python backends (naive / windowed / batch /
glv). The reference's JAX limb backend is not part of the port.
"""

from repro_torch.core.crypto.backends.python import (BatchOps, CurveOps,
                                                     NaiveOps, RLCItem,
                                                     WindowedOps,
                                                     rlc_coefficient)

__all__ = ["CurveOps", "NaiveOps", "WindowedOps", "BatchOps", "RLCItem",
           "rlc_coefficient"]
