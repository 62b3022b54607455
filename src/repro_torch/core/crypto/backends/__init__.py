"""Curve-arithmetic backends behind the ``crypto.set_backend`` seam.

``python`` hosts the pure-Python backends (naive / windowed / batch /
glv); ``limb`` the limb-vectorized ``torch`` backend (the port of the
reference's ``jax`` one), whose ladder runs on the card. ``limb`` is
imported only when that backend is first requested.
"""

from repro_torch.core.crypto.backends.python import (BatchOps, CurveOps,
                                                     NaiveOps, RLCItem,
                                                     WindowedOps,
                                                     rlc_coefficient)

__all__ = ["CurveOps", "NaiveOps", "WindowedOps", "BatchOps", "RLCItem",
           "rlc_coefficient"]
