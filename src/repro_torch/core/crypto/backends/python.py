"""Pure-Python curve backends behind the ``CurveOps`` seam.

``repro_torch.core.crypto`` routes every scalar-multiplication decision through
one of these objects (selected by ``set_backend``):

* :class:`NaiveOps`    — double-and-add, no tables: the algorithmic
  baseline the benchmarks measure everything against.
* :class:`WindowedOps` — 4-bit fixed-window tables (base point
  precomputed, public keys cached FIFO): the per-message fast path.
* :class:`BatchOps`    — per-message behaviour identical to windowed,
  plus the round-level randomized-linear-combination equation
  (:meth:`rlc_check`) that ``verify_batch`` folds a whole phase's
  signatures through — evaluated by the GLV + wNAF/Pippenger MSM engine
  (``curve.msm_jc``).
* :class:`GLVOps`      — BatchOps with a uniform-schedule fixed-base
  ladder on the signing side (``curve.point_mul_base_ct``) and the
  interleaved-wNAF engine pinned for the batch equation.

All accumulate in Jacobian coordinates (``curve.py``): a point add costs
mulmods instead of a modular inversion, and the RLC equation needs
*zero* inversions — "is the sum infinity" is just Z == 0.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

from ..curve import (G, Point, g_table, jc_add, jc_is_inf, jc_to_affine,
                     msm_jc, pk_table, point_mul_base_ct, point_mul_naive,
                     point_mul_windowed, point_mul_windowed_jc,
                     strauss_shamir)
from ..curve import N as _N
from ..field import P as _P
from repro_torch.obs import get_recorder

# (u1, u2, PK, R): one prepared signature of the batch equation
#     (Σ aᵢ·u1ᵢ)·G + Σ (aᵢ·u2ᵢ)·PKᵢ − Σ aᵢ·Rᵢ == ∞
RLCItem = Tuple[int, int, Point, Point]


def rlc_coefficient() -> int:
    """A fresh random 128-bit nonzero batch coefficient. 128 bits bound the
    adversary's cancellation probability at 2^-128; fresh draws per equation
    keep bisection sound against crafted forgery pairs."""
    return int.from_bytes(os.urandom(16), "big") | 1


def rlc_coefficients(n: int) -> List[int]:
    """``n`` fresh coefficients from ONE urandom read — the per-draw
    syscall is ~10 µs, which is real money across a 32-signature batch."""
    buf = os.urandom(16 * n)
    return [int.from_bytes(buf[i:i + 16], "big") | 1
            for i in range(0, 16 * n, 16)]


class CurveOps:
    """Backend seam: the three point-arithmetic decisions ECDSA makes."""

    name = "base"
    #: True when ``verify_batch`` should fold batches through rlc_check
    #: instead of looping dverify
    batch_equation = False

    def mul_base(self, k: int) -> Point:
        """k·G — the signing-side multiplication."""
        raise NotImplementedError

    def linear_combo(self, u1: int, u2: int, pk: Point) -> Point:
        """u1·G + u2·PK — the single-signature verification equation."""
        raise NotImplementedError

    def rlc_check(self, group: Sequence[RLCItem]) -> bool:
        """One randomized-linear-combination equation over prepared items
        (accept up to the 2^-128 false-accept bound)."""
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<{type(self).__name__} name={self.name!r}>"


class NaiveOps(CurveOps):
    name = "naive"

    def mul_base(self, k: int) -> Point:
        return point_mul_naive(k, G)

    def linear_combo(self, u1: int, u2: int, pk: Point) -> Point:
        return strauss_shamir(u1, G, u2, pk)


class WindowedOps(CurveOps):
    name = "windowed"

    def mul_base(self, k: int) -> Point:
        return point_mul_windowed(k, g_table())

    def linear_combo(self, u1: int, u2: int, pk: Point) -> Point:
        acc = jc_add(point_mul_windowed_jc(u1, g_table()),
                     point_mul_windowed_jc(u2, pk_table(pk)))
        return jc_to_affine(acc)


class BatchOps(WindowedOps):
    name = "batch"
    batch_equation = True
    #: MSM engine for the batch equation — "auto" lets ``curve.msm_jc``
    #: switch the fresh (−R) terms to Pippenger buckets past the
    #: measured crossover; GLVOps pins "wnaf".
    msm_engine = "auto"

    def rlc_check(self, group: Sequence[RLCItem]) -> bool:
        rec = get_recorder()
        if rec.enabled:
            with rec.span("crypto.rlc_python", cat="crypto",
                          group=len(group)):
                result = self._rlc_check_python(group, rec)
            rec.counter("crypto.rlc_python_calls")
            return result
        return self._rlc_check_python(group, None)

    def _rlc_check_python(self, group: Sequence[RLCItem],
                          rec=None) -> bool:
        coeffs = rlc_coefficients(len(group))
        sg = 0
        base_terms: List[Tuple[int, Point]] = []
        fresh_terms: List[Tuple[int, Point]] = []
        for a, (u1, u2, pk, R) in zip(coeffs, group):
            sg = (sg + a * u1) % _N
            # PK terms ride cached GLV wNAF tables (reused across rounds)
            base_terms.append((a * u2 % _N, pk))
            # nonce points are one-shot: per-call tables or buckets
            fresh_terms.append((a, (R[0], (-R[1]) % _P)))   # −R
        base_terms.append((sg, G))
        stats: Dict[str, int] = {}
        acc = msm_jc(base_terms, fresh_terms, engine=self.msm_engine,
                     stats=stats)
        if rec is not None:
            rec.counter("crypto.msm_calls")
            rec.counter("crypto.msm_event_adds",
                        stats.get("event_adds", 0))
            rec.counter("crypto.msm_doublings", stats.get("doublings", 0))
            if "pip_buckets_total" in stats:
                rec.counter("crypto.msm_pippenger_calls")
                rec.observe("crypto.msm_bucket_occupancy",
                            stats["pip_buckets_used"]
                            / max(1, stats["pip_buckets_total"]))
        return jc_is_inf(acc)


class GLVOps(BatchOps):
    """BatchOps plus a uniform-operation-schedule signing side.

    ``mul_base`` (key derivation and the R = k·G nonce multiply — the
    two secret-scalar multiplications) runs the GLV regular-recoded
    ladder with a fixed double/add schedule instead of the windowed
    table walk, trading ~3× single-multiply speed for secret-independent
    operation structure. Verification-side behaviour is BatchOps with
    the interleaved-wNAF engine pinned (public inputs only).
    """

    name = "glv"
    msm_engine = "wnaf"

    def mul_base(self, k: int) -> Point:
        return point_mul_base_ct(k)

    def linear_combo(self, u1: int, u2: int, pk: Point) -> Point:
        return jc_to_affine(msm_jc([(u1, G), (u2, pk)],
                                   engine=self.msm_engine))
