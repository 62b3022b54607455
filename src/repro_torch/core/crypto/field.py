"""Prime-field helpers for the secp256k1 coordinate field.

Everything here is plain-Python big-int arithmetic shared by the curve
layer and the Python backends. The one performance-relevant fact driving
the module's existence: on this interpreter a modular inversion
(``pow(a, -1, p)``) costs ~40× a 256-bit ``mulmod``, which is why the
curve layer works in Jacobian coordinates (no inversion per point add)
and normalizes whole batches of points with :func:`batch_inv` (one
inversion amortized over N points, Montgomery's trick).
"""

from __future__ import annotations

from typing import List, Sequence

# secp256k1 coordinate field prime (SEC 2, v2.0): p = 2^256 - 2^32 - 977
P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F


def inv_mod(a: int, m: int) -> int:
    return pow(a, -1, m)


def sqrt_mod_p(a: int) -> int:
    """A square root of ``a`` mod P (p ≡ 3 mod 4, so one exponentiation).

    The caller must check ``r * r % P == a`` — a non-residue input returns
    a root of nothing in particular.
    """
    return pow(a, (P + 1) // 4, P)


def batch_inv(xs: Sequence[int], m: int = P) -> List[int]:
    """Montgomery's trick: invert every xᵢ with ONE modular inversion.

    Forward pass accumulates prefix products, a single ``pow(·, -1, m)``
    inverts the total, and the backward pass peels per-element inverses —
    3(N−1) multiplications + 1 inversion instead of N inversions.

    Zero entries are passed through as 0 (treated as "no inverse
    requested" rather than an error): the reference's JAX backend
    batch-normalizes combination tables whose unused slots hold the point
    at infinity (Z = 0), and skipping them here avoids a host-side filter
    pass.
    """
    xs = [x % m for x in xs]
    if not xs:
        return []
    acc = 1
    prefix = []
    for x in xs:
        prefix.append(acc)
        if x:
            acc = acc * x % m
    inv = inv_mod(acc, m)
    out = [0] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        x = xs[i]
        if x:
            out[i] = inv * prefix[i] % m
            inv = inv * x % m
    return out
