"""secp256k1 point arithmetic — Jacobian-first, with affine legacy ops.

The hot inner loop of every PoFEL round's signature work is point
addition. An affine add pays a full modular inversion for the slope
(~40× the cost of a mulmod on this interpreter); a Jacobian add/double is
inversion-free, so every multi-point evaluation in this module
accumulates in Jacobian coordinates ``(X, Y, Z)`` (affine x = X/Z²,
y = Y/Z³; Z = 0 is the point at infinity) and defers normalization to a
single final inversion — or none at all for the batch equation, whose
only question is "is the sum the point at infinity?" (Z == 0).

Window tables keep *affine* entries (mixed addition Jacobian+affine is
the cheapest add form); building a table runs in Jacobian and then
normalizes all 64×15 entries with one :func:`field.batch_inv` call.

The ``affine_*`` functions preserve the pre-Jacobian implementation:
the reference's ``benchmarks/bench_hcds.py`` times them as the baseline
the Jacobian backends are measured against, and the host-side backends
use :func:`affine_point_add` for one-off sums where clarity beats speed.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, List, Optional, Sequence, Tuple

from .field import P as _P
from .field import batch_inv, inv_mod, sqrt_mod_p

# ---------------------------------------------------------------------------
# secp256k1 curve parameters (SEC 2, v2.0): y² = x³ + 7 over F_P
# ---------------------------------------------------------------------------
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
A = 0
B = 7
G: "Point" = (GX, GY)

Point = Tuple[int, int]
INF: Point = (0, 0)  # affine point-at-infinity sentinel ((0,0) is off-curve)

JPoint = Tuple[int, int, int]
J_INF: JPoint = (1, 1, 0)


def is_inf(p: Point) -> bool:
    return p[0] == 0 and p[1] == 0


def on_curve(p: Point) -> bool:
    if is_inf(p):
        return False
    x, y = p
    return (y * y - (x * x * x + B)) % _P == 0


# ---------------------------------------------------------------------------
# Affine arithmetic (legacy/baseline + host-side one-offs)
# ---------------------------------------------------------------------------

def affine_point_add(p: Point, q: Point) -> Point:
    if is_inf(p):
        return q
    if is_inf(q):
        return p
    if p[0] == q[0] and (p[1] + q[1]) % _P == 0:
        return INF
    if p == q:
        lam = (3 * p[0] * p[0] + A) * inv_mod(2 * p[1], _P) % _P
    else:
        lam = (q[1] - p[1]) * inv_mod(q[0] - p[0], _P) % _P
    x = (lam * lam - p[0] - q[0]) % _P
    y = (lam * (p[0] - x) - p[1]) % _P
    return (x, y)


def affine_point_neg(p: Point) -> Point:
    if is_inf(p):
        return p
    return (p[0], (-p[1]) % _P)


def affine_point_mul_windowed(k: int, table: "WindowTable") -> Point:
    """The affine windowed evaluation — one affine add (one inversion) per
    nonzero 4-bit digit. Kept as the measured baseline for the Jacobian
    rework; live code paths use :func:`point_mul_windowed`."""
    acc = INF
    w = 0
    while k:
        d = k & _WINDOW_MASK
        if d:
            acc = affine_point_add(acc, table[w][d - 1])
        k >>= _WINDOW_BITS
        w += 1
    return acc


def affine_multi_scalar(pairs: Sequence[Tuple[int, Point]]) -> Point:
    """Shared-doubling Σ kᵢ·Pᵢ, affine adds throughout (baseline)."""
    pairs = [(k, p) for k, p in pairs if k and not is_inf(p)]
    if not pairs:
        return INF
    acc = INF
    for i in range(max(k.bit_length() for k, _ in pairs) - 1, -1, -1):
        acc = affine_point_add(acc, acc)
        for k, p in pairs:
            if (k >> i) & 1:
                acc = affine_point_add(acc, p)
    return acc


# ---------------------------------------------------------------------------
# Jacobian arithmetic — the live representation for every multi-op chain
# ---------------------------------------------------------------------------

def jc_is_inf(p: JPoint) -> bool:
    return p[2] == 0


def jc_from_affine(p: Point) -> JPoint:
    if is_inf(p):
        return J_INF
    return (p[0], p[1], 1)


def jc_to_affine(p: JPoint) -> Point:
    if p[2] == 0:
        return INF
    zi = inv_mod(p[2], _P)
    zi2 = zi * zi % _P
    return (p[0] * zi2 % _P, p[1] * zi2 * zi % _P)


def jc_double(p: JPoint) -> JPoint:
    """dbl-2009-l (a = 0): 2M + 5S, no inversion."""
    X1, Y1, Z1 = p
    if Z1 == 0:
        return p
    A_ = X1 * X1 % _P
    B_ = Y1 * Y1 % _P
    C = B_ * B_ % _P
    t = X1 + B_
    D = 2 * (t * t - A_ - C) % _P
    E = 3 * A_ % _P
    F = E * E % _P
    X3 = (F - 2 * D) % _P
    Y3 = (E * (D - X3) - 8 * C) % _P
    Z3 = 2 * Y1 * Z1 % _P
    return (X3, Y3, Z3)


def jc_add_mixed(p: JPoint, q: Point) -> JPoint:
    """madd-2007-bl — Jacobian + affine mixed addition: 8M + 3S."""
    if is_inf(q):
        return p
    X1, Y1, Z1 = p
    if Z1 == 0:
        return (q[0], q[1], 1)
    Z1Z1 = Z1 * Z1 % _P
    U2 = q[0] * Z1Z1 % _P
    S2 = q[1] * Z1 * Z1Z1 % _P
    if U2 == X1:
        if S2 == Y1:
            return jc_double(p)
        return J_INF
    H = (U2 - X1) % _P
    HH = H * H % _P
    I = 4 * HH % _P
    J = H * I % _P
    r = 2 * (S2 - Y1) % _P
    V = X1 * I % _P
    X3 = (r * r - J - 2 * V) % _P
    Y3 = (r * (V - X3) - 2 * Y1 * J) % _P
    t = Z1 + H
    Z3 = (t * t - Z1Z1 - HH) % _P
    return (X3, Y3, Z3)


def jc_add(p: JPoint, q: JPoint) -> JPoint:
    """add-2007-bl — general Jacobian addition: 11M + 5S."""
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = Z1 * Z1 % _P
    Z2Z2 = Z2 * Z2 % _P
    U1 = X1 * Z2Z2 % _P
    U2 = X2 * Z1Z1 % _P
    S1 = Y1 * Z2 * Z2Z2 % _P
    S2 = Y2 * Z1 * Z1Z1 % _P
    if U1 == U2:
        if S1 == S2:
            return jc_double(p)
        return J_INF
    H = (U2 - U1) % _P
    I = 4 * H * H % _P
    J = H * I % _P
    r = 2 * (S2 - S1) % _P
    V = U1 * I % _P
    X3 = (r * r - J - 2 * V) % _P
    Y3 = (r * (V - X3) - 2 * S1 * J) % _P
    t = Z1 + Z2
    Z3 = (t * t - Z1Z1 - Z2Z2) % _P * H % _P
    return (X3, Y3, Z3)


# ---------------------------------------------------------------------------
# Scalar multiplication
# ---------------------------------------------------------------------------

def point_mul_naive(k: int, p: Point) -> Point:
    """Double-and-add (the algorithmic baseline backend), accumulated in
    Jacobian with a single final inversion. Constant-time not required in
    this research framework; keys only sign benchmark/e2e traffic."""
    acc = J_INF
    addend = jc_from_affine(p)
    while k:
        if k & 1:
            acc = jc_add(acc, addend)
        addend = jc_double(addend)
        k >>= 1
    return jc_to_affine(acc)


# -- windowed scalar multiplication -----------------------------------------
# A 4-bit fixed-window table over a point Q holds d * (16^w * Q) for every
# window position w and digit d, turning a 256-bit multiply into ≤ 64 point
# additions with zero doublings at evaluation time. Entries are affine so
# evaluation uses the cheapest (mixed) addition; the build itself runs in
# Jacobian and batch-normalizes every entry with ONE inversion.

_WINDOW_BITS = 4
_WINDOW_MASK = (1 << _WINDOW_BITS) - 1
_N_WINDOWS = (256 + _WINDOW_BITS - 1) // _WINDOW_BITS

WindowTable = Tuple[Tuple[Point, ...], ...]


def build_window_table(p: Point) -> WindowTable:
    if is_inf(p):
        raise ValueError("cannot build a window table for the point at "
                         "infinity")
    jrows: List[List[JPoint]] = []
    base = jc_from_affine(p)
    for _ in range(_N_WINDOWS):
        row = [base]
        for _ in range(_WINDOW_MASK - 1):
            row.append(jc_add(row[-1], base))   # row[d-1] = d * base
        jrows.append(row)
        for _ in range(_WINDOW_BITS):
            base = jc_double(base)
    # one inversion normalizes all 64×15 entries (p has prime order, so no
    # intermediate multiple of a valid input is the point at infinity)
    flat = [pt for row in jrows for pt in row]
    zinv = batch_inv([pt[2] for pt in flat])
    table: List[Tuple[Point, ...]] = []
    it = iter(zip(flat, zinv))
    for row in jrows:
        entries = []
        for _ in row:
            (X, Y, _Z), zi = next(it)
            zi2 = zi * zi % _P
            entries.append((X * zi2 % _P, Y * zi2 * zi % _P))
        table.append(tuple(entries))
    return tuple(table)


def point_mul_windowed_jc(k: int, table: WindowTable) -> JPoint:
    acc = J_INF
    w = 0
    while k:
        d = k & _WINDOW_MASK
        if d:
            acc = jc_add_mixed(acc, table[w][d - 1])
        k >>= _WINDOW_BITS
        w += 1
    return acc


def point_mul_windowed(k: int, table: WindowTable) -> Point:
    return jc_to_affine(point_mul_windowed_jc(k, table))


def strauss_shamir(u1: int, p: Point, u2: int, q: Point) -> Point:
    """Dual-scalar u1·P + u2·Q with shared doublings (Strauss–Shamir):
    one Jacobian pass over the joint bit length, one final inversion."""
    pq = affine_point_add(p, q)
    acc = J_INF
    for i in range(max(u1.bit_length(), u2.bit_length()) - 1, -1, -1):
        acc = jc_double(acc)
        b1 = (u1 >> i) & 1
        b2 = (u2 >> i) & 1
        if b1 and b2:
            acc = jc_add_mixed(acc, pq)
        elif b1:
            acc = jc_add_mixed(acc, p)
        elif b2:
            acc = jc_add_mixed(acc, q)
    return jc_to_affine(acc)


def multi_scalar_jc(pairs: Sequence[Tuple[int, Point]]) -> JPoint:
    """Σ kᵢ·Pᵢ with doublings shared across every term (n-ary
    Strauss–Shamir), Jacobian throughout — zero inversions."""
    pairs = [(k, p) for k, p in pairs if k and not is_inf(p)]
    if not pairs:
        return J_INF
    acc = J_INF
    for i in range(max(k.bit_length() for k, _ in pairs) - 1, -1, -1):
        acc = jc_double(acc)
        for k, p in pairs:
            if (k >> i) & 1:
                acc = jc_add_mixed(acc, p)
    return acc


def multi_scalar(pairs: Sequence[Tuple[int, Point]]) -> Point:
    return jc_to_affine(multi_scalar_jc(pairs))


# ---------------------------------------------------------------------------
# GLV endomorphism (secp256k1)
# ---------------------------------------------------------------------------
# secp256k1 admits an efficient endomorphism φ(x, y) = (β·x, y) with
# φ(P) = λ·P, where λ³ ≡ 1 (mod N) and β³ ≡ 1 (mod P). Decomposing a
# scalar k as k ≡ k₁ + k₂·λ (mod N) with |kᵢ| < 2¹²⁹ (lattice reduction
# against a precomputed short basis, constants from libsecp256k1) halves
# the length of every ladder: k·P = k₁·P + k₂·φ(P) runs over ~129 bits
# instead of 256.

GLV_LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
GLV_BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE

# Rounding constants gᵢ = round(2³⁸⁴·bᵢ/N) for the short lattice basis
# ((b1, -MINUS_B1), (MINUS_B1+B2... )) — see GLV §4 / libsecp256k1
# scalar_split_lambda. 384-bit shift keeps the halves under 2¹²⁹.
_GLV_G1 = 0x3086D221A7D46BCDE86C90E49284EB153DAA8A1471E8CA7FE893209A45DBB031
_GLV_G2 = 0xE4437ED6010E88286F547FA90ABFE4C4221208AC9DF506C61571B4AE8AC47F71
_GLV_MINUS_B1 = 0xE4437ED6010E88286F547FA90ABFE4C3
_GLV_B2 = 0x3086D221A7D46BCDE86C90E49284EB15


def endo(p: Point) -> Point:
    """φ(x, y) = (β·x, y) = λ·(x, y) — one field mul per application."""
    if is_inf(p):
        return p
    return (p[0] * GLV_BETA % _P, p[1])


def glv_decompose(k: int) -> Tuple[int, int]:
    """Split k into signed halves (k₁, k₂) with k₁ + k₂·λ ≡ k (mod N)
    and |kᵢ| < 2¹²⁹."""
    k %= N
    t1 = k * _GLV_G1
    t2 = k * _GLV_G2
    c1 = (t1 >> 384) + ((t1 >> 383) & 1)  # round, not floor
    c2 = (t2 >> 384) + ((t2 >> 383) & 1)
    k2 = c1 * _GLV_MINUS_B1 - c2 * _GLV_B2
    k1 = (k - k2 * GLV_LAMBDA) % N
    k1 = ((k1 + N // 2) % N) - N // 2  # centered representative
    return k1, k2


# ---------------------------------------------------------------------------
# Lazy-reduction Jacobian ops (MSM inner loop only)
# ---------------------------------------------------------------------------
# Python's signed big-int arithmetic keeps a*b % P exact for unreduced
# operands, so the MSM hot loop elides the reductions whose only purpose
# is keeping intermediates one limb small. ``jc_add_mixed``/``jc_double``
# stay untouched: they are the Jacobian baseline the benchmarks measure
# against and remain the live path for the naive/windowed backends.


def _dbl(p: JPoint) -> JPoint:
    X1, Y1, Z1 = p
    if Z1 == 0:
        return p
    A_ = X1 * X1 % _P
    B_ = Y1 * Y1 % _P
    C = B_ * B_ % _P
    t = X1 + B_
    D = 2 * (t * t - A_ - C) % _P
    E = 3 * A_  # lazy: < 3P, consumed by reducing muls below
    F = E * E % _P
    X3 = (F - 2 * D) % _P
    Y3 = (E * (D - X3) - 8 * C) % _P
    Z3 = 2 * Y1 * Z1 % _P
    return (X3, Y3, Z3)


def _madd(p: JPoint, x2: int, y2: int) -> JPoint:
    """Mixed add with lazy reduction; (x2, y2) must be a finite affine
    point."""
    X1, Y1, Z1 = p
    if Z1 == 0:
        return (x2, y2, 1)
    Z1Z1 = Z1 * Z1 % _P
    U2 = x2 * Z1Z1 % _P
    S2 = y2 * Z1 % _P * Z1Z1 % _P
    H = U2 - X1  # lazy signed, |H| < P
    if H == 0:
        if S2 == Y1:
            return _dbl(p)
        return J_INF
    HH = H * H % _P
    I = 4 * HH  # lazy, < 4P
    J = H * I % _P
    r = 2 * (S2 - Y1)  # lazy signed, |r| < 2P
    V = X1 * I % _P
    X3 = (r * r - J - 2 * V) % _P
    Y3 = (r * (V - X3) - 2 * Y1 * J) % _P
    t = Z1 + H
    Z3 = (t * t - Z1Z1 - HH) % _P
    return (X3, Y3, Z3)


# ---------------------------------------------------------------------------
# wNAF recoding
# ---------------------------------------------------------------------------

def wnaf_digits(k: int, w: int) -> List[Tuple[int, int]]:
    """Sparse width-w NAF of k > 0: returns [(bit_position, digit), ...]
    LSB-first with odd digits in (-2^(w-1), 2^(w-1)), such that
    Σ d·2^pos == k. Zero runs are skipped via trailing-zero counting
    instead of bit-by-bit iteration (the recode otherwise dominates MSM
    setup at ~70 µs/scalar)."""
    half = 1 << (w - 1)
    full = half << 1
    mask = full - 1
    out: List[Tuple[int, int]] = []
    pos = (k & -k).bit_length() - 1
    k >>= pos
    while k:
        d = k & mask
        if d >= half:
            d -= full
        out.append((pos, d))
        # d ≡ k (mod 2^w), so the shift by w below is exact
        k = (k - d) >> w
        pos += w
        if k:
            tz = (k & -k).bit_length() - 1
            k >>= tz
            pos += tz
    return out


def _signed_digits(k: int, c: int) -> List[int]:
    """Dense base-2^c signed-digit recode of k ≥ 0 (LSB first), digits in
    [-2^(c-1), 2^(c-1)] — the Pippenger bucket indices."""
    half = 1 << (c - 1)
    full = half << 1
    mask = full - 1
    out: List[int] = []
    while k:
        d = k & mask
        if d > half:
            d -= full
        out.append(d)
        k = (k - d) >> c
    return out


# ---------------------------------------------------------------------------
# MSM tables — odd multiples, GLV-paired, cached per base (true LRU)
# ---------------------------------------------------------------------------

_MSM_W = 10  # window width for cached bases (G, public keys)
_FRESH_W = 4  # window width for per-call bases (nonce points R): the
# 128-bit RLC coefficients meet w=4's table-build + digit-add total
# below w=5's (measured in BENCH_crypto.json — the 8-entry rows cost
# more to build than their sparser digits save at these batch sizes)
_GLV_SPLIT_BITS = 160  # decompose scalars longer than this


class MSMTable:
    """Odd multiples [P, 3P, ..., (2^(w-1)-1)·P] of a cached base and of
    its endomorphism image φ(P), all affine. Negative wNAF digits negate
    y at evaluation time, so no negated rows are stored."""

    __slots__ = ("pos", "phi")

    def __init__(self, pos: Tuple[Point, ...], phi: Tuple[Point, ...]):
        self.pos = pos
        self.phi = phi


def _odd_multiple_rows(points: Sequence[Point], w: int) -> List[List[Point]]:
    """Affine odd-multiple rows for several bases with ONE shared batch
    inversion across all entries."""
    jrows: List[List[JPoint]] = []
    for p in points:
        base: JPoint = (p[0], p[1], 1)
        d2 = _dbl(base)
        row = [base]
        for _ in range((1 << (w - 2)) - 1):
            row.append(jc_add(row[-1], d2))
        jrows.append(row)
    flat = [pt for row in jrows for pt in row]
    zinv = batch_inv([pt[2] for pt in flat])
    rows: List[List[Point]] = []
    it = iter(zip(flat, zinv))
    for row in jrows:
        arow: List[Point] = []
        for _ in row:
            (X, Y, _Z), zi = next(it)
            zi2 = zi * zi % _P
            arow.append((X * zi2 % _P, Y * zi2 * zi % _P))
        rows.append(arow)
    return rows


def _build_msm_table(p: Point) -> MSMTable:
    (row,) = _odd_multiple_rows([p], _MSM_W)
    # φ(m·P) = m·φ(P): the φ row is the β-map of the base row.
    phi = tuple((x * GLV_BETA % _P, y) for x, y in row)
    return MSMTable(tuple(row), phi)


_G_MSM: Optional[MSMTable] = None
_MSM_TABLES: "OrderedDict[Point, MSMTable]" = OrderedDict()
_MSM_CACHE_MAX = 256


def g_msm_table() -> MSMTable:
    global _G_MSM
    if _G_MSM is None:
        _G_MSM = _build_msm_table(G)
    return _G_MSM


def msm_table(p: Point) -> MSMTable:
    """Cached GLV wNAF table for a reused base (LRU-bounded — long
    consortium runs see many distinct signers)."""
    if p == G:
        return g_msm_table()
    t = _MSM_TABLES.get(p)
    if t is None:
        t = _build_msm_table(p)
        _MSM_TABLES[p] = t
        if len(_MSM_TABLES) > _MSM_CACHE_MAX:
            _MSM_TABLES.popitem(last=False)
    else:
        _MSM_TABLES.move_to_end(p)
    return t


# ---------------------------------------------------------------------------
# Multi-scalar multiplication engines
# ---------------------------------------------------------------------------

# Below this many normalized fresh points the interleaved-wNAF chain wins;
# above it the signed-bucket Pippenger's n/log(n) scaling takes over
# (measured crossover on CPython big-ints; see benchmarks/README.md).
PIPPENGER_MIN_FRESH = 128


def _normalize_pairs(pairs: Sequence[Tuple[int, Point]],
                     ) -> List[Tuple[int, Point]]:
    """Reduce scalars mod N, drop zero terms, GLV-split long scalars and
    fold signs into the points: returns (k > 0, affine P) pairs."""
    out: List[Tuple[int, Point]] = []
    for k, p in pairs:
        k %= N
        if k == 0 or is_inf(p):
            continue
        if k.bit_length() > _GLV_SPLIT_BITS:
            k1, k2 = glv_decompose(k)
            for ki, pi in ((k1, p), (k2, endo(p))):
                if ki < 0:
                    ki, pi = -ki, (pi[0], _P - pi[1])
                if ki:
                    out.append((ki, pi))
        else:
            out.append((k, p))
    return out


def _emit_slot(events: dict, k: int, tab: Sequence[Point], w: int,
               negate: bool = False) -> int:
    """Schedule the wNAF digits of one (scalar, table) slot onto the
    shared doubling chain; returns the number of adds emitted.

    The recode is :func:`wnaf_digits` inlined so the digit stream feeds
    the event schedule directly — no intermediate list, no (pos, digit)
    tuples, and the exact ``(k - d) >> w`` subtraction replaced by a
    shift with the borrow folded in (``d`` is the low window of ``k``,
    so a negative digit just carries +1 into the shifted scalar)."""
    half = 1 << (w - 1)
    full = half << 1
    mask = full - 1
    n = 0
    pos = (k & -k).bit_length() - 1
    k >>= pos
    while k:
        d = k & mask
        if d >= half:
            d -= full
            k = (k >> w) + 1
        else:
            k >>= w
        if negate:
            d = -d
        if d > 0:
            pt = tab[d >> 1]
        else:
            x, y = tab[(-d) >> 1]
            pt = (x, _P - y)
        ev = events.get(pos)
        if ev is None:
            events[pos] = [pt]
        else:
            ev.append(pt)
        n += 1
        pos += w
        if k:
            tz = (k & -k).bit_length() - 1
            k >>= tz
            pos += tz
    return n


def _pippenger_core(pairs: Sequence[Tuple[int, Point]], c: Optional[int],
                    stats: Optional[dict]) -> JPoint:
    """Signed-digit bucket Pippenger over normalized (k > 0, affine)
    pairs: per window, points land in |digit| buckets (sign folds into
    y), then a running suffix sum turns bucket contents into
    Σ d·bucket_d with ~2^(c-1) adds instead of a mul per bucket."""
    if not pairs:
        return J_INF
    n = len(pairs)
    if c is None:
        c = 4 if n < 48 else (5 if n < 128 else (6 if n < 384 else 8))
    half = 1 << (c - 1)
    recoded = [(_signed_digits(k, c), p) for k, p in pairs]
    nwin = max(len(d) for d, _ in recoded)
    acc = J_INF
    used = 0
    total = 0
    for win in range(nwin - 1, -1, -1):
        if acc[2] != 0:
            for _ in range(c):
                acc = _dbl(acc)
        buckets: List[Optional[JPoint]] = [None] * (half + 1)
        for digs, p in recoded:
            if win < len(digs):
                d = digs[win]
                if d > 0:
                    b = buckets[d]
                    buckets[d] = ((p[0], p[1], 1) if b is None
                                  else _madd(b, p[0], p[1]))
                elif d:
                    b = buckets[-d]
                    ny = _P - p[1]
                    buckets[-d] = ((p[0], ny, 1) if b is None
                                   else _madd(b, p[0], ny))
        total += half
        run: Optional[JPoint] = None
        tot: Optional[JPoint] = None
        for d in range(half, 0, -1):
            b = buckets[d]
            if b is not None:
                used += 1
                run = b if run is None else jc_add(run, b)
            if run is not None:
                tot = run if tot is None else jc_add(tot, run)
        if tot is not None:
            acc = jc_add(acc, tot)
    if stats is not None:
        stats["pip_points"] = n
        stats["pip_window_bits"] = c
        stats["pip_windows"] = nwin
        stats["pip_buckets_used"] = used
        stats["pip_buckets_total"] = total
    return acc


def pippenger_msm_jc(pairs: Sequence[Tuple[int, Point]],
                     c: Optional[int] = None,
                     stats: Optional[dict] = None) -> JPoint:
    """Σ kᵢ·Pᵢ via GLV-normalized signed-bucket Pippenger."""
    return _pippenger_core(_normalize_pairs(pairs), c, stats)


def msm_jc(base_pairs: Sequence[Tuple[int, Point]] = (),
           fresh_pairs: Sequence[Tuple[int, Point]] = (),
           engine: str = "auto",
           stats: Optional[dict] = None) -> JPoint:
    """Σ kᵢ·Pᵢ — the engine behind the batch verification equation.

    ``base_pairs`` are terms over reused bases (G, public keys): their
    scalars are GLV-decomposed onto cached width-``_MSM_W`` odd-multiple
    tables. ``fresh_pairs`` are one-shot bases (nonce points R): below
    :data:`PIPPENGER_MIN_FRESH` normalized points they get per-call
    width-``_FRESH_W`` tables interleaved onto the same doubling chain;
    above it they route to Pippenger buckets. ``engine`` forces a path
    ("wnaf" | "pippenger" | "auto"); "pippenger" sends *everything*
    through the bucket engine (no cached tables), which is the
    reference shape for the differential tests.
    """
    if engine not in ("auto", "wnaf", "pippenger"):
        raise ValueError(f"unknown msm engine: {engine!r}")
    if engine == "pippenger":
        merged = list(base_pairs) + list(fresh_pairs)
        if stats is not None:
            stats["engine"] = "pippenger"
        return _pippenger_core(_normalize_pairs(merged), None, stats)

    events: dict = {}
    n_adds = 0
    for k, p in base_pairs:
        k %= N
        if k == 0 or is_inf(p):
            continue
        t = msm_table(p)
        k1, k2 = glv_decompose(k)
        if k1:
            n_adds += _emit_slot(events, abs(k1), t.pos, _MSM_W, k1 < 0)
        if k2:
            n_adds += _emit_slot(events, abs(k2), t.phi, _MSM_W, k2 < 0)
    fresh = _normalize_pairs(fresh_pairs)
    pip_acc: Optional[JPoint] = None
    if fresh:
        if engine == "auto" and len(fresh) >= PIPPENGER_MIN_FRESH:
            pip_acc = _pippenger_core(fresh, None, stats)
            if stats is not None:
                stats["engine"] = "wnaf+pippenger"
        else:
            rows = _odd_multiple_rows([p for _, p in fresh], _FRESH_W)
            for (k, _p), row in zip(fresh, rows):
                n_adds += _emit_slot(events, k, row, _FRESH_W)
            if stats is not None:
                stats["engine"] = "wnaf"
    elif stats is not None:
        stats["engine"] = "wnaf"
    acc = J_INF
    if events:
        for i in range(max(events), -1, -1):
            acc = _dbl(acc)
            ev = events.get(i)
            if ev is not None:
                for x, y in ev:
                    acc = _madd(acc, x, y)
        if stats is not None:
            stats["event_adds"] = n_adds
            stats["doublings"] = max(events) + 1
    if pip_acc is not None:
        acc = jc_add(acc, pip_acc)
    return acc


def msm(base_pairs: Sequence[Tuple[int, Point]] = (),
        fresh_pairs: Sequence[Tuple[int, Point]] = (),
        engine: str = "auto") -> Point:
    return jc_to_affine(msm_jc(base_pairs, fresh_pairs, engine))


# ---------------------------------------------------------------------------
# Fixed-base scalar multiplication with a uniform operation schedule
# ---------------------------------------------------------------------------

_CT_W = 4
_CT_DIGITS = 34  # ⌈130 / _CT_W⌉ + 1 covers |half| ≤ 2^129 after |1
_CT_TABLES: Optional[Tuple[Tuple[Point, ...], ...]] = None


def _regular_recode(k: int, w: int, m: int) -> List[int]:
    """Fixed-length signed odd-digit recode (Joye–Tunstall): k odd > 0
    becomes exactly m digits, every digit odd in [-(2^w - 1), 2^w - 1]
    — no zero digits, so evaluation does the same add count for every
    scalar."""
    digs: List[int] = []
    for _ in range(m - 1):
        d = (k & ((1 << (w + 1)) - 1)) - (1 << w)
        digs.append(d)
        k = (k - d) >> w
    digs.append(k)  # remaining k is odd and 0 < k < 2^w for our sizes
    return digs


def _ct_tables() -> Tuple[Tuple[Point, ...], ...]:
    """(G⁺, G⁻, φG⁺, φG⁻) odd-multiple rows (1…2^_CT_W−1) for the
    uniform ladder — sign selection is a table choice, not a branch."""
    global _CT_TABLES
    if _CT_TABLES is None:
        g = g_msm_table()
        n_ent = 1 << (_CT_W - 1)
        gp = tuple(g.pos[:n_ent])
        pp = tuple(g.phi[:n_ent])
        gn = tuple((x, _P - y) for x, y in gp)
        pn = tuple((x, _P - y) for x, y in pp)
        _CT_TABLES = (gp, gn, pp, pn)
    return _CT_TABLES


def point_mul_base_ct(k: int) -> Point:
    """k·G with a secret-independent operation schedule.

    GLV halves the ladder, then each half runs a fixed 34-window regular
    recoding (all digits odd ⇒ every window costs exactly
    ``_CT_W`` doubles + 2 adds), signs select between precomputed ±
    tables by index, and the odd-scalar correction is applied as an
    always-computed add selected by index. This gives uniform
    *algorithmic* structure (no secret-dependent branch or add/skip
    pattern — the property analysis rule RA203 checks); CPython big-int
    timing and memory access are inherently variable and out of scope.
    """
    gp, gn, pp, pn = _ct_tables()
    k1, k2 = glv_decompose(k)
    s1, s2 = k1 < 0, k2 < 0
    a1, a2 = abs(k1), abs(k2)
    c1, c2 = 1 - (a1 & 1), 1 - (a2 & 1)  # |1 parity fix, corrected below
    d1 = _regular_recode(a1 | 1, _CT_W, _CT_DIGITS)
    d2 = _regular_recode(a2 | 1, _CT_W, _CT_DIGITS)
    t1 = (gp, gn)[s1]
    t2 = (pp, pn)[s2]
    acc = J_INF
    for i in range(_CT_DIGITS - 1, -1, -1):
        for _ in range(_CT_W):
            acc = _dbl(acc)
        e1 = d1[i]
        neg = e1 < 0
        x, y = t1[(e1, -e1)[neg] >> 1]
        acc = _madd(acc, x, (y, _P - y)[neg])
        e2 = d2[i]
        neg = e2 < 0
        x, y = t2[(e2, -e2)[neg] >> 1]
        acc = _madd(acc, x, (y, _P - y)[neg])
    # Correct the forced-odd scalars: subtract s·G (resp. s·φG) iff the
    # half was even; both candidate states are computed, index selects.
    x, y = gn[0] if not s1 else gp[0]
    acc = (acc, _madd(acc, x, y))[c1]
    x, y = pn[0] if not s2 else pp[0]
    acc = (acc, _madd(acc, x, y))[c2]
    return jc_to_affine(acc)


# ---------------------------------------------------------------------------
# Precomputed tables: the base point once, public keys cached LRU
# ---------------------------------------------------------------------------

_G_TABLE: Optional[WindowTable] = None
# public-key tables, keyed by the (x, y) point; bounded LRU cache — a
# FIFO here would evict the *hottest* signers in long consortium runs
# where > _PK_CACHE_MAX distinct keys cycle through
_PK_TABLES: "OrderedDict[Point, WindowTable]" = OrderedDict()
_PK_CACHE_MAX = 256


def g_table() -> WindowTable:
    global _G_TABLE
    if _G_TABLE is None:
        _G_TABLE = build_window_table(G)
    return _G_TABLE


def pk_table(pk: Point) -> WindowTable:
    """Cached window table for a public key — ``dverify`` against the same
    key is O(N) per consensus round, so the one-time precompute amortizes
    within a single HCDS exchange."""
    table = _PK_TABLES.get(pk)
    if table is None:
        table = build_window_table(pk)
        _PK_TABLES[pk] = table
        if len(_PK_TABLES) > _PK_CACHE_MAX:
            _PK_TABLES.popitem(last=False)
    else:
        _PK_TABLES.move_to_end(pk)
    return table


# decompressed points keyed by (x, y-parity); bounded LRU. The modular
# square root behind each decompression (~100 µs) is the single largest
# non-point-arithmetic cost of batch verification, and the in-process
# consensus run recovers the same nonce points over and over: every
# receiver re-verifies the same commit tags, the reveal phase re-checks
# the commit set, and bisection after a failed batch re-recovers every R
# in the surviving halves. None (no point has that x — a forged r) is a
# valid, cacheable answer, hence the sentinel.
_LIFT_CACHE: "OrderedDict[Tuple[int, bool], Optional[Point]]" = OrderedDict()
_LIFT_CACHE_MAX = 1024
_LIFT_MISS: Any = object()


def lift_x(x: int, odd_y: bool) -> Optional[Point]:
    """The curve point with this x and y-parity, or None when no point has
    that x (used to recover nonce points R from compact signatures)."""
    key = (x, odd_y)
    cached = _LIFT_CACHE.get(key, _LIFT_MISS)
    if cached is not _LIFT_MISS:
        _LIFT_CACHE.move_to_end(key)
        return cached
    p: Optional[Point] = None
    if x < _P:
        y2 = (pow(x, 3, _P) + B) % _P
        y = sqrt_mod_p(y2)
        if y * y % _P == y2:
            if (y & 1) != (1 if odd_y else 0):
                y = _P - y
            p = (x, y)
    _LIFT_CACHE[key] = p
    if len(_LIFT_CACHE) > _LIFT_CACHE_MAX:
        _LIFT_CACHE.popitem(last=False)
    return p
