"""Cryptographic primitives for the HCDS scheme (paper §4.1).

The paper uses SHA-256 as the hash function ``H`` and ECDSA (secp256k1) as
the digital-signature algorithm (``DSign`` / ``DVerify``).  This package is
a dependency-free implementation of both:

* ``sha256_digest`` — H(r || w) over a nonce and a serialized model.
* ``ECDSAKeyPair`` / ``dsign`` / ``dverify`` — deterministic-nonce (RFC-6979
  style, HMAC-DRBG) ECDSA over secp256k1.
* ``verify_batch`` — round-level verification of many (tag, PK, digest)
  triples at once, behind a pluggable backend seam
  (``set_backend("naive" | "windowed" | "batch" | "glv" | "auto")``).

The ``batch`` backend (the default) verifies a whole phase's envelopes with
one randomized-linear-combination equation: per signature it recovers the
nonce point R from the recovery bit ``Signature.v``, then checks

    (Σ aᵢ·u1ᵢ)·G + Σ (aᵢ·u2ᵢ)·PKᵢ − Σ aᵢ·Rᵢ == ∞

for random 128-bit aᵢ, sharing doublings across all Rᵢ terms. Identical
(tag, PK, digest) triples — a consensus round re-verifies each sender's
message at N−1 receivers — are deduplicated first, which is where the
round-level win comes from. A failing batch bisects, so the caller learns
exactly which signatures were forged (``BatchVerifyResult.bad``) — the
adversary attribution the simulator's scenario reports depend on.

Package layout (the point-arithmetic hot loop lives below the seam):

* ``field``  — prime-field helpers (inversion, batched inversion, sqrt);
* ``curve``  — secp256k1 in Jacobian coordinates: add/double with no
  per-op inversion, window tables built with one batched inversion, and
  the GLV + wNAF/Pippenger multi-scalar engine (``msm_jc``) behind the
  batch equation (plus the affine legacy ops the benchmarks keep as the
  pre-Jacobian baseline);
* ``backends.python`` — the ``CurveOps`` seam and the naive / windowed /
  batch / glv backends.

This is the PyTorch port's copy of ``repro.core.crypto``. The crypto runs
in the host control plane and never touches the GPU. The reference's
limb-vectorized JAX backend (``backends/jax.py``) and its AOT kernel cache
are not carried over, so ``set_backend("auto")`` always settles on the
pure-Python ``batch`` backend.
"""

from __future__ import annotations

import contextlib
import hashlib
import hmac
import os
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

from repro_torch.core.crypto import curve, field
from repro_torch.core.crypto.backends.python import (BatchOps, CurveOps,
                                                     GLVOps, NaiveOps,
                                                     WindowedOps,
                                                     rlc_coefficient)
from repro_torch.obs import get_recorder

# ---------------------------------------------------------------------------
# Back-compat re-exports: the pre-package module exposed these names, and
# tests/benchmarks/experiments reach for them.
# ---------------------------------------------------------------------------
_P = field.P
_N = curve.N
_GX = curve.GX
_GY = curve.GY
_A = curve.A

Point = curve.Point
_INF = curve.INF
_is_inf = curve.is_inf
_inv_mod = field.inv_mod
_point_add = curve.affine_point_add
_point_mul_naive = curve.point_mul_naive
_strauss_shamir = curve.strauss_shamir
_multi_scalar = curve.multi_scalar

WindowTable = curve.WindowTable
_WINDOW_BITS = curve._WINDOW_BITS
_WINDOW_MASK = curve._WINDOW_MASK
_N_WINDOWS = curve._N_WINDOWS
_build_window_table = curve.build_window_table
_point_mul_windowed = curve.point_mul_windowed
_g_table = curve.g_table
_pk_table = curve.pk_table
_PK_TABLES = curve._PK_TABLES
_rlc_coefficient = rlc_coefficient


def _point_mul(k: int, p: Point) -> Point:
    """Scalar multiplication; routes G through the precomputed base-point
    window table, everything else through plain double-and-add."""
    if p == curve.G:
        return curve.point_mul_windowed(k, curve.g_table())
    return curve.point_mul_naive(k, p)


# ---------------------------------------------------------------------------
# Backend seam
# ---------------------------------------------------------------------------
# "naive"    — double-and-add everywhere: the pre-optimization baseline.
# "windowed" — 4-bit fixed-window tables (G precomputed, per-PK cached):
#              the per-message fast path.
# "batch"    — per-message verification identical to "windowed", but
#              ``verify_batch`` additionally folds a whole phase's tags into
#              one randomized-linear-combination equation (GLV +
#              wNAF/Pippenger MSM) with bisection fallback for attribution.
# "glv"      — ``batch`` semantics with a uniform-operation-schedule
#              fixed-base ladder on the signing side and the interleaved
#              wNAF engine pinned for the equation.
# set_backend("auto") resolves to "batch" (see _calibrate).

BACKENDS = ("naive", "windowed", "batch", "glv")
_BACKEND = "batch"
_OPS: Dict[str, CurveOps] = {}


def _get_ops(name: str) -> CurveOps:
    """The ``CurveOps`` instance for a backend name (constructed lazily)."""
    if name not in BACKENDS:
        raise ValueError(f"unknown crypto backend {name!r}; "
                         f"choose from {BACKENDS + ('auto',)}")
    ops = _OPS.get(name)
    if ops is None:
        ops = {"naive": NaiveOps,
               "windowed": WindowedOps,
               "batch": BatchOps,
               "glv": GLVOps}[name]()
        _OPS[name] = ops
    return ops


def set_backend(name: str) -> None:
    """Select the crypto backend (``"naive" | "windowed" | "batch" |
    "glv" | "auto"``). ``"auto"`` settles on "batch"
    (:func:`calibration_info` reports the decision)."""
    global _BACKEND
    if name == "auto":
        name = _calibrate()
    _get_ops(name)          # validates the name and any gated dependency
    _BACKEND = name


def get_backend() -> str:
    return _BACKEND


@contextlib.contextmanager
def use_backend(name: str) -> Iterator[None]:
    """Temporarily switch the crypto backend (benchmarks / tests)."""
    prev = get_backend()
    set_backend(name)
    try:
        yield
    finally:
        set_backend(prev)


# ---------------------------------------------------------------------------
# Backend auto-calibration
# ---------------------------------------------------------------------------

_CALIBRATION: Optional[dict] = None


def calibration_info() -> Optional[dict]:
    """The decision record of the last ``set_backend("auto")`` probe, or
    None if auto was never requested (recorded into BENCH_crypto.json by
    the benchmark sweep)."""
    return _CALIBRATION


def _calibrate(probe_n: int = 16, force: bool = False) -> str:
    """The decision behind ``set_backend("auto")``.

    The reference probes between the Python ``batch`` backend and its JAX
    limb kernel. The port has no JAX backend, so the only candidate is
    ``batch``; the decision record keeps the reference's shape.
    """
    global _CALIBRATION
    if _CALIBRATION is not None and not force:
        return _CALIBRATION["chosen"]
    _CALIBRATION = {"probe_n": probe_n, "chosen": "batch",
                    "reason": "python batch default (no jax backend in "
                              "the port)"}
    return _CALIBRATION["chosen"]


# ---------------------------------------------------------------------------
# Hashing / commitment
# ---------------------------------------------------------------------------

def sha256_digest(*parts: bytes) -> bytes:
    """H(part0 || part1 || ...) — the commitment digest of Alg. 2 line 2."""
    h = hashlib.sha256()
    for part in parts:
        h.update(part)
    return h.digest()


def random_nonce(length: int = 32) -> bytes:
    """Fixed-length random nonce r^i(k) (Alg. 2 line 1)."""
    return os.urandom(length)


# ---------------------------------------------------------------------------
# ECDSA
# ---------------------------------------------------------------------------

def _bits2int(b: bytes) -> int:
    i = int.from_bytes(b, "big")
    blen = len(b) * 8
    nlen = _N.bit_length()
    if blen > nlen:
        i >>= blen - nlen
    return i


def _rfc6979_k(msg_hash: bytes, priv: int, extra: bytes = b"") -> int:
    """Deterministic nonce per RFC 6979 (HMAC-SHA256 DRBG).

    ``extra`` is RFC 6979 §3.6 additional data k': mixed into both DRBG
    seeding steps. ``dsign`` feeds a retry counter through it when a drawn
    nonce yields r == 0 or s == 0, so retries re-randomize k while still
    signing the *caller's* digest.
    """
    holen = 32
    x = priv.to_bytes(32, "big")
    h1 = msg_hash
    v = b"\x01" * holen
    k = b"\x00" * holen
    k = hmac.new(k, v + b"\x00" + x + h1 + extra, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h1 + extra, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = _bits2int(v)
        if 1 <= cand < _N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


@dataclass(frozen=True)
class ECDSAKeyPair:
    """A BCFL node's signing identity (SK_i, PK_i)."""

    private_key: int
    public_key: Point

    @staticmethod
    def generate(seed: bytes | None = None) -> "ECDSAKeyPair":
        if seed is None:
            seed = os.urandom(32)
        priv = (int.from_bytes(hashlib.sha256(seed).digest(), "big") % (_N - 1)) + 1
        # uniform-schedule GLV ladder: key derivation is the one fixed-base
        # multiply whose scalar is a long-lived secret (RA203)
        pub = curve.point_mul_base_ct(priv)
        return ECDSAKeyPair(priv, pub)


class Signature(NamedTuple):
    """An ECDSA tag ``(r, s)`` plus the recovery bit ``v`` (the parity of
    the nonce point R's y-coordinate, after low-s normalization).

    A NamedTuple keeps full tuple compatibility with the pre-envelope wire
    format (``(r, s)`` pairs still verify; ``tuple(sig)`` still works), and
    ``to_bytes``/``from_bytes`` is the single canonical serialization used
    by envelopes, blocks, and ledger dict I/O. ``v`` lets ``verify_batch``
    recover R without a square-root ambiguity, which is what makes the
    randomized-linear-combination batch equation possible.
    """

    r: int
    s: int
    v: int = 0

    def to_bytes(self) -> bytes:
        """Canonical 65-byte wire form: r (32) ‖ s (32) ‖ v (1)."""
        return (self.r.to_bytes(32, "big") + self.s.to_bytes(32, "big")
                + bytes([self.v & 0xFF]))

    @classmethod
    def from_bytes(cls, data: bytes) -> "Signature":
        if len(data) != 65:
            raise ValueError(f"signature must be 65 bytes, got {len(data)}")
        return cls(int.from_bytes(data[:32], "big"),
                   int.from_bytes(data[32:64], "big"), data[64])

    @classmethod
    def coerce(cls, tag) -> "Signature":
        """Canonicalize any historical representation — a Signature, a bare
        ``(r, s)`` pair, a JSON-roundtripped list, or the hex of
        ``to_bytes`` — into a Signature."""
        if isinstance(tag, cls):
            return tag
        if isinstance(tag, str):
            return cls.from_bytes(bytes.fromhex(tag))
        if isinstance(tag, (tuple, list)) and len(tag) in (2, 3):
            return cls(*(int(x) for x in tag))
        raise TypeError(f"cannot coerce {type(tag).__name__} to Signature")


def dsign(digest: bytes, private_key: int) -> Signature:
    """DSign(d, SK) → tag (Alg. 2 line 3).

    The r == 0 / s == 0 retry (probability ~2^-256 per draw) re-seeds the
    RFC-6979 DRBG with a retry counter and signs the *same* digest — the
    returned tag always verifies against the digest the caller passed.
    """
    z = _bits2int(digest)
    ops = _get_ops(_BACKEND)
    retry = 0
    while True:
        extra = b"" if retry == 0 else retry.to_bytes(4, "big")
        k = _rfc6979_k(digest, private_key, extra=extra)
        x, y = ops.mul_base(k)
        r = x % _N
        if r == 0:
            retry += 1
            continue
        s = _inv_mod(k, _N) * (z + r * private_key) % _N
        if s == 0:
            retry += 1
            continue
        v = y & 1
        if s > _N // 2:  # low-s normalization
            s = _N - s
            v ^= 1       # negating s negates R, flipping the y parity
        if x >= _N:      # r overflowed the group order (p ≈ 2^256, ~2^-128)
            v |= 2       # recovery must add N back to r — flag it
        return Signature(r, s, v)


def dverify(tag, public_key: Point, digest: bytes) -> bool:
    """DVerify(tag, PK, d) → Accepted? (Alg. 2 lines 7, 15).

    Accepts a :class:`Signature` or any bare ``(r, s)`` pair; the recovery
    bit plays no role in single-message verification.
    """
    r, s = tag[0], tag[1]
    if not (1 <= r < _N and 1 <= s < _N):
        return False
    if _is_inf(public_key):
        return False
    z = _bits2int(digest)
    w = _inv_mod(s, _N)
    u1 = z * w % _N
    u2 = r * w % _N
    pt = _get_ops(_BACKEND).linear_combo(u1, u2, public_key)
    if _is_inf(pt):
        return False
    return pt[0] % _N == r


# ---------------------------------------------------------------------------
# Round-level batch verification
# ---------------------------------------------------------------------------

BatchItem = Tuple["Signature | Tuple[int, int]", Point, bytes]


class BatchVerifyResult(NamedTuple):
    """Outcome of :func:`verify_batch`: ``ok`` iff every item verifies;
    ``bad`` holds the indices (into the input sequence) of the items that
    fail individual verification — the forged-envelope attribution."""

    ok: bool
    bad: Tuple[int, ...]


def _recover_R(sig: Signature) -> Optional[Point]:
    """The nonce point R from (r, v). Returns None when no curve point has
    that x (a forged r) — the caller falls back to individual verification."""
    return curve.lift_x(sig.r + (_N if sig.v & 2 else 0), bool(sig.v & 1))


def verify_batch(items: Sequence[BatchItem],
                 backend: Optional[str] = None) -> BatchVerifyResult:
    """Verify many ``(tag, public_key, digest)`` triples at once.

    Under the ``naive``/``windowed`` backends this is a plain loop of
    :func:`dverify` calls (the per-message baseline, timed as such by the
    benchmarks). Under ``batch``/``glv`` (equation-capable backends),
    identical triples are deduplicated — one consensus round verifies each
    sender's tag at N−1 receivers, so a round-level batch collapses
    N×(N−1) checks to N — and the distinct remainder is checked with one
    randomized-linear-combination equation (Jacobian Python); on
    failure, bisection attributes the exact forged items.

    The acceptance predicate is identical across backends: an item passes
    iff ``dverify`` passes it individually.
    """
    rec = get_recorder()
    if not rec.enabled:
        return _verify_batch_impl(items, backend)
    name = backend if backend is not None else _BACKEND
    t0 = time.perf_counter()
    with rec.span("crypto.verify_batch", cat="crypto",
                  backend=name, items=len(items)):
        result = _verify_batch_impl(items, backend)
    rec.counter("crypto.verify_batch_calls")
    rec.counter("crypto.verify_batch_items", len(items))
    if result.bad:
        rec.counter("crypto.verify_batch_forged", len(result.bad))
    rec.observe("crypto.verify_batch_ms",
                (time.perf_counter() - t0) * 1e3)
    rec.observe("crypto.verify_batch_size", len(items))
    return result


def _verify_batch_impl(items: Sequence[BatchItem],
                       backend: Optional[str] = None) -> BatchVerifyResult:
    name = backend if backend is not None else _BACKEND
    ops = _get_ops(name)
    items = list(items)
    if not ops.batch_equation:
        with use_backend(name):
            bad = tuple(i for i, (tag, pk, d) in enumerate(items)
                        if not dverify(tag, pk, d))
        return BatchVerifyResult(not bad, bad)

    # -- dedup: identical triples share one verification ---------------------
    distinct: "OrderedDict[tuple, List[int]]" = OrderedDict()
    for i, (tag, pk, d) in enumerate(items):
        key = (tuple(tag), pk, d)
        distinct.setdefault(key, []).append(i)

    singles: List[tuple] = []      # keys that must go through dverify alone
    pending: List[tuple] = []      # (key, r, s, z, pk, R) awaiting s⁻¹
    for key in distinct:
        (tag, pk, d) = key[0], key[1], key[2]
        r, s = tag[0], tag[1]
        sig = Signature(*tag) if len(tag) == 3 else None
        if (sig is None or not (1 <= r < _N and 1 <= s < _N)
                or _is_inf(pk)):
            singles.append(key)
            continue
        R = _recover_R(sig)
        if R is None:
            singles.append(key)
            continue
        pending.append((key, r, s, _bits2int(d), pk, R))

    # one Montgomery pass amortizes the per-signature s⁻¹ (s ∈ [1, N) so
    # no zero entries); the per-item pow(s, -1, N) otherwise shows up at
    # batch sizes
    s_invs = field.batch_inv([p[2] for p in pending], _N)
    prepared: List[tuple] = []     # (key, (u1, u2, pk, R)) for the equation
    for (key, r, _s, z, pk, R), w in zip(pending, s_invs):
        prepared.append((key, (z * w % _N, r * w % _N, pk, R)))

    bad_keys = set()
    for key in singles:
        if not dverify(key[0], key[1], key[2]):
            bad_keys.add(key)

    def check(group: List[tuple]) -> None:
        """Recursive RLC check with bisection; leaves fall back to dverify
        (a valid tag with a tampered recovery bit fails every equation but
        must still be accepted — the predicate is dverify's)."""
        if not group:
            return
        if ops.rlc_check([prep for _, prep in group]):
            return
        if len(group) == 1:
            key = group[0][0]
            if not dverify(key[0], key[1], key[2]):
                bad_keys.add(key)
            return
        mid = len(group) // 2
        check(group[:mid])
        check(group[mid:])

    check(prepared)
    bad = tuple(sorted(i for key, idxs in distinct.items()
                       if key in bad_keys for i in idxs))
    return BatchVerifyResult(not bad, bad)
