"""Limb-vectorized secp256k1 backend on the card (``set_backend("torch")``).

Port of the reference's JAX backend (``repro.core.crypto.backends.jax``,
``set_backend("jax")``). The round-level RLC batch equation

    (Σ aᵢ·u1ᵢ)·G + Σ (aᵢ·u2ᵢ)·PKᵢ − Σ aᵢ·Rᵢ == ∞

runs as ONE ladder over all N deduplicated signatures, a lane each.
Representation:

* a field element is 8 little-endian 32-bit limbs held in ``int64``
  lanes, shape ``(lanes, 8)``. The reference holds them in ``uint64``;
  most torch ops do not take ``torch.uint64``, and ``int64`` serves: a
  product of two limbs wraps modulo 2^64 with the unsigned product's
  bits, so ``x & MASK32`` is its low half and ``(x >> 32) & MASK32`` its
  high half (the shift is arithmetic: every right shift is masked);
  column sums stay below 2^37 and the borrow compare sees values below
  2^33, all positive;
* reduction mod p = 2^256 − 2^32 − 977 folds the high half as
  H·(2^32 + 977); every field op returns a fully reduced element, so a
  lane's (X, Y, Z) limbs are canonical and the CUDA kernel is held to
  the plain version limb for limb, with no tolerance;
* points are Jacobian ``(X, Y, Z)`` limb triples, doubled by dbl-2009-l
  and added by the masked mixed add madd-2007-bl, the reference's
  formulas in the reference's order. The mixed add omits the P == Q
  branch, as the reference's does: a collision zeroes Z, the equation
  fails, and bisection falls back to ``dverify`` (wrong but safe, never
  a false accept);
* each signature is one lane of a joint GLV Strauss–Shamir ladder: 130
  shared double steps over a per-lane 8-entry subset-sum table of
  ±PK, ±φPK and −R, one masked mixed add a step.

The host preparation is the reference's, step for step: the RLC
coefficients; the GLV split with signs folded into the points; the four
combination slots normalized by one zero-skipping ``batch_inv`` (an
adversarial PK = R makes a slot the point at infinity, which stays
masked off: adding nothing); the digit gather into ``(130, L, 8)``
addends; lanes padded to a power of two; the lanes' accumulators and
the shared G term folded on the host (``point_mul_windowed_jc``).

The ladder is :func:`repro_torch.kernels.rlc_ladder.rlc_ladder`: on the
card the hand-written kernel ``kernels/csrc/rlc_ladder.cu`` (one thread a
lane), on the CPU :func:`rlc_ladder_ref`, the plain torch version of the
reference's ``_rlc_kernel``. :class:`LimbOps` runs on the card unless
it is given ``device="cpu"``; with no card and no device it raises.
There is no fallback: a failed build or launch raises. Per-message
operations (``dsign``/``dverify``) stay on the windowed Python path, as
the reference's do. The ladder's library is built by
``kernels._build`` at first use and cached on disk (``..aotcache``).
"""

from __future__ import annotations

import time
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..curve import (JPoint, endo, g_table, glv_decompose, jc_add, jc_is_inf,
                     point_mul_windowed_jc)
from ..curve import N as _N
from ..field import P as _P
from ..field import batch_inv
from .python import BatchOps, RLCItem, rlc_coefficient
from repro_torch.obs import get_recorder

_LIMBS = 8
_LBITS = 32
_MASK32 = (1 << 32) - 1
_FOLD = 977          # 2^256 ≡ 2^32 + 977 (mod p)

_P_LIMBS_HOST = [(_P >> (_LBITS * i)) & _MASK32 for i in range(_LIMBS)]


# ---------------------------------------------------------------------------
# host <-> limb conversion (the reference's, numpy)
# ---------------------------------------------------------------------------

def to_limbs(x: int) -> np.ndarray:
    return np.array([(x >> (_LBITS * i)) & _MASK32 for i in range(_LIMBS)],
                    dtype=np.uint64)


def from_limbs(arr) -> int:
    out = 0
    for i, limb in enumerate(np.asarray(arr).astype(np.uint64).tolist()):
        out |= int(limb) << (_LBITS * i)
    return out


def scalar_bits(k: int) -> np.ndarray:
    """(256,) uint8, most-significant bit first."""
    return np.unpackbits(
        np.frombuffer((k % (1 << 256)).to_bytes(32, "big"), dtype=np.uint8))


def scalar_bits_n(k: int, nbits: int) -> np.ndarray:
    """(nbits,) uint8, most-significant bit first (GLV half scalars)."""
    nbytes = (nbits + 7) // 8
    bits = np.unpackbits(
        np.frombuffer((k % (1 << nbits)).to_bytes(nbytes, "big"),
                      dtype=np.uint8))
    return bits[-nbits:]


# ---------------------------------------------------------------------------
# field arithmetic on (..., 8) int64 limb tensors (fully reduced invariant)
# ---------------------------------------------------------------------------
# The reference unrolls each carry or borrow chain limb by limb at trace
# time. Eager torch would pay an op a limb, so here a chain is a few
# whole-vector passes: each pass moves every limb's carry (or borrow) one
# limb up, until none is left (at most one pass a limb). The values are
# the reference's, intermediate ones included.

def _carry_chain(cols: torch.Tensor):
    """Propagate carries over column sums (..., n), each non-negative and
    below 2^62: the n 32-bit limbs, and the carry out of the top."""
    out = torch.zeros_like(cols[..., 0])
    while True:
        carry = cols >> _LBITS
        if not bool(carry.any()):
            return cols, out
        cols = (cols & _MASK32) + F.pad(carry[..., :-1], (1, 0))
        out = out + carry[..., -1]


def _sub_chain(a: torch.Tensor, b: torch.Tensor):
    """Limbwise a − b with borrow propagation: the 32-bit limbs of
    a − b mod 2^256, and the borrow out of the top (0/1)."""
    d = a - b
    out = torch.zeros_like(d[..., 0])
    while True:
        neg = (d < 0).to(d.dtype)
        if not bool(neg.any()):
            return d, out
        d = d + (neg << _LBITS) - F.pad(neg[..., :-1], (1, 0))
        out = out + neg[..., -1]


def _p_limbs(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(_P_LIMBS_HOST, dtype=torch.int64, device=like.device)


def _cond_sub_p(limbs: torch.Tensor, overflow: torch.Tensor) -> torch.Tensor:
    """Subtract p iff ``limbs + overflow·2^256 >= p`` (value < 2p)."""
    d, borrow = _sub_chain(limbs, _p_limbs(limbs))
    need = (overflow > 0) | (borrow == 0)
    return torch.where(need[..., None], d, limbs)


def _fold_overflow(limbs: torch.Tensor, overflow: torch.Tensor):
    """Add ``overflow·(2^32 + 977)`` into the low limbs (2^256 ≡ that)."""
    low = torch.stack((overflow * _FOLD, overflow), dim=-1)
    return _carry_chain(limbs + F.pad(low, (0, _LIMBS - 2)))


def ff_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _cond_sub_p(*_carry_chain(a + b))


def ff_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d, borrow = _sub_chain(a, b)
    limbs, _ = _carry_chain(d + borrow[..., None] * _p_limbs(d))
    return limbs                       # the carry-out cancels the borrow


def ff_small(a: torch.Tensor, m: int) -> torch.Tensor:
    """a·m for a small constant m (2, 3, 4, 8): limbwise multiply + fold."""
    limbs, carry = _carry_chain(a * m)
    limbs, carry = _fold_overflow(limbs, carry)          # carry < m
    limbs, carry = _fold_overflow(limbs, carry)          # carry now 0/1
    return _cond_sub_p(limbs, carry)


def _columns(rows: torch.Tensor, shift: int) -> torch.Tensor:
    """(..., 8, 8) → (..., 16): row i's entries added into columns
    i + shift .. i + shift + 7 (each row padded to 17 entries, so the flat
    rows re-read 16 wide slide one column a row)."""
    lead = rows.shape[:-2]
    flat = F.pad(rows, (shift, _LIMBS + 1 - shift)).flatten(-2)
    return flat[..., :2 * _LIMBS * _LIMBS].reshape(
        lead + (_LIMBS, 2 * _LIMBS)).sum(-2)


def ff_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # 8×8 schoolbook with lazily-split columns: lo halves land in column
    # i+j, hi halves in i+j+1; each column sums ≤ 16 values < 2^32. The
    # int64 product wraps with the unsigned product's bits.
    prod = a[..., :, None] * b[..., None, :]             # (..., 8, 8)
    lo = prod & _MASK32
    hi = (prod >> _LBITS) & _MASK32
    m, _ = _carry_chain(_columns(lo, 0) + _columns(hi, 1))   # < p² < 2^512
    # fold the high half: v = L + H·(2^32 + 977)  (≤ 10 limbs)
    lo8, hi8 = m[..., :_LIMBS], m[..., _LIMBS:]
    v, _ = _carry_chain(F.pad(lo8 + hi8 * _FOLD, (0, 2))
                        + F.pad(hi8, (1, 1)))
    top = v[..., _LIMBS] + (v[..., _LIMBS + 1] << _LBITS)  # value >> 256
    limbs, carry = _fold_overflow(v[..., :_LIMBS], top)
    limbs, carry = _fold_overflow(limbs, carry)
    return _cond_sub_p(limbs, carry)


def ff_sqr(a: torch.Tensor) -> torch.Tensor:
    return ff_mul(a, a)


def ff_is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=-1)


# ---------------------------------------------------------------------------
# Jacobian point ops on limb lanes
# ---------------------------------------------------------------------------

def _sel(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Lane-masked select over limb tensors (mask shape (...,))."""
    return torch.where(mask[..., None], a, b)


def jc_double_v(X, Y, Z):
    """dbl-2009-l (a = 0); an infinity lane (Z = 0) stays at infinity."""
    A_ = ff_sqr(X)
    B_ = ff_sqr(Y)
    C = ff_sqr(B_)
    D = ff_small(ff_sub(ff_sub(ff_sqr(ff_add(X, B_)), A_), C), 2)
    E = ff_small(A_, 3)
    X3 = ff_sub(ff_sqr(E), ff_small(D, 2))
    Y3 = ff_sub(ff_mul(E, ff_sub(D, X3)), ff_small(C, 8))
    Z3 = ff_small(ff_mul(Y, Z), 2)
    return X3, Y3, Z3


def jc_add_mixed_v(X1, Y1, Z1, x2, y2, use):
    """Per-lane P + (x2, y2) (madd-2007-bl); ``use`` masks lanes that add.

    Handles P at infinity and P == −Q (H = 0 zeroes Z3). The P == Q case
    also lands on Z3 = 0: wrong (it should double) but safe, the
    reference's trade (module docstring)."""
    Z1Z1 = ff_sqr(Z1)
    U2 = ff_mul(x2, Z1Z1)
    S2 = ff_mul(y2, ff_mul(Z1, Z1Z1))
    H = ff_sub(U2, X1)
    r = ff_small(ff_sub(S2, Y1), 2)
    HH = ff_sqr(H)
    I = ff_small(HH, 4)
    J = ff_mul(H, I)
    V = ff_mul(X1, I)
    X3 = ff_sub(ff_sub(ff_sqr(r), J), ff_small(V, 2))
    Y3 = ff_sub(ff_mul(r, ff_sub(V, X3)), ff_small(ff_mul(Y1, J), 2))
    Z3 = ff_sub(ff_sub(ff_sqr(ff_add(Z1, H)), Z1Z1), HH)
    p_inf = ff_is_zero(Z1)
    one = torch.zeros_like(X1)
    one[..., 0] = 1
    X3 = _sel(p_inf, x2, X3)
    Y3 = _sel(p_inf, y2, Y3)
    Z3 = _sel(p_inf, one, Z3)
    keep = ~use
    return (_sel(keep, X1, X3), _sel(keep, Y1, Y3), _sel(keep, Z1, Z3))


# ---------------------------------------------------------------------------
# the batch-equation ladder
# ---------------------------------------------------------------------------

def rlc_ladder_ref(step_x: torch.Tensor, step_y: torch.Tensor,
                   step_use: torch.Tensor):
    """Joint Strauss–Shamir ladder over every lane: the plain version of
    the reference's ``_rlc_kernel`` and of ``kernels/csrc/rlc_ladder.cu``.

    step_x/step_y: (S, L, 8) int64 — MSB-first ladder addends;
    step_use:      (S, L) bool — False steps add nothing.
    Returns per-lane Jacobian (X, Y, Z) limbs, (L, 8) int64 each; every
    lane starts at infinity (1, 1, 0)."""
    L = step_x.shape[1]
    zeros = torch.zeros((L, _LIMBS), dtype=torch.int64,
                        device=step_x.device)
    one = zeros.clone()
    one[:, 0] = 1
    X, Y, Z = one, one.clone(), zeros
    for j in range(step_x.shape[0]):
        X, Y, Z = jc_double_v(X, Y, Z)
        X, Y, Z = jc_add_mixed_v(X, Y, Z, step_x[j], step_y[j],
                                 step_use[j])
    return X, Y, Z


# GLV ladder length: half scalars are < 2^129, the −R coefficient is
# 128-bit — 130 steps covers both with margin.
_GLV_STEPS = 130
_SLOTS = 8

# whether this process has loaded the ladder's library: its first call on
# the card pays the load (or the build); tracked here, not in the
# recorder, so the compile/execute attribution survives recorder swaps
_LIBRARY_LOADED = False


def _load_library() -> str:
    """Load (building it if missing) the ladder's library; "cache" or
    "build" (``..aotcache``)."""
    global _LIBRARY_LOADED
    from .. import aotcache
    _fn, source = aotcache.load_kernel()
    _LIBRARY_LOADED = True
    return source


def warm_bucket(lanes: int) -> dict:
    """Load the ladder's library and run one ladder of ``lanes`` lanes on
    the card on zero addends, timing the load and the first call: the
    aotcache CLI's warm/smoke primitive. A failure goes into ``error``."""
    info: dict = {"lanes": lanes, "steps": _GLV_STEPS}
    try:
        from repro_torch.kernels.rlc_ladder import rlc_ladder
        t0 = time.perf_counter()
        info["source"] = _load_library()
        info["load_s"] = time.perf_counter() - t0
        dev = torch.device("cuda")
        zeros = torch.zeros((_GLV_STEPS, lanes, _LIMBS), dtype=torch.int64,
                            device=dev)
        use = torch.zeros((_GLV_STEPS, lanes), dtype=torch.bool, device=dev)
        t0 = time.perf_counter()
        X, _Y, _Z = rlc_ladder(zeros, zeros, use)
        X.cpu()                                   # block until ready
        info["first_call_s"] = time.perf_counter() - t0
    except Exception as exc:
        info["error"] = f"{type(exc).__name__}: {exc}"
    return info


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def prepare(group: Sequence[RLCItem]) -> tuple:
    """The reference's host preparation of one RLC check: (sg, step_x,
    step_y, step_use) with the addends as numpy ``int64`` (130, L, 8)
    and (130, L) bool, L the lanes padded to a power of two, and sg the
    shared G coefficient."""
    coeffs = [rlc_coefficient() for _ in group]
    sg = 0
    n = len(group)
    L = _next_pow2(n)
    tx = np.zeros((L, _SLOTS, _LIMBS), dtype=np.uint64)
    ty = np.zeros((L, _SLOTS, _LIMBS), dtype=np.uint64)
    use = np.zeros((L, _SLOTS), dtype=bool)
    digits = np.zeros((_GLV_STEPS, L), dtype=np.int64)
    # per lane: P1 = ±PK, P2 = ±φPK (GLV halves of a·u2, signs folded
    # into the points), P3 = −R with the 128-bit coefficient a
    combos: List[JPoint] = []   # slots 3,5,6,7 per lane, Jacobian
    for lane, (a, (u1, u2, pk, R)) in enumerate(zip(coeffs, group)):
        sg = (sg + a * u1) % _N
        b1, b2 = glv_decompose(a * u2 % _N)
        phi = endo(pk)
        p1 = (pk[0], pk[1] if b1 >= 0 else _P - pk[1])
        p2 = (phi[0], phi[1] if b2 >= 0 else _P - phi[1])
        p3 = (R[0], (-R[1]) % _P)
        j1: JPoint = (p1[0], p1[1], 1)
        j3: JPoint = (p3[0], p3[1], 1)
        c12 = jc_add(j1, (p2[0], p2[1], 1))
        combos.extend((c12, jc_add(j1, j3),
                       jc_add((p2[0], p2[1], 1), j3), jc_add(c12, j3)))
        for slot, pt in ((1, p1), (2, p2), (4, p3)):
            tx[lane, slot] = to_limbs(pt[0])
            ty[lane, slot] = to_limbs(pt[1])
            use[lane, slot] = True
        digits[:, lane] = (scalar_bits_n(abs(b1), _GLV_STEPS)
                           + 2 * scalar_bits_n(abs(b2), _GLV_STEPS)
                           + 4 * scalar_bits_n(a, _GLV_STEPS))
    # one zero-skipping batch inversion normalizes every combo; a Z = 0
    # combo (adversarial PK/R alignment) stays masked off — adding the
    # point at infinity is exactly "add nothing"
    zinv = batch_inv([c[2] for c in combos])
    for i, ((X, Y, Z), zi) in enumerate(zip(combos, zinv)):
        if Z == 0:
            continue
        lane, slot = divmod(i, 4)
        slot = (3, 5, 6, 7)[slot]
        zi2 = zi * zi % _P
        tx[lane, slot] = to_limbs(X * zi2 % _P)
        ty[lane, slot] = to_limbs(Y * zi2 * zi % _P)
        use[lane, slot] = True
    lanes = np.arange(L)
    step_x = tx[lanes[None, :], digits].astype(np.int64)   # (130, L, 8)
    step_y = ty[lanes[None, :], digits].astype(np.int64)
    step_use = use[lanes[None, :], digits]
    return sg, step_x, step_y, step_use


def fold(sg: int, X, Y, Z, n: int) -> bool:
    """The lanes' accumulators plus the shared G term, on the host: is
    the sum the point at infinity?"""
    acc: JPoint = point_mul_windowed_jc(sg, g_table())
    for lane in range(n):
        acc = jc_add(acc, (from_limbs(X[lane]), from_limbs(Y[lane]),
                           from_limbs(Z[lane])))
    return jc_is_inf(acc)


class LimbOps(BatchOps):
    """``batch`` semantics with the RLC equation on the limb ladder: the
    CUDA kernel on the card, its plain version on the CPU."""

    name = "torch"
    batch_equation = True
    #: below this lane count the ladder cannot amortize its launch and
    #: copies — the Python Jacobian equation wins (bisection leaves land
    #: here)
    min_lanes = 2

    def __init__(self, device=None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "crypto backend 'torch' runs its RLC ladder on a CUDA "
                    "card, and none was found; pass device='cpu' for its "
                    "plain version")
            device = "cuda"
        self.device = torch.device(device)

    def rlc_check(self, group: Sequence[RLCItem]) -> bool:
        if len(group) < self.min_lanes:
            return super().rlc_check(group)
        rec = get_recorder()
        if rec.enabled:
            return self._rlc_check_traced(group)
        return self._rlc_check_torch(group)

    def _rlc_check_traced(self, group: Sequence[RLCItem]) -> bool:
        # the process's first call on the card loads (or builds) the
        # ladder's library; splitting it out is the load-vs-execute
        # latency decomposition
        rec = get_recorder()
        L = _next_pow2(len(group))
        load = self.device.type == "cuda" and not _LIBRARY_LOADED
        with rec.span("crypto.rlc_torch", cat="crypto", group=len(group),
                      lanes=L, compile=load):
            result = self._rlc_check_torch(group)
        if load:
            rec.counter("crypto.torch_library_loads")
        rec.counter("crypto.rlc_torch_calls")
        rec.observe("crypto.rlc_torch_lanes", L)
        return result

    def _rlc_check_torch(self, group: Sequence[RLCItem]) -> bool:
        from repro_torch.kernels.rlc_ladder import rlc_ladder
        sg, step_x, step_y, step_use = prepare(group)
        if self.device.type == "cuda" and not _LIBRARY_LOADED:
            _load_library()
        dev = self.device
        X, Y, Z = rlc_ladder(torch.from_numpy(step_x).to(dev),
                             torch.from_numpy(step_y).to(dev),
                             torch.from_numpy(step_use).to(dev))
        X, Y, Z = X.cpu().numpy(), Y.cpu().numpy(), Z.cpu().numpy()
        return fold(sg, X, Y, Z, len(group))


__all__ = ["LimbOps", "ff_add", "ff_is_zero", "ff_mul", "ff_small", "ff_sqr",
           "ff_sub", "fold", "from_limbs", "jc_add_mixed_v", "jc_double_v",
           "prepare", "rlc_ladder_ref", "scalar_bits", "scalar_bits_n",
           "to_limbs", "warm_bucket"]
