// The joint GLV Strauss-Shamir ladder of the round-level RLC batch
// equation over secp256k1 (the crypto backend "torch").
//
// Replaces no Pallas kernel: it is the port of the reference's jitted
// ladder src/repro/core/crypto/backends/jax.py:_rlc_kernel (a
// lax.fori_loop over 130 steps, :279-300). Its plain version is
// repro_torch.core.crypto.backends.limb.rlc_ladder_ref, and the two are
// bit-identical: each field op below returns the fully reduced element,
// as each of the plain version's does, and the point formulas are the
// same in the same order (dbl-2009-l, then the masked madd-2007-bl), so
// every lane's (X, Y, Z) limbs are the same canonical values.
//
// Per step and lane: a doubling (7 field multiplications) and, where the
// step's digit is nonzero, a mixed add (11). Each multiplication is an 8 x
// 8 schoolbook of 32 x 32 -> 64-bit products (64 of them) and a fold of
// the high half by 2^256 = 2^32 + 977 (mod p). What bounds it on this card:
// integer operations, 32-bit multiply-adds, never bytes: a lane reads 130
// x (2 x 64 + 1) bytes of addends and does ~150,000 wide products.
//
// Design (a simple kernel, right first): one thread owns one lane and
// keeps its X, Y, Z in registers as 8 x 32-bit limbs, with 64-bit
// accumulators for the carry chains (nvcc makes IMAD.WIDE.U32 and
// IADD3 carries of them). Lanes are independent, so there is no shared
// memory and no synchronization. The addends are read in the reference's
// (130, L, 8) int64 layout: a step's 8 limbs of a lane are 64 contiguous
// bytes and neighbouring threads read neighbouring lanes, so a warp reads
// 2 KB of consecutive bytes a step and every byte read is used; the
// kernel keeps the low 32 bits of each int64. The mask is (130, L) bytes.
// Blocks are 32 threads so that a few hundred lanes spread over that many
// SMs; each step's work is a chain of dependent multiply-adds, so a lane
// is latency-bound, and the card is mostly idle at the batch sizes of a
// round (L <= 64). Using more of it (several threads a lane, or many
// batches a launch) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLimbs = 8;
constexpr int kThreads = 32;
constexpr uint32_t kFold = 977;  // 2^256 = 2^32 + 977 (mod p)

// p = 2^256 - 2^32 - 977, little-endian 32-bit limbs
__constant__ uint32_t kP[kLimbs] = {0xFFFFFC2Fu, 0xFFFFFFFEu, 0xFFFFFFFFu,
                                    0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                                    0xFFFFFFFFu, 0xFFFFFFFFu};

struct Fe {
  uint32_t v[kLimbs];
};

// subtract p iff value + overflow * 2^256 >= p (the value is below 2p)
__device__ __forceinline__ void cond_sub_p(Fe& r, uint32_t overflow) {
  uint32_t d[kLimbs];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const uint64_t bi = (uint64_t)kP[i] + borrow;
    const uint64_t ai = r.v[i];
    d[i] = (uint32_t)(ai - bi);
    borrow = ai < bi;
  }
  const bool need = overflow != 0 || borrow == 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) r.v[i] = need ? d[i] : r.v[i];
}

__device__ __forceinline__ Fe ff_add(const Fe& a, const Fe& b) {
  Fe r;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    c += (uint64_t)a.v[i] + b.v[i];
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
  cond_sub_p(r, (uint32_t)c);
  return r;
}

__device__ __forceinline__ Fe ff_sub(const Fe& a, const Fe& b) {
  Fe r;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const uint64_t bi = (uint64_t)b.v[i] + borrow;
    const uint64_t ai = a.v[i];
    r.v[i] = (uint32_t)(ai - bi);
    borrow = ai < bi;
  }
  // a < b: add p back (the carry out cancels the borrow)
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    c += (uint64_t)r.v[i] + (borrow ? kP[i] : 0u);
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
  return r;
}

// add top * (2^32 + 977) into the limbs; returns the carry out of 2^256
__device__ __forceinline__ uint32_t fold(Fe& t, uint64_t top) {
  uint64_t c = (uint64_t)t.v[0] + top * kFold;
  t.v[0] = (uint32_t)c;
  c >>= 32;
  c += (uint64_t)t.v[1] + top;
  t.v[1] = (uint32_t)c;
  c >>= 32;
#pragma unroll
  for (int i = 2; i < kLimbs; ++i) {
    c += t.v[i];
    t.v[i] = (uint32_t)c;
    c >>= 32;
  }
  return (uint32_t)c;
}

// not inlined: 18 multiplications a step, each ~100 unrolled instructions,
// inlined made nvcc take ~50 s over this file (the build's longest), with
// no gain to a lane whose time is one dependent chain anyway
__device__ __noinline__ Fe ff_mul(const Fe& a, const Fe& b) {
  // 8 x 8 schoolbook, row by row: each partial sum a*b + w + c fits 64 bits
  uint32_t w[2 * kLimbs];
#pragma unroll
  for (int i = 0; i < 2 * kLimbs; ++i) w[i] = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) {
      const uint64_t t = (uint64_t)a.v[i] * b.v[j] + w[i + j] + c;
      w[i + j] = (uint32_t)t;
      c = t >> 32;
    }
    w[i + kLimbs] = (uint32_t)c;
  }
  // value = L + H * 2^256 = L + H * 977 + H * 2^32 (mod p)
  Fe t;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    c += (uint64_t)w[i] + (uint64_t)w[i + kLimbs] * kFold +
         (i ? w[i + kLimbs - 1] : 0u);
    t.v[i] = (uint32_t)c;
    c >>= 32;
  }
  const uint64_t top = c + w[2 * kLimbs - 1];  // value >> 256, < 2^34
  uint32_t over = fold(t, top);
  over = fold(t, over);  // 0 afterwards: t was small if it carried
  cond_sub_p(t, over);
  return t;
}

__device__ __forceinline__ Fe ff_sqr(const Fe& a) { return ff_mul(a, a); }

__device__ __forceinline__ Fe ff_x2(const Fe& a) { return ff_add(a, a); }

__device__ __forceinline__ bool ff_is_zero(const Fe& a) {
  uint32_t o = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) o |= a.v[i];
  return o == 0;
}

// dbl-2009-l (a = 0); a lane at infinity (Z = 0) stays there
__device__ __forceinline__ void jc_double(Fe& X, Fe& Y, Fe& Z) {
  const Fe A = ff_sqr(X);
  const Fe B = ff_sqr(Y);
  const Fe C = ff_sqr(B);
  const Fe D = ff_x2(ff_sub(ff_sub(ff_sqr(ff_add(X, B)), A), C));
  const Fe E = ff_add(ff_x2(A), A);
  const Fe X3 = ff_sub(ff_sqr(E), ff_x2(D));
  const Fe C4 = ff_x2(ff_x2(C));
  const Fe Y3 = ff_sub(ff_mul(E, ff_sub(D, X3)), ff_x2(C4));
  const Fe Z3 = ff_x2(ff_mul(Y, Z));
  X = X3;
  Y = Y3;
  Z = Z3;
}

// madd-2007-bl: P + (x2, y2) for a lane whose step adds. P at infinity
// gives (x2, y2, 1); P == -Q gives Z = 0. P == Q also gives Z = 0, where
// it should double: the reference's deliberate omission (wrong but safe:
// the equation fails and bisection falls back to dverify).
__device__ __forceinline__ void jc_add_mixed(Fe& X1, Fe& Y1, Fe& Z1,
                                             const Fe& x2, const Fe& y2) {
  if (ff_is_zero(Z1)) {
    X1 = x2;
    Y1 = y2;
#pragma unroll
    for (int i = 0; i < kLimbs; ++i) Z1.v[i] = i == 0;
    return;
  }
  const Fe Z1Z1 = ff_sqr(Z1);
  const Fe U2 = ff_mul(x2, Z1Z1);
  const Fe S2 = ff_mul(y2, ff_mul(Z1, Z1Z1));
  const Fe H = ff_sub(U2, X1);
  const Fe r = ff_x2(ff_sub(S2, Y1));
  const Fe HH = ff_sqr(H);
  const Fe I = ff_x2(ff_x2(HH));
  const Fe J = ff_mul(H, I);
  const Fe V = ff_mul(X1, I);
  const Fe X3 = ff_sub(ff_sub(ff_sqr(r), J), ff_x2(V));
  const Fe Y3 = ff_sub(ff_mul(r, ff_sub(V, X3)), ff_x2(ff_mul(Y1, J)));
  const Fe Z3 = ff_sub(ff_sub(ff_sqr(ff_add(Z1, H)), Z1Z1), HH);
  X1 = X3;
  Y1 = Y3;
  Z1 = Z3;
}

__device__ __forceinline__ Fe load_limbs(const long long* p) {
  const longlong2* q = reinterpret_cast<const longlong2*>(p);
  Fe r;
#pragma unroll
  for (int i = 0; i < kLimbs / 2; ++i) {
    const longlong2 v = __ldg(q + i);
    r.v[2 * i] = (uint32_t)v.x;
    r.v[2 * i + 1] = (uint32_t)v.y;
  }
  return r;
}

__device__ __forceinline__ void store_limbs(long long* p, const Fe& a) {
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) p[i] = (long long)a.v[i];
}

__global__ void __launch_bounds__(kThreads)
    rlc_ladder_kernel(const long long* __restrict__ step_x,
                      const long long* __restrict__ step_y,
                      const uint8_t* __restrict__ step_use, int steps,
                      int lanes, long long* __restrict__ out_x,
                      long long* __restrict__ out_y,
                      long long* __restrict__ out_z) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  Fe X, Y, Z;  // every lane starts at infinity (1, 1, 0)
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    X.v[i] = i == 0;
    Y.v[i] = i == 0;
    Z.v[i] = 0;
  }
  for (int j = 0; j < steps; ++j) {
    jc_double(X, Y, Z);
    const size_t at = (size_t)j * lanes + lane;
    if (step_use[at]) {
      const Fe x2 = load_limbs(step_x + at * kLimbs);
      const Fe y2 = load_limbs(step_y + at * kLimbs);
      jc_add_mixed(X, Y, Z, x2, y2);
    }
  }
  store_limbs(out_x + (size_t)lane * kLimbs, X);
  store_limbs(out_y + (size_t)lane * kLimbs, Y);
  store_limbs(out_z + (size_t)lane * kLimbs, Z);
}

}  // namespace

// step_x, step_y: (steps, lanes, 8) int64 limbs below 2^32; step_use:
// (steps, lanes) bool; out_x/y/z: (lanes, 8) int64. Returns the launch's
// CUDA error code.
extern "C" int repro_rlc_ladder(const void* step_x, const void* step_y,
                                const void* step_use, int steps, int lanes,
                                void* out_x, void* out_y, void* out_z,
                                void* stream) {
  if (lanes < 1 || steps < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((lanes + kThreads - 1) / kThreads);
  rlc_ladder_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const long long*>(step_x),
      static_cast<const long long*>(step_y),
      static_cast<const uint8_t*>(step_use), steps, lanes,
      static_cast<long long*>(out_x), static_cast<long long*>(out_y),
      static_cast<long long*>(out_z));
  return (int)cudaGetLastError();
}
