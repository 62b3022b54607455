// Fused cosine-similarity partials for Model Evaluation (paper Eq. 2).
//
// Replaces the TPU kernel src/repro/kernels/cosine_sim.py:
// _cosine_partials_kernel (pallas_call at :90, wrapper cosine_partials):
//
//     dot[n] = sum_d W[n,d] * gw[d],  wsq[n] = sum_d W[n,d]^2,
//     gsq    = sum_d gw[d]^2,          accumulated in fp32.
//
// What bounds it: bytes. It reads W (N x D) and gw (D) once and does
// 4 flops per element of W, far below the card's ~20 flop/byte ridge in
// fp32, so its floor is (N*D + D) * sizeof(T) over HBM bandwidth. At the
// main path's 3.3 MB a second launch and rereads of gw cost more than
// the bytes do, so this is one launch that reads gw once.
//
// The TPU kernel carries dot_ref += ... across the D axis of its grid,
// which is sound only because a TPU grid runs in order. Hopper blocks run
// in no order, and the protocol needs every honest node to compute
// bit-identical partials (core/phases.py ModelEvaluation), so there are no
// atomics on floats and every sum has a fixed order:
//
// * Block s takes the s-th chunk of D (the wrapper's chunk_for(D), whole
//   tiles of kTile = 2048) for all N + 1 rows. It stages gw's tile in
//   shared memory as fp32, read from device memory once a block. Its 16
//   warps take rows w, w + 16, .. (row N is gw itself, for gsq), so 16
//   rows of loads are in flight a block. In each tile lane l owns the
//   8-byte groups k*32 + l (2 fp32 or 4 bf16 elements each), so each
//   warp-wide load of a row is 256 contiguous bytes; it reads them with
//   loads of VEC elements (VEC from D and W's alignment, as
//   weighted_agg.vector_width picks it, at most a group), the first rows'
//   before gw is staged. A lane sums a row's elements in a fixed order (k,
//   then e, in two chains over the group's halves, added at the end); VEC
//   changes the loads, never that order.
// * The lanes of a warp fold with xor shuffles, offsets 16, 8, .., 1, and
//   lane 0 writes the chunk's (dot, sq) partial of the row.
// * The last block folds. Every block takes an integer ticket with one
//   acquire-release atomic add; the block that draws the last one reads
//   every partial (through L2) and folds each row's splits in a fixed tree
//   (lane l sums splits l, l + 32, ... in order, then xor shuffles), writes
//   dot, wsq and gsq, and sets the ticket back to 0 for the next launch.
//   The ticket decides which block folds, never the order.
//
// The chunk, and with it every order, is a function of D alone, never of
// the SM count or of W's alignment. The ticket is an int32 in device memory
// that the wrapper zeroes once and keeps per (device, stream): launches on
// one stream run one after another, so one ticket per stream is never
// shared by two running launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr int kThreads = 512;               // 16 rows in flight a block
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 2048;                 // elements of D a tile

template <int BYTES>
struct Raw;
template <>
struct Raw<2> {
  using type = unsigned short;
};
template <>
struct Raw<4> {
  using type = unsigned int;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<16> {
  using type = uint4;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// a group: the EPT = 8 bytes' worth of elements of T at p (p + EPT <= end
// or not), VEC at a time; D and p are multiples of VEC, so a load is
// either whole or past the end
template <typename T, int VEC>
struct Group {
  static constexpr int EPT = 8 / sizeof(T);
  using R = typename Raw<sizeof(T) * VEC>::type;
  R raw[EPT / VEC];
  __device__ __forceinline__ void load(const T* p, long long left) {
#pragma unroll
    for (int q = 0; q < EPT / VEC; ++q) {
      if (q * VEC < left) {
        raw[q] = __ldg(reinterpret_cast<const R*>(p) + q);
      } else {
        memset(&raw[q], 0, sizeof(R));
      }
    }
  }
  __device__ __forceinline__ float get(int e) const {
    T x[VEC];
    memcpy(x, &raw[e / VEC], sizeof(R));
    return to_f32(x[e % VEC]);
  }
};

__device__ __forceinline__ float warp_fold(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename TW, int VEC, typename TG>
__global__ void __launch_bounds__(kThreads)
    cosine_partials(const TW* __restrict__ W, const TG* __restrict__ g,
                    float* __restrict__ part_dot,
                    float* __restrict__ part_sq, float* __restrict__ dot,
                    float* __restrict__ wsq, float* __restrict__ gsq,
                    unsigned* __restrict__ ticket, int n_rows, long long D,
                    long long chunk) {
  __shared__ __align__(16) float sg[kTile];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int splits = gridDim.x;
  const int s = blockIdx.x;
  const long long lo = static_cast<long long>(s) * chunk;
  const long long hi = lo + chunk < D ? lo + chunk : D;
  const int tiles = static_cast<int>((hi - lo + kTile - 1) / kTile);

  using Grp = Group<TW, VEC>;
  constexpr int kEpt = Grp::EPT;
  constexpr int kGroups = kTile / (32 * kEpt);  // groups a lane, a tile
  Grp x[kGroups];
  auto load_row = [&](int row, long long t0) {
    const TW* wr = W + static_cast<long long>(row) * D;
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const long long d0 = t0 + (k * 32 + lane) * kEpt;
      x[k].load(wr + d0, hi - d0);
    }
  };
  // gw's tile into shared memory as fp32: thread t takes 8-byte groups
  // t, t + kThreads, .., all its loads in flight at once
  auto stage_g = [&](long long t0) {
    using GrpG = Group<TG, 1>;
    constexpr int kEptG = GrpG::EPT, kPer = kTile / kEptG / kThreads;
    GrpG y[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const long long d0 = t0 + (tid + q * kThreads) * kEptG;
      y[q].load(g + d0, hi - d0);
    }
    __syncthreads();  // every warp is done with the last tile
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
#pragma unroll
      for (int e = 0; e < kEptG; ++e)
        sg[(tid + q * kThreads) * kEptG + e] = y[q].get(e);
    }
    __syncthreads();
  };

  // rows r0 + warp, r0 = 0, 16, ..; every warp runs the same trips, so a
  // chunk of several tiles (D > 2 Mi) can restage gw between them. With
  // one tile gw is staged once, while the first rows' loads fly.
  if (tiles == 1) {
    if (warp < n_rows) load_row(warp, lo);
    stage_g(lo);
  }
  for (int r0 = 0; r0 <= n_rows; r0 += kWarps) {
    const int row = r0 + warp;  // row n_rows is gw (gsq)
    float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
    for (int tile = 0; tile < tiles; ++tile) {
      const long long t0 = lo + static_cast<long long>(tile) * kTile;
      if (row < n_rows && (tiles > 1 || r0 > 0)) load_row(row, t0);
      if (tiles > 1) stage_g(t0);
      if (row > n_rows) continue;
#pragma unroll
      for (int k = 0; k < kGroups; ++k) {
        const int i0 = (k * 32 + lane) * kEpt;
        float gv[kEpt];
#pragma unroll
        for (int e = 0; e < kEpt; e += 2) {
          const float2 gq = *reinterpret_cast<const float2*>(sg + i0 + e);
          gv[e] = gq.x;
          gv[e + 1] = gq.y;
        }
#pragma unroll
        for (int e = 0; e < kEpt; ++e) {
          const float wv = row < n_rows ? x[k].get(e) : gv[e];
          if (e < kEpt / 2) {
            a0 = fmaf(wv, gv[e], a0);
            b0 = fmaf(wv, wv, b0);
          } else {
            a1 = fmaf(wv, gv[e], a1);
            b1 = fmaf(wv, wv, b1);
          }
        }
      }
    }
    if (row <= n_rows) {
      const float a = warp_fold(a0 + a1);
      const float b = warp_fold(b0 + b1);
      if (lane == 0) {
        const long long o = static_cast<long long>(row) * splits + s;
        if (row < n_rows) part_dot[o] = a;
        part_sq[o] = b;
      }
    }
  }

  // the last block to finish folds every row's partials
  __syncthreads();
  if (tid == 0) {
    // release: the block's partials (ordered before by the barrier) are
    // visible to whoever acquires the ticket after this add; acquire: the
    // last block sees every other block's
    unsigned prev;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(prev)
                 : "l"(ticket)
                 : "memory");
    last = prev == static_cast<unsigned>(splits) - 1;
  }
  __syncthreads();
  if (!last) return;
  // warp w folds rows w, w + 16, .., four at a time with all their loads
  // in flight; lane l sums splits l, l + 32, .. in order
  constexpr int kFold = 4;
  for (int r0 = warp; r0 <= n_rows; r0 += kFold * kWarps) {
    float a[kFold], b[kFold];
#pragma unroll
    for (int i = 0; i < kFold; ++i) a[i] = b[i] = 0.f;
    for (int k0 = lane; k0 < splits; k0 += 64) {
      float pa[kFold][2], pb[kFold][2];
#pragma unroll
      for (int i = 0; i < kFold; ++i) {
        const int row = r0 + i * kWarps;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int k = k0 + 32 * q;
          const long long o = static_cast<long long>(row) * splits + k;
          const bool ok = row <= n_rows && k < splits;
          pa[i][q] = ok && row < n_rows ? __ldcg(part_dot + o) : 0.f;
          pb[i][q] = ok ? __ldcg(part_sq + o) : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < kFold; ++i) {
        a[i] = (a[i] + pa[i][0]) + pa[i][1];
        b[i] = (b[i] + pb[i][0]) + pb[i][1];
      }
    }
#pragma unroll
    for (int i = 0; i < kFold; ++i) {
      const int row = r0 + i * kWarps;
      const float fa = warp_fold(a[i]);
      const float fb = warp_fold(b[i]);
      if (lane == 0 && row <= n_rows) {
        if (row < n_rows) {
          dot[row] = fa;
          wsq[row] = fb;
        } else {
          gsq[0] = fb;
        }
      }
    }
  }
  if (tid == 0) *ticket = 0u;
}

template <typename TW, int VEC, typename TG>
int launch(const void* W, const void* g, float* part, float* dot, float* wsq,
           float* gsq, unsigned* ticket, int n_rows, long long D,
           long long chunk, cudaStream_t stream) {
  if (D % VEC != 0 || chunk % kTile != 0 ||
      reinterpret_cast<uintptr_t>(W) % (sizeof(TW) * VEC) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long splits = (D + chunk - 1) / chunk;
  float* part_dot = part;
  float* part_sq = part + (n_rows + 1) * splits;
  cosine_partials<TW, VEC, TG><<<static_cast<unsigned>(splits), kThreads, 0,
                                 stream>>>(
      static_cast<const TW*>(W), static_cast<const TG*>(g), part_dot, part_sq,
      dot, wsq, gsq, ticket, n_rows, D, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename TG>
int launch_w(const void* W, int w_bf16, int vec, const void* g, float* part,
             float* dot, float* wsq, float* gsq, unsigned* ticket,
             int n_rows, long long D, long long chunk, cudaStream_t st) {
  if (w_bf16) {
    switch (vec) {
      case 1:
        return launch<__nv_bfloat16, 1, TG>(W, g, part, dot, wsq, gsq, ticket,
                                            n_rows, D, chunk, st);
      case 2:
        return launch<__nv_bfloat16, 2, TG>(W, g, part, dot, wsq, gsq, ticket,
                                            n_rows, D, chunk, st);
      case 4:
        return launch<__nv_bfloat16, 4, TG>(W, g, part, dot, wsq, gsq, ticket,
                                            n_rows, D, chunk, st);
    }
  } else {
    switch (vec) {
      case 1:
        return launch<float, 1, TG>(W, g, part, dot, wsq, gsq, ticket, n_rows,
                                    D, chunk, st);
      case 2:
        return launch<float, 2, TG>(W, g, part, dot, wsq, gsq, ticket, n_rows,
                                    D, chunk, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// W: (n_rows, D) row-major, fp32 or bf16 (w_bf16), its base aligned to
// vec elements and D a multiple of vec (1 or 2; 4 for bf16); g: (D,),
// fp32 or bf16 (g_bf16); part: 2 * (n_rows + 1) * ceil(D / chunk) fp32
// scratch; dot, wsq: (n_rows,) fp32; gsq: (1,) fp32; ticket: one uint32,
// 0 before the launch and 0 again after it, used by no other stream;
// chunk a multiple of 2048. Returns cudaGetLastError() after the one
// launch on `stream`, cudaErrorInvalidValue for another vec,
// cudaErrorMisalignedAddress if W, D or chunk does not suit.
extern "C" int repro_cosine_partials(const void* W, const void* g, int w_bf16,
                                     int g_bf16, int vec, void* part,
                                     void* dot, void* wsq, void* gsq,
                                     void* ticket, int n_rows, long long D,
                                     long long chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* o_dot = static_cast<float*>(dot);
  float* o_wsq = static_cast<float*>(wsq);
  float* o_gsq = static_cast<float*>(gsq);
  unsigned* t = static_cast<unsigned*>(ticket);
  if (g_bf16)
    return launch_w<__nv_bfloat16>(W, w_bf16, vec, g, p, o_dot, o_wsq, o_gsq,
                                   t, n_rows, D, chunk, st);
  return launch_w<float>(W, w_bf16, vec, g, p, o_dot, o_wsq, o_gsq, t, n_rows,
                         D, chunk, st);
}
