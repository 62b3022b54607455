// Weighted model aggregation for Model Evaluation (paper Eq. 1).
//
// Replaces the TPU kernel src/repro/kernels/weighted_agg.py:
// _weighted_agg_kernel (pallas_call at :56, wrapper weighted_aggregate):
//
//     gw[d] = sum_n lam[n] * W[n,d],   lam = w / sum(w), in fp32.
//
// What bounds it: bytes. It reads W (N x D) once and writes gw (D); two
// flops per element of W is far below the fp32 ridge, so its floor is
// (N*D * sizeof(T) + N*4 + D*4) over HBM bandwidth.
//
// The TPU kernel computes (1, N) @ (N, bd) panels on the MXU. That is a
// GEMV, with nothing for a tensor core to gain; what matters is keeping
// enough bytes in flight. Each thread owns V consecutive columns and reads
// a row of them with one V-wide load (up to 16 bytes: V <= 4 for fp32,
// V <= 8 for bf16; the wrapper picks the widest V that divides D and the
// base pointer's alignment, so every row start is aligned too).
// Neighbouring threads own neighbouring columns, so every row read is
// coalesced. Rows are taken in chunks of up to 8, the chunk's loads
// started before its fmaf's, so each thread has up to 8 loads in flight
// instead of one dependent load->fmaf chain. The sum per column still
// runs n = 0..N-1 in order in fp32 with no atomics, so the same input
// gives bit-identical gw on every run, as the protocol requires of all
// honest nodes.
//
// lam is normalized here, not by three launches in the wrapper: every
// thread sums the raw fp32 weights in order n = 0..N-1 (the same bits in
// every thread), then a block divides each weight by that sum once into
// shared memory (256 rows at a time) for its threads to read. The grid is
// sized to the card, at most 8 blocks of 256 threads an SM, and walks the
// columns in a grid-stride loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kRowChunk = 8;   // rows whose loads are in flight together
constexpr int kLamRows = 256;  // normalized weights held in shared memory
constexpr int kBlocksPerSm = 8;

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

// V consecutive elements of T, read with one load
template <typename T, int V>
struct Vec {
  using R = typename Raw<sizeof(T) * V>::type;
  R raw;
  __device__ __forceinline__ void load(const T* p) {
    raw = __ldg(reinterpret_cast<const R*>(p));
  }
  __device__ __forceinline__ float get(int i) const {
    T e[V];
    memcpy(e, &raw, sizeof raw);
    return to_f32(e[i]);
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    weighted_agg(const T* __restrict__ W, const float* __restrict__ w,
                 float* __restrict__ out, int n_rows, long long D) {
  __shared__ float lam[kLamRows];
  float total = 0.f;
  for (int n = 0; n < n_rows; ++n) total += __ldg(w + n);

  const long long n_vec = D / V;
  // the trip count depends on the block only, so every thread reaches
  // the barriers below
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads;
       base < n_vec; base += static_cast<long long>(gridDim.x) * kThreads) {
    const long long g = base + threadIdx.x;
    const bool active = g < n_vec;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    for (int n0 = 0; n0 < n_rows; n0 += kLamRows) {
      const int nc = min(kLamRows, n_rows - n0);
      __syncthreads();  // every thread is done with the previous lam
      for (int i = threadIdx.x; i < nc; i += kThreads)
        lam[i] = __ldg(w + n0 + i) / total;
      __syncthreads();
      if (!active) continue;
      const T* p = W + static_cast<long long>(n0) * D + g * V;
      for (int n = 0; n < nc; n += kRowChunk) {
        const int m = min(kRowChunk, nc - n);
        Vec<T, V> x[kRowChunk];
#pragma unroll
        for (int r = 0; r < kRowChunk; ++r)
          if (r < m) x[r].load(p + (n + r) * D);
#pragma unroll
        for (int r = 0; r < kRowChunk; ++r) {
          if (r < m) {
            const float lr = lam[n + r];
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[v] = fmaf(lr, x[r].get(v), acc[v]);
          }
        }
      }
    }
    if (active) {
#pragma unroll
      for (int v = 0; v < V; ++v) out[g * V + v] = acc[v];
    }
  }
}

template <typename T, int V>
int launch(const void* W, const void* w, void* out, int n_rows, long long D,
           cudaStream_t stream) {
  if (D % V != 0 ||
      reinterpret_cast<uintptr_t>(W) % (sizeof(T) * V) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long need = (D / V + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  const unsigned blocks = static_cast<unsigned>(need < cap ? need : cap);
  weighted_agg<T, V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(W), static_cast<const float*>(w),
      static_cast<float*>(out), n_rows, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// W: (n_rows, D) row-major, fp32 or bf16 (w_bf16), its base aligned to
// vec elements and D a multiple of vec (vec 1, 2, 4, or 8 for bf16);
// weights: (n_rows,) fp32, raw (normalized here); out: (D,) fp32. Returns
// cudaGetLastError() after the launch on `stream`, cudaErrorInvalidValue
// for another vec, cudaErrorMisalignedAddress if W or D does not suit vec.
extern "C" int repro_weighted_agg(const void* W, int w_bf16,
                                  const void* weights, void* out, int n_rows,
                                  long long D, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_bf16) {
    switch (vec) {
      case 1:
        return launch<__nv_bfloat16, 1>(W, weights, out, n_rows, D, st);
      case 2:
        return launch<__nv_bfloat16, 2>(W, weights, out, n_rows, D, st);
      case 4:
        return launch<__nv_bfloat16, 4>(W, weights, out, n_rows, D, st);
      case 8:
        return launch<__nv_bfloat16, 8>(W, weights, out, n_rows, D, st);
    }
  } else {
    switch (vec) {
      case 1:
        return launch<float, 1>(W, weights, out, n_rows, D, st);
      case 2:
        return launch<float, 2>(W, weights, out, n_rows, D, st);
      case 4:
        return launch<float, 4>(W, weights, out, n_rows, D, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
