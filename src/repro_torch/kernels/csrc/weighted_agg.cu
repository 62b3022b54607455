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
// GEMV, with nothing for a tensor core to gain. Here each thread owns one
// column d (neighbouring threads on neighbouring d, so every row read is
// coalesced) and walks n = 0..N-1 in order in fp32: one pass over W, no
// atomics, and a fixed summation order, so the same input gives
// bit-identical gw on every run, as the protocol requires of all honest
// nodes. lam is normalized by the Python wrapper, as the TPU wrapper
// does; its N values are broadcast to the warp from the cache.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename TW>
__global__ void __launch_bounds__(kThreads)
    weighted_agg(const TW* __restrict__ W, const float* __restrict__ lam,
                 float* __restrict__ out, int n_rows, long long D) {
  const long long d = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  float acc = 0.f;
  for (int n = 0; n < n_rows; ++n) {
    acc = fmaf(__ldg(lam + n), to_f32(W[(long long)n * D + d]), acc);
  }
  out[d] = acc;
}

}  // namespace

// W: (n_rows, D) row-major, fp32 or bf16 (w_bf16); lam: (n_rows,) fp32,
// already normalized; out: (D,) fp32. Returns cudaGetLastError() after the
// launch on `stream`.
extern "C" int repro_weighted_agg(const void* W, int w_bf16, const void* lam,
                                  void* out, int n_rows, long long D,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((D + kThreads - 1) / kThreads);
  const float* l = static_cast<const float*>(lam);
  float* o = static_cast<float*>(out);
  if (w_bf16) {
    weighted_agg<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(W), l, o, n_rows, D);
  } else {
    weighted_agg<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(W), l, o, n_rows, D);
  }
  return static_cast<int>(cudaGetLastError());
}
