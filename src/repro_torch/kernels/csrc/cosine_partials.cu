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
// fp32, so its floor is (N*D + D) * sizeof(T) over HBM bandwidth.
//
// The TPU kernel carries dot_ref += ... across the D axis of its grid,
// which is sound only because a TPU grid runs in order. Hopper blocks
// run in no order, and the protocol needs every honest node to compute
// bit-identical partials (core/phases.py ModelEvaluation), so there are
// no atomics and every sum has a fixed order:
//
//   pass 1: grid (splits, N + 1). Block (s, r) reduces row r of W over
//           the s-th chunk of D (row N is gw itself, for gsq): each
//           thread walks a fixed stride of the chunk, then the block
//           folds its threads in a fixed tree, and writes one partial.
//   pass 2: one block per row folds that row's `splits` partials in a
//           fixed tree and writes dot/wsq (or gsq).
//
// `splits` depends only on D (chosen by the Python wrapper), so the same
// input gives bit-identical output on every run. gw is re-read by each
// row's blocks; at the main path's sizes it stays in the 50 MB L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Fixed-shape tree over the block: the result lands in a[0], b[0].
__device__ __forceinline__ void block_fold2(float* a, float* b, float va,
                                            float vb) {
  const int t = threadIdx.x;
  a[t] = va;
  b[t] = vb;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
      a[t] += a[t + s];
      b[t] += b[t + s];
    }
    __syncthreads();
  }
}

template <typename TW, typename TG>
__global__ void __launch_bounds__(kThreads)
    partials_pass1(const TW* __restrict__ W, const TG* __restrict__ g,
                   float* __restrict__ part_dot, float* __restrict__ part_sq,
                   int n_rows, long long D, long long chunk) {
  __shared__ float sa[kThreads];
  __shared__ float sb[kThreads];
  const int s = blockIdx.x;
  const int r = blockIdx.y;
  const long long lo = (long long)s * chunk;
  const long long hi = lo + chunk < D ? lo + chunk : D;
  float dot = 0.f, sq = 0.f;
  if (r < n_rows) {
    const TW* w = W + (long long)r * D;
    for (long long d = lo + threadIdx.x; d < hi; d += kThreads) {
      const float wv = to_f32(w[d]);
      const float gv = to_f32(g[d]);
      dot = fmaf(wv, gv, dot);
      sq = fmaf(wv, wv, sq);
    }
  } else {
    for (long long d = lo + threadIdx.x; d < hi; d += kThreads) {
      const float gv = to_f32(g[d]);
      sq = fmaf(gv, gv, sq);
    }
  }
  block_fold2(sa, sb, dot, sq);
  if (threadIdx.x == 0) {
    const long long o = (long long)r * gridDim.x + s;
    part_dot[o] = sa[0];
    part_sq[o] = sb[0];
  }
}

__global__ void __launch_bounds__(kThreads)
    partials_pass2(const float* __restrict__ part_dot,
                   const float* __restrict__ part_sq, float* __restrict__ dot,
                   float* __restrict__ wsq, float* __restrict__ gsq,
                   int n_rows, int splits) {
  __shared__ float sa[kThreads];
  __shared__ float sb[kThreads];
  const int r = blockIdx.x;
  float a = 0.f, b = 0.f;
  for (int s = threadIdx.x; s < splits; s += kThreads) {
    a += part_dot[(long long)r * splits + s];
    b += part_sq[(long long)r * splits + s];
  }
  block_fold2(sa, sb, a, b);
  if (threadIdx.x == 0) {
    if (r < n_rows) {
      dot[r] = sa[0];
      wsq[r] = sb[0];
    } else {
      gsq[0] = sb[0];
    }
  }
}

template <typename TW, typename TG>
void launch(const void* W, const void* g, float* part, float* dot, float* wsq,
            float* gsq, int n_rows, long long D, int splits,
            cudaStream_t stream) {
  const long long chunk = (D + splits - 1) / splits;
  float* part_dot = part;
  float* part_sq = part + (long long)(n_rows + 1) * splits;
  partials_pass1<TW, TG><<<dim3(splits, n_rows + 1), kThreads, 0, stream>>>(
      static_cast<const TW*>(W), static_cast<const TG*>(g), part_dot, part_sq,
      n_rows, D, chunk);
  partials_pass2<<<n_rows + 1, kThreads, 0, stream>>>(part_dot, part_sq, dot,
                                                      wsq, gsq, n_rows,
                                                      splits);
}

}  // namespace

// W: (n_rows, D) row-major, fp32 or bf16 (w_bf16); g: (D,), fp32 or bf16
// (g_bf16); part: 2 * (n_rows + 1) * splits fp32 scratch; dot, wsq:
// (n_rows,) fp32; gsq: (1,) fp32. Returns cudaGetLastError() after the
// two launches on `stream`.
extern "C" int repro_cosine_partials(const void* W, const void* g, int w_bf16,
                                     int g_bf16, void* part, void* dot,
                                     void* wsq, void* gsq, int n_rows,
                                     long long D, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* o_dot = static_cast<float*>(dot);
  float* o_wsq = static_cast<float*>(wsq);
  float* o_gsq = static_cast<float*>(gsq);
  if (w_bf16 && g_bf16) {
    launch<__nv_bfloat16, __nv_bfloat16>(W, g, p, o_dot, o_wsq, o_gsq, n_rows,
                                         D, splits, st);
  } else if (w_bf16) {
    launch<__nv_bfloat16, float>(W, g, p, o_dot, o_wsq, o_gsq, n_rows, D,
                                 splits, st);
  } else if (g_bf16) {
    launch<float, __nv_bfloat16>(W, g, p, o_dot, o_wsq, o_gsq, n_rows, D,
                                 splits, st);
  } else {
    launch<float, float>(W, g, p, o_dot, o_wsq, o_gsq, n_rows, D, splits, st);
  }
  return static_cast<int>(cudaGetLastError());
}
