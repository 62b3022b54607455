// Flash attention forward: blocked online softmax with GQA, causal,
// sliding-window and ragged-edge masks.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// _flash_kernel (pallas_call at :88, wrapper flash_attention; GQA wrapper
// ops.flash_attention). Per (b, query head hq) with kv head hq / G:
//
//     s[i,j] = (q_i . k_j) / sqrt(hd)   in fp32, -1e30 where masked
//     o_i    = sum_j softmax_j(s[i,:]) v_j
//
// keys masked by k < S, causality (q >= k) and the window (q - k < window),
// the softmax kept online (running max m, sum l, fp32 accumulator acc) and
// o = acc / max(l, 1e-30) written in the inputs' dtype.
//
// What bounds it: at the served model's shapes (hd = 128, bf16) the card
// could do the 4*hd operations of each unmasked (q, k) pair on its tensor
// cores at 989 TFLOP/s and move q, k, v and o once at 3.35 TB/s; at
// (8, 512, Hq 32, Hk 4) causal that is 22.5 us of bytes against 17.4 us
// of operations, so bytes. This first version does the arithmetic in fp32
// on CUDA cores (67 TFLOP/s at most), so it sits well above that bound;
// wgmma, TMA and warp specialisation are a later change.
//
// The TPU kernel walks the KV tiles as the innermost sequential grid axis
// and carries (m, l, acc) in VMEM scratch between grid steps; its wrapper
// transposes to (B*H, S, hd), repeats each KV head G times and pads S.
// Hopper blocks run in no order and carry nothing, so here one block owns
// one (b, hq, 64-query tile) and loops over the KV tiles in order itself.
// Tiles wholly above the diagonal or wholly outside the window are
// skipped: with the finite -1e30 mask such a tile only adds terms that the
// first valid key multiplies by exp(-1e30 - m) = 0, so the skip is exact.
// q, k, v are read in their (B, S, H, hd) layout through strides and the kv
// head is hq / G: no transpose, no repeat, no padding. The ragged last tile
// is masked here and its missing rows are filled with zeros, so every
// value in shared memory is finite.
//
// Layout of a block: 128 threads; thread t owns query rows t/16 + 8r
// (r = 0..7) and, for them, score columns t%16 + 16c of the 32-key tile
// and hd/16 output dims (out_dim below). The 16 threads of a row
// group are one half-warp, so row max and row sum are xor-shuffles inside
// it, and the probabilities a half-warp writes to shared memory are read
// back only by itself (a __syncwarp, not a barrier). The q tile (fp32,
// converted once) stays in shared memory for the whole KV loop; each K/V
// tile is converted to fp32 on its way in. Shared memory at hd = 128 is
// 76,288 bytes (dynamic, opted in above 48 KB): two blocks an SM.
// Every sum runs in a fixed order and no atomics are used, so a repeat on
// the same input is bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;    // query rows of a block
constexpr int BK = 32;    // keys of a tile
constexpr int NT = 128;   // threads of a block
constexpr int RPT = BQ / 8;   // rows a thread owns
constexpr int CPT = BK / 16;  // score columns a thread owns
constexpr int PP = BK + 4;    // padded row of the probability tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The output dim of a thread's i-th accumulator. At hd >= 64 a thread
// owns runs of 4 dims 64 apart (ln*4 + 64*(i/4) + i%4), so the 8 threads
// of one 16-byte load phase read 32 different banks of a V row; below
// that it owns hd/16 dims in a row (2-byte strides, no conflict).
template <int HD>
__device__ __forceinline__ int out_dim(int ln, int i) {
  if constexpr (HD >= 64)
    return (i / 4) * 64 + ln * 4 + i % 4;
  else
    return ln * (HD / 16) + i;
}

template <int HD>
constexpr int smem_floats() {
  // q tile and k tile rows padded by 4 floats (16-byte loads without bank
  // conflicts), v tile unpadded, probability tile padded
  return BQ * (HD + 4) + BK * (HD + 4) + BK * HD + BQ * PP;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, long long qsb,
              long long qss, long long qsh, long long ksb, long long kss,
              long long ksh, long long vsb, long long vss, long long vsh,
              int S, int Hq, int Hk, int causal, int window, float scale) {
  constexpr int QP = HD + 4;
  constexpr int DPT = HD / 16;  // output dims a thread owns
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // BQ x QP
  float* sk = sq + BQ * QP;                     // BK x QP
  float* sv = sk + BK * QP;                     // BK x HD
  float* sp = sv + BK * HD;                     // BQ x PP

  const int tid = threadIdx.x;
  const int rg = tid >> 4;
  const int ln = tid & 15;
  const int q0 = blockIdx.x * BQ;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hq / (Hq / Hk);

  const T* qb = q + b * qsb + hq * qsh;
  for (int idx = tid; idx < BQ * HD; idx += NT) {
    const int r = idx / HD, d = idx - r * HD;
    const int pos = q0 + r;
    sq[r * QP + d] = pos < S ? to_f(qb[pos * qss + d]) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[r][i] = 0.f;
  }

  // the KV tiles that hold at least one unmasked key for this query tile
  const int q_last = min(q0 + BQ, S) - 1;
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;  // the oldest key any row may see
    kt_begin = lo > 0 ? lo / BK : 0;
  }
  const int k_end = causal ? q_last + 1 : S;
  const int kt_end = (k_end + BK - 1) / BK;

  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < BK * HD; idx += NT) {
      const int r = idx / HD, d = idx - r * HD;
      const int pos = k0 + r;
      const bool in = pos < S;
      sk[r * QP + d] = in ? to_f(kb[pos * kss + d]) : 0.f;
      sv[r * HD + d] = in ? to_f(vb[pos * vss + d]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 kv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        kv[c] = *reinterpret_cast<const float4*>(&sk[(ln + 16 * c) * QP + d]);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&sq[(rg + 8 * r) * QP + d]);
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          s[r][c] = fmaf(qv.x, kv[c].x, s[r][c]);
          s[r][c] = fmaf(qv.y, kv[c].y, s[r][c]);
          s[r][c] = fmaf(qv.z, kv[c].z, s[r][c]);
          s[r][c] = fmaf(qv.w, kv[c].w, s[r][c]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int qpos = q0 + rg + 8 * r;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int kpos = k0 + ln + 16 * c;
        bool ok = kpos < S;
        if (causal) ok = ok && qpos >= kpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        s[r][c] = ok ? s[r][c] * scale : NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float p = expf(s[r][c] - m_new);
        sp[(rg + 8 * r) * PP + ln + 16 * c] = p;
        psum += p;
      }
      // a butterfly: both lanes of every pair add the same two values, so
      // all 16 lanes end with the same bits
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[r] = corr * l[r] + psum;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[r][i] *= corr;
    }
    __syncwarp();  // the half-warp's probabilities are in sp

#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pv[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        pv[r] = *reinterpret_cast<const float4*>(&sp[(rg + 8 * r) * PP + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = &sv[(j + jj) * HD];
        float vv[DPT];
        if constexpr (DPT % 4 == 0) {
#pragma unroll
          for (int i = 0; i < DPT; i += 4) {
            const float4 t =
                *reinterpret_cast<const float4*>(vrow + out_dim<HD>(ln, i));
            vv[i] = t.x;
            vv[i + 1] = t.y;
            vv[i + 2] = t.z;
            vv[i + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < DPT; ++i) vv[i] = vrow[out_dim<HD>(ln, i)];
        }
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float p = jj == 0   ? pv[r].x
                          : jj == 1 ? pv[r].y
                          : jj == 2 ? pv[r].z
                                    : pv[r].w;
#pragma unroll
          for (int i = 0; i < DPT; ++i) acc[r][i] = fmaf(p, vv[i], acc[r][i]);
        }
      }
    }
  }

  // o is contiguous (B, S, Hq, hd)
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int qpos = q0 + rg + 8 * r;
    if (qpos >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * S + qpos) * Hq + hq) * HD;
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      orow[out_dim<HD>(ln, i)] = from_f<T>(acc[r][i] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int B, int S, int Hq, int Hk, int causal,
           int window, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * 4;
  // the shared-memory opt-in, once per kernel and device
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[dev]) {
    e = cudaFuncSetAttribute(flash_fwd<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in[dev] = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  flash_fwd<T, HD><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], S, Hq, Hk, causal, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o,
                const long long* st, int B, int S, int Hq, int Hk, int hd,
                int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, st, B, S, Hq, Hk, causal, window,
                           stream);
    case 32:
      return launch<T, 32>(q, k, v, o, st, B, S, Hq, Hk, causal, window,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, st, B, S, Hq, Hk, causal, window,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, st, B, S, Hq, Hk, causal, window,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (B, S, Hq, hd); k, v: (B, S, Hk, hd), Hq a multiple of Hk, each read
// through its element strides (batch, sequence, head) with a unit stride
// over hd; o: (B, S, Hq, hd) contiguous. dtype 0 is fp32, 1 bf16; hd is 16,
// 32, 64 or 128; window 0 means none. Returns cudaGetLastError() after the
// launch on `stream`, or cudaErrorInvalidValue for another dtype or hd.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int B, int S, int Hq, int Hk,
    int hd, int causal, int window, int dtype, void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, o, st, B, S, Hq, Hk, hd, causal,
                              window, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, st, B, S, Hq, Hk, hd,
                                      causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
