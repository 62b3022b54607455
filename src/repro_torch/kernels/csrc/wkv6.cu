// WKV6 recurrence, the RWKV-6 time-mix hot spot (forward only).
//
// Replaces the TPU kernel src/repro/kernels/wkv6.py: _wkv6_kernel
// (pallas_call at :75, wrapper wkv6; ops.wkv6_recurrence). Per batch b
// and head h, with a K x K fp32 state S (row = key channel i, column =
// value channel j):
//
//     o_t[j]   = sum_i r_t[i] * (S[i,j] + u[i] * k_t[i] * v_t[j])
//     S[i,j]  <- w_t[i] * S[i,j] + k_t[i] * v_t[j]
//
// What bounds it: bytes. At decode (S = 1) the state read from s0 and
// written back (2 * B*H*K*K*4 bytes) dwarfs r, k, v, w and o. Over a long
// sequence r, k, v, w and o (5 * 4 bytes per (b, t, h, channel)) outweigh
// the 5*K^2 fp32 operations per (b, h, t) the function needs (one
// multiply-add for o, since the bonus term is a scalar per step times
// v_t, and three for the state update): at K = 64 that is 320
// operations against 20 bytes per channel, 16 a byte, under the card's
// fp32 rate of about 20 a byte (67 TFLOP/s over 3.35 TB/s). What keeps this kernel from the bound is that the recurrence is
// sequential in t: each step is a chain of K dependent multiply-adds.
//
// The TPU kernel keeps the state in VMEM across an in-kernel fori_loop
// over a chunk of t, and across chunks through the sequential minor grid
// axis. Hopper blocks run in no order and carry nothing between them, so
// here one block owns one (b, h) and loops over every t itself; there is
// no chunking, no padding of S and no w = 1 trick. The block has K
// threads, and thread j keeps column j of S in K registers for the whole
// sequence, so the state touches device memory twice: read from s0, and
// written to s_out at the end. Each step the block stages r_t, k_t and
// w_t in shared memory (double-buffered, so one barrier a step; thread j
// already has v_t[j] in a register), and thread j sums over i in a fixed
// order. No atomics: the same input gives bit-identical o and S.
// r, k, v, w are read in their (B, S, H, K) layout through strides, so
// the caller needs neither the transpose nor the pad of the TPU wrapper;
// o is written in (B, S, H, K). The next step's four values are loaded
// into registers before the current step's sums, to hide their latency.
//
// With B*H blocks of K threads (256 blocks of 64 at the model's shapes)
// the card holds two warps a block and the loop is latency-bound; this
// is the simple version, not yet a fast one.

#include <cuda_runtime.h>

namespace {

template <int K>
__global__ void __launch_bounds__(K)
    wkv6_fwd(const float* __restrict__ r, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ w,
             long long sb, long long ss, long long sh,
             const float* __restrict__ u, const float* __restrict__ s0,
             float* __restrict__ o, float* __restrict__ s_out, int S,
             int H) {
  __shared__ float sr[2][K], sk[2][K], sw[2][K], su[K];
  const int j = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const long long in0 = b * sb + h * sh + j;
  // o is contiguous (B, S, H, K)
  const long long out0 = ((long long)b * S * H + h) * K + j;
  const long long out_step = (long long)H * K;

  su[j] = u[h * K + j];
  float st[K];
  const float* s0p = s0 + (long long)bh * K * K;
#pragma unroll
  for (int i = 0; i < K; ++i) st[i] = s0p[i * K + j];

  float nr = r[in0], nk = k[in0], nv = v[in0], nw = w[in0];
  for (int t = 0; t < S; ++t) {
    const int buf = t & 1;
    sr[buf][j] = nr;
    sk[buf][j] = nk;
    sw[buf][j] = nw;
    const float vj = nv;
    if (t + 1 < S) {
      const long long off = in0 + (t + 1) * ss;
      nr = r[off];
      nk = k[off];
      nv = v[off];
      nw = w[off];
    }
    // one barrier a step: buffer buf is written again at step t + 2, after
    // every thread has passed the barrier of step t + 1 and so has finished
    // reading it at step t
    __syncthreads();
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float kv = sk[buf][i] * vj;
      acc = fmaf(sr[buf][i], fmaf(su[i], kv, st[i]), acc);
      st[i] = fmaf(sw[buf][i], st[i], kv);
    }
    o[out0 + t * out_step] = acc;
  }

  float* sop = s_out + (long long)bh * K * K;
#pragma unroll
  for (int i = 0; i < K; ++i) sop[i * K + j] = st[i];
}

template <int K>
void launch(const float* r, const float* k, const float* v, const float* w,
            long long sb, long long ss, long long sh, const float* u,
            const float* s0, float* o, float* s_out, int B, int S, int H,
            cudaStream_t st) {
  wkv6_fwd<K><<<static_cast<unsigned>(B) * H, K, 0, st>>>(
      r, k, v, w, sb, ss, sh, u, s0, o, s_out, S, H);
}

}  // namespace

// r, k, v, w: (B, S, H, K) fp32 sharing the element strides (sb, ss, sh)
// and a unit stride over K; u: (H, K) fp32 contiguous; s0, s_out:
// (B, H, K, K) fp32 contiguous; o: (B, S, H, K) fp32 contiguous.
// K is 8, 16, 32 or 64. Returns cudaGetLastError() after the launch on
// `stream`, or cudaErrorInvalidValue for another K.
extern "C" int repro_wkv6(const void* r, const void* k, const void* v,
                          const void* w, long long sb, long long ss,
                          long long sh, const void* u, const void* s0,
                          void* o, void* s_out, int B, int S, int H, int K,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* rp = static_cast<const float*>(r);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* wp = static_cast<const float*>(w);
  const float* up = static_cast<const float*>(u);
  const float* s0p = static_cast<const float*>(s0);
  float* op = static_cast<float*>(o);
  float* sp = static_cast<float*>(s_out);
  switch (K) {
    case 8:
      launch<8>(rp, kp, vp, wp, sb, ss, sh, up, s0p, op, sp, B, S, H, st);
      break;
    case 16:
      launch<16>(rp, kp, vp, wp, sb, ss, sh, up, s0p, op, sp, B, S, H, st);
      break;
    case 32:
      launch<32>(rp, kp, vp, wp, sb, ss, sh, up, s0p, op, sp, B, S, H, st);
      break;
    case 64:
      launch<64>(rp, kp, vp, wp, sb, ss, sh, up, s0p, op, sp, B, S, H, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
