// WKV6 recurrence, the RWKV-6 time-mix hot spot (forward only).
//
// Replaces the TPU kernel src/repro/kernels/wkv6.py: _wkv6_kernel
// (pallas_call at :75, wrapper wkv6; ops.wkv6_recurrence). Per batch b
// and head h, with a K x K fp32 state S (row = key channel i, column =
// value channel j):
//
//     o_t[j]   = sum_i r_t[i] * (S[i,j] + u[i] * k_t[i] * v_t[j])
//              = sum_i r_t[i] * S[i,j] + v_t[j] * a_t,
//                a_t = sum_i r_t[i] * u[i] * k_t[i]
//     S[i,j]  <- w_t[i] * S[i,j] + k_t[i] * v_t[j]
//
// What bounds it: bytes, closely followed by fp32 issue. At decode (S = 1)
// the state read from s0 and written back (2 * B*H*K*K*4 bytes) dwarfs r,
// k, v, w and o. Over a long sequence r, k, v, w and o (20 bytes per
// (b, t, h, channel)) and the 5*K^2 operations per (b, h, t) (one
// multiply-add for o, a multiply and a multiply-add for S) come out about
// even on the H100: at K = 64 that is 320 operations against 20 bytes a
// channel, 16 a byte, under the card's fp32 ridge of about 20.
//
// The TPU kernel keeps S in VMEM across an in-kernel fori_loop over a
// chunk of t and across chunks through the sequential grid axis. Hopper
// blocks run in no order and carry nothing between them, so a block loops
// over every t itself. The design:
//
// * Columns across blocks. Column j of S evolves from k, w and v_j alone
//   and o_t[j] needs only column j, so a (b, h) may be cut into K / JC
//   column groups that never communicate: B*H*(K/JC) blocks, each reading
//   r, k and w of its (b, h) whole and v for its JC columns. At K = 64 one
//   block takes all 64 columns (JC = 64): with JC = 32 the two blocks of a
//   (b, h) copy r, k, w twice, and that measured slower.
// * Rows across lanes, a tile of state a thread. Thread (cl, g) =
//   threadIdx.x / G, % G holds rows g*R .. g*R + R-1 (R = K / G) of the C
//   columns j0 + cl*C .. + C-1 in registers for the whole sequence. Every
//   value a lane reads from shared memory (r, k, w of its R rows, v of its
//   C columns) serves C (or R) state entries: with one column a thread
//   (C = 1) shared-memory reads, not arithmetic, set the pace (three reads
//   per three operations; shared memory serves 32 lanes a cycle, fp32
//   128). Each step a lane sums its R terms of o per column in order, then
//   the G adjacent lanes of a column group fold with a fixed xor tree,
//   offsets 1, 2, 4, ..: while a lane still holds more than one column it
//   sends half of them and keeps half (a reduce-scatter, log2 shuffles
//   fewer than folding every column), after that it adds its partner's
//   one. Every column ends with the same tree of sums; the loop-carried
//   chain is one fmaf per state entry a step.
// * The bonus term once per step: a_t is folded per chunk with the same
//   tree (R terms in order, then the xor offsets) into shared memory, and
//   o_t[j] = fmaf(v_t[j], a_t, folded sum).
// * A staged time chunk. r, k, w (all K channels) and v (the block's JC
//   columns) of T steps are copied into shared memory with cp.async (16
//   bytes a copy where the wrapper finds every address 16-byte aligned, 4
//   otherwise) into a ring of STAGES chunks: the next chunks' copies are in
//   flight while this one computes. Every chunk commits one copy group,
//   empty past the end, so the wait count is the same at the ragged last
//   chunk, which is masked by its step count and never padded. A lane
//   copies the same pieces of every step (consecutive lanes, consecutive
//   16 bytes of a row), so issuing a chunk is a copy and two adds a piece
//   (computing each piece's addresses anew cost a large share of the
//   kernel's time). Within a chunk the next step's operands are read
//   before this step's sums, and step t's fold is issued after step
//   t + 1's products.
// * o staged per chunk in shared memory and written back as JC contiguous
//   floats per step, with 16-byte stores.
// * The state is read from s0 and written to s_out straight from the
//   registers: for each of its rows a lane moves its C contiguous columns
//   (16-byte accesses), the s0 loads issued before the first chunk is
//   waited for.
// * Decode (S = 1) runs wkv6_step, a specialisation with the same order
//   of sums and no staging, whose lane map moves the state in rows of 32
//   contiguous floats a warp (below); one step through wkv6_fwd measured
//   slower than the earlier one-column-a-thread kernel.
// * r, k, w rows in shared memory have 4 floats of padding after every 32,
//   so the 16-byte reads of row groups g and g + 4 fall on distinct banks.
//
// Deterministic, no atomics: the order of every sum (R, G, C, the fold
// tree, where a_t is added) is a function of K alone (Geo<K> below), never
// of B, H, S or the card, so the same input gives bit-identical o and S on
// every run and for every batch it sits in.
//
// Why CUDA cores and not tensor cores: the chunked matrix form divides by
// products of decays, and the model's w = exp(-exp(.)) comes arbitrarily
// close to 0, so those products underflow; and TF32 cannot meet the
// rtol 1e-5 / atol 1e-4 held against the plain version.
//
// Budget (K = 64): two warps a block, 8 x 8 state entries a lane (64
// registers of state, at most 255 in all); 55,872 bytes of shared memory
// a block (3 stages x 16 steps x (3 x 68 + 64) floats, 16 x 64 of o, 16
// of a_t, 64 of u), so the 256 blocks of (B, H) = (8, 32) fit on 132 SMs
// at once, two an SM. A lane's tile being the unit of work, that is four
// warps an SM, one per scheduler: the step loop is unrolled by four so
// the scheduler finds independent work across steps.

#include <cuda_runtime.h>

namespace {

// Launch geometry, a function of K alone; kernels/wkv6.py: launch_shape
// mirrors it and passes it back, and a mismatch refuses the launch.
template <int K>
struct Geo;
template <>
struct Geo<64> {
  static constexpr int JC = 64, G = 8, C = 8, T = 16, STAGES = 3;
};
template <>
struct Geo<32> {
  static constexpr int JC = 32, G = 4, C = 4, T = 16, STAGES = 2;
};
template <>
struct Geo<16> {
  static constexpr int JC = 16, G = 4, C = 2, T = 16, STAGES = 2;
};
template <>
struct Geo<8> {
  static constexpr int JC = 8, G = 4, C = 1, T = 16, STAGES = 2;
};

template <int K>
struct Layout {
  static constexpr int JC = Geo<K>::JC, G = Geo<K>::G, C = Geo<K>::C,
                       T = Geo<K>::T, STAGES = Geo<K>::STAGES;
  static constexpr int R = K / G, NCL = JC / C, NT = NCL * G, NCG = K / JC;
  static constexpr int ROW = K + ((K - 1) >> 5) * 4;  // padded r/k/w row
  static constexpr int STAGE = T * (3 * ROW + JC);    // floats a stage
  // ring, o (T x JC), a_t (T), u (K)
  static constexpr int FLOATS = STAGES * STAGE + T * JC + T + K;
  static constexpr int BYTES = FLOATS * 4;
  static_assert(K % G == 0 && K % JC == 0 && JC % C == 0, "geometry");
  static_assert(NT % 32 == 0 && 32 % G == 0, "whole warps; a column group "
                                             "in one warp");
  static_assert((R % 4 == 0 || R == 2) && 32 % R == 0,
                "rows read 8 or 16 bytes at a time, inside 32-float runs");
  static_assert(C == 1 || C == 2 || C % 4 == 0, "column loads");
  static_assert(STAGES >= 2, "ring");
};

// shared-memory index of channel i in an r/k/w row: 4 floats of padding
// after every 32
__device__ __forceinline__ constexpr int pidx(int i) { return i + (i >> 5) * 4; }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(BYTES)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N consecutive floats at p (16-, 8- or 4-byte aligned to suit N), with
// the widest accesses that fit
template <int N>
__device__ __forceinline__ void load_n(const float* p, float* out) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(p)[q];
      out[4 * q] = x.x;
      out[4 * q + 1] = x.y;
      out[4 * q + 2] = x.z;
      out[4 * q + 3] = x.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const float2 x = reinterpret_cast<const float2*>(p)[q];
      out[2 * q] = x.x;
      out[2 * q + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) out[q] = p[q];
  }
}

template <int N>
__device__ __forceinline__ void store_n(float* p, const float* in) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(in[4 * q], in[4 * q + 1], in[4 * q + 2], in[4 * q + 3]);
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N / 2; ++q)
      reinterpret_cast<float2*>(p)[q] = make_float2(in[2 * q], in[2 * q + 1]);
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) p[q] = in[q];
  }
}

// The G lanes of a column group fold their C partial sums with the xor
// tree, offsets 1, 2, 4, ..; each add is (own + partner's). While a lane
// holds n > 1 columns it keeps half and sends half; the lane with the
// offset's bit set keeps the upper half. Afterwards the lane holds the
// full sums of its columns [col, col + max(1, C / G)) in acc[0..].
template <int G, int C>
__device__ __forceinline__ int fold_scatter(float (&acc)[C], int g) {
  int col = 0;
#pragma unroll
  for (int l = 0, off = 1; off < G; ++l, off <<= 1) {
    const int n = C >> l;  // columns held before this level
    if (n > 1) {
      const bool upper = g & off;
#pragma unroll
      for (int i = 0; i < n / 2; ++i) {
        const float send = upper ? acc[i] : acc[i + n / 2];
        const float keep = upper ? acc[i + n / 2] : acc[i];
        acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
      if (upper) col += n / 2;
    } else {
      acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], off);
    }
  }
  return col;
}

// SAVE (training) also writes the state before every chunk, the lane's
// tile of it, to ckpt (B*H, n_chunks, K, K): the backward recomputes the
// states inside a chunk from there. The serving launch is SAVE = false.
template <int K, int VEC, bool SAVE>
__global__ void __launch_bounds__(Layout<K>::NT)
    wkv6_fwd(const float* __restrict__ r, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ w,
             long long sb, long long ss, long long sh,
             const float* __restrict__ u, const float* __restrict__ s0,
             float* __restrict__ o, float* __restrict__ s_out,
             float* __restrict__ ckpt, int S, int H) {
  using L = Layout<K>;
  constexpr int JC = L::JC, G = L::G, C = L::C, T = L::T,
                STAGES = L::STAGES, R = L::R, NT = L::NT, ROW = L::ROW;
  constexpr int CF = C >= G ? C / G : 1;  // columns a lane ends a fold with
  // a lane whose g has a bit set above the split levels holds a copy
  constexpr int SPLIT_MASK = (C >= G ? G : C) - 1;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* s_o = ring + STAGES * L::STAGE;  // T x JC
  float* s_a = s_o + T * JC;              // T
  float* s_u = s_a + T;                   // K

  const int tid = threadIdx.x;
  const int cl = tid / G;
  const int g = tid - cl * G;
  const int bh = blockIdx.x / L::NCG;
  const int j0 = (blockIdx.x - bh * L::NCG) * JC;
  const int b = bh / H;
  const int h = bh - b * H;
  const long long in0 = b * sb + h * sh;
  const int n_chunks = (S + T - 1) / T;
  const int row0 = g * R;
  const int col0 = cl * C;  // the lane's first column within the block's

  // copy chunk c (its steps that exist) into its ring stage. A step's
  // r, k, w rows and v columns are PER_T pieces of VEC floats; a lane
  // copies the same pieces q = tid, tid + NT, .. of every step, so
  // consecutive lanes copy consecutive pieces of a row
  constexpr int KV = K / VEC, PER_T = 3 * KV + JC / VEC;
  auto issue_chunk = [&](int c) {
    float* st = ring + (c % STAGES) * L::STAGE;
    const int t0 = c * T;
    const int n = min(T, S - t0);
#pragma unroll
    for (int q = tid; q < PER_T; q += NT) {
      const float* src;
      float* dst;
      int step;
      if (q < 3 * KV) {
        const int a = q / KV;
        const int i = (q - a * KV) * VEC;
        src = (a == 0 ? r : (a == 1 ? k : w)) + in0 + i;
        dst = st + a * T * ROW + pidx(i);
        step = ROW;
      } else {
        const int jv = (q - 3 * KV) * VEC;
        src = v + in0 + j0 + jv;
        dst = st + 3 * T * ROW + jv;
        step = JC;
      }
      src += static_cast<long long>(t0) * ss;
      for (int tt = 0; tt < n; ++tt, src += ss, dst += step)
        cp_async<VEC * 4>(dst, src);
    }
  };

  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < n_chunks) issue_chunk(c);
    cp_async_commit();
  }
  // the lane's R x C tile of s0, C contiguous floats a row
  float st[R][C];
  const float* s0p = s0 + (static_cast<long long>(bh) * K + row0) * K + j0 +
                     col0;
#pragma unroll
  for (int m = 0; m < R; ++m) load_n<C>(s0p + m * K, st[m]);
  for (int i = tid; i < K; i += NT) s_u[i] = u[h * K + i];

  for (int c = 0; c < n_chunks; ++c) {
    if constexpr (SAVE) {
      float* cp = ckpt +
                  ((static_cast<long long>(bh) * n_chunks + c) * K + row0) * K +
                  j0 + col0;
#pragma unroll
      for (int m = 0; m < R; ++m) store_n<C>(cp + m * K, st[m]);
    }
    // groups committed so far: STAGES - 1 + c; chunk c's is complete
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // the stage of chunk c - 1 is free: every thread passed the barrier
    if (c + STAGES - 1 < n_chunks) issue_chunk(c + STAGES - 1);
    cp_async_commit();

    const float* cr = ring + (c % STAGES) * L::STAGE;
    const float* ck = cr + T * ROW;
    const float* cw = ck + T * ROW;
    const float* cv = cw + T * ROW;
    const int n = min(T, S - c * T);

    // a_t for the chunk's steps: column lanes cl take steps cl, cl + NCL,
    // .. (the trip count is the same in every lane, for the shuffles)
#pragma unroll
    for (int t_base = 0; t_base < T; t_base += L::NCL) {
      const int tt = t_base + cl;
      float a = 0.f;
      if (tt < n) {
        float rr[R], kk[R];
        load_n<R>(cr + tt * ROW + pidx(row0), rr);
        load_n<R>(ck + tt * ROW + pidx(row0), kk);
#pragma unroll
        for (int m = 0; m < R; ++m) a = fmaf(rr[m] * s_u[row0 + m], kk[m], a);
      }
#pragma unroll
      for (int off = 1; off < G; off <<= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      if (g == 0 && tt < n) s_a[tt] = a;
    }
    __syncthreads();

    // step tt's products, then step tt - 1's fold (its shuffles overlap
    // the products); o_t is written by the lanes that hold its columns
    auto fold_out = [&](float (&acc)[C], int tt) {
      const int col = col0 + fold_scatter<G, C>(acc, g);
      if (C >= G || (g & ~SPLIT_MASK) == 0) {
        const float at = s_a[tt];
#pragma unroll
        for (int i = 0; i < CF; ++i)
          s_o[tt * JC + col + i] = fmaf(cv[tt * JC + col + i], at, acc[i]);
      }
    };
    float rr[R], kk[R], ww[R], vv[C], prev[C];
    load_n<R>(cr + pidx(row0), rr);
    load_n<R>(ck + pidx(row0), kk);
    load_n<R>(cw + pidx(row0), ww);
    load_n<C>(cv + col0, vv);
#pragma unroll 4
    for (int tt = 0; tt < n; ++tt) {
      // the next step's operands, read before this step's sums
      float nr[R], nk[R], nw[R], nv[C];
      const int tn = tt + 1 < n ? tt + 1 : tt;
      load_n<R>(cr + tn * ROW + pidx(row0), nr);
      load_n<R>(ck + tn * ROW + pidx(row0), nk);
      load_n<R>(cw + tn * ROW + pidx(row0), nw);
      load_n<C>(cv + tn * JC + col0, nv);

      float acc[C];
#pragma unroll
      for (int j = 0; j < C; ++j) acc[j] = 0.f;
#pragma unroll
      for (int m = 0; m < R; ++m) {
#pragma unroll
        for (int j = 0; j < C; ++j) {
          acc[j] = fmaf(rr[m], st[m][j], acc[j]);
          st[m][j] = fmaf(ww[m], st[m][j], kk[m] * vv[j]);
        }
      }
      if (tt > 0) fold_out(prev, tt - 1);
#pragma unroll
      for (int j = 0; j < C; ++j) prev[j] = acc[j];
#pragma unroll
      for (int m = 0; m < R; ++m) {
        rr[m] = nr[m];
        kk[m] = nk[m];
        ww[m] = nw[m];
      }
#pragma unroll
      for (int j = 0; j < C; ++j) vv[j] = nv[j];
    }
    fold_out(prev, n - 1);
    __syncthreads();

    // o of the chunk: JC contiguous floats per step, 16 bytes a store
    float* op = o + ((static_cast<long long>(b) * S + c * T) * H + h) * K + j0;
    for (int e = tid; e < n * (JC / 4); e += NT) {
      const int tt = e / (JC / 4);
      const int q = e - tt * (JC / 4);
      *reinterpret_cast<float4*>(op + static_cast<long long>(tt) * H * K +
                                 4 * q) =
          *reinterpret_cast<const float4*>(s_o + tt * JC + 4 * q);
    }
  }
  cp_async_wait<0>();

  float* sop = s_out + (static_cast<long long>(bh) * K + row0) * K + j0 +
               col0;
#pragma unroll
  for (int m = 0; m < R; ++m) store_n<C>(sop + m * K, st[m]);
}

// One step (S = 1, decode), with the same order of sums as wkv6_fwd: the
// R rows of a row group summed in order, the G groups folded with the
// same pairwise tree (here through shared memory), a_1 the same way, and
// o = fmaf(v, a, sum). Only the state's bytes are many here, so the lane
// map is the one that moves them best: block (b, h) has G warps' worth of
// lanes per column, lane (g, j) = (tid / K, tid % K) holds rows
// g*R .. g*R + R-1 of column j, and a warp reads and writes rows of 32
// consecutive floats. r, k, w of a row group are the same for all its
// lanes (one broadcast load each).
template <int K, int VEC>
__global__ void __launch_bounds__(K * Geo<K>::G)
    wkv6_step(const float* __restrict__ r, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ w,
              long long sb, long long sh, const float* __restrict__ u,
              const float* __restrict__ s0, float* __restrict__ o,
              float* __restrict__ s_out, int H) {
  constexpr int G = Geo<K>::G, R = K / G;
  __shared__ float s_p[G][K];
  __shared__ float s_a[G];
  const int tid = threadIdx.x;
  const int g = tid / K;
  const int j = tid - g * K;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const long long in0 = b * sb + h * sh;
  const int row0 = g * R;

  float st[R], rr[R], kk[R], ww[R];
  const float* s0p = s0 + (static_cast<long long>(bh) * K + row0) * K + j;
#pragma unroll
  for (int m = 0; m < R; ++m) st[m] = s0p[m * K];
  if constexpr (VEC == 4) {
    load_n<R>(r + in0 + row0, rr);
    load_n<R>(k + in0 + row0, kk);
    load_n<R>(w + in0 + row0, ww);
  } else {
#pragma unroll
    for (int m = 0; m < R; ++m) {
      rr[m] = r[in0 + row0 + m];
      kk[m] = k[in0 + row0 + m];
      ww[m] = w[in0 + row0 + m];
    }
  }
  const float vj = v[in0 + j];

  float a = 0.f, acc = 0.f;
#pragma unroll
  for (int m = 0; m < R; ++m) {
    a = fmaf(rr[m] * u[h * K + row0 + m], kk[m], a);
    acc = fmaf(rr[m], st[m], acc);
    st[m] = fmaf(ww[m], st[m], kk[m] * vj);
  }
  s_p[g][j] = acc;
  if (j == 0) s_a[g] = a;
  float* sop = s_out + (static_cast<long long>(bh) * K + row0) * K + j;
#pragma unroll
  for (int m = 0; m < R; ++m) sop[m * K] = st[m];
  __syncthreads();
  if (g == 0) {
    float p[G], q[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      p[i] = s_p[i][j];
      q[i] = s_a[i];
    }
    // pair (i, i + off) at offsets 1, 2, 4, ..: the xor tree's sums
#pragma unroll
    for (int off = 1; off < G; off <<= 1) {
#pragma unroll
      for (int i = 0; i < G; i += 2 * off) {
        p[i] = p[i] + p[i + off];
        q[i] = q[i] + q[i + off];
      }
    }
    o[(static_cast<long long>(b) * H + h) * K + j] = fmaf(vj, q[0], p[0]);
  }
}

template <int K, int VEC>
int launch(const float* r, const float* k, const float* v, const float* w,
           long long sb, long long ss, long long sh, const float* u,
           const float* s0, float* o, float* s_out, float* ckpt, int B, int S,
           int H, cudaStream_t st) {
  using L = Layout<K>;
  // the shared-memory attribute is set once per kernel and device
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(configured & bit)) {
    e = cudaFuncSetAttribute(wkv6_fwd<K, VEC, false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(wkv6_fwd<K, VEC, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured |= bit;
  }
  const unsigned blocks = static_cast<unsigned>(B) * H * L::NCG;
  if (ckpt != nullptr) {
    // training: the chunked kernel at every S, saving its chunk states
    wkv6_fwd<K, VEC, true><<<blocks, L::NT, L::BYTES, st>>>(
        r, k, v, w, sb, ss, sh, u, s0, o, s_out, ckpt, S, H);
  } else if (S == 1) {
    wkv6_step<K, VEC><<<static_cast<unsigned>(B) * H, K * L::G, 0, st>>>(
        r, k, v, w, sb, sh, u, s0, o, s_out, H);
  } else {
    wkv6_fwd<K, VEC, false><<<blocks, L::NT, L::BYTES, st>>>(
        r, k, v, w, sb, ss, sh, u, s0, o, s_out, nullptr, S, H);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int dispatch(const float* r, const float* k, const float* v, const float* w,
             long long sb, long long ss, long long sh, const float* u,
             const float* s0, float* o, float* s_out, float* ckpt, int B,
             int S, int H, int vec, const int* geo, cudaStream_t st) {
  using L = Layout<K>;
  if (geo[0] != L::JC || geo[1] != L::G || geo[2] != L::C || geo[3] != L::T ||
      geo[4] != L::STAGES)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (vec == 4)
    return launch<K, 4>(r, k, v, w, sb, ss, sh, u, s0, o, s_out, ckpt, B, S,
                        H, st);
  if (vec == 1)
    return launch<K, 1>(r, k, v, w, sb, ss, sh, u, s0, o, s_out, ckpt, B, S,
                        H, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------
// Backward (training). Given dO and dS_T, with S_{t-1} the state before
// step t and dS the gradient of the state after it, walking t downward:
//
//     dr_t[i] = sum_j dO_t[j] * (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])
//     dk_t[i] = sum_j e[i,j] * v_t[j],   e = dS + (u r_t) dO_t^T
//     dv_t[j] = sum_i k_t[i] * e[i,j]
//     dw_t[i] = sum_j dS[i,j] * S_{t-1}[i,j]
//     du[i]  += r_t[i] k_t[i] * sum_j dO_t[j] v_t[j]
//     dS     <- diag(w_t) dS + r_t^T dO_t,   ds0 = the last dS
//
// (kernels/ref.py: wkv6_backward_ref). The reference has no Pallas
// backward: it differentiates lax.scan (src/repro/models/rwkv6.py:141).
//
// Column j of S and of dS evolves from its own v_j, dO_j and the rows'
// k, w, r alone, so a block takes one (b, h) and a group of JB columns,
// as the forward takes JC: B*H*(K/JB) blocks, dS of its columns in
// registers for the whole walk. S_{t-1} never comes from dividing by w
// (w = exp(-exp(.)) can be ~0): the forward (SAVE) wrote the state before
// every 16-step chunk, and the block recomputes the chunk's 16 states from
// there, forward, into shared memory (each lane reads back only its own
// entries), then walks the chunk downward.
//
// Lane (i, p) = (tid / L, tid % L) holds row i, columns p*CT .. +CT of
// the block's. Row sums (dr, dk, dw and sum_j dO v over the block's
// columns) are CT terms in order, then a reduce-scatter over the L lanes
// of the row: each of the four ends in one lane. Column sums (dv) are the
// warp's rows folded by a reduce-scatter (xor L, 2L, ..), then the warps
// in order through shared memory. What sums over all K columns (dr, dk,
// dw, du) leaves a block as a partial of its JB columns; wkv6_bwd_fold
// adds the K/JB partials in order, and du's over b too. Every order is a
// function of K alone and no atomics are used: a repeat is bit-identical.
//
// What bounds it: like the forward, bytes and fp32 issue (~12 operations
// a state entry and step: the recomputed update, e, four products into
// the sums, the dS update). Shared memory at K = 64: the chunk's 16
// states of 64 x 16 (64 KB) plus its inputs and staged outputs, ~100 KB:
// two blocks an SM.

template <int K>
struct Bwd {
  static constexpr int JB = K >= 16 ? 16 : 8;  // columns a block
  static constexpr int CT = K >= 16 ? 4 : 2;   // columns a lane
  static constexpr int L = JB / CT;            // lanes a row
  static constexpr int NT = K * L;             // threads a block
  static constexpr int NW = NT / 32;
  static constexpr int NCB = K / JB;           // column groups of a (b, h)
  static constexpr int T = 16;                 // the forward's chunk
  // staged r, k, w (T x K), v, dO (T x JB); the chunk's states (T x K x
  // JB); the warps' dv partials (T x NW x JB); dr, dk, dw out (3 x T x K)
  static constexpr int FLOATS =
      3 * T * K + 2 * T * JB + T * K * JB + T * NW * JB + 3 * T * K;
  static constexpr int BYTES = FLOATS * 4;
  static_assert(L == 4, "the row fold scatters four sums over four lanes");
  static_assert(NT % 32 == 0, "whole warps");
};

// xor reduce-scatter over the lanes whose ids differ in the bits FIRST,
// 2*FIRST, .. below END: while a lane holds n > 1 values it keeps half
// and sends half (the lane with the offset's bit set keeps the upper
// half), then it adds its partner's one. Returns the index of the value
// whose full sum the lane ends with in acc[0].
template <int FIRST, int END, int N>
__device__ __forceinline__ int xor_scatter(float (&acc)[N], int lane) {
  int idx = 0;
#pragma unroll
  for (int l = 0, off = FIRST; off < END; ++l, off <<= 1) {
    const int n = N >> l;
    if (n > 1) {
      const bool upper = lane & off;
#pragma unroll
      for (int i = 0; i < n / 2; ++i) {
        const float send = upper ? acc[i] : acc[i + n / 2];
        const float keep = upper ? acc[i + n / 2] : acc[i];
        acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
      if (upper) idx += n / 2;
    } else {
      acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], off);
    }
  }
  return idx;
}

// d_o through its own element strides (dsb, dss, dsh), unit over K.
// part: (3, NCB, B, S, H, K) partial dr, dk, dw; du_part: (B, H, NCB, K);
// dv: (B, S, H, K); ds0, d_state: (B, H, K, K); ckpt as the forward's.
template <int K>
__global__ void __launch_bounds__(Bwd<K>::NT)
    wkv6_bwd(const float* __restrict__ r, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ w,
             long long sb, long long ss, long long sh,
             const float* __restrict__ u, const float* __restrict__ ckpt,
             const float* __restrict__ d_o, long long dsb, long long dss,
             long long dsh, const float* __restrict__ d_state,
             float* __restrict__ part, float* __restrict__ du_part,
             float* __restrict__ dv, float* __restrict__ ds0, int B, int S,
             int H) {
  using W = Bwd<K>;
  constexpr int JB = W::JB, CT = W::CT, L = W::L, NT = W::NT, NW = W::NW,
                T = W::T, NCB = W::NCB;
  extern __shared__ __align__(16) float smem[];
  float* s_r = smem;              // T x K
  float* s_k = s_r + T * K;
  float* s_w = s_k + T * K;
  float* s_v = s_w + T * K;       // T x JB
  float* s_do = s_v + T * JB;     // T x JB
  float* s_hist = s_do + T * JB;  // T x K x JB
  float* s_red = s_hist + T * K * JB;  // T x NW x JB
  float* s_out = s_red + T * NW * JB;  // 3 x T x K

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int i = tid / L;
  const int p = tid - i * L;
  const int bh = blockIdx.x / NCB;
  const int cg = blockIdx.x - bh * NCB;
  const int j0 = cg * JB;     // the block's first column
  const int jl = p * CT;      // the lane's first column within the block's
  const int b = bh / H;
  const int h = bh - b * H;
  const long long in0 = b * sb + h * sh;
  const long long do0 = b * dsb + h * dsh;
  const int n_chunks = (S + T - 1) / T;
  const long long n_out = static_cast<long long>(B) * S * H * K;

  float ds[CT];
  const float* dsp = d_state + (static_cast<long long>(bh) * K + i) * K +
                     j0 + jl;
#pragma unroll
  for (int q = 0; q < CT; ++q) ds[q] = dsp[q];
  const float ui = u[h * K + i];
  float du = 0.f;  // r k (dO . v) over t, in the lane that holds dO . v

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * T;
    const int n = min(T, S - t0);
    __syncthreads();  // the previous chunk's staged data is consumed
    for (int e = tid; e < n * K; e += NT) {
      const int tt = e / K, x = e - tt * K;
      const long long g = in0 + static_cast<long long>(t0 + tt) * ss + x;
      s_r[e] = r[g];
      s_k[e] = k[g];
      s_w[e] = w[g];
    }
    for (int e = tid; e < n * JB; e += NT) {
      const int tt = e / JB, x = e - tt * JB;
      s_v[e] = v[in0 + static_cast<long long>(t0 + tt) * ss + j0 + x];
      s_do[e] = d_o[do0 + static_cast<long long>(t0 + tt) * dss + j0 + x];
    }
    float st[CT];
    const float* cp = ckpt +
                      ((static_cast<long long>(bh) * n_chunks + c) * K + i) *
                          K + j0 + jl;
#pragma unroll
    for (int q = 0; q < CT; ++q) st[q] = cp[q];
    __syncthreads();

    // the chunk's states, forward, with the forward kernel's update; a
    // lane's CT columns move as one 8- or 16-byte access
#pragma unroll 2
    for (int tt = 0; tt < n; ++tt) {
      const float wi = s_w[tt * K + i], ki = s_k[tt * K + i];
      float vv[CT];
      load_n<CT>(s_v + tt * JB + jl, vv);
      store_n<CT>(s_hist + (tt * K + i) * JB + jl, st);
#pragma unroll
      for (int q = 0; q < CT; ++q) st[q] = fmaf(wi, st[q], ki * vv[q]);
    }

#pragma unroll 2
    for (int tt = n - 1; tt >= 0; --tt) {
      const float ri = s_r[tt * K + i], ki = s_k[tt * K + i],
                  wi = s_w[tt * K + i];
      const float ur = ui * ri, uk = ui * ki;
      float hist[CT], vv[CT], dd[CT];
      load_n<CT>(s_hist + (tt * K + i) * JB + jl, hist);
      load_n<CT>(s_v + tt * JB + jl, vv);
      load_n<CT>(s_do + tt * JB + jl, dd);
      float rows[4] = {0.f, 0.f, 0.f, 0.f};  // dr, dk, dw, dO . v
      float dvc[CT];
#pragma unroll
      for (int q = 0; q < CT; ++q) {
        const float prev = hist[q], vj = vv[q], dj = dd[q];
        const float e = fmaf(ur, dj, ds[q]);
        rows[0] = fmaf(dj, fmaf(uk, vj, prev), rows[0]);
        rows[1] = fmaf(e, vj, rows[1]);
        rows[2] = fmaf(ds[q], prev, rows[2]);
        rows[3] = fmaf(dj, vj, rows[3]);
        dvc[q] = ki * e;
        ds[q] = fmaf(wi, ds[q], ri * dj);
      }
      const int which = xor_scatter<1, L, 4>(rows, lane);
      if (which < 3)
        s_out[(which * T + tt) * K + i] = rows[0];
      else
        du = fmaf(ri * ki, rows[0], du);
      const int col = xor_scatter<L, 32, CT>(dvc, lane);
      if (((lane / L) & ~(CT - 1)) == 0)
        s_red[(tt * NW + warp) * JB + jl + col] = dvc[0];
    }
    __syncthreads();

    // dv of the chunk: the warps' partials in order
    for (int e = tid; e < n * JB; e += NT) {
      const int tt = e / JB, x = e - tt * JB;
      float acc = s_red[(tt * NW) * JB + x];
#pragma unroll
      for (int q = 1; q < NW; ++q) acc += s_red[(tt * NW + q) * JB + x];
      dv[((static_cast<long long>(b) * S + t0 + tt) * H + h) * K + j0 + x] =
          acc;
    }
    // dr, dk, dw partials of this column group
    for (int e = tid; e < 3 * n * K; e += NT) {
      const int which = e / (n * K);
      const int rest = e - which * n * K;
      const int tt = rest / K, x = rest - tt * K;
      part[(which * NCB + cg) * n_out +
           ((static_cast<long long>(b) * S + t0 + tt) * H + h) * K + x] =
          s_out[(which * T + tt) * K + x];
    }
  }

  float* dsq = ds0 + (static_cast<long long>(bh) * K + i) * K + j0 + jl;
#pragma unroll
  for (int q = 0; q < CT; ++q) dsq[q] = ds[q];
  // the lane that ended with dO . v holds this column group's du[i]
  if (p == L - 1) du_part[(static_cast<long long>(bh) * NCB + cg) * K + i] = du;
}

// dr, dk, dw: the NCB column groups' partials added in order; du: the
// (b, column group) partials added in order of b, then group.
template <int K>
__global__ void wkv6_bwd_fold(const float* __restrict__ part,
                              const float* __restrict__ du_part,
                              float* __restrict__ dr, float* __restrict__ dk,
                              float* __restrict__ dw, float* __restrict__ du,
                              long long n_out, int B, int H) {
  constexpr int NCB = Bwd<K>::NCB;
  const long long x = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (x < n_out) {
    float* outs[3] = {dr, dk, dw};
#pragma unroll
    for (int which = 0; which < 3; ++which) {
      const float* pp = part + which * NCB * n_out + x;
      float acc = pp[0];
#pragma unroll
      for (int q = 1; q < NCB; ++q) acc += pp[q * n_out];
      outs[which][x] = acc;
    }
  }
  if (x < static_cast<long long>(H) * K) {
    const int h = static_cast<int>(x / K), i = static_cast<int>(x % K);
    float acc = 0.f;
    for (int bb = 0; bb < B; ++bb)
#pragma unroll
      for (int q = 0; q < NCB; ++q)
        acc += du_part[((static_cast<long long>(bb) * H + h) * NCB + q) * K + i];
    du[x] = acc;
  }
}

template <int K>
int launch_bwd(const float* r, const float* k, const float* v, const float* w,
               long long sb, long long ss, long long sh, const float* u,
               const float* ckpt, const float* d_o, long long dsb,
               long long dss, long long dsh, const float* d_state,
               float* part, float* du_part, float* dr, float* dk, float* dv,
               float* dw, float* du, float* ds0, int B, int S, int H, int jb,
               cudaStream_t st) {
  using W = Bwd<K>;
  if (jb != W::JB) return static_cast<int>(cudaErrorInvalidConfiguration);
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(configured & bit)) {
    e = cudaFuncSetAttribute(wkv6_bwd<K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             W::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured |= bit;
  }
  wkv6_bwd<K><<<static_cast<unsigned>(B) * H * W::NCB, W::NT, W::BYTES,
                 st>>>(r, k, v, w, sb, ss, sh, u, ckpt, d_o, dsb, dss, dsh,
                       d_state, part, du_part, dv, ds0, B, S, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n_out = static_cast<long long>(B) * S * H * K;
  const long long n = n_out > static_cast<long long>(H) * K
                          ? n_out
                          : static_cast<long long>(H) * K;
  wkv6_bwd_fold<K><<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      part, du_part, dr, dk, dw, du, n_out, B, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, w: (B, S, H, K) fp32 sharing the element strides (sb, ss, sh)
// and a unit stride over K; with vec = 4 their bases and strides are
// multiples of 16 bytes (vec = 1: any). u: (H, K) fp32 contiguous; s0,
// s_out: (B, H, K, K) fp32 contiguous, 16-byte aligned; o: (B, S, H, K)
// fp32 contiguous, 16-byte aligned. ckpt: null (serving), or (B, H,
// ceil(S / 16), K, K) fp32 contiguous, which then receives the state
// before every 16-step chunk (training; the chunked kernel runs at every
// S). K is 8, 16, 32 or 64; (jc, g, c, t, stages) must be the kernel's
// geometry for K. Returns cudaGetLastError() after the launch on
// `stream`, cudaErrorInvalidValue for another K or vec,
// cudaErrorInvalidConfiguration for another geometry.
extern "C" int repro_wkv6(const void* r, const void* k, const void* v,
                          const void* w, long long sb, long long ss,
                          long long sh, const void* u, const void* s0,
                          void* o, void* s_out, void* ckpt, int B, int S,
                          int H, int K, int vec, int jc, int g, int c, int t,
                          int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* rp = static_cast<const float*>(r);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* wp = static_cast<const float*>(w);
  const float* up = static_cast<const float*>(u);
  const float* s0p = static_cast<const float*>(s0);
  float* op = static_cast<float*>(o);
  float* sp = static_cast<float*>(s_out);
  float* cp = static_cast<float*>(ckpt);
  const int geo[5] = {jc, g, c, t, stages};
  switch (K) {
    case 8:
      return dispatch<8>(rp, kp, vp, wp, sb, ss, sh, up, s0p, op, sp, cp, B,
                         S, H, vec, geo, st);
    case 16:
      return dispatch<16>(rp, kp, vp, wp, sb, ss, sh, up, s0p, op, sp, cp, B,
                          S, H, vec, geo, st);
    case 32:
      return dispatch<32>(rp, kp, vp, wp, sb, ss, sh, up, s0p, op, sp, cp, B,
                          S, H, vec, geo, st);
    case 64:
      return dispatch<64>(rp, kp, vp, wp, sb, ss, sh, up, s0p, op, sp, cp, B,
                          S, H, vec, geo, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward of repro_wkv6 (training): r, k, v, w, u as given to it,
// ckpt as it wrote it; d_o (B, S, H, K) fp32 read through its element
// strides (dsb, dss, dsh) with a unit stride over K; d_state (B, H, K, K)
// fp32 contiguous (zeros where the final state has no gradient). Writes
// dr, dk, dv, dw (B, S, H, K), du (H, K) and ds0 (B, H, K, K), all fp32
// contiguous; part (3, K / jb, B, S, H, K) and du_part (B, H, K / jb, K)
// are scratch. jb must be the kernel's column group for K. Two launches
// (the walk, then the ordered fold); returns cudaGetLastError() after
// each, cudaErrorInvalidValue for another K.
extern "C" int repro_wkv6_backward(
    const void* r, const void* k, const void* v, const void* w, long long sb,
    long long ss, long long sh, const void* u, const void* ckpt,
    const void* d_o, long long dsb, long long dss, long long dsh,
    const void* d_state, void* part, void* du_part, void* dr, void* dk,
    void* dv, void* dw, void* du, void* ds0, int B, int S, int H, int K,
    int jb, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_ARGS                                                          \
  static_cast<const float*>(r), static_cast<const float*>(k),              \
      static_cast<const float*>(v), static_cast<const float*>(w), sb, ss,  \
      sh, static_cast<const float*>(u), static_cast<const float*>(ckpt),   \
      static_cast<const float*>(d_o), dsb, dss, dsh,                       \
      static_cast<const float*>(d_state), static_cast<float*>(part),       \
      static_cast<float*>(du_part), static_cast<float*>(dr),               \
      static_cast<float*>(dk), static_cast<float*>(dv),                    \
      static_cast<float*>(dw), static_cast<float*>(du),                    \
      static_cast<float*>(ds0), B, S, H, jb, st
  switch (K) {
    case 8:
      return launch_bwd<8>(REPRO_ARGS);
    case 16:
      return launch_bwd<16>(REPRO_ARGS);
    case 32:
      return launch_bwd<32>(REPRO_ARGS);
    case 64:
      return launch_bwd<64>(REPRO_ARGS);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_ARGS
}
