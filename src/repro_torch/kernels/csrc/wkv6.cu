// WKV6 recurrence, the RWKV-6 time-mix hot spot (the forward here; the
// backward below the forward's launch code).
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
//     dr_t[i] = sum_j dO_t[j] * S_{t-1}[i,j] + u[i] k_t[i] * (dO_t . v_t)
//     dk_t[i] = sum_j e[i,j] * v_t[j],   e = dS + (u r_t) dO_t^T
//     dv_t[j] = sum_i k_t[i] * e[i,j]
//     dw_t[i] = sum_j dS[i,j] * S_{t-1}[i,j]
//     du[i]  += r_t[i] k_t[i] * (dO_t . v_t)
//     dS     <- diag(w_t) dS + r_t^T dO_t,   ds0 = the last dS
//
// (kernels/ref.py: wkv6_backward_ref, which sums dO_t[j] (S_{t-1}[i,j] +
// u[i] k_t[i] v_t[j]) over j for dr: the same terms). The reference has
// no Pallas backward: it differentiates lax.scan
// (src/repro/models/rwkv6.py:141).
//
// Column j of S and of dS evolves from its own v_j, dO_j and the rows'
// k, w, r alone, so a (b, h) is cut into NCB = K / JB column groups. Its
// NCB blocks form one thread-block cluster (cluster rank = column group):
// each keeps dS of its JB columns in registers for the whole walk, and
// what sums over all K columns -- the row sums dr, dk, dw and dO_t . v_t
// -- is added across the cluster through distributed shared memory, in
// rank order, once per 16-step chunk. So dr, dk and dw are written once,
// at their final values: there is no partial buffer in device memory and
// no fold launch for them. du sums over t in the walk's order and then
// over b, which a launch of B*H*K / 256 blocks does in order of b.
//
// S_{t-1} never comes from dividing by w (w = exp(-exp(.)) can be ~0):
// the training forward (SAVE) wrote the state before every 16-step chunk,
// and the block recomputes the chunk's states from there with the
// forward's own update (the same bits), keeping every other one in shared
// memory (lane-private, 8 x K x JB floats); the walk recomputes the one
// in between from the kept one before it (one multiply-add an entry,
// every other step).
//
// Lane (i, p) = (tid / L, tid % L) holds row i and the CT columns p*CT ..
// of the block's JB (L = 4 lanes a row, 4K threads a block). A step is CT terms in order for each row sum, then
// an xor reduce-scatter over the L lanes of the row, written to shared
// memory as this block's partial; the column sums (dv) are the warp's
// rows folded by a reduce-scatter (xor L, 2L, ..) and the warps added in
// order through shared memory, all inside the block (it holds every row
// of its columns). At the end of a chunk, after a cluster barrier, rank q
// takes rows q*K/NCB .. of every step and adds the NCB partials in rank
// order (ld.shared::cluster), then the row terms with dO_t . v_t. The
// partials are double-buffered across chunks, so one cluster barrier a
// chunk suffices. Every order is a function of K alone and no atomics are
// used: a repeat is bit-identical.
//
// Staging and overlap: r, k, w (all K rows) and v, dO (the block's JB
// columns) of a chunk arrive by cp.async into a ring of two stages; chunk
// c - 1 lands while chunk c is walked, and is recomputed between the
// cluster barrier's arrive and its wait, so the barrier's latency hides
// behind it. Within the walk the next step's operands are read before
// this step's sums. The lane's checkpoint entries for the next chunk are
// loaded into registers a chunk ahead.
//
// What bounds it: latency, not operations or bytes. The least work is
// ~11 fp32 operations a state entry and step (a bound of ~93 us at
// (8, 512, 32, 64)); by a count of this source a lane issues ~24
// instructions an entry and step (the operations, its share of the two
// reduce-scatters, the recompute, the shared-memory reads), and each
// chunk adds serial phases (the fold, the cluster barrier, du). Shared
// memory (~95 KB at K = 64: the ring 28 KB, the kept states 32 KB, the
// double-buffered partials 24 KB, the warps' dv partials 8 KB) and
// registers (128 a thread) allow two blocks, 16 warps, an SM. Timed on
// the H100 (tools/time_wkv6_backward.py), four columns a lane beat eight
// (eight warps an SM, or longer chains at K <= 32), and each of these
// was slower: the pad slot of the row fold carrying dO . v together with
// a recompute reading four steps at a time, the written arrays in static
// shared memory, dv and dk from dS with the u r dO terms added after the
// sums, and a fold whose lanes take a row's 16 steps (uncoalesced
// stores).

// JB state columns a block, CT columns a lane: four lanes a row
template <int K>
struct Bwd {
  static constexpr int JB = K >= 16 ? 16 : 8, CT = JB / 4;
};

template <int K>
struct BwdLayout {
  static constexpr int JB = Bwd<K>::JB;         // columns a block
  static constexpr int CT = Bwd<K>::CT;         // columns a lane
  static constexpr int L = JB / CT;             // lanes a row
  static constexpr int NT = K * L;              // threads a block
  static constexpr int NW = NT / 32;
  static constexpr int NCB = K / JB;            // blocks of a cluster
  static constexpr int ROWS = K / NCB;          // rows a rank folds
  static constexpr int T = 16;                  // the forward's chunk
  static constexpr int STAGE = 3 * T * K + 2 * T * JB;  // r, k, w; v, dO
  static constexpr int HIST = (T / 2) * K * JB;         // kept states
  static constexpr int PART = 3 * T * K + T;  // dr, dk, dw partials; dO.v
  static constexpr int RED = T * NW * JB;     // the warps' dv partials
  // ring, kept states, two partial buffers, dv partials, du terms, u
  static constexpr int FLOATS =
      2 * STAGE + HIST + 2 * PART + RED + T * ROWS + K;
  static constexpr int BYTES = FLOATS * 4;
  static_assert(NT % 32 == 0 && 32 % L == 0, "whole warps; a row in one");
  static_assert(L == 4, "the row fold scatters four sums, one a lane");
  static_assert(CT % 2 == 0 && K % JB == 0 && NCB <= 8, "geometry");
  static_assert(NT >= T, "a thread for each step's dO . v");
};

// xor reduce-scatter over the lanes whose ids differ in the bits FIRST,
// 2*FIRST, .. below END: while a lane holds n > 1 values it keeps half
// and sends half (the lane with the offset's bit set keeps the upper
// half), then it adds its partner's one. Returns the index of the first
// value whose full sum the lane ends with in acc[0..].
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

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the cluster barrier in two halves: every thread of every block of the
// cluster arrives, then waits; shared-memory writes before the arrive are
// visible to reads after the wait, in every block
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the address of the same shared-memory variable in cluster rank q
__device__ __forceinline__ unsigned cluster_addr(const void* p, unsigned q) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_u32(p)), "r"(q));
  return out;
}

__device__ __forceinline__ float cluster_ld(unsigned addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr)
               : "memory");
  return v;
}

// d_o through its own element strides (dsb, dss, dsh), unit over K.
// du_part: (B, H, K); dr, dk, dv, dw: (B, S, H, K); ds0, d_state:
// (B, H, K, K); ckpt as the forward's. Launched as clusters of NCB blocks
// along x: block x is column group x % NCB of (b, h) = x / NCB.
template <int K, int VEC>
__global__ void __launch_bounds__(BwdLayout<K>::NT)
    wkv6_bwd(const float* __restrict__ r, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ w,
             long long sb, long long ss, long long sh,
             const float* __restrict__ u, const float* __restrict__ ckpt,
             const float* __restrict__ d_o, long long dsb, long long dss,
             long long dsh, const float* __restrict__ d_state,
             float* __restrict__ du_part, float* __restrict__ dr,
             float* __restrict__ dk, float* __restrict__ dv,
             float* __restrict__ dw, float* __restrict__ ds0, int S,
             int H) {
  using W = BwdLayout<K>;
  constexpr int JB = W::JB, CT = W::CT, L = W::L, NT = W::NT, NW = W::NW,
                T = W::T, NCB = W::NCB, ROWS = W::ROWS;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                        // 2 x STAGE
  float* s_hist = ring + 2 * W::STAGE;       // T/2 x K x JB
  float* s_part = s_hist + W::HIST;          // 2 x PART
  float* s_red = s_part + 2 * W::PART;       // T x NW x JB
  float* s_duc = s_red + W::RED;             // T x ROWS
  float* s_u = s_duc + T * ROWS;             // K

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int i = tid / L;
  const int p = tid - i * L;
  const unsigned rank = cluster_rank();
  const int bh = blockIdx.x / NCB;
  const int j0 = static_cast<int>(rank) * JB;  // the block's first column
  const int jl = p * CT;    // the lane's first column within the block's
  const int b = bh / H;
  const int h = bh - b * H;
  const long long in0 = b * sb + h * sh;
  const long long do0 = b * dsb + h * dsh;
  const int n_chunks = (S + T - 1) / T;

  // copy chunk c (its steps that exist) into ring stage `stage`: r, k, w
  // rows of K and v, dO rows of JB, VEC floats a copy; a lane copies the
  // same pieces of every step
  constexpr int KV = K / VEC, JV = JB / VEC, PER_T = 3 * KV + 2 * JV;
  auto issue_chunk = [&](int c, int stage) {
    float* st = ring + stage * W::STAGE;
    const int t0 = c * T;
    const int n = min(T, S - t0);
    for (int q = tid; q < PER_T; q += NT) {
      const float* src;
      long long step_src;
      float* dst;
      int step;
      if (q < 3 * KV) {
        const int a = q / KV;
        const int x = (q - a * KV) * VEC;
        src = (a == 0 ? r : (a == 1 ? k : w)) + in0 + x;
        step_src = ss;
        dst = st + a * T * K + x;
        step = K;
      } else {
        const int a = (q - 3 * KV) / JV;
        const int x = (q - 3 * KV - a * JV) * VEC;
        src = (a == 0 ? v + in0 : d_o + do0) + j0 + x;
        step_src = a == 0 ? ss : dss;
        dst = st + 3 * T * K + a * T * JB + x;
        step = JB;
      }
      src += static_cast<long long>(t0) * step_src;
      for (int tt = 0; tt < n; ++tt, src += step_src, dst += step)
        cp_async<VEC * 4>(dst, src);
    }
  };

  float ds[CT], st[CT];
  load_n<CT>(d_state + (static_cast<long long>(bh) * K + i) * K + j0 + jl,
             ds);
  const float* ck = ckpt + (static_cast<long long>(bh) * n_chunks * K + i) *
                               K + j0 + jl;
  load_n<CT>(ck + static_cast<long long>(n_chunks - 1) * K * K, st);
  for (int x = tid; x < K; x += NT) s_u[x] = u[h * K + x];
  const float ui = u[h * K + i];
  float du = 0.f;  // of row rank * ROWS + tid (tid < ROWS), over t

  // the chunk's states forward from its checkpoint st, with the forward
  // kernel's update (the same bits); the state before every even step is
  // kept. Then st takes the next chunk's checkpoint (loaded early).
  auto recompute = [&](int c, int stage) {
    const float* ckk = ring + stage * W::STAGE + T * K;
    const float* cw = ckk + T * K;
    const float* cv = cw + T * K;
    const int n = min(T, S - c * T);
#pragma unroll 2
    for (int tt = 0; tt < n; ++tt) {
      if ((tt & 1) == 0)
        store_n<CT>(s_hist + ((tt >> 1) * K + i) * JB + jl, st);
      const float wi = cw[tt * K + i], ki = ckk[tt * K + i];
      float vv[CT];
      load_n<CT>(cv + tt * JB + jl, vv);
#pragma unroll
      for (int q = 0; q < CT; ++q) st[q] = fmaf(wi, st[q], ki * vv[q]);
    }
    if (c > 0) load_n<CT>(ck + static_cast<long long>(c - 1) * K * K, st);
  };

  // chunk n_chunks - 1 into stage 0, then n_chunks - 2 into stage 1 while
  // the first is recomputed; chunk c is in stage (n_chunks - 1 - c) & 1
  issue_chunk(n_chunks - 1, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (n_chunks > 1) issue_chunk(n_chunks - 2, 1);
  cp_async_commit();
  recompute(n_chunks - 1, 0);

  for (int kc = 0; kc < n_chunks; ++kc) {
    const int c = n_chunks - 1 - kc;
    const int t0 = c * T;
    const int n = min(T, S - t0);
    const int stage = kc & 1;
    const float* cr = ring + stage * W::STAGE;
    const float* ckk = cr + T * K;
    const float* cw = ckk + T * K;
    const float* cv = cw + T * K;
    const float* cdo = cv + T * JB;
    // dr, dk, dw partials (3 x T x K), then dO . v (T); the other buffer
    // is the one the cluster may still be reading (chunk c + 1)
    float* part = s_part + stage * W::PART;

    // this block's dO_t . v_t over its JB columns, in order
    if (tid < n) {
      float d = 0.f;
#pragma unroll
      for (int x = 0; x < JB; ++x)
        d = fmaf(cdo[tid * JB + x], cv[tid * JB + x], d);
      part[3 * T * K + tid] = d;
    }

    // the walk, t downward; the next step's operands are read before
    // this step's sums. An odd step's state comes from the kept state of
    // the even step before it (the next step) by one update.
    float ri, ki, wi, vv[CT], dd[CT], kept[CT];
    auto load_step = [&](int tt, float& r_, float& k_, float& w_,
                         float (&v_)[CT], float (&d_)[CT],
                         float (&h_)[CT]) {
      r_ = cr[tt * K + i];
      k_ = ckk[tt * K + i];
      w_ = cw[tt * K + i];
      load_n<CT>(cv + tt * JB + jl, v_);
      load_n<CT>(cdo + tt * JB + jl, d_);
      if ((tt & 1) == 0) load_n<CT>(s_hist + ((tt >> 1) * K + i) * JB + jl, h_);
    };
    load_step(n - 1, ri, ki, wi, vv, dd, kept);
#pragma unroll 2
    for (int tt = n - 1; tt >= 0; --tt) {
      float nr = 0.f, nk = 0.f, nw = 0.f, nv[CT], nd[CT], nh[CT];
      if (tt > 0) load_step(tt - 1, nr, nk, nw, nv, nd, nh);
      float prev[CT];
#pragma unroll
      for (int q = 0; q < CT; ++q)
        prev[q] = (tt & 1) ? fmaf(nw, nh[q], nk * nv[q]) : kept[q];
      float rows[4] = {0.f, 0.f, 0.f, 0.f};  // dr, dk, dw, (none)
      float dvc[CT];
#pragma unroll
      for (int q = 0; q < CT; ++q) {
        const float rd = ri * dd[q];
        const float e = fmaf(ui, rd, ds[q]);
        rows[0] = fmaf(dd[q], prev[q], rows[0]);
        rows[1] = fmaf(e, vv[q], rows[1]);
        rows[2] = fmaf(ds[q], prev[q], rows[2]);
        dvc[q] = ki * e;
        ds[q] = fmaf(wi, ds[q], rd);
      }
      const int which = xor_scatter<1, L, 4>(rows, lane);
      if (which < 3) part[(which * T + tt) * K + i] = rows[0];
      const int col = xor_scatter<L, 32, CT>(dvc, lane);
      if (((lane / L) & ~(CT - 1)) == 0)
        s_red[(tt * NW + warp) * JB + jl + col] = dvc[0];
      ri = nr;
      ki = nk;
      wi = nw;
#pragma unroll
      for (int q = 0; q < CT; ++q) {
        vv[q] = nv[q];
        dd[q] = nd[q];
        kept[q] = nh[q];
      }
    }
    // this block's partials of the chunk are in place; the next chunk is
    // recomputed while the other blocks get there
    cluster_arrive();
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
    if (c > 0) {
      cp_async_wait<0>();   // chunk c - 1 has landed
      __syncthreads();      // and dv has read s_red
      recompute(c - 1, stage ^ 1);
    }
    cluster_wait();
    // this rank's rows: the NCB partials in rank order, then the row terms
    for (int e = tid; e < n * ROWS; e += NT) {
      const int tt = e / ROWS, il = e - tt * ROWS;
      const int ii = static_cast<int>(rank) * ROWS + il;
      float sums[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float* src = a < 3 ? part + (a * T + tt) * K + ii
                                 : part + 3 * T * K + tt;
        float acc = cluster_ld(cluster_addr(src, 0));
#pragma unroll
        for (int q = 1; q < NCB; ++q)
          acc += cluster_ld(cluster_addr(src, static_cast<unsigned>(q)));
        sums[a] = acc;
      }
      const float rri = cr[tt * K + ii], kki = ckk[tt * K + ii];
      const long long at =
          ((static_cast<long long>(b) * S + t0 + tt) * H + h) * K + ii;
      dr[at] = fmaf(s_u[ii] * kki, sums[3], sums[0]);
      dk[at] = sums[1];
      dw[at] = sums[2];
      s_duc[tt * ROWS + il] = rri * kki * sums[3];
    }
    __syncthreads();
    if (tid < ROWS) {
#pragma unroll
      for (int tt = T - 1; tt >= 0; --tt)
        if (tt < n) du += s_duc[tt * ROWS + tid];
    }
    // chunk c - 2 into the stage chunk c was read from
    if (c > 1) issue_chunk(c - 2, stage);
    cp_async_commit();
  }
  // no block leaves while another reads its partials
  cp_async_wait<0>();
  cluster_arrive();
  cluster_wait();

  store_n<CT>(ds0 + (static_cast<long long>(bh) * K + i) * K + j0 + jl, ds);
  if (tid < ROWS)
    du_part[static_cast<long long>(bh) * K + rank * ROWS + tid] = du;
}

// du: the (b, h) sums added in order of b
__global__ void wkv6_bwd_du(const float* __restrict__ du_part,
                            float* __restrict__ du, int B, int HK) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= HK) return;
  float acc = du_part[x];
  for (int bb = 1; bb < B; ++bb)
    acc += du_part[static_cast<long long>(bb) * HK + x];
  du[x] = acc;
}

template <int K, int VEC>
int launch_bwd(const float* r, const float* k, const float* v, const float* w,
               long long sb, long long ss, long long sh, const float* u,
               const float* ckpt, const float* d_o, long long dsb,
               long long dss, long long dsh, const float* d_state,
               float* du_part, float* dr, float* dk, float* dv, float* dw,
               float* du, float* ds0, int B, int S, int H, cudaStream_t st) {
  using W = BwdLayout<K>;
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(configured & bit)) {
    e = cudaFuncSetAttribute(wkv6_bwd<K, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             W::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured |= bit;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * H * W::NCB);
  cfg.blockDim = dim3(W::NT);
  cfg.dynamicSmemBytes = W::BYTES;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = W::NCB;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, wkv6_bwd<K, VEC>, r, k, v, w, sb, ss, sh, u,
                         ckpt, d_o, dsb, dss, dsh, d_state, du_part, dr, dk,
                         dv, dw, ds0, S, H);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int hk = H * K;
  wkv6_bwd_du<<<(hk + 255) / 256, 256, 0, st>>>(du_part, du, B, hk);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int dispatch_bwd(const float* r, const float* k, const float* v,
                 const float* w, long long sb, long long ss, long long sh,
                 const float* u, const float* ckpt, const float* d_o,
                 long long dsb, long long dss, long long dsh,
                 const float* d_state, float* du_part, float* dr, float* dk,
                 float* dv, float* dw, float* du, float* ds0, int B, int S,
                 int H, int vec, int jb, int ct, cudaStream_t st) {
  if (jb != Bwd<K>::JB || ct != Bwd<K>::CT)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (vec == 4)
    return launch_bwd<K, 4>(r, k, v, w, sb, ss, sh, u, ckpt, d_o, dsb, dss,
                            dsh, d_state, du_part, dr, dk, dv, dw, du, ds0,
                            B, S, H, st);
  if (vec == 1)
    return launch_bwd<K, 1>(r, k, v, w, sb, ss, sh, u, ckpt, d_o, dsb, dss,
                            dsh, d_state, du_part, dr, dk, dv, dw, du, ds0,
                            B, S, H, st);
  return static_cast<int>(cudaErrorInvalidValue);
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
// fp32 contiguous and 16-byte aligned (zeros where the final state has no
// gradient). Writes dr, dk, dv, dw (B, S, H, K), du (H, K) and ds0
// (B, H, K, K), all fp32 contiguous; du_part (B, H, K) is scratch. With
// vec = 4 every base and used stride of r, k, v, w and d_o is a multiple
// of 16 bytes (vec = 1: any). (jb, ct) must be the kernel's column group
// and lane width for K. Two launches (the walk, in clusters of K / jb
// blocks, then du's ordered fold over b); returns cudaGetLastError() after
// each, cudaErrorInvalidValue for another K or vec,
// cudaErrorInvalidConfiguration for another geometry.
extern "C" int repro_wkv6_backward(
    const void* r, const void* k, const void* v, const void* w, long long sb,
    long long ss, long long sh, const void* u, const void* ckpt,
    const void* d_o, long long dsb, long long dss, long long dsh,
    const void* d_state, void* du_part, void* dr, void* dk, void* dv,
    void* dw, void* du, void* ds0, int B, int S, int H, int K, int vec,
    int jb, int ct, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_ARGS                                                          \
  static_cast<const float*>(r), static_cast<const float*>(k),              \
      static_cast<const float*>(v), static_cast<const float*>(w), sb, ss,  \
      sh, static_cast<const float*>(u), static_cast<const float*>(ckpt),   \
      static_cast<const float*>(d_o), dsb, dss, dsh,                       \
      static_cast<const float*>(d_state), static_cast<float*>(du_part),    \
      static_cast<float*>(dr), static_cast<float*>(dk),                    \
      static_cast<float*>(dv), static_cast<float*>(dw),                    \
      static_cast<float*>(du), static_cast<float*>(ds0), B, S, H, vec, jb, \
      ct, st
  switch (K) {
    case 8:
      return dispatch_bwd<8>(REPRO_ARGS);
    case 16:
      return dispatch_bwd<16>(REPRO_ARGS);
    case 32:
      return dispatch_bwd<32>(REPRO_ARGS);
    case 64:
      return dispatch_bwd<64>(REPRO_ARGS);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_ARGS
}
