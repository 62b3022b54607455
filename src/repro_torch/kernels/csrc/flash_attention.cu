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
// keys masked by k < Skv, causality (q >= k) and the window (q - k < window),
// the softmax kept online (running max m, sum l, fp32 accumulator acc) and
// o = acc / max(l, 1e-30) written in the inputs' dtype. The forward takes
// Skv keys of its own (cross-attention: Sq tokens to Skv context keys,
// positions of both from 0, as the reference's blockwise_attention has
// it), unmasked but for k < Skv; causal and window runs have Skv = Sq.
// The tensor maps of k and v have extent Skv, so TMA zero-fills a tile's
// rows past it, and the grid and the o and L stores run over Sq.
//
// What bounds it: at the served model's shapes (hd = 128, bf16) the card
// could do the 4*hd operations of each unmasked (q, k) pair on its tensor
// cores at 989 TFLOP/s and move q, k, v and o once at 3.35 TB/s; at
// (8, 512, Hq 32, Hk 4) causal that is 22.5 us of bytes against 17.4 us
// of operations, so bytes. In fp32 there is no tensor-core path that
// keeps fp32 products, so fp32 is bound by operations at 67 TFLOP/s.
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
// head is hq / G: no transpose, no repeat, no padding. Every sum runs in a
// fixed order and no atomics are used, so a repeat on the same input is
// bit-identical. There are two kernels:
//
// bf16: flash_fwd_tc, on the tensor cores. A warpgroup (128 threads)
// owns a 64-query tile of one (b, hq) and walks 64-key tiles; a block has
// two warpgroups for two query heads of one kv group where G is even (one
// otherwise), so each K/V tile it brings serves both. At (8, 512, Hq 32,
// Hk 4) that halves what the blocks read from L2 (~180 MB instead of
// ~330 MB), and two such blocks fit an SM.
//  - S = Q.K^T is wgmma m64n64k16 (bf16 operands, fp32 accumulators in
//    registers), both operands read from shared memory, K-major; the q tile
//    stays in shared memory for the whole KV loop. 1/sqrt(hd) (times
//    log2 e, so the exponentials are exp2) is applied to the fp32 scores;
//    off the edge tiles it is folded into the fma of the exponent.
//  - The online softmax runs on the accumulator fragment: a thread holds
//    two rows (lane/4 and lane/4 + 8 of its warp's 16), each shared by the
//    four lanes of a quad, so row max and row sum are xor-shuffles over 1
//    and 2 -- a butterfly, so the four lanes end with the same bits. Only
//    tiles that cross S, the diagonal or the window edge are masked.
//  - O += P.V is wgmma m64n{hd}k16 with P as the A operand from registers:
//    the accumulator fragment of S is laid out as the A fragment of
//    m64nNk16, so the fp32 pairs (8j + 2r, 8j + 2r + 1) pack into bf16x2
//    register r of key slice j with no shuffle. l sums the fp32 p. V is
//    the B operand, read MN-major (its rows are keys, hd contiguous) with
//    the transpose bit that 16-bit wgmma allows.
//  - K/V tiles come by TMA (cp.async.bulk.tensor) into a ring of two
//    stages, completion counted in bytes on an mbarrier per stage; thread 0
//    starts the copy of tile j + 1 before tile j's two products, so the
//    copy overlaps them. TMA rather than cp.async: it writes the 128-byte
//    swizzled layout that wgmma reads without a bank conflict, zero-fills
//    rows past S (the ragged tail) by itself, costs the threads no
//    registers or address arithmetic, and needs no proxy fence before
//    wgmma (both are async-proxy operations). The tensor maps are encoded
//    per call from the (B, S, H, hd) strides (cuTensorMapEncodeTiled,
//    reached through cudaGetDriverEntryPoint, so nothing links libcuda)
//    and passed as __grid_constant__ parameters. TMA needs 16-byte aligned
//    bases and strides; the wrapper refuses anything else.
//  - A tile row of hd bf16 is split into sub-tiles of min(hd, 64) columns
//    (2 at hd = 128), each swizzled over its row width (128, 64 or 32
//    bytes): the canonical wgmma layouts, one 8-row atom per 8 rows.
//  - hd = 112 (Zamba2-7B) runs the hd-128 kernel on tensor maps whose hd
//    extent is 112: the second 64-column box of a row reads columns
//    64-111 and TMA fills 112-127 with zeros, so both products run at
//    128, the zeros add nothing to Q.K^T and give 16 zero columns of O,
//    which are not stored. The scale stays 1/sqrt(112). This spends 1/8
//    of the MMA work on zeros; seven 16-column sub-tiles under the 32-byte
//    swizzle (no padding, P.V as m64n112k16) measured slower on the H100.
//  - Shared memory at hd = 128: 2 q tiles 32 KB + 2 stages x (K + V)
//    64 KB = 97 KB with the barriers and alignment; 127 registers a thread,
//    no spills: two blocks (four warpgroups) an SM. On the H100 a third
//    stage (one block an SM), four heads a block, or issuing the next
//    Q.K^T before this P.V has finished (141 registers) were all slower.
//  - What holds it back: each warpgroup runs Q.K^T, the softmax and P.V
//    one after the other, so the tensor cores wait while it does the
//    softmax; only the other warpgroups of the SM fill that gap. A
//    producer warp with the softmax overlapping P.V (as FlashAttention-3
//    does) needs more registers than four warpgroups an SM leave, and at
//    one block of two consumer warpgroups an SM it was slower here.

// fp32: flash_fwd_f32, on CUDA cores. 128 threads; thread t owns query
// rows t/16 + 8r (r = 0..7) and, for them, score columns t%16 + 16c of
// the 32-key tile and hd/16 output dims (out_dim below). The 16 threads
// of a row group are one half-warp, so row max and row sum are
// xor-shuffles inside it, and the probabilities a half-warp writes to
// shared memory are read back only by itself (a __syncwarp, not a
// barrier). The q tile stays in shared memory
// for the whole KV loop; the ragged last tile is masked and its missing
// rows are filled with zeros, so every value in shared memory is finite.
// Shared memory at hd = 128 is 76,288 bytes (dynamic, opted in above
// 48 KB): two blocks an SM.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NT = 128;   // threads of a block (one warpgroup)

// ---------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------

constexpr int TQ = 64;    // query rows of a warpgroup
constexpr int TK = 64;    // keys of a tile
// stages of the K/V ring: tile j + KV_STAGES - 1 is on its way while tile
// j is computed
constexpr int KV_STAGES = 2;

template <int HD>
struct Tc {
  static constexpr int SW = HD * 2 < 128 ? HD * 2 : 128;  // swizzle bytes
  static constexpr int COLS = SW / 2;      // columns of a sub-tile
  static constexpr int NSUB = HD / COLS;   // sub-tiles of a row
  static constexpr int SUB = 64 * SW;      // bytes of a 64-row sub-tile
  static constexpr int TILE = 64 * HD * 2; // bytes of a 64-row tile
  // wgmma descriptor layout: 1 = 128-byte swizzle, 2 = 64, 3 = 32
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  // NWG q tiles, then (K, V) for each ring stage, then 1 + KV_STAGES
  // mbarriers
  template <int NWG>
  static constexpr int smem() {
    return (NWG + 2 * KV_STAGES) * TILE + 8 * (1 + KV_STAGES) + 1024;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// A copy that has not landed after ~10 s of clocks traps (the launch
// fails with an error) rather than hanging the card.
constexpr long long WATCHDOG_CYCLES = 20'000'000'000LL;

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > WATCHDOG_CYCLES) __trap();
}

// one TMA box (COLS, 1, 64, 1) of a 4-d tensor map into shared memory,
// counted on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// The three outer dims of a tensor map are (h, s, b) in the order of
// their strides; `perm` holds the map dim (1..3) of h in bits 0-1, of s in
// bits 2-3 and of b in bits 4-5 (set by encode_map below).
__device__ __forceinline__ int pick(int perm, int dim, int h, int s, int b) {
  return (perm & 3) == dim ? h : ((perm >> 2) & 3) == dim ? s : b;
}

// all NSUB sub-tiles of rows [s0, s0 + 64) of head h, batch b
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          int perm, uint32_t bar, int h,
                                          int s0, int b) {
  const int c1 = pick(perm, 1, h, s0, b), c2 = pick(perm, 2, h, s0, b),
            c3 = pick(perm, 3, h, s0, b);
#pragma unroll
  for (int j = 0; j < Tc<HD>::NSUB; ++j)
    tma_load(dst + j * Tc<HD>::SUB, map, bar, j * Tc<HD>::COLS, c1, c2, c3);
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle layout
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous window of a wgmma
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// the same for the A fragments a wgmma reads from registers: they stay
// live, and unmoved, until the wait
__device__ __forceinline__ void reg_fence(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
}

#define F4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define F8(a, i) F4(a, i), F4(a, i + 4)

// S (+)= A.B, m64n64k16, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// O += P.V, m64n{16,32,64,128}k16: A (P, bf16x2) in registers, B (V)
// MN-major in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : F8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : F8(d, 0), F8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24), F8(d, 32), F8(d, 40),
        F8(d, 48), F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef F8
#undef F4

// 2^x on the special-function unit; 0 for x below -126 (the p of a key
// 2^126 below the row max does not reach bf16's P anyway)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Grid (S/64, Hq/NWG, B), NWG warpgroups: warpgroup w takes query head
// blockIdx.y * NWG + w, and all NWG heads share one kv head (NWG divides
// G), so each K/V tile a block brings serves NWG heads. perm_* as in
// pick(); o is contiguous (B, S, Hq, OD): the first OD <= HD dims of the
// tile (OD < HD: the maps' hd extent is OD, the rest of a row reads as
// zeros). scale2 = log2(e) / sqrt(OD).
template <int HD, int NWG, int OD = HD>
__global__ void __launch_bounds__(NWG * NT)
    flash_fwd_tc(const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv, int perm_q,
                 int perm_k, int perm_v, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int S, int Skv, int Hq, int Hk,
                 int causal, int window, float scale2) {
  using C = Tc<HD>;
  constexpr int ST = KV_STAGES;
  extern __shared__ uint8_t smem_raw[];
  // every sub-tile starts on a 1024-byte boundary (the 128-byte swizzle's
  // repeat), so the swizzle TMA writes is the one wgmma reads. Layout:
  // NWG q tiles, then (K, V) of each of the ST stages, then the barriers
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t skv = base + NWG * C::TILE;
  const uint32_t bar_q = skv + 2 * ST * C::TILE;  // q arrived
  const uint32_t bar_kv = bar_q + 8;  // + 8 * stage: that stage's K, V arrived

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const uint32_t sq = base + wg * C::TILE;
  // the longest query tiles (causal) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TQ;
  const int h0 = blockIdx.y * NWG;
  const int hq = h0 + wg;
  const int b = blockIdx.z;
  const int hk = h0 / (Hq / Hk);

  // the KV tiles that hold at least one unmasked key for this query tile
  const int q_last = min(q0 + TQ, S) - 1;
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;  // the oldest key any row may see
    kt_begin = lo > 0 ? lo / TK : 0;
  }
  const int k_end = causal ? q_last + 1 : Skv;  // causal: Skv == S
  const int n_tiles = (k_end + TK - 1) / TK - kt_begin;

  if (tid == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int st = 0; st < ST; ++st) mbar_init(bar_kv + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, NWG * C::TILE);
#pragma unroll
    for (int w = 0; w < NWG; ++w)
      load_tile<HD>(base + w * C::TILE, &mq, perm_q, bar_q, h0 + w, q0, b);
    // the first ST - 1 tiles; tile t goes to stage t % ST
    for (int t = 0; t < min(ST - 1, n_tiles); ++t) {
      const uint32_t bar = bar_kv + 8 * t;
      mbar_expect_tx(bar, 2 * C::TILE);
      load_tile<HD>(skv + 2 * t * C::TILE, &mk, perm_k, bar, hk,
                    (kt_begin + t) * TK, b);
      load_tile<HD>(skv + (2 * t + 1) * C::TILE, &mv, perm_v, bar, hk,
                    (kt_begin + t) * TK, b);
    }
  }

  // this thread's rows: r0 and r0 + 8 of the tile
  const int r0 = warp * 16 + (lane >> 2);
  const int qpos[2] = {q0 + r0, q0 + r0 + 8};
  const int cq = 2 * (lane & 3);  // its first column in every 8-column group
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  float s[32];  // scores, then probabilities, of the current tile
#pragma unroll
  for (int x = 0; x < 32; ++x) s[x] = 0.f;

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = (kt_begin + j) * TK;
    const int stage = j % ST;
    const uint32_t sk = skv + 2 * stage * C::TILE;
    const uint32_t sv = sk + C::TILE;
    if (j + ST - 1 < n_tiles) {
      // tile j + ST - 1 goes to the stage tile j - 1 was read from, whose
      // products every warp of every warpgroup has waited for
      if (j > 0) __syncthreads();
      if (tid == 0) {
        const int nst = (j + ST - 1) % ST;
        const uint32_t nbar = bar_kv + 8 * nst;
        mbar_expect_tx(nbar, 2 * C::TILE);
        load_tile<HD>(skv + 2 * nst * C::TILE, &mk, perm_k, nbar, hk,
                      k0 + (ST - 1) * TK, b);
        load_tile<HD>(skv + (2 * nst + 1) * C::TILE, &mv, perm_v, nbar, hk,
                      k0 + (ST - 1) * TK, b);
      }
    }
    mbar_wait(bar_kv + 8 * stage, (j / ST) & 1);

    // S = Q.K^T over hd in k16 steps; step kk lies in sub-tile
    // kk / (COLS/16), 32 bytes further along the row per step inside it
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / (C::COLS / 16)) * C::SUB +
                           (kk % (C::COLS / 16)) * 32;
      wgmma_ss_n64(s, make_desc(sq + off, 16, 8 * C::SW, C::LAYOUT),
                   make_desc(sk + off, 16, 8 * C::SW, C::LAYOUT), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);

    // s[4c + 2i + e] is row r0 + 8i, key k0 + 8c + cq + e. Only a tile
    // that crosses Skv, the diagonal or the window edge is masked: there the
    // scores are scaled and masked first; elsewhere the row max is taken
    // on the raw scores (scale2 > 0, so it scales exactly) and the scale
    // is folded into the exponent's fma.
    const bool edge = k0 + TK > Skv || (causal && k0 + TK - 1 > q0) ||
                      (window > 0 && q0 + TQ - 1 - k0 >= window);
    float mx[2] = {NEG_INF, NEG_INF};
    if (edge) {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int i = (x >> 1) & 1;
        const int kpos = k0 + 8 * (x >> 2) + cq + (x & 1);
        bool ok = kpos < Skv;
        if (causal) ok = ok && qpos[i] >= kpos;
        if (window > 0) ok = ok && qpos[i] - kpos < window;
        s[x] = ok ? s[x] * scale2 : NEG_INF;
        mx[i] = fmaxf(mx[i], s[x]);
      }
    } else {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int i = (x >> 1) & 1;
        mx[i] = fmaxf(mx[i], s[x]);
      }
      mx[0] *= scale2;
      mx[1] *= scale2;
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = fast_exp2(m[i] - m_new);
      m[i] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int i = (x >> 1) & 1;
      s[x] = fast_exp2(edge ? s[x] - m[i] : fmaf(s[x], scale2, -m[i]));
      psum[i] += s[x];
    }
    l[0] = corr[0] * l[0] + psum[0];
    l[1] = corr[1] * l[1] + psum[1];
    // multiplying by 1 is exact: skip the rescale when no row of the warp
    // moved its max
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int x = 0; x < HD / 2; ++x) acc[x] *= corr[(x >> 1) & 1];
    }

    // O += P.V, 16 keys a step; V's 16 rows of step j4 start 16 * SW
    // bytes further into each sub-tile, the sub-tiles SUB bytes apart
    uint32_t p[4][4];
#pragma unroll
    for (int j4 = 0; j4 < 4; ++j4)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[j4][r] = pack_bf16(s[8 * j4 + 2 * r], s[8 * j4 + 2 * r + 1]);
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int j4 = 0; j4 < 4; ++j4)
      wgmma_rs(acc, p[j4],
               make_desc(sv + 16 * j4 * C::SW, C::SUB, 8 * C::SW, C::LAYOUT));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);
    reg_fence(p);
  }

  // l over the quad: a butterfly, the same bits in all four lanes
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  // training: L = ln(sum_j exp(s_j)) of each row, for the backward (m is
  // in the log2 domain of the scaled scores)
  if (lse != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (qpos[i] < S)
        lse[(static_cast<long long>(b) * Hq + hq) * S + qpos[i]] =
            (m[i] + log2f(l[i])) * 0.6931471805599453f;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qpos[i] >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow =
        o + ((static_cast<long long>(b) * S + qpos[i]) * Hq + hq) * OD + cq;
#pragma unroll
    for (int c = 0; c < OD / 8; ++c) {
      const float lo = acc[4 * c + 2 * i] * inv;
      const float hi = acc[4 * c + 2 * i + 1] * inv;
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
          __floats2bfloat162_rn(lo, hi);
    }
  }
}

// ---------------------------------------------------------------------
// fp32 on CUDA cores
// ---------------------------------------------------------------------

constexpr int BQ = 64;    // query rows of a block
constexpr int BK = 32;    // keys of a tile
constexpr int RPT = BQ / 8;   // rows a thread owns
constexpr int CPT = BK / 16;  // score columns a thread owns
constexpr int PP = BK + 4;    // padded row of the probability tile

// The output dim of a thread's i-th accumulator. At hd 64 and 128 a
// thread owns runs of 4 dims 64 apart (ln*4 + 64*(i/4) + i%4), so the 8
// threads of one 16-byte load phase read 32 different banks of a V row;
// otherwise it owns hd/16 dims in a row (at hd 112, 7 dims: a stride of
// 7 words, coprime with the 32 banks, so no conflict).
template <int HD>
__device__ __forceinline__ int out_dim(int ln, int i) {
  if constexpr (HD % 64 == 0)
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

template <int HD>
__global__ void __launch_bounds__(NT)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, long long qsb, long long qss,
                  long long qsh, long long ksb,
                  long long kss, long long ksh, long long vsb, long long vss,
                  long long vsh, int S, int Skv, int Hq, int Hk,
                  int causal, int window, float scale) {
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

  const float* qb = q + b * qsb + hq * qsh;
  for (int idx = tid; idx < BQ * HD; idx += NT) {
    const int r = idx / HD, d = idx - r * HD;
    const int pos = q0 + r;
    sq[r * QP + d] = pos < S ? qb[pos * qss + d] : 0.f;
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
  const int k_end = causal ? q_last + 1 : Skv;  // causal: Skv == S
  const int kt_end = (k_end + BK - 1) / BK;

  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < BK * HD; idx += NT) {
      const int r = idx / HD, d = idx - r * HD;
      const int pos = k0 + r;
      const bool in = pos < Skv;
      sk[r * QP + d] = in ? kb[pos * kss + d] : 0.f;
      sv[r * HD + d] = in ? vb[pos * vss + d] : 0.f;
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
        bool ok = kpos < Skv;
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
    if (lse != nullptr && ln == 0)   // training: L = m + ln(l)
      lse[(static_cast<long long>(b) * Hq + hq) * S + qpos] = m[r] + logf(l[r]);
    float* orow = o + ((static_cast<long long>(b) * S + qpos) * Hq + hq) * HD;
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      orow[out_dim<HD>(ln, i)] = acc[r][i] / den;
  }
}

// the shared-memory opt-in above 48 KB, once per kernel and device
template <typename Kernel>
int opt_in(Kernel kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!done[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    done[dev] = true;
  }
  return 0;
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, const long long* st, int B, int S, int Skv, int Hq,
               int Hk, int causal, int window, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * 4;
  static bool opted_in[64] = {};
  const int e = opt_in(flash_fwd_f32<HD>, bytes, opted_in);
  if (e != 0) return e;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  flash_fwd_f32<HD><<<grid, NT, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], S, Skv, Hq, Hk,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled, a libcuda call, reached through the runtime's
// entry-point query so the library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A failed encode returns -(CUresult), a missing entry point -1000.
constexpr int NO_ENCODER = -1000;

// The tensor map of one (B, S, H, HD) bf16 operand, read through its
// element strides: dim 0 is hd (unit stride), dims 1-3 are those of h, s
// and b of extent > 1 in the order of their strides, then those of extent
// 1 with a packed stride (their stride is never used). The box is
// (COLS, 64 along s, 1, 1), swizzled over its COLS * 2 bytes; rows past
// S, and columns past an hd extent OD < HD, read as zeros. *perm says
// where h, s and b went (see pick()).
template <int HD, int OD = HD>
int encode_map(CUtensorMap* map, int* perm, const void* ptr, int H, int S,
               int B, long long sb, long long ss, long long sh) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return NO_ENCODER;
  struct Dim {
    long long n, stride;
    int which;  // 0 h, 1 s, 2 b
  };
  Dim d[3] = {{H, sh, 0}, {S, ss, 1}, {B, sb, 2}};
  std::stable_sort(d, d + 3, [](const Dim& x, const Dim& y) {
    if ((x.n > 1) != (y.n > 1)) return x.n > 1;
    return x.n > 1 && x.stride < y.stride;
  });
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(OD), 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {static_cast<cuuint32_t>(Tc<HD>::COLS), 1, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  long long prev_n = OD, prev_stride = 1;
  *perm = 0;
  for (int i = 0; i < 3; ++i) {
    const long long stride = d[i].n > 1 ? d[i].stride : prev_n * prev_stride;
    dims[1 + i] = static_cast<cuuint64_t>(d[i].n);
    strides[i] = static_cast<cuuint64_t>(stride) * 2;
    if (d[i].which == 1) box[1 + i] = TK;  // TQ == TK
    *perm |= (1 + i) << (2 * d[i].which);
    prev_n = d[i].n;
    prev_stride = stride;
  }
  const CUtensorMapSwizzle swizzle =
      Tc<HD>::SW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : Tc<HD>::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                         : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

// HD is the tile's hd, OD <= HD the operands' (see flash_fwd_tc)
template <int HD, int NWG, int OD>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, const long long* st, int B, int S, int Skv, int Hq,
              int Hk, int causal, int window, cudaStream_t stream) {
  static_assert(TQ == TK, "one box shape serves q, k and v");
  constexpr int bytes = Tc<HD>::template smem<NWG>();
  static bool opted_in[64] = {};
  int e = opt_in(flash_fwd_tc<HD, NWG, OD>, bytes, opted_in);
  if (e != 0) return e;
  CUtensorMap mq, mk, mv;
  int pq = 0, pk = 0, pv = 0;
  if ((e = encode_map<HD, OD>(&mq, &pq, q, Hq, S, B, st[0], st[1], st[2])) ||
      (e = encode_map<HD, OD>(&mk, &pk, k, Hk, Skv, B, st[3], st[4],
                              st[5])) ||
      (e = encode_map<HD, OD>(&mv, &pv, v, Hk, Skv, B, st[6], st[7],
                              st[8])))
    return e;
  const dim3 grid((S + TQ - 1) / TQ, Hq / NWG, B);
  const float scale2 = 1.4426950408889634f / sqrtf(static_cast<float>(OD));
  flash_fwd_tc<HD, NWG, OD><<<grid, NWG * NT, bytes, stream>>>(
      mq, mk, mv, pq, pk, pv, static_cast<__nv_bfloat16*>(o), lse, S, Skv,
      Hq, Hk, causal, window, scale2);
  return static_cast<int>(cudaGetLastError());
}

// two query heads of one kv group a block where G is even; hd 112 on the
// hd-128 tile
template <int OD>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, const long long* st, int B, int S, int Skv, int Hq,
              int Hk, int causal, int window, cudaStream_t stream) {
  constexpr int HD = OD == 112 ? 128 : OD;
  if ((Hq / Hk) % 2 == 0)
    return launch_tc<HD, 2, OD>(q, k, v, o, lse, st, B, S, Skv, Hq, Hk,
                                causal, window, stream);
  return launch_tc<HD, 1, OD>(q, k, v, o, lse, st, B, S, Skv, Hq, Hk,
                              causal, window, stream);
}

template <bool TC>
int dispatch_hd(const void* q, const void* k, const void* v, void* o,
                float* lse, const long long* st, int B, int S, int Skv,
                int Hq, int Hk, int hd, int causal, int window,
                cudaStream_t s) {
  switch (hd) {
#define REPRO_HD(N)                                                         \
  case N:                                                                   \
    return TC ? launch_tc<N>(q, k, v, o, lse, st, B, S, Skv, Hq, Hk,        \
                             causal, window, s)                             \
              : launch_f32<N>(q, k, v, o, lse, st, B, S, Skv, Hq, Hk,       \
                              causal, window, s);
    REPRO_HD(16)
    REPRO_HD(32)
    REPRO_HD(64)
    REPRO_HD(112)
    REPRO_HD(128)
#undef REPRO_HD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------
// Backward (training). With P
// recomputed from the forward's L (masked keys give P = 0, as the finite
// -1e30 does):
//
//     P = exp(s - L),  D_i = sum_d dO[i,d] O[i,d],  dV = P^T dO,
//     dS = P o (dO V^T - D),  dQ = scale dS K,  dK = scale dS^T Q
//
// (kernels/ref.py: flash_attention_backward_ref). The reference has no
// Pallas backward: it differentiates the jnp blockwise attention
// (src/repro/models/layers.py:79). Per type two kernels, no atomics,
// every sum in a fixed order, so a repeat is bit-identical:
//  - dq: a block per (b, query head, 64-query tile) walks the key tiles
//    the forward walks (the same skips) and writes dQ; first it writes D
//    of its rows, which the second kernel reads.
//  - dkdv: for each (b, kv head, key tile), the G query heads of its kv
//    group in order and, for each, the query tiles that see the key tile,
//    dK and dV summed over them (fp32: one block walks them all; bf16: a
//    cluster of blocks shares them, below).
// What bounds it: operations (10 hd a pair: Q.K^T, dO.V^T, dV, dQ, dK).
// Keys of their own length (cross-attention, Skv != S, never causal or
// windowed), as in the forward: k, v and dk, dv have Skv rows, the key
// loops and masks run to Skv, the grids of dq and of the (L, D) scratch
// run over the S queries, those of dkdv over Skv's key tiles. hd 112
// (Zamba2-7B): fp32 has its own case (7 output dims a thread, out_dim);
// bf16 runs the hd-128 tile on tensor maps of hd extent 112, as the
// forward does, so every product sees zeros in columns 112-127; D sums
// the 112 columns of O and dO that exist, 112 columns of dQ, dK and dV
// are stored, and the scale is 1/sqrt(112).
//
// fp32 (flash_bwd_*_f32), on CUDA cores; 32-key tiles of dkdv. The thread
// map is the fp32 forward's: 128 threads, thread t owns rows
// t/16 + 8r of its tile and columns t%16 + 16c of the other; scores and
// dO.V^T are fp32 dot products over hd from shared memory, P and dS go
// through shared memory to the products that accumulate in registers.

constexpr int BBQ = 64;   // dq: query rows of a block
constexpr int BBK = 32;   // dq: keys of a tile; dkdv: keys of a block
constexpr int BQ2 = 32;   // dkdv: queries of a tile

// rows [s0, s0 + n) of one (b, h) of a (B, S, H, HD) operand (base at
// that (b, h), sequence stride ss) into shared memory as fp32 rows of
// HD + 4 floats, zeros past S
template <int HD>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long ss, int s0, int n,
                                           int S) {
  for (int idx = threadIdx.x; idx < n * HD; idx += NT) {
    const int r = idx / HD, d = idx - r * HD;
    const int pos = s0 + r;
    dst[r * (HD + 4) + d] = pos < S ? src[pos * ss + d] : 0.f;
  }
}

__device__ __forceinline__ bool unmasked(int qpos, int kpos, int S, int Skv,
                                         int causal, int window) {
  bool ok = kpos < Skv && qpos < S;
  if (causal) ok = ok && qpos >= kpos;
  if (window > 0) ok = ok && qpos - kpos < window;
  return ok;
}

// a[r][c] += rows(ra + 8r) of A . rows(cb + 16c) of B over HD, and the
// same for the second pair: two score-like products in one pass
template <int HD, int RN, int CN>
__device__ __forceinline__ void dots2(float (&a)[RN][CN], float (&b2)[RN][CN],
                                      const float* A, const float* Bm,
                                      const float* A2, const float* B2,
                                      int ra, int cb) {
  constexpr int P = HD + 4;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 kb[CN], kb2[CN];
#pragma unroll
    for (int c = 0; c < CN; ++c) {
      kb[c] = *reinterpret_cast<const float4*>(&Bm[(cb + 16 * c) * P + d]);
      kb2[c] = *reinterpret_cast<const float4*>(&B2[(cb + 16 * c) * P + d]);
    }
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(&A[(ra + 8 * r) * P + d]);
      const float4 y =
          *reinterpret_cast<const float4*>(&A2[(ra + 8 * r) * P + d]);
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        a[r][c] = fmaf(x.x, kb[c].x, a[r][c]);
        a[r][c] = fmaf(x.y, kb[c].y, a[r][c]);
        a[r][c] = fmaf(x.z, kb[c].z, a[r][c]);
        a[r][c] = fmaf(x.w, kb[c].w, a[r][c]);
        b2[r][c] = fmaf(y.x, kb2[c].x, b2[r][c]);
        b2[r][c] = fmaf(y.y, kb2[c].y, b2[r][c]);
        b2[r][c] = fmaf(y.z, kb2[c].z, b2[r][c]);
        b2[r][c] = fmaf(y.w, kb2[c].w, b2[r][c]);
      }
    }
  }
}

// acc[r][i] += sum_j W[ra + 8r][j] * X[j][out_dim(ln, i)] over the NJ
// columns of W (row stride WP) and the rows of X (HD + 4 floats a row)
template <int HD, int RN, int NJ, int WP>
__device__ __forceinline__ void accumulate(float (&acc)[RN][HD / 16],
                                           const float* W, const float* X,
                                           int ra, int ln) {
  constexpr int DPT = HD / 16, P = HD + 4;
#pragma unroll 2
  for (int j = 0; j < NJ; ++j) {
    const float* xrow = X + j * P;
    float xv[DPT];
    if constexpr (DPT % 4 == 0) {
#pragma unroll
      for (int i = 0; i < DPT; i += 4) {
        const float4 t =
            *reinterpret_cast<const float4*>(xrow + out_dim<HD>(ln, i));
        xv[i] = t.x;
        xv[i + 1] = t.y;
        xv[i + 2] = t.z;
        xv[i + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < DPT; ++i) xv[i] = xrow[out_dim<HD>(ln, i)];
    }
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      const float wv = W[(ra + 8 * r) * WP + j];
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[r][i] = fmaf(wv, xv[i], acc[r][i]);
    }
  }
}

template <int HD>
constexpr int dq_smem_floats() {
  // q, dO (BBQ rows), k, v (BBK rows), dS (BBQ x (BBK + 4))
  return 2 * BBQ * (HD + 4) + 2 * BBK * (HD + 4) + BBQ * (BBK + 4);
}

template <int HD>
__global__ void __launch_bounds__(NT)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ o,
                 const float* __restrict__ lse, const float* __restrict__ d_o,
                 float* __restrict__ dq, float* __restrict__ delta, long long qsb,
                 long long qss, long long qsh, long long ksb, long long kss,
                 long long ksh, long long vsb, long long vss, long long vsh,
                 long long dsb, long long dss, long long dsh, int S, int Skv,
                 int Hq, int Hk, int causal, int window, float scale) {
  constexpr int P = HD + 4, DPT = HD / 16, RN = BBQ / 8, CN = BBK / 16;
  constexpr int WP = BBK + 4;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sdo = sq + BBQ * P;
  float* sk = sdo + BBQ * P;
  float* sv = sk + BBK * P;
  float* sds = sv + BBK * P;

  const int tid = threadIdx.x;
  const int rg = tid >> 4, ln = tid & 15;
  const int q0 = blockIdx.x * BBQ;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hq / (Hq / Hk);
  const long long row0 = (static_cast<long long>(b) * Hq + hq) * S;

  stage_rows<HD>(sq, q + b * qsb + hq * qsh, qss, q0, BBQ, S);
  stage_rows<HD>(sdo, d_o + b * dsb + hq * dsh, dss, q0, BBQ, S);
  __syncthreads();

  // D and L of the thread's rows; D = dO . O over the half-warp's 16
  // lanes, a butterfly (every lane ends with the same bits)
  float Lr[RN], Dr[RN];
#pragma unroll
  for (int r = 0; r < RN; ++r) {
    const int pos = q0 + rg + 8 * r;
    float acc = 0.f;
    if (pos < S) {
      const float* orow = o + ((static_cast<long long>(b) * S + pos) * Hq + hq) * HD;
      for (int d = ln; d < HD; d += 16)
        acc = fmaf(sdo[(rg + 8 * r) * P + d], orow[d], acc);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    Dr[r] = acc;
    Lr[r] = pos < S ? lse[row0 + pos] : 0.f;
    if (pos < S && ln == 0) delta[row0 + pos] = acc;
  }

  float acc[RN][DPT];
#pragma unroll
  for (int r = 0; r < RN; ++r)
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[r][i] = 0.f;

  // the key tiles the forward walks for this query tile
  const int q_last = min(q0 + BBQ, S) - 1;
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;
    kt_begin = lo > 0 ? lo / BBK : 0;
  }
  const int kt_end = ((causal ? q_last + 1 : Skv) + BBK - 1) / BBK;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BBK;
    __syncthreads();  // every thread is done with the previous tile
    stage_rows<HD>(sk, kb, kss, k0, BBK, Skv);
    stage_rows<HD>(sv, vb, vss, k0, BBK, Skv);
    __syncthreads();
    float sc[RN][CN], dp[RN][CN];
#pragma unroll
    for (int r = 0; r < RN; ++r)
#pragma unroll
      for (int c = 0; c < CN; ++c) sc[r][c] = dp[r][c] = 0.f;
    dots2<HD, RN, CN>(sc, dp, sq, sk, sdo, sv, rg, ln);
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      const int qpos = q0 + rg + 8 * r;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int kpos = k0 + ln + 16 * c;
        const float p = unmasked(qpos, kpos, S, Skv, causal, window)
                            ? expf(fmaf(sc[r][c], scale, -Lr[r]))
                            : 0.f;
        sds[(rg + 8 * r) * WP + ln + 16 * c] = p * (dp[r][c] - Dr[r]);
      }
    }
    __syncwarp();  // the half-warp's rows of dS are in place
    accumulate<HD, RN, BBK, WP>(acc, sds, sk, rg, ln);
  }

#pragma unroll
  for (int r = 0; r < RN; ++r) {
    const int qpos = q0 + rg + 8 * r;
    if (qpos >= S) continue;
    float* row = dq + ((static_cast<long long>(b) * S + qpos) * Hq + hq) * HD;
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      row[out_dim<HD>(ln, i)] = acc[r][i] * scale;
  }
}

template <int HD>
constexpr int dkdv_smem_floats() {
  // k, v (BBK rows), q, dO (BQ2 rows), P and dS (BBK x (BQ2 + 4)), L, D
  return 2 * BBK * (HD + 4) + 2 * BQ2 * (HD + 4) + 2 * BBK * (BQ2 + 4) +
         2 * BQ2;
}

template <int HD>
__global__ void __launch_bounds__(NT)
    flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ lse,
                   const float* __restrict__ delta, const float* __restrict__ d_o,
                   float* __restrict__ dk, float* __restrict__ dv, long long qsb,
                   long long qss, long long qsh, long long ksb, long long kss,
                   long long ksh, long long vsb, long long vss, long long vsh,
                   long long dsb, long long dss, long long dsh, int S,
                   int Skv, int Hq, int Hk, int causal, int window,
                   float scale) {
  constexpr int P = HD + 4, DPT = HD / 16, RN = BBK / 8, CN = BQ2 / 16;
  constexpr int WP = BQ2 + 4;
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);
  float* sv = sk + BBK * P;
  float* sq = sv + BBK * P;
  float* sdo = sq + BQ2 * P;
  float* sp = sdo + BQ2 * P;
  float* sds = sp + BBK * WP;
  float* sL = sds + BBK * WP;
  float* sD = sL + BQ2;

  const int tid = threadIdx.x;
  const int rg = tid >> 4, ln = tid & 15;
  const int k0 = blockIdx.x * BBK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hk;

  stage_rows<HD>(sk, k + b * ksb + hk * ksh, kss, k0, BBK, Skv);
  stage_rows<HD>(sv, v + b * vsb + hk * vsh, vss, k0, BBK, Skv);

  // the query tiles that see at least one key of this tile (a window
  // only with Skv == S)
  const int k_last = min(k0 + BBK, Skv) - 1;
  const int qt_begin = causal ? k0 / BQ2 : 0;
  int q_end = S;  // one past the last query that sees a key here
  if (window > 0) q_end = min(S, k_last + window);
  const int qt_end = (q_end + BQ2 - 1) / BQ2;

  float ak[RN][DPT], av[RN][DPT];
#pragma unroll
  for (int r = 0; r < RN; ++r)
#pragma unroll
    for (int i = 0; i < DPT; ++i) ak[r][i] = av[r][i] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int hq = hk * G + g;
    const long long row0 = (static_cast<long long>(b) * Hq + hq) * S;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ2;
      __syncthreads();  // every thread is done with the previous tile
      stage_rows<HD>(sq, q + b * qsb + hq * qsh, qss, q0, BQ2, S);
      stage_rows<HD>(sdo, d_o + b * dsb + hq * dsh, dss, q0, BQ2, S);
      for (int x = tid; x < BQ2; x += NT) {
        const bool in = q0 + x < S;
        sL[x] = in ? lse[row0 + q0 + x] : 0.f;
        sD[x] = in ? delta[row0 + q0 + x] : 0.f;
      }
      __syncthreads();
      // rows: keys; columns: queries
      float sc[RN][CN], dp[RN][CN];
#pragma unroll
      for (int r = 0; r < RN; ++r)
#pragma unroll
        for (int c = 0; c < CN; ++c) sc[r][c] = dp[r][c] = 0.f;
      dots2<HD, RN, CN>(sc, dp, sk, sq, sv, sdo, rg, ln);
#pragma unroll
      for (int r = 0; r < RN; ++r) {
        const int kpos = k0 + rg + 8 * r;
#pragma unroll
        for (int c = 0; c < CN; ++c) {
          const int col = ln + 16 * c;
          const float p = unmasked(q0 + col, kpos, S, Skv, causal, window)
                              ? expf(fmaf(sc[r][c], scale, -sL[col]))
                              : 0.f;
          sp[(rg + 8 * r) * WP + col] = p;
          sds[(rg + 8 * r) * WP + col] = p * (dp[r][c] - sD[col]);
        }
      }
      __syncwarp();  // the half-warp's rows of P and dS are in place
      accumulate<HD, RN, BQ2, WP>(av, sp, sdo, rg, ln);
      accumulate<HD, RN, BQ2, WP>(ak, sds, sq, rg, ln);
    }
  }

#pragma unroll
  for (int r = 0; r < RN; ++r) {
    const int kpos = k0 + rg + 8 * r;
    if (kpos >= Skv) continue;
    const long long at =
        ((static_cast<long long>(b) * Skv + kpos) * Hk + hk) * HD;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      dk[at + out_dim<HD>(ln, i)] = ak[r][i] * scale;
      dv[at + out_dim<HD>(ln, i)] = av[r][i];
    }
  }
}

template <int HD>
int launch_bwd_f32(const void* q, const void* k, const void* v, const void* o,
               const float* lse, const void* d_o, void* dq, void* dk,
               void* dv, float* delta, const long long* st, int B, int S,
               int Skv, int Hq, int Hk, int causal, int window,
               cudaStream_t stream) {
  constexpr int dq_bytes = dq_smem_floats<HD>() * 4;
  constexpr int kv_bytes = dkdv_smem_floats<HD>() * 4;
  static bool dq_in[64] = {}, kv_in[64] = {};
  int e = opt_in(flash_bwd_dq_f32<HD>, dq_bytes, dq_in);
  if (e == 0) e = opt_in(flash_bwd_dkdv_f32<HD>, kv_bytes, kv_in);
  if (e != 0) return e;
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(d_o);
  flash_bwd_dq_f32<HD><<<dim3((S + BBQ - 1) / BBQ, Hq, B), NT, dq_bytes,
                        stream>>>(
      tq, tk, tv, static_cast<const float*>(o), lse, tdo, static_cast<float*>(dq),
      delta, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], S, Skv, Hq, Hk, causal, window, scale);
  e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  flash_bwd_dkdv_f32<HD><<<dim3((Skv + BBK - 1) / BBK, Hk, B), NT, kv_bytes,
                          stream>>>(
      tq, tk, tv, lse, delta, tdo, static_cast<float*>(dk), static_cast<float*>(dv),
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], S, Skv, Hq, Hk, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                 const float* lse, const void* d_o, void* dq, void* dk,
                 void* dv, float* delta, const long long* st, int B, int S,
                 int Skv, int Hq, int Hk, int hd, int causal, int window,
                 cudaStream_t s) {
  switch (hd) {
#define REPRO_HD(N)                                                        \
  case N:                                                                  \
    return launch_bwd_f32<N>(q, k, v, o, lse, d_o, dq, dk, dv, delta, st, B, \
                             S, Skv, Hq, Hk, causal, window, s);
    REPRO_HD(16)
    REPRO_HD(32)
    REPRO_HD(64)
    REPRO_HD(112)
    REPRO_HD(128)
#undef REPRO_HD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bf16 (flash_bwd_dq_wg, flash_bwd_dkdv_wg), on the tensor cores with
// wgmma, the forward's machinery: a warpgroup owns a 64-row tile, tiles
// arrive by TMA (the forward's tensor maps, 128-byte swizzle) into rings
// of two stages under mbarriers, and every product is wgmma m64nNk16 with
// bf16 operands and fp32 accumulators in registers:
//  - dq: a block per (b, query head, 64-query tile), longest causal tiles
//    first. S = Q.K^T and dP = dO.V^T read both operands from shared
//    memory (K-major); dQ += dS.K takes dS from the registers (the
//    accumulator fragment of S is the A fragment of m64nNk16) and K
//    MN-major. It writes D = rowsum(dO o O) and L log2 e of its rows, as
//    (L, D) pairs padded to whole tiles, for the second kernel.
//  - dkdv: rows are keys. S^T = K.Q^T and dP^T = V.dO^T from shared
//    memory, then dV += P^T.dO and dK += dS^T.Q with P^T and dS^T from
//    the registers and dO, Q MN-major. The (head, query tile) pairs that
//    see a key tile -- G heads of the kv group, in order, each its query
//    tiles in order -- are cut into CL contiguous runs, one for each block
//    of a thread-block cluster (CL <= 4, as many as there are pairs), so
//    no block walks all of them; each block's Q, dO and (L, D) tiles come
//    by TMA into a two-stage ring. The blocks' fp32 dK and dV are then
//    added in rank order through distributed shared memory
//    (ld.shared::cluster), each rank folding a quarter (1 / CL) of the
//    rows, and written once. Clusters go out key tile by key tile, tile 0
//    first: under the causal mask the longest first.
// P and dS enter their products as two bf16 parts, hi = bf16(x) and lo =
// bf16(x - hi), ~16 bits of mantissa where one part keeps 8: twice those
// two products (one part measured 15 % faster on the H100 with 4x the
// error, inside the tolerance; the margin was kept). No atomics, every sum in a fixed order that
// depends on the shape alone, so a repeat is bit-identical. TMA needs
// 16-byte aligned bases and strides of q, k, v and dO; the wrapper
// refuses anything else.

constexpr int Q_STAGES = 2;   // dkdv: query tiles in the ring
constexpr int MAX_CL = 4;     // dkdv: blocks of a cluster
constexpr int LD_BYTES = TQ * 8;  // (L log2 e, D) of a query tile

template <int HD>
struct Bw {
  using C = Tc<HD>;
  // dq: Q, dO, then (K, V) for each ring stage, D of the rows, barriers
  static constexpr int DQ_SMEM =
      (2 + 2 * KV_STAGES) * C::TILE + TQ * 4 + 8 * (1 + KV_STAGES) + 1024;
  // dkdv: K, V, then (Q, dO) for each ring stage, (L, D) for each stage,
  // barriers; the fp32 dK, dV of the fold (2 x 64 x HD) reuse the ring
  static constexpr int KV_SMEM = (2 + 2 * Q_STAGES) * C::TILE +
                                 Q_STAGES * LD_BYTES + 8 * (1 + Q_STAGES) +
                                 1024;
  static_assert(2 * 64 * HD * 4 <= 2 * Q_STAGES * C::TILE,
                "the fold's dK, dV fit the ring");
};

// the A fragments of k-step j4 (16 keys or queries) of a 64-column
// accumulator x as two bf16 parts: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void pack_split(const float (&x)[32], int j4,
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float a = x[8 * j4 + 2 * r], c = x[8 * j4 + 2 * r + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, c);
    hi[r] = *reinterpret_cast<const uint32_t*>(&h);
    lo[r] = pack_bf16(a - __low2float(h), c - __high2float(h));
  }
}

// acc += X . B over 64 rows of B (shared memory tile at sb, MN-major), X
// the 64 x 64 fp32 accumulator x in registers: hi parts, then lo parts
template <int HD>
__device__ __forceinline__ void product_rs(float (&acc)[HD / 2],
                                           const float (&x)[32],
                                           uint32_t sb) {
  using C = Tc<HD>;
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int j4 = 0; j4 < 4; ++j4) pack_split(x, j4, hi[j4], lo[j4]);
  reg_fence(acc);
  wgmma_fence();
#pragma unroll
  for (int j4 = 0; j4 < 4; ++j4)
    wgmma_rs(acc, hi[j4],
             make_desc(sb + 16 * j4 * C::SW, C::SUB, 8 * C::SW, C::LAYOUT));
#pragma unroll
  for (int j4 = 0; j4 < 4; ++j4)
    wgmma_rs(acc, lo[j4],
             make_desc(sb + 16 * j4 * C::SW, C::SUB, 8 * C::SW, C::LAYOUT));
  wgmma_commit();
  wgmma_wait_all();
  reg_fence(acc);
  reg_fence(hi);
  reg_fence(lo);
}

// d = A.B^T over HD (both 64-row tiles K-major in shared memory), and
// d2 = A2.B2^T, one commit group
template <int HD>
__device__ __forceinline__ void products_ss(float (&d)[32], uint32_t sa,
                                            uint32_t sb, float (&d2)[32],
                                            uint32_t sa2, uint32_t sb2) {
  using C = Tc<HD>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off =
        (kk / (C::COLS / 16)) * C::SUB + (kk % (C::COLS / 16)) * 32;
    wgmma_ss_n64(d, make_desc(sa + off, 16, 8 * C::SW, C::LAYOUT),
                 make_desc(sb + off, 16, 8 * C::SW, C::LAYOUT), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off =
        (kk / (C::COLS / 16)) * C::SUB + (kk % (C::COLS / 16)) * 32;
    wgmma_ss_n64(d2, make_desc(sa2 + off, 16, 8 * C::SW, C::LAYOUT),
                 make_desc(sb2 + off, 16, 8 * C::SW, C::LAYOUT), kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  reg_fence(d);
  reg_fence(d2);
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Grid (S/64, Hq, B), one warpgroup a block; Skv keys. ld: (B*Hq, S_pad)
// pairs (L log2 e, D), S_pad = S rounded up to whole tiles, written here
// for every query row of the block's tile (zeros past S). o, dq
// contiguous (B, S, Hq, OD): the first OD <= HD columns of the tile (OD <
// HD: the maps' hd extent is OD and the rest of a row reads as zeros, so
// D sums OD columns and OD columns of dQ are stored).
template <int HD, int OD = HD>
__global__ void __launch_bounds__(NT)
    flash_bwd_dq_wg(const __grid_constant__ CUtensorMap mq,
                    const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv,
                    const __grid_constant__ CUtensorMap mdo, int perm_q,
                    int perm_k, int perm_v, int perm_do,
                    const __nv_bfloat16* __restrict__ o,
                    const __nv_bfloat16* __restrict__ d_o, long long dsb,
                    long long dss, long long dsh,
                    const float* __restrict__ lse, float* __restrict__ ld,
                    __nv_bfloat16* __restrict__ dq, int S, int Skv,
                    int S_pad, int Hq, int Hk, int causal, int window,
                    float scale2) {
  using C = Tc<HD>;
  constexpr int ST = KV_STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base, sdo = base + C::TILE;
  const uint32_t skv = base + 2 * C::TILE;
  float* sD = reinterpret_cast<float*>(smem_raw + (skv + 2 * ST * C::TILE -
                                                   smem_addr(smem_raw)));
  const uint32_t bar_q = skv + 2 * ST * C::TILE + TQ * 4;
  const uint32_t bar_kv = bar_q + 8;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TQ;  // longest first
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hq / (Hq / Hk);
  const long long row0 = (static_cast<long long>(b) * Hq + hq);

  const int q_last = min(q0 + TQ, S) - 1;
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;
    kt_begin = lo > 0 ? lo / TK : 0;
  }
  const int k_end = causal ? q_last + 1 : Skv;  // causal: Skv == S
  const int n_tiles = (k_end + TK - 1) / TK - kt_begin;

  if (tid == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int st = 0; st < ST; ++st) mbar_init(bar_kv + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * C::TILE);
    load_tile<HD>(sq, &mq, perm_q, bar_q, hq, q0, b);
    load_tile<HD>(sdo, &mdo, perm_do, bar_q, hq, q0, b);
    for (int t = 0; t < min(ST - 1, n_tiles); ++t) {
      const uint32_t bar = bar_kv + 8 * t;
      mbar_expect_tx(bar, 2 * C::TILE);
      load_tile<HD>(skv + 2 * t * C::TILE, &mk, perm_k, bar, hk,
                    (kt_begin + t) * TK, b);
      load_tile<HD>(skv + (2 * t + 1) * C::TILE, &mv, perm_v, bar, hk,
                    (kt_begin + t) * TK, b);
    }
  }

  // D of the tile's rows from device memory: two threads a row, halves of
  // OD in order (16-byte loads: OD / 2 is a multiple of 8), then one
  // butterfly add (both end with the same bits)
  {
    const int r = tid >> 1, pos = q0 + r;
    float acc = 0.f;
    if (pos < S) {
      const __nv_bfloat16* orow =
          o + ((static_cast<long long>(b) * S + pos) * Hq + hq) * OD +
          (tid & 1) * (OD / 2);
      const __nv_bfloat16* drow = d_o + b * dsb + pos * dss + hq * dsh +
                                  (tid & 1) * (OD / 2);
#pragma unroll
      for (int c = 0; c < OD / 16; ++c) {
        const uint4 ov = reinterpret_cast<const uint4*>(orow)[c];
        const uint4 dv = reinterpret_cast<const uint4*>(drow)[c];
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc = fmaf(__low2float(d2[e]), __low2float(o2[e]), acc);
          acc = fmaf(__high2float(d2[e]), __high2float(o2[e]), acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0) {
      sD[r] = acc;
      const float l2 = pos < S ? lse[row0 * S + pos] * 1.4426950408889634f
                               : 0.f;
      reinterpret_cast<float2*>(ld)[row0 * S_pad + pos] =
          make_float2(l2, pos < S ? acc : 0.f);
    }
  }
  __syncthreads();

  const int r0 = warp * 16 + (lane >> 2);
  const int qpos[2] = {q0 + r0, q0 + r0 + 8};
  const int cq = 2 * (lane & 3);
  float Lr[2], Dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    Lr[i] = qpos[i] < S ? lse[row0 * S + qpos[i]] * 1.4426950408889634f : 0.f;
    Dr[i] = sD[r0 + 8 * i];
  }
  float acc[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) acc[x] = 0.f;
  float s[32], dp[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) s[x] = dp[x] = 0.f;

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = (kt_begin + j) * TK;
    const int stage = j % ST;
    const uint32_t sk = skv + 2 * stage * C::TILE;
    const uint32_t sv = sk + C::TILE;
    if (j + ST - 1 < n_tiles) {
      if (j > 0) __syncthreads();
      if (tid == 0) {
        const int nst = (j + ST - 1) % ST;
        const uint32_t nbar = bar_kv + 8 * nst;
        mbar_expect_tx(nbar, 2 * C::TILE);
        load_tile<HD>(skv + 2 * nst * C::TILE, &mk, perm_k, nbar, hk,
                      k0 + (ST - 1) * TK, b);
        load_tile<HD>(skv + (2 * nst + 1) * C::TILE, &mv, perm_v, nbar, hk,
                      k0 + (ST - 1) * TK, b);
      }
    }
    mbar_wait(bar_kv + 8 * stage, (j / ST) & 1);
    products_ss<HD>(s, sq, sk, dp, sdo, sv);

    // s[4c + 2i + e]: row r0 + 8i, key k0 + 8c + cq + e. P = 2^(s scale2
    // - L log2 e), 0 where masked; dS = P (dP - D) into dp
    const bool edge = k0 + TK > Skv || (causal && k0 + TK - 1 > q0) ||
                      (window > 0 && q0 + TQ - 1 - k0 >= window);
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int i = (x >> 1) & 1;
      float p = fast_exp2(fmaf(s[x], scale2, -Lr[i]));
      if (edge) {
        const int kpos = k0 + 8 * (x >> 2) + cq + (x & 1);
        bool ok = kpos < Skv;
        if (causal) ok = ok && qpos[i] >= kpos;
        if (window > 0) ok = ok && qpos[i] - kpos < window;
        p = ok ? p : 0.f;
      }
      dp[x] = p * (dp[x] - Dr[i]);
    }
    product_rs<HD>(acc, dp, sk);
  }

  const float mult = scale2 * 0.6931471805599453f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qpos[i] >= S) continue;
    __nv_bfloat16* row =
        dq + ((static_cast<long long>(b) * S + qpos[i]) * Hq + hq) * OD + cq;
#pragma unroll
    for (int c = 0; c < OD / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * c) = __floats2bfloat162_rn(
          acc[4 * c + 2 * i] * mult, acc[4 * c + 2 * i + 1] * mult);
  }
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float4 cluster_ld4(uint32_t addr, uint32_t q) {
  uint32_t ra;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(ra)
               : "r"(addr), "r"(q));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(ra)
               : "memory");
  return v;
}

// The fold's fp32 tile: row `row`, columns from `col`, swizzled by the
// row so that the warps' float2 writes spread over the banks
template <int HD>
__device__ __forceinline__ int fold_idx(int row, int col) {
  constexpr int SPAN = HD / 8 < 8 ? HD / 8 : 8;
  return row * HD + (col ^ ((row & (SPAN - 1)) << 3));
}

// Grid x = CL x (key tiles of Skv x Hk x B), clusters of CL blocks along
// x: cluster c takes key tile c / (B Hk), batch (c / Hk) % B, kv head c %
// Hk; its rank takes its run of the (head, query tile) pairs, query tiles
// of S. dk, dv contiguous (B, Skv, Hk, OD), OD <= HD as in
// flash_bwd_dq_wg; ld as flash_bwd_dq_wg wrote it.
template <int HD, int OD = HD>
__global__ void __launch_bounds__(NT)
    flash_bwd_dkdv_wg(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv,
                      const __grid_constant__ CUtensorMap mdo, int perm_q,
                      int perm_k, int perm_v, int perm_do,
                      const float* __restrict__ ld,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int S, int Skv,
                      int S_pad, int B, int Hq, int Hk, int causal,
                      int window, float scale2) {
  using C = Tc<HD>;
  constexpr int QS = Q_STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = base, sv = base + C::TILE;
  const uint32_t sring = base + 2 * C::TILE;        // (Q, dO) per stage
  const uint32_t sld = sring + 2 * QS * C::TILE;    // (L, D) per stage
  const uint32_t bar_kv = sld + QS * LD_BYTES;
  const uint32_t bar_q = bar_kv + 8;                // + 8 * stage
  uint8_t* const gbase = smem_raw + (base - smem_addr(smem_raw));

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int CL = static_cast<int>(gridDim.x) /
                 (((Skv + TK - 1) / TK) * Hk * B);    // blocks a cluster
  const int rank = static_cast<int>(cluster_rank());
  const int cid = blockIdx.x / CL;
  const int kt = cid / (B * Hk);
  const int b = (cid / Hk) % B;
  const int hk = cid % Hk;
  const int G = Hq / Hk;
  const int k0 = kt * TK;

  // the query tiles that see this key tile; pairs (g, tile) in order (a
  // causal mask or a window only with Skv == S)
  const int k_last = min(k0 + TK, Skv) - 1;
  const int qt_begin = causal ? k0 / TQ : 0;
  const int q_end = window > 0 ? min(S, k_last + window) : S;
  const int nq = (q_end + TQ - 1) / TQ - qt_begin;
  const int pairs = G * nq;
  const int first = pairs * rank / CL;
  const int n_local = pairs * (rank + 1) / CL - first;

  const CUtensorMap* const pmq = &mq;
  const CUtensorMap* const pmdo = &mdo;
  auto issue = [&](int j, int stage) {
    const int it = first + j;
    const int hq = hk * G + it / nq;
    const int q0 = (qt_begin + it % nq) * TQ;
    const uint32_t bar = bar_q + 8 * stage;
    mbar_expect_tx(bar, 2 * C::TILE + LD_BYTES);
    load_tile<HD>(sring + 2 * stage * C::TILE, pmq, perm_q, bar, hq, q0, b);
    load_tile<HD>(sring + (2 * stage + 1) * C::TILE, pmdo, perm_do, bar, hq,
                  q0, b);
    bulk_load(sld + stage * LD_BYTES,
              ld + 2 * ((static_cast<long long>(b) * Hq + hq) * S_pad + q0),
              LD_BYTES, bar);
  };

  if (tid == 0) {
    mbar_init(bar_kv, 1);
#pragma unroll
    for (int st = 0; st < QS; ++st) mbar_init(bar_q + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * C::TILE);
    load_tile<HD>(sk, &mk, perm_k, bar_kv, hk, k0, b);
    load_tile<HD>(sv, &mv, perm_v, bar_kv, hk, k0, b);
    for (int j = 0; j < min(QS - 1, n_local); ++j) issue(j, j);
  }

  // this thread's rows (keys) r0, r0 + 8; columns (queries) 8c + cq + e
  const int r0 = warp * 16 + (lane >> 2);
  const int kpos[2] = {k0 + r0, k0 + r0 + 8};
  const int cq = 2 * (lane & 3);
  float ak[HD / 2], av[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) ak[x] = av[x] = 0.f;
  float s[32], dp[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) s[x] = dp[x] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int j = 0; j < n_local; ++j) {
    const int stage = j % QS;
    const int it = first + j;
    const int q0 = (qt_begin + it % nq) * TQ;
    const uint32_t sq = sring + 2 * stage * C::TILE;
    const uint32_t sdo = sq + C::TILE;
    if (j + QS - 1 < n_local) {
      // the stage pair j - 1 was read from: every warp has waited on it
      if (j > 0) __syncthreads();
      if (tid == 0) issue(j + QS - 1, (j + QS - 1) % QS);
    }
    mbar_wait(bar_q + 8 * stage, (j / QS) & 1);
    products_ss<HD>(s, sk, sq, dp, sv, sdo);

    const float4* lds = reinterpret_cast<const float4*>(
        gbase + (sld - base) + stage * LD_BYTES);
    const bool edge = q0 + TQ > S || k0 + TK > Skv ||
                      (causal && q0 < k0 + TK - 1) ||
                      (window > 0 && q0 + TQ - 1 - k0 >= window);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      // (L, D) of queries q0 + 8c + cq and + 1
      const float4 pr = lds[(8 * c + cq) >> 1];
#pragma unroll
      for (int x = 4 * c; x < 4 * c + 4; ++x) {  // unrolled: x is constant
        const int e = x & 1;
        const float l2 = e ? pr.z : pr.x, dd = e ? pr.w : pr.y;
        float p = fast_exp2(fmaf(s[x], scale2, -l2));
        if (edge) {
          const int kp = kpos[(x >> 1) & 1], qp = q0 + 8 * c + cq + e;
          bool ok = kp < Skv && qp < S;
          if (causal) ok = ok && qp >= kp;
          if (window > 0) ok = ok && qp - kp < window;
          p = ok ? p : 0.f;
        }
        s[x] = p;
        dp[x] = p * (dp[x] - dd);
      }
    }
    product_rs<HD>(av, s, sdo);
    product_rs<HD>(ak, dp, sq);
  }

  // the fold: this block's dK, dV (fp32) into the ring, then every rank
  // adds the CL blocks' rows of its share in rank order
  __syncthreads();
  float* fk = reinterpret_cast<float*>(gbase + (sring - base));
  float* fv = fk + 64 * HD;
#pragma unroll
  for (int c = 0; c < HD / 8; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int at = fold_idx<HD>(r0 + 8 * i, 8 * c + cq);
      *reinterpret_cast<float2*>(fk + at) =
          make_float2(ak[4 * c + 2 * i], ak[4 * c + 2 * i + 1]);
      *reinterpret_cast<float2*>(fv + at) =
          make_float2(av[4 * c + 2 * i], av[4 * c + 2 * i + 1]);
    }
  cluster_sync();
  const float mult = scale2 * 0.6931471805599453f;
  const int rows = 64 / CL;
  for (int e = tid; e < 2 * rows * (HD / 4); e += NT) {
    const int which = e / (rows * (HD / 4));
    const int rest = e - which * rows * (HD / 4);
    const int row = rank * rows + rest / (HD / 4);
    const int col = 4 * (rest % (HD / 4));
    const int pos = k0 + row;
    const uint32_t src =
        smem_addr(which ? fv : fk) + 4 * fold_idx<HD>(row, col);
    float4 a = cluster_ld4(src, 0);
    for (int q = 1; q < CL; ++q) {
      const float4 t = cluster_ld4(src, q);
      a.x += t.x;
      a.y += t.y;
      a.z += t.z;
      a.w += t.w;
    }
    if (pos < Skv && col < OD) {
      const float m = which ? 1.f : mult;
      __nv_bfloat162 lo2 = __floats2bfloat162_rn(a.x * m, a.y * m);
      __nv_bfloat162 hi2 = __floats2bfloat162_rn(a.z * m, a.w * m);
      uint2 pk;
      pk.x = *reinterpret_cast<uint32_t*>(&lo2);
      pk.y = *reinterpret_cast<uint32_t*>(&hi2);
      *reinterpret_cast<uint2*>(
          (which ? dv : dk) +
          ((static_cast<long long>(b) * Skv + pos) * Hk + hk) * OD + col) = pk;
    }
  }
  // no block leaves while another reads its shared memory
  cluster_sync();
}

// CL: the blocks a cluster takes a key tile's (head, query tile) pairs
// with, as many as the longest key tile (of Skv keys) has, query tiles of
// S, up to MAX_CL
int dkdv_cluster(int S, int Skv, int G, int causal, int window) {
  int most = 0;
  const int n_kt = (Skv + TK - 1) / TK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TK, k_last = std::min(k0 + TK, Skv) - 1;
    const int qt_begin = causal ? k0 / TQ : 0;
    const int q_end = window > 0 ? std::min(S, k_last + window) : S;
    most = std::max(most, G * ((q_end + TQ - 1) / TQ - qt_begin));
  }
  return most >= 4 ? 4 : most >= 2 ? 2 : 1;
}

// HD is the tile's hd, OD <= HD the operands' (see flash_bwd_dq_wg)
template <int HD, int OD>
int launch_bwd_tc(const void* q, const void* k, const void* v, const void* o,
                  const float* lse, const void* d_o, void* dq, void* dk,
                  void* dv, float* ld, const long long* st, int B, int S,
                  int Skv, int Hq, int Hk, int causal, int window,
                  cudaStream_t stream) {
  static_assert(TQ == TK, "one box shape serves q, k, v and dO");
  constexpr int dq_bytes = Bw<HD>::DQ_SMEM;
  constexpr int kv_bytes = Bw<HD>::KV_SMEM;
  static bool dq_in[64] = {}, kv_in[64] = {};
  int e = opt_in(flash_bwd_dq_wg<HD, OD>, dq_bytes, dq_in);
  if (e == 0) e = opt_in(flash_bwd_dkdv_wg<HD, OD>, kv_bytes, kv_in);
  if (e != 0) return e;
  CUtensorMap mq, mk, mv, mdo;
  int pq = 0, pk = 0, pv = 0, pdo = 0;
  if ((e = encode_map<HD, OD>(&mq, &pq, q, Hq, S, B, st[0], st[1], st[2])) ||
      (e = encode_map<HD, OD>(&mk, &pk, k, Hk, Skv, B, st[3], st[4],
                              st[5])) ||
      (e = encode_map<HD, OD>(&mv, &pv, v, Hk, Skv, B, st[6], st[7],
                              st[8])) ||
      (e = encode_map<HD, OD>(&mdo, &pdo, d_o, Hq, S, B, st[9], st[10],
                              st[11])))
    return e;
  // scores scaled into the log2 domain: P = 2^(s scale2 - L log2 e)
  const float scale2 = 1.4426950408889634f / sqrtf(static_cast<float>(OD));
  const int n_t = (S + TQ - 1) / TQ, S_pad = n_t * TQ;
  const int n_kt = (Skv + TK - 1) / TK;
  using bf = __nv_bfloat16;
  flash_bwd_dq_wg<HD, OD><<<dim3(n_t, Hq, B), NT, dq_bytes, stream>>>(
      mq, mk, mv, mdo, pq, pk, pv, pdo, static_cast<const bf*>(o),
      static_cast<const bf*>(d_o), st[9], st[10], st[11], lse, ld,
      static_cast<bf*>(dq), S, Skv, S_pad, Hq, Hk, causal, window, scale2);
  e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  const int cl = dkdv_cluster(S, Skv, Hq / Hk, causal, window);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cl) * n_kt * Hk * B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = kv_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = static_cast<int>(cudaLaunchKernelEx(
      &cfg, flash_bwd_dkdv_wg<HD, OD>, mq, mk, mv, mdo, pq, pk, pv, pdo,
      static_cast<const float*>(ld), static_cast<bf*>(dk),
      static_cast<bf*>(dv), S, Skv, S_pad, B, Hq, Hk, causal, window,
      scale2));
  if (e != 0) return e;
  return static_cast<int>(cudaGetLastError());
}

int dispatch_bwd_tc(const void* q, const void* k, const void* v,
                    const void* o, const float* lse, const void* d_o,
                    void* dq, void* dk, void* dv, float* delta,
                    const long long* st, int B, int S, int Skv, int Hq,
                    int Hk, int hd, int causal, int window, cudaStream_t s) {
  // hd 112 on the hd-128 tile, as the forward (flash_fwd_tc)
  switch (hd) {
#define REPRO_HD(N)                                                         \
  case N:                                                                   \
    return launch_bwd_tc<N == 112 ? 128 : N, N>(                            \
        q, k, v, o, lse, d_o, dq, dk, dv, delta, st, B, S, Skv, Hq, Hk,     \
        causal, window, s);
    REPRO_HD(16)
    REPRO_HD(32)
    REPRO_HD(64)
    REPRO_HD(112)
    REPRO_HD(128)
#undef REPRO_HD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (B, S, Hq, hd); k, v: (B, Skv, Hk, hd), Hq a multiple of Hk, each
// read through its element strides (batch, sequence, head) with a unit
// stride over hd; o: (B, S, Hq, hd) contiguous. Query and key positions
// both count from 0; Skv != S (cross-attention) only without causality
// or a window. lse: null (serving), or (B, Hq, S) fp32, which then
// receives each row's L = ln(sum_j exp(s_j)) for the backward (training).
// dtype 0 is fp32 (CUDA cores), 1 bf16 (tensor cores: every base 16-byte
// aligned and every stride of a dim of extent > 1 a multiple of 8
// elements); hd is 16, 32, 64, 112 or 128; window 0 means none. Returns
// cudaGetLastError() after the launch on `stream`, cudaErrorInvalidValue
// for another dtype or hd or a mask with Skv != S, -(CUresult) if a
// tensor map cannot be encoded and -1000 if libcuda has no
// cuTensorMapEncodeTiled.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, void* lse,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, int B, int S,
    int Skv, int Hq, int Hk, int hd, int causal, int window, int dtype,
    void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (Skv != S && (causal || window > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_hd<false>(q, k, v, o, l, st, B, S, Skv, Hq, Hk, hd,
                              causal, window, s);
  if (dtype == 1)
    return dispatch_hd<true>(q, k, v, o, l, st, B, S, Skv, Hq, Hk, hd,
                             causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward of repro_flash_attention (training). q (B, S, Hq, hd), k
// and v (B, Skv, Hk, hd) as given to it (each through its strides, unit
// over hd; Skv != S only without causality or a window), o its output
// and lse what it wrote; d_o (B, S, Hq, hd) through its strides (dsb, dss,
// dsh). Writes dq (B, S, Hq, hd), dk and dv (B, Skv, Hk, hd), contiguous,
// in the inputs' dtype (0 fp32 on CUDA cores, 1 bf16 on the tensor cores:
// every base and used stride of q, k, v and d_o a multiple of 16 bytes),
// and uses delta, fp32 scratch of 2 B Hq S_pad floats, S_pad = S rounded
// up to a multiple of 64 (fp32: D = dO . O as (B, Hq, S); bf16: (L log2 e,
// D) pairs as (B, Hq, S_pad, 2)). Two launches (dQ, then dK and dV; bf16's
// second in clusters); returns cudaGetLastError() after each,
// cudaErrorInvalidValue for another dtype or hd or a mask with Skv != S,
// -(CUresult) if a tensor map cannot be encoded and -1000 if libcuda has
// no cuTensorMapEncodeTiled.
extern "C" int repro_flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* d_o, void* dq, void* dk, void* dv,
    void* delta, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss, long long vsh,
    long long dsb, long long dss, long long dsh, int B, int S, int Skv,
    int Hq, int Hk, int hd, int causal, int window, int dtype, void* stream) {
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, dsb, dss, dsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (Skv != S && (causal || window > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_bwd_f32(q, k, v, o, l, d_o, dq, dk, dv, dl, st, B, S, Skv,
                            Hq, Hk, hd, causal, window, s);
  if (dtype == 1)
    return dispatch_bwd_tc(q, k, v, o, l, d_o, dq, dk, dv, dl, st, B, S, Skv,
                           Hq, Hk, hd, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
