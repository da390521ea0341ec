// Hopper (sm_90a) building blocks of the port's tensor-core kernels: the
// flash-attention forward (flash_attention.cu, #5), its backward
// (flash_attention_bwd.cu, #6 and #7), the SSD chunked scan (ssd_scan.cu,
// #8) and its backward (ssd_scan_bwd.cu, 8').  Plain CUDA C++ with no
// PyTorch header, included by each of those sources; everything is in an
// anonymous namespace, so each translation unit keeps its own copy.
//
//   * Swizzled bf16 tiles in shared memory and the wgmma descriptors that
//     read them, K-major or MN-major (transposed);
//   * cp.async copies counted by an mbarrier per ring stage;
//   * the wgmma issue, commit and wait, m64n64k16 and m64n32k16 with
//     float32 accumulators, A from shared memory or from registers;
//   * split3 / split_frags: the exact three-way bf16 split of a float32
//     operand, so that three bf16 products give the float32 product;
//     round_frags and scale_tile: the single bf16 roundings of the
//     prob_bf16 variants of #5 and #7; slice_frags, either of one 16-column
//     slice (#5 at D = 256);
//   * exp_p, the special-function unit's ex2;
//   * the SSD kernels' in-chunk float64 cumsum and their split stores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarpgroup = 128;  // the threads of one wgmma

// ---------------------------------------------------------------------
// Shared-memory tiles.  A tile of R rows of D bf16 is stored as D / C
// column blocks of R rows x C columns (C = 64, rows of 128 bytes, the
// 128-byte swizzle; C = 32 at D = 32, the 64-byte swizzle): the 16-byte
// chunk c of row r of a block sits at chunk c ^ (r % 8) (c ^ (r / 2 % 4)).
// Read with the rows along M or N and the columns along K, the tile is a
// K-major wgmma operand; read with the rows along K and the columns along
// M or N, the same bytes are an MN-major (transposed) one.

template <int D>
struct Swz {
  static constexpr int kCols = D >= 64 ? 64 : 32;        // C
  static constexpr int kRowBytes = 2 * kCols;
  static constexpr int kAtom = 8 * kRowBytes;            // 8 rows
  static constexpr uint64_t kLayout = D >= 64 ? 1 : 2;   // SW128, SW64
  static constexpr int kBlocks = D / kCols;
};

// Byte offset of 16-byte chunk ch (of D / 8) of row r in an R-row tile.
template <int D, int R>
__device__ __forceinline__ uint32_t chunk_off(int r, int ch) {
  using G = Swz<D>;
  constexpr int cpr = G::kCols / 8;
  const int sw = G::kCols == 64 ? (r & 7) : ((r >> 1) & 3);
  return (ch / cpr) * R * G::kRowBytes + r * G::kRowBytes +
         (((ch % cpr) ^ sw) << 4);
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

// The K-major operand of columns 16 kk .. 16 kk + 15 of an R-row tile.
template <int D, int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using G = Swz<D>;
  const int col = 16 * kk;
  return make_desc(tile + (col / G::kCols) * R * G::kRowBytes +
                       (col % G::kCols) * 2,
                   16, G::kAtom, G::kLayout);
}

// The MN-major operand of rows 16 kc .. 16 kc + 15 (along K) and column
// block blk (along M or N) of an R-row tile.
template <int D, int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kc, int blk) {
  using G = Swz<D>;
  return make_desc(tile + blk * R * G::kRowBytes + 16 * kc * G::kRowBytes,
                   G::kAtom, G::kAtom, G::kLayout);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------
// Asynchronous copies and their barriers.

// 16 bytes global -> shared; zero-filled where !ok (src is not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

// Waits until every cp.async this thread has started has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Arrive on bar once every cp.async this thread has started has landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// cp.async and st.shared write through the generic proxy, wgmma reads
// through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [r0, r0 + R) of a row-major (n, D) bf16 matrix whose rows lie ld
// elements apart into a swizzled tile, by the block's Threads threads;
// rows at or past n are zero.
template <int D, int R, int Threads = kWarpgroup>
__device__ __forceinline__ void load_tile(uint32_t tile,
                                          const bf16* __restrict__ src,
                                          int r0, int n, int tid,
                                          int64_t ld = D) {
  constexpr int cpr = D / 8;
  constexpr int per = R * cpr / Threads;
  static_assert(per * Threads == R * cpr, "tile does not split");
#pragma unroll
  for (int i = 0; i < per; ++i) {
    const int e = tid + i * Threads;
    const int r = e / cpr, ch = e % cpr;
    const bool ok = r0 + r < n;
    cp_async16(tile + chunk_off<D, R>(r, ch),
               src + (ok ? static_cast<int64_t>(r0 + r) * ld + ch * 8 : 0),
               ok);
  }
}

// ---------------------------------------------------------------------
// wgmma.  Accumulators of an m64nN tile: thread t of the warpgroup holds
// rows 16 (t / 32) + t % 32 / 4 + 8 i and columns 8 n8 + 2 (t % 4) + j in
// d[4 n8 + 2 i + j].

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups are still in flight.
template <int N = 0>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving register reads and writes across a
// wgmma that is still in flight.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= A B, m64n64k16, A and B from shared memory, K-major unless TA
// (A) or TB (B) is 1, then MN-major; acc = 0 overwrites d.
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

// d += A B, m64n64k16, A from registers (four bf16x2), B from shared
// memory MN-major (transposed).
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// d (+)= A B, m64n32k16, A and B from shared memory (K-major);
// acc = 0 overwrites d.
__device__ __forceinline__ void mma_ss_n32(float (&d)[16], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

// d += A B, m64n32k16, A from registers (four bf16x2), B from shared
// memory MN-major (transposed).
__device__ __forceinline__ void mma_rs_n32(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// The wgmma of an accumulator's width, N = 64 or 32: #7's q step at
// D = 128, and the split products' width at D = 32.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a,
                                       uint64_t b, int acc) {
  mma_ss_n64(d, a, b, acc);
}
__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t a,
                                       uint64_t b, int acc) {
  mma_ss_n32(d, a, b, acc);
}
__device__ __forceinline__ void mma_rs(float (&d)[32],
                                       const uint32_t (&a)[4], uint64_t b) {
  mma_rs_n64(d, a, b);
}
__device__ __forceinline__ void mma_rs(float (&d)[16],
                                       const uint32_t (&a)[4], uint64_t b) {
  mma_rs_n32(d, a, b);
}

// The upper halves of a and b, the bf16 values that they truncate to,
// packed as a bf16x2 (a in the low half).
__device__ __forceinline__ uint32_t upper2(float a, float b) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, 0x7632;\n"
      : "=r"(d)
      : "r"(__float_as_uint(a)), "r"(__float_as_uint(b)));
  return d;
}

// x cut to its bf16 value (rounded toward zero), as a float.
__device__ __forceinline__ float cut(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
}

// The three bf16 terms of x0 and x1, each pair packed as a bf16x2 (x0 in
// the low half): hi = cut(x), mid = cut(x - hi), lo = cut(x - hi - mid).
// The differences are exact in float32 and hold 16 and then 8 bits of x's
// 24, so x = hi + mid + lo exactly for |x| >= 2^-110 (7.7e-34); below
// that, lo is a bf16 subnormal and drops x's bits under 2^-133.  Rounding
// toward zero splits as exactly as rounding to nearest would, with no
// conversion instructions.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = upper2(x0, x1);
  const float r0 = x0 - cut(x0), r1 = x1 - cut(x1);
  mid = upper2(r0, r1);
  lo = upper2(r0 - cut(r0), r1 - cut(r1));
}

// The wgmma A fragments of columns 16 kc .. 16 kc + 15 of an m64nN
// accumulator tile x, split: f[part][kc] for part hi, mid, lo.  The
// accumulator layout of columns 16 kc .. is the A layout of k16.
template <int N>
__device__ __forceinline__ void split_frags(const float (&x)[N / 2],
                                            uint32_t (&f)[3][N / 16][4]) {
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int at = 4 * (2 * kc + (r >> 1)) + 2 * (r & 1);
      split3(x[at], x[at + 1], f[0][kc][r], f[1][kc][r], f[2][kc][r]);
    }
}

// x0 and x1 rounded to the nearest bf16, packed as a bf16x2 (x0 in the
// low half).
__device__ __forceinline__ uint32_t round2(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The wgmma A fragments of columns 16 kc .. 16 kc + 15 of an m64nN
// accumulator tile x, each entry rounded to one bf16: p as the
// prob_bf16 variants of #5 and #7 multiply it (the reference's
// p.astype(bf16) under that flag).
template <int N>
__device__ __forceinline__ void round_frags(const float (&x)[N / 2],
                                            uint32_t (&f)[1][N / 16][4]) {
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int at = 4 * (2 * kc + (r >> 1)) + 2 * (r & 1);
      f[0][kc][r] = round2(x[at], x[at + 1]);
    }
}

template <int P, int M>
__device__ __forceinline__ void fence_frags(uint32_t (&f)[P][M][4]) {
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int kc = 0; kc < M; ++kc) fence_regs(f[p][kc]);
}
template <int P>
__device__ __forceinline__ void fence_frags(uint32_t (&f)[P][4]) {
#pragma unroll
  for (int p = 0; p < P; ++p) fence_regs(f[p]);
}

// The wgmma A fragment of columns 16 kc .. 16 kc + 15 of an m64nN
// accumulator tile x alone: its three bf16 terms (f[0], f[1], f[2], as
// split_frags), or with Round one term, x rounded to nearest (f[0], as
// round_frags).  #5 at D = 256 forms one slice at a time: its
// accumulator leaves no room for the whole tile's terms.
template <bool Round, int P, int H>
__device__ __forceinline__ void slice_frags(const float (&x)[H], int kc,
                                            uint32_t (&f)[P][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int at = 4 * (2 * kc + (r >> 1)) + 2 * (r & 1);
    if constexpr (Round)
      f[0][r] = round2(x[at], x[at + 1]);
    else
      split3(x[at], x[at + 1], f[0][r], f[1][r], f[2][r]);
  }
}

// The eight entries of x that slice_frags(x, kc) reads pass through an
// empty asm: the compiler does not form that slice's terms ahead of
// the wgmma issued before this point.
template <int H>
__device__ __forceinline__ void fence_slice(float (&x)[H], int kc) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int at = 4 * (2 * kc + (r >> 1)) + 2 * (r & 1);
    asm volatile("" : "+f"(x[at]), "+f"(x[at + 1])::"memory");
  }
}

// Rounds the R x D bf16 tile at shared address `tile` (`raw` the shared
// address of `smem`) in place to bf16(x scale), each entry from its
// float32 product, as the reference's prob_bf16 route rounds q scale.
// Entrywise, so the swizzle does not matter; the caller has waited for
// the tile, and afterwards fences it for the async proxy and syncs.
template <int R, int D, int Threads = kWarpgroup>
__device__ __forceinline__ void scale_tile(uint8_t* smem, uint32_t raw,
                                           uint32_t tile, float scale,
                                           int tid) {
  __nv_bfloat162* t =
      reinterpret_cast<__nv_bfloat162*>(smem + (tile - raw));
#pragma unroll 4
  for (int w = tid; w < R * D / 2; w += Threads) {
    const float2 x = __bfloat1622float2(t[w]);
    t[w] = __floats2bfloat162_rn(x.x * scale, x.y * scale);
  }
}

#ifndef FLASH_BWD_EXPF
// p = 2^x, x = s scale log2 e - m log2 e: kExpUnit scales the softmax
// scale and the row's max or lse, exp_p is the special-function unit's
// ex2 (one instruction, relative error about 2^-22; results below 2^-126
// are flushed to 0).
constexpr float kExpUnit = 1.4426950408889634f;  // log2 e
__device__ __forceinline__ float exp_p(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
#else
// Built with -DFLASH_BWD_EXPF (chip_flash_bwd_exp.py only): p = expf(s
// scale - lse), the exp of the CUDA-core kernels, to hold the ex2 against.
constexpr float kExpUnit = 1.f;
__device__ __forceinline__ float exp_p(float x) { return expf(x); }
#endif

// Whether query position q_pos sees key k_pos (attention masks).
__device__ __forceinline__ bool live(int q_pos, int k_pos, int skv,
                                     int causal, int window) {
  return k_pos < skv && (!causal || q_pos >= k_pos) &&
         (window <= 0 || k_pos > q_pos - window);
}

// ---------------------------------------------------------------------
// The SSD kernels (ssd_scan.cu, ssd_scan_bwd.cu).

constexpr int kSplitTile = 64 * 64 * 2;  // one bf16 term of a 64 x 64 tile

// The inclusive float64 cumsum of (float) dt a over qc rows, carry (the
// cumsum before them) added, into cum[], and dt into dts[], by one warp;
// dt_row is the first row's dt, its rows stride apart.  Returns the
// cumsum at the last row, the carry of the rows that follow: a chunk
// taken in tiles of rows, a multiple of 32 each, gets the same bits as in
// one call.
__device__ __forceinline__ double chunk_cumsum(double* cum, float* dts,
                                               const float* __restrict__ dt_row,
                                               int stride, float a, int qc,
                                               int lane, double carry) {
  for (int r0 = 0; r0 < qc; r0 += 32) {
    const int j = r0 + lane;
    const float d = j < qc ? dt_row[static_cast<int64_t>(j) * stride] : 0.f;
    double v = static_cast<double>(d * a);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double t = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += t;
    }
    v += carry;
    if (j < qc) {
      cum[j] = v;
      dts[j] = d;
    }
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
  return carry;
}

// Eight consecutive float32 values x0..x7 split into their three bf16
// terms, 16 bytes each, stored at chunk offset off of the three tiles
// part 0, 1, 2 (kSplitTile bytes apart) from tile.
__device__ __forceinline__ void store_split8(uint32_t tile, uint32_t off,
                                             const float (&x)[8]) {
  uint32_t t[3][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split3(x[2 * i], x[2 * i + 1], t[0][i], t[1][i], t[2][i]);
#pragma unroll
  for (int part = 0; part < 3; ++part)
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     tile + part * kSplitTile + off),
                 "r"(t[part][0]), "r"(t[part][1]), "r"(t[part][2]),
                 "r"(t[part][3])
                 : "memory");
}

}  // namespace
