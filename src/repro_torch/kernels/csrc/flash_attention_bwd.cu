// Flash-attention backward for Hopper (sm_90a) on the tensor cores: dq,
// and dk / dv per q head, of causal / sliding-window / GQA attention with
// bf16 q, k, v, dO, any Sq and Skv.  (float32 operands go to the
// CUDA-core kernels of flash_attention_bwd_fma.cu; the binding chooses by
// dtype.)
//
// Replaces the Pallas TPU kernels repro/kernels/flash_attention.py:152
// (_dq_kernel) and :192 (_dkv_kernel), both via _bwd_impl.  They are the
// FlashAttention-2 recompute backward: with D = rowsum(dO o) (computed by
// the wrapper, as the reference computes it outside its kernels),
//   p  = exp(q k^T scale - lse)        ds = p (dO v^T - D)
//   dq = ds k scale                    dk = ds^T q scale    dv = p^T dO
// and no (Sq, Skv) tensor ever reaches device memory.  There, a
// sequential grid axis carried dq (kv innermost) or dk, dv (q innermost)
// in VMEM.  Blocks on Hopper run in no order, so here
//   * flash_dq_kernel (#6): one block (one warpgroup) per (batch, q head,
//     64-row q tile) walks the live 64-key tiles with dq in registers;
//   * flash_dkv_kernel (#7): one block per (batch, q head, 64-key tile)
//     walks the live q tiles (64 rows; 32 at D = 128) with dk and dv in
//     registers, and writes them per q head in float32; the wrapper sums
//     each kv group in a fixed order, as the reference sums outside its
//     kernel.
// No float atomics anywhere, so a training step repeats bitwise.
//
// Precision.  The reference computes every product in float32.  q k^T and
// dO v^T have bf16 operands: wgmma forms the products exactly and sums
// them into float32 accumulators; the softmax scale is applied to the
// float32 sum (q scale is not bf16-exact at D = 32 or 128).  p = 2^(s
// scale log2 e - lse log2 e) is formed in float32 by one FMA and the
// special-function unit's ex2 (relative error about 2^-22).  The products
// on p and ds (#6: ds k; #7: p^T dO and ds^T q) have one float32
// operand.  Each float32 x splits exactly into three bf16 terms (split3 of
// wgmma.cuh: hi is x cut to bf16, mid the same of x - hi, lo of x - hi - mid;
// exact for |x| above 2^-110), so three wgmma products against the bf16
// operand are the float32 product's exact parts.  No TF32, and p or ds
// is never cast to a single bf16.  What the kernels do not match is the
// rounding of the sums: the tensor cores add a wgmma's products into the
// float32 accumulator by their own rules, not as a chain of float32 FMAs.
// At smollm's training shape dk and dv lie 3.4e-5 and 6.6e-5 from a
// float64 recompute, the plain float32 version 1.0e-5 and 1.7e-5; a
// build with expf in place of ex2 (-DFLASH_BWD_EXPF) errs as much (dk
// alike to four digits, dv 6.57e-5) and takes 20 % (#6) and 10 % (#7)
// longer (chip_flash_bwd_exp.py on an H100 80GB HBM3 at 700 W).  Phase
// 14 holds them to 2e-4 + 2e-5 |d|.
//
// What bounds them on the H100.  At smollm-135m's training shape (B = 8,
// Hq = 9, S = 2048, D = 64, causal) #6 runs 38.7 GFLOP of bf16 products
// and 19.3 GFLOP of float32-by-bf16 ones, three tensor-core products each
// (97 GFLOP of tensor-core work, 0.098 ms at 989 TFLOP/s); #7 38.7 and
// 38.7 (155 GFLOP, 0.156 ms).  The bytes (70 and 127 MB) take 0.02 and
// 0.04 ms.  Measured, they take about twice that (0.21 and 0.36 ms on an
// H100 80GB HBM3 at 700 W, chip_smoke.py phase 14), and what holds them
// there is the instruction count, not the tensor cores: beside their 20
// and 32 wgmma the kernels' SASS holds some 1,400 (#6) and 1,900 (#7)
// instructions (the exp, the mask, ds, the split, addresses; phase 14
// prints the counts).  Cutting them (the exp to two instructions,
// the split's conversions) cut the time in proportion; occupancy and
// ring depth did not move it.  What the design does:
//   * Every product is a wgmma m64nNk16 with float32 accumulators: S and
//     dP (#6), S^T and dP^T (#7) with both operands in shared memory; the
//     split products with A (the three bf16 terms of ds, p^T or ds^T)
//     from registers, where the accumulator of S or dP already lies in
//     the A-fragment layout, and B (K in #6, dO and Q in #7) read
//     transposed from the same tile through an MN-major descriptor.
//   * Tiles live in shared memory in bf16, in the 128-byte swizzle (64
//     at D = 32) that the descriptors name.  The tile that the block walks
//     (K and V in #6; Q, dO, lse and dsum in #7) arrives through a ring
//     of two stages: cp.async into the swizzled layout, completion counted
//     by one mbarrier per stage, the next tile's copy in flight while the
//     current one is used.  Q and dO (#6), K and V (#7) stay resident.
//   * The elementwise work runs while wgmma groups are in flight: p while
//     dP is computed, and in #7 ds while dV is.  The mask is applied only
//     on tiles that the diagonal, the window edge or the ragged Sq / Skv
//     edge crosses; tiles that the reference's _tile_live rules out are
//     never visited.  Under a causal mask the heaviest tiles are launched
//     first.
//   * One warpgroup per block, 2 to 3 blocks per SM by registers (150
//     and 212 a thread at D = 64, no spills).
// The prob_bf16 variant of #7 (PB, the perf flag: the reference's jnp
// route under it, differentiated with the cast passed straight through)
// multiplies dv += p^T dO with p^T rounded to the nearest bf16, one wgmma
// in place of three; ds, and with it dk and #6's dq, keep the float32 p.
// Launches and grids do not change; the default variant's code is
// untouched by the switch.
// Masking: p is set to 0 on every masked entry.  The reference computes
// exp(-1e30 - lse) there, which is 1 on a row with no live key (its lse
// is -1e30) and gives that row a spurious gradient; a row that sees at
// least one key (every row of causal training) gets the same p in both.
// Head sizes 32, 64, 128 and 256; the Python wrapper zero-pads the others
// up to the next.  At D = 256 one 64-row tile of dq is 128 registers a
// thread, and dk and dv of 64 keys would be 256, so:
//   * #6 walks 32-key tiles (KN; 64 at the smaller heads): S and dP are
//     16 registers each beside dq's 128; Q and dO stay resident (64 KB),
//     K and V come in two stages of 32 KB;
//   * #7 splits the head's columns in two (NH blocks a key tile): each
//     block keeps dk and dv of 64 keys x 128 columns (128 registers, as at
//     D = 128), reads K and V whole, since S^T = K Q^T and dP^T = V dO^T
//     reduce over all 256 columns, and walks 32-row q tiles.  So S^T and
//     dP^T are formed once per half: 1.25x the tensor-core work that the
//     bound counts (2 products once + 2 three times = 8 units; the kernel
//     does 10).  Still one launch, no atomics: a step repeats bit for bit.
// One block holds an SM at D = 256 (about 132 KB of shared memory).

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 128;  // one warpgroup
constexpr int kBM = 64;        // #6: q rows and keys a tile; #7: keys
constexpr int kStages = 2;     // depth of the ring

// ---------------------------------------------------------------------
// #6: dq.  Shared memory: Q, dO (64 x D), then per stage K, V (KN x D),
// then one mbarrier per stage; 1024 bytes of slack align the tiles.

template <int D>
__host__ __device__ constexpr int dq_keys() {
  return D == 256 ? 32 : 64;  // KN: dq alone is 128 registers at D = 256
}

template <int D>
__host__ __device__ constexpr int dq_smem_bytes() {
  return 1024 + 2 * kBM * D * 2 + 2 * kStages * dq_keys<D>() * D * 2 +
         8 * kStages;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ dsum, bf16* __restrict__ dq,
                int hq, int hkv, int sq, int skv, int causal, int window,
                int q_offset, float scale, int n_qtiles) {
  using G = Swz<D>;
  constexpr int KN = dq_keys<D>();  // keys a kv tile
  constexpr int kTile = kBM * D * 2, kTileK = KN * D * 2;
  constexpr int NB = G::kBlocks, NC = G::kCols;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t s_q = base, s_do = base + kTile;
  const uint32_t bars = base + 2 * kTile + 2 * kStages * kTileK;
  auto s_k = [&](int st) { return base + 2 * kTile + 2 * st * kTileK; };
  auto s_v = [&](int st) { return s_k(st) + kTileK; };

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int iq = causal ? n_qtiles - 1 - blockIdx.x : blockIdx.x;
  const int ih = blockIdx.y;
  const int ib = blockIdx.z;
  const int ikv = ih / (hq / hkv);
  const int q0 = iq * kBM;
  const int64_t q_head = (static_cast<int64_t>(ib) * hq + ih) * sq;
  const bf16* kp = k + (static_cast<int64_t>(ib) * hkv + ikv) * skv * D;
  const bf16* vp = v + (static_cast<int64_t>(ib) * hkv + ikv) * skv * D;

  // the live kv range of this q tile (the reference's _tile_live)
  const int q_first = q_offset + q0;
  const int q_last = q_first + kBM - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) / KN * KN
                                 : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + KN - 1) / KN : 0;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bars + 8 * st, kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (n_tiles > 0) {  // Q and dO land with the first kv tile
    load_tile<D, kBM>(s_q, q + q_head * D, q0, sq, tid);
    load_tile<D, kBM>(s_do, dout + q_head * D, q0, sq, tid);
  }
  for (int t = 0; t < kStages - 1 && t < n_tiles; ++t) {
    load_tile<D, KN>(s_k(t), kp, k_begin + t * KN, skv, tid);
    load_tile<D, KN>(s_v(t), vp, k_begin + t * KN, skv, tid);
    cp_async_arrive(bars + 8 * t);
  }

  // this thread's rows of the tile: r_lo and r_lo + 8
  const int r_lo = 16 * warp + lane / 4;
  // p = exp(s scale - lse) = 2^(s scale log2 e - lse log2 e)
  const float scale2 = scale * kExpUnit;
  float row_lse[2], row_d[2];  // row_lse times kExpUnit
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r_lo + 8 * i;
    row_lse[i] = row < sq ? lse[q_head + row] * kExpUnit : 0.f;
    row_d[i] = row < sq ? dsum[q_head + row] : 0.f;
  }
  float acc[NB][NC / 2];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int c = 0; c < NC / 2; ++c) acc[b][c] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * KN;
    const int st = it % kStages;
    if (it + kStages - 1 < n_tiles) {
      __syncthreads();  // every warp is done with the stage refilled here
      const int nx = (it + kStages - 1) % kStages;
      const int kn = k0 + (kStages - 1) * KN;
      load_tile<D, KN>(s_k(nx), kp, kn, skv, tid);
      load_tile<D, KN>(s_v(nx), vp, kn, skv, tid);
      cp_async_arrive(bars + 8 * nx);
    }
    mbar_wait(bars + 8 * st, (it / kStages) & 1);
    fence_proxy_async();

    // s = q k^T and dp = dO v^T: rows of the q tile, the tile's KN keys
    float s[KN / 2], dp[KN / 2];  // the first product overwrites them
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss(s, desc_k<D, kBM>(s_q, kk), desc_k<D, KN>(s_k(st), kk), kk);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss(dp, desc_k<D, kBM>(s_do, kk), desc_k<D, KN>(s_v(st), kk),
             kk);
    wg_commit();
    fence_regs(dp);
    wg_wait<1>();  // s is done; dp may still run
    fence_regs(s);

    // p on live entries, else 0, in place of s; the mask only where the
    // diagonal, the window edge or the end of the keys crosses the tile
    const bool edge = k0 + KN > skv || (causal && q_first < k0 + KN - 1) ||
                      (window > 0 && k0 <= q_last - window);
    if (edge) {
#pragma unroll
      for (int at = 0; at < KN / 2; ++at) {  // at = 4 n8 + 2 i + j
        const int i = at / 2 % 2;
        s[at] = live(q_first + r_lo + 8 * i,
                     k0 + 8 * (at / 4) + 2 * (lane % 4) + at % 2, skv,
                     causal, window)
                    ? exp_p(fmaf(s[at], scale2, -row_lse[i]))
                    : 0.f;
      }
    } else {
#pragma unroll
      for (int at = 0; at < KN / 2; ++at)
        s[at] = exp_p(fmaf(s[at], scale2, -row_lse[at / 2 % 2]));
    }
    wg_wait();
    fence_regs(dp);
    // ds = p (dp - D) in place of dp
#pragma unroll
    for (int at = 0; at < KN / 2; ++at)
      dp[at] = s[at] * (dp[at] - row_d[at / 2 % 2]);

    // dq += ds k: ds from registers in three bf16 terms, k transposed
    uint32_t f[3][KN / 16][4];
    split_frags<KN>(dp, f);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < KN / 16; ++kc)
#pragma unroll
      for (int part = 0; part < 3; ++part)
#pragma unroll
        for (int b = 0; b < NB; ++b)
          mma_rs(acc[b], f[part][kc], desc_mn<D, KN>(s_k(st), kc, b));
    wg_commit();
    wg_wait();
#pragma unroll
    for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
    fence_frags(f);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r_lo + 8 * i;
    if (row >= sq) continue;
    bf16* dst = dq + (q_head + row) * D + 2 * (lane % 4);
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int n8 = 0; n8 < NC / 8; ++n8)
        *reinterpret_cast<__nv_bfloat162*>(dst + b * NC + 8 * n8) =
            __floats2bfloat162_rn(acc[b][4 * n8 + 2 * i] * scale,
                                  acc[b][4 * n8 + 2 * i + 1] * scale);
  }
}

// ---------------------------------------------------------------------
// #7: dk, dv per q head.  Shared memory: K, V (64 x D), then per stage Q,
// dO (NQ x D), then per stage lse, dsum (NQ floats each), then one
// mbarrier per stage.  At D = 256 a block holds dk and dv of one half of
// the head's columns (NH = 2 blocks a key tile, blockIdx.y = NH x q head
// + half): 64 keys x 256 columns of both would be 256 registers a thread.

template <int D>
__host__ __device__ constexpr int dkv_rows() {
  return D >= 128 ? 32 : 64;  // NQ: 64 rows spill registers at D = 128
}

template <int D>
__host__ __device__ constexpr int dkv_parts() {
  return D == 256 ? 2 : 1;  // NH: column halves of dk and dv
}

template <int D>
__host__ __device__ constexpr int dkv_smem_bytes() {
  return 1024 + 2 * kBM * D * 2 +
         kStages * (2 * dkv_rows<D>() * D * 2 + 8 * dkv_rows<D>()) +
         8 * kStages;
}

template <int D, bool PB>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ dsum, float* __restrict__ dk,
                 float* __restrict__ dv, int hq, int hkv, int sq, int skv,
                 int causal, int window, int q_offset, float scale) {
  using G = Swz<D>;
  constexpr int NQ = dkv_rows<D>();  // q rows a step
  constexpr int NH = dkv_parts<D>();
  constexpr int kTileK = kBM * D * 2, kTileQ = NQ * D * 2;
  // NB: the column blocks of dk and dv that this block holds
  constexpr int NB = G::kBlocks / NH, NC = G::kCols;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t s_k = base, s_v = base + kTileK;
  const uint32_t s_rows = base + 2 * kTileK + 2 * kStages * kTileQ;
  const uint32_t bars = s_rows + kStages * 8 * NQ;
  auto s_q = [&](int st) { return base + 2 * kTileK + 2 * st * kTileQ; };
  auto s_do = [&](int st) { return s_q(st) + kTileQ; };
  auto s_lse = [&](int st) { return s_rows + 8 * NQ * st; };

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * kBM;  // under a causal mask the first key
  const int ih = blockIdx.y / NH;   // tiles see the most rows: first out
  const int c0 = blockIdx.y % NH * NB;  // this block's first column block
  const int ib = blockIdx.z;
  const int ikv = ih / (hq / hkv);
  const int64_t q_head = (static_cast<int64_t>(ib) * hq + ih) * sq;
  const int64_t kv_head = (static_cast<int64_t>(ib) * hkv + ikv) * skv;
  const bf16* qp = q + q_head * D;
  const bf16* dop = dout + q_head * D;

  // the live q rows of this kv tile: a query at position p sees key j
  // iff p >= j (causal) and p < j + window
  const int k_last = min(skv, k0 + kBM) - 1;
  const int i_begin = causal ? max(0, k0 - q_offset) : 0;
  const int i_end =
      window > 0 ? min(sq, max(0, k_last + window - q_offset)) : sq;
  const int n_tiles = i_end > i_begin ? (i_end - i_begin + NQ - 1) / NQ : 0;

  // lse (threads 0 ..) and dsum (64 ..) of rows [i0, i0 + NQ) into
  // stage st; 0 past Sq
  auto load_rows = [&](int st, int i0) {
    const int t = tid % 64, row = i0 + t;
    const bool ok = row < sq;
    if (t < NQ)
      cp_async4(s_lse(st) + 4 * (tid < 64 ? t : NQ + t),
                (tid < 64 ? lse : dsum) + q_head + (ok ? row : 0), ok);
  };

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bars + 8 * st, kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (n_tiles > 0) {  // K and V land with the first q tile
    load_tile<D, kBM>(s_k, k + kv_head * D, k0, skv, tid);
    load_tile<D, kBM>(s_v, v + kv_head * D, k0, skv, tid);
  }
  for (int t = 0; t < kStages - 1 && t < n_tiles; ++t) {
    load_tile<D, NQ>(s_q(t), qp, i_begin + t * NQ, sq, tid);
    load_tile<D, NQ>(s_do(t), dop, i_begin + t * NQ, sq, tid);
    load_rows(t, i_begin + t * NQ);
    cp_async_arrive(bars + 8 * t);
  }

  // this thread's keys of the tile: key_lo and key_lo + 8
  const int key_lo = k0 + 16 * warp + lane / 4;
  const float scale2 = scale * kExpUnit;  // p = exp_p(s scale2 - lse kExpUnit)
  float dk_acc[NB][NC / 2], dv_acc[NB][NC / 2];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int c = 0; c < NC / 2; ++c) dk_acc[b][c] = dv_acc[b][c] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = i_begin + it * NQ;
    const int st = it % kStages;
    if (it + kStages - 1 < n_tiles) {
      __syncthreads();  // every warp is done with the stage refilled here
      const int nx = (it + kStages - 1) % kStages;
      const int in = i0 + (kStages - 1) * NQ;
      load_tile<D, NQ>(s_q(nx), qp, in, sq, tid);
      load_tile<D, NQ>(s_do(nx), dop, in, sq, tid);
      load_rows(nx, in);
      cp_async_arrive(bars + 8 * nx);
    }
    mbar_wait(bars + 8 * st, (it / kStages) & 1);
    fence_proxy_async();

    // s^T = k q^T and dp^T = v dO^T: the tile's keys, rows i0 ..
    float s[NQ / 2], dp[NQ / 2];  // the first product overwrites them
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss(s, desc_k<D, kBM>(s_k, kk), desc_k<D, NQ>(s_q(st), kk), kk);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss(dp, desc_k<D, kBM>(s_v, kk), desc_k<D, NQ>(s_do(st), kk), kk);
    wg_commit();
    fence_regs(dp);
    wg_wait<1>();  // s^T is done; dp^T may still run
    fence_regs(s);

    // p^T in place of s^T
    const bool edge = i0 + NQ > sq || k0 + kBM > skv ||
                      (causal && q_offset + i0 < k0 + kBM - 1) ||
                      (window > 0 && k0 <= q_offset + i0 + NQ - 1 - window);
    // lse and dsum of this thread's columns 8 n8 + 2 (lane % 4) + j:
    // float2 (lse[st][c], lse[st][c + 1]) at rows[4 n8 + lane % 4],
    // dsum's NQ / 2 further; lse in units of log2
    const float2* rows =
        reinterpret_cast<const float2*>(smem_raw + (s_lse(st) - raw));
    float col_lse[NQ / 4];
#pragma unroll
    for (int n8 = 0; n8 < NQ / 8; ++n8) {
      const float2 l = rows[4 * n8 + lane % 4];
      col_lse[2 * n8] = l.x * kExpUnit;
      col_lse[2 * n8 + 1] = l.y * kExpUnit;
    }
    if (edge) {
#pragma unroll
      for (int at = 0; at < NQ / 2; ++at) {  // at = 4 n8 + 2 i + j
        const int col = 8 * (at / 4) + 2 * (lane % 4) + at % 2;
        s[at] = i0 + col < sq && live(q_offset + i0 + col,
                                      key_lo + 8 * (at / 2 % 2), skv,
                                      causal, window)
                    ? exp_p(fmaf(s[at], scale2,
                                       -col_lse[2 * (at / 4) + at % 2]))
                    : 0.f;
      }
    } else {
#pragma unroll
      for (int at = 0; at < NQ / 2; ++at)
        s[at] = exp_p(
            fmaf(s[at], scale2, -col_lse[2 * (at / 4) + at % 2]));
    }

    // dv += p^T dO: p^T from registers in three bf16 terms (PB: one, p^T
    // rounded to nearest), dO transposed
    constexpr int kParts = PB ? 1 : 3;
    uint32_t fp[kParts][NQ / 16][4], fs[3][NQ / 16][4];
    if constexpr (PB)
      round_frags<NQ>(s, fp);
    else
      split_frags<NQ>(s, fp);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < NQ / 16; ++kc)
#pragma unroll
      for (int part = 0; part < kParts; ++part)
#pragma unroll
        for (int b = 0; b < NB; ++b)
          mma_rs(dv_acc[b], fp[part][kc],
                 desc_mn<D, NQ>(s_do(st), kc, c0 + b));
    wg_commit();
#pragma unroll
    for (int b = 0; b < NB; ++b) fence_regs(dv_acc[b]);
    wg_wait<1>();  // dp^T is done; dv may still run
    fence_regs(dp);

    // ds^T in place of dp^T, while dv runs; then dk += ds^T q
#pragma unroll
    for (int n8 = 0; n8 < NQ / 8; ++n8) {
      const float2 dd = rows[NQ / 2 + 4 * n8 + lane % 4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int at = 4 * n8 + 2 * i;
        dp[at] = s[at] * (dp[at] - dd.x);
        dp[at + 1] = s[at + 1] * (dp[at + 1] - dd.y);
      }
    }
    split_frags<NQ>(dp, fs);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < NQ / 16; ++kc)
#pragma unroll
      for (int part = 0; part < 3; ++part)
#pragma unroll
        for (int b = 0; b < NB; ++b)
          mma_rs(dk_acc[b], fs[part][kc],
                 desc_mn<D, NQ>(s_q(st), kc, c0 + b));
    wg_commit();
    wg_wait();
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      fence_regs(dk_acc[b]);
      fence_regs(dv_acc[b]);
    }
    fence_frags(fp);
    fence_frags(fs);
  }

  // per q head, float32; keys no q row sees get 0
  const int64_t out_head = (static_cast<int64_t>(ib) * hq + ih) * skv;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key_lo + 8 * i;
    if (key >= skv) continue;
    const int64_t at = (out_head + key) * D + c0 * NC + 2 * (lane % 4);
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int n8 = 0; n8 < NC / 8; ++n8) {
        const int c = 4 * n8 + 2 * i;
        *reinterpret_cast<float2*>(dk + at + b * NC + 8 * n8) =
            make_float2(dk_acc[b][c] * scale, dk_acc[b][c + 1] * scale);
        *reinterpret_cast<float2*>(dv + at + b * NC + 8 * n8) =
            make_float2(dv_acc[b][c], dv_acc[b][c + 1]);
      }
  }
}

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;
  const float* dsum;
  int b, hq, hkv, sq, skv, causal, window, q_offset;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dq(const Args& a, bf16* dq) {
  constexpr int bytes = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const int n_qtiles = (a.sq + kBM - 1) / kBM;
  const dim3 grid(n_qtiles, a.hq, a.b);
  flash_dq_kernel<D><<<grid, kThreads, bytes, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.dsum, dq, a.hq, a.hkv, a.sq, a.skv,
      a.causal, a.window, a.q_offset, a.scale, n_qtiles);
  return cudaGetLastError();
}

template <int D, bool PB>
cudaError_t launch_dkv(const Args& a, float* dk, float* dv) {
  constexpr int bytes = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel<D, PB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.skv + kBM - 1) / kBM, a.hq * dkv_parts<D>(), a.b);
  flash_dkv_kernel<D, PB><<<grid, kThreads, bytes, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.dsum, dk, dv, a.hq, a.hkv, a.sq,
      a.skv, a.causal, a.window, a.q_offset, a.scale);
  return cudaGetLastError();
}

template <bool PB>
cudaError_t dispatch_dkv(const Args& a, int d, float* dk, float* dv) {
  switch (d) {
    case 32:
      return launch_dkv<32, PB>(a, dk, dv);
    case 64:
      return launch_dkv<64, PB>(a, dk, dv);
    case 128:
      return launch_dkv<128, PB>(a, dk, dv);
    case 256:
      return launch_dkv<256, PB>(a, dk, dv);
    default:
      return cudaErrorInvalidValue;
  }
}

bool valid(int b, int hq, int hkv, int sq, int skv) {
  return b > 0 && sq > 0 && skv > 0 && hkv > 0 && hq % hkv == 0;
}

}  // namespace

// q, dout (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D), contiguous bfloat16,
// rows 16-byte aligned; lse and dsum (B, Hq, Sq) float32; dq like q.
// window <= 0 means none.  D in {32, 64, 128, 256}.
cudaError_t flash_attention_dq(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* dsum, void* dq, int b, int hq,
                               int hkv, int sq, int skv, int d, int causal,
                               int window, int q_offset, float scale,
                               cudaStream_t stream) {
  if (!valid(b, hq, hkv, sq, skv)) return cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
               lse, dsum, b, hq, hkv, sq, skv, causal, window, q_offset,
               scale, stream};
  bf16* out = static_cast<bf16*>(dq);
  switch (d) {
    case 32:
      return launch_dq<32>(a, out);
    case 64:
      return launch_dq<64>(a, out);
    case 128:
      return launch_dq<128>(a, out);
    case 256:
      return launch_dq<256>(a, out);
    default:
      return cudaErrorInvalidValue;
  }
}

// Inputs as flash_attention_dq; dk and dv (B, Hq, Skv, D) float32, per q
// head.  prob_bf16 != 0: the flag's variant (dv from bf16 p).
cudaError_t flash_attention_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* dsum, float* dk, float* dv,
                                int b, int hq, int hkv, int sq, int skv,
                                int d, int causal, int window, int q_offset,
                                float scale, int prob_bf16,
                                cudaStream_t stream) {
  if (!valid(b, hq, hkv, sq, skv)) return cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
               lse, dsum, b, hq, hkv, sq, skv, causal, window, q_offset,
               scale, stream};
  return prob_bf16 ? dispatch_dkv<true>(a, d, dk, dv)
                   : dispatch_dkv<false>(a, d, dk, dv);
}
