// Backward of the Mamba-2 SSD chunked scan (#8) for Hopper (sm_90a) on the
// tensor cores: the gradients of x, dt, a_log, B, C, d_skip and the
// initial state, given dy and the final state's gradient, for bf16 x, B,
// C and dy.  (float32 operands go to the CUDA-core kernels of
// ssd_scan_bwd_fma.cu; the binding chooses by dtype.)
//
// It replaces no Pallas kernel: the reference's ssd_scan
// (repro/kernels/ssd_scan.py:31) has no custom_vjp, and the reference
// trains the SSD by autodiff of its jnp path (_ssd_jnp_chunked,
// repro/kernels/ops.py:145).  It computes what ssd_scan_bwd_fma.cu
// computes, mirrored by repro_torch.kernels.ref.ssd_scan_bwd_ref (terms=3
// emulates its split products).  Per (batch, head) and chunk, with cum
// the in-chunk cumsum of dt a (float64), L_ij = exp(cum_i - cum_j) for i
// >= j, w_j = exp(cum[Q-1] - cum_j), S_in the state entering the chunk, dS
// the gradient of the state leaving it, S = C B^T, G = dy x^T and M_ij =
// S_ij L_ij dt_j G_ij:
//     dS_in = exp(cum[Q-1]) dS + C^T (exp(cum) dy)
//     dx    = dt ((S L)^T dy + w (B dS)) + D dy
//     dC    = (G L dt_j) B + exp(cum) (dy S_in^T)
//     dB    = dt ((G L)^T C + w (x dS^T))
//     dcum  = rows of M less columns of M + exp(cum) dy.(C S_in)
//             - w dt x.(B dS) (+ exp(cum[Q-1]) <S_in, dS> + sum of the
//             last term, on row Q-1)
//     d(dt a) = reverse cumsum of dcum;  ddt = sum_i (S L G)_ij +
//             w x.(B dS) + a d(dt a);  d a_log = a sum dt d(dt a)
// Five kinds of launch on one stream (the wrapper counts them as one):
//   1. ssd_bwd_sums_kernel, per (batch, head, chunk, 64 columns of P,
//      product): the cumsum (into a float64 scratch), the chunk's own
//      state B^T (x dt w) or the pull of its output on its entering
//      state, C^T (exp(cum) dy): #8's phase 1 (ssd_states_kernel);
//   2. ssd_bwd_pass_kernel, one thread per (batch, head, 4 state entries):
//      the state passing in reverse from the final state's gradient (each
//      chunk's dS in place of its pull) and forward (each chunk's S_in in
//      place of its own state), the initial state's gradient, and <S_in,
//      dS> of every chunk as float64 partials, one per warp's 128 entries;
//   3. ssd_bwd_rows_kernel, per (batch, head, chunk, 64-row slab of i),
//      after #6 (flash_attention_bwd.cu, flash_dq_kernel): dC of the rows
//      (per head), their dcum term exp(cum_i) C_i.(dy S_in^T)_i, and M,
//      formed here and nowhere else: its row sums, and the column sums of
//      each 64 x 64 tile of it, over the key blocks j <= i;
//   4. ssd_bwd_cols_kernel, per (batch, head, chunk, 64-row slab of j),
//      after #7 (flash_dkv_kernel): dx, dB (per head) and the direct ddt
//      terms of the rows, over the slabs i >= j;
//   5. ssd_bwd_close_kernel, per (batch, head, chunk): <S_in, dS> from its
//      partials, the column sums of M from their slab partials, dcum's
//      reverse cumsum, ddt, and the chunk's partials of d a_log and
//      d d_skip.
// The group sums of dB and dC over heads and the (H,) parameter sums over
// batch and chunks are left to the wrapper (fixed-axis torch.sum).
//
// Precision.  S = C B^T and G = dy x^T have bf16 operands: wgmma forms
// the products exactly and sums them in float32.  Every other product has
// a float32 operand (x dt w, exp(cum) dy, S L, G L dt_j, G L, S_in, dS),
// and split3 (wgmma.cuh) cuts that operand exactly into three bf16 terms,
// so that three wgmma products are the float32 product's exact parts: as
// in #8 and #6 / #7, no TF32, and no float32 operand is ever cast to a
// single bf16.  A row scalar on the M or N axis (w, dt, exp(cum)) is
// applied to the product's float32 sum, so that the other operand stays
// bf16; one on the K axis is folded into the float32 operand before the
// split.  The cumsum is float64; every exp takes a float32 difference of
// it that is <= 0 (L masked before the exp, so no exp is formed above the
// diagonal).  The rows and the columns of M cancel in dcum's reverse
// cumsum (every pair i, j >= k): summed in float32 they leave 2e-4 of
// d a_log's size at a real layer's decay.  So M is formed once, in the
// rows kernel, written as float32 into a shared-memory tile, and both of
// its sums are float64 sums of those same float32 bits: the row sums per
// row i, the column sums per (row j, slab of i), which the close kernel
// adds in slab order.  The columns kernel forms S L and G L, never M.
//
// What bounds it on the H100: operations.  At one mamba2-130m training
// layer (B = 8, L = 2048, H = 24, P = 64, G = 1, N = 128, chunk 256) S and
// G over each chunk's lower triangle are 7.0 GFLOP of bf16 products; (S
// L)^T dy, (G L dt) B and (G L)^T C over the triangle and the five (N, P)
// products per chunk 64.6 GFLOP with a float32 operand, three tensor-core
// products each: 200.7 GFLOP, 0.203 ms at 989 TFLOP/s, against 0.07 ms of
// bytes.  Here S and G are formed twice (rows and columns), for the
// whole 64 x 64 diagonal tiles, and the (N, P) scratch (own, pull, 25 MB
// each at that shape) is written twice and read three times.  Measured
// there (chip_smoke.py phase 26, H100 80GB HBM3 at 700 W; PERF.md §6),
// the five launches take about 1.7 ms of device time, some 8x the bound:
// the columns kernel about 0.73 ms, the rows 0.63, the chunk sums 0.20,
// the state passing 0.08, the close 0.02.  The rows and the columns
// kernels reach some 15-19 % of the tensor cores' rate, bound by
// latency: one warpgroup a block, two blocks an SM at 255 registers a
// thread (a few bytes of spills), and within a block the loads, the
// products and the elementwise work (the decay's float64 difference and
// expf, the split) take turns.  dx and dB in separate blocks, one set of
// accumulators each and no spills, were slower: each block formed G^T
// and the decays again.  What the design does:
//   * Every product is a wgmma m64n64k16 with float32 accumulators: S, G
//     (rows), S^T, G^T (columns) and the state products with both
//     operands in shared memory; the products with S L, G L or G L dt_j
//     from registers, where the accumulator of S^T, G^T or G already lies
//     in the A-fragment layout, against C, dy or B read transposed from
//     the same tile through an MN-major descriptor; S_in and dS split 64 x
//     64 at a time into shared memory.
//   * Grid width.  The rows and the columns kernels take each (batch,
//     head, chunk, slab) at once, 6,144 blocks of one warpgroup each at
//     the layer above; the heaviest slabs are launched first.  The
//     tile that a block walks (B and x in the rows kernel, C and dy in
//     the columns kernel) arrives through a ring of two stages (cp.async,
//     one mbarrier a stage); the slab's own tiles stay resident.  The
//     state passing is one thread per 4 state entries (393k threads at B
//     = 8), serial only over the chunks, each with 8 chunks' loads in
//     flight at once.
//   * Determinism.  No atomics: every output element is written by one
//     thread, every sum runs in a fixed order, so a repeat gives the same
//     bits.
//   * Ragged lengths.  The last chunk may be short: rows past the end
//     load as zeros and are never stored.
//   * Any chunk.  Nothing is held for the whole chunk: the chunk sums
//     carry the cumsum from one tile of 256 rows to the next (a first walk
//     finds the last row, the decay of w), the rows and the columns
//     kernels take each block's cumsum and dt with its tiles, and the
//     close kernel walks a long chunk tile by tile, its reverse cumsum
//     from the last tile back.
//   * Sub-problems.  A d_state over 256 is taken in slices of 256 or 128
//     state rows (a grid axis of the chunk sums) and a head size over 256
//     in blocks of 256 or 192 columns; the rows and the columns kernels
//     run once per (slice, block), in that order, each on its slice's B
//     and C columns and its block's x and dy columns.  What sums over the
//     slices (dx) or the blocks (dB, dC, the float64 row terms) is added
//     to what the launches before left: a fixed order, no atomics.
// Shapes: N in {64, 128, 256} or a multiple of 128 above 256, P in {64,
// 128, 192, 256} or a multiple of 192 or 256 above (the Python wrapper
// zero-pads any other N and P), any chunk, H % G == 0.

#include "wgmma.cuh"

namespace {

constexpr int kBQ = 64;        // rows of a slab (chunk rows, K-slabs)
constexpr int kTileQ = 256;    // chunk rows of a cumsum tile
constexpr int kStages = 2;     // depth of the rings
constexpr int kPassThreads = 256;
constexpr int kCloseThreads = kTileQ;  // one thread per row of a tile
constexpr int kCloseWarps = kCloseThreads / 32;
constexpr int kMLd = 68;       // row stride (floats) of the M tile
// planes of the float64 row scratch: 0 the rows kernel's state term of
// dcum, 1 its row sums of M; 2-4 the columns kernel's sums of S L G, x.(B
// dS) and dy.x; from kColPlane on, the column sums of M by 64-row slab of
// i (the rows kernel)
constexpr int kColPlane = 5;
// state entries of one <S_in, dS> partial: a warp's, 4 a thread
constexpr int kTileEntries = 4 * 32;


// The three bf16 terms of the 64 x 64 float32 tile at src (rows ld floats
// apart) stored at tile by the block's Threads threads, then made visible
// to wgmma.
template <int Threads>
__device__ __forceinline__ void split_tile(uint32_t tile,
                                           const float* __restrict__ src,
                                           int64_t ld, int tid) {
  for (int e = tid; e < kBQ * 8; e += Threads) {
    const int r = e / 8, ch = e % 8;
    const float* row = src + r * ld + 8 * ch;
    const float4 lo4 = *reinterpret_cast<const float4*>(row);
    const float4 hi4 = *reinterpret_cast<const float4*>(row + 4);
    const float v[8] = {lo4.x, lo4.y, lo4.z, lo4.w,
                        hi4.x, hi4.y, hi4.z, hi4.w};
    store_split8(tile, chunk_off<64, kBQ>(r, ch), v);
  }
  fence_proxy_async();
}

// *p = v, or *p += v where acc: the part of a sum over sub-problems (state
// slices, head-size blocks) that the launches before have left there.
template <typename T>
__device__ __forceinline__ void put(T* p, T v, bool acc) {
  *p = acc ? *p + v : v;
}
__device__ __forceinline__ void put2(float* p, float v0, float v1,
                                     bool acc) {
  float2* q = reinterpret_cast<float2*>(p);
  if (acc) {
    const float2 o = *q;
    v0 += o.x;
    v1 += o.y;
  }
  *q = make_float2(v0, v1);
}

// ---------------------------------------------------------------------
// 1. The chunk sums.  Block (chunk x state slice, head, (batch x P block)
// x 2), N / 64 warpgroups, warpgroup w owning rows 64 w .. 64 w + 63 of
// the slice's N state rows; product 0 is own = B^T (x dt w), product 1
// pull = C^T (exp(cum) dy).  Shared memory: per stage the B or C slab (64
// x N) and the three bf16 terms of the row-scaled x or dy (3 x 64 x 64),
// then one mbarrier per stage, the cumsum (double) and the row factors of
// a tile of kTileQ chunk rows.

template <int N>
__host__ __device__ constexpr int sums_smem_bytes() {
  return 1024 + kStages * (kBQ * N * 2 + 3 * kSplitTile) + 8 * kStages +
         kTileQ * (8 + 4);
}

template <int N>
__global__ void __launch_bounds__(2 * N)
ssd_bwd_sums_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a_log,
                    const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                    const bf16* __restrict__ dy, double* __restrict__ cum_out,
                    float* __restrict__ own, float* __restrict__ pull,
                    int len, int h_count, int p, int g_count, int q,
                    int n_chunks, int n_slices) {
  constexpr int kThreads = 2 * N;
  constexpr int kStage = kBQ * N * 2 + 3 * kSplitTile;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bars = base + kStages * kStage;
  double* cum = reinterpret_cast<double*>(smem_raw + (bars + 8 * kStages -
                                                      raw));
  float* f = reinterpret_cast<float*>(cum + kTileQ);
  auto s_m = [&](int st) { return base + st * kStage; };
  auto s_v = [&](int st) { return base + st * kStage + kBQ * N * 2; };

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wg = tid / kWarpgroup;
  const int c = blockIdx.x / n_slices, k = blockIdx.x % n_slices;
  const int h = blockIdx.y;
  const int npb = p / 64;
  const int prod = blockIdx.z % 2;
  const int b = blockIdx.z / 2 / npb, pb = blockIdx.z / 2 % npb;
  const int c0 = c * q, qc = min(q, len - c0);
  const int g = h / (h_count / g_count);
  const int64_t bh = static_cast<int64_t>(b) * h_count + h;
  const int n_tot = N * n_slices;
  const float a = -expf(a_log[h]);
  const float* dt_row = dt + (static_cast<int64_t>(b) * len + c0) * h_count
                        + h;
  const int n_tiles = (qc + kTileQ - 1) / kTileQ;
  // warp 0: the cumsum of tile t into cum and dt into f, after carry
  auto scan = [&](int t, double carry) {
    return chunk_cumsum(cum, f, dt_row + static_cast<int64_t>(t) * kTileQ *
                                             h_count,
                        h_count, a, min(kTileQ, qc - t * kTileQ), lane,
                        carry);
  };

  // the chunk's cumsum tile by tile: its last row, then tile 0 again
  double carry = 0.0;
  if (warp == 0)
    for (int t = 0; t < n_tiles; ++t) carry = scan(t, carry);
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bars + 8 * st, kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const double last = cum[(qc - 1) % kTileQ];
  // f = dt w (own) or exp(cum) (pull) over tile t (its cumsum in place);
  // one block writes the cumsum out
  auto weigh = [&](int t) {
    if (n_tiles > 1) {
      __syncthreads();  // every thread is done with the tile before
      if (warp == 0) carry = scan(t, t == 0 ? 0.0 : carry);
      __syncthreads();
    }
    const int r0 = t * kTileQ, rows = min(kTileQ, qc - r0);
    for (int j = tid; j < rows; j += kThreads) {
      f[j] = prod == 0 ? f[j] * expf(static_cast<float>(last - cum[j]))
                       : expf(static_cast<float>(cum[j]));
      if (prod == 0 && pb == 0 && k == 0)
        cum_out[bh * len + c0 + r0 + j] = cum[j];
    }
    __syncthreads();
  };
  weigh(0);

  const bf16* msrc = (prod == 0 ? bm : cm) +
                     (static_cast<int64_t>(b) * len * g_count + g) * n_tot +
                     k * N;
  const bf16* vsrc = (prod == 0 ? x : dy) +
                     (static_cast<int64_t>(b) * len * h_count + h) * p +
                     pb * 64;
  const int64_t vld = static_cast<int64_t>(h_count) * p;
  const int n_slabs = (qc + kBQ - 1) / kBQ;

  // K-slab s (chunk rows 64 s ..) into stage st: B or C by cp.async, the
  // three bf16 terms of the row-scaled x or dy by the threads
  auto fill = [&](int s, int st) {
    load_tile<N, kBQ, kThreads>(s_m(st), msrc, c0 + s * kBQ, c0 + qc, tid,
                                static_cast<int64_t>(g_count) * n_tot);
    cp_async_arrive(bars + 8 * st);
    for (int e = tid; e < kBQ * 8; e += kThreads) {
      const int r = e / 8, ch = e % 8, j = s * kBQ + r;
      float v[8];
      if (j < qc) {
        const uint4 raw8 = *reinterpret_cast<const uint4*>(
            vsrc + (c0 + j) * vld + 8 * ch);
        const uint32_t w4[4] = {raw8.x, raw8.y, raw8.z, raw8.w};
        const float fj = f[j % kTileQ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 t = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&w4[i]));
          v[2 * i] = t.x * fj;
          v[2 * i + 1] = t.y * fj;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = 0.f;
      }
      store_split8(s_v(st), chunk_off<64, kBQ>(r, ch), v);
    }
    fence_proxy_async();
  };

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  fill(0, 0);
  for (int s = 0; s < n_slabs; ++s) {
    const int st = s % kStages;
    // slab s's terms are written by every thread, and slab s - 1's
    // products (the other stage) are done in every warpgroup
    __syncthreads();
    mbar_wait(bars + 8 * st, (s / kStages) & 1);
    fence_proxy_async();
    // acc += B^T (f x): A = B^T (MN-major), B = the terms (MN-major)
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < kBQ / 16; ++kc)
#pragma unroll
      for (int part = 0; part < 3; ++part)
        mma_ss_n64<1, 1>(acc, desc_mn<N, kBQ>(s_m(st), kc, wg),
                         desc_mn<64, kBQ>(s_v(st) + part * kSplitTile, kc,
                                          0),
                         1);
    wg_commit();
    if (s + 1 < n_slabs) {
      if ((s + 1) * kBQ % kTileQ == 0) weigh((s + 1) * kBQ / kTileQ);
      fill(s + 1, (s + 1) % kStages);
    }
    wg_wait();
    fence_regs(acc);
  }

  // rows 64 wg + r_lo (+ 8) of the slice, columns 8 n8 + 2 (lane % 4) + j
  const int r_lo = 64 * wg + 16 * (warp % 4) + lane / 4;
  float* dst = (prod == 0 ? own : pull) +
               ((bh * n_chunks + c) * n_tot + k * N + r_lo) * p + pb * 64 +
               2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
      *reinterpret_cast<float2*>(dst + 8 * i * p + 8 * n8) =
          make_float2(acc[4 * n8 + 2 * i], acc[4 * n8 + 2 * i + 1]);
}

// ---------------------------------------------------------------------
// 2. The state passing both ways, in place, one thread per (batch, head,
// 4 state entries): pull becomes each chunk's dS, own each chunk's S_in,
// and each warp's 128 entries give one float64 partial of <S_in, dS> a
// chunk.  A thread issues the loads of kPassGroup chunks before it walks
// them, so that they are in flight together.

constexpr int kPassGroup = 8;

__device__ __forceinline__ float chunk_decay(const double* cum, int64_t bh,
                                             int len, int q, int c) {
  const int last = min(q * (c + 1), len) - 1;
  return expf(static_cast<float>(cum[bh * len + last]));
}

__device__ __forceinline__ float4 step4(float d, float4 s, float4 l) {
  return make_float4(d * s.x + l.x, d * s.y + l.y, d * s.z + l.z,
                     d * s.w + l.w);
}

// The grid covers np exactly (np is a multiple of 4 kPassThreads), so
// every lane of every warp is live for the warp sums.
__global__ void __launch_bounds__(kPassThreads)
ssd_bwd_pass_kernel(const double* __restrict__ cum,
                    const float* __restrict__ state_in,
                    const float* __restrict__ dfinal, float* __restrict__ own,
                    float* __restrict__ pull, float* __restrict__ dstate,
                    double* __restrict__ sdot, int len, int h_count, int np,
                    int q, int n_chunks) {
  const int e = 4 * (blockIdx.x * kPassThreads + threadIdx.x);
  const int n_tiles = np / kTileEntries, tile = e / kTileEntries;
  const int lane = threadIdx.x % 32;
  const int64_t bh = static_cast<int64_t>(blockIdx.z) * h_count + blockIdx.y;
  auto at = [&](float* base, int c) {
    return reinterpret_cast<float4*>(base + (bh * n_chunks + c) * np + e);
  };
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 ds = dfinal != nullptr
                  ? *reinterpret_cast<const float4*>(dfinal + bh * np + e)
                  : zero;
  for (int c0 = n_chunks - 1; c0 >= 0; c0 -= kPassGroup) {
    float4 pc[kPassGroup];
#pragma unroll
    for (int k = 0; k < kPassGroup; ++k)
      if (c0 - k >= 0) pc[k] = *at(pull, c0 - k);
#pragma unroll
    for (int k = 0; k < kPassGroup; ++k)
      if (c0 - k >= 0) {
        *at(pull, c0 - k) = ds;                      // dS leaving the chunk
        ds = step4(chunk_decay(cum, bh, len, q, c0 - k), ds, pc[k]);
      }
  }
  if (dstate != nullptr)
    *reinterpret_cast<float4*>(dstate + bh * np + e) = ds;

  float4 s = state_in != nullptr
                 ? *reinterpret_cast<const float4*>(state_in + bh * np + e)
                 : zero;
  for (int c0 = 0; c0 < n_chunks; c0 += kPassGroup) {
    float4 lc[kPassGroup], dv[kPassGroup];
#pragma unroll
    for (int k = 0; k < kPassGroup; ++k)
      if (c0 + k < n_chunks) {
        lc[k] = *at(own, c0 + k);
        dv[k] = *at(pull, c0 + k);
      }
#pragma unroll
    for (int k = 0; k < kPassGroup; ++k)
      if (c0 + k < n_chunks) {               // the same in every lane
        *at(own, c0 + k) = s;                        // S_in of the chunk
        // <S_in, dS> over the warp's entries: float32 products, float64
        // sums in a fixed order
        double part = static_cast<double>(s.x * dv[k].x);
        part += static_cast<double>(s.y * dv[k].y);
        part += static_cast<double>(s.z * dv[k].z);
        part += static_cast<double>(s.w * dv[k].w);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (lane == 0) sdot[(bh * n_chunks + c0 + k) * n_tiles + tile] = part;
        s = step4(chunk_decay(cum, bh, len, q, c0 + k), s, lc[k]);
      }
  }
}

// ---------------------------------------------------------------------
// Shared by the rows and the columns kernels: the block's (chunk, head,
// batch) from blockIdx.x, and one sub-problem's place in the operands.  A
// sub-problem is a slice of N state rows (k) and a block of P head columns
// (pb): the kernels take its B and C columns, x and dy columns, and its
// part of the states; n_ld and p_ld are the whole d_state and head size.
// Each output that sums over slices or blocks is added to what the
// sub-problems launched before left (acc_*), in launch order.

struct Slab {
  int c, h, b, c0, qc, g;
  int64_t bh;
};

__device__ __forceinline__ Slab slab_of(int len, int h_count, int g_count,
                                        int q, int n_chunks) {
  int lin = blockIdx.x;
  Slab s;
  s.c = lin % n_chunks;
  lin /= n_chunks;
  s.h = lin % h_count;
  s.b = lin / h_count;
  s.c0 = s.c * q;
  s.qc = min(q, len - s.c0);
  s.g = s.h / (h_count / g_count);
  s.bh = static_cast<int64_t>(s.b) * h_count + s.h;
  return s;
}

struct Sub {
  int n_ld, p_ld;  // the whole d_state and head size
  int acc_k;       // 1: add dx to the slices' before (k > 0)
  int acc_p;       // 1: add dB, dC to the head blocks' before (pb > 0)
  int acc_rows;    // 1: add the float64 planes to the sub-problems' before
  int first_k;     // 1: slice 0, which adds d_skip dy and dy.x
};

// rows [r0, r0 + 64) of the chunk's cum (and dt, where dts) into shared
// memory; 0 past its end
__device__ __forceinline__ void load_rows64(double* cum, float* dts,
                                            const double* __restrict__ cum_in,
                                            const float* __restrict__ dt,
                                            const Slab& s, int r0, int len,
                                            int h_count) {
  for (int j = threadIdx.x; j < kBQ; j += kWarpgroup) {
    const bool ok = r0 + j < s.qc;
    cum[j] = ok ? cum_in[s.bh * len + s.c0 + r0 + j] : 0.0;
    if (dts != nullptr)
      dts[j] = ok ? dt[(static_cast<int64_t>(s.b) * len + s.c0 + r0 + j) *
                           h_count + s.h]
                  : 0.f;
  }
}

// The same rows by cp.async (counted by the stage's mbarrier), by the
// warpgroup's threads: 0-63 the cumsum, 64-127 dt (where dts).
__device__ __forceinline__ void copy_rows64(double* cum, float* dts,
                                            const double* __restrict__ cum_in,
                                            const float* __restrict__ dt,
                                            const Slab& s, int r0, int len,
                                            int h_count, int tid) {
  const int j = tid % kBQ;
  const bool ok = r0 + j < s.qc;
  const int row = ok ? s.c0 + r0 + j : 0;
  if (tid < kBQ)
    cp_async8(smem_u32(cum + j), cum_in + s.bh * len + row, ok);
  else if (dts != nullptr)
    cp_async4(smem_u32(dts + j),
              dt + (static_cast<int64_t>(s.b) * len + row) * h_count + s.h,
              ok);
}

// ---------------------------------------------------------------------
// 3. dC and M.  Block (chunk x head x batch, slab rank), one warpgroup.
// Shared memory: the dy (64 x P) and C (64 x N) slabs, the three bf16
// terms of a 64 x 64 tile of S_in (then the M tile: 64 x 64 floats, rows
// i, kMLd apart), then per stage a key block's B (64 x N) and x (64 x P),
// then one mbarrier per stage, the slab's cumsum (double), and per stage
// the key block's cumsum (double) and dt.

template <int N, int P>
__host__ __device__ constexpr int rows_smem_bytes() {
  return 1024 + kBQ * P * 2 + kBQ * N * 2 + 3 * kSplitTile +
         kStages * (kBQ * N * 2 + kBQ * P * 2) + 8 * kStages + kBQ * 8 +
         kStages * kBQ * (8 + 4);
}

static_assert(kBQ * kMLd * 4 <= 3 * kSplitTile,
              "the M tile does not fit the split tile's place");

template <int N, int P>
__global__ void __launch_bounds__(kWarpgroup)
ssd_bwd_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                    const bf16* __restrict__ dy,
                    const double* __restrict__ cum_in,
                    const float* __restrict__ s_in, float* __restrict__ dc,
                    double* __restrict__ rows, int len, int h_count,
                    int g_count, int q, int n_chunks, Sub sub) {
  constexpr int kTileB = kBQ * N * 2, kTileX = kBQ * P * 2;
  constexpr int NB = N / 64;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t s_dy = base, s_ci = base + kTileX;
  const uint32_t s_s = s_ci + kTileB;
  const uint32_t ring = s_s + 3 * kSplitTile;
  const uint32_t bars = ring + kStages * (kTileB + kTileX);
  float* mt = reinterpret_cast<float*>(smem_raw + (s_s - raw));
  double* icum = reinterpret_cast<double*>(smem_raw + (bars + 8 * kStages -
                                                       raw));
  double* kcum = icum + kBQ;                 // [kStages][kBQ]
  float* kdt = reinterpret_cast<float*>(kcum + kStages * kBQ);
  auto s_b = [&](int st) { return ring + st * (kTileB + kTileX); };
  auto s_x = [&](int st) { return s_b(st) + kTileB; };

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const Slab sl = slab_of(len, h_count, g_count, q, n_chunks);
  const int spc = (q + kBQ - 1) / kBQ;
  const int si = spc - 1 - blockIdx.y;  // the heaviest slabs first
  const int i0 = si * kBQ;
  if (i0 >= sl.qc) return;  // past the end of a short last chunk
  const int nblk = si + 1;  // the key blocks left of the diagonal

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bars + 8 * st, kWarpgroup);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  load_rows64(icum, nullptr, cum_in, dt, sl, i0, len, h_count);
  __syncthreads();

  const int64_t gld = static_cast<int64_t>(g_count) * sub.n_ld;
  const int64_t xld = static_cast<int64_t>(h_count) * sub.p_ld;
  const int64_t bg = static_cast<int64_t>(sl.b) * len * g_count + sl.g;
  const int64_t bhx = (static_cast<int64_t>(sl.b) * len * h_count + sl.h);
  const bf16* bsrc = bm + bg * sub.n_ld;
  const bf16* csrc = cm + bg * sub.n_ld;
  const bf16* xsrc = x + bhx * sub.p_ld;
  const bf16* dysrc = dy + bhx * sub.p_ld;
  const int end = sl.c0 + sl.qc;
  auto fill = [&](int jb, int st) {
    load_tile<N, kBQ>(s_b(st), bsrc, sl.c0 + jb * kBQ, end, tid, gld);
    load_tile<P, kBQ>(s_x(st), xsrc, sl.c0 + jb * kBQ, end, tid, xld);
    copy_rows64(kcum + st * kBQ, kdt + st * kBQ, cum_in, dt, sl, jb * kBQ,
                len, h_count, tid);
    cp_async_arrive(bars + 8 * st);
  };
  // the dy and C slabs land with block 0
  load_tile<P, kBQ>(s_dy, dysrc, sl.c0 + i0, end, tid, xld);
  load_tile<N, kBQ>(s_ci, csrc, sl.c0 + i0, end, tid, gld);
  for (int t = 0; t < kStages && t < nblk; ++t) fill(t, t);

  // acc = dy S_in^T, S_in taken in 64 x 64 tiles (state rows nb, head
  // columns ks), each split into three bf16 terms
  const float* sin_c = s_in + (sl.bh * n_chunks + sl.c) * sub.n_ld *
                                  static_cast<int64_t>(sub.p_ld);
  float acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll 1
    for (int ks = 0; ks < P / 64; ++ks) {
      if (nb + ks > 0) {
        wg_wait();  // the previous tile's products are done with s_s
#pragma unroll
        for (int k = 0; k < NB; ++k) fence_regs(acc[k]);
        __syncthreads();
      }
      split_tile<kWarpgroup>(
          s_s, sin_c + static_cast<int64_t>(nb) * 64 * sub.p_ld + ks * 64,
          sub.p_ld, tid);
      __syncthreads();
      if (nb + ks == 0) {  // the dy slab
        mbar_wait(bars, 0);
        fence_proxy_async();
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int part = 0; part < 3; ++part)
          mma_ss_n64<0, 0>(acc[nb], desc_k<P, kBQ>(s_dy, ks * 4 + kk),
                           desc_k<64, kBQ>(s_s + part * kSplitTile, kk), 1);
      wg_commit();
    }
  wg_wait();
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);

  // this thread's rows of the slab: il_lo and il_lo + 8 (chunk-local);
  // the state term of dcum, exp(cum_i) C_i.(dy S_in^T)_i, then acc =
  // exp(cum_i) dy S_in^T
  const int il_lo = i0 + 16 * warp + lane / 4;
  const int64_t plane = static_cast<int64_t>(gridDim.x / n_chunks) * len;
  const bool acc_rows = sub.acc_rows;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int il = il_lo + 8 * i;
    const bool ok = il < sl.qc;
    const float ei = ok ? expf(static_cast<float>(icum[il - i0])) : 0.f;
    const bf16* crow = csrc + (ok ? (sl.c0 + il) * gld : 0) + 2 * (lane % 4);
    float part = 0.f;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        const int at = 4 * n8 + 2 * i;
        if (ok) {
          const float2 cv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(crow + nb * 64 +
                                                       8 * n8));
          part += cv.x * acc[nb][at] + cv.y * acc[nb][at + 1];
        }
        acc[nb][at] *= ei;
        acc[nb][at + 1] *= ei;
      }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    if (ok && lane % 4 == 0)
      put(rows + sl.bh * len + sl.c0 + il, static_cast<double>(ei * part),
          acc_rows);
  }
  __syncthreads();  // every warp is past the split tile: it is the M tile

  // threads 0-63: column jb 64 + tid of M over the slab's 64 rows, one
  // float64 partial per (column, slab); threads 64-127: row i0 + tid - 64
  // of M over every key block; both in a fixed order
  double* colsum = rows + (kColPlane + si) * plane + sl.bh * len + sl.c0;
  double rowsum = 0.0;
  for (int jb = 0; jb < nblk; ++jb) {
    const int st = jb % kStages;
    mbar_wait(bars + 8 * st, (jb / kStages) & 1);
    fence_proxy_async();

    // sm = S = C_i B_j^T and gm = G = dy_i x_j^T: the slab's rows, the
    // block's 64 keys
    float sm[32], gm[32];  // the first product overwrites them
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      mma_ss(sm, desc_k<N, kBQ>(s_ci, kk), desc_k<N, kBQ>(s_b(st), kk), kk);
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk)
      mma_ss(gm, desc_k<P, kBQ>(s_dy, kk), desc_k<P, kBQ>(s_x(st), kk), kk);
    wg_commit();
    wg_wait();
    fence_regs(sm);
    fence_regs(gm);

    // Z = G L dt_j in place of G, 0 above the diagonal and past the end;
    // M = S Z into the tile
    const bool diag = jb == si;
    const double* kc = kcum + st * kBQ;
    const float* kd = kdt + st * kBQ;
#pragma unroll
    for (int at = 0; at < 32; ++at) {  // at = 4 n8 + 2 i + j
      const int il = il_lo + 8 * (at / 2 % 2);
      const int jt = 8 * (at / 4) + 2 * (lane % 4) + at % 2;
      const float l = (!diag || jb * kBQ + jt <= il) && il < sl.qc
                          ? expf(static_cast<float>(icum[il - i0] - kc[jt]))
                          : 0.f;
      const float z = (gm[at] * l) * kd[jt];
      mt[(il - i0) * kMLd + jt] = sm[at] * z;
      gm[at] = z;
    }
    // acc += Z B_j: Z from registers in three bf16 terms, B_j transposed
    uint32_t fr[3][4][4];
    split_frags<64>(gm, fr);
    wg_fence();
#pragma unroll
    for (int kc4 = 0; kc4 < 4; ++kc4)
#pragma unroll
      for (int part = 0; part < 3; ++part)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          mma_rs(acc[nb], fr[part][kc4], desc_mn<N, kBQ>(s_b(st), kc4, nb));
    wg_commit();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);

    // while it runs: M's sums, four chains each, added in a fixed order
    __syncthreads();  // the tile is whole
    if (tid < kBQ) {
      double c4[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll 4
      for (int r = 0; r < kBQ; r += 4)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          c4[k] += static_cast<double>(mt[(r + k) * kMLd + tid]);
      const int jl = jb * kBQ + tid;
      if (jl < sl.qc)
        put(colsum + jl, (c4[0] + c4[1]) + (c4[2] + c4[3]), acc_rows);
    } else {
      const float4* mrow =
          reinterpret_cast<const float4*>(mt + (tid - kBQ) * kMLd);
      double c4[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
      for (int k = 0; k < kBQ / 4; ++k) {
        const float4 v = mrow[k];
        c4[0] += static_cast<double>(v.x);
        c4[1] += static_cast<double>(v.y);
        c4[2] += static_cast<double>(v.z);
        c4[3] += static_cast<double>(v.w);
      }
      rowsum += (c4[0] + c4[1]) + (c4[2] + c4[3]);
    }

    wg_wait();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
    fence_frags(fr);
    // every warp is done with the M tile and with the stage refilled here
    __syncthreads();
    if (jb + kStages < nblk) fill(jb + kStages, st);
  }
  if (tid >= kBQ && i0 + tid - kBQ < sl.qc)
    put(rows + plane + sl.bh * len + sl.c0 + i0 + tid - kBQ, rowsum,
        acc_rows);

  // dC per head, float32: columns 64 nb + 8 n8 + 2 (lane % 4) + j
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int il = il_lo + 8 * i;
    if (il >= sl.qc) continue;
    float* dst = dc + ((static_cast<int64_t>(sl.b) * len + sl.c0 + il) *
                           h_count + sl.h) * sub.n_ld + 2 * (lane % 4);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8)
        put2(dst + nb * 64 + 8 * n8, acc[nb][4 * n8 + 2 * i],
             acc[nb][4 * n8 + 2 * i + 1], sub.acc_p);
  }
}

// ---------------------------------------------------------------------
// 4. dx, dB and the direct ddt terms.  Block (chunk x head x batch, slab
// j), one warpgroup.  Shared memory: the B (64 x N) and x (64 x P) slabs,
// then per stage an i block's C (64 x N) and dy (64 x P) (the epilogue
// splits dS into the first stage), then one mbarrier per stage, the
// slab's cumsum (double) and dt, and per stage the i block's cumsum.

template <int N, int P>
__host__ __device__ constexpr int cols_smem_bytes() {
  return 1024 + kBQ * N * 2 + kBQ * P * 2 +
         kStages * (kBQ * N * 2 + kBQ * P * 2) + 8 * kStages +
         kBQ * (8 + 4) + kStages * kBQ * 8;
}

template <int N, int P>
__global__ void __launch_bounds__(kWarpgroup)
ssd_bwd_cols_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                    const bf16* __restrict__ dy,
                    const float* __restrict__ d_skip,
                    const double* __restrict__ cum_in,
                    const float* __restrict__ ds_out, float* __restrict__ dx,
                    float* __restrict__ db, double* __restrict__ rows,
                    int len, int h_count, int g_count, int q, int n_chunks,
                    Sub sub) {
  constexpr int kTileB = kBQ * N * 2, kTileX = kBQ * P * 2;
  constexpr int NB = N / 64, XB = P / 64;
  static_assert(3 * kSplitTile <= kStages * (kTileB + kTileX),
                "dS's split tile does not fit the ring");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t s_bj = base, s_xj = base + kTileB;
  const uint32_t ring = s_xj + kTileX;
  const uint32_t bars = ring + kStages * (kTileB + kTileX);
  double* jcum = reinterpret_cast<double*>(smem_raw + (bars + 8 * kStages -
                                                       raw));
  double* kcum = jcum + kBQ;                 // [kStages][kBQ]
  float* jdt = reinterpret_cast<float*>(kcum + kStages * kBQ);
  auto s_c = [&](int st) { return ring + st * (kTileB + kTileX); };
  auto s_dy = [&](int st) { return s_c(st) + kTileB; };

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const Slab sl = slab_of(len, h_count, g_count, q, n_chunks);
  const int sj = blockIdx.y;  // slab 0 sees the most rows: first out
  const int j0 = sj * kBQ;
  if (j0 >= sl.qc) return;  // past the end of a short last chunk
  const int n_live = (sl.qc + kBQ - 1) / kBQ;
  const int n_i = n_live - sj;  // the i slabs on or below the diagonal

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bars + 8 * st, kWarpgroup);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  load_rows64(jcum, jdt, cum_in, dt, sl, j0, len, h_count);
  __syncthreads();

  const int64_t gld = static_cast<int64_t>(g_count) * sub.n_ld;
  const int64_t xld = static_cast<int64_t>(h_count) * sub.p_ld;
  const int64_t bg = static_cast<int64_t>(sl.b) * len * g_count + sl.g;
  const int64_t bhx = (static_cast<int64_t>(sl.b) * len * h_count + sl.h);
  const bf16* csrc = cm + bg * sub.n_ld;
  const bf16* dysrc = dy + bhx * sub.p_ld;
  const int end = sl.c0 + sl.qc;
  auto fill = [&](int t, int st) {
    const int r0 = (sj + t) * kBQ;
    load_tile<N, kBQ>(s_c(st), csrc, sl.c0 + r0, end, tid, gld);
    load_tile<P, kBQ>(s_dy(st), dysrc, sl.c0 + r0, end, tid, xld);
    copy_rows64(kcum + st * kBQ, nullptr, cum_in, dt, sl, r0, len, h_count,
                tid);
    cp_async_arrive(bars + 8 * st);
  };
  // B_j and x_j land with the first i block
  load_tile<N, kBQ>(s_bj, bm + bg * sub.n_ld, sl.c0 + j0, end, tid, gld);
  load_tile<P, kBQ>(s_xj, x + bhx * sub.p_ld, sl.c0 + j0, end, tid, xld);
  for (int t = 0; t < kStages && t < n_i; ++t) fill(t, t);

  // this thread's rows of the slab: jl_lo and jl_lo + 8 (chunk-local)
  const int jl_lo = j0 + 16 * warp + lane / 4;
  const float dtj[2] = {jdt[jl_lo - j0], jdt[jl_lo + 8 - j0]};
  const double cj[2] = {jcum[jl_lo - j0], jcum[jl_lo + 8 - j0]};
  double qd[2] = {0.0, 0.0};
  float dxa[XB][32], dba[NB][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
#pragma unroll
    for (int k = 0; k < XB; ++k) dxa[k][i] = 0.f;
#pragma unroll
    for (int k = 0; k < NB; ++k) dba[k][i] = 0.f;
  }

  for (int t = 0; t < n_i; ++t) {
    const int st = t % kStages;
    const int i0 = (sj + t) * kBQ;
    mbar_wait(bars + 8 * st, (t / kStages) & 1);
    fence_proxy_async();

    // s = S^T = B_j C_i^T and gt = G^T = x_j dy_i^T: the slab's rows j,
    // the block's 64 rows i; S L in place of s and G L in place of gt
    // (L^T masked before the exp), and the sums of S L G; then dx += (S
    // L)^T dy_i and dB += (G L)^T C_i, S L and G L from registers in three
    // bf16 terms in turn, dy_i and C_i transposed
    uint32_t fr[3][4][4];
    float s[32], gt[32];  // the first product overwrites them
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      mma_ss(s, desc_k<N, kBQ>(s_bj, kk), desc_k<N, kBQ>(s_c(st), kk), kk);
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk)
      mma_ss(gt, desc_k<P, kBQ>(s_xj, kk), desc_k<P, kBQ>(s_dy(st), kk),
             kk);
    wg_commit();
    wg_wait();
    fence_regs(s);
    fence_regs(gt);
    const double* ic = kcum + st * kBQ;
#pragma unroll
    for (int at = 0; at < 32; ++at) {  // at = 4 n8 + 2 i + j
      const int k = at / 2 % 2;
      const int jl = jl_lo + 8 * k;
      const int it = 8 * (at / 4) + 2 * (lane % 4) + at % 2;
      const int il = i0 + it;
      const float l = jl <= il && il < sl.qc
                          ? expf(static_cast<float>(ic[it] - cj[k]))
                          : 0.f;
      const float slv = s[at] * l;
      qd[k] += static_cast<double>(slv * gt[at]);
      s[at] = slv;
      gt[at] *= l;
    }
    split_frags<64>(s, fr);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int part = 0; part < 3; ++part)
#pragma unroll
        for (int k = 0; k < XB; ++k)
          mma_rs(dxa[k], fr[part][kc], desc_mn<P, kBQ>(s_dy(st), kc, k));
    wg_commit();
    wg_wait();
#pragma unroll
    for (int k = 0; k < XB; ++k) fence_regs(dxa[k]);
    fence_frags(fr);
    split_frags<64>(gt, fr);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int part = 0; part < 3; ++part)
#pragma unroll
        for (int k = 0; k < NB; ++k)
          mma_rs(dba[k], fr[part][kc], desc_mn<N, kBQ>(s_c(st), kc, k));
    wg_commit();
    wg_wait();
#pragma unroll
    for (int k = 0; k < NB; ++k) fence_regs(dba[k]);
#pragma unroll
    for (int k = 0; k < XB; ++k) fence_regs(dxa[k]);
    fence_frags(fr);
    // every warp is done with the stage refilled here
    __syncthreads();
    if (t + kStages < n_i) fill(t + kStages, st);
  }

  // the epilogue, against dS split 64 x 64 at a time into the first stage
  // (free now): bds = B_j dS, then xds = x_j dS^T
  const float* dso = ds_out + (sl.bh * n_chunks + sl.c) * sub.n_ld *
                                  static_cast<int64_t>(sub.p_ld);
  const uint32_t s_t = ring;
  const double last = cum_in[sl.bh * len + sl.c0 + sl.qc - 1];
  float w[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int jl = jl_lo + 8 * k;
    w[k] = jl < sl.qc ? expf(static_cast<float>(last - cj[k])) : 0.f;
  }
  {
    float bds[XB][32];
#pragma unroll
    for (int k = 0; k < XB; ++k)
#pragma unroll
      for (int i = 0; i < 32; ++i) bds[k][i] = 0.f;
#pragma unroll
    for (int pb = 0; pb < XB; ++pb)
#pragma unroll 1
      for (int nb = 0; nb < NB; ++nb) {
        if (pb + nb > 0) {
          wg_wait();
#pragma unroll
          for (int k = 0; k < XB; ++k) fence_regs(bds[k]);
          __syncthreads();
        }
        split_tile<kWarpgroup>(
            s_t, dso + static_cast<int64_t>(nb) * 64 * sub.p_ld + pb * 64,
            sub.p_ld, tid);
        __syncthreads();
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int part = 0; part < 3; ++part)
            mma_ss_n64<0, 1>(bds[pb], desc_k<N, kBQ>(s_bj, nb * 4 + kk),
                             desc_mn<64, kBQ>(s_t + part * kSplitTile, kk,
                                              0),
                             1);
        wg_commit();
      }
    wg_wait();
#pragma unroll
    for (int k = 0; k < XB; ++k) fence_regs(bds[k]);

    // dx = dt (dxa + w bds) + D dy; the rows' x.(B dS), dy.x and sums of
    // S L G
    const int64_t plane = static_cast<int64_t>(gridDim.x / n_chunks) * len;
    const float dsk = sub.first_k ? d_skip[sl.h] : 0.f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int jl = jl_lo + 8 * k;
      const bool live = jl < sl.qc;
      const int64_t at = (sl.c0 + (live ? jl : 0)) * xld + 2 * (lane % 4);
      const bf16* xr = x + bhx * sub.p_ld + at;
      const bf16* dyr = dysrc + at;
      float* dxr = dx + bhx * sub.p_ld + at;
      float xb = 0.f, dd = 0.f;
#pragma unroll
      for (int pb = 0; pb < XB; ++pb)
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8) {
          if (!live) continue;
          const int col = pb * 64 + 8 * n8, a = 4 * n8 + 2 * k;
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xr + col));
          const float2 dyv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(dyr + col));
          const float b0 = bds[pb][a], b1 = bds[pb][a + 1];
          xb += xv.x * b0 + xv.y * b1;
          dd += dyv.x * xv.x + dyv.y * xv.y;
          put2(dxr + col, dtj[k] * (dxa[pb][a] + w[k] * b0) + dsk * dyv.x,
               dtj[k] * (dxa[pb][a + 1] + w[k] * b1) + dsk * dyv.y,
               sub.acc_k);
        }
      xb += __shfl_xor_sync(0xffffffffu, xb, 1);
      xb += __shfl_xor_sync(0xffffffffu, xb, 2);
      dd += __shfl_xor_sync(0xffffffffu, dd, 1);
      dd += __shfl_xor_sync(0xffffffffu, dd, 2);
      double qd_k = qd[k];
      qd_k += __shfl_xor_sync(0xffffffffu, qd_k, 1);
      qd_k += __shfl_xor_sync(0xffffffffu, qd_k, 2);
      if (live && lane % 4 == 0) {
        const int64_t row = sl.bh * len + sl.c0 + jl;
        put(rows + plane * 2 + row, qd_k, sub.acc_rows);
        put(rows + plane * 3 + row, static_cast<double>(xb), sub.acc_rows);
        if (sub.first_k)
          put(rows + plane * 4 + row, static_cast<double>(dd), sub.acc_p);
      }
    }
  }
  __syncthreads();  // s_t is free again

  float xds[NB][32];
#pragma unroll
  for (int k = 0; k < NB; ++k)
#pragma unroll
    for (int i = 0; i < 32; ++i) xds[k][i] = 0.f;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll 1
    for (int pb = 0; pb < XB; ++pb) {
      if (nb + pb > 0) {
        wg_wait();
#pragma unroll
        for (int k = 0; k < NB; ++k) fence_regs(xds[k]);
        __syncthreads();  // the previous tile's products are done with s_t
      }
      split_tile<kWarpgroup>(
          s_t, dso + static_cast<int64_t>(nb) * 64 * sub.p_ld + pb * 64,
          sub.p_ld, tid);
      __syncthreads();
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int part = 0; part < 3; ++part)
          mma_ss_n64<0, 0>(xds[nb], desc_k<P, kBQ>(s_xj, pb * 4 + kk),
                           desc_k<64, kBQ>(s_t + part * kSplitTile, kk), 1);
      wg_commit();
    }
  wg_wait();
#pragma unroll
  for (int k = 0; k < NB; ++k) fence_regs(xds[k]);

  // dB per head, float32: dt (dba + w xds)
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int jl = jl_lo + 8 * k;
    if (jl >= sl.qc) continue;
    float* dst = db + ((static_cast<int64_t>(sl.b) * len + sl.c0 + jl) *
                           h_count + sl.h) * sub.n_ld + 2 * (lane % 4);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        const int a = 4 * n8 + 2 * k;
        put2(dst + nb * 64 + 8 * n8,
             dtj[k] * (dba[nb][a] + w[k] * xds[nb][a]),
             dtj[k] * (dba[nb][a + 1] + w[k] * xds[nb][a + 1]), sub.acc_p);
      }
  }
}

// ---------------------------------------------------------------------
// 5. Per (b, h, chunk): <S_in, dS>, dcum, its reverse cumsum d(dt a),
// ddt, and the chunk's partials a sum dt d(dt a) (of d a_log) and sum
// dy.x (of d d_skip).  One thread per row of a tile of kTileQ rows; a
// longer chunk is walked tile by tile, its reverse cumsum from the last
// tile back, carried.

// Sum of v over the block, the same in every thread: a warp xor tree,
// then the warps' sums in order.  red holds kCloseWarps values.
__device__ double block_sum(double v, double* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // red is free
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < kCloseWarps; ++w) s += red[w];
  return s;
}

// Inclusive scan of v over the block's threads in thread order (float64):
// warp shuffles, then the warps' totals.
__device__ double block_scan(double v, double* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double t = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += t;
  }
  __syncthreads();  // wsum is free
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += wsum[w];
  return v;
}

__global__ void __launch_bounds__(kCloseThreads)
ssd_bwd_close_kernel(const float* __restrict__ dt,
                     const float* __restrict__ a_log,
                     const double* __restrict__ cum,
                     const double* __restrict__ rows,
                     const double* __restrict__ sdot_parts,
                     float* __restrict__ ddt, float* __restrict__ parts,
                     int len, int h_count, int n_tiles, int q, int n_chunks) {
  __shared__ double red[kCloseWarps];
  __shared__ double dda[kTileQ];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * q, qc = min(q, len - c0), tid = threadIdx.x;
  const int n_live = (qc + kBQ - 1) / kBQ;
  const int64_t bh = static_cast<int64_t>(b) * h_count + h;
  const int64_t plane = static_cast<int64_t>(gridDim.z) * h_count * len;
  const float a = -expf(a_log[h]);
  const double last = cum[bh * len + c0 + qc - 1];

  // <S_in, dS>: the state passing's float64 partials, in a fixed order
  const double* sp_c = sdot_parts + (bh * n_chunks + c) * n_tiles;
  double sp = 0.0;
  for (int t = tid; t < n_tiles; t += kCloseThreads) sp += sp_c[t];
  const float sdot = static_cast<float>(block_sum(sp, red));

  // row i's terms: w, dt and x.(B dS), and dcum but for row qc - 1's
  // extras
  struct Row {
    float w, dti, t;
    double qd, xb, dd, dcum;
  };
  auto row_of = [&](int i) {
    Row r{0.f, 0.f, 0.f, 0.0, 0.0, 0.0, 0.0};
    if (i >= qc) return r;
    const int64_t at = bh * len + c0 + i;
    const double cumi = cum[at];
    const double rowp = rows[at] + rows[plane + at];
    double colm = 0.0;
    for (int s = i / kBQ; s < n_live; ++s)
      colm += rows[(kColPlane + s) * plane + at];
    r.qd = rows[2 * plane + at];
    r.xb = rows[3 * plane + at];
    r.dd = rows[4 * plane + at];
    r.dti = dt[(static_cast<int64_t>(b) * len + c0 + i) * h_count + h];
    r.w = expf(static_cast<float>(last - cumi));
    r.t = r.w * r.dti * static_cast<float>(r.xb);
    r.dcum = rowp - colm - static_cast<double>(r.t);
    return r;
  };
  double t_part = 0.0;
  for (int i = tid; i < qc; i += kCloseThreads)
    t_part += static_cast<double>(row_of(i).t);
  const double t_sum = block_sum(t_part, red);

  // reverse inclusive cumsum, tile by tile from the last: thread k scans
  // the tile's element rows - 1 - k, after the carry of the tiles behind
  double carry = 0.0, da = 0.0, ds = 0.0;
  for (int tl = (qc - 1) / kTileQ; tl >= 0; --tl) {
    const int r0 = tl * kTileQ, rows_t = min(kTileQ, qc - r0);
    const int i = r0 + tid;
    const bool live = tid < rows_t;
    const Row r = row_of(i);
    double dcum = r.dcum;
    if (i == qc - 1)
      dcum += static_cast<double>(expf(static_cast<float>(last)) * sdot) +
              t_sum;
    __syncthreads();
    if (live) dda[tid] = dcum;
    __syncthreads();
    const int k = rows_t - 1 - tid;
    const double rv = block_scan(live ? dda[k] : 0.0, red) + carry;
    __syncthreads();
    if (live) dda[k] = rv;
    __syncthreads();
    const double ddai = live ? dda[tid] : 0.0;
    if (live)
      ddt[(static_cast<int64_t>(b) * len + c0 + i) * h_count + h] =
          static_cast<float>(r.qd) + r.w * static_cast<float>(r.xb) +
          a * static_cast<float>(ddai);
    da += static_cast<double>(r.dti) * ddai;
    ds += r.dd;
    carry = dda[0];
  }
  da = block_sum(da, red);
  ds = block_sum(ds, red);
  if (tid == 0) {
    const int64_t nparts = static_cast<int64_t>(gridDim.z) * h_count *
                           n_chunks;
    parts[bh * n_chunks + c] = static_cast<float>(static_cast<double>(a) * da);
    parts[nparts + bh * n_chunks + c] = static_cast<float>(ds);
  }
}

struct Args {
  const bf16* x;
  const float* dt;
  const float* a_log;
  const bf16* bm;
  const bf16* cm;
  const float* d_skip;
  const float* state_in;
  const bf16* dy;
  const float* dfinal;
  float *dx, *ddt, *db, *dc, *dstate, *parts;
  double* cum;
  float *own, *pull;
  double *sdot, *rows;
  int b, len, h, g, q, n, p;
  cudaStream_t stream;
};

template <typename Kern>
cudaError_t allow_smem(Kern kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The rows and the columns kernels of sub-problem (k, pb): state rows k N
// .., head columns pb P ..
template <int N, int P>
cudaError_t launch_sub(const Args& a, int k, int pb, int nc) {
  const int spc = (a.q + kBQ - 1) / kBQ;
  constexpr int s3 = rows_smem_bytes<N, P>(), s4 = cols_smem_bytes<N, P>();
  cudaError_t err;
  if ((err = allow_smem(ssd_bwd_rows_kernel<N, P>, s3)) != cudaSuccess ||
      (err = allow_smem(ssd_bwd_cols_kernel<N, P>, s4)) != cudaSuccess)
    return err;
  const Sub sub{a.n, a.p, k > 0, pb > 0, k + pb > 0, k == 0};
  const int64_t state_at = static_cast<int64_t>(k) * N * a.p + pb * P;
  ssd_bwd_rows_kernel<N, P><<<dim3(nc * a.h * a.b, spc), kWarpgroup, s3,
                              a.stream>>>(
      a.x + pb * P, a.dt, a.bm + k * N, a.cm + k * N, a.dy + pb * P, a.cum,
      a.own + state_at, a.dc + k * N, a.rows, a.len, a.h, a.g, a.q, nc, sub);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_cols_kernel<N, P><<<dim3(nc * a.h * a.b, spc), kWarpgroup, s4,
                              a.stream>>>(
      a.x + pb * P, a.dt, a.bm + k * N, a.cm + k * N, a.dy + pb * P,
      a.d_skip, a.cum, a.pull + state_at, a.dx + pb * P, a.db + k * N,
      a.rows, a.len, a.h, a.g, a.q, nc, sub);
  return cudaGetLastError();
}

// N state rows a slice, P head columns a block (the whole d_state a.n and
// head size a.p their multiples)
template <int N, int P>
cudaError_t launch(const Args& a) {
  const int nc = (a.len + a.q - 1) / a.q;
  const int n_slices = a.n / N, n_blocks = a.p / P;
  constexpr int s1 = sums_smem_bytes<N>();
  cudaError_t err;
  if ((err = allow_smem(ssd_bwd_sums_kernel<N>, s1)) != cudaSuccess)
    return err;
  ssd_bwd_sums_kernel<N><<<dim3(nc * n_slices, a.h, a.b * (a.p / 64) * 2),
                           2 * N, s1, a.stream>>>(
      a.x, a.dt, a.a_log, a.bm, a.cm, a.dy, a.cum, a.own, a.pull, a.len, a.h,
      a.p, a.g, a.q, nc, n_slices);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int np = a.n * a.p;  // a multiple of 4 kPassThreads
  ssd_bwd_pass_kernel<<<dim3(np / 4 / kPassThreads, a.h, a.b), kPassThreads,
                        0, a.stream>>>(a.cum, a.state_in, a.dfinal, a.own,
                                    a.pull, a.dstate, a.sdot, a.len, a.h, np,
                                    a.q, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int k = 0; k < n_slices; ++k)
    for (int pb = 0; pb < n_blocks; ++pb)
      if ((err = launch_sub<N, P>(a, k, pb, nc)) != cudaSuccess) return err;
  ssd_bwd_close_kernel<<<dim3(nc, a.h, a.b), kCloseThreads, 0, a.stream>>>(
      a.dt, a.a_log, a.cum, a.rows, a.sdot, a.ddt, a.parts, a.len, a.h,
      np / kTileEntries, a.q, nc);
  return cudaGetLastError();
}

// The head block: the whole head size where it is 64, 128, 192 or 256,
// else blocks of 192 or 256 (the wrapper pads to one of their multiples).
template <int N>
cudaError_t launch_p(const Args& a) {
  switch (a.p) {
    case 64:
      return launch<N, 64>(a);
    case 128:
      return launch<N, 128>(a);
    case 192:
      return launch<N, 192>(a);
    default:
      if (a.p % 256 == 0) return launch<N, 256>(a);
      if (a.p % 192 == 0) return launch<N, 192>(a);
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, dy (B, L, H, P) and b_mat, c_mat (B, L, G, N): bfloat16; dt (B, L,
// H), a_log and d_skip (H,), state_in and dfinal (B, H, N, P) or null:
// float32.  Outputs, float32: dx like x, ddt like dt, db and dc (B, L, H,
// N) per head, dstate (B, H, N, P) or null, parts (2, B, H, n_chunks): the
// partials of d a_log and d d_skip.  Scratch: cum (B, H, L) float64,
// states and pulls (B, H, n_chunks, N, P) float32, sdot (B, H, n_chunks,
// N P / 128) float64, rows (5 + ceil(q / 64), B, H, L) float64.  All
// contiguous, rows 16-byte aligned; N in {64, 128, 256} or a multiple of
// 128 above 256 (slices of 256 where it is a multiple of 256, else of
// 128), P in {64, 128, 192} or a multiple of 192 or 256 (blocks of 256,
// else of 192), q >= 1, H % G == 0.
cudaError_t ssd_scan_backward(const void* x, const float* dt,
                              const float* a_log, const void* bm,
                              const void* cm, const float* d_skip,
                              const float* state_in, const void* dy,
                              const float* dfinal, float* dx, float* ddt,
                              float* db, float* dc, float* dstate,
                              float* parts, double* cum, float* states,
                              float* pulls, double* sdot, double* rows,
                              int b, int len, int h, int p, int g, int n,
                              int q, cudaStream_t stream) {
  if (b <= 0 || len <= 0 || g <= 0 || h % g != 0 || q < 1)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(x), dt, a_log,
               static_cast<const bf16*>(bm), static_cast<const bf16*>(cm),
               d_skip, state_in, static_cast<const bf16*>(dy), dfinal, dx,
               ddt, db, dc, dstate, parts, cum, states, pulls, sdot, rows,
               b, len, h, g, q, n, p, stream};
  if (n == 64) return launch_p<64>(a);
  if (n == 128) return launch_p<128>(a);
  if (n > 0 && n % 256 == 0) return launch_p<256>(a);
  if (n > 256 && n % 128 == 0) return launch_p<128>(a);
  return cudaErrorInvalidValue;
}
