// Mamba-2 SSD chunked scan for Hopper (sm_90a) on the tensor cores: y and
// the final state of one SSD layer's prefill, bf16 x, B, C, any sequence
// length.  (float32 operands go to the CUDA-core kernel of
// ssd_scan_fma.cu; the binding chooses by dtype.)
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py:31 (_kernel via
// ssd_scan).  There, a sequential chunk grid axis carried the float32
// (N, P) state in VMEM, and each grid step did, in this order,
//     cum    = inclusive cumsum of dt * a
//     scores = (C B^T) * exp(where(causal, cum_i - cum_j, -inf))
//     y      = scores @ (x dt) + (C @ S_in) * exp(cum) + x * d_skip
//     S_out  = exp(cum[-1]) S_in + B^T @ (exp(cum[-1] - cum) * x dt)
// Only the last line is a recurrence over chunks, and it is elementwise;
// the products are not.  So one call here is the chunk-parallel
// decomposition of the SSD, three launches on one stream:
//   1. ssd_states_kernel, one block per (batch, head, chunk, 64 columns of
//      P): the chunk's own state L_c = B^T (w dt x), w = exp(cum[-1] -
//      cum), into a float32 scratch; it also writes the chunk's cumsum.
//   2. ssd_pass_kernel, one thread per (batch, head, state entry): in
//      series over the chunks, S_c = exp(cum_c[-1]) S_{c-1} + L_c from
//      the initial state (or zero); each chunk's S_in replaces its L_c in
//      the scratch, and the last S is the final state.
//   3. ssd_output_kernel, one block per (batch, head, chunk, 64-row slab,
//      64 columns of P): y = (C B^T * exp(seg) * dt_j) x + (C S_in) *
//      exp(cum) + x d_skip, the three terms in the reference's order,
//      over the key blocks left of the slab's diagonal.
//
// Precision.  The cumsum is carried in float64 (a warp-shuffle scan, as
// in the CUDA-core kernel: at the serve shape it reaches about -3e3
// within a chunk, where a float32 ulp of 2.4e-4 would put that much noise
// into every decay factor); each difference is rounded to float32 before
// its exp, as in the plain version.  C B^T has bf16 operands: wgmma forms
// the products exactly and sums them in float32.  Every other product has
// one float32 operand, and split3 (wgmma.cuh) cuts that operand exactly
// into three bf16 terms, so that three wgmma products are the float32
// product's exact parts: w dt x against B^T (phase 1), the scores with
// dt_j folded in against x, and S_in against C (phase 3).  No TF32; no
// float32 operand is ever cast to a single bf16.
//
// What bounds it on the H100: operations.  At the serve shape (one
// mamba2-130m layer, B = 1, L = 2048, H = 24, P = 64, G = 1, N = 128,
// chunk 256) C B^T once per chunk and group is 0.07 GFLOP of bf16
// products, and B^T (w dt x), C S_in and the scores times x 2.4 GFLOP of
// float32-by-bf16 ones, three tensor-core products each: 7.3 GFLOP, 7.4 us
// at 989 TFLOP/s, against 14.6 MB of HBM traffic (4.4 us).  Here C B^T is
// formed again for each head (1.6 GFLOP more) and the float32 state
// scratch (6.3 MB at the serve shape, written and read twice) stays in the
// 50 MB L2.  Measured, one call takes about 10x the bound (0.075 ms on an
// H100 80GB HBM3 at 700 W, chip_smoke.py phase 10), two thirds of it in
// phase 3, where each score's decay costs a float64 difference and an
// expf on the CUDA cores beside the split.  What the design does:
//   * Grid width.  The products run over all B H n_chunks (head, chunk)
//     pairs at once, 192 at the serve shape (phase 3: 768 slabs), not
//     along 24 serial walks.
//   * Tiles live in shared memory in bf16, in the 128-byte swizzle that
//     the descriptors name: B^T is read from the B tile through an
//     MN-major descriptor as phase 1's A, and x as the MN-major B of the
//     scores' product; the split terms are written by the threads into
//     the same layout (fence.proxy.async before the wgmma reads them).
//   * Shared memory is spent in 64-row slabs: phase 1 takes the chunk in
//     K-slabs of 64 rows through a ring of two stages (B by cp.async with
//     an mbarrier each; the split of the next slab's w dt x is written
//     while the current slab's products run), 86.0 KB at the serve
//     shape; phase 3 keeps its C slab, splits S_in in K-slabs of 64 state
//     rows and takes the key blocks (B, x, and their cumsum and dt)
//     through a two-stage ring, 93.2 KB.  Two blocks fit on an SM.
//     Nothing is held for the whole chunk, so any chunk runs: phase 1
//     carries the cumsum from one tile of 256 rows to the next (a first
//     walk finds its last row, the decay of w), phase 3 reads each key
//     block's cumsum and dt with its tiles.
//   * A d_state over 256 is taken in slices of 256 or 128 state rows: a
//     grid axis of phase 1, a K-loop of C B^T and C S_in in phase 3, whose
//     stages then also bring the slab's C slice (207.9 KB at slices of
//     256, one block an SM).
//   * Causality.  Phase 3 visits only the key blocks left of its slab's
//     diagonal and masks only the diagonal block; its heaviest slabs are
//     launched first.
//   * Ragged lengths.  The last chunk may be short: rows past the end
//     load as zeros and are never stored.
// Shapes: N in {64, 128, 256} or a multiple of 128 above 256, P a multiple
// of 64 (the Python wrapper zero-pads any other N and P), any chunk.

#include "wgmma.cuh"

namespace {

constexpr int kBQ = 64;       // rows of a slab (chunk rows, keys, K-slabs)
constexpr int kPB = 64;       // columns of P a block takes
constexpr int kTileQ = 256;   // chunk rows of phase 1's cumsum tile
constexpr int kStages = 2;    // depth of the rings
constexpr int kPassThreads = 256;

// ---------------------------------------------------------------------
// Phase 1: the chunk states.  Block (chunk x state slice, head, batch x P
// block), N / 64 warpgroups, warpgroup w owning rows 64 w .. 64 w + 63 of
// the slice's N state rows.  Shared memory: per stage the B slab (64 x N)
// and the three bf16 terms of w dt x (3 x 64 x 64), then one mbarrier per
// stage, the cumsum (double) and w dt of a tile of kTileQ chunk rows.

template <int N>
__host__ __device__ constexpr int states_smem_bytes() {
  return 1024 + kStages * (kBQ * N * 2 + 3 * kSplitTile) + 8 * kStages +
         kTileQ * (8 + 4);
}

template <int N>
__global__ void __launch_bounds__(2 * N)
ssd_states_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a_log,
                  const bf16* __restrict__ bm, double* __restrict__ cum_out,
                  float* __restrict__ states, int len, int h_count, int p,
                  int g_count, int q, int n_chunks, int n_slices) {
  constexpr int kThreads = 2 * N;
  constexpr int kStage = kBQ * N * 2 + 3 * kSplitTile;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bars = base + kStages * kStage;
  double* cum = reinterpret_cast<double*>(smem_raw + (bars + 8 * kStages -
                                                      raw));
  float* f = reinterpret_cast<float*>(cum + kTileQ);
  auto s_b = [&](int st) { return base + st * kStage; };
  auto s_x = [&](int st) { return base + st * kStage + kBQ * N * 2; };

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wg = tid / kWarpgroup;
  const int c = blockIdx.x / n_slices, k = blockIdx.x % n_slices;
  const int h = blockIdx.y;
  const int npb = p / kPB;
  const int b = blockIdx.z / npb, pb = blockIdx.z % npb;
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
  // f = dt w, w = exp(cum[-1] - cum), over tile t (its cumsum in place);
  // the first slice of P block 0 writes the cumsum out
  auto weigh = [&](int t) {
    if (n_tiles > 1) {
      __syncthreads();  // every thread is done with the tile before
      if (warp == 0) carry = scan(t, t == 0 ? 0.0 : carry);
      __syncthreads();
    }
    const int r0 = t * kTileQ, rows = min(kTileQ, qc - r0);
    for (int j = tid; j < rows; j += kThreads) {
      f[j] *= expf(static_cast<float>(last - cum[j]));
      if (pb == 0 && k == 0) cum_out[bh * len + c0 + r0 + j] = cum[j];
    }
    __syncthreads();
  };
  weigh(0);

  const int64_t gld = static_cast<int64_t>(g_count) * n_tot;
  const bf16* bsrc = bm + (static_cast<int64_t>(b) * len * g_count + g) *
                              n_tot + k * N;
  const bf16* xsrc =
      x + (static_cast<int64_t>(b) * len * h_count + h) * p + pb * kPB;
  const int64_t xld = static_cast<int64_t>(h_count) * p;
  const int n_slabs = (qc + kBQ - 1) / kBQ;

  // K-slab s (chunk rows 64 s ..) into stage st: B by cp.async, the three
  // bf16 terms of w dt x by the threads
  auto fill = [&](int s, int st) {
    load_tile<N, kBQ, kThreads>(s_b(st), bsrc, c0 + s * kBQ, c0 + qc, tid,
                                gld);
    cp_async_arrive(bars + 8 * st);
    for (int e = tid; e < kBQ * 8; e += kThreads) {
      const int r = e / 8, ch = e % 8, j = s * kBQ + r;
      float v[8];
      if (j < qc) {
        const uint4 raw8 = *reinterpret_cast<const uint4*>(
            xsrc + (c0 + j) * xld + 8 * ch);
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
      store_split8(s_x(st), chunk_off<kPB, kBQ>(r, ch), v);
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
    // L += B^T (w dt x): A = B^T (MN-major), B = the terms (MN-major)
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < kBQ / 16; ++kc)
#pragma unroll
      for (int part = 0; part < 3; ++part)
        mma_ss_n64<1, 1>(acc, desc_mn<N, kBQ>(s_b(st), kc, wg),
                         desc_mn<kPB, kBQ>(s_x(st) + part * kSplitTile, kc,
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
  float* dst = states + ((bh * n_chunks + c) * n_tot + k * N + r_lo) * p +
               pb * kPB + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
      *reinterpret_cast<float2*>(dst + 8 * i * p + 8 * n8) =
          make_float2(acc[4 * n8 + 2 * i], acc[4 * n8 + 2 * i + 1]);
}

// ---------------------------------------------------------------------
// Phase 2: the states passed from chunk to chunk, one thread per (batch,
// head, state entry); L_c in the scratch becomes S_in of chunk c.

__global__ void __launch_bounds__(kPassThreads)
ssd_pass_kernel(const double* __restrict__ cum,
                const float* __restrict__ state_in,
                float* __restrict__ states, float* __restrict__ state_out,
                int len, int h_count, int np, int q, int n_chunks) {
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= np) return;
  const int64_t bh = static_cast<int64_t>(blockIdx.z) * h_count + blockIdx.y;
  float s = state_in != nullptr ? state_in[bh * np + e] : 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    float* slot = states + (bh * n_chunks + c) * np + e;
    const float lc = *slot;
    *slot = s;
    const int last = min(len, (c + 1) * q) - 1;
    s = expf(static_cast<float>(cum[bh * len + last])) * s + lc;
  }
  state_out[bh * np + e] = s;
}

// ---------------------------------------------------------------------
// Phase 3: y.  Block (chunk x head x batch x P block, slab rank), one
// warpgroup.  The state's n_slices * N rows are taken N at a time: C B^T
// and C S_in are K-loops over the slices.  Shared memory: the C slab (64
// x N: its one slice, or the slice of C S_in's K-loop), the three bf16
// terms of a 64-row K-slab of S_in (3 x 64 x 64), then per stage a key
// block's B slice (64 x N), with more than one slice the slab's C slice
// (64 x N), and x (64 x 64), then one mbarrier per stage, the slab's
// cumsum (double), and per stage the key block's cumsum (double) and dt.

template <int N>
__host__ __device__ constexpr int output_smem_bytes(bool sliced) {
  return 1024 + kBQ * N * 2 + 3 * kSplitTile +
         kStages * (kBQ * N * 2 * (sliced ? 2 : 1) + kBQ * kPB * 2) +
         8 * kStages + kBQ * 8 + kStages * kBQ * (8 + 4);
}

template <int N>
__global__ void __launch_bounds__(kWarpgroup)
ssd_output_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                  const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                  const float* __restrict__ d_skip,
                  const double* __restrict__ cum_in,
                  const float* __restrict__ states, bf16* __restrict__ y,
                  int len, int h_count, int p, int g_count, int q,
                  int n_chunks, int n_slices) {
  constexpr int kThreads = kWarpgroup;
  constexpr int kTileB = kBQ * N * 2, kTileX = kBQ * kPB * 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const bool sliced = n_slices > 1;
  const int stage = kTileB * (sliced ? 2 : 1) + kTileX;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t s_c = base, s_s = base + kTileB;
  const uint32_t ring = s_s + 3 * kSplitTile;
  const uint32_t bars = ring + kStages * stage;
  double* icum = reinterpret_cast<double*>(smem_raw + (bars + 8 * kStages -
                                                       raw));
  double* kcum = icum + kBQ;                 // [kStages][kBQ]
  float* kdt = reinterpret_cast<float*>(kcum + kStages * kBQ);
  auto s_b = [&](int st) { return ring + st * stage; };
  auto s_cb = [&](int st) { return s_b(st) + kTileB; };  // sliced only
  auto s_x = [&](int st) { return s_b(st) + stage - kTileX; };

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int npb = p / kPB;
  int lin = blockIdx.x;
  const int c = lin % n_chunks;
  lin /= n_chunks;
  const int h = lin % h_count;
  lin /= h_count;
  const int pb = lin % npb, b = lin / npb;
  const int spc = (q + kBQ - 1) / kBQ;
  const int sl = spc - 1 - blockIdx.y;  // the heaviest slabs first
  const int c0 = c * q, qc = min(q, len - c0), i0 = sl * kBQ;
  if (i0 >= qc) return;  // past the end of a short last chunk
  const int nblk = sl + 1;  // the key blocks left of the diagonal
  const int n_steps = nblk * n_slices;  // (key block, state slice)
  const int n_tot = N * n_slices;
  const int g = h / (h_count / g_count);
  const int64_t bh = static_cast<int64_t>(b) * h_count + h;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bars + 8 * st, kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < kBQ)
    icum[tid] = i0 + tid < qc ? cum_in[bh * len + c0 + i0 + tid] : 0.0;
  __syncthreads();

  const int64_t gld = static_cast<int64_t>(g_count) * n_tot;
  const int64_t xld = static_cast<int64_t>(h_count) * p;
  const bf16* bsrc = bm + (static_cast<int64_t>(b) * len * g_count + g) *
                              n_tot;
  const bf16* csrc = cm + (static_cast<int64_t>(b) * len * g_count + g) *
                              n_tot;
  const bf16* xsrc =
      x + (static_cast<int64_t>(b) * len * h_count + h) * p + pb * kPB;
  // step t: slice t % n_slices of key block t / n_slices; the last slice
  // also brings the block's x, cumsum and dt
  auto fill = [&](int t, int st) {
    const int jb = t / n_slices, k = t % n_slices, j0 = c0 + jb * kBQ;
    load_tile<N, kBQ>(s_b(st), bsrc + k * N, j0, c0 + qc, tid, gld);
    if (sliced)
      load_tile<N, kBQ>(s_cb(st), csrc + k * N, c0 + i0, c0 + qc, tid, gld);
    if (k == n_slices - 1) {
      load_tile<kPB, kBQ>(s_x(st), xsrc, j0, c0 + qc, tid, xld);
      const int r = tid % kBQ;
      const bool ok = j0 + r < c0 + qc;
      if (tid < kBQ)
        cp_async8(smem_u32(kcum + st * kBQ + r),
                  cum_in + bh * len + (ok ? j0 + r : 0), ok);
      else
        cp_async4(smem_u32(kdt + st * kBQ + r),
                  dt + (static_cast<int64_t>(b) * len + (ok ? j0 + r : 0)) *
                           h_count + h,
                  ok);
    }
    cp_async_arrive(bars + 8 * st);
  };
  load_tile<N, kBQ>(s_c, csrc, c0 + i0, c0 + qc, tid, gld);  // with step 0
  for (int t = 0; t < kStages && t < n_steps; ++t) fill(t, t);

  // cs = C S_in, S_in taken in K-slabs of 64 state rows, each split into
  // three bf16 terms; with more than one state slice, C's slices come into
  // s_c in turn; the last slab's products stay in flight
  const float* s_in =
      states + (bh * n_chunks + c) * n_tot * static_cast<int64_t>(p) +
      pb * kPB;
  float cs[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) cs[i] = 0.f;
#pragma unroll 1
  for (int ks = 0; ks < n_tot / kBQ; ++ks) {
    const int kl = ks % (N / kBQ);  // the K-slab within its slice
    if (ks > 0) {
      wg_wait();  // the previous slab's products are done with s_s (s_c)
      fence_regs(cs);
      __syncthreads();
    }
    if (sliced && kl == 0 && ks > 0)
      load_tile<N, kBQ>(s_c, csrc + ks * kBQ, c0 + i0, c0 + qc, tid, gld);
    for (int e = tid; e < kBQ * 8; e += kThreads) {
      const int r = e / 8, ch = e % 8;
      const float* src = s_in + (ks * kBQ + r) * static_cast<int64_t>(p) +
                         8 * ch;
      const float4 lo4 = *reinterpret_cast<const float4*>(src);
      const float4 hi4 = *reinterpret_cast<const float4*>(src + 4);
      const float v[8] = {lo4.x, lo4.y, lo4.z, lo4.w,
                          hi4.x, hi4.y, hi4.z, hi4.w};
      store_split8(s_s, chunk_off<kPB, kBQ>(r, ch), v);
    }
    if (sliced && kl == 0) cp_async_wait_all();  // the C slice
    fence_proxy_async();
    __syncthreads();
    if (ks == 0 && !sliced) {  // the C slab
      mbar_wait(bars, 0);
      fence_proxy_async();
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
      for (int part = 0; part < 3; ++part)
        mma_ss_n64<0, 1>(cs, desc_k<N, kBQ>(s_c, kl * (kBQ / 16) + kk),
                         desc_mn<kPB, kBQ>(s_s + part * kSplitTile, kk, 0),
                         1);
    wg_commit();
  }

  // this thread's rows of the slab: il_lo and il_lo + 8 (chunk-local)
  const int il_lo = i0 + 16 * warp + lane / 4;
  float yacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) yacc[i] = 0.f;
  float gm[32];  // the first product of a key block overwrites it
  for (int t = 0; t < n_steps; ++t) {
    const int st = t % kStages;
    const int jb = t / n_slices, k = t % n_slices;
    mbar_wait(bars + 8 * st, (t / kStages) & 1);
    fence_proxy_async();

    // gm (+)= C B^T over the slice: the slab's rows, the block's 64 keys
    const uint32_t ct = sliced ? s_cb(st) : s_c;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      mma_ss(gm, desc_k<N, kBQ>(ct, kk), desc_k<N, kBQ>(s_b(st), kk),
             k + kk);
    wg_commit();
    wg_wait();  // C S_in as well
    fence_regs(gm);
    fence_regs(cs);

    if (k == n_slices - 1) {
      // scores = gm exp(cum_i - cum_j) dt_j, 0 right of the diagonal
      const bool diag = jb == sl;
      const double* kc = kcum + st * kBQ;
      const float* kd = kdt + st * kBQ;
#pragma unroll
      for (int at = 0; at < 32; ++at) {  // at = 4 n8 + 2 i + j
        const int il = il_lo + 8 * (at / 2 % 2);
        const int jt = 8 * (at / 4) + 2 * (lane % 4) + at % 2;
        gm[at] = !diag || jb * kBQ + jt <= il
                     ? gm[at] *
                           expf(static_cast<float>(icum[il - i0] - kc[jt])) *
                           kd[jt]
                     : 0.f;
      }
      // yacc += scores x: the scores from registers in three bf16 terms, x
      // transposed
      uint32_t fr[3][4][4];
      split_frags<64>(gm, fr);
      wg_fence();
#pragma unroll
      for (int kc4 = 0; kc4 < 4; ++kc4)
#pragma unroll
        for (int part = 0; part < 3; ++part)
          mma_rs(yacc, fr[part][kc4], desc_mn<kPB, kBQ>(s_x(st), kc4, 0));
      wg_commit();
      wg_wait();
      fence_regs(yacc);
      fence_frags(fr);
    }
    if (t + kStages < n_steps) {
      __syncthreads();  // every warp is done with the stage refilled here
      fill(t + kStages, st);
    }
  }

  // y = yacc + cs exp(cum_i) + x d_skip, columns 8 n8 + 2 (lane % 4) + j
  const float dsk = d_skip[h];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int il = il_lo + 8 * i;
    if (il >= qc) continue;
    const float e = expf(static_cast<float>(icum[il - i0]));
    const int64_t at = (c0 + il) * xld + 2 * (lane % 4);
    const bf16* xr = xsrc + at;
    bf16* yr = y + (static_cast<int64_t>(b) * len * h_count + h) * p +
               pb * kPB + at;
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xr + 8 * n8));
      const int a0 = 4 * n8 + 2 * i;
      const float v0 = (yacc[a0] + cs[a0] * e) + xv.x * dsk;
      const float v1 = (yacc[a0 + 1] + cs[a0 + 1] * e) + xv.y * dsk;
      *reinterpret_cast<__nv_bfloat162*>(yr + 8 * n8) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

template <int N>
cudaError_t launch(const bf16* x, const float* dt, const float* a_log,
                   const bf16* bm, const bf16* cm, const float* d_skip,
                   const float* state_in, bf16* y, float* state_out,
                   double* cum, float* states, int b, int len, int h, int p,
                   int g, int q, int n_slices, cudaStream_t stream) {
  const int n_chunks = (len + q - 1) / q;
  const int npb = p / kPB;
  constexpr int s1 = states_smem_bytes<N>();
  const int s3 = output_smem_bytes<N>(n_slices > 1);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_states_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, s1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_output_kernel<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, s3);
  if (err != cudaSuccess) return err;
  ssd_states_kernel<N>
      <<<dim3(n_chunks * n_slices, h, b * npb), 2 * N, s1, stream>>>(
          x, dt, a_log, bm, cum, states, len, h, p, g, q, n_chunks,
          n_slices);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int np = N * n_slices * p;
  ssd_pass_kernel<<<dim3((np + kPassThreads - 1) / kPassThreads, h, b),
                    kPassThreads, 0, stream>>>(cum, state_in, states,
                                               state_out, len, h, np, q,
                                               n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int spc = (q + kBQ - 1) / kBQ;
  ssd_output_kernel<N>
      <<<dim3(n_chunks * h * b * npb, spc), kWarpgroup, s3, stream>>>(
          x, dt, bm, cm, d_skip, cum, states, y, len, h, p, g, q, n_chunks,
          n_slices);
  return cudaGetLastError();
}

}  // namespace

// x (B, L, H, P), b_mat and c_mat (B, L, G, N), y like x: contiguous
// bfloat16, P a multiple of 64, N in {64, 128, 256} or a multiple of 128
// above 256 (taken in slices of 256 where it is a multiple of 256, else of
// 128); dt (B, L, H), a_log and d_skip (H,), state_in (B, H, N, P) or
// null, state_out (B, H, N, P): float32.  Scratch: cum (B, H, L) float64
// and states (B, H, n_chunks, N, P) float32.  q >= 1, H % G == 0.
cudaError_t ssd_scan_fwd(const void* x, const float* dt, const float* a_log,
                         const void* bm, const void* cm, const float* d_skip,
                         const float* state_in, void* y, float* state_out,
                         double* cum, float* states, int b, int len, int h,
                         int p, int g, int n, int q, cudaStream_t stream) {
  if (b <= 0 || len <= 0 || g <= 0 || h % g != 0 || q < 1 || p < kPB ||
      p % kPB != 0)
    return cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* bb = static_cast<const bf16*>(bm);
  const bf16* cb = static_cast<const bf16*>(cm);
  bf16* yb = static_cast<bf16*>(y);
  if (n == 64)
    return launch<64>(xb, dt, a_log, bb, cb, d_skip, state_in, yb, state_out,
                      cum, states, b, len, h, p, g, q, 1, stream);
  if (n == 128)
    return launch<128>(xb, dt, a_log, bb, cb, d_skip, state_in, yb,
                       state_out, cum, states, b, len, h, p, g, q, 1, stream);
  if (n > 0 && n % 256 == 0)
    return launch<256>(xb, dt, a_log, bb, cb, d_skip, state_in, yb,
                       state_out, cum, states, b, len, h, p, g, q, n / 256,
                       stream);
  if (n > 256 && n % 128 == 0)
    return launch<128>(xb, dt, a_log, bb, cb, d_skip, state_in, yb,
                       state_out, cum, states, b, len, h, p, g, q, n / 128,
                       stream);
  return cudaErrorInvalidValue;
}
