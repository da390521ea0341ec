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
//     rows and takes the key blocks (B and x) through a two-stage ring,
//     94.2 KB.  Two blocks fit on an SM.
//   * Causality.  Phase 3 visits only the key blocks left of its slab's
//     diagonal and masks only the diagonal block; its heaviest slabs are
//     launched first.
//   * Ragged lengths.  The last chunk may be short: rows past the end
//     load as zeros and are never stored.
// Shapes: N in {64, 128, 256} and P a multiple of 64 (the Python wrapper
// zero-pads other N <= 256 and P), chunk <= 256.

#include "wgmma.cuh"

namespace {

constexpr int kBQ = 64;       // rows of a slab (chunk rows, keys, K-slabs)
constexpr int kPB = 64;       // columns of P a block takes
constexpr int kMaxQ = 256;    // chunk rows
constexpr int kStages = 2;    // depth of the rings
constexpr int kPassThreads = 256;

// ---------------------------------------------------------------------
// Phase 1: the chunk states.  Block (chunk, head, batch x P block), N / 64
// warpgroups, warpgroup w owning state rows 64 w .. 64 w + 63.  Shared
// memory: per stage the B slab (64 x N) and the three bf16 terms of w dt x
// (3 x 64 x 64), then one mbarrier per stage, cum (double) and w dt.

template <int N>
__host__ __device__ constexpr int states_smem_bytes() {
  return 1024 + kStages * (kBQ * N * 2 + 3 * kSplitTile) + 8 * kStages +
         kMaxQ * (8 + 4);
}

template <int N>
__global__ void __launch_bounds__(2 * N)
ssd_states_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a_log,
                  const bf16* __restrict__ bm, double* __restrict__ cum_out,
                  float* __restrict__ states, int len, int h_count, int p,
                  int g_count, int q, int n_chunks) {
  constexpr int kThreads = 2 * N;
  constexpr int kStage = kBQ * N * 2 + 3 * kSplitTile;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bars = base + kStages * kStage;
  double* cum = reinterpret_cast<double*>(smem_raw + (bars + 8 * kStages -
                                                      raw));
  float* f = reinterpret_cast<float*>(cum + kMaxQ);
  auto s_b = [&](int st) { return base + st * kStage; };
  auto s_x = [&](int st) { return base + st * kStage + kBQ * N * 2; };

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wg = tid / kWarpgroup;
  const int c = blockIdx.x, h = blockIdx.y;
  const int npb = p / kPB;
  const int b = blockIdx.z / npb, pb = blockIdx.z % npb;
  const int c0 = c * q, qc = min(q, len - c0);
  const int g = h / (h_count / g_count);
  const int64_t bh = static_cast<int64_t>(b) * h_count + h;

  if (warp == 0)
    chunk_cumsum(cum, f, dt + (static_cast<int64_t>(b) * len + c0) * h_count
                             + h, h_count, -expf(a_log[h]), qc, lane);
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bars + 8 * st, kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // f = dt w, w = exp(cum[-1] - cum); the P block 0 writes the cumsum out
  const double last = cum[qc - 1];
  for (int j = tid; j < qc; j += kThreads) {
    f[j] *= expf(static_cast<float>(last - cum[j]));
    if (pb == 0) cum_out[bh * len + c0 + j] = cum[j];
  }
  __syncthreads();

  const bf16* bsrc = bm + (static_cast<int64_t>(b) * len * g_count + g) * N;
  const bf16* xsrc =
      x + (static_cast<int64_t>(b) * len * h_count + h) * p + pb * kPB;
  const int64_t xld = static_cast<int64_t>(h_count) * p;
  const int n_slabs = (qc + kBQ - 1) / kBQ;

  // K-slab s (chunk rows 64 s ..) into stage st: B by cp.async, the three
  // bf16 terms of w dt x by the threads
  auto fill = [&](int s, int st) {
    load_tile<N, kBQ, kThreads>(s_b(st), bsrc, c0 + s * kBQ, c0 + qc, tid,
                                static_cast<int64_t>(g_count) * N);
    cp_async_arrive(bars + 8 * st);
    for (int e = tid; e < kBQ * 8; e += kThreads) {
      const int r = e / 8, ch = e % 8, j = s * kBQ + r;
      float v[8];
      if (j < qc) {
        const uint4 raw8 = *reinterpret_cast<const uint4*>(
            xsrc + (c0 + j) * xld + 8 * ch);
        const uint32_t w4[4] = {raw8.x, raw8.y, raw8.z, raw8.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 t = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&w4[i]));
          v[2 * i] = t.x * f[j];
          v[2 * i + 1] = t.y * f[j];
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
    if (s + 1 < n_slabs) fill(s + 1, (s + 1) % kStages);
    wg_wait();
    fence_regs(acc);
  }

  // rows 64 wg + r_lo (+ 8) of L, columns 8 n8 + 2 (lane % 4) + j
  const int r_lo = 64 * wg + 16 * (warp % 4) + lane / 4;
  float* dst = states + ((bh * n_chunks + c) * N + r_lo) * p + pb * kPB +
               2 * (lane % 4);
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
// warpgroup.  Shared memory: the C slab (64 x N), the three bf16 terms of
// a 64-row K-slab of S_in (3 x 64 x 64), then per stage a key block's B
// (64 x N) and x (64 x 64), then one mbarrier per stage, cum (double) and
// dt of the chunk's rows.

template <int N>
__host__ __device__ constexpr int output_smem_bytes() {
  return 1024 + kBQ * N * 2 + 3 * kSplitTile +
         kStages * (kBQ * N * 2 + kBQ * kPB * 2) + 8 * kStages +
         kMaxQ * (8 + 4);
}

template <int N>
__global__ void __launch_bounds__(kWarpgroup)
ssd_output_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                  const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                  const float* __restrict__ d_skip,
                  const double* __restrict__ cum_in,
                  const float* __restrict__ states, bf16* __restrict__ y,
                  int len, int h_count, int p, int g_count, int q,
                  int n_chunks) {
  constexpr int kThreads = kWarpgroup;
  constexpr int kTileB = kBQ * N * 2, kTileX = kBQ * kPB * 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t s_c = base, s_s = base + kTileB;
  const uint32_t ring = s_s + 3 * kSplitTile;
  const uint32_t bars = ring + kStages * (kTileB + kTileX);
  double* cum = reinterpret_cast<double*>(smem_raw + (bars + 8 * kStages -
                                                      raw));
  float* dts = reinterpret_cast<float*>(cum + kMaxQ);
  auto s_b = [&](int st) { return ring + st * (kTileB + kTileX); };
  auto s_x = [&](int st) { return s_b(st) + kTileB; };

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
  const int g = h / (h_count / g_count);
  const int64_t bh = static_cast<int64_t>(b) * h_count + h;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bars + 8 * st, kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int j = tid; j < nblk * kBQ; j += kThreads) {
    const bool ok = j < qc;
    cum[j] = ok ? cum_in[bh * len + c0 + j] : 0.0;
    dts[j] = ok ? dt[(static_cast<int64_t>(b) * len + c0 + j) * h_count + h]
                : 0.f;
  }
  __syncthreads();

  const int64_t gld = static_cast<int64_t>(g_count) * N;
  const int64_t xld = static_cast<int64_t>(h_count) * p;
  const bf16* bsrc = bm + (static_cast<int64_t>(b) * len * g_count + g) * N;
  const bf16* csrc = cm + (static_cast<int64_t>(b) * len * g_count + g) * N;
  const bf16* xsrc =
      x + (static_cast<int64_t>(b) * len * h_count + h) * p + pb * kPB;
  auto fill = [&](int jb, int st) {
    load_tile<N, kBQ>(s_b(st), bsrc, c0 + jb * kBQ, c0 + qc, tid, gld);
    load_tile<kPB, kBQ>(s_x(st), xsrc, c0 + jb * kBQ, c0 + qc, tid, xld);
    cp_async_arrive(bars + 8 * st);
  };
  load_tile<N, kBQ>(s_c, csrc, c0 + i0, c0 + qc, tid, gld);  // with block 0
  for (int t = 0; t < kStages && t < nblk; ++t) fill(t, t);

  // cs = C S_in, S_in taken in K-slabs of 64 state rows, each split into
  // three bf16 terms; the last slab's products stay in flight
  const float* s_in =
      states + (bh * n_chunks + c) * N * static_cast<int64_t>(p) + pb * kPB;
  float cs[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) cs[i] = 0.f;
#pragma unroll 1
  for (int ks = 0; ks < N / kBQ; ++ks) {
    if (ks > 0) {
      wg_wait();  // the previous slab's products are done with s_s
      fence_regs(cs);
      __syncthreads();
    }
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
    fence_proxy_async();
    __syncthreads();
    if (ks == 0) {  // the C slab
      mbar_wait(bars, 0);
      fence_proxy_async();
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
      for (int part = 0; part < 3; ++part)
        mma_ss_n64<0, 1>(cs, desc_k<N, kBQ>(s_c, ks * (kBQ / 16) + kk),
                         desc_mn<kPB, kBQ>(s_s + part * kSplitTile, kk, 0),
                         1);
    wg_commit();
  }

  // this thread's rows of the slab: il_lo and il_lo + 8 (chunk-local)
  const int il_lo = i0 + 16 * warp + lane / 4;
  float yacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) yacc[i] = 0.f;
  for (int jb = 0; jb < nblk; ++jb) {
    const int st = jb % kStages;
    mbar_wait(bars + 8 * st, (jb / kStages) & 1);
    fence_proxy_async();

    // gm = C B^T: the slab's rows, the block's 64 keys
    float gm[32];  // the first product overwrites it
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      mma_ss(gm, desc_k<N, kBQ>(s_c, kk), desc_k<N, kBQ>(s_b(st), kk), kk);
    wg_commit();
    wg_wait();  // C S_in as well
    fence_regs(gm);
    fence_regs(cs);

    // scores = gm exp(cum_i - cum_j) dt_j, 0 right of the diagonal
    const bool diag = jb == sl;
#pragma unroll
    for (int at = 0; at < 32; ++at) {  // at = 4 n8 + 2 i + j
      const int il = il_lo + 8 * (at / 2 % 2);
      const int jl = jb * kBQ + 8 * (at / 4) + 2 * (lane % 4) + at % 2;
      gm[at] = !diag || jl <= il
                   ? gm[at] * expf(static_cast<float>(cum[il] - cum[jl])) *
                         dts[jl]
                   : 0.f;
    }
    // yacc += scores x: the scores from registers in three bf16 terms, x
    // transposed
    uint32_t fr[3][4][4];
    split_frags<64>(gm, fr);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int part = 0; part < 3; ++part)
        mma_rs(yacc, fr[part][kc], desc_mn<kPB, kBQ>(s_x(st), kc, 0));
    wg_commit();
    wg_wait();
    fence_regs(yacc);
    fence_frags(fr);
    if (jb + kStages < nblk) {
      __syncthreads();  // every warp is done with the stage refilled here
      fill(jb + kStages, st);
    }
  }

  // y = yacc + cs exp(cum_i) + x d_skip, columns 8 n8 + 2 (lane % 4) + j
  const float dsk = d_skip[h];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int il = il_lo + 8 * i;
    if (il >= qc) continue;
    const float e = expf(static_cast<float>(cum[il]));
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
                   int g, int q, cudaStream_t stream) {
  const int n_chunks = (len + q - 1) / q;
  const int npb = p / kPB;
  constexpr int s1 = states_smem_bytes<N>(), s3 = output_smem_bytes<N>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_states_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, s1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_output_kernel<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, s3);
  if (err != cudaSuccess) return err;
  ssd_states_kernel<N><<<dim3(n_chunks, h, b * npb), 2 * N, s1, stream>>>(
      x, dt, a_log, bm, cum, states, len, h, p, g, q, n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int np = N * p;
  ssd_pass_kernel<<<dim3((np + kPassThreads - 1) / kPassThreads, h, b),
                    kPassThreads, 0, stream>>>(cum, state_in, states,
                                               state_out, len, h, np, q,
                                               n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int spc = (q + kBQ - 1) / kBQ;
  ssd_output_kernel<N>
      <<<dim3(n_chunks * h * b * npb, spc), kWarpgroup, s3, stream>>>(
          x, dt, bm, cm, d_skip, cum, states, y, len, h, p, g, q, n_chunks);
  return cudaGetLastError();
}

}  // namespace

// x (B, L, H, P), b_mat and c_mat (B, L, G, N), y like x: contiguous
// bfloat16, P a multiple of 64, N in {64, 128, 256}; dt (B, L, H), a_log
// and d_skip (H,), state_in (B, H, N, P) or null, state_out (B, H, N, P):
// float32.  Scratch: cum (B, H, L) float64 and states (B, H, n_chunks, N,
// P) float32.  1 <= q <= 256, H % G == 0.
cudaError_t ssd_scan_fwd(const void* x, const float* dt, const float* a_log,
                         const void* bm, const void* cm, const float* d_skip,
                         const float* state_in, void* y, float* state_out,
                         double* cum, float* states, int b, int len, int h,
                         int p, int g, int n, int q, cudaStream_t stream) {
  if (b <= 0 || len <= 0 || g <= 0 || h % g != 0 || q < 1 || q > kMaxQ ||
      p < kPB || p % kPB != 0)
    return cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* bb = static_cast<const bf16*>(bm);
  const bf16* cb = static_cast<const bf16*>(cm);
  bf16* yb = static_cast<bf16*>(y);
  switch (n) {
    case 64:
      return launch<64>(xb, dt, a_log, bb, cb, d_skip, state_in, yb,
                        state_out, cum, states, b, len, h, p, g, q, stream);
    case 128:
      return launch<128>(xb, dt, a_log, bb, cb, d_skip, state_in, yb,
                         state_out, cum, states, b, len, h, p, g, q, stream);
    case 256:
      return launch<256>(xb, dt, a_log, bb, cb, d_skip, state_in, yb,
                         state_out, cum, states, b, len, h, p, g, q, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
