// Backward of the Mamba-2 SSD chunked scan (#8) on the CUDA cores: the
// gradients of x, dt, a_log, B, C, d_skip and the initial state, given
// dy and the final state's gradient, for float32 operands.  (bf16
// operands go to the tensor-core kernels of ssd_scan_bwd.cu; the binding
// chooses by dtype.)
//
// It replaces no Pallas kernel: the reference's ssd_scan
// (repro/kernels/ssd_scan.py:31) has no custom_vjp, and the reference
// trains the SSD by autodiff of its jnp path (_ssd_jnp_chunked,
// repro/kernels/ops.py:145).  The port's kernels launch or raise on the
// card, so its backward is a kernel of its own, mirrored by
// repro_torch.kernels.ref.ssd_scan_bwd_ref.  Per (batch, head) and chunk
// of Q rows, with cum the in-chunk cumsum of dt a (float64), L_ij =
// exp(cum_i - cum_j) for i >= j, w_j = exp(cum[Q-1] - cum_j), S_in the
// state entering the chunk and dS the gradient of the state leaving it:
//     dS_in = exp(cum[Q-1]) dS + C^T (exp(cum) dy)
//     dx    = dt ((C B^T L)^T dy + w (B dS)) + D dy
//     dC    = (G L dt_j) B + exp(cum) (dy S_in^T),   G_ij = dy_i . x_j
//     dB    = dt ((G L)^T C + w (x dS^T))
//     dcum  = rows of M less columns of M + exp(cum) dy.(C S_in)
//             - w dt x.(B dS) (+ exp(cum[Q-1]) <S_in, dS> + sum of the
//             last term, on row Q-1),   M_ij = (C_i.B_j) L_ij dt_j G_ij
//     d(dt a) = reverse cumsum of dcum;  ddt = sum_i (C B^T L G)_ij +
//             w x.(B dS) + a d(dt a);  d a_log = a sum dt d(dt a)
// Five launches on one stream (the wrapper counts them as one):
//   1. ssd_bwd_chunk_kernel, per (batch, head, chunk): the cumsum (into a
//      float64 scratch), the chunk's own state B^T (x dt w) and the pull
//      of its output on its entering state, C^T (exp(cum) dy);
//   2. ssd_bwd_pass_kernel, per (batch, head): the state passing forward
//      (each chunk's S_in in place of its own state) and in reverse from
//      the final state's gradient (each chunk's dS in place of its pull),
//      the initial state's gradient, and <S_in, dS> per chunk;
//   3. ssd_bwd_rows_kernel, per (batch, head, chunk, slab of R rows i):
//      dC of the slab's rows (per head) and their dcum terms, over the
//      key slabs j <= i;
//   4. ssd_bwd_cols_kernel, per (batch, head, chunk, slab of R rows j):
//      dx and dB (per head) of the slab's rows and their dcum and direct
//      ddt terms, over the slabs i >= j;
//   5. ssd_bwd_close_kernel, per (batch, head, chunk): dcum's reverse
//      cumsum, ddt, and the chunk's partials of d a_log and d d_skip.
// The group sums of dB and dC over heads and the (H,) parameter sums over
// batch and chunks are left to the wrapper (fixed-axis torch.sum).
//
// What bounds it on the H100: operations.  At one mamba2-130m layer
// (B = 8, L = 2048, H = 24, P = 64, G = 1, N = 128, chunk 256) it does
// some 85 GFLOP of float32 products (C B^T and dy x^T twice, once for the
// rows and once for the columns), against some 25 GFLOP of minimal work
// at the table's convention.  This first kernel is simple, not fast:
//   * Every product is one block-wide helper (block_mm): 256 threads,
//     each a 4 x 4 tile of the output, float32 FMAs from shared memory in
//     a fixed order.  No tensor cores, no TMA.
//   * Slabs of 64 rows (32 where 64 would not fit a block's shared
//     memory, e.g. d_state 256); shared-memory rows padded to an odd
//     length, so that reads along either axis spread over the banks.
//   * Overflow.  Every exp takes a float32 difference of the float64
//     cumsum that is <= 0: L only on and below the diagonal (masked
//     before the exp), w, exp(cum) and exp(cum[Q-1]); nothing is ever
//     factored as exp(cum_i) exp(-cum_j).
//   * Precision.  The rows and columns of M cancel in the reverse cumsum
//     (pairs i, j >= k), so both sums are taken in float64 of the same
//     float32 products (the rows and the columns kernels form S, G, L and
//     M by the same operations, bit for bit), and so is the cumsum.
//   * Determinism.  No atomics: every output element is written by one
//     thread, every sum runs in a fixed order, so a repeat gives the same
//     bits.
//   * Ragged lengths.  The last chunk may be short: rows past the end
//     load as zeros and are never stored.
// Shapes: any N <= 256 and P whose slabs fit a block's shared memory,
// chunk <= 256, H % G == 0.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 256;     // chunk rows (one per thread in the scans)
constexpr int kChunkR = 32;    // rows of a slab in the chunk-sums kernel

__device__ __forceinline__ float to_f32(float v) { return v; }

// out(m, n) (+)= sum_k A(m, k) B(k, n) for m < M, n < N, with A(m, k) at
// a[m * a_rs + k * a_cs] and B(k, n) at b[k * b_rs + n * b_cs], all in
// shared memory.  Thread e of the block takes the 4 x 4 tile of rows
// e / nq + {0, 1, 2, 3} mq and columns e % nq + {0, 1, 2, 3} nq (mq, nq =
// M / 4, N / 4 rounded up), the k in ascending order, one FMA each.
template <bool kAcc>
__device__ void block_mm(float* out, int ldo, const float* a, int a_rs,
                         int a_cs, const float* b, int b_rs, int b_cs, int m,
                         int n, int k) {
  const int mq = (m + 3) / 4, nq = (n + 3) / 4;
  for (int e = threadIdx.x; e < mq * nq; e += kThreads) {
    const int r0 = e / nq, c0 = e % nq;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    const float* ap[4];
    const float* bp[4];
    bool am[4], bm[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      am[r] = r0 + r * mq < m;
      ap[r] = a + (am[r] ? r0 + r * mq : 0) * a_rs;
      bm[r] = c0 + r * nq < n;
      bp[r] = b + (bm[r] ? c0 + r * nq : 0) * b_cs;
    }
    for (int kk = 0; kk < k; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        av[r] = am[r] ? ap[r][kk * a_cs] : 0.f;
        bv[r] = bm[r] ? bp[r][kk * b_rs] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (!am[r]) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (!bm[c]) continue;
        float* o = out + (r0 + r * mq) * ldo + c0 + c * nq;
        *o = kAcc ? *o + acc[r][c] : acc[r][c];
      }
    }
  }
}

// Sum of v over the tpr consecutive lanes of a row group (tpr a power of
// two dividing 32), by the same xor tree in every lane.
template <typename V>
__device__ __forceinline__ V group_sum(V v, int tpr) {
  for (int off = tpr / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum of v over the block, the same in every thread: a warp xor tree,
// then the warps' sums in order.  red holds kWarps values.
__device__ double block_sum(double v, double* red) {
  v = group_sum(v, 32);
  __syncthreads();  // red is free
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// Inclusive scan of v over the block's threads in thread order (float64),
// as in the forward kernels: warp shuffles, then the warps' totals.
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

// Loads rows r0 .. r0 + rows - 1 of a (len, stride) matrix slice into
// shared memory as float, rows at or past qc (the chunk's end) as zeros:
// dst[r * ld + col] = src[(row0 + r) * stride + col], col < width.
template <typename T>
__device__ void load_rows(float* dst, int ld, const T* src, int64_t stride,
                          int row0, int rows, int qc_rel, int width) {
  for (int e = threadIdx.x; e < rows * width; e += kThreads) {
    const int r = e / width, col = e % width;
    dst[r * ld + col] =
        r < qc_rel ? to_f32(src[static_cast<int64_t>(row0 + r) * stride +
                                col])
                   : 0.f;
  }
}

struct Dims {
  int b, len, h, p, g, n, q, nc;
  __host__ __device__ int rep() const { return h / g; }
};

// ---------------------------------------------------------------------
// 1. Per (b, h, chunk): cum, B^T (x dt w) and C^T (exp(cum) dy).
//    Shared memory (floats after the doubles): cum[kMaxQ] and wsum
//    (doubles); dt, w, e (kMaxQ each); B and C slabs [kChunkR][N + 1];
//    x dt w and exp(cum) dy slabs [kChunkR][P + 1]; the two sums [N][P + 1].
__host__ __device__ inline int64_t chunk_smem(int n, int p) {
  return 8 * (kMaxQ + kWarps) +
         4 * (3 * kMaxQ + 2 * kChunkR * (n + 1) + 2 * kChunkR * (p + 1) +
              2 * n * (p + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a_log, const T* __restrict__ bm,
                     const T* __restrict__ cm, const T* __restrict__ dy,
                     double* __restrict__ cum_out, float* __restrict__ own,
                     float* __restrict__ pull, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * d.q, qc = min(d.q, d.len - c0);
  const int g = h / d.rep();
  const int n = d.n, p = d.p, tid = threadIdx.x;
  double* cum = reinterpret_cast<double*>(smem_raw);
  double* wsum = cum + kMaxQ;
  float* dts = reinterpret_cast<float*>(wsum + kWarps);
  float* ws = dts + kMaxQ;
  float* es = ws + kMaxQ;
  float* bs = es + kMaxQ;
  float* cs = bs + kChunkR * (n + 1);
  float* xs = cs + kChunkR * (n + 1);
  float* ys = xs + kChunkR * (p + 1);
  float* lacc = ys + kChunkR * (p + 1);
  float* eacc = lacc + n * (p + 1);

  const float a = -expf(a_log[h]);
  const int64_t bh = static_cast<int64_t>(b) * d.h + h;
  const float dtv =
      tid < qc ? dt[(static_cast<int64_t>(b) * d.len + c0 + tid) * d.h + h]
               : 0.f;
  const double v = block_scan(tid < qc ? static_cast<double>(dtv * a) : 0.0,
                              wsum);
  cum[tid] = v;
  dts[tid] = dtv;
  if (tid < qc) cum_out[bh * d.len + c0 + tid] = v;
  __syncthreads();
  const double last = cum[qc - 1];
  ws[tid] = tid < qc ? expf(static_cast<float>(last - cum[tid])) : 0.f;
  es[tid] = tid < qc ? expf(static_cast<float>(cum[tid])) : 0.f;
  for (int e = tid; e < n * (p + 1); e += kThreads) lacc[e] = eacc[e] = 0.f;
  __syncthreads();

  const int64_t row_bn = static_cast<int64_t>(d.g) * n;    // B, C rows
  const int64_t row_xp = static_cast<int64_t>(d.h) * p;    // x, dy rows
  const T* b0 = bm + (static_cast<int64_t>(b) * d.len + c0) * row_bn + g * n;
  const T* cp = cm + (static_cast<int64_t>(b) * d.len + c0) * row_bn + g * n;
  const T* x0 = x + (static_cast<int64_t>(b) * d.len + c0) * row_xp + h * p;
  const T* y0 = dy + (static_cast<int64_t>(b) * d.len + c0) * row_xp + h * p;
  for (int r0 = 0; r0 < qc; r0 += kChunkR) {
    load_rows(bs, n + 1, b0, row_bn, r0, kChunkR, qc - r0, n);
    load_rows(cs, n + 1, cp, row_bn, r0, kChunkR, qc - r0, n);
    load_rows(xs, p + 1, x0, row_xp, r0, kChunkR, qc - r0, p);
    load_rows(ys, p + 1, y0, row_xp, r0, kChunkR, qc - r0, p);
    __syncthreads();
    for (int e = tid; e < kChunkR * p; e += kThreads) {
      const int r = e / p, col = e % p;
      xs[r * (p + 1) + col] *= dts[r0 + r] * ws[r0 + r];
      ys[r * (p + 1) + col] *= es[r0 + r];
    }
    __syncthreads();
    // (N x P) += (rows x N)^T (rows x P)
    block_mm<true>(lacc, p + 1, bs, 1, n + 1, xs, p + 1, 1, n, p, kChunkR);
    block_mm<true>(eacc, p + 1, cs, 1, n + 1, ys, p + 1, 1, n, p, kChunkR);
    __syncthreads();
  }
  const int64_t base = (bh * d.nc + c) * n * p;
  for (int e = tid; e < n * p; e += kThreads) {
    const int nn = e / p, pp = e % p;
    own[base + e] = lacc[nn * (p + 1) + pp];
    pull[base + e] = eacc[nn * (p + 1) + pp];
  }
}

// ---------------------------------------------------------------------
// 2. Per (b, h): the state passing both ways, in place, one thread per
//    state entry (strided); then <S_in, dS> of every chunk.
__device__ __forceinline__ float chunk_decay(const double* cum, int64_t bh,
                                             const Dims& d, int c) {
  const int last = min(d.q * (c + 1), d.len) - 1;
  return expf(static_cast<float>(cum[bh * d.len + last]));
}

__global__ void __launch_bounds__(kThreads)
ssd_bwd_pass_kernel(const double* __restrict__ cum,
                    const float* __restrict__ state_in,
                    const float* __restrict__ dfinal, float* __restrict__ own,
                    float* __restrict__ pull, float* __restrict__ dstate,
                    float* __restrict__ sdot, Dims d) {
  __shared__ double red[kWarps];
  const int64_t bh = static_cast<int64_t>(blockIdx.y) * d.h + blockIdx.x;
  const int np = d.n * d.p;
  for (int e = threadIdx.x; e < np; e += kThreads) {
    float s = state_in != nullptr ? state_in[bh * np + e] : 0.f;
    for (int c = 0; c < d.nc; ++c) {
      const int64_t at = (bh * d.nc + c) * np + e;
      const float lc = own[at];
      own[at] = s;                                 // S_in of chunk c
      s = chunk_decay(cum, bh, d, c) * s + lc;
    }
    float ds = dfinal != nullptr ? dfinal[bh * np + e] : 0.f;
    for (int c = d.nc - 1; c >= 0; --c) {
      const int64_t at = (bh * d.nc + c) * np + e;
      const float pc = pull[at];
      pull[at] = ds;                               // dS leaving chunk c
      ds = chunk_decay(cum, bh, d, c) * ds + pc;
    }
    if (dstate != nullptr) dstate[bh * np + e] = ds;
  }
  for (int c = 0; c < d.nc; ++c) {
    double part = 0.0;
    for (int e = threadIdx.x; e < np; e += kThreads) {
      const int64_t at = (bh * d.nc + c) * np + e;
      part += static_cast<double>(own[at] * pull[at]);
    }
    const double total = block_sum(part, red);
    if (threadIdx.x == 0) sdot[bh * d.nc + c] = static_cast<float>(total);
  }
}

// ---------------------------------------------------------------------
// Shared-memory layout of the row and column kernels, R rows a slab:
// doubles cum[kMaxQ] and three [R] sums, then floats dt[kMaxQ] and the
// slabs (rows padded to odd lengths).  The union region u holds either
// the state (N x (P + 1)) or a slab pair (R x (N + 1) + R x (P + 1)).
struct Slab {
  int r, n, p;
  __host__ __device__ int ln() const { return n + 1; }
  __host__ __device__ int lp() const { return p + 1; }
  __host__ __device__ int lr() const { return r + 1; }
  __host__ __device__ int pair() const { return r * ln() + r * lp(); }
  __host__ __device__ int u() const {
    return n * lp() > pair() ? n * lp() : pair();
  }
  // floats after the doubles
  __host__ __device__ int rows_floats() const {   // kernel 3
    return kMaxQ + r * ln() + r * lp() + u() + 2 * r * lr() + r * ln();
  }
  __host__ __device__ int cols_floats() const {   // kernel 4
    return kMaxQ + 2 * r * ln() + 2 * r * lp() + u() + 2 * r * lr() +
           r * lp();
  }
  __host__ __device__ int64_t doubles_bytes() const {
    return 8 * (kMaxQ + 3 * r);
  }
};

// the chunk's cum (from kernel 1) and dt into shared memory
__device__ void load_chunk(double* cums, float* dts, const double* cum,
                           const float* dt, int64_t bh, int b, int h, int c0,
                           int qc, const Dims& d) {
  for (int i = threadIdx.x; i < kMaxQ; i += kThreads) {
    cums[i] = i < qc ? cum[bh * d.len + c0 + i] : 0.0;
    dts[i] = i < qc ? dt[(static_cast<int64_t>(b) * d.len + c0 + i) * d.h +
                         h]
                    : 0.f;
  }
}

// L_ij, masked before the exp: 0 above the diagonal and past the chunk
__device__ __forceinline__ float decay_ij(const double* cums, int i, int j,
                                          int qc) {
  return (j <= i && i < qc) ? expf(static_cast<float>(cums[i] - cums[j]))
                            : 0.f;
}

// ---------------------------------------------------------------------
// 3. Per (b, h, chunk, slab of rows i): dC of the rows (per head) and
//    their dcum terms sum_j M_ij + exp(cum_i) dy_i.(C_i S_in).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const T* __restrict__ bm, const T* __restrict__ cm,
                    const T* __restrict__ dy, const double* __restrict__ cum,
                    const float* __restrict__ s_in, float* __restrict__ dc,
                    double* __restrict__ rowpart, Dims d, int r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int spc = (d.q + r - 1) / r;
  const int c = blockIdx.x / spc, s = blockIdx.x % spc;
  const int h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * d.q, qc = min(d.q, d.len - c0), i0 = s * r;
  if (i0 >= qc) return;
  const int g = h / d.rep();
  const int n = d.n, p = d.p, tid = threadIdx.x;
  const Slab sl{r, n, p};
  double* cums = reinterpret_cast<double*>(smem_raw);
  double* rowm = cums + kMaxQ;
  float* dts = reinterpret_cast<float*>(rowm + 3 * r);
  float* ci = dts + kMaxQ;
  float* dyi = ci + r * sl.ln();
  float* u = dyi + r * sl.lp();
  float* bj = u;                        // slab pair j, or S_in
  float* xj = u + r * sl.ln();
  float* st = u + sl.u();
  float* gt = st + r * sl.lr();
  float* dci = gt + r * sl.lr();

  const int64_t bh = static_cast<int64_t>(b) * d.h + h;
  const int64_t row_bn = static_cast<int64_t>(d.g) * n;
  const int64_t row_xp = static_cast<int64_t>(d.h) * p;
  const int64_t at_bn = (static_cast<int64_t>(b) * d.len + c0) * row_bn +
                        g * n;
  const int64_t at_xp = (static_cast<int64_t>(b) * d.len + c0) * row_xp +
                        h * p;
  load_chunk(cums, dts, cum, dt, bh, b, h, c0, qc, d);
  load_rows(ci, sl.ln(), cm + at_bn, row_bn, i0, r, qc - i0, n);
  load_rows(dyi, sl.lp(), dy + at_xp, row_xp, i0, r, qc - i0, p);
  const float* s0 = s_in + (bh * d.nc + c) * n * p;
  for (int e = tid; e < n * p; e += kThreads)
    u[(e / p) * sl.lp() + e % p] = s0[e];
  __syncthreads();

  // dy S_in^T (r x N), and the state term of dcum
  block_mm<false>(dci, sl.ln(), dyi, sl.lp(), 1, u, 1, sl.lp(), r, n, p);
  __syncthreads();
  const int tpr = kThreads / r, row = tid / tpr, sub = tid % tpr;
  const int i = i0 + row;
  {
    const float ei = i < qc ? expf(static_cast<float>(cums[i])) : 0.f;
    float part = 0.f;
    for (int nn = sub; nn < n; nn += tpr) {
      float* o = dci + row * sl.ln() + nn;
      part += ci[row * sl.ln() + nn] * *o;
      *o *= ei;
    }
    part = group_sum(part, tpr);
    if (sub == 0) rowm[row] = static_cast<double>(ei * part);
  }
  for (int jb = 0; jb <= s; ++jb) {
    const int j0 = jb * r;
    __syncthreads();  // u and the tiles are free
    load_rows(bj, sl.ln(), bm + at_bn, row_bn, j0, r, qc - j0, n);
    load_rows(xj, sl.lp(), x + at_xp, row_xp, j0, r, qc - j0, p);
    __syncthreads();
    // S = C_i B_j^T and G = dy_i x_j^T (r x r)
    block_mm<false>(st, sl.lr(), ci, sl.ln(), 1, bj, 1, sl.ln(), r, r, n);
    block_mm<false>(gt, sl.lr(), dyi, sl.lp(), 1, xj, 1, sl.lp(), r, r, p);
    __syncthreads();
    double msum = 0.0;
    for (int jj = sub; jj < r; jj += tpr) {
      const int j = j0 + jj;
      const float l = decay_ij(cums, i, j, qc);
      float* gp = gt + row * sl.lr() + jj;
      const float z = (*gp * l) * dts[j];               // G L dt_j
      msum += static_cast<double>(st[row * sl.lr() + jj] * z);  // M_ij
      *gp = z;
    }
    msum = group_sum(msum, tpr);
    if (sub == 0) rowm[row] += msum;
    __syncthreads();
    block_mm<true>(dci, sl.ln(), gt, sl.lr(), 1, bj, sl.ln(), 1, r, n, r);
  }
  __syncthreads();
  for (int e = tid; e < r * n; e += kThreads) {
    const int rr = e / n, nn = e % n;
    if (i0 + rr < qc)
      dc[((static_cast<int64_t>(b) * d.len + c0 + i0 + rr) * d.h + h) * n +
         nn] = dci[rr * sl.ln() + nn];
  }
  if (tid < r && i0 + tid < qc) rowpart[bh * d.len + c0 + i0 + tid] =
      rowm[tid];
}

// ---------------------------------------------------------------------
// 4. Per (b, h, chunk, slab of rows j): dx and dB (per head) of the rows,
//    and their terms of dcum and ddt: sum_i M_ij, sum_i (C B^T L G)_ij,
//    x_j.(B_j dS) and dy_j.x_j.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_cols_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const T* __restrict__ bm, const T* __restrict__ cm,
                    const T* __restrict__ dy, const float* __restrict__ d_skip,
                    const double* __restrict__ cum,
                    const float* __restrict__ ds_out, float* __restrict__ dx,
                    float* __restrict__ db, double* __restrict__ rows,
                    Dims d, int r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int spc = (d.q + r - 1) / r;
  const int c = blockIdx.x / spc, s = blockIdx.x % spc;
  const int h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * d.q, qc = min(d.q, d.len - c0), j0 = s * r;
  if (j0 >= qc) return;
  const int g = h / d.rep();
  const int n = d.n, p = d.p, tid = threadIdx.x;
  const Slab sl{r, n, p};
  double* cums = reinterpret_cast<double*>(smem_raw);
  double* colm = cums + kMaxQ;
  double* qd = colm + r;
  float* dts = reinterpret_cast<float*>(colm + 3 * r);
  float* bj = dts + kMaxQ;
  float* dbj = bj + r * sl.ln();
  float* xj = dbj + r * sl.ln();
  float* dxj = xj + r * sl.lp();
  float* u = dxj + r * sl.lp();
  float* ci = u;                        // slab pair i, or dS
  float* dyi = u + r * sl.ln();
  float* st = u + sl.u();
  float* gt = st + r * sl.lr();
  float* tmp = gt + r * sl.lr();

  const int64_t bh = static_cast<int64_t>(b) * d.h + h;
  const int64_t row_bn = static_cast<int64_t>(d.g) * n;
  const int64_t row_xp = static_cast<int64_t>(d.h) * p;
  const int64_t at_bn = (static_cast<int64_t>(b) * d.len + c0) * row_bn +
                        g * n;
  const int64_t at_xp = (static_cast<int64_t>(b) * d.len + c0) * row_xp +
                        h * p;
  load_chunk(cums, dts, cum, dt, bh, b, h, c0, qc, d);
  load_rows(bj, sl.ln(), bm + at_bn, row_bn, j0, r, qc - j0, n);
  load_rows(xj, sl.lp(), x + at_xp, row_xp, j0, r, qc - j0, p);
  for (int e = tid; e < r * sl.ln(); e += kThreads) dbj[e] = 0.f;
  for (int e = tid; e < r * sl.lp(); e += kThreads) dxj[e] = 0.f;
  if (tid < r) colm[tid] = qd[tid] = 0.0;
  const int tpr = kThreads / r, row = tid / tpr, sub = tid % tpr;
  const int j = j0 + row;
  // rows and slabs end by kMaxQ (q <= 256 and r divides 256)
  const float dtj = dts[j];
  for (int i0 = j0; i0 < qc; i0 += r) {
    __syncthreads();  // u and the tiles are free
    load_rows(ci, sl.ln(), cm + at_bn, row_bn, i0, r, qc - i0, n);
    load_rows(dyi, sl.lp(), dy + at_xp, row_xp, i0, r, qc - i0, p);
    __syncthreads();
    // S^T = B_j C_i^T and G^T = x_j dy_i^T (r x r)
    block_mm<false>(st, sl.lr(), bj, sl.ln(), 1, ci, 1, sl.ln(), r, r, n);
    block_mm<false>(gt, sl.lr(), xj, sl.lp(), 1, dyi, 1, sl.lp(), r, r, p);
    __syncthreads();
    double msum = 0.0, qsum = 0.0;
    for (int ii = sub; ii < r; ii += tpr) {
      const float l = decay_ij(cums, i0 + ii, j, qc);
      float* sp = st + row * sl.lr() + ii;
      float* gp = gt + row * sl.lr() + ii;
      const float sv = *sp, gv = *gp;
      const float y = gv * l;                            // G L
      const float z = y * dtj;                           // G L dt_j
      const float slv = sv * l;                          // C B^T L
      msum += static_cast<double>(sv * z);               // M_ij
      qsum += static_cast<double>(slv * gv);
      *sp = slv;
      *gp = y;
    }
    msum = group_sum(msum, tpr);
    qsum = group_sum(qsum, tpr);
    if (sub == 0) {
      colm[row] += msum;
      qd[row] += qsum;
    }
    __syncthreads();
    block_mm<true>(dxj, sl.lp(), st, sl.lr(), 1, dyi, sl.lp(), 1, r, p, r);
    block_mm<true>(dbj, sl.ln(), gt, sl.lr(), 1, ci, sl.ln(), 1, r, n, r);
  }
  __syncthreads();
  const float* dso = ds_out + (bh * d.nc + c) * n * p;
  for (int e = tid; e < n * p; e += kThreads)
    u[(e / p) * sl.lp() + e % p] = dso[e];
  __syncthreads();
  // B_j dS (r x P)
  block_mm<false>(tmp, sl.lp(), bj, sl.ln(), 1, u, sl.lp(), 1, r, p, n);
  __syncthreads();
  {
    const double last = cums[qc - 1];
    const bool live = j < qc;
    const float w = live ? expf(static_cast<float>(last - cums[j])) : 0.f;
    const float dsk = d_skip[h];
    float xb = 0.f, dd = 0.f;
    for (int pp = sub; pp < p; pp += tpr) {
      float* xp = xj + row * sl.lp() + pp;
      const float bds = tmp[row * sl.lp() + pp];
      xb += *xp * bds;
      if (live) {
        const int64_t at = at_xp + static_cast<int64_t>(j) * row_xp + pp;
        const float dyv = to_f32(dy[at]);
        dd += dyv * *xp;
        dx[at] = dtj * (dxj[row * sl.lp() + pp] + w * bds) + dsk * dyv;
      }
      *xp *= w;
    }
    xb = group_sum(xb, tpr);
    dd = group_sum(dd, tpr);
    if (sub == 0 && live) {
      const int64_t at = bh * d.len + c0 + j;
      const int64_t plane = static_cast<int64_t>(d.b) * d.h * d.len;
      rows[plane * 1 + at] = colm[row];
      rows[plane * 2 + at] = qd[row];
      rows[plane * 3 + at] = static_cast<double>(xb);
      rows[plane * 4 + at] = static_cast<double>(dd);
    }
  }
  __syncthreads();
  // + (w x_j) dS^T (r x N)
  block_mm<true>(dbj, sl.ln(), xj, sl.lp(), 1, u, 1, sl.lp(), r, n, p);
  __syncthreads();
  for (int e = tid; e < r * n; e += kThreads) {
    const int rr = e / n, nn = e % n;
    if (j0 + rr < qc)
      db[((static_cast<int64_t>(b) * d.len + c0 + j0 + rr) * d.h + h) * n +
         nn] = dts[j0 + rr] * dbj[rr * sl.ln() + nn];
  }
}

// ---------------------------------------------------------------------
// 5. Per (b, h, chunk): dcum, its reverse cumsum d(dt a), ddt, and the
//    chunk's partials a sum dt d(dt a) (of d a_log) and sum dy.x (of
//    d d_skip).
__global__ void __launch_bounds__(kThreads)
ssd_bwd_close_kernel(const float* __restrict__ dt,
                     const float* __restrict__ a_log,
                     const double* __restrict__ cum,
                     const double* __restrict__ rows,
                     const float* __restrict__ sdot, float* __restrict__ ddt,
                     float* __restrict__ parts, Dims d) {
  __shared__ double red[kWarps];
  __shared__ double dda[kMaxQ];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * d.q, qc = min(d.q, d.len - c0), i = threadIdx.x;
  const int64_t bh = static_cast<int64_t>(b) * d.h + h;
  const int64_t plane = static_cast<int64_t>(d.b) * d.h * d.len;
  const int64_t at = bh * d.len + c0 + i;
  const bool live = i < qc;
  const float a = -expf(a_log[h]);
  const double last = cum[bh * d.len + c0 + qc - 1];
  double cumi = 0.0, rowp = 0.0, colm = 0.0, qd = 0.0, xb = 0.0, dd = 0.0;
  float dti = 0.f;
  if (live) {
    cumi = cum[at];
    rowp = rows[at];
    colm = rows[plane + at];
    qd = rows[2 * plane + at];
    xb = rows[3 * plane + at];
    dd = rows[4 * plane + at];
    dti = dt[(static_cast<int64_t>(b) * d.len + c0 + i) * d.h + h];
  }
  const float w = live ? expf(static_cast<float>(last - cumi)) : 0.f;
  const float t = w * dti * static_cast<float>(xb);
  double dcum = live ? rowp - colm - static_cast<double>(t) : 0.0;
  const double t_sum = block_sum(static_cast<double>(t), red);
  if (i == qc - 1)
    dcum += static_cast<double>(expf(static_cast<float>(last)) *
                                sdot[bh * d.nc + c]) + t_sum;
  // reverse inclusive cumsum: thread k scans the element qc - 1 - k
  __syncthreads();
  if (live) dda[i] = dcum;
  __syncthreads();
  const int k = qc - 1 - i;
  const double rv = block_scan(i < qc ? dda[k] : 0.0, red);
  __syncthreads();
  if (live) dda[k] = rv;
  __syncthreads();
  const double ddai = live ? dda[i] : 0.0;
  if (live)
    ddt[(static_cast<int64_t>(b) * d.len + c0 + i) * d.h + h] =
        static_cast<float>(qd) + w * static_cast<float>(xb) +
        a * static_cast<float>(ddai);
  const double da = block_sum(static_cast<double>(dti) * ddai, red);
  const double ds = block_sum(dd, red);
  if (i == 0) {
    const int64_t nparts = static_cast<int64_t>(d.b) * d.h * d.nc;
    parts[bh * d.nc + c] = static_cast<float>(static_cast<double>(a) * da);
    parts[nparts + bh * d.nc + c] = static_cast<float>(ds);
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kernel, int64_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
cudaError_t launch(const T* x, const float* dt, const float* a_log,
                   const T* bm, const T* cm, const float* d_skip,
                   const float* state_in, const T* dy, const float* dfinal,
                   float* dx, float* ddt, float* db, float* dc, float* dstate,
                   float* parts, double* cum, float* states, float* pulls,
                   float* sdot, double* rows, const Dims& d,
                   cudaStream_t stream) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int64_t chunk_bytes = chunk_smem(d.n, d.p);
  auto slab_bytes = [&](int r) {
    const Slab sl{r, d.n, d.p};
    const int64_t rows_b = sl.doubles_bytes() + 4LL * sl.rows_floats();
    const int64_t cols_b = sl.doubles_bytes() + 4LL * sl.cols_floats();
    return rows_b > cols_b ? rows_b : cols_b;
  };
  const int r = slab_bytes(64) <= limit ? 64 : 32;
  const Slab sl{r, d.n, d.p};
  const int64_t rows_bytes = sl.doubles_bytes() + 4LL * sl.rows_floats();
  const int64_t cols_bytes = sl.doubles_bytes() + 4LL * sl.cols_floats();
  if (chunk_bytes > limit || rows_bytes > limit || cols_bytes > limit)
    return cudaErrorInvalidValue;
  if ((err = allow_smem(ssd_bwd_chunk_kernel<T>, chunk_bytes)) !=
          cudaSuccess ||
      (err = allow_smem(ssd_bwd_rows_kernel<T>, rows_bytes)) != cudaSuccess ||
      (err = allow_smem(ssd_bwd_cols_kernel<T>, cols_bytes)) != cudaSuccess)
    return err;
  const dim3 per_chunk(d.nc, d.h, d.b);
  const dim3 per_slab(d.nc * ((d.q + r - 1) / r), d.h, d.b);
  ssd_bwd_chunk_kernel<T><<<per_chunk, kThreads, chunk_bytes, stream>>>(
      x, dt, a_log, bm, cm, dy, cum, states, pulls, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_pass_kernel<<<dim3(d.h, d.b), kThreads, 0, stream>>>(
      cum, state_in, dfinal, states, pulls, dstate, sdot, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_rows_kernel<T><<<per_slab, kThreads, rows_bytes, stream>>>(
      x, dt, bm, cm, dy, cum, states, dc, rows, d, r);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_cols_kernel<T><<<per_slab, kThreads, cols_bytes, stream>>>(
      x, dt, bm, cm, dy, d_skip, cum, pulls, dx, db, rows, d, r);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_close_kernel<<<per_chunk, kThreads, 0, stream>>>(
      dt, a_log, cum, rows, sdot, ddt, parts, d);
  return cudaGetLastError();
}

}  // namespace

// x, dy (B, L, H, P) and b_mat, c_mat (B, L, G, N) float32; dt (B, L,
// H), a_log and d_skip (H,), state_in and dfinal (B, H, N, P) or null:
// float32.  Outputs, float32: dx like x, ddt like dt, db and dc (B, L, H,
// N) per head, dstate (B, H, N, P) or null, parts (2, B, H, n_chunks):
// the partials of d a_log and d d_skip.  Scratch: cum (B, H, L) float64,
// states and pulls (B, H, n_chunks, N, P) float32, sdot (B, H, n_chunks)
// float32, rows (5, B, H, L) float64.  All contiguous; 1 <= q <= 256,
// 1 <= N <= 256, H % G == 0.  A (N, P) whose slabs exceed a block's
// shared memory fails the launch.
cudaError_t ssd_scan_backward_fma(const float* x, const float* dt,
                                  const float* a_log, const float* bm,
                                  const float* cm, const float* d_skip,
                                  const float* state_in, const float* dy,
                                  const float* dfinal, float* dx, float* ddt,
                                  float* db, float* dc, float* dstate,
                                  float* parts, double* cum, float* states,
                                  float* pulls, float* sdot, double* rows,
                                  int b, int len, int h, int p, int g, int n,
                                  int q, cudaStream_t stream) {
  if (b <= 0 || len <= 0 || g <= 0 || h % g != 0 || q < 1 || q > kMaxQ ||
      n < 1 || n > 256 || p < 1)
    return cudaErrorInvalidValue;
  const Dims d{b, len, h, p, g, n, q, (len + q - 1) / q};
  return launch<float>(x, dt, a_log, bm, cm, d_skip, state_in, dy, dfinal,
                       dx, ddt, db, dc, dstate, parts, cum, states, pulls,
                       sdot, rows, d, stream);
}
