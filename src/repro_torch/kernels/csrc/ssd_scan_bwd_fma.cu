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
// Five kinds of launch on one stream (the wrapper counts them as one):
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
//     a fixed order, the loop over k unrolled.  No tensor cores, no TMA.
//   * Slabs of 64 rows (32 where 64 would not fit a block's shared
//     memory, e.g. d_state 256); shared-memory rows padded to an odd
//     length, so that reads along either axis spread over the banks.
//   * Sub-problems.  Where even slabs of 32 rows of the whole (N, P)
//     would not fit a block's 232,448 B (reckoned before the launch), the
//     state's rows are cut into slices and the head into column blocks,
//     halving the larger until they fit; kernels 1, 3 and 4 run once per
//     (slice, block), in that order, and each output that sums over
//     slices or blocks (dx over slices; dB, dC and the float64 row terms
//     over blocks) is added to what the launches before left.
//   * Any chunk.  Nothing is held for the whole chunk: kernel 1 scans the
//     cumsum in tiles of 256 rows with a carry (a first walk finds the
//     last row, the decay of w), kernels 3 and 4 read the cumsum and dt
//     of each slab with its rows, and the close kernel walks a long chunk
//     tile by tile, its reverse cumsum from the last tile back.
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
// Shapes: any N, P and chunk, H % G == 0.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileQ = kThreads;  // chunk rows of a scan tile (one a thread)
constexpr int kChunkR = 32;    // rows of a slab in the chunk-sums kernel

__device__ __forceinline__ float to_f32(float v) { return v; }

// out(m, n) (+)= sum_k A(m, k) B(k, n) for m < M, n < N, with A(m, k) at
// a[m * a_rs + k * a_cs] and B(k, n) at b[k * b_rs + n * b_cs], all in
// shared memory.  Thread e of the block takes the 4 x 4 tile of rows
// e / nq + {0, 1, 2, 3} mq and columns e % nq + {0, 1, 2, 3} nq (mq, nq =
// M / 4, N / 4 rounded up), the k in ascending order, one FMA each.  K > 0
// is k known at compile time, its loop unrolled whole (the chunk sums'
// slabs); else the loop over k is unrolled by 4.
template <bool kAcc, int K = 0>
__device__ __forceinline__ void block_mm(float* out, int ldo, const float* a,
                                         int a_rs, int a_cs, const float* b,
                                         int b_rs, int b_cs, int m, int n,
                                         int k) {
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
    auto step = [&](int kk) {
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
    };
    if constexpr (K > 0) {
#pragma unroll
      for (int kk = 0; kk < K; ++kk) step(kk);
    } else {
#pragma unroll 4
      for (int kk = 0; kk < k; ++kk) step(kk);
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
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          int64_t stride, int row0, int rows,
                                          int qc_rel, int width) {
  for (int e = threadIdx.x; e < rows * width; e += kThreads) {
    const int r = e / width, col = e % width;
    dst[r * ld + col] =
        r < qc_rel ? to_f32(src[static_cast<int64_t>(row0 + r) * stride +
                                col])
                   : 0.f;
  }
}

// A sub-problem: n state rows (a slice of n_ld) and p head columns (a
// block of p_ld); the operands' pointers are offset to them.  Outputs
// that sum over slices (acc_k) or blocks (acc_p), and the float64 row
// terms (acc_rows), are added to what the launches before left.
struct Dims {
  int b, len, h, p, g, n, q, nc;
  int n_ld, p_ld;
  int acc_k, acc_p, acc_rows, first_k;
  __host__ __device__ int rep() const { return h / g; }
};

template <typename T>
__device__ __forceinline__ void put(T* p, T v, bool acc) {
  *p = acc ? *p + v : v;
}

// ---------------------------------------------------------------------
// 1. Per (b, h, chunk): cum, B^T (x dt w) and C^T (exp(cum) dy).
//    Shared memory (floats after the doubles): cum[kTileQ] and wsum
//    (doubles); dt, w, e (kTileQ each); B and C slabs [kChunkR][N + 1];
//    x dt w and exp(cum) dy slabs [kChunkR][P + 1]; the two sums [N][P + 1].
__host__ __device__ inline int64_t chunk_smem(int n, int p) {
  return 8 * (kTileQ + kWarps) +
         4 * (3 * kTileQ + 2 * kChunkR * (n + 1) + 2 * kChunkR * (p + 1) +
              2 * static_cast<int64_t>(n) * (p + 1));
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
  double* wsum = cum + kTileQ;
  float* dts = reinterpret_cast<float*>(wsum + kWarps);
  float* ws = dts + kTileQ;
  float* es = ws + kTileQ;
  float* bs = es + kTileQ;
  float* cs = bs + kChunkR * (n + 1);
  float* xs = cs + kChunkR * (n + 1);
  float* ys = xs + kChunkR * (p + 1);
  float* lacc = ys + kChunkR * (p + 1);
  float* eacc = lacc + n * (p + 1);

  const float a = -expf(a_log[h]);
  const int64_t bh = static_cast<int64_t>(b) * d.h + h;
  // tile t's cumsum (one row a thread, after carry) into cum and dt into
  // dts; returns its last row's cumsum, the same in every thread
  auto scan = [&](int t, double carry) {
    const int r0 = t * kTileQ, rows = min(kTileQ, qc - r0);
    const bool live = tid < rows;
    const float dtv =
        live ? dt[(static_cast<int64_t>(b) * d.len + c0 + r0 + tid) * d.h +
                  h]
             : 0.f;
    const double v =
        block_scan(live ? static_cast<double>(dtv * a) : 0.0, wsum) + carry;
    __syncthreads();  // the tile before is read
    cum[tid] = v;
    dts[tid] = dtv;
    __syncthreads();
    return cum[rows - 1];
  };
  const int n_tiles = (qc + kTileQ - 1) / kTileQ;
  double carry = 0.0;
  for (int t = 0; t < n_tiles; ++t) carry = scan(t, carry);
  const double last = carry;
  // w and exp(cum) of the tile from row t0 (its cumsum in cum); the first
  // sub-problem writes the cumsum out
  auto weigh = [&](int t0) {
    if (tid < min(kTileQ, qc - t0)) {
      if (d.first_k && d.acc_p == 0)
        cum_out[bh * d.len + c0 + t0 + tid] = cum[tid];
      ws[tid] = expf(static_cast<float>(last - cum[tid]));
      es[tid] = expf(static_cast<float>(cum[tid]));
    } else {
      ws[tid] = es[tid] = 0.f;
    }
  };
  if (n_tiles > 1) carry = scan(0, 0.0);
  weigh(0);
  for (int e = tid; e < n * (p + 1); e += kThreads) lacc[e] = eacc[e] = 0.f;
  __syncthreads();

  const int64_t row_bn = static_cast<int64_t>(d.g) * d.n_ld;   // B, C rows
  const int64_t row_xp = static_cast<int64_t>(d.h) * d.p_ld;   // x, dy rows
  const T* b0 = bm + (static_cast<int64_t>(b) * d.len + c0) * row_bn +
                g * d.n_ld;
  const T* cp = cm + (static_cast<int64_t>(b) * d.len + c0) * row_bn +
                g * d.n_ld;
  const T* x0 = x + (static_cast<int64_t>(b) * d.len + c0) * row_xp +
                h * d.p_ld;
  const T* y0 = dy + (static_cast<int64_t>(b) * d.len + c0) * row_xp +
                h * d.p_ld;
  for (int r0 = 0; r0 < qc; r0 += kChunkR) {
    if (r0 > 0 && r0 % kTileQ == 0) {  // the next tile
      carry = scan(r0 / kTileQ, carry);
      weigh(r0);
      __syncthreads();
    }
    load_rows(bs, n + 1, b0, row_bn, r0, kChunkR, qc - r0, n);
    load_rows(cs, n + 1, cp, row_bn, r0, kChunkR, qc - r0, n);
    load_rows(xs, p + 1, x0, row_xp, r0, kChunkR, qc - r0, p);
    load_rows(ys, p + 1, y0, row_xp, r0, kChunkR, qc - r0, p);
    __syncthreads();
    for (int e = tid; e < kChunkR * p; e += kThreads) {
      const int r = e / p, col = e % p, rt = r0 % kTileQ + r;
      xs[r * (p + 1) + col] *= dts[rt] * ws[rt];
      ys[r * (p + 1) + col] *= es[rt];
    }
    __syncthreads();
    // (N x P) += (rows x N)^T (rows x P)
    block_mm<true, kChunkR>(lacc, p + 1, bs, 1, n + 1, xs, p + 1, 1, n, p,
                            kChunkR);
    block_mm<true, kChunkR>(eacc, p + 1, cs, 1, n + 1, ys, p + 1, 1, n, p,
                            kChunkR);
    __syncthreads();
  }
  const int64_t base = (bh * d.nc + c) * d.n_ld * d.p_ld;
  for (int e = tid; e < n * p; e += kThreads) {
    const int nn = e / p, pp = e % p;
    own[base + nn * d.p_ld + pp] = lacc[nn * (p + 1) + pp];
    pull[base + nn * d.p_ld + pp] = eacc[nn * (p + 1) + pp];
  }
}

// ---------------------------------------------------------------------
// 2. Per (b, h): the state passing both ways, in place, one thread per
//    state entry (strided); then <S_in, dS> of every chunk.  Launched
//    once, over the whole (N, P).
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
  const int64_t np = static_cast<int64_t>(d.n) * d.p;
  for (int64_t e = threadIdx.x; e < np; e += kThreads) {
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
    for (int64_t e = threadIdx.x; e < np; e += kThreads) {
      const int64_t at = (bh * d.nc + c) * np + e;
      part += static_cast<double>(own[at] * pull[at]);
    }
    const double total = block_sum(part, red);
    if (threadIdx.x == 0) sdot[bh * d.nc + c] = static_cast<float>(total);
  }
}

// ---------------------------------------------------------------------
// Shared-memory layout of the row and column kernels, R rows a slab:
// doubles: the cumsum of the slab's own rows and of the other slab's, and
// three [R] sums; floats: dt of the key slab j, then the slabs (rows
// padded to odd lengths).  The union region u holds either the state (N x (P +
// 1)) or a slab pair (R x (N + 1) + R x (P + 1)).
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
    return r + r * ln() + r * lp() + u() + 2 * r * lr() + r * ln();
  }
  __host__ __device__ int cols_floats() const {   // kernel 4
    return r + 2 * r * ln() + 2 * r * lp() + u() + 2 * r * lr() + r * lp();
  }
  __host__ __device__ int64_t doubles_bytes() const { return 8 * (5 * r); }
  __host__ __device__ int64_t bytes() const {
    const int f = rows_floats() > cols_floats() ? rows_floats()
                                                : cols_floats();
    return doubles_bytes() + 4LL * f;
  }
};

// rows r0 .. r0 + r - 1 of the chunk's cum (from kernel 1) and dt (where
// dts) into shared memory, 0 past its end
__device__ __forceinline__ void load_cum(double* cums, float* dts,
                                         const double* cum, const float* dt,
                                         int64_t bh, int b, int h, int c0,
                                         int qc, int r0, int r,
                                         const Dims& d) {
  for (int i = threadIdx.x; i < r; i += kThreads) {
    const bool ok = r0 + i < qc;
    cums[i] = ok ? cum[bh * d.len + c0 + r0 + i] : 0.0;
    if (dts != nullptr)
      dts[i] = ok ? dt[(static_cast<int64_t>(b) * d.len + c0 + r0 + i) *
                           d.h + h]
                  : 0.f;
  }
}

// L_ij, masked before the exp: 0 above the diagonal and past the chunk
__device__ __forceinline__ float decay_ij(double ci, double cj, int i, int j,
                                          int qc) {
  return (j <= i && i < qc) ? expf(static_cast<float>(ci - cj)) : 0.f;
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
  double* ci_cum = reinterpret_cast<double*>(smem_raw);
  double* cj_cum = ci_cum + r;
  double* rowm = cj_cum + r;
  float* dtj = reinterpret_cast<float*>(ci_cum + 5 * r);
  float* ci = dtj + r;
  float* dyi = ci + r * sl.ln();
  float* u = dyi + r * sl.lp();
  float* bj = u;                        // slab pair j, or S_in
  float* xj = u + r * sl.ln();
  float* st = u + sl.u();
  float* gt = st + r * sl.lr();
  float* dci = gt + r * sl.lr();

  const int64_t bh = static_cast<int64_t>(b) * d.h + h;
  const int64_t row_bn = static_cast<int64_t>(d.g) * d.n_ld;
  const int64_t row_xp = static_cast<int64_t>(d.h) * d.p_ld;
  const int64_t at_bn = (static_cast<int64_t>(b) * d.len + c0) * row_bn +
                        g * d.n_ld;
  const int64_t at_xp = (static_cast<int64_t>(b) * d.len + c0) * row_xp +
                        h * d.p_ld;
  load_cum(ci_cum, nullptr, cum, dt, bh, b, h, c0, qc, i0, r, d);
  load_rows(ci, sl.ln(), cm + at_bn, row_bn, i0, r, qc - i0, n);
  load_rows(dyi, sl.lp(), dy + at_xp, row_xp, i0, r, qc - i0, p);
  const float* s0 = s_in + (bh * d.nc + c) * d.n_ld * d.p_ld;
  for (int e = tid; e < n * p; e += kThreads)
    u[(e / p) * sl.lp() + e % p] = s0[(e / p) * d.p_ld + e % p];
  __syncthreads();

  // dy S_in^T (r x N), and the state term of dcum
  block_mm<false>(dci, sl.ln(), dyi, sl.lp(), 1, u, 1, sl.lp(), r, n, p);
  __syncthreads();
  const int tpr = kThreads / r, row = tid / tpr, sub = tid % tpr;
  const int i = i0 + row;
  {
    const float ei = i < qc ? expf(static_cast<float>(ci_cum[row])) : 0.f;
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
    load_cum(cj_cum, dtj, cum, dt, bh, b, h, c0, qc, j0, r, d);
    __syncthreads();
    // S = C_i B_j^T and G = dy_i x_j^T (r x r)
    block_mm<false>(st, sl.lr(), ci, sl.ln(), 1, bj, 1, sl.ln(), r, r, n);
    block_mm<false>(gt, sl.lr(), dyi, sl.lp(), 1, xj, 1, sl.lp(), r, r, p);
    __syncthreads();
    double msum = 0.0;
    for (int jj = sub; jj < r; jj += tpr) {
      const int j = j0 + jj;
      const float l = decay_ij(ci_cum[row], cj_cum[jj], i, j, qc);
      float* gp = gt + row * sl.lr() + jj;
      const float z = (*gp * l) * dtj[jj];              // G L dt_j
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
      put(dc + ((static_cast<int64_t>(b) * d.len + c0 + i0 + rr) * d.h + h) *
                   d.n_ld + nn,
          dci[rr * sl.ln() + nn], d.acc_p);
  }
  if (tid < r && i0 + tid < qc)
    put(rowpart + bh * d.len + c0 + i0 + tid, rowm[tid], d.acc_rows);
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
  double* cj_cum = reinterpret_cast<double*>(smem_raw);
  double* ci_cum = cj_cum + r;
  double* colm = ci_cum + r;
  double* qd = colm + r;
  float* dtj = reinterpret_cast<float*>(cj_cum + 5 * r);
  float* bj = dtj + r;
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
  const int64_t row_bn = static_cast<int64_t>(d.g) * d.n_ld;
  const int64_t row_xp = static_cast<int64_t>(d.h) * d.p_ld;
  const int64_t at_bn = (static_cast<int64_t>(b) * d.len + c0) * row_bn +
                        g * d.n_ld;
  const int64_t at_xp = (static_cast<int64_t>(b) * d.len + c0) * row_xp +
                        h * d.p_ld;
  load_cum(cj_cum, dtj, cum, dt, bh, b, h, c0, qc, j0, r, d);
  load_rows(bj, sl.ln(), bm + at_bn, row_bn, j0, r, qc - j0, n);
  load_rows(xj, sl.lp(), x + at_xp, row_xp, j0, r, qc - j0, p);
  for (int e = tid; e < r * sl.ln(); e += kThreads) dbj[e] = 0.f;
  for (int e = tid; e < r * sl.lp(); e += kThreads) dxj[e] = 0.f;
  if (tid < r) colm[tid] = qd[tid] = 0.0;
  const int tpr = kThreads / r, row = tid / tpr, sub = tid % tpr;
  const int j = j0 + row;
  __syncthreads();
  const float dtr = dtj[row];
  const double cjr = cj_cum[row];
  for (int i0 = j0; i0 < qc; i0 += r) {
    __syncthreads();  // u and the tiles are free
    load_rows(ci, sl.ln(), cm + at_bn, row_bn, i0, r, qc - i0, n);
    load_rows(dyi, sl.lp(), dy + at_xp, row_xp, i0, r, qc - i0, p);
    load_cum(ci_cum, nullptr, cum, dt, bh, b, h, c0, qc, i0, r, d);
    __syncthreads();
    // S^T = B_j C_i^T and G^T = x_j dy_i^T (r x r)
    block_mm<false>(st, sl.lr(), bj, sl.ln(), 1, ci, 1, sl.ln(), r, r, n);
    block_mm<false>(gt, sl.lr(), xj, sl.lp(), 1, dyi, 1, sl.lp(), r, r, p);
    __syncthreads();
    double msum = 0.0, qsum = 0.0;
    for (int ii = sub; ii < r; ii += tpr) {
      const float l = decay_ij(ci_cum[ii], cjr, i0 + ii, j, qc);
      float* sp = st + row * sl.lr() + ii;
      float* gp = gt + row * sl.lr() + ii;
      const float sv = *sp, gv = *gp;
      const float y = gv * l;                            // G L
      const float z = y * dtr;                           // G L dt_j
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
  const float* dso = ds_out + (bh * d.nc + c) * d.n_ld * d.p_ld;
  for (int e = tid; e < n * p; e += kThreads)
    u[(e / p) * sl.lp() + e % p] = dso[(e / p) * d.p_ld + e % p];
  __syncthreads();
  // B_j dS (r x P)
  block_mm<false>(tmp, sl.lp(), bj, sl.ln(), 1, u, sl.lp(), 1, r, p, n);
  __syncthreads();
  {
    const double last = cum[bh * d.len + c0 + qc - 1];
    const bool live = j < qc;
    const float w = live ? expf(static_cast<float>(last - cjr)) : 0.f;
    const float dsk = d.first_k ? d_skip[h] : 0.f;
    float xb = 0.f, dd = 0.f;
    for (int pp = sub; pp < p; pp += tpr) {
      float* xp = xj + row * sl.lp() + pp;
      const float bds = tmp[row * sl.lp() + pp];
      xb += *xp * bds;
      if (live) {
        const int64_t at = at_xp + static_cast<int64_t>(j) * row_xp + pp;
        const float dyv = to_f32(dy[at]);
        dd += dyv * *xp;
        put(dx + at, dtr * (dxj[row * sl.lp() + pp] + w * bds) + dsk * dyv,
            d.acc_k);
      }
      *xp *= w;
    }
    xb = group_sum(xb, tpr);
    dd = group_sum(dd, tpr);
    if (sub == 0 && live) {
      const int64_t at = bh * d.len + c0 + j;
      const int64_t plane = static_cast<int64_t>(d.b) * d.h * d.len;
      put(rows + plane * 1 + at, colm[row], d.acc_rows);
      put(rows + plane * 2 + at, qd[row], d.acc_rows);
      put(rows + plane * 3 + at, static_cast<double>(xb), d.acc_rows);
      if (d.first_k)
        put(rows + plane * 4 + at, static_cast<double>(dd), d.acc_p);
    }
  }
  __syncthreads();
  // + (w x_j) dS^T (r x N)
  block_mm<true>(dbj, sl.ln(), xj, sl.lp(), 1, u, 1, sl.lp(), r, n, p);
  __syncthreads();
  for (int e = tid; e < r * n; e += kThreads) {
    const int rr = e / n, nn = e % n;
    if (j0 + rr < qc)
      put(db + ((static_cast<int64_t>(b) * d.len + c0 + j0 + rr) * d.h + h) *
                   d.n_ld + nn,
          dtj[rr] * dbj[rr * sl.ln() + nn], d.acc_p);
  }
}

// ---------------------------------------------------------------------
// 5. Per (b, h, chunk): dcum, its reverse cumsum d(dt a), ddt, and the
//    chunk's partials a sum dt d(dt a) (of d a_log) and sum dy.x (of
//    d d_skip).  One thread per row of a tile; a longer chunk is walked
//    tile by tile, its reverse cumsum from the last tile back, carried.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_close_kernel(const float* __restrict__ dt,
                     const float* __restrict__ a_log,
                     const double* __restrict__ cum,
                     const double* __restrict__ rows,
                     const float* __restrict__ sdot, float* __restrict__ ddt,
                     float* __restrict__ parts, Dims d) {
  __shared__ double red[kWarps];
  __shared__ double dda[kTileQ];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * d.q, qc = min(d.q, d.len - c0), tid = threadIdx.x;
  const int64_t bh = static_cast<int64_t>(b) * d.h + h;
  const int64_t plane = static_cast<int64_t>(d.b) * d.h * d.len;
  const float a = -expf(a_log[h]);
  const double last = cum[bh * d.len + c0 + qc - 1];
  struct Row {
    float w, dti, t;
    double qd, xb, dd, dcum;
  };
  auto row_of = [&](int i) {
    Row r{0.f, 0.f, 0.f, 0.0, 0.0, 0.0, 0.0};
    if (i >= qc) return r;
    const int64_t at = bh * d.len + c0 + i;
    const double cumi = cum[at];
    r.qd = rows[2 * plane + at];
    r.xb = rows[3 * plane + at];
    r.dd = rows[4 * plane + at];
    r.dti = dt[(static_cast<int64_t>(b) * d.len + c0 + i) * d.h + h];
    r.w = expf(static_cast<float>(last - cumi));
    r.t = r.w * r.dti * static_cast<float>(r.xb);
    r.dcum = rows[at] - rows[plane + at] - static_cast<double>(r.t);
    return r;
  };
  double t_part = 0.0;
  for (int i = tid; i < qc; i += kThreads)
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
      dcum += static_cast<double>(expf(static_cast<float>(last)) *
                                  sdot[bh * d.nc + c]) + t_sum;
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
      ddt[(static_cast<int64_t>(b) * d.len + c0 + i) * d.h + h] =
          static_cast<float>(r.qd) + r.w * static_cast<float>(r.xb) +
          a * static_cast<float>(ddai);
    da += static_cast<double>(r.dti) * ddai;
    ds += r.dd;
    carry = dda[0];
  }
  da = block_sum(da, red);
  ds = block_sum(ds, red);
  if (tid == 0) {
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
  // the sub-problems' size: the whole (N, P), halved along the larger
  // until a block of each kernel fits; slabs of 64 rows where they fit
  int ns = d.n, pw = d.p;
  auto fits = [&](int r) {
    return chunk_smem(ns, pw) <= limit && Slab{r, ns, pw}.bytes() <= limit;
  };
  while (!fits(32)) {
    if (ns == 1 && pw == 1) return cudaErrorInvalidValue;
    if (ns >= pw)
      ns = (ns + 1) / 2;
    else
      pw = (pw + 1) / 2;
  }
  const int r = fits(64) ? 64 : 32;
  const int64_t chunk_bytes = chunk_smem(ns, pw);
  const int64_t slab_bytes = Slab{r, ns, pw}.bytes();
  if ((err = allow_smem(ssd_bwd_chunk_kernel<T>, chunk_bytes)) !=
          cudaSuccess ||
      (err = allow_smem(ssd_bwd_rows_kernel<T>, slab_bytes)) != cudaSuccess ||
      (err = allow_smem(ssd_bwd_cols_kernel<T>, slab_bytes)) != cudaSuccess)
    return err;
  const dim3 per_chunk(d.nc, d.h, d.b);
  const dim3 per_slab(d.nc * ((d.q + r - 1) / r), d.h, d.b);
  // sub-problem (k0, p0): state rows k0 .., head columns p0 ..
  auto sub = [&](int k0, int p0) {
    Dims s = d;
    s.n = min(ns, d.n - k0);
    s.p = min(pw, d.p - p0);
    s.acc_k = k0 > 0;
    s.acc_p = p0 > 0;
    s.acc_rows = k0 + p0 > 0;
    s.first_k = k0 == 0;
    return s;
  };
  for (int k0 = 0; k0 < d.n; k0 += ns)
    for (int p0 = 0; p0 < d.p; p0 += pw) {
      const Dims s = sub(k0, p0);
      const int64_t st = static_cast<int64_t>(k0) * d.p + p0;
      ssd_bwd_chunk_kernel<T><<<per_chunk, kThreads, chunk_bytes, stream>>>(
          x + p0, dt, a_log, bm + k0, cm + k0, dy + p0, cum, states + st,
          pulls + st, s);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  ssd_bwd_pass_kernel<<<dim3(d.h, d.b), kThreads, 0, stream>>>(
      cum, state_in, dfinal, states, pulls, dstate, sdot, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int k0 = 0; k0 < d.n; k0 += ns)
    for (int p0 = 0; p0 < d.p; p0 += pw) {
      const Dims s = sub(k0, p0);
      const int64_t st = static_cast<int64_t>(k0) * d.p + p0;
      ssd_bwd_rows_kernel<T><<<per_slab, kThreads, slab_bytes, stream>>>(
          x + p0, dt, bm + k0, cm + k0, dy + p0, cum, states + st, dc + k0,
          rows, s, r);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      ssd_bwd_cols_kernel<T><<<per_slab, kThreads, slab_bytes, stream>>>(
          x + p0, dt, bm + k0, cm + k0, dy + p0, d_skip, cum, pulls + st,
          dx + p0, db + k0, rows, s, r);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
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
// float32, rows (5, B, H, L) float64.  All contiguous; q >= 1, N >= 1,
// P >= 1, H % G == 0.
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
  if (b <= 0 || len <= 0 || g <= 0 || h % g != 0 || q < 1 || n < 1 || p < 1)
    return cudaErrorInvalidValue;
  const Dims d{b, len, h, p, g, n, q, (len + q - 1) / q, n, p, 0, 0, 0, 1};
  return launch<float>(x, dt, a_log, bm, cm, d_skip, state_in, dy, dfinal,
                       dx, ddt, db, dc, dstate, parts, cum, states, pulls,
                       sdot, rows, d, stream);
}
