// Mamba-2 SSD chunked scan on the CUDA cores, for float32 operands: y and
// the final state of one SSD layer's prefill, any sequence length.  The
// bf16 operands of the main path go to the tensor-core kernels of
// ssd_scan.cu; the binding (sim_step_binding.cpp) chooses by dtype.  Same
// function as those, the same replaced Pallas kernel
// (repro/kernels/ssd_scan.py:31, _kernel via ssd_scan), float32 in and out.
//
// There, a sequential chunk grid axis carried the float32 (N, P) state in
// VMEM.  Here one block owns a (batch, head, 16-column slice of P, slice
// of at most 256 state rows) and walks the chunks in a loop with its part
// of the state in shared memory.  Per chunk of Q rows it computes, in the
// reference's order:
//     cum    = inclusive cumsum of dt * a
//     scores = (C B^T) * exp(where(causal, cum_i - cum_j, -inf))
//     y      = scores @ (x dt) + (C @ S_in) * exp(cum) + x * d_skip
//     S_out  = exp(cum[-1]) S_in + B^T @ (exp(cum[-1] - cum) * x dt)
// Two launches: ssd_cumsum_kernel, one warp per (batch, head, chunk), the
// float64 cumsum into a scratch; then ssd_scan_fma_kernel.
//
// What bounds it: the float32 products at the CUDA cores' 67 TFLOP/s (the
// first port of #8; the tensor cores take float32 only as TF32, which is
// ruled out).  What the design does about it:
//   * Grid width.  A prefill has B = 1, so (b, h) alone gives 24 blocks
//     for 132 SMs.  The P columns of y and of the state are independent,
//     so each block takes 16 of them: 96 blocks of 512 threads.  Each
//     recomputes its chunk's C B^T, the price of the wider grid.
//   * Shared memory is bounded by the tiles, not by the chunk: a block
//     takes the chunk's queries in slabs of 64 rows and, for each, walks
//     the key slabs of 64 rows left of its diagonal (B^T of the slab, x dt
//     and the keys' cumsum), then walks the key slabs once more for the
//     state.  With 256 state rows: 64 rows of C, 256 x 64 of B^T, the 64 x
//     64 scores, the state slice, 172.3 KB in all.  Rows of C and of the
//     scores are read as float4.
//   * A d_state over 256 is cut into slices of 256 rows: the rows of the
//     state are independent, and so are the slices' shares of y, which the
//     wrapper adds in slice order (y then holds one share per slice).
//   * Causality.  Only the key slabs left of a query slab's diagonal are
//     visited; the diagonal slab is masked.
//   * The cumsum is carried in float64 (a warp-shuffle scan): at the
//     serve shape it reaches about -3e3 within a chunk, where a float32
//     ulp of 2.4e-4 would put that much noise into every decay factor.
//   * Ragged lengths.  The last chunk may be short: rows past the end
//     load as zeros and are never stored.
// No TF32, no tensor cores: float32 FMAs throughout.
// Shapes: N a multiple of 4 (the Python wrapper zero-pads any other), any
// P and chunk, H % G == 0.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPT = 16;        // state and y columns per block
constexpr int kQS = 64;        // query rows per slab (4 per warp)
constexpr int kKS = 64;        // key rows per slab (2 columns per lane)
constexpr int kMaxN = 256;     // state rows of a slice (8 per thread)
constexpr int kLdk = kKS + 1;  // bt rows: odd, for the transposed stores
constexpr int kLds = kKS + 4;  // score rows

static_assert(kQS == 4 * kWarps && kKS == 64 && kThreads == kQS * kPT / 2,
              "the slabs do not match the threads");

__host__ __device__ constexpr int slices(int n) {
  return (n + kMaxN - 1) / kMaxN;
}

// Shared-memory layout of one block with ns state rows (a multiple of 4):
// doubles icum[kQS], kcum[kKS]; floats cs[kQS][ns + 4], bt[ns][kLdk],
// ss[kQS][kLds], xdt[kKS][kPT], st[ns][kPT], kw[kKS].
inline int64_t smem_bytes(int ns) {
  return 8 * (kQS + kKS) +
         4 * (static_cast<int64_t>(kQS) * (ns + 4) + ns * kLdk + kQS * kLds +
              kKS * kPT + ns * kPT + kKS);
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The float64 inclusive cumsum of dt a within each chunk, one warp per
// (chunk, head, batch): 32 rows at a time, a shuffle scan plus the carry.
__global__ void __launch_bounds__(32)
ssd_cumsum_kernel(const float* __restrict__ dt,
                  const float* __restrict__ a_log, double* __restrict__ cum,
                  int len, int h_count, int q) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x;
  const int c0 = c * q, qc = min(q, len - c0);
  const float a = -expf(a_log[h]);
  const int64_t bh = static_cast<int64_t>(b) * h_count + h;
  double carry = 0.0;
  for (int r0 = 0; r0 < qc; r0 += 32) {
    const int j = r0 + lane;
    const float d = j < qc ? dt[(static_cast<int64_t>(b) * len + c0 + j) *
                                    h_count + h]
                           : 0.f;
    double v = static_cast<double>(d * a);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double t = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += t;
    }
    v += carry;
    if (j < qc) cum[bh * len + c0 + j] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_fma_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ bm, const float* __restrict__ cm,
                    const float* __restrict__ d_skip,
                    const double* __restrict__ cum,
                    const float* __restrict__ state_in, float* __restrict__ y,
                    float* __restrict__ state_out, int b_count, int len,
                    int h_count, int p, int g_count, int n, int q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_sl = slices(n);
  const int ns_max = n_sl > 1 ? kMaxN : n;
  const int ldc = ns_max + 4;
  double* icum = reinterpret_cast<double*>(smem_raw);
  double* kcum = icum + kQS;
  float* cs = reinterpret_cast<float*>(kcum + kKS);
  float* bt = cs + kQS * ldc;
  float* ss = bt + ns_max * kLdk;
  float* xdt = ss + kQS * kLds;
  float* st = xdt + kKS * kPT;
  float* kw = st + ns_max * kPT;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p0 = blockIdx.x / n_sl * kPT;
  const int k = blockIdx.x % n_sl;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n0 = k * kMaxN, ns = min(kMaxN, n - n0);  // the slice's rows
  const int g = h / (h_count / g_count);
  const float dsk = k == 0 ? d_skip[h] : 0.f;  // slice 0 adds x d_skip
  const int64_t bh = static_cast<int64_t>(b) * h_count + h;
  const int64_t state_base = bh * n * p;
  // slice k's share of y
  float* yk = y + static_cast<int64_t>(k) * b_count * len * h_count * p;

  for (int e = tid; e < ns * kPT; e += kThreads) {
    const int pp = e % kPT;
    const int64_t at = state_base + static_cast<int64_t>(n0 + e / kPT) * p +
                       p0 + pp;
    st[e] = (state_in != nullptr && p0 + pp < p) ? state_in[at] : 0.f;
  }

  // rows j0 .. j0 + kKS - 1 of the chunk from c0: B^T of the slice into
  // bt, x dt (times w with `decayed`) into xdt, the cumsum into kcum;
  // rows past qc are zero
  auto load_keys = [&](int c0, int qc, int j0, bool decayed, double last) {
    if (tid < kKS) {
      const int j = j0 + tid;
      const bool ok = j < qc;
      const double cj = ok ? cum[bh * len + c0 + j] : 0.0;
      float v = ok ? dt[(static_cast<int64_t>(b) * len + c0 + j) * h_count +
                        h]
                   : 0.f;
      if (decayed && ok) v *= expf(static_cast<float>(last - cj));
      kcum[tid] = cj;
      kw[tid] = v;
    }
    for (int e = tid; e < kKS * ns; e += kThreads) {
      const int j = e / ns, nn = e % ns;
      bt[nn * kLdk + j] =
          j0 + j < qc ? bm[((static_cast<int64_t>(b) * len + c0 + j0 + j) *
                                g_count + g) * n + n0 + nn]
                      : 0.f;
    }
    __syncthreads();  // kw
    for (int e = tid; e < kKS * kPT; e += kThreads) {
      const int j = e / kPT, pp = e % kPT;
      float val = 0.f;
      if (j0 + j < qc && p0 + pp < p)
        val = x[((static_cast<int64_t>(b) * len + c0 + j0 + j) * h_count +
                 h) * p + p0 + pp] * kw[j];
      xdt[e] = val;
    }
    __syncthreads();
  };

  for (int c0 = 0; c0 < len; c0 += q) {
    const int qc = min(q, len - c0);
    const double last = cum[bh * len + c0 + qc - 1];

    for (int i0 = 0; i0 < qc; i0 += kQS) {
      __syncthreads();  // the previous slab's readers are done
      // the slab's C rows (of the slice) and cumsum
      for (int e = tid; e < kQS * ns; e += kThreads) {
        const int r = e / ns, nn = e % ns;
        cs[r * ldc + nn] =
            i0 + r < qc ? cm[((static_cast<int64_t>(b) * len + c0 + i0 + r) *
                                  g_count + g) * n + n0 + nn]
                        : 0.f;
      }
      if (tid < kQS)
        icum[tid] = i0 + tid < qc ? cum[bh * len + c0 + i0 + tid] : 0.0;

      // thread (r, pp) has rows r and r + 32 of column pp; four partial
      // sums per row keep the FMAs independent
      const int pp = tid % kPT, r = tid / kPT;
      float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j0 = 0; j0 <= i0; j0 += kKS) {
        __syncthreads();  // bt, xdt and ss are free
        load_keys(c0, qc, j0, false, last);

        // scores of (query slab, key slab): warp w has rows 4 w .. 4 w + 3
        // and, with lane l, the keys l and l + 32
        {
          const int r0 = 4 * warp;
          float acc[4][2];
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) acc[rr][0] = acc[rr][1] = 0.f;
          const float* crow = cs + r0 * ldc;
          for (int nn = 0; nn < ns; nn += 4) {
            float4 cv[4];
#pragma unroll
            for (int rr = 0; rr < 4; ++rr)
              cv[rr] = *reinterpret_cast<const float4*>(crow + rr * ldc + nn);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float* brow = bt + (nn + u) * kLdk + lane;
              const float b0 = brow[0], b1 = brow[32];
#pragma unroll
              for (int rr = 0; rr < 4; ++rr) {
                acc[rr][0] = fmaf(lane4(cv[rr], u), b0, acc[rr][0]);
                acc[rr][1] = fmaf(lane4(cv[rr], u), b1, acc[rr][1]);
              }
            }
          }
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const int i = i0 + r0 + rr;
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int jl = lane + 32 * cc;
              float val = 0.f;
              if (j0 + jl <= i && i < qc)
                val = acc[rr][cc] *
                      expf(static_cast<float>(icum[r0 + rr] - kcum[jl]));
              ss[(r0 + rr) * kLds + jl] = val;
            }
          }
        }
        __syncthreads();

        // y of the slab += scores x dt; past qc the scores and x dt are
        // zero
        const float* s0 = ss + r * kLds;
        const float* s1 = ss + (r + 32) * kLds;
        for (int j = 0; j < kKS; j += 4) {
          const float4 v0 = *reinterpret_cast<const float4*>(s0 + j);
          const float4 v1 = *reinterpret_cast<const float4*>(s1 + j);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float xv = xdt[(j + u) * kPT + pp];
            a0[u] = fmaf(lane4(v0, u), xv, a0[u]);
            a1[u] = fmaf(lane4(v1, u), xv, a1[u]);
          }
        }
      }

      // y = scores x dt + (C S_in) exp(cum) + x d_skip
      const float ys0 = (a0[0] + a0[1]) + (a0[2] + a0[3]);
      const float ys1 = (a1[0] + a1[1]) + (a1[2] + a1[3]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rr = r + 32 * half;
        const float ys = half ? ys1 : ys0;
        const float* cr = cs + rr * ldc;
        float c4[4] = {0.f, 0.f, 0.f, 0.f};
        for (int nn = 0; nn < ns; nn += 4) {
          const float4 cv = *reinterpret_cast<const float4*>(cr + nn);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            c4[u] = fmaf(lane4(cv, u), st[(nn + u) * kPT + pp], c4[u]);
        }
        const float csum = (c4[0] + c4[1]) + (c4[2] + c4[3]);
        const int i = i0 + rr;
        if (p0 + pp < p && i < qc) {
          const int64_t at =
              ((static_cast<int64_t>(b) * len + c0 + i) * h_count + h) * p +
              p0 + pp;
          float out = ys + csum * expf(static_cast<float>(icum[rr]));
          out += x[at] * dsk;
          yk[at] = out;
        }
      }
    }

    // the state carried into the next chunk: S = exp(cum[-1]) S + B^T (w x
    // dt), the keys walked once more in slabs
    {
      constexpr int kRowsPer = kMaxN / (kThreads / kPT);   // 8
      const int pp = tid % kPT;
      const int nr = tid / kPT;
      float acc[kRowsPer];
#pragma unroll
      for (int kk = 0; kk < kRowsPer; ++kk) acc[kk] = 0.f;
      for (int j0 = 0; j0 < qc; j0 += kKS) {
        __syncthreads();  // bt, xdt (and, first, cs and st) are free
        load_keys(c0, qc, j0, true, last);
        for (int j = 0; j < kKS; ++j) {
          const float xv = xdt[j * kPT + pp];
#pragma unroll
          for (int kk = 0; kk < kRowsPer; ++kk) {
            const int nn = nr + (kThreads / kPT) * kk;
            if (nn < ns) acc[kk] = fmaf(bt[nn * kLdk + j], xv, acc[kk]);
          }
        }
      }
      const float decay = expf(static_cast<float>(last));
#pragma unroll
      for (int kk = 0; kk < kRowsPer; ++kk) {
        const int nn = nr + (kThreads / kPT) * kk;
        if (nn < ns) st[nn * kPT + pp] = decay * st[nn * kPT + pp] + acc[kk];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < ns * kPT; e += kThreads) {
    const int pp = e % kPT;
    if (p0 + pp < p)
      state_out[state_base + static_cast<int64_t>(n0 + e / kPT) * p + p0 +
                pp] = st[e];
  }
}

}  // namespace

// x (B, L, H, P), b_mat and c_mat (B, L, G, N), dt (B, L, H), a_log and
// d_skip (H,), state_in (B, H, N, P) or null, state_out (B, H, N, P):
// float32, all contiguous; N a multiple of 4, q >= 1, H % G == 0.  y holds
// ceil(N / 256) shares (slices of 256 state rows) of y, each shaped like
// x: their sum in slice order is y.  Scratch: cum (B, H, L) float64.
cudaError_t ssd_scan_fwd_fma(const float* x, const float* dt,
                             const float* a_log, const float* bm,
                             const float* cm, const float* d_skip,
                             const float* state_in, float* y,
                             float* state_out, double* cum, int b, int len,
                             int h, int p, int g, int n, int q,
                             cudaStream_t stream) {
  if (b <= 0 || len <= 0 || g <= 0 || h % g != 0 || q < 1 || n < 4 ||
      n % 4 != 0 || p < 1)
    return cudaErrorInvalidValue;
  const int n_chunks = (len + q - 1) / q;
  ssd_cumsum_kernel<<<dim3(n_chunks, h, b), 32, 0, stream>>>(dt, a_log, cum,
                                                             len, h, q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t bytes = smem_bytes(slices(n) > 1 ? kMaxN : n);
  err = cudaFuncSetAttribute(ssd_scan_fma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p + kPT - 1) / kPT * slices(n), h, b);
  ssd_scan_fma_kernel<<<grid, kThreads, bytes, stream>>>(
      x, dt, bm, cm, d_skip, cum, state_in, y, state_out, b, len, h, p, g, n,
      q);
  return cudaGetLastError();
}
