// Mamba-2 SSD chunked scan on the CUDA cores, for float32 operands: y and
// the final state of one SSD layer's prefill, any sequence length.  The
// bf16 operands of the main path go to the tensor-core kernels of
// ssd_scan.cu; the binding (sim_step_binding.cpp) chooses by dtype.  Same
// function as those, the same replaced Pallas kernel
// (repro/kernels/ssd_scan.py:31, _kernel via ssd_scan), float32 in and out.
//
// There, a sequential chunk grid axis carried the float32 (N, P) state in
// VMEM.  Here one block owns a (batch, head, 16-column slice of P) and
// walks the chunks in a loop with the state slice in shared memory.  Per
// chunk of Q rows it computes, in the reference's order:
//     cum    = inclusive cumsum of dt * a
//     scores = (C B^T) * exp(where(causal, cum_i - cum_j, -inf))
//     y      = scores @ (x dt) + (C @ S_in) * exp(cum) + x * d_skip
//     S_out  = exp(cum[-1]) S_in + B^T @ (exp(cum[-1] - cum) * x dt)
//
// What bounds it: the float32 products at the CUDA cores' 67 TFLOP/s (the
// first port of #8; the tensor cores take float32 only as TF32, which is
// ruled out).  What the design does about it:
//   * Grid width.  A prefill has B = 1, so (b, h) alone gives 24 blocks
//     for 132 SMs.  The P columns of y and of the state are independent,
//     so each block takes 16 of them: 96 blocks of 512 threads.  Each
//     recomputes its chunk's C B^T, the price of the wider grid.
//   * Shared memory.  At Q = 256 the (Q, Q) float32 scores alone are
//     256 KB, over a block's 227 KB.  The block keeps B^T of the chunk
//     (N x Q) and computes the scores in slabs of 32 query rows: the
//     slab's C rows and scores, x dt of the chunk and the state slice,
//     209.5 KB in all at the serve shape (dynamic shared memory).  Rows
//     of C and of the scores are read as float4.
//   * Causality.  A slab only computes the scores left of its diagonal;
//     columns of 32 past it are skipped by whole warps.
//   * The cumsum is carried in float64 (a warp-shuffle scan): at the
//     serve shape it reaches about -3e3 within a chunk, where a float32
//     ulp of 2.4e-4 would put that much noise into every decay factor.
//   * Ragged lengths.  The last chunk may be short: rows past the end
//     load as zeros and are never stored.
// No TF32, no tensor cores: float32 FMAs throughout.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPT = 16;        // state and y columns per block
constexpr int kSR = 32;        // query rows per score slab
constexpr int kMaxQ = 256;     // chunk rows (8 column groups of 32)
constexpr int kMaxN = 256;     // d_state (8 state rows per thread)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__host__ __device__ constexpr int round32(int v) { return (v + 31) / 32 * 32; }

// Shared-memory layout of one block (qa = chunk rounded up to 32; N a
// multiple of 4): doubles cum[qa], wsum[kWarps]; floats bt[N][qa + 1]
// (padded to 16 bytes), cs[kSR][N + 4], ss[kSR][qa + 4], xdt[qa][kPT],
// st[N][kPT], w[qa].  The rows of cs and ss are read as float4.
__host__ __device__ inline int bt_floats(int qa, int n) {
  return (n * (qa + 1) + 3) / 4 * 4;
}
inline int64_t smem_bytes(int q, int n) {
  const int qa = round32(q);
  return 8 * (qa + kWarps) +
         4 * (static_cast<int64_t>(bt_floats(qa, n)) + kSR * (n + 4) +
              kSR * (qa + 4) + qa * kPT + n * kPT + qa);
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_fma_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_log, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ d_skip,
                const float* __restrict__ state_in, T* __restrict__ y,
                float* __restrict__ state_out, int len, int h_count, int p,
                int g_count, int n, int q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int qa = round32(q);
  const int ldq = qa + 1;          // bt rows: odd, for the transposed stores
  const int ldc = n + 4;           // cs rows
  const int lds = qa + 4;          // ss rows
  double* cum = reinterpret_cast<double*>(smem_raw);
  double* wsum = cum + qa;
  float* bt = reinterpret_cast<float*>(wsum + kWarps);
  float* cs = bt + bt_floats(qa, n);
  float* ss = cs + kSR * ldc;
  float* xdt = ss + kSR * lds;
  float* st = xdt + qa * kPT;
  float* w = st + n * kPT;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p0 = blockIdx.x * kPT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (h_count / g_count);
  const float a = -expf(a_log[h]);
  const float dsk = d_skip[h];
  const int64_t state_base = (static_cast<int64_t>(b) * h_count + h) * n * p;

  for (int e = tid; e < n * kPT; e += kThreads) {
    const int pp = e % kPT;
    const int64_t at = state_base + static_cast<int64_t>(e / kPT) * p + p0 + pp;
    st[e] = (state_in != nullptr && p0 + pp < p) ? state_in[at] : 0.f;
  }

  for (int c0 = 0; c0 < len; c0 += q) {
    const int qc = min(q, len - c0);
    __syncthreads();  // the previous chunk's readers are done

    // dt of the chunk and the float64 inclusive cumsum of dt * a
    double v = 0.0;
    if (tid < qa) {
      const float dtv =
          tid < qc ? dt[(static_cast<int64_t>(b) * len + c0 + tid) * h_count +
                        h]
                   : 0.f;
      w[tid] = dtv;
      v = static_cast<double>(dtv * a);
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double t = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += t;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    if (tid < qa) {
      for (int i = 0; i < warp; ++i) v += wsum[i];
      cum[tid] = v;
    }
    // B^T and x dt of the chunk; rows past its end are zero
    for (int e = tid; e < qa * n; e += kThreads) {
      const int j = e / n;
      const int nn = e % n;
      bt[nn * ldq + j] =
          j < qc ? to_f32(bm[((static_cast<int64_t>(b) * len + c0 + j) *
                                  g_count + g) * n + nn])
                 : 0.f;
    }
    for (int e = tid; e < qa * kPT; e += kThreads) {
      const int j = e / kPT;
      const int pp = e % kPT;
      float val = 0.f;
      if (j < qc && p0 + pp < p)
        val = to_f32(x[((static_cast<int64_t>(b) * len + c0 + j) * h_count +
                        h) * p + p0 + pp]) * w[j];
      xdt[e] = val;
    }
    __syncthreads();

    for (int i0 = 0; i0 < qc; i0 += kSR) {
      // the slab's C rows
      for (int e = tid; e < kSR * n; e += kThreads) {
        const int r = e / n;
        const int nn = e % n;
        cs[r * ldc + nn] =
            i0 + r < qc ? to_f32(cm[((static_cast<int64_t>(b) * len + c0 +
                                      i0 + r) * g_count + g) * n + nn])
                        : 0.f;
      }
      __syncthreads();

      // scores of the slab: warp w has rows 4 (w % 8) .. + 3 and, with
      // lane l, the columns l + 32 c for c = w / 8, w / 8 + 2, ... left of
      // the diagonal
      {
        const int cmax = i0 / 32;
        const int r0 = 4 * (warp % 8);
        const int c0g = warp / 8;
        float acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
        const float* crow = cs + r0 * ldc;
        for (int nn = 0; nn < n; nn += 4) {
          float4 cv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            cv[r] = *reinterpret_cast<const float4*>(crow + r * ldc + nn);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float* brow = bt + (nn + u) * ldq + lane;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (c0g + 2 * c <= cmax) {
                const float bv = brow[32 * (c0g + 2 * c)];
#pragma unroll
                for (int r = 0; r < 4; ++r)
                  acc[r][c] = fmaf(lane4(cv[r], u), bv, acc[r][c]);
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + r0 + r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (c0g + 2 * c <= cmax) {
              const int j = lane + 32 * (c0g + 2 * c);
              float val = 0.f;
              if (j <= i && i < qc)
                val = acc[r][c] *
                      expf(static_cast<float>(cum[i] - cum[j]));
              ss[(r0 + r) * lds + j] = val;
            }
          }
        }
      }
      __syncthreads();

      // y of the slab: thread (r, pp) has row r of column pp; four
      // partial sums per product keep the FMAs independent
      {
        const int pp = tid % kPT;
        const int r = tid / kPT;
        // past min(i0 + 32, qc) the scores and x dt are zero, so the
        // loops run on in whole float4s
        const int jmax = (min(i0 + kSR, qc) + 3) & ~3;
        const float* sr = ss + r * lds;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        for (int j = 0; j < jmax; j += 4) {
          const float4 sv = *reinterpret_cast<const float4*>(sr + j);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            a[u] = fmaf(lane4(sv, u), xdt[(j + u) * kPT + pp], a[u]);
        }
        const float ys = (a[0] + a[1]) + (a[2] + a[3]);
        const float* cr = cs + r * ldc;
        float c4[4] = {0.f, 0.f, 0.f, 0.f};
        for (int nn = 0; nn < n; nn += 4) {
          const float4 cv = *reinterpret_cast<const float4*>(cr + nn);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            c4[u] = fmaf(lane4(cv, u), st[(nn + u) * kPT + pp], c4[u]);
        }
        const float csum = (c4[0] + c4[1]) + (c4[2] + c4[3]);
        const int i = i0 + r;
        if (p0 + pp < p && i < qc) {
          const int64_t at =
              ((static_cast<int64_t>(b) * len + c0 + i) * h_count + h) * p +
              p0 + pp;
          float out = ys + csum * expf(static_cast<float>(cum[i]));
          out += to_f32(x[at]) * dsk;
          store(&y[at], out);
        }
      }
      __syncthreads();
    }

    // the state carried into the next chunk
    const double last = cum[qc - 1];
    if (tid < qa) w[tid] = tid < qc ? expf(static_cast<float>(last - cum[tid])) : 0.f;
    __syncthreads();
    for (int e = tid; e < qa * kPT; e += kThreads) xdt[e] *= w[e / kPT];
    __syncthreads();
    {
      constexpr int kRowsPer = kMaxN / (kThreads / kPT);   // 8
      const int pp = tid % kPT;
      const int n0 = tid / kPT;
      const float decay = expf(static_cast<float>(last));
      float acc[kRowsPer];
#pragma unroll
      for (int kk = 0; kk < kRowsPer; ++kk) acc[kk] = 0.f;
      for (int j = 0; j < qc; ++j) {
        const float xv = xdt[j * kPT + pp];
#pragma unroll
        for (int kk = 0; kk < kRowsPer; ++kk) {
          const int nn = n0 + (kThreads / kPT) * kk;
          if (nn < n) acc[kk] = fmaf(bt[nn * ldq + j], xv, acc[kk]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < kRowsPer; ++kk) {
        const int nn = n0 + (kThreads / kPT) * kk;
        if (nn < n) st[nn * kPT + pp] = decay * st[nn * kPT + pp] + acc[kk];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < n * kPT; e += kThreads) {
    const int pp = e % kPT;
    if (p0 + pp < p)
      state_out[state_base + static_cast<int64_t>(e / kPT) * p + p0 + pp] =
          st[e];
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* a_log,
                   const void* bm, const void* cm, const float* d_skip,
                   const float* state_in, void* y, float* state_out, int b,
                   int len, int h, int p, int g, int n, int q,
                   cudaStream_t stream) {
  const int64_t bytes = smem_bytes(q, n);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_fma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p + kPT - 1) / kPT, h, b);
  ssd_scan_fma_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, a_log, static_cast<const T*>(bm),
      static_cast<const T*>(cm), d_skip, state_in, static_cast<T*>(y),
      state_out, len, h, p, g, n, q);
  return cudaGetLastError();
}

}  // namespace

// x (B, L, H, P), b_mat and c_mat (B, L, G, N), y like x, dt (B, L, H),
// a_log and d_skip (H,), state_in (B, H, N, P) or null, state_out (B, H,
// N, P): float32, all contiguous; 1 <= q <= 256, N <= 256 a multiple of
// 4, H % G == 0.  A (q, N) whose shared memory exceeds a block's 227 KB
// fails the launch (209.5 KB at q = 256, N = 128).
cudaError_t ssd_scan_fwd_fma(const float* x, const float* dt,
                             const float* a_log, const float* bm,
                             const float* cm, const float* d_skip,
                             const float* state_in, float* y,
                             float* state_out, int b, int len, int h, int p,
                             int g, int n, int q, cudaStream_t stream) {
  if (b <= 0 || len <= 0 || g <= 0 || h % g != 0 || q < 1 || q > kMaxQ ||
      n < 4 || n > kMaxN || n % 4 != 0 || p < 1)
    return cudaErrorInvalidValue;
  return launch<float>(x, dt, a_log, bm, cm, d_skip, state_in, y, state_out,
                       b, len, h, p, g, n, q, stream);
}
