// Flash-attention backward on the CUDA cores, for float32 operands: dq,
// and dk / dv per q head, of causal / sliding-window / GQA attention, any
// Sq and Skv.  The bf16 operands of the main path go to the tensor-core
// kernels of flash_attention_bwd.cu; the binding (sim_step_binding.cpp)
// chooses by dtype.  Same function as those (see there), the same
// replaced Pallas kernels (repro/kernels/flash_attention.py:152
// _dq_kernel and :192 _dkv_kernel), float32 in and out.
//
// Design (the first port of #6 and #7):
//   * flash_dq_fma_kernel: one block per (batch, q head, 64-row q tile)
//     walks the live 64-key tiles with dq in registers;
//   * flash_dkv_fma_kernel: one block per (batch, q head, 64-key tile)
//     walks the live 32-row q tiles with dk and dv in registers, and
//     writes them per q head; the wrapper sums each kv group in a fixed
//     order.  No float atomics, so a run repeats bitwise.
//   * Every product is a float32 FMA, register-tiled: a thread owns a
//     4 x 8 (#6) or 4 x 4 (#7) tile of the scores and a 4 x D/8 tile of
//     each accumulator, and reads its operands as float4 rows of shared
//     memory, staged transposed where the product runs over the head dim
//     and row-major where it runs over the keys or queries; rows are
//     padded by 4 floats.  #7's eight staged tiles take 157.7 KB at
//     D = 128 (88.1 KB at D = 64).
//   * Tiles that the reference's _tile_live rules out are never visited;
//     the ragged edges of Sq and Skv are masked in the kernel.  Under a
//     causal mask the heaviest tiles are launched first.
// What bounds them: the float32 products at the CUDA cores' 67 TFLOP/s.
// Masking: p is set to 0 on every masked entry (the reference's exp(-1e30
// - lse) is 1 on a row with no live key).  Head sizes 32, 64 and 128.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;   // 16 row groups x 8 column groups
constexpr int kBQ = 64;         // #6: query rows per block
constexpr int kBK = 64;         // #6: keys per kv tile; #7: keys per block
constexpr int kLD = 64 + 4;     // padded row of a transposed 64-wide tile
constexpr int kBQ7 = 32;        // #7: query rows per q tile
constexpr int kLD7 = kBQ7 + 4;  // padded row of a transposed 32-wide tile

// Four consecutive elements as loaded (one 16-byte load).
template <typename T>
struct Raw4;
template <>
struct Raw4<float> {
  float4 v;
};

__device__ __forceinline__ void load4(Raw4<float>& r, const float* p) {
  r.v = *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void zero4(Raw4<float>& r) {
  r.v = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ float4 to_f32(const Raw4<float>& r) { return r.v; }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Column c (0..7) of column group cg in a 64-wide tile: 4 cg .. 4 cg + 3,
// then 32 further.
__device__ __forceinline__ int col_of(int cg, int c) {
  return 4 * cg + (c & 3) + 32 * (c >> 2);
}

// Rows [r0, r0 + ROWS) of a row-major (n, D) matrix into shared memory as
// float32 times mul: transposed into t[d * ldt + r] and, if rm is given,
// row-major into rm[r * (D + 4) + d].  Rows at or past n are zero.  Lanes
// run along the rows, so that a warp's transposed stores hit consecutive
// banks.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void stage(const T* __restrict__ src, int r0,
                                      int n, float mul, float* t, int ldt,
                                      float* rm, int tid) {
  constexpr int CH = ROWS * D / 4 / kThreads;
  static_assert(CH * 4 * kThreads == ROWS * D, "tile does not split");
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int e = tid + c * kThreads;
    const int r = e % ROWS;
    const int d = 4 * (e / ROWS);
    Raw4<T> raw;
    if (r0 + r < n)
      load4(raw, src + static_cast<int64_t>(r0 + r) * D + d);
    else
      zero4(raw);
    float4 f = to_f32(raw);
    f.x *= mul;
    f.y *= mul;
    f.z *= mul;
    f.w *= mul;
    t[(d + 0) * ldt + r] = f.x;
    t[(d + 1) * ldt + r] = f.y;
    t[(d + 2) * ldt + r] = f.z;
    t[(d + 3) * ldt + r] = f.w;
    if (rm != nullptr)
      *reinterpret_cast<float4*>(rm + r * (D + 4) + d) = f;
  }
}

__device__ __forceinline__ bool live(int q_pos, int k_pos, int skv,
                                     int causal, int window) {
  return k_pos < skv && (!causal || q_pos >= k_pos) &&
         (window <= 0 || k_pos > q_pos - window);
}

// Shared memory of #6: Qt, dOt, Kt, Vt [D][kLD] (q scaled), Ks [kBK]
// [D + 4], dSt [kBK][kLD] (ds transposed: dSt[key][row]).
__host__ __device__ constexpr int dq_smem_bytes(int d) {
  return 4 * (4 * d * kLD + kBK * (d + 4) + kBK * kLD);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ dsum, T* __restrict__ dq, int hq,
                int hkv, int sq, int skv, int causal, int window,
                int q_offset, float scale, int n_qtiles) {
  constexpr int LDR = D + 4;
  constexpr int DG = D / 32;       // 4-wide output groups per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;
  float* dot = qt + D * kLD;
  float* kt = dot + D * kLD;
  float* vt = kt + D * kLD;
  float* ks = vt + D * kLD;
  float* dst = ks + kBK * LDR;

  const int tid = threadIdx.x;
  const int rg = tid / 8;          // rows 4 rg .. 4 rg + 3
  const int cg = tid % 8;          // keys col_of(cg, 0..7)
  const int iq = causal ? n_qtiles - 1 - blockIdx.x : blockIdx.x;
  const int ih = blockIdx.y;
  const int ib = blockIdx.z;
  const int ikv = ih / (hq / hkv);
  const int q0 = iq * kBQ;

  const int64_t q_head = (static_cast<int64_t>(ib) * hq + ih) * sq;
  const T* kp = k + (static_cast<int64_t>(ib) * hkv + ikv) * skv * D;
  const T* vp = v + (static_cast<int64_t>(ib) * hkv + ikv) * skv * D;

  stage<T, D, kBQ>(q + q_head * D, q0, sq, scale, qt, kLD, nullptr, tid);
  stage<T, D, kBQ>(dout + q_head * D, q0, sq, 1.f, dot, kLD, nullptr, tid);
  float row_lse[4], row_d[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + 4 * rg + r;
    row_lse[r] = row < sq ? lse[q_head + row] : 0.f;
    row_d[r] = row < sq ? dsum[q_head + row] : 0.f;
  }

  float acc[4][4 * DG];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4 * DG; ++c) acc[r][c] = 0.f;

  // the live kv range of this q tile (the reference's _tile_live)
  const int q_first = q_offset + q0;
  const int q_last = q_first + kBQ - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_first - window + 1) / kBK * kBK;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile has been consumed
    stage<T, D, kBK>(kp, k0, skv, 1.f, kt, kLD, ks, tid);
    stage<T, D, kBK>(vp, k0, skv, 1.f, vt, kLD, nullptr, tid);
    __syncthreads();

    // s = (q scale) k^T and dp = dO v^T for rows 4 rg + r, keys
    // col_of(cg, c)
    float s[4][8], dp[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = ld4(qt + d * kLD + 4 * rg);
      const float4 ov = ld4(dot + d * kLD + 4 * rg);
      const float4 ka = ld4(kt + d * kLD + 4 * cg);
      const float4 kb = ld4(kt + d * kLD + 32 + 4 * cg);
      const float4 va = ld4(vt + d * kLD + 4 * cg);
      const float4 vb = ld4(vt + d * kLD + 32 + 4 * cg);
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
      const float orow[4] = {ov.x, ov.y, ov.z, ov.w};
      const float kc[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
      const float vc[8] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          s[r][c] = fmaf(qr[r], kc[c], s[r][c]);
          dp[r][c] = fmaf(orow[r], vc[c], dp[r][c]);
        }
    }

    // ds = p (dp - D), p = exp(s - lse) on live entries, else 0; stored
    // transposed: dSt[key][row]
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int k_pos = k0 + col_of(cg, c);
      float ds[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool ok =
            live(q_first + 4 * rg + r, k_pos, skv, causal, window);
        const float p = ok ? expf(s[r][c] - row_lse[r]) : 0.f;
        ds[r] = p * (dp[r][c] - row_d[r]);
      }
      *reinterpret_cast<float4*>(dst + col_of(cg, c) * kLD + 4 * rg) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

    // acc += ds k for rows 4 rg + r, dims 32 g + 4 cg + i
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 dv4 = ld4(dst + j * kLD + 4 * rg);
      const float dr[4] = {dv4.x, dv4.y, dv4.z, dv4.w};
#pragma unroll
      for (int g = 0; g < DG; ++g) {
        const float4 kv = ld4(ks + j * LDR + 32 * g + 4 * cg);
        const float kc[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[r][4 * g + i] = fmaf(dr[r], kc[i], acc[r][4 * g + i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + 4 * rg + r;
    if (row >= sq) continue;
#pragma unroll
    for (int g = 0; g < DG; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        store(&dq[(q_head + row) * D + 32 * g + 4 * cg + i],
              acc[r][4 * g + i] * scale);
  }
}

// Shared memory of #7: Kt, Vt [D][kLD], Qt, dOt [D][kLD7] (q scaled), Qs,
// dOs [kBQ7][D + 4] (q scaled), Ps, dSs [kBQ7][kLD] (Ps[row][key]).
__host__ __device__ constexpr int dkv_smem_bytes(int d) {
  return 4 * (2 * d * kLD + 2 * d * kLD7 + 2 * kBQ7 * (d + 4) +
              2 * kBQ7 * kLD);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ dsum, float* __restrict__ dk,
                 float* __restrict__ dv, int hq, int hkv, int sq, int skv,
                 int causal, int window, int q_offset, float scale) {
  constexpr int LDR = D + 4;
  constexpr int DG = D / 32;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;
  float* vt = kt + D * kLD;
  float* qt = vt + D * kLD;
  float* dot = qt + D * kLD7;
  float* qs = dot + D * kLD7;
  float* dos = qs + kBQ7 * LDR;
  float* ps = dos + kBQ7 * LDR;
  float* dss = ps + kBQ7 * kLD;

  const int tid = threadIdx.x;
  const int rg = tid / 8;          // keys 4 rg .. 4 rg + 3
  const int cg = tid % 8;          // q rows 4 cg .. 4 cg + 3 of a q tile
  const int k0 = blockIdx.x * kBK; // under a causal mask the first key
  const int ih = blockIdx.y;       // tiles see the most rows: first out
  const int ib = blockIdx.z;
  const int ikv = ih / (hq / hkv);

  const int64_t q_head = (static_cast<int64_t>(ib) * hq + ih) * sq;
  const int64_t kv_head = (static_cast<int64_t>(ib) * hkv + ikv) * skv;
  stage<T, D, kBK>(k + kv_head * D, k0, skv, 1.f, kt, kLD, nullptr, tid);
  stage<T, D, kBK>(v + kv_head * D, k0, skv, 1.f, vt, kLD, nullptr, tid);

  float dk_acc[4][4 * DG], dv_acc[4][4 * DG];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4 * DG; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  // the live q rows of this kv tile: a query at position p sees key j
  // iff p >= j (causal) and p < j + window
  const int k_last = min(skv, k0 + kBK) - 1;
  const int i_begin = causal ? max(0, k0 - q_offset) : 0;
  const int i_end =
      window > 0 ? min(sq, max(0, k_last + window - q_offset)) : sq;

  for (int i0 = i_begin; i0 < i_end; i0 += kBQ7) {
    __syncthreads();  // the previous q tile has been consumed
    stage<T, D, kBQ7>(q + q_head * D, i0, sq, scale, qt, kLD7, qs, tid);
    stage<T, D, kBQ7>(dout + q_head * D, i0, sq, 1.f, dot, kLD7, dos, tid);
    float col_lse[4], col_d[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = i0 + 4 * cg + c;
      col_lse[c] = row < sq ? lse[q_head + row] : 0.f;
      col_d[c] = row < sq ? dsum[q_head + row] : 0.f;
    }
    __syncthreads();

    // s^T = k (q scale)^T and dp^T = v dO^T for keys 4 rg + r, rows
    // 4 cg + c
    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 kv = ld4(kt + d * kLD + 4 * rg);
      const float4 vv = ld4(vt + d * kLD + 4 * rg);
      const float4 qv = ld4(qt + d * kLD7 + 4 * cg);
      const float4 ov = ld4(dot + d * kLD7 + 4 * cg);
      const float kr[4] = {kv.x, kv.y, kv.z, kv.w};
      const float vr[4] = {vv.x, vv.y, vv.z, vv.w};
      const float qc[4] = {qv.x, qv.y, qv.z, qv.w};
      const float oc[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(kr[r], qc[c], s[r][c]);
          dp[r][c] = fmaf(vr[r], oc[c], dp[r][c]);
        }
    }

    // p and ds, stored as Ps[row][key], dSs[row][key]
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = i0 + 4 * cg + c;
      float p[4], ds[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool ok = row < sq && live(q_offset + row, k0 + 4 * rg + r,
                                         skv, causal, window);
        p[r] = ok ? expf(s[r][c] - col_lse[c]) : 0.f;
        ds[r] = p[r] * (dp[r][c] - col_d[c]);
      }
      *reinterpret_cast<float4*>(ps + (4 * cg + c) * kLD + 4 * rg) =
          make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(dss + (4 * cg + c) * kLD + 4 * rg) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

    // dv += p^T dO and dk += ds^T (q scale) for keys 4 rg + r, dims
    // 32 g + 4 cg + i
#pragma unroll 4
    for (int i = 0; i < kBQ7; ++i) {
      const float4 pv = ld4(ps + i * kLD + 4 * rg);
      const float4 sv = ld4(dss + i * kLD + 4 * rg);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
      const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int g = 0; g < DG; ++g) {
        const float4 ov = ld4(dos + i * LDR + 32 * g + 4 * cg);
        const float4 qv = ld4(qs + i * LDR + 32 * g + 4 * cg);
        const float oc[4] = {ov.x, ov.y, ov.z, ov.w};
        const float qc[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dv_acc[r][4 * g + e] = fmaf(pr[r], oc[e], dv_acc[r][4 * g + e]);
            dk_acc[r][4 * g + e] = fmaf(sr[r], qc[e], dk_acc[r][4 * g + e]);
          }
      }
    }
  }

  // per q head, float32; keys no q row sees get 0
  const int64_t out_head = (static_cast<int64_t>(ib) * hq + ih) * skv;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + 4 * rg + r;
    if (key >= skv) continue;
#pragma unroll
    for (int g = 0; g < DG; ++g) {
      const int64_t at = (out_head + key) * D + 32 * g + 4 * cg;
      *reinterpret_cast<float4*>(dk + at) =
          make_float4(dk_acc[r][4 * g], dk_acc[r][4 * g + 1],
                      dk_acc[r][4 * g + 2], dk_acc[r][4 * g + 3]);
      *reinterpret_cast<float4*>(dv + at) =
          make_float4(dv_acc[r][4 * g], dv_acc[r][4 * g + 1],
                      dv_acc[r][4 * g + 2], dv_acc[r][4 * g + 3]);
    }
  }
}

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;
  const float* dsum;
  int b, hq, hkv, sq, skv, causal, window, q_offset;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dq(const Args& a, float* dq) {
  constexpr int bytes = dq_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_fma_kernel<float, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int n_qtiles = (a.sq + kBQ - 1) / kBQ;
  const dim3 grid(n_qtiles, a.hq, a.b);
  flash_dq_fma_kernel<float, D><<<grid, kThreads, bytes, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.dsum, dq, a.hq, a.hkv, a.sq, a.skv,
      a.causal, a.window, a.q_offset, a.scale, n_qtiles);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, float* dk, float* dv) {
  constexpr int bytes = dkv_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_fma_kernel<float, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.skv + kBK - 1) / kBK, a.hq, a.b);
  flash_dkv_fma_kernel<float, D><<<grid, kThreads, bytes, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.dsum, dk, dv, a.hq, a.hkv, a.sq,
      a.skv, a.causal, a.window, a.q_offset, a.scale);
  return cudaGetLastError();
}

bool valid(int b, int hq, int hkv, int sq, int skv) {
  return b > 0 && sq > 0 && skv > 0 && hkv > 0 && hq % hkv == 0;
}

}  // namespace

// q, dout (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D), contiguous float32;
// lse and dsum (B, Hq, Sq) float32; dq like q.  window <= 0 means none.
// D in {32, 64, 128}.
cudaError_t flash_attention_dq_fma(const float* q, const float* k,
                                   const float* v, const float* dout,
                                   const float* lse, const float* dsum,
                                   float* dq, int b, int hq, int hkv, int sq,
                                   int skv, int d, int causal, int window,
                                   int q_offset, float scale,
                                   cudaStream_t stream) {
  if (!valid(b, hq, hkv, sq, skv)) return cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, dsum, b, hq, hkv, sq, skv, causal,
               window, q_offset, scale, stream};
  switch (d) {
    case 32:
      return launch_dq<32>(a, dq);
    case 64:
      return launch_dq<64>(a, dq);
    case 128:
      return launch_dq<128>(a, dq);
    default:
      return cudaErrorInvalidValue;
  }
}

// Inputs as flash_attention_dq_fma; dk and dv (B, Hq, Skv, D) float32,
// per q head.
cudaError_t flash_attention_dkv_fma(const float* q, const float* k,
                                    const float* v, const float* dout,
                                    const float* lse, const float* dsum,
                                    float* dk, float* dv, int b, int hq,
                                    int hkv, int sq, int skv, int d,
                                    int causal, int window, int q_offset,
                                    float scale, cudaStream_t stream) {
  if (!valid(b, hq, hkv, sq, skv)) return cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, dsum, b, hq, hkv, sq, skv, causal,
               window, q_offset, scale, stream};
  switch (d) {
    case 32:
      return launch_dkv<32>(a, dk, dv);
    case 64:
      return launch_dkv<64>(a, dk, dv);
    case 128:
      return launch_dkv<128>(a, dk, dv);
    default:
      return cudaErrorInvalidValue;
  }
}
