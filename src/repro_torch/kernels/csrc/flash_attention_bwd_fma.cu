// Flash-attention backward on the CUDA cores, for float32 operands: dq,
// and dk / dv per q head, of causal / sliding-window / GQA attention, any
// Sq and Skv.  The bf16 operands of the main path go to the tensor-core
// kernels of flash_attention_bwd.cu; the binding (sim_step_binding.cpp)
// chooses by dtype.  Same function as those (see there), the same
// replaced Pallas kernels (repro/kernels/flash_attention.py:152
// _dq_kernel and :192 _dkv_kernel), float32 in and out.
//
// Design (the first port of #6 and #7):
//   * flash_dq_fma_kernel: one block per (batch, q head, BQ-row q tile)
//     walks the live BK-key tiles with dq in registers;
//   * flash_dkv_fma_kernel: one block per (batch, q head, BK-key tile)
//     walks the live 32-row q tiles with dk and dv in registers, and
//     writes them per q head; the wrapper sums each kv group in a fixed
//     order.  No float atomics, so a run repeats bitwise.
//   * Every product is a float32 FMA, register-tiled: the 128 threads are
//     row groups of 4 (q rows in #6, keys in #7) by NCG column groups; a
//     thread owns a 4 x 8 (#6) or 4 x 4 (#7) tile of the scores and a
//     4 x D/8 tile of each accumulator at D <= 128, and reads its
//     operands as float4 rows of shared memory, staged transposed where
//     the product runs over the head dim and row-major where it runs over
//     the keys or queries; rows are padded by 4 floats.  #7's eight
//     staged tiles take 157.7 KB at D = 128 (88.1 KB at D = 64).
//   * At D = 256 the tiles halve (DqTiles, DkvTiles): #6's 64 x 64 tiles
//     would take 362,496 bytes of shared memory and #7's accumulators 256
//     floats a thread.  #6 runs 32 q rows against 32-key tiles (185,344
//     bytes; a thread 4 x 2 scores, 4 x 16 of dq), #7 32 keys a block
//     (223,232 bytes; 4 x 2 scores, 4 x 16 of dk and of dv), both under
//     the block's 232,448 bytes.
//   * Tiles that the reference's _tile_live rules out are never visited;
//     the ragged edges of Sq and Skv are masked in the kernel.  Under a
//     causal mask the heaviest tiles are launched first.
// What bounds them: the float32 products at the CUDA cores' 67 TFLOP/s.
// Masking: p is set to 0 on every masked entry (the reference's exp(-1e30
// - lse) is 1 on a row with no live key).  Head sizes 32, 64, 128 and 256.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;   // row groups of 4 x NCG column groups
constexpr int kBQ7 = 32;        // #7: query rows per q tile

// #6's tiles at head size D: BQ query rows a block, BQ keys a kv tile.
template <int D>
struct DqTiles {
  static constexpr int BQ = D <= 128 ? 64 : 32;
  static constexpr int BK = BQ;
  static constexpr int NCG = kThreads / (BQ / 4);  // column groups
  static constexpr int KC = BK / NCG;              // keys a thread
  static constexpr int DG = D / (4 * NCG);         // 4-wide dq groups
  static constexpr int LDQ = BQ + 4;               // padded Qt, dOt, dSt
  static constexpr int LDK = BK + 4;               // padded Kt, Vt
};

// #7's tiles at head size D: BK keys a block, kBQ7 query rows a q tile.
template <int D>
struct DkvTiles {
  static constexpr int BK = D <= 128 ? 64 : 32;
  static constexpr int NCG = kThreads / (BK / 4);  // column groups
  static constexpr int RC = kBQ7 / NCG;            // q rows a thread
  static constexpr int DG = D / (4 * NCG);         // 4-wide dk, dv groups
  static constexpr int LDK = BK + 4;               // padded Kt, Vt, Ps, dSs
  static constexpr int LDQ = kBQ7 + 4;             // padded Qt, dOt
};

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

// Column c (0 .. N - 1) of column group cg, NCG groups of N columns: runs
// of W = min(N, 4) side by side, the next run W NCG further (with N = 8,
// NCG = 8: 4 cg .. 4 cg + 3, then 32 further).
template <int NCG, int N>
__device__ __forceinline__ int col_of(int cg, int c) {
  constexpr int W = N < 4 ? N : 4;
  return W * cg + c % W + W * NCG * (c / W);
}

// base + col_of<NCG, N>(cg, c), summed from the left (as the D <= 128
// kernels always summed a q row, i0 + 4 cg + c).
template <int NCG, int N>
__device__ __forceinline__ int col_of(int cg, int c, int base) {
  constexpr int W = N < 4 ? N : 4;
  return base + W * cg + c % W + W * NCG * (c / W);
}

// Columns col_of<NCG, N>(cg, 0 .. N - 1) of a row of shared memory.
template <int NCG, int N>
__device__ __forceinline__ void load_cols(float (&x)[N], const float* row,
                                          int cg) {
  static_assert(N == 2 || N % 4 == 0, "columns a thread");
  if constexpr (N == 2) {
    const float2 f = *reinterpret_cast<const float2*>(row + 2 * cg);
    x[0] = f.x;
    x[1] = f.y;
  } else {
#pragma unroll
    for (int w = 0; w < N / 4; ++w) {
      const float4 f = ld4(row + 4 * cg + 4 * NCG * w);
      x[4 * w] = f.x;
      x[4 * w + 1] = f.y;
      x[4 * w + 2] = f.z;
      x[4 * w + 3] = f.w;
    }
  }
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

// Shared memory of #6: Qt, dOt [D][LDQ] (q scaled), Kt, Vt [D][LDK], Ks
// [BK][D + 4], dSt [BK][LDQ] (ds transposed: dSt[key][row]).
template <int D>
__host__ __device__ constexpr int dq_smem_bytes() {
  using Tl = DqTiles<D>;
  return 4 * (2 * D * Tl::LDQ + 2 * D * Tl::LDK + Tl::BK * (D + 4) +
              Tl::BK * Tl::LDQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ dsum, T* __restrict__ dq, int hq,
                int hkv, int sq, int skv, int causal, int window,
                int q_offset, float scale, int n_qtiles) {
  using Tl = DqTiles<D>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK, NCG = Tl::NCG, KC = Tl::KC;
  constexpr int DG = Tl::DG, LDQ = Tl::LDQ, LDK = Tl::LDK;
  constexpr int LDR = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;
  float* dot = qt + D * LDQ;
  float* kt = dot + D * LDQ;
  float* vt = kt + D * LDK;
  float* ks = vt + D * LDK;
  float* dst = ks + BK * LDR;

  const int tid = threadIdx.x;
  const int rg = tid / NCG;        // rows 4 rg .. 4 rg + 3
  const int cg = tid % NCG;        // keys col_of<NCG, KC>(cg, 0 .. KC - 1)
  const int iq = causal ? n_qtiles - 1 - blockIdx.x : blockIdx.x;
  const int ih = blockIdx.y;
  const int ib = blockIdx.z;
  const int ikv = ih / (hq / hkv);
  const int q0 = iq * BQ;

  const int64_t q_head = (static_cast<int64_t>(ib) * hq + ih) * sq;
  const T* kp = k + (static_cast<int64_t>(ib) * hkv + ikv) * skv * D;
  const T* vp = v + (static_cast<int64_t>(ib) * hkv + ikv) * skv * D;

  stage<T, D, BQ>(q + q_head * D, q0, sq, scale, qt, LDQ, nullptr, tid);
  stage<T, D, BQ>(dout + q_head * D, q0, sq, 1.f, dot, LDQ, nullptr, tid);
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
  const int q_last = q_first + BQ - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_first - window + 1) / BK * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile has been consumed
    stage<T, D, BK>(kp, k0, skv, 1.f, kt, LDK, ks, tid);
    stage<T, D, BK>(vp, k0, skv, 1.f, vt, LDK, nullptr, tid);
    __syncthreads();

    // s = (q scale) k^T and dp = dO v^T for rows 4 rg + r, keys
    // col_of<NCG, KC>(cg, c)
    float s[4][KC], dp[4][KC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < KC; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = ld4(qt + d * LDQ + 4 * rg);
      const float4 ov = ld4(dot + d * LDQ + 4 * rg);
      float kc[KC], vc[KC];
      load_cols<NCG, KC>(kc, kt + d * LDK, cg);
      load_cols<NCG, KC>(vc, vt + d * LDK, cg);
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
      const float orow[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          s[r][c] = fmaf(qr[r], kc[c], s[r][c]);
          dp[r][c] = fmaf(orow[r], vc[c], dp[r][c]);
        }
    }

    // ds = p (dp - D), p = exp(s - lse) on live entries, else 0; stored
    // transposed: dSt[key][row]
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const int k_pos = k0 + col_of<NCG, KC>(cg, c);
      float ds[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool ok =
            live(q_first + 4 * rg + r, k_pos, skv, causal, window);
        const float p = ok ? expf(s[r][c] - row_lse[r]) : 0.f;
        ds[r] = p * (dp[r][c] - row_d[r]);
      }
      *reinterpret_cast<float4*>(dst + col_of<NCG, KC>(cg, c) * LDQ +
                                 4 * rg) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

    // acc += ds k for rows 4 rg + r, dims 4 NCG g + 4 cg + i
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 dv4 = ld4(dst + j * LDQ + 4 * rg);
      const float dr[4] = {dv4.x, dv4.y, dv4.z, dv4.w};
#pragma unroll
      for (int g = 0; g < DG; ++g) {
        const float4 kv = ld4(ks + j * LDR + 4 * NCG * g + 4 * cg);
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
        store(&dq[(q_head + row) * D + 4 * NCG * g + 4 * cg + i],
              acc[r][4 * g + i] * scale);
  }
}

// Shared memory of #7: Kt, Vt [D][LDK], Qt, dOt [D][LDQ] (q scaled), Qs,
// dOs [kBQ7][D + 4] (q scaled), Ps, dSs [kBQ7][LDK] (Ps[row][key]).
template <int D>
__host__ __device__ constexpr int dkv_smem_bytes() {
  using Tl = DkvTiles<D>;
  return 4 * (2 * D * Tl::LDK + 2 * D * Tl::LDQ + 2 * kBQ7 * (D + 4) +
              2 * kBQ7 * Tl::LDK);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ dsum, float* __restrict__ dk,
                 float* __restrict__ dv, int hq, int hkv, int sq, int skv,
                 int causal, int window, int q_offset, float scale) {
  using Tl = DkvTiles<D>;
  constexpr int BK = Tl::BK, NCG = Tl::NCG, RC = Tl::RC, DG = Tl::DG;
  constexpr int LDK = Tl::LDK, LDQ = Tl::LDQ;
  constexpr int LDR = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;
  float* vt = kt + D * LDK;
  float* qt = vt + D * LDK;
  float* dot = qt + D * LDQ;
  float* qs = dot + D * LDQ;
  float* dos = qs + kBQ7 * LDR;
  float* ps = dos + kBQ7 * LDR;
  float* dss = ps + kBQ7 * LDK;

  const int tid = threadIdx.x;
  const int rg = tid / NCG;        // keys 4 rg .. 4 rg + 3
  const int cg = tid % NCG;        // q rows col_of<NCG, RC>(cg, c) of a tile
  const int k0 = blockIdx.x * BK;  // under a causal mask the first key
  const int ih = blockIdx.y;       // tiles see the most rows: first out
  const int ib = blockIdx.z;
  const int ikv = ih / (hq / hkv);

  const int64_t q_head = (static_cast<int64_t>(ib) * hq + ih) * sq;
  const int64_t kv_head = (static_cast<int64_t>(ib) * hkv + ikv) * skv;
  stage<T, D, BK>(k + kv_head * D, k0, skv, 1.f, kt, LDK, nullptr, tid);
  stage<T, D, BK>(v + kv_head * D, k0, skv, 1.f, vt, LDK, nullptr, tid);

  float dk_acc[4][4 * DG], dv_acc[4][4 * DG];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4 * DG; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  // the live q rows of this kv tile: a query at position p sees key j
  // iff p >= j (causal) and p < j + window
  const int k_last = min(skv, k0 + BK) - 1;
  const int i_begin = causal ? max(0, k0 - q_offset) : 0;
  const int i_end =
      window > 0 ? min(sq, max(0, k_last + window - q_offset)) : sq;

  for (int i0 = i_begin; i0 < i_end; i0 += kBQ7) {
    __syncthreads();  // the previous q tile has been consumed
    stage<T, D, kBQ7>(q + q_head * D, i0, sq, scale, qt, LDQ, qs, tid);
    stage<T, D, kBQ7>(dout + q_head * D, i0, sq, 1.f, dot, LDQ, dos, tid);
    float col_lse[RC], col_d[RC];
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      const int row = col_of<NCG, RC>(cg, c, i0);
      col_lse[c] = row < sq ? lse[q_head + row] : 0.f;
      col_d[c] = row < sq ? dsum[q_head + row] : 0.f;
    }
    __syncthreads();

    // s^T = k (q scale)^T and dp^T = v dO^T for keys 4 rg + r, rows
    // col_of<NCG, RC>(cg, c)
    float s[4][RC], dp[4][RC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < RC; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 kv = ld4(kt + d * LDK + 4 * rg);
      const float4 vv = ld4(vt + d * LDK + 4 * rg);
      float qc[RC], oc[RC];
      load_cols<NCG, RC>(qc, qt + d * LDQ, cg);
      load_cols<NCG, RC>(oc, dot + d * LDQ, cg);
      const float kr[4] = {kv.x, kv.y, kv.z, kv.w};
      const float vr[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < RC; ++c) {
          s[r][c] = fmaf(kr[r], qc[c], s[r][c]);
          dp[r][c] = fmaf(vr[r], oc[c], dp[r][c]);
        }
    }

    // p and ds, stored as Ps[row][key], dSs[row][key]
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      const int row = col_of<NCG, RC>(cg, c, i0);
      float p[4], ds[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool ok = row < sq && live(q_offset + row, k0 + 4 * rg + r,
                                         skv, causal, window);
        p[r] = ok ? expf(s[r][c] - col_lse[c]) : 0.f;
        ds[r] = p[r] * (dp[r][c] - col_d[c]);
      }
      *reinterpret_cast<float4*>(ps + col_of<NCG, RC>(cg, c) * LDK +
                                 4 * rg) = make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(dss + col_of<NCG, RC>(cg, c) * LDK +
                                 4 * rg) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

    // dv += p^T dO and dk += ds^T (q scale) for keys 4 rg + r, dims
    // 4 NCG g + 4 cg + i
#pragma unroll 4
    for (int i = 0; i < kBQ7; ++i) {
      const float4 pv = ld4(ps + i * LDK + 4 * rg);
      const float4 sv = ld4(dss + i * LDK + 4 * rg);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
      const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int g = 0; g < DG; ++g) {
        const float4 ov = ld4(dos + i * LDR + 4 * NCG * g + 4 * cg);
        const float4 qv = ld4(qs + i * LDR + 4 * NCG * g + 4 * cg);
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
      const int64_t at = (out_head + key) * D + 4 * NCG * g + 4 * cg;
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
  constexpr int bytes = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_fma_kernel<float, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  constexpr int BQ = DqTiles<D>::BQ;
  const int n_qtiles = (a.sq + BQ - 1) / BQ;
  const dim3 grid(n_qtiles, a.hq, a.b);
  flash_dq_fma_kernel<float, D><<<grid, kThreads, bytes, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.dsum, dq, a.hq, a.hkv, a.sq, a.skv,
      a.causal, a.window, a.q_offset, a.scale, n_qtiles);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, float* dk, float* dv) {
  constexpr int bytes = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_fma_kernel<float, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  constexpr int BK = DkvTiles<D>::BK;
  const dim3 grid((a.skv + BK - 1) / BK, a.hq, a.b);
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
// D in {32, 64, 128, 256}.
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
    case 256:
      return launch_dq<256>(a, dq);
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
    case 256:
      return launch_dkv<256>(a, dk, dv);
    default:
      return cudaErrorInvalidValue;
  }
}
