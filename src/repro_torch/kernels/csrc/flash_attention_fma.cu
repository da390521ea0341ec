// Flash-attention forward on the CUDA cores, for float32 operands:
// causal / sliding-window / GQA online-softmax attention with the row
// log-sum-exp, any Sq and Skv.  The bf16 operands of the main path go to
// the tensor-core kernel of flash_attention.cu; the binding
// (sim_step_binding.cpp) chooses by dtype.  Same function as that one,
// the same replaced Pallas kernel (repro/kernels/flash_attention.py:62,
// _fwd_kernel via flash_attention -> _fwd), float32 in and out.
//
// There, a sequential kv grid axis carried the float32 (acc, m, l) state
// in VMEM from one kv block to the next.  Blocks on Hopper run in no
// order, so one block here owns a (batch, q head, 64-row q tile) and walks
// the 64-key kv tiles in a loop, with the online-softmax state in
// registers.
//
// What bounds it: the float32 products at the CUDA cores' 67 TFLOP/s
// (the first port of #5; the tensor cores take float32 only as TF32,
// which is ruled out).  What the design does:
//   * Both products are register-tiled, as a SIMT GEMM: the 128 threads
//     are BQ / 4 row groups by NCG column groups; each owns a 4 x KC tile
//     of the (BQ, BK) scores and a 4 x D / NCG tile of the output (4 x 8
//     and 4 x D/8 with 64-row tiles), and reads its operands as float4
//     rows of shared memory, so that three 16-byte loads feed 32 FMAs.
//     Q, K and the probabilities are staged transposed (column-major) and
//     V row-major, each row padded by 4 floats; a lane's 8 columns are two
//     groups of 4, 32 apart, so that the lanes of a warp read 16-byte
//     chunks side by side.
//   * q, k and v are read once per block and tile, four elements per
//     load, into shared memory (69.6 KB at D = 64, dynamic shared
//     memory).  Up to D = 128 the next kv tile's loads are issued before
//     the current tile's products and stored after them, so their
//     latency hides behind the FMAs.  At D = 256 the same 64 x 64 tiles
//     take 223,232 of the block's 232,448 bytes of shared memory and the
//     output 128 accumulators a thread; a fetched kv tile would hold 256
//     more floats a thread, so the kv tiles go straight to shared memory
//     there (Tiles below).
//   * A row's max and sum are reduced over the NCG lanes that share it
//     with warp shuffles; the state (m, l) is kept in all of them.
//   * Tiles that the reference's _tile_live rules out (above the causal
//     diagonal, below the window) are never visited; the ragged edge of
//     Sq and Skv is masked in the kernel, so unpadded prompts of any
//     length take this path.  Under a causal mask the last (heaviest) q
//     tiles are launched first.
// Masking follows the reference: -1e30 (not -inf); a row with l == 0
// gets o = 0; lse = m + log(max(l, 1e-30)).  Head sizes 32, 64, 128 and
// 256; the Python wrapper zero-pads others.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;    // BQ / 4 row groups x NCG column groups

// The tiles of head size D: BQ query rows a block, BK keys a kv tile, and
// whether the next kv tile is fetched into registers during the products.
template <int D>
struct Tiles {
  static constexpr int BQ = 64;
  static constexpr int BK = 64;
  static constexpr bool kFetch = D <= 128;
  static constexpr int NCG = kThreads / (BQ / 4);  // column groups
  static constexpr int KC = BK / NCG;              // keys a thread
  static constexpr int DG = D / (4 * NCG);         // 4-wide output groups
  static constexpr int LDQ = BQ + 4;               // padded row of Qt, Pt
  static constexpr int LDK = BK + 4;               // padded row of Kt
  static constexpr int CH = BK * D / 4 / kThreads; // 4-element kv chunks
  static_assert(CH * 4 * kThreads == BK * D && KC * NCG == BK &&
                    DG * 4 * NCG == D && BQ * D % (4 * kThreads) == 0,
                "tiles do not split over the threads");
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

// Column c (0 .. N - 1) of column group cg, NCG groups of N columns: runs
// of W = min(N, 4) side by side, the next run W NCG further (with N = 8,
// NCG = 8: 4 cg .. 4 cg + 3, then 32 further).
template <int NCG, int N>
__device__ __forceinline__ int col_of(int cg, int c) {
  constexpr int W = N < 4 ? N : 4;
  return W * cg + c % W + W * NCG * (c / W);
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
      const float4 f =
          *reinterpret_cast<const float4*>(row + 4 * cg + 4 * NCG * w);
      x[4 * w] = f.x;
      x[4 * w + 1] = f.y;
      x[4 * w + 2] = f.z;
      x[4 * w + 3] = f.w;
    }
  }
}

// Shared memory: Qt[D][LDQ] (scaled q, transposed), Kt[D][LDK], Vs[BK]
// [D + 4], Pt[BK][LDQ] (probabilities, transposed), all float32.
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  using Tl = Tiles<D>;
  return 4 * (D * Tl::LDQ + D * Tl::LDK + Tl::BK * (D + 4) +
              Tl::BK * Tl::LDQ);
}

// Chunk c of the kv tile at k0 into registers (keys past Skv zero).  For
// K the lanes run along the keys, so that stash_kv's transposed stores
// hit consecutive banks; for V along the head dim.
template <typename T, int D>
__device__ __forceinline__ void fetch_chunk(Raw4<T>& kraw, Raw4<T>& vraw,
                                            const T* kp, const T* vp,
                                            int k0, int skv, int e) {
  constexpr int BK = Tiles<D>::BK;
  const int j = e % BK;
  if (k0 + j < skv)
    load4(kraw, kp + static_cast<int64_t>(k0 + j) * D + 4 * (e / BK));
  else
    zero4(kraw);
  const int jv = e / (D / 4);
  if (k0 + jv < skv)
    load4(vraw, vp + static_cast<int64_t>(k0 + jv) * D + 4 * (e % (D / 4)));
  else
    zero4(vraw);
}

// Chunk c of a fetched tile into shared memory: K transposed, V
// row-major.
template <typename T, int D>
__device__ __forceinline__ void stash_chunk(const Raw4<T>& kraw,
                                            const Raw4<T>& vraw, float* kt,
                                            float* vs, int e) {
  using Tl = Tiles<D>;
  const int j = e % Tl::BK;
  const int d = 4 * (e / Tl::BK);
  const float4 f = to_f32(kraw);
  kt[(d + 0) * Tl::LDK + j] = f.x;
  kt[(d + 1) * Tl::LDK + j] = f.y;
  kt[(d + 2) * Tl::LDK + j] = f.z;
  kt[(d + 3) * Tl::LDK + j] = f.w;
  *reinterpret_cast<float4*>(vs + (e / (D / 4)) * (D + 4) +
                             4 * (e % (D / 4))) = to_f32(vraw);
}

template <typename T, int D>
__device__ __forceinline__ void fetch_kv(Raw4<T> (&kraw)[Tiles<D>::CH],
                                         Raw4<T> (&vraw)[Tiles<D>::CH],
                                         const T* kp, const T* vp, int k0,
                                         int skv, int tid) {
#pragma unroll
  for (int c = 0; c < Tiles<D>::CH; ++c)
    fetch_chunk<T, D>(kraw[c], vraw[c], kp, vp, k0, skv, tid + c * kThreads);
}

template <typename T, int D>
__device__ __forceinline__ void stash_kv(const Raw4<T> (&kraw)[Tiles<D>::CH],
                                         const Raw4<T> (&vraw)[Tiles<D>::CH],
                                         float* kt, float* vs, int tid) {
#pragma unroll
  for (int c = 0; c < Tiles<D>::CH; ++c)
    stash_chunk<T, D>(kraw[c], vraw[c], kt, vs, tid + c * kThreads);
}

// The kv tile at k0 straight into shared memory, where it is not fetched
// ahead (Tiles<D>::kFetch false).
template <typename T, int D>
__device__ __forceinline__ void copy_kv(const T* kp, const T* vp, int k0,
                                        int skv, float* kt, float* vs,
                                        int tid) {
#pragma unroll 8
  for (int c = 0; c < Tiles<D>::CH; ++c) {
    Raw4<T> kraw, vraw;
    fetch_chunk<T, D>(kraw, vraw, kp, vp, k0, skv, tid + c * kThreads);
    stash_chunk<T, D>(kraw, vraw, kt, vs, tid + c * kThreads);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int hq, int hkv, int sq, int skv,
                 int causal, int window, int q_offset, float scale,
                 int n_qtiles) {
  using Tl = Tiles<D>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK, NCG = Tl::NCG, KC = Tl::KC;
  constexpr int DG = Tl::DG, LDQ = Tl::LDQ, LDK = Tl::LDK;
  constexpr int LDV = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;
  float* kt = qt + D * LDQ;
  float* vs = kt + D * LDK;
  float* pt = vs + BK * LDV;

  const int tid = threadIdx.x;
  const int rg = tid / NCG;        // rows 4 rg .. 4 rg + 3
  const int cg = tid % NCG;        // the NCG lanes of a row group share it
  const int iq = causal ? n_qtiles - 1 - blockIdx.x : blockIdx.x;
  const int ih = blockIdx.y;
  const int ib = blockIdx.z;
  const int ikv = ih / (hq / hkv);
  const int q0 = iq * BQ;

  const int64_t q_head = (static_cast<int64_t>(ib) * hq + ih) * sq;
  const T* kp = k + (static_cast<int64_t>(ib) * hkv + ikv) * skv * D;
  const T* vp = v + (static_cast<int64_t>(ib) * hkv + ikv) * skv * D;

  // the q tile, scaled, transposed; rows past Sq are zero.  Each thread
  // loads 4 consecutive elements of a row: lanes run along the rows, so
  // the transposed stores of a warp hit consecutive banks.
  constexpr int CHQ = BQ * D / 4 / kThreads;
  {
    Raw4<T> raw[CHQ];
#pragma unroll
    for (int c = 0; c < CHQ; ++c) {
      const int e = tid + c * kThreads;
      const int r = e % BQ;
      if (q0 + r < sq)
        load4(raw[c], q + (q_head + q0 + r) * D + 4 * (e / BQ));
      else
        zero4(raw[c]);
    }
#pragma unroll
    for (int c = 0; c < CHQ; ++c) {
      const int e = tid + c * kThreads;
      const int r = e % BQ;
      const int d = 4 * (e / BQ);
      const float4 f = to_f32(raw[c]);
      qt[(d + 0) * LDQ + r] = f.x * scale;
      qt[(d + 1) * LDQ + r] = f.y * scale;
      qt[(d + 2) * LDQ + r] = f.z * scale;
      qt[(d + 3) * LDQ + r] = f.w * scale;
    }
  }

  // Where Tl::kFetch, K and V of a kv tile travel through registers: the
  // next tile's loads are issued before the current tile's products, and
  // land in shared memory after them.
  Raw4<T> kraw[Tl::kFetch ? Tl::CH : 1], vraw[Tl::kFetch ? Tl::CH : 1];

  float acc[4][4 * DG];
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * DG; ++c) acc[r][c] = 0.f;
  }

  // the live kv range of this q tile (the reference's _tile_live, with
  // the whole tile's first and last positions)
  const int q_first = q_offset + q0;
  const int q_last = q_first + BQ - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_first - window + 1) / BK * BK;

  if constexpr (Tl::kFetch) {
    if (k_begin < k_end)
      fetch_kv<T, D>(kraw, vraw, kp, vp, k_begin, skv, tid);
  }
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile has been consumed
    if constexpr (Tl::kFetch) {
      stash_kv<T, D>(kraw, vraw, kt, vs, tid);
      if (k0 + BK < k_end)
        fetch_kv<T, D>(kraw, vraw, kp, vp, k0 + BK, skv, tid);
    } else {
      copy_kv<T, D>(kp, vp, k0, skv, kt, vs, tid);
    }
    __syncthreads();

    // scores s = (q * scale) k^T for rows 4 rg + r, keys
    // col_of<NCG, KC>(cg, c)
    float s[4][KC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < KC; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qt + d * LDQ + 4 * rg);
      float kc[KC];
      load_cols<NCG, KC>(kc, kt + d * LDK, cg);
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < KC; ++c) s[r][c] = fmaf(qr[r], kc[c], s[r][c]);
    }

    // online softmax, row by row
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int q_pos = q_first + 4 * rg + r;
      unsigned live = 0u;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const int k_pos = k0 + col_of<NCG, KC>(cg, c);
        const bool ok = k_pos < skv && (!causal || q_pos >= k_pos) &&
                        (window <= 0 || k_pos > q_pos - window);
        live |= ok ? (1u << c) : 0u;
        s[r][c] = ok ? s[r][c] : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int lane = 1; lane < NCG; lane <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, lane));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        s[r][c] = (live >> c) & 1u ? expf(s[r][c] - m_new) : 0.f;
        ps += s[r][c];
      }
#pragma unroll
      for (int lane = 1; lane < NCG; lane <<= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, lane);
      l[r] = alpha * l[r] + ps;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * DG; ++c) acc[r][c] *= alpha;
    }
    // the probabilities, transposed: Pt[key][row]
#pragma unroll
    for (int c = 0; c < KC; ++c)
      *reinterpret_cast<float4*>(pt + col_of<NCG, KC>(cg, c) * LDQ +
                                 4 * rg) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();

    // acc += p v for rows 4 rg + r, dims 4 cg + 4 NCG g + i
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(pt + j * LDQ + 4 * rg);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int g = 0; g < DG; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(
            vs + j * LDV + 4 * NCG * g + 4 * cg);
        const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[r][4 * g + i] = fmaf(pr[r], vc[i], acc[r][4 * g + i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + 4 * rg + r;
    if (row >= sq) continue;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
#pragma unroll
    for (int g = 0; g < DG; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        store(&o[(q_head + row) * D + 4 * NCG * g + 4 * cg + i],
              acc[r][4 * g + i] * inv);
    if (cg == 0) lse[q_head + row] = m[r] + logf(fmaxf(l[r], 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int hq, int hkv, int sq, int skv,
                   int causal, int window, int q_offset, float scale,
                   cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_fma_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int n_qtiles = (sq + Tiles<D>::BQ - 1) / Tiles<D>::BQ;
  const dim3 grid(n_qtiles, hq, b);
  flash_fwd_fma_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, hq, hkv, sq, skv,
      causal, window, q_offset, scale, n_qtiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v,
                     void* o, float* lse, int b, int hq, int hkv, int sq,
                     int skv, int causal, int window, int q_offset,
                     float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, b, hq, hkv, sq, skv, causal,
                           window, q_offset, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, b, hq, hkv, sq, skv, causal,
                           window, q_offset, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, b, hq, hkv, sq, skv, causal,
                            window, q_offset, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, lse, b, hq, hkv, sq, skv, causal,
                            window, q_offset, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), o like q, all contiguous
// float32; lse (B, Hq, Sq) float32.  window <= 0 means none.  D in
// {32, 64, 128, 256}.
cudaError_t flash_attention_fwd_fma(const float* q, const float* k,
                                    const float* v, float* o, float* lse,
                                    int b, int hq, int hkv, int sq, int skv,
                                    int d, int causal, int window,
                                    int q_offset, float scale,
                                    cudaStream_t stream) {
  if (b <= 0 || sq <= 0 || hkv <= 0 || hq % hkv != 0)
    return cudaErrorInvalidValue;
  return dispatch<float>(d, q, k, v, o, lse, b, hq, hkv, sq, skv, causal,
                         window, q_offset, scale, stream);
}
