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
//   * Both products are register-tiled, as a SIMT GEMM: each of the 128
//     threads owns a 4 x 8 tile of the (64, 64) scores and a 4 x D/8
//     tile of the output, and reads its operands as float4 rows of shared
//     memory, so that three 16-byte loads feed 32 FMAs.  Q, K and the
//     probabilities are staged transposed (column-major) and V
//     row-major, each row padded by 4 floats; a lane's 8 columns are two
//     groups of 4, 32 apart, so that the lanes of a warp read 16-byte
//     chunks side by side.
//   * q, k and v are read once per block and tile, four elements per
//     load, into shared memory (69.6 KB at D = 64, dynamic shared
//     memory).  The next kv tile's loads are issued before the current
//     tile's products and stored after them, so their latency hides
//     behind the FMAs.
//   * A row's max and sum are reduced over the 8 lanes that share it with
//     warp shuffles; the state (m, l) is kept in all 8.
//   * Tiles that the reference's _tile_live rules out (above the causal
//     diagonal, below the window) are never visited; the ragged edge of
//     Sq and Skv is masked in the kernel, so unpadded prompts of any
//     length take this path.  Under a causal mask the last (heaviest) q
//     tiles are launched first.
// Masking follows the reference: -1e30 (not -inf); a row with l == 0
// gets o = 0; lse = m + log(max(l, 1e-30)).  Head sizes 32, 64 and 128;
// the Python wrapper zero-pads smaller ones.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per kv tile
constexpr int kThreads = 128;    // 16 row groups x 8 column groups
constexpr int kLD = kBQ + 4;     // padded row of Qt, Kt and Pt

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

// Column c (0..7) of column group cg: 4 cg .. 4 cg + 3, then 32 further.
__device__ __forceinline__ int col_of(int cg, int c) {
  return 4 * cg + (c & 3) + 32 * (c >> 2);
}

// Shared memory: Qt[D][kLD] (scaled q, transposed), Kt[D][kLD], Vs[kBK]
// [D + 4], Pt[kBK][kLD] (probabilities, transposed), all float32.
__host__ __device__ constexpr int smem_bytes(int d) {
  return 4 * (2 * d * kLD + kBK * (d + 4) + kBK * kLD);
}

// 4-element chunks of a (64, D) tile per thread.
template <int D>
constexpr int chunks() {
  return kBK * D / 4 / kThreads;
}

// Loads of the kv tile at k0 into registers (keys past Skv zero).  For K
// the lanes run along the keys, so that stash_kv's transposed stores hit
// consecutive banks; for V along the head dim.
template <typename T, int D>
__device__ __forceinline__ void fetch_kv(Raw4<T> (&kraw)[chunks<D>()],
                                         Raw4<T> (&vraw)[chunks<D>()],
                                         const T* kp, const T* vp, int k0,
                                         int skv, int tid) {
#pragma unroll
  for (int c = 0; c < chunks<D>(); ++c) {
    const int e = tid + c * kThreads;
    const int j = e % kBK;
    if (k0 + j < skv)
      load4(kraw[c], kp + static_cast<int64_t>(k0 + j) * D + 4 * (e / kBK));
    else
      zero4(kraw[c]);
    const int jv = e / (D / 4);
    if (k0 + jv < skv)
      load4(vraw[c],
            vp + static_cast<int64_t>(k0 + jv) * D + 4 * (e % (D / 4)));
    else
      zero4(vraw[c]);
  }
}

// The fetched tile into shared memory: K transposed, V row-major.
template <typename T, int D>
__device__ __forceinline__ void stash_kv(const Raw4<T> (&kraw)[chunks<D>()],
                                         const Raw4<T> (&vraw)[chunks<D>()],
                                         float* kt, float* vs, int tid) {
#pragma unroll
  for (int c = 0; c < chunks<D>(); ++c) {
    const int e = tid + c * kThreads;
    const int j = e % kBK;
    const int d = 4 * (e / kBK);
    const float4 f = to_f32(kraw[c]);
    kt[(d + 0) * kLD + j] = f.x;
    kt[(d + 1) * kLD + j] = f.y;
    kt[(d + 2) * kLD + j] = f.z;
    kt[(d + 3) * kLD + j] = f.w;
    *reinterpret_cast<float4*>(vs + (e / (D / 4)) * (D + 4) +
                               4 * (e % (D / 4))) = to_f32(vraw[c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int hq, int hkv, int sq, int skv,
                 int causal, int window, int q_offset, float scale,
                 int n_qtiles) {
  constexpr int LDV = D + 4;
  constexpr int DG = D / 32;       // 4-wide output groups per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;
  float* kt = qt + D * kLD;
  float* vs = kt + D * kLD;
  float* pt = vs + kBK * LDV;

  const int tid = threadIdx.x;
  const int rg = tid / 8;          // rows 4 rg .. 4 rg + 3
  const int cg = tid % 8;          // lanes 8 rg .. 8 rg + 7 share a row
  const int iq = causal ? n_qtiles - 1 - blockIdx.x : blockIdx.x;
  const int ih = blockIdx.y;
  const int ib = blockIdx.z;
  const int ikv = ih / (hq / hkv);
  const int q0 = iq * kBQ;

  const int64_t q_head = (static_cast<int64_t>(ib) * hq + ih) * sq;
  const T* kp = k + (static_cast<int64_t>(ib) * hkv + ikv) * skv * D;
  const T* vp = v + (static_cast<int64_t>(ib) * hkv + ikv) * skv * D;

  // the q tile, scaled, transposed; rows past Sq are zero.  Each thread
  // loads 4 consecutive elements of a row: lanes run along the rows, so
  // the transposed stores of a warp hit consecutive banks.
  constexpr int CH = chunks<D>();
  {
    Raw4<T> raw[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int e = tid + c * kThreads;
      const int r = e % kBQ;
      if (q0 + r < sq)
        load4(raw[c], q + (q_head + q0 + r) * D + 4 * (e / kBQ));
      else
        zero4(raw[c]);
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int e = tid + c * kThreads;
      const int r = e % kBQ;
      const int d = 4 * (e / kBQ);
      const float4 f = to_f32(raw[c]);
      qt[(d + 0) * kLD + r] = f.x * scale;
      qt[(d + 1) * kLD + r] = f.y * scale;
      qt[(d + 2) * kLD + r] = f.z * scale;
      qt[(d + 3) * kLD + r] = f.w * scale;
    }
  }

  // K and V of a kv tile travel through registers: the next tile's loads
  // are issued before the current tile's products, and land in shared
  // memory after them.
  Raw4<T> kraw[CH], vraw[CH];

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
  const int q_last = q_first + kBQ - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_first - window + 1) / kBK * kBK;

  if (k_begin < k_end) fetch_kv<T, D>(kraw, vraw, kp, vp, k_begin, skv, tid);
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile has been consumed
    stash_kv<T, D>(kraw, vraw, kt, vs, tid);
    if (k0 + kBK < k_end)
      fetch_kv<T, D>(kraw, vraw, kp, vp, k0 + kBK, skv, tid);
    __syncthreads();

    // scores s = (q * scale) k^T for rows 4 rg + r, columns col_of(cg, c)
    float s[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qt + d * kLD + 4 * rg);
      const float4 ka = *reinterpret_cast<const float4*>(kt + d * kLD + 4 * cg);
      const float4 kb =
          *reinterpret_cast<const float4*>(kt + d * kLD + 32 + 4 * cg);
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
      const float kc[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) s[r][c] = fmaf(qr[r], kc[c], s[r][c]);
    }

    // online softmax, row by row
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int q_pos = q_first + 4 * rg + r;
      unsigned live = 0u;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int k_pos = k0 + col_of(cg, c);
        const bool ok = k_pos < skv && (!causal || q_pos >= k_pos) &&
                        (window <= 0 || k_pos > q_pos - window);
        live |= ok ? (1u << c) : 0u;
        s[r][c] = ok ? s[r][c] : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        s[r][c] = (live >> c) & 1u ? expf(s[r][c] - m_new) : 0.f;
        ps += s[r][c];
      }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      ps += __shfl_xor_sync(0xffffffffu, ps, 4);
      l[r] = alpha * l[r] + ps;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * DG; ++c) acc[r][c] *= alpha;
    }
    // the probabilities, transposed: Pt[key][row]
#pragma unroll
    for (int c = 0; c < 8; ++c)
      *reinterpret_cast<float4*>(pt + col_of(cg, c) * kLD + 4 * rg) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();

    // acc += p v for rows 4 rg + r, dims 4 cg + 32 g + i
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(pt + j * kLD + 4 * rg);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int g = 0; g < DG; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vs + j * LDV + 32 * g + 4 * cg);
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
        store(&o[(q_head + row) * D + 32 * g + 4 * cg + i],
              acc[r][4 * g + i] * inv);
    if (cg == 0) lse[q_head + row] = m[r] + logf(fmaxf(l[r], 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int hq, int hkv, int sq, int skv,
                   int causal, int window, int q_offset, float scale,
                   cudaStream_t stream) {
  constexpr int bytes = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_fma_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int n_qtiles = (sq + kBQ - 1) / kBQ;
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
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), o like q, all contiguous
// float32; lse (B, Hq, Sq) float32.  window <= 0 means none.  D in
// {32, 64, 128}.
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
