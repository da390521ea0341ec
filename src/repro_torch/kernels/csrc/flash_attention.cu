// Flash-attention forward for Hopper (sm_90a) on the tensor cores: causal
// / sliding-window / GQA online-softmax attention with the row
// log-sum-exp, bf16 q, k, v, any Sq and Skv.  (float32 operands go to the
// CUDA-core kernel of flash_attention_fma.cu; the binding chooses by
// dtype.)
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:62
// (_fwd_kernel via flash_attention -> _fwd).  There, a sequential kv grid
// axis carried the float32 (acc, m, l) state in VMEM from one kv block to
// the next.  Blocks on Hopper run in no order, so one block (one
// warpgroup) here owns a (batch, q head, 64-row q tile) and walks the
// live 64-key tiles in a loop, with the online-softmax state in registers.
//
// Precision.  The reference computes both products in float32.  Q K^T has
// bf16 operands: wgmma forms the products exactly and sums them into
// float32 accumulators; the softmax scale is applied to the float32 sum
// (q scale is not bf16-exact at D = 32 or 128).  p = 2^(s scale log2 e -
// m log2 e) is formed in float32 by one FMA and the special-function
// unit's ex2 (relative error about 2^-22).  P V has one float32 operand,
// p: split3 (wgmma.cuh) cuts it exactly into three bf16 terms, and three
// wgmma products against V are the float32 product's exact parts.  No
// TF32, and p is never cast to a single bf16.  The tensor cores add a
// wgmma's products into the float32 accumulator by their own rounding,
// not as a chain of float32 FMAs.
//
// What bounds it on the H100: operations.  At the serve shape (one
// smollm-135m layer, B = 1, Hq = 9, S = 2048, D = 64, causal) Q K^T is
// 2.4 GFLOP of bf16 products and P V 2.4 GFLOP of float32-by-bf16 ones,
// three tensor-core products each: 9.7 GFLOP of tensor-core work, 9.8 us
// at 989 TFLOP/s, against 6.4 MB of HBM traffic (1.9 us).  Measured, it
// takes 2.5x its bound at the training shape (B = 8: 0.197 ms of device
// time against 0.078 ms on an H100 80GB HBM3 at 700 W, chip_smoke.py
// phase 14), held there, like #6 and #7, by instructions per thread as
// much as by the tensor cores: some 10 per score (max, sum, the ex2 and
// its FMA, 5.5 for the split) beside 16 wgmma per kv tile.  What the
// design does:
//   * Every product is a wgmma m64nNk16 with float32 accumulators: S = Q
//     K^T with both operands in shared memory, then acc += P V with the
//     three bf16 terms of p from registers, where the accumulator of S
//     already lies in the A-fragment layout, and V read transposed from
//     its tile through an MN-major descriptor.
//   * Tiles live in shared memory in bf16, in the 128-byte swizzle (64 at
//     D = 32) that the descriptors name.  Q stays resident; K and V
//     arrive through a ring of two stages: cp.async into the swizzled
//     layout, completion counted by one mbarrier per stage, the next
//     tile's copy in flight while the current one is used.
//   * The online softmax runs on the accumulator: a row's max and sum over
//     the four lanes of a quad take two shuffles each.  acc is rescaled
//     only after the wgmma group that wrote it has been waited for.
//   * The mask is applied only on tiles that the diagonal, the window edge
//     or the ragged Sq / Skv edge crosses; tiles that the reference's
//     _tile_live rules out are never visited.  Under a causal mask the
//     heaviest q tiles are launched first.
//   * One warpgroup per block; several blocks share an SM, so one block's
//     softmax overlaps another's products.
// The prob_bf16 variant (PB, the perf flag: the reference's jnp route
// under it) differs in two places: once Q has landed, each entry of the
// resident tile is rounded in place to bf16(q scale), so Q K^T is the
// scaled score and the softmax takes scale 1; and P V is one wgmma of p
// rounded to the nearest bf16, in place of the split's three.  p is formed
// against the running max, as in the default variant, so it is rounded
// before the rescale by alpha that the reference's one-pass max needs
// not: the two differ by one bf16 rounding of p.  Launches and the grid
// do not change; the default variant's code is untouched by the switch.
// Masking follows the reference: masked entries get p = 0; m starts at
// -1e30, so a row with no live key gets l = 0, o = 0 and lse = -1e30 +
// log(1e-30); o = acc / l, lse = m + log(max(l, 1e-30)).  Head sizes 32,
// 64, 128 and 256; the Python wrapper zero-pads the others up to the next.
// At D = 256 (recurrentgemma-9b; deepseek-v3's MLA 192, padded) acc is 128
// registers a thread and s 32 more, so the three bf16 terms of p are
// formed one 16-key slice at a time (12 registers), each slice's while
// the previous slice's products run, in place of the whole tile's 48.
// Shared memory is 164,880 B there (Q and two stages of K and V, 32 KB
// each), so one block of one warpgroup holds an SM and no other block's
// softmax fills the tensor cores' gaps: at a recurrentgemma serve layer
// (B 1, 16 q heads, S 1536) it took 3.1-3.7x its bound and 2.5x SDPA's
// (cuDNN) forward, at deepseek's MLA layer 5.5x its bound at the caller's
// widths (the padding alone is 1.78x the products) and 5.3x SDPA's
// (chip_smoke.py phase 28, H100 80GB HBM3 at 700 W).  ptxas keeps it at
// 255 registers with 112 bytes of stack.  Two consumer warpgroups sharing
// each K / V stage over 128 q rows is the redesign.

#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the reference's mask value, m's start
constexpr int kThreads = 128;      // one warpgroup
constexpr int kBM = 64;            // q rows a block, keys a kv tile
constexpr int kStages = 2;         // depth of the ring

// Shared memory: Q (64 x D), then per stage K, V (64 x D), then one
// mbarrier per stage; 1024 bytes of slack align the tiles.
template <int D>
__host__ __device__ constexpr int fwd_smem_bytes() {
  return 1024 + (1 + 2 * kStages) * kBM * D * 2 + 8 * kStages;
}

template <int D, bool PB>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int hq, int hkv, int sq, int skv,
                 int causal, int window, int q_offset, float scale,
                 int n_qtiles) {
  using G = Swz<D>;
  constexpr int kTile = kBM * D * 2;
  constexpr int NB = G::kBlocks, NC = G::kCols;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t bars = base + (1 + 2 * kStages) * kTile;
  auto s_k = [&](int st) { return base + (1 + 2 * st) * kTile; };
  auto s_v = [&](int st) { return base + (2 + 2 * st) * kTile; };

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int iq = causal ? n_qtiles - 1 - blockIdx.x : blockIdx.x;
  const int ih = blockIdx.y;
  const int ib = blockIdx.z;
  const int ikv = ih / (hq / hkv);
  const int q0 = iq * kBM;
  const int64_t q_head = (static_cast<int64_t>(ib) * hq + ih) * sq;
  const bf16* kp = k + (static_cast<int64_t>(ib) * hkv + ikv) * skv * D;
  const bf16* vp = v + (static_cast<int64_t>(ib) * hkv + ikv) * skv * D;

  // the live kv range of this q tile (the reference's _tile_live)
  const int q_first = q_offset + q0;
  const int q_last = q_first + kBM - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  const int k_begin =
      window > 0 ? max(0, q_first - window + 1) / kBM * kBM : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBM - 1) / kBM
                                      : 0;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bars + 8 * st, kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (n_tiles > 0)  // Q lands with the first kv tile
    load_tile<D, kBM>(s_q, q + q_head * D, q0, sq, tid);
  for (int t = 0; t < kStages - 1 && t < n_tiles; ++t) {
    load_tile<D, kBM>(s_k(t), kp, k_begin + t * kBM, skv, tid);
    load_tile<D, kBM>(s_v(t), vp, k_begin + t * kBM, skv, tid);
    cp_async_arrive(bars + 8 * t);
  }

  // this thread's rows of the tile: r_lo and r_lo + 8; m in units of the
  // scaled scores, mb = m kExpUnit
  const int r_lo = 16 * warp + lane / 4;
  // PB: the scale is in Q once Q has been rounded, s is the scaled score
  const float sc = PB ? 1.f : scale;
  const float scale2 = sc * kExpUnit;
  const float masked = -__int_as_float(0x7f800000);  // -inf: p = 0
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NB][NC / 2];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int c = 0; c < NC / 2; ++c) acc[b][c] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * kBM;
    const int st = it % kStages;
    if (it + kStages - 1 < n_tiles) {
      __syncthreads();  // every warp is done with the stage refilled here
      const int nx = (it + kStages - 1) % kStages;
      const int kn = k0 + (kStages - 1) * kBM;
      load_tile<D, kBM>(s_k(nx), kp, kn, skv, tid);
      load_tile<D, kBM>(s_v(nx), vp, kn, skv, tid);
      cp_async_arrive(bars + 8 * nx);
    }
    mbar_wait(bars + 8 * st, (it / kStages) & 1);
    if constexpr (PB) {
      if (it == 0) {  // Q landed with the first tile: Q <- bf16(Q scale)
        scale_tile<kBM, D>(smem_raw, raw, s_q, scale, tid);
        fence_proxy_async();
        __syncthreads();
      }
    }
    fence_proxy_async();

    // s = q k^T: rows of the q tile, the tile's 64 keys
    float s[32];  // the first product overwrites it
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss(s, desc_k<D, kBM>(s_q, kk), desc_k<D, kBM>(s_k(st), kk), kk);
    wg_commit();
    wg_wait();
    fence_regs(s);

    // the mask only where the diagonal, the window edge or the end of the
    // keys crosses the tile
    const bool edge = k0 + kBM > skv || (causal && q_first < k0 + kBM - 1) ||
                      (window > 0 && k0 <= q_last - window);
    if (edge) {
#pragma unroll
      for (int at = 0; at < 32; ++at)  // at = 4 n8 + 2 i + j
        if (!live(q_first + r_lo + 8 * (at / 2 % 2),
                  k0 + 8 * (at / 4) + 2 * (lane % 4) + at % 2, skv, causal,
                  window))
          s[at] = masked;
    }
    // online softmax: the rows' max over the quad, p in place of s
    float mx[2] = {masked, masked}, mb[2], alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int at = 0; at < 32; ++at)
      mx[at / 2 % 2] = fmaxf(mx[at / 2 % 2], s[at]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i] * sc);
      alpha[i] = exp_p((m[i] - m_new) * kExpUnit);
      mb[i] = m_new * kExpUnit;
      m[i] = m_new;
    }
#pragma unroll
    for (int at = 0; at < 32; ++at) {
      s[at] = exp_p(fmaf(s[at], scale2, -mb[at / 2 % 2]));
      ps[at / 2 % 2] += s[at];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 1);
      ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 2);
      l[i] = alpha[i] * l[i] + ps[i];
    }
    // the previous tile's P V has been waited for: acc is free
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int c = 0; c < NC / 2; ++c) acc[b][c] *= alpha[c / 2 % 2];

    // acc += p v: p from registers in three bf16 terms (PB: one, p
    // rounded to nearest), v transposed
    constexpr int kParts = PB ? 1 : 3;
    if constexpr (D == 256) {
      // acc holds 128 registers a thread: the terms of one 16-key slice
      // at a time, formed while the previous slice's products run
      uint32_t f[4][kParts][4];
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        fence_slice(s, kc);  // not hoisted above the previous slice
        slice_frags<PB>(s, kc, f[kc]);
        wg_fence();
#pragma unroll
        for (int part = 0; part < kParts; ++part)
#pragma unroll
          for (int b = 0; b < NB; ++b)
            mma_rs(acc[b], f[kc][part], desc_mn<D, kBM>(s_v(st), kc, b));
        wg_commit();
        if (kc > 0) {
          wg_wait<1>();  // slice kc - 1 is done with its terms
          fence_frags(f[kc - 1]);
        }
      }
      wg_wait();
#pragma unroll
      for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
      fence_frags(f[3]);
    } else {
      uint32_t f[kParts][4][4];
      if constexpr (PB)
        round_frags<64>(s, f);
      else
        split_frags<64>(s, f);
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int part = 0; part < kParts; ++part)
#pragma unroll
          for (int b = 0; b < NB; ++b)
            mma_rs(acc[b], f[part][kc], desc_mn<D, kBM>(s_v(st), kc, b));
      wg_commit();
      wg_wait();
#pragma unroll
      for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
      fence_frags(f);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r_lo + 8 * i;
    if (row >= sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
    bf16* dst = o + (q_head + row) * D + 2 * (lane % 4);
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int n8 = 0; n8 < NC / 8; ++n8)
        *reinterpret_cast<__nv_bfloat162*>(dst + b * NC + 8 * n8) =
            __floats2bfloat162_rn(acc[b][4 * n8 + 2 * i] / li,
                                  acc[b][4 * n8 + 2 * i + 1] / li);
    if (lane % 4 == 0) lse[q_head + row] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

template <int D, bool PB>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                   float* lse, int b, int hq, int hkv, int sq, int skv,
                   int causal, int window, int q_offset, float scale,
                   cudaStream_t stream) {
  constexpr int bytes = fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, PB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const int n_qtiles = (sq + kBM - 1) / kBM;
  const dim3 grid(n_qtiles, hq, b);
  flash_fwd_kernel<D, PB><<<grid, kThreads, bytes, stream>>>(
      q, k, v, o, lse, hq, hkv, sq, skv, causal, window, q_offset, scale,
      n_qtiles);
  return cudaGetLastError();
}

template <bool PB>
cudaError_t dispatch(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                     float* lse, int b, int hq, int hkv, int sq, int skv,
                     int d, int causal, int window, int q_offset,
                     float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<32, PB>(q, k, v, o, lse, b, hq, hkv, sq, skv, causal,
                            window, q_offset, scale, stream);
    case 64:
      return launch<64, PB>(q, k, v, o, lse, b, hq, hkv, sq, skv, causal,
                            window, q_offset, scale, stream);
    case 128:
      return launch<128, PB>(q, k, v, o, lse, b, hq, hkv, sq, skv, causal,
                             window, q_offset, scale, stream);
    case 256:
      return launch<256, PB>(q, k, v, o, lse, b, hq, hkv, sq, skv, causal,
                             window, q_offset, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), o like q, contiguous
// bfloat16, rows 16-byte aligned; lse (B, Hq, Sq) float32.  window <= 0
// means none.  D in {32, 64, 128, 256}.  prob_bf16 != 0: the flag's
// variant.
cudaError_t flash_attention_fwd(const void* q, const void* k, const void* v,
                                void* o, float* lse, int b, int hq, int hkv,
                                int sq, int skv, int d, int causal,
                                int window, int q_offset, float scale,
                                int prob_bf16, cudaStream_t stream) {
  if (b <= 0 || sq <= 0 || hkv <= 0 || hq % hkv != 0)
    return cudaErrorInvalidValue;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  return prob_bf16
             ? dispatch<true>(qb, kb, vb, ob, lse, b, hq, hkv, sq, skv, d,
                              causal, window, q_offset, scale, stream)
             : dispatch<false>(qb, kb, vb, ob, lse, b, hq, hkv, sq, skv, d,
                               causal, window, q_offset, scale, stream);
}
