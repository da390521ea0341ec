// Hand-written Hopper (sm_90a) kernels of the flow-level simulator step.
//
// This file holds no PyTorch header: it is plain CUDA C++ with a C++
// launcher per (kernel, dtype).  The binding file (sim_step_binding.cpp)
// checks the tensors, takes PyTorch's current stream and calls these
// launchers.
//
// fused_step_update replaces src/repro/kernels/sim_step.py::_kernel (the
// Pallas kernel behind fused_step_update).  For one virtual channel:
//
//     q_out = q * fac[r, k] - q * corr[r, k] * deliver[r, k, d]
//           + inflow[r, d] * split[r, k, d]
//     o_out[r, k] = sum_d q_out[r, k, d]
//
// It reads q, split and deliver once and writes q_out once, so it is
// bound by HBM bytes (about 1.04 GB per VC1 launch at PN(27)).  Design:
// one block per (row block, dest tile), one warp per (router, slot) row
// in the block, each lane owning 4 columns of the 128-wide tile, so the
// three big streams load coalesced along the dest axis.  The TPU kernel
// carried o_out across the sequential dest-tile grid axis; blocks here
// run in no order, so each warp writes its (row, tile) partial to an
// (N*K, T) scratch and a second pass sums the T partials in ascending
// tile order.  No float atomics: the result is bitwise reproducible.
// tile_mask is read from device memory (computed on the device by the
// caller, never read back to the host); a dead tile writes zeros.
//
// fused_decision replaces src/repro/kernels/sim_step.py::_decision_kernel.
// Per-hop UGAL: q_min[r, d] = sum_k b0[r, k] * split[r, k, d] (ascending
// k), out = cand where dist * q_min > thr + hval * q_val[r], else 0.  One
// block per (router, dest tile), one thread per dest column; split is
// read once along the dest axis, so it is bound by HBM bytes too.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 128;          // dest columns per tile (DEST_TILE)
constexpr int kWarps = 8;           // warps per step-update block
constexpr int kRowsPerBlock = 32;   // (router, slot) rows per block
constexpr int kColsPerLane = kTile / 32;

template <typename T>
__global__ void step_update_kernel(
    const T* __restrict__ q, const T* __restrict__ split,
    const T* __restrict__ deliver, const T* __restrict__ fac,
    const T* __restrict__ corr, const T* __restrict__ inflow,
    const int32_t* __restrict__ tile_mask, T* __restrict__ q_out,
    T* __restrict__ partial, int64_t rows, int k, int w, int n_tiles) {
  const int tile = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = tile * kTile;
  const bool live = tile_mask[tile] != 0;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
  for (int rr = warp; rr < kRowsPerBlock; rr += kWarps) {
    const int64_t a = row0 + rr;
    if (a >= rows) break;  // uniform across the warp
    const int64_t base = a * w;
    T sum = T(0);
    if (live) {
      const T f = fac[a];
      const T c = corr[a];
      const T* in_row = inflow + (a / k) * w;
#pragma unroll
      for (int i = 0; i < kColsPerLane; ++i) {
        const int d = col0 + lane + 32 * i;
        if (d < w) {
          const T qv = q[base + d];
          T v = qv * f;
          v -= qv * c * deliver[base + d];
          v += in_row[d] * split[base + d];
          q_out[base + d] = v;
          sum += v;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kColsPerLane; ++i) {
        const int d = col0 + lane + 32 * i;
        if (d < w) q_out[base + d] = T(0);
      }
    }
    // fixed butterfly order: deterministic
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_down_sync(0xffffffffu, sum, off);
    if (lane == 0) partial[a * n_tiles + tile] = sum;
  }
}

template <typename T>
__global__ void tile_partial_sum_kernel(const T* __restrict__ partial,
                                        T* __restrict__ o_out, int64_t rows,
                                        int n_tiles) {
  const int64_t a =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (a >= rows) return;
  const T* p = partial + a * n_tiles;
  T s = T(0);
  for (int j = 0; j < n_tiles; ++j) s += p[j];
  o_out[a] = s;
}

template <typename T>
__global__ void decision_kernel(
    const T* __restrict__ b0, const T* __restrict__ split,
    const T* __restrict__ dist, const T* __restrict__ hval,
    const T* __restrict__ cand, const T* __restrict__ q_val,
    const int32_t* __restrict__ tile_mask, T thr, T* __restrict__ out,
    int k, int c) {
  const int64_t r = blockIdx.x;
  const int tile = blockIdx.y;
  const int d = tile * kTile + threadIdx.x;
  if (d >= c) return;
  const int64_t rd = r * c + d;
  if (tile_mask[tile] == 0) {
    out[rd] = T(0);  // no candidate fluid in the tile: nothing diverts
    return;
  }
  const T* b = b0 + r * k;
  const T* sp = split + r * k * c + d;
  T q_min = T(0);
  for (int kk = 0; kk < k; ++kk)
    q_min += b[kk] * sp[static_cast<int64_t>(kk) * c];
  const bool divert = dist[rd] * q_min > thr + hval[rd] * q_val[r];
  out[rd] = divert ? cand[rd] : T(0);
}

template <typename T>
cudaError_t launch_step_update(const T* q, const T* split, const T* deliver,
                               const T* fac, const T* corr, const T* inflow,
                               const int32_t* tile_mask, T* q_out,
                               T* partial, T* o_out, int64_t rows, int k,
                               int w, int n_tiles, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((rows + kRowsPerBlock - 1) /
                                        kRowsPerBlock),
                  static_cast<unsigned>(n_tiles));
  step_update_kernel<T><<<grid, kWarps * 32, 0, stream>>>(
      q, split, deliver, fac, corr, inflow, tile_mask, q_out, partial, rows,
      k, w, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = 256;
  tile_partial_sum_kernel<T>
      <<<static_cast<unsigned>((rows + threads - 1) / threads), threads, 0,
         stream>>>(partial, o_out, rows, n_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_decision(const T* b0, const T* split, const T* dist,
                            const T* hval, const T* cand, const T* q_val,
                            const int32_t* tile_mask, double thr, T* out,
                            int64_t n, int k, int c, int n_tiles,
                            cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(n), static_cast<unsigned>(n_tiles));
  decision_kernel<T><<<grid, kTile, 0, stream>>>(
      b0, split, dist, hval, cand, q_val, tile_mask, static_cast<T>(thr),
      out, k, c);
  return cudaGetLastError();
}

}  // namespace

#define SIM_STEP_DEFINE(T, SUFFIX)                                           \
  cudaError_t sim_step_update_##SUFFIX(                                      \
      const T* q, const T* split, const T* deliver, const T* fac,            \
      const T* corr, const T* inflow, const int32_t* tile_mask, T* q_out,    \
      T* partial, T* o_out, int64_t rows, int k, int w, int n_tiles,         \
      cudaStream_t stream) {                                                 \
    return launch_step_update<T>(q, split, deliver, fac, corr, inflow,       \
                                 tile_mask, q_out, partial, o_out, rows, k,  \
                                 w, n_tiles, stream);                        \
  }                                                                          \
  cudaError_t sim_decision_##SUFFIX(                                         \
      const T* b0, const T* split, const T* dist, const T* hval,             \
      const T* cand, const T* q_val, const int32_t* tile_mask, double thr,   \
      T* out, int64_t n, int k, int c, int n_tiles, cudaStream_t stream) {   \
    return launch_decision<T>(b0, split, dist, hval, cand, q_val, tile_mask, \
                              thr, out, n, k, c, n_tiles, stream);           \
  }

SIM_STEP_DEFINE(float, f32)
SIM_STEP_DEFINE(double, f64)
