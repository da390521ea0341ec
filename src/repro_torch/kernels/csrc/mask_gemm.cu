// Hand-written Hopper (sm_90a) kernels of the batched-Brandes level
// recurrences behind the analytic arc-load engine ("fused").
//
// Plain CUDA C++ with a C++ launcher per (kernel, dtype); the binding
// file (sim_step_binding.cpp) checks the tensors, takes PyTorch's
// current stream and calls these launchers.
//
// frontier_step replaces src/repro/kernels/mask_gemm.py::_fwd_kernel
// (the Pallas kernel behind frontier_step).  One forward BFS level of a
// block of S sources over the N vertices:
//
//     t       = front @ A
//     new     = (t > 0) & (dist < 0)
//     nxt     = where(new, t, 0)
//     dist'   = where(new, lvl, dist)
//     sigma'  = where(new, t, sigma)
//     any_new |= new.any()
//
// backward_step replaces src/repro/kernels/mask_gemm.py::_bwd_kernel:
//
//     delta'  = delta + sigma * ((coeff @ A) * (dist == lvl))
//
// A is a graph adjacency: 1.8 % dense at PN(27), 0.8 % at PN(64).  The
// TPU ran the product as a dense blocked GEMM because its matrix unit
// makes zeros cheap; here A comes compressed by column with values
// (CSC: column v holds data[indptr[v]:indptr[v+1]] at rows indices[...];
// the same function on another storage of A, general for any weighted A,
// and for a graph's symmetric adjacency the same arrays as its CSR), so
// the work is S * nnz(A) multiply-adds and both kernels are bound by HBM
// bytes: each (S, N) operand is read once and each output written once
// (frontier: 40 B per cell in float64, backward: 36 B).
//
// Design: one thread per output (s, v).  A block covers a run of 32
// consecutive v for 8 rows s, one warp per row; the thread sums
// x[s, indices[j]] * data[j] over column v in ascending j and applies
// the epilogue in registers, so the (S, N) operands stream coalesced.
// The 8 warps of a block walk the same 32 columns of A, so all but the
// first read them from L1.  A first version with 256 v of one row per
// block, whose column reads (lanes a column's length apart) missed L1 in
// every warp, ran the forward step several times slower on an H100
// (PERF.md, kernel table).  The gathers x[s, indices[j]] go through the
// cache.
// No float atomics: bitwise reproducible.
// The "any new" flag is one int32 raised by one integer atomicOr per
// warp that claimed a vertex (deterministic), so the caller reads one
// scalar per level.  Edges: the grid is cut to the shape, no padding.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCols = 32;                // consecutive v per block: a warp
constexpr int kRows = 8;                 // rows s per block, one per warp
constexpr int kThreads = kCols * kRows;

template <typename T>
__device__ __forceinline__ T col_dot(const T* __restrict__ xs,
                                     const int32_t* __restrict__ indptr,
                                     const int32_t* __restrict__ indices,
                                     const T* __restrict__ data, int v) {
  T t = T(0);
  const int end = indptr[v + 1];
  for (int j = indptr[v]; j < end; ++j) t += xs[indices[j]] * data[j];
  return t;
}

template <typename T>
__global__ void frontier_kernel(
    const T* __restrict__ front, const int32_t* __restrict__ indptr,
    const int32_t* __restrict__ indices, const T* __restrict__ data,
    const int32_t* __restrict__ dist, const T* __restrict__ sigma,
    T* __restrict__ nxt, int32_t* __restrict__ dist_out,
    T* __restrict__ sigma_out, int32_t* __restrict__ any_new, int64_t rows,
    int n, int v_blocks, int lvl) {
  const int64_t s = static_cast<int64_t>(blockIdx.x / v_blocks) * kRows +
                    threadIdx.x / kCols;
  const int v = (blockIdx.x % v_blocks) * kCols + threadIdx.x % kCols;
  bool is_new = false;
  if (v < n && s < rows) {
    const int64_t o = s * n + v;
    const T t = col_dot(front + s * n, indptr, indices, data, v);
    const int32_t d = dist[o];
    is_new = (t > T(0)) && (d < 0);
    nxt[o] = is_new ? t : T(0);
    dist_out[o] = is_new ? lvl : d;
    sigma_out[o] = is_new ? t : sigma[o];
  }
  // every lane reaches the vote: no thread returned early
  if (__any_sync(0xffffffffu, is_new) && (threadIdx.x & 31) == 0)
    atomicOr(any_new, 1);
}

template <typename T>
__global__ void backward_kernel(
    const T* __restrict__ coeff, const int32_t* __restrict__ indptr,
    const int32_t* __restrict__ indices, const T* __restrict__ data,
    const int32_t* __restrict__ dist, const T* __restrict__ sigma,
    const T* __restrict__ delta, T* __restrict__ out, int64_t rows, int n,
    int v_blocks, int lvl) {
  const int64_t s = static_cast<int64_t>(blockIdx.x / v_blocks) * kRows +
                    threadIdx.x / kCols;
  const int v = (blockIdx.x % v_blocks) * kCols + threadIdx.x % kCols;
  if (v >= n || s >= rows) return;
  const int64_t o = s * n + v;
  // the product is needed only where the level mask holds
  const T t = dist[o] == lvl
                  ? col_dot(coeff + s * n, indptr, indices, data, v)
                  : T(0);
  out[o] = delta[o] + sigma[o] * t;
}

inline unsigned grid_of(int64_t s, int n, int* v_blocks) {
  *v_blocks = (n + kCols - 1) / kCols;
  return static_cast<unsigned>((s + kRows - 1) / kRows * *v_blocks);
}

template <typename T>
cudaError_t launch_frontier(const T* front, const int32_t* indptr,
                            const int32_t* indices, const T* data,
                            const int32_t* dist, const T* sigma, T* nxt,
                            int32_t* dist_out, T* sigma_out,
                            int32_t* any_new, int64_t s, int n, int lvl,
                            cudaStream_t stream) {
  int v_blocks;
  const unsigned grid = grid_of(s, n, &v_blocks);
  frontier_kernel<T><<<grid, kThreads, 0, stream>>>(
      front, indptr, indices, data, dist, sigma, nxt, dist_out, sigma_out,
      any_new, s, n, v_blocks, lvl);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_backward(const T* coeff, const int32_t* indptr,
                            const int32_t* indices, const T* data,
                            const int32_t* dist, const T* sigma,
                            const T* delta, T* out, int64_t s, int n,
                            int lvl, cudaStream_t stream) {
  int v_blocks;
  const unsigned grid = grid_of(s, n, &v_blocks);
  backward_kernel<T><<<grid, kThreads, 0, stream>>>(
      coeff, indptr, indices, data, dist, sigma, delta, out, s, n, v_blocks,
      lvl);
  return cudaGetLastError();
}

}  // namespace

#define MASK_GEMM_DEFINE(T, SUFFIX)                                         \
  cudaError_t mask_frontier_##SUFFIX(                                       \
      const T* front, const int32_t* indptr, const int32_t* indices,        \
      const T* data, const int32_t* dist, const T* sigma, T* nxt,           \
      int32_t* dist_out, T* sigma_out, int32_t* any_new, int64_t s, int n,  \
      int lvl, cudaStream_t stream) {                                       \
    return launch_frontier<T>(front, indptr, indices, data, dist, sigma,    \
                              nxt, dist_out, sigma_out, any_new, s, n, lvl, \
                              stream);                                      \
  }                                                                         \
  cudaError_t mask_backward_##SUFFIX(                                       \
      const T* coeff, const int32_t* indptr, const int32_t* indices,        \
      const T* data, const int32_t* dist, const T* sigma, const T* delta,   \
      T* out, int64_t s, int n, int lvl, cudaStream_t stream) {             \
    return launch_backward<T>(coeff, indptr, indices, data, dist, sigma,    \
                              delta, out, s, n, lvl, stream);               \
  }

MASK_GEMM_DEFINE(float, f32)
MASK_GEMM_DEFINE(double, f64)
