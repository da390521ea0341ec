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
// and for a graph's symmetric adjacency the same arrays as its CSR).
// The kernels do not rely on the order of the rows inside a column.
//
// What bounds them.  The dense operands move 40 B per (s, v) cell in
// the frontier step (front, dist, sigma in; nxt, dist', sigma' out) and
// 36 B in the backward step: at the first PN(64) source block (S = 756,
// N = 8322, nnz = 540,930, float64) 252 / 227 MB, 0.075 / 0.068 ms at
// 3.35 TB/s.  The work is S * nnz = 409 M gathers x[s, indices[j]] times
// data[j].  One thread per output gathering from device memory (the
// first port of these kernels) pulled a 32-byte sector per gather from
// L2, up to 13 GB, and ran at 14x / 8x the byte bound.  So the design
// keeps the gathers out of L2:
//
// 1. Rows in shared memory.  A block owns R rows s of the output and
//    stages its R rows of x (front or coeff) in shared memory with
//    cp.async, once; every gather is then a shared-memory read.  A
//    float64 row of N = 8322 is 66.6 KB, so R = 3 rows (199.7 KB) fit
//    in the 227 KB a block may hold: 252 blocks for S = 756, one per SM
//    at a time.  Where not even the plan's rows fit whole (large N), the
//    contraction is cut into chunks of K consecutive u: the block stages
//    its rows' segment [u0, u0 + K) in turn, an entry whose row lies
//    outside the segment waits for its chunk, and each chunk's sums are
//    carried to the next in the output array (nxt or delta'), added in
//    chunk order.  The wrapper (kernels/mask_gemm.py::plan) picks R and
//    K from the card's shared memory and hands them in.
// 2. Each column of A read once per block (per chunk), coalesced, for
//    all R rows.  A warp takes 32 consecutive columns at a time, from a
//    counter in shared memory (so that skipped columns do not leave some
//    warps idle), and marks those that some row needs from their dist
//    tile (one lane per column).  Sixteen lanes then walk one marked
//    column's entries, two columns a pass: lane l takes entries
//    beg + l, beg + l + 16, ... ("slots"), so a column's indices and
//    data are read in 64-byte and 128-byte runs, all five slots of a
//    PN(64) column in one round of loads; each entry feeds the gathers
//    of all R rows, three slots' gathers in flight before their
//    products.  An
//    xor tree over the sixteen lanes closes the column's sum, and the
//    column's own lane takes it and writes the epilogue, coalesced
//    across the warp.
// 3. Only the products the epilogue keeps.  The frontier step needs t
//    only where dist < 0 and the backward step only where dist == lvl;
//    a warp walks only the columns that some row needs.  A block first
//    scans its dist rows; if none of its outputs needs a product (the
//    last BFS level, a dependency level that misses its rows) it stages
//    nothing and only writes the epilogue.  The outputs are exactly
//    those of the full product.
//
// Budget at the timed shape (BFS level 2 of the first PN(64) block,
// float64): x comes in once (50.3 MB); the CSC triple (6.5 MB, resident
// in the 50 MB L2) is read by each of the 252 blocks, 1.64 GB from L2
// against up to 13 GB of sectors before; the 409 M gathers are
// shared-memory reads.  What bounds the result is the SM's load/store
// pipe, which the gathers (15 random 8-byte shared loads a pass of two
// columns), the loads of the triple (10) and the shuffles (32) share,
// and the latency of each pass's round of loads, which 32 warps a block
// hide (R <= 3; 16 above, for their registers).  Bank conflicts of the
// gathers cost the most that a layout can change: PN(64)'s line
// columns step their rows by 64, all on one bank.  So the sparse copy
// that core/graph.py::adjacency_csr builds deals each column's entries
// round-robin over the 16 banks (bank_order), and the sixteen lanes of a
// slot, one half-warp, mostly read sixteen banks.
// scripts/mask_gemm_variants.py ablates the kernel on an H100 (PERF.md,
// Findings): at level 2 it takes 0.530 ms, with the graph's own order
// 0.587, with eight lanes a column 0.548, with every gather on its own
// bank 0.526, without the xor tree 0.444, with 16 warps 0.643, and its
// staging, dist scans and epilogue alone 0.120: the xor tree and the
// streaming are what is left.
//
// Exact and reproducible: every output sums in one fixed order (each
// lane's entries in ascending j, then the xor tree, then the chunks in
// order), each product and sum rounded by itself (__dmul_rn/__dadd_rn,
// never contracted to an FMA), with no float atomics, so two launches
// agree bit for bit and ref.masked_product_tiled mirrors the kernels
// bit for bit.  The "any new" flag is one int32 raised by one integer
// atomicOr per warp that claimed a vertex, so the caller reads one
// scalar per level.  Edges: rows S and columns N need not be multiples
// of R or 32; the grid is cut to the shape, with no padding.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// threads per block: 32 warps where R <= 3 rows fit in 64 registers a
// thread, 16 above
__host__ __device__ constexpr int threads_for(int rows) {
  return rows <= 3 ? 1024 : 512;
}
constexpr int kGroup = 32;               // consecutive columns per warp task
constexpr int kLanes = 16;               // lanes per column, a half-warp
constexpr int kPass = 32 / kLanes;       // columns per pass of a warp
constexpr int kUnroll = 9;               // slots a lane loads at once
constexpr int kBatch = 3;                // slots whose gathers go out at once
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T)));
}

// x at a 32-bit shared address (computed once per block: through a
// generic pointer the compiler recomputes the window's base per gather)
__device__ __forceinline__ double lds(unsigned addr, double) {
  double v;
  asm volatile("ld.shared.f64 %0, [%1];" : "=d"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ float lds(unsigned addr, float) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T>
struct MaskArgs {
  const T* x;                // front or coeff, (S, N)
  const int32_t* indptr;     // (N + 1,)
  const int32_t* indices;    // (nnz,)
  const T* data;             // (nnz,)
  const int32_t* dist;       // (S, N)
  const T* sigma;            // (S, N)
  const T* delta;            // (S, N), backward only
  T* out;                    // nxt (frontier) or delta' (backward)
  int32_t* dist_out;         // frontier only
  T* sigma_out;              // frontier only
  int32_t* any_new;          // frontier only
  int64_t s;
  int n, lvl, chunk, chunks, col_splits;
};

// Does the epilogue keep the product at an output of this distance?
template <bool kFwd>
__device__ __forceinline__ bool needs(int32_t d, int lvl) {
  return kFwd ? d < 0 : d == lvl;
}

// One pass of a warp: the lowest kPass marked columns of a group, one per
// sixteen lanes; this lane's column spans entries [beg, end), and the pass
// takes `slots` entries per lane (the most of its columns, so that every
// loop over slots is warp-uniform).
struct Pass {
  int beg, end, slots;
};

__device__ __forceinline__ Pass pass_of(unsigned rest, int sub, int lo,
                                        int hi) {
  unsigned mine = rest;
  for (int i = 0; i < sub; ++i) mine &= mine - 1u;
  const int col = mine ? __ffs(mine) - 1 : 0;
  Pass ps;
  ps.beg = __shfl_sync(kFull, lo, col);
  ps.end = __shfl_sync(kFull, hi, col);
  if (!mine) ps.end = ps.beg;
  ps.slots = static_cast<int>(__reduce_max_sync(
      kFull, static_cast<unsigned>(ps.end - ps.beg + kLanes - 1) / kLanes));
  return ps;
}

// Slots s0 .. s0 + kUnroll - 1 of this lane (entries beg + sl + 16 k): the
// entry's row relative to the chunk (>= the chunk's width outside it, or
// past the column) and its value.
template <typename T>
__device__ __forceinline__ void load_slots(const MaskArgs<T>& p,
                                           const Pass& ps, int sl, int s0,
                                           int u0, unsigned (&u)[kUnroll],
                                           T (&a)[kUnroll]) {
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int j = ps.beg + sl + (s0 + k) * kLanes;
    u[k] = j < ps.end ? static_cast<unsigned>(p.indices[j]) -
                            static_cast<unsigned>(u0)
                      : 0xffffffffu;
    a[k] = j < ps.end ? p.data[j] : T(0);
  }
}

// Sum the first min(left, kUnroll) loaded slots into part, for all R rows:
// a row whose output does not keep the product sums it all the same, for
// nothing; a slot without an entry in this chunk reads the row's first
// word and adds nothing.  The loads of kBatch slots go out before their
// products.
template <typename T, int R>
__device__ __forceinline__ void gather_slots(unsigned xs_addr,
                                             unsigned row_bytes, int kw,
                                             int left,
                                             const unsigned (&u)[kUnroll],
                                             const T (&a)[kUnroll],
                                             T (&part)[R]) {
#pragma unroll
  for (int k0 = 0; k0 < kUnroll; k0 += kBatch) {
    if (k0 >= left) break;               // warp-uniform
    T xv[kBatch][R];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const unsigned uu =
          u[k0 + k] < static_cast<unsigned>(kw) ? u[k0 + k] : 0u;
      const unsigned at = xs_addr + uu * sizeof(T);
#pragma unroll
      for (int r = 0; r < R; ++r) xv[k][r] = lds(at + r * row_bytes, T(0));
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const T prod = mul_rn(xv[k][r], a[k0 + k]);
        if (u[k0 + k] < static_cast<unsigned>(kw))
          part[r] = add_rn(part[r], prod);
      }
  }
}

template <typename T, int R, bool kFwd>
__global__ void __launch_bounds__(threads_for(R), 1)
    mask_gemm_kernel(const MaskArgs<T> p) {
  constexpr int kThreads = threads_for(R);
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);      // R rows of one chunk of x
  const unsigned xs_addr =
      static_cast<unsigned>(__cvta_generic_to_shared(xs));
  __shared__ int next_group;

  const int n = p.n;
  const int split = blockIdx.x % p.col_splits;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x / p.col_splits) * R;
  const int rows = static_cast<int>(
      p.s - row0 < R ? p.s - row0 : static_cast<int64_t>(R));
  const int groups = (n + kGroup - 1) / kGroup;
  const int g_lo = static_cast<int>(static_cast<int64_t>(groups) * split /
                                    p.col_splits);
  const int g_hi = static_cast<int>(static_cast<int64_t>(groups) *
                                    (split + 1) / p.col_splits);
  const int v_lo = g_lo * kGroup;
  const int v_hi = min(g_hi * kGroup, n);
  const int lane = threadIdx.x & 31;
  const int sub = lane / kLanes;
  const int sl = lane % kLanes;

  // Does any output of the block need a product?  If not, stage nothing.
  bool want = false;
  for (int r = 0; r < rows; ++r) {
    const int32_t* drow = p.dist + (row0 + r) * n;
    for (int v = v_lo + static_cast<int>(threadIdx.x); v < v_hi;
         v += kThreads)
      want |= needs<kFwd>(drow[v], p.lvl);
  }
  const bool work = __syncthreads_or(want);
  bool claimed = false;

  for (int c = work ? 0 : p.chunks - 1; c < p.chunks; ++c) {
    const int u0 = c * p.chunk;                 // the chunk's first row of A
    const int kw = min(p.chunk, n - u0);
    const unsigned row_bytes = static_cast<unsigned>(kw) * sizeof(T);
    const bool last = c == p.chunks - 1;
    __syncthreads();                   // the previous chunk's gathers are done
    if (work) {
      for (int r = 0; r < rows; ++r) {
        const T* src = p.x + (row0 + r) * n + u0;
        T* dst = xs + r * kw;
        for (int i = threadIdx.x; i < kw; i += kThreads)
          cp_async(dst + i, src + i);
      }
      cp_async_wait_all();
    }
    if (threadIdx.x == 0) next_group = g_lo;
    __syncthreads();

    for (;;) {
      int g = 0;
      if (lane == 0) g = atomicAdd(&next_group, 1);
      g = __shfl_sync(kFull, g, 0);
      if (g >= g_hi) break;                // warp-uniform
      const int v = g * kGroup + lane;
      const bool in = v < n;

      // the columns of this group where some row keeps the product
      bool keep = false;
#pragma unroll
      for (int r = 0; r < R; ++r)
        keep |= work && in && r < rows &&
                needs<kFwd>(p.dist[(row0 + r) * n + v], p.lvl);
      const unsigned cols = __ballot_sync(kFull, keep);
      // the epilogue's sigma (and delta) lines into L2 while the products
      // are summed, without holding registers for them
      if (in && (lane & 15) == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r >= rows) break;
          const int64_t o = (row0 + r) * n + v;
          asm volatile("prefetch.global.L2 [%0];" ::"l"(p.sigma + o));
          if (!kFwd)
            asm volatile("prefetch.global.L2 [%0];" ::"l"(p.delta + o));
        }
      }
      const int lo = in ? p.indptr[v] : 0;
      const int hi = in ? p.indptr[v + 1] : 0;

      T t[R];
#pragma unroll
      for (int r = 0; r < R; ++r) t[r] = T(0);
      // Passes over the marked columns, kPass at a time.
      for (unsigned rest = cols; rest;) {
        const Pass ps = pass_of(rest, sub, lo, hi);
        unsigned u[kUnroll];
        T a[kUnroll];
        load_slots(p, ps, sl, 0, u0, u, a);
        T part[R];
#pragma unroll
        for (int r = 0; r < R; ++r) part[r] = T(0);
        gather_slots<T, R>(xs_addr, row_bytes, kw, ps.slots, u, a, part);
        for (int s0 = kUnroll; s0 < ps.slots; s0 += kUnroll) {
          load_slots(p, ps, sl, s0, u0, u, a);
          gather_slots<T, R>(xs_addr, row_bytes, kw, ps.slots - s0, u, a,
                             part);
        }
        // close each column's sum over its sixteen lanes (the same bits in
        // every lane: lane l adds lane l ^ 8, then l ^ 4, l ^ 2, l ^ 1)
#pragma unroll
        for (int off = kLanes / 2; off; off /= 2) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            part[r] = add_rn(part[r], __shfl_xor_sync(kFull, part[r], off));
        }
        // the column's own lane takes its sums
        const int rank = __popc(rest & ((1u << lane) - 1u));
        const bool owner = ((rest >> lane) & 1u) && rank < kPass;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const T got =
              __shfl_sync(kFull, part[r], (owner ? rank : 0) * kLanes);
          if (owner) t[r] = got;
        }
        for (int i = 0; i < kPass; ++i) rest &= rest - 1u;
      }

#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!in || r >= rows) break;
        const int64_t o = (row0 + r) * n + v;
        const int32_t dr = p.dist[o];
        T tr = t[r];
        if (p.chunks > 1 && work) {        // carry the sum over the chunks
          if (c > 0) tr = add_rn(p.out[o], tr);
          if (!last) {
            p.out[o] = tr;
            continue;
          }
        }
        if constexpr (kFwd) {
          const bool is_new = dr < 0 && tr > T(0);
          p.out[o] = is_new ? tr : T(0);
          p.dist_out[o] = is_new ? p.lvl : dr;
          p.sigma_out[o] = is_new ? tr : p.sigma[o];
          claimed |= is_new;
        } else {
          p.out[o] = add_rn(p.delta[o],
                            mul_rn(p.sigma[o], dr == p.lvl ? tr : T(0)));
        }
      }
    }
  }
  if constexpr (kFwd) {
    // every lane reaches the vote: the loops above are warp-uniform
    if (__any_sync(kFull, claimed) && lane == 0) atomicOr(p.any_new, 1);
  }
}

template <typename T, int R, bool kFwd>
cudaError_t launch_rows(const MaskArgs<T>& p, cudaStream_t stream) {
  const auto kernel = mask_gemm_kernel<T, R, kFwd>;
  const size_t smem = static_cast<size_t>(R) * p.chunk * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t blocks = (p.s + R - 1) / R * p.col_splits;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), threads_for(R), smem, stream>>>(p);
  return cudaGetLastError();
}

// The plan's rows per block, one instantiation each.
template <typename T, bool kFwd>
cudaError_t launch(MaskArgs<T> p, int rows, cudaStream_t stream) {
  if (p.chunk < 1 || p.col_splits < 1) return cudaErrorInvalidValue;
  p.chunks = (p.n + p.chunk - 1) / p.chunk;
  switch (rows) {
    case 1: return launch_rows<T, 1, kFwd>(p, stream);
    case 2: return launch_rows<T, 2, kFwd>(p, stream);
    case 3: return launch_rows<T, 3, kFwd>(p, stream);
    case 4: return launch_rows<T, 4, kFwd>(p, stream);
    case 6: return launch_rows<T, 6, kFwd>(p, stream);
    case 8: return launch_rows<T, 8, kFwd>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The most shared memory one block of the current device may hold.
cudaError_t mask_gemm_smem_limit(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

#define MASK_GEMM_DEFINE(T, SUFFIX)                                          \
  cudaError_t mask_frontier_##SUFFIX(                                        \
      const T* front, const int32_t* indptr, const int32_t* indices,         \
      const T* data, const int32_t* dist, const T* sigma, T* nxt,            \
      int32_t* dist_out, T* sigma_out, int32_t* any_new, int64_t s, int n,   \
      int lvl, int rows, int chunk, int col_splits, cudaStream_t stream) {   \
    MaskArgs<T> p{front, indptr, indices, data,     dist, sigma,   nullptr,  \
                  nxt,   dist_out, sigma_out, any_new, s,   n,     lvl,      \
                  chunk, 0,      col_splits};                                \
    return launch<T, true>(p, rows, stream);                                 \
  }                                                                          \
  cudaError_t mask_backward_##SUFFIX(                                        \
      const T* coeff, const int32_t* indptr, const int32_t* indices,         \
      const T* data, const int32_t* dist, const T* sigma, const T* delta,    \
      T* out, int64_t s, int n, int lvl, int rows, int chunk,                \
      int col_splits, cudaStream_t stream) {                                 \
    MaskArgs<T> p{coeff, indptr,  indices, data, dist, sigma, delta,         \
                  out,   nullptr, nullptr, nullptr, s, n,   lvl,             \
                  chunk, 0,       col_splits};                               \
    return launch<T, false>(p, rows, stream);                                \
  }

MASK_GEMM_DEFINE(float, f32)
MASK_GEMM_DEFINE(double, f64)
