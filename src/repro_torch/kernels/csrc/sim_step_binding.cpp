// PyTorch binding of the port's kernels: the simulator-step kernels in
// sim_step.cu, the mask+GEMM kernels in mask_gemm.cu, and the model
// kernels, each in two sources chosen here by dtype (bfloat16: tensor
// cores; float32: CUDA cores): the flash-attention forward in
// flash_attention.cu and flash_attention_fma.cu, its backward in
// flash_attention_bwd.cu and flash_attention_bwd_fma.cu, the SSD chunked
// scan in ssd_scan.cu and ssd_scan_fma.cu, and its backward in
// ssd_scan_bwd.cu and ssd_scan_bwd_fma.cu.
//
// The only file of the extension that includes PyTorch's headers, and
// only the few it needs (the tensor, the pybind11 tensor caster and the
// CUDA stream/guard/launch-check helpers): the catch-all
// <torch/extension.h> would multiply the first build's time.  The
// Python wrappers (repro_torch/kernels/sim_step.py, mask_gemm.py,
// flash_attention.py, ssd_scan.py) check shapes, dtypes and contiguity
// and allocate every output; this file re-checks what a wrong pointer
// would turn into a fault, launches on PyTorch's current stream and
// checks the launch.

#include <ATen/core/Tensor.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime.h>

#include <torch/csrc/utils/pybind.h>

#include <array>
#include <cstdint>

#define SIM_STEP_DECLARE(T, SUFFIX)                                        \
  cudaError_t sim_step_update_##SUFFIX(                                    \
      const T* q, const T* split, const T* deliver, const T* fac,          \
      const T* corr, const T* inflow, const int32_t* tile_mask, T* q_out,  \
      T* partial, T* o_out, int64_t rows, int k, int w, int n_tiles,       \
      cudaStream_t stream);                                                \
  cudaError_t sim_decision_##SUFFIX(                                       \
      const T* b0, const T* split, const T* dist, const T* hval,           \
      const T* cand, const T* q_val, const int32_t* tile_mask, double thr, \
      T* out, int64_t n, int k, int c, int n_tiles, cudaStream_t stream);

SIM_STEP_DECLARE(float, f32)
SIM_STEP_DECLARE(double, f64)

#define MASK_GEMM_DECLARE(T, SUFFIX)                                        \
  cudaError_t mask_frontier_##SUFFIX(                                       \
      const T* front, const int32_t* indptr, const int32_t* indices,        \
      const T* data, const int32_t* dist, const T* sigma, T* nxt,           \
      int32_t* dist_out, T* sigma_out, int32_t* any_new, int64_t s, int n,  \
      int lvl, int rows, int chunk, int col_splits, cudaStream_t stream);   \
  cudaError_t mask_backward_##SUFFIX(                                       \
      const T* coeff, const int32_t* indptr, const int32_t* indices,        \
      const T* data, const int32_t* dist, const T* sigma, const T* delta,   \
      T* out, int64_t s, int n, int lvl, int rows, int chunk,               \
      int col_splits, cudaStream_t stream);

MASK_GEMM_DECLARE(float, f32)
MASK_GEMM_DECLARE(double, f64)
cudaError_t mask_gemm_smem_limit(int* bytes);

// bfloat16 operands: the tensor-core kernel of flash_attention.cu.
cudaError_t flash_attention_fwd(const void* q, const void* k, const void* v,
                                void* o, float* lse, int b, int hq, int hkv,
                                int sq, int skv, int d, int causal,
                                int window, int q_offset, float scale,
                                int prob_bf16, cudaStream_t stream);

// float32 operands: the CUDA-core kernel of flash_attention_fma.cu.
cudaError_t flash_attention_fwd_fma(const float* q, const float* k,
                                    const float* v, float* o, float* lse,
                                    int b, int hq, int hkv, int sq, int skv,
                                    int d, int causal, int window,
                                    int q_offset, float scale,
                                    cudaStream_t stream);

// bfloat16 operands: the tensor-core kernels of flash_attention_bwd.cu.
cudaError_t flash_attention_dq(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* dsum, void* dq, int b, int hq,
                               int hkv, int sq, int skv, int d, int causal,
                               int window, int q_offset, float scale,
                               cudaStream_t stream);

cudaError_t flash_attention_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* dsum, float* dk, float* dv,
                                int b, int hq, int hkv, int sq, int skv,
                                int d, int causal, int window, int q_offset,
                                float scale, int prob_bf16,
                                cudaStream_t stream);

// float32 operands: the CUDA-core kernels of flash_attention_bwd_fma.cu.
cudaError_t flash_attention_dq_fma(const float* q, const float* k,
                                   const float* v, const float* dout,
                                   const float* lse, const float* dsum,
                                   float* dq, int b, int hq, int hkv, int sq,
                                   int skv, int d, int causal, int window,
                                   int q_offset, float scale,
                                   cudaStream_t stream);

cudaError_t flash_attention_dkv_fma(const float* q, const float* k,
                                    const float* v, const float* dout,
                                    const float* lse, const float* dsum,
                                    float* dk, float* dv, int b, int hq,
                                    int hkv, int sq, int skv, int d,
                                    int causal, int window, int q_offset,
                                    float scale, cudaStream_t stream);

// bfloat16 operands: the tensor-core kernels of ssd_scan.cu.
cudaError_t ssd_scan_fwd(const void* x, const float* dt, const float* a_log,
                         const void* bm, const void* cm, const float* d_skip,
                         const float* state_in, void* y, float* state_out,
                         double* cum, float* states, int b, int len, int h,
                         int p, int g, int n, int q, cudaStream_t stream);

// float32 operands: the CUDA-core kernels of ssd_scan_fma.cu.
cudaError_t ssd_scan_fwd_fma(const float* x, const float* dt,
                             const float* a_log, const float* bm,
                             const float* cm, const float* d_skip,
                             const float* state_in, float* y,
                             float* state_out, double* cum, int b, int len,
                             int h, int p, int g, int n, int q,
                             cudaStream_t stream);

// The SSD scan's backward.  bfloat16 operands: the tensor-core kernels of
// ssd_scan_bwd.cu.
cudaError_t ssd_scan_backward(const void* x, const float* dt,
                              const float* a_log, const void* bm,
                              const void* cm, const float* d_skip,
                              const float* state_in, const void* dy,
                              const float* dfinal, float* dx, float* ddt,
                              float* db, float* dc, float* dstate,
                              float* parts, double* cum, float* states,
                              float* pulls, double* sdot, double* rows,
                              int b, int len, int h, int p, int g, int n,
                              int q, cudaStream_t stream);

// float32 operands: the CUDA-core kernels of ssd_scan_bwd_fma.cu.
cudaError_t ssd_scan_backward_fma(const float* x, const float* dt,
                                  const float* a_log, const float* bm,
                                  const float* cm, const float* d_skip,
                                  const float* state_in, const float* dy,
                                  const float* dfinal, float* dx, float* ddt,
                                  float* db, float* dc, float* dstate,
                                  float* parts, double* cum, float* states,
                                  float* pulls, float* sdot, double* rows,
                                  int b, int len, int h, int p, int g, int n,
                                  int q, cudaStream_t stream);

namespace {

void check_cuda(const at::Tensor& t, const char* name,
                at::ScalarType dtype) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
  TORCH_CHECK(t.scalar_type() == dtype, name, " has the wrong dtype");
}

void fused_step_update(const at::Tensor& q, const at::Tensor& split,
                       const at::Tensor& deliver, const at::Tensor& fac,
                       const at::Tensor& corr, const at::Tensor& inflow,
                       const at::Tensor& tile_mask, at::Tensor& q_out,
                       at::Tensor& partial, at::Tensor& o_out) {
  const auto dt = q.scalar_type();
  TORCH_CHECK(dt == at::kFloat || dt == at::kDouble,
              "fused_step_update takes float32 or float64");
  check_cuda(q, "q", dt);
  check_cuda(split, "split", dt);
  check_cuda(deliver, "deliver", dt);
  check_cuda(q_out, "q_out", dt);
  check_cuda(fac, "fac", dt);
  check_cuda(corr, "corr", dt);
  check_cuda(inflow, "inflow", dt);
  check_cuda(partial, "partial", dt);
  check_cuda(o_out, "o_out", dt);
  check_cuda(tile_mask, "tile_mask", at::kInt);
  const int64_t n = q.size(0), k = q.size(1), w = q.size(2);
  const int64_t n_tiles = tile_mask.numel();
  TORCH_CHECK(partial.numel() == n * k * n_tiles, "partial has wrong size");
  const c10::cuda::CUDAGuard guard(q.device());
  const cudaStream_t stream = c10::cuda::getCurrentCUDAStream().stream();
  if (n * k == 0 || w == 0) return;
  cudaError_t err;
  if (dt == at::kFloat) {
    err = sim_step_update_f32(
        q.data_ptr<float>(), split.data_ptr<float>(),
        deliver.data_ptr<float>(), fac.data_ptr<float>(),
        corr.data_ptr<float>(), inflow.data_ptr<float>(),
        tile_mask.data_ptr<int32_t>(), q_out.data_ptr<float>(),
        partial.data_ptr<float>(), o_out.data_ptr<float>(), n * k,
        static_cast<int>(k), static_cast<int>(w),
        static_cast<int>(n_tiles), stream);
  } else {
    err = sim_step_update_f64(
        q.data_ptr<double>(), split.data_ptr<double>(),
        deliver.data_ptr<double>(), fac.data_ptr<double>(),
        corr.data_ptr<double>(), inflow.data_ptr<double>(),
        tile_mask.data_ptr<int32_t>(), q_out.data_ptr<double>(),
        partial.data_ptr<double>(), o_out.data_ptr<double>(), n * k,
        static_cast<int>(k), static_cast<int>(w),
        static_cast<int>(n_tiles), stream);
  }
  TORCH_CHECK(err == cudaSuccess, "fused_step_update launch failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void fused_decision(const at::Tensor& b0, const at::Tensor& split,
                    const at::Tensor& dist, const at::Tensor& hval,
                    const at::Tensor& cand, const at::Tensor& q_val,
                    const at::Tensor& tile_mask, double thr,
                    at::Tensor& out) {
  const auto dt = split.scalar_type();
  TORCH_CHECK(dt == at::kFloat || dt == at::kDouble,
              "fused_decision takes float32 or float64");
  check_cuda(b0, "b0", dt);
  check_cuda(split, "split", dt);
  check_cuda(dist, "dist", dt);
  check_cuda(hval, "hval", dt);
  check_cuda(cand, "cand", dt);
  check_cuda(q_val, "q_val", dt);
  check_cuda(out, "out", dt);
  check_cuda(tile_mask, "tile_mask", at::kInt);
  const int64_t n = split.size(0), k = split.size(1), c = split.size(2);
  const int64_t n_tiles = tile_mask.numel();
  const c10::cuda::CUDAGuard guard(split.device());
  const cudaStream_t stream = c10::cuda::getCurrentCUDAStream().stream();
  if (n == 0 || c == 0) return;
  cudaError_t err;
  if (dt == at::kFloat) {
    err = sim_decision_f32(
        b0.data_ptr<float>(), split.data_ptr<float>(),
        dist.data_ptr<float>(), hval.data_ptr<float>(),
        cand.data_ptr<float>(), q_val.data_ptr<float>(),
        tile_mask.data_ptr<int32_t>(), thr, out.data_ptr<float>(), n,
        static_cast<int>(k), static_cast<int>(c),
        static_cast<int>(n_tiles), stream);
  } else {
    err = sim_decision_f64(
        b0.data_ptr<double>(), split.data_ptr<double>(),
        dist.data_ptr<double>(), hval.data_ptr<double>(),
        cand.data_ptr<double>(), q_val.data_ptr<double>(),
        tile_mask.data_ptr<int32_t>(), thr, out.data_ptr<double>(), n,
        static_cast<int>(k), static_cast<int>(c),
        static_cast<int>(n_tiles), stream);
  }
  TORCH_CHECK(err == cudaSuccess, "fused_decision launch failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// An (S, N) operand of a mask+GEMM call: on the card, contiguous, of
// the given dtype and of the same shape as the level state x.
void check_like(const at::Tensor& t, const char* name, const at::Tensor& x,
                at::ScalarType dtype) {
  check_cuda(t, name, dtype);
  TORCH_CHECK(t.sizes() == x.sizes(), name, " must be (S, N)");
}

// The compressed-column A and the (S, N) level state of one mask+GEMM
// call.
void check_level(const at::Tensor& x, const at::Tensor& indptr,
                 const at::Tensor& indices, const at::Tensor& data,
                 const at::Tensor& dist) {
  const auto dt = x.scalar_type();
  TORCH_CHECK(dt == at::kFloat || dt == at::kDouble,
              "the mask+GEMM kernels take float32 or float64");
  check_cuda(x, "x", dt);
  check_cuda(data, "data", dt);
  check_cuda(indptr, "indptr", at::kInt);
  check_cuda(indices, "indices", at::kInt);
  check_cuda(dist, "dist", at::kInt);
  TORCH_CHECK(x.dim() == 2 && dist.sizes() == x.sizes(),
              "x and dist must be (S, N)");
  TORCH_CHECK(indptr.numel() == x.size(1) + 1, "indptr must have N + 1 "
              "entries");
  TORCH_CHECK(indices.numel() == data.numel(), "indices and data differ "
              "in length");
}

// The wrapper's tiling of one mask+GEMM launch (kernels/mask_gemm.py::
// plan): rows per block, the contraction chunk, column splits.  The
// launcher refuses a rows value it has no instantiation for and the
// runtime a chunk whose rows exceed the block's shared memory.
void check_plan(int64_t rows, int64_t chunk, int64_t col_splits) {
  TORCH_CHECK(rows >= 1 && rows <= 8 && chunk >= 1 && chunk <= (1 << 30) &&
                  col_splits >= 1 && col_splits <= (1 << 20),
              "bad mask+GEMM plan: rows ", rows, ", chunk ", chunk,
              ", col_splits ", col_splits);
}

int64_t mask_smem_limit(int64_t device) {
  const c10::cuda::CUDAGuard guard(static_cast<c10::DeviceIndex>(device));
  int bytes = 0;
  const cudaError_t err = mask_gemm_smem_limit(&bytes);
  TORCH_CHECK(err == cudaSuccess, "shared-memory query failed: ",
              cudaGetErrorString(err));
  return bytes;
}

void mask_frontier(const at::Tensor& front, const at::Tensor& indptr,
                   const at::Tensor& indices, const at::Tensor& data,
                   const at::Tensor& dist, const at::Tensor& sigma,
                   int64_t lvl, int64_t rows, int64_t chunk,
                   int64_t col_splits, at::Tensor& nxt, at::Tensor& dist_out,
                   at::Tensor& sigma_out, at::Tensor& any_new) {
  check_level(front, indptr, indices, data, dist);
  check_plan(rows, chunk, col_splits);
  const auto dt = front.scalar_type();
  check_like(sigma, "sigma", front, dt);
  check_like(nxt, "nxt", front, dt);
  check_like(sigma_out, "sigma_out", front, dt);
  check_like(dist_out, "dist_out", front, at::kInt);
  check_cuda(any_new, "any_new", at::kInt);
  TORCH_CHECK(any_new.numel() == 1, "any_new must hold one int32");
  const int64_t s = front.size(0), n = front.size(1);
  const c10::cuda::CUDAGuard guard(front.device());
  const cudaStream_t stream = c10::cuda::getCurrentCUDAStream().stream();
  if (s == 0 || n == 0) return;
  cudaError_t err;
  if (dt == at::kFloat) {
    err = mask_frontier_f32(
        front.data_ptr<float>(), indptr.data_ptr<int32_t>(),
        indices.data_ptr<int32_t>(), data.data_ptr<float>(),
        dist.data_ptr<int32_t>(), sigma.data_ptr<float>(),
        nxt.data_ptr<float>(), dist_out.data_ptr<int32_t>(),
        sigma_out.data_ptr<float>(), any_new.data_ptr<int32_t>(), s,
        static_cast<int>(n), static_cast<int>(lvl), static_cast<int>(rows),
        static_cast<int>(chunk), static_cast<int>(col_splits), stream);
  } else {
    err = mask_frontier_f64(
        front.data_ptr<double>(), indptr.data_ptr<int32_t>(),
        indices.data_ptr<int32_t>(), data.data_ptr<double>(),
        dist.data_ptr<int32_t>(), sigma.data_ptr<double>(),
        nxt.data_ptr<double>(), dist_out.data_ptr<int32_t>(),
        sigma_out.data_ptr<double>(), any_new.data_ptr<int32_t>(), s,
        static_cast<int>(n), static_cast<int>(lvl), static_cast<int>(rows),
        static_cast<int>(chunk), static_cast<int>(col_splits), stream);
  }
  TORCH_CHECK(err == cudaSuccess, "frontier_step launch failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void mask_backward(const at::Tensor& coeff, const at::Tensor& indptr,
                   const at::Tensor& indices, const at::Tensor& data,
                   const at::Tensor& dist, const at::Tensor& sigma,
                   const at::Tensor& delta, int64_t lvl, int64_t rows,
                   int64_t chunk, int64_t col_splits, at::Tensor& out) {
  check_level(coeff, indptr, indices, data, dist);
  check_plan(rows, chunk, col_splits);
  const auto dt = coeff.scalar_type();
  check_like(sigma, "sigma", coeff, dt);
  check_like(delta, "delta", coeff, dt);
  check_like(out, "out", coeff, dt);
  const int64_t s = coeff.size(0), n = coeff.size(1);
  const c10::cuda::CUDAGuard guard(coeff.device());
  const cudaStream_t stream = c10::cuda::getCurrentCUDAStream().stream();
  if (s == 0 || n == 0) return;
  cudaError_t err;
  if (dt == at::kFloat) {
    err = mask_backward_f32(
        coeff.data_ptr<float>(), indptr.data_ptr<int32_t>(),
        indices.data_ptr<int32_t>(), data.data_ptr<float>(),
        dist.data_ptr<int32_t>(), sigma.data_ptr<float>(),
        delta.data_ptr<float>(), out.data_ptr<float>(), s,
        static_cast<int>(n), static_cast<int>(lvl), static_cast<int>(rows),
        static_cast<int>(chunk), static_cast<int>(col_splits), stream);
  } else {
    err = mask_backward_f64(
        coeff.data_ptr<double>(), indptr.data_ptr<int32_t>(),
        indices.data_ptr<int32_t>(), data.data_ptr<double>(),
        dist.data_ptr<int32_t>(), sigma.data_ptr<double>(),
        delta.data_ptr<double>(), out.data_ptr<double>(), s,
        static_cast<int>(n), static_cast<int>(lvl), static_cast<int>(rows),
        static_cast<int>(chunk), static_cast<int>(col_splits), stream);
  }
  TORCH_CHECK(err == cudaSuccess, "backward_step launch failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), o like q, lse (B, Hq, Sq)
// float32; bfloat16 or float32 operands.  prob_bf16: the bf16 kernel's
// variant for the perf flag (float32 operands have none).
void flash_fwd(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
               bool causal, int64_t window, int64_t q_offset, double scale,
               bool prob_bf16, at::Tensor& o, at::Tensor& lse) {
  const auto dt = q.scalar_type();
  TORCH_CHECK(dt == at::kFloat || dt == at::kBFloat16,
              "flash_attention takes float32 or bfloat16");
  check_cuda(q, "q", dt);
  check_cuda(k, "k", dt);
  check_cuda(v, "v", dt);
  check_cuda(o, "o", dt);
  check_cuda(lse, "lse", at::kFloat);
  TORCH_CHECK(q.dim() == 4 && k.dim() == 4 && k.sizes() == v.sizes(),
              "q, k, v must be (B, H, S, D) with k and v alike");
  TORCH_CHECK(o.sizes() == q.sizes(), "o must be shaped like q");
  const int64_t b = q.size(0), hq = q.size(1), sq = q.size(2), d = q.size(3);
  const int64_t hkv = k.size(1), skv = k.size(2);
  TORCH_CHECK(k.size(0) == b && k.size(3) == d && hq % hkv == 0,
              "k does not match q");
  TORCH_CHECK(lse.numel() == b * hq * sq, "lse must hold B * Hq * Sq");
  const c10::cuda::CUDAGuard guard(q.device());
  const cudaStream_t stream = c10::cuda::getCurrentCUDAStream().stream();
  if (b * hq * sq == 0) return;
  const int ib = static_cast<int>(b), ihq = static_cast<int>(hq),
            ihkv = static_cast<int>(hkv), isq = static_cast<int>(sq),
            iskv = static_cast<int>(skv), id = static_cast<int>(d),
            ic = causal ? 1 : 0, iw = static_cast<int>(window),
            io = static_cast<int>(q_offset);
  const float sc = static_cast<float>(scale);
  const cudaError_t err =
      dt == at::kBFloat16
          ? flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                o.data_ptr(), lse.data_ptr<float>(), ib, ihq,
                                ihkv, isq, iskv, id, ic, iw, io, sc,
                                prob_bf16 ? 1 : 0, stream)
          : flash_attention_fwd_fma(
                q.data_ptr<float>(), k.data_ptr<float>(),
                v.data_ptr<float>(), o.data_ptr<float>(),
                lse.data_ptr<float>(), ib, ihq, ihkv, isq, iskv, id, ic, iw,
                io, sc, stream);
  TORCH_CHECK(err == cudaSuccess, "flash_attention launch failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// q and dout (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), bfloat16 or
// float32; lse and dsum (B, Hq, Sq) float32.  Checks what the two
// backward kernels share and returns (b, hq, hkv, sq, skv, d).
std::array<int64_t, 6> check_bwd(const at::Tensor& q, const at::Tensor& k,
                                 const at::Tensor& v, const at::Tensor& dout,
                                 const at::Tensor& lse,
                                 const at::Tensor& dsum) {
  const auto dt = q.scalar_type();
  TORCH_CHECK(dt == at::kFloat || dt == at::kBFloat16,
              "flash_attention backward takes float32 or bfloat16");
  check_cuda(q, "q", dt);
  check_cuda(k, "k", dt);
  check_cuda(v, "v", dt);
  check_cuda(dout, "dout", dt);
  check_cuda(lse, "lse", at::kFloat);
  check_cuda(dsum, "dsum", at::kFloat);
  TORCH_CHECK(q.dim() == 4 && k.dim() == 4 && k.sizes() == v.sizes() &&
                  dout.sizes() == q.sizes(),
              "q, dout must be (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D)");
  const int64_t b = q.size(0), hq = q.size(1), sq = q.size(2), d = q.size(3);
  const int64_t hkv = k.size(1), skv = k.size(2);
  TORCH_CHECK(k.size(0) == b && k.size(3) == d && hq % hkv == 0,
              "k does not match q");
  TORCH_CHECK(lse.numel() == b * hq * sq && dsum.numel() == b * hq * sq,
              "lse and dsum must hold B * Hq * Sq");
  return {b, hq, hkv, sq, skv, d};
}

void flash_dq(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
              const at::Tensor& dout, const at::Tensor& lse,
              const at::Tensor& dsum, bool causal, int64_t window,
              int64_t q_offset, double scale, at::Tensor& dq) {
  const auto [b, hq, hkv, sq, skv, d] = check_bwd(q, k, v, dout, lse, dsum);
  check_cuda(dq, "dq", q.scalar_type());
  TORCH_CHECK(dq.sizes() == q.sizes(), "dq must be shaped like q");
  const c10::cuda::CUDAGuard guard(q.device());
  const cudaStream_t stream = c10::cuda::getCurrentCUDAStream().stream();
  if (b * hq * sq * skv == 0) return;
  const int ib = static_cast<int>(b), ihq = static_cast<int>(hq),
            ihkv = static_cast<int>(hkv), isq = static_cast<int>(sq),
            iskv = static_cast<int>(skv), id = static_cast<int>(d),
            ic = causal ? 1 : 0, iw = static_cast<int>(window),
            io = static_cast<int>(q_offset);
  const float sc = static_cast<float>(scale);
  const cudaError_t err =
      q.scalar_type() == at::kBFloat16
          ? flash_attention_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               dout.data_ptr(), lse.data_ptr<float>(),
                               dsum.data_ptr<float>(), dq.data_ptr(), ib,
                               ihq, ihkv, isq, iskv, id, ic, iw, io, sc,
                               stream)
          : flash_attention_dq_fma(
                q.data_ptr<float>(), k.data_ptr<float>(),
                v.data_ptr<float>(), dout.data_ptr<float>(),
                lse.data_ptr<float>(), dsum.data_ptr<float>(),
                dq.data_ptr<float>(), ib, ihq, ihkv, isq, iskv, id, ic, iw,
                io, sc, stream);
  TORCH_CHECK(err == cudaSuccess, "flash_attention dq launch failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// dk and dv (B, Hq, Skv, D) float32, per q head.  prob_bf16: the bf16
// kernel's variant for the perf flag (float32 operands have none).
void flash_dkv(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
               const at::Tensor& dout, const at::Tensor& lse,
               const at::Tensor& dsum, bool causal, int64_t window,
               int64_t q_offset, double scale, bool prob_bf16,
               at::Tensor& dk, at::Tensor& dv) {
  const auto [b, hq, hkv, sq, skv, d] = check_bwd(q, k, v, dout, lse, dsum);
  check_cuda(dk, "dk", at::kFloat);
  check_cuda(dv, "dv", at::kFloat);
  TORCH_CHECK(dk.numel() == b * hq * skv * d && dv.numel() == dk.numel(),
              "dk and dv must be (B, Hq, Skv, D)");
  const c10::cuda::CUDAGuard guard(q.device());
  const cudaStream_t stream = c10::cuda::getCurrentCUDAStream().stream();
  if (b * hq * sq * skv == 0) return;
  const int ib = static_cast<int>(b), ihq = static_cast<int>(hq),
            ihkv = static_cast<int>(hkv), isq = static_cast<int>(sq),
            iskv = static_cast<int>(skv), id = static_cast<int>(d),
            ic = causal ? 1 : 0, iw = static_cast<int>(window),
            io = static_cast<int>(q_offset);
  const float sc = static_cast<float>(scale);
  const cudaError_t err =
      q.scalar_type() == at::kBFloat16
          ? flash_attention_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                dout.data_ptr(), lse.data_ptr<float>(),
                                dsum.data_ptr<float>(), dk.data_ptr<float>(),
                                dv.data_ptr<float>(), ib, ihq, ihkv, isq,
                                iskv, id, ic, iw, io, sc, prob_bf16 ? 1 : 0,
                                stream)
          : flash_attention_dkv_fma(
                q.data_ptr<float>(), k.data_ptr<float>(),
                v.data_ptr<float>(), dout.data_ptr<float>(),
                lse.data_ptr<float>(), dsum.data_ptr<float>(),
                dk.data_ptr<float>(), dv.data_ptr<float>(), ib, ihq, ihkv,
                isq, iskv, id, ic, iw, io, sc, stream);
  TORCH_CHECK(err == cudaSuccess, "flash_attention dk/dv launch failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// x (B, L, H, P), b_mat and c_mat (B, L, G, N): bfloat16 or float32; y
// like x (float32: ceil(N / 256) shares of y, one per slice of 256 state
// rows, which the caller adds); dt (B, L, H), a_log and d_skip (H,),
// state_out (B, H, N, P) and state_in float32, state_in empty for a zero
// initial state.  Scratch: cum (B, H, L) float64; bfloat16 only: states
// (B, H, n_chunks, N, P) float32 (empty for float32).
void ssd_scan(const at::Tensor& x, const at::Tensor& dt,
              const at::Tensor& a_log, const at::Tensor& b_mat,
              const at::Tensor& c_mat, const at::Tensor& d_skip,
              const at::Tensor& state_in, int64_t chunk,
              at::Tensor& y, at::Tensor& state_out, at::Tensor& cum,
              at::Tensor& states) {
  const auto xt = x.scalar_type();
  TORCH_CHECK(xt == at::kFloat || xt == at::kBFloat16,
              "ssd_scan takes float32 or bfloat16 x");
  check_cuda(x, "x", xt);
  check_cuda(b_mat, "b_mat", xt);
  check_cuda(c_mat, "c_mat", xt);
  check_cuda(y, "y", xt);
  check_cuda(dt, "dt", at::kFloat);
  check_cuda(a_log, "a_log", at::kFloat);
  check_cuda(d_skip, "d_skip", at::kFloat);
  check_cuda(state_out, "state_out", at::kFloat);
  TORCH_CHECK(x.dim() == 4 && b_mat.dim() == 4 && b_mat.sizes() == c_mat.sizes(),
              "x must be (B, L, H, P) and b_mat, c_mat (B, L, G, N)");
  const int64_t b = x.size(0), len = x.size(1), h = x.size(2), p = x.size(3);
  const int64_t g = b_mat.size(2), n = b_mat.size(3);
  const bool bf = xt == at::kBFloat16;
  TORCH_CHECK(bf ? y.sizes() == x.sizes()
                 : y.numel() == (n + 255) / 256 * x.numel(),
              "y must be shaped like x (float32: a share per 256 state "
              "rows)");
  TORCH_CHECK(dt.dim() == 3 && dt.size(0) == b && dt.size(1) == len &&
                  dt.size(2) == h, "dt must be (B, L, H)");
  TORCH_CHECK(b_mat.size(0) == b && b_mat.size(1) == len && h % g == 0,
              "b_mat does not match x");
  TORCH_CHECK(a_log.numel() == h && d_skip.numel() == h,
              "a_log and d_skip must hold H values");
  TORCH_CHECK(state_out.numel() == b * h * n * p, "state_out must be "
              "(B, H, N, P)");
  const float* s_in = nullptr;
  if (state_in.numel() != 0) {
    check_cuda(state_in, "state_in", at::kFloat);
    TORCH_CHECK(state_in.numel() == b * h * n * p, "state_in must be "
                "(B, H, N, P)");
    s_in = state_in.data_ptr<float>();
  }
  TORCH_CHECK(chunk >= 1, "chunk must be >= 1");
  check_cuda(cum, "cum", at::kDouble);
  TORCH_CHECK(cum.numel() == b * h * len, "cum must be (B, H, L)");
  if (bf) {
    const int64_t n_chunks = (len + chunk - 1) / chunk;
    check_cuda(states, "states", at::kFloat);
    TORCH_CHECK(states.numel() == b * h * n_chunks * n * p,
                "states must be (B, H, n_chunks, N, P)");
  }
  const c10::cuda::CUDAGuard guard(x.device());
  const cudaStream_t stream = c10::cuda::getCurrentCUDAStream().stream();
  if (b * len * h * p == 0) return;
  const int ib = static_cast<int>(b), il = static_cast<int>(len),
            ih = static_cast<int>(h), ip = static_cast<int>(p),
            ig = static_cast<int>(g), in = static_cast<int>(n),
            iq = static_cast<int>(chunk);
  const cudaError_t err =
      bf ? ssd_scan_fwd(x.data_ptr(), dt.data_ptr<float>(),
                        a_log.data_ptr<float>(), b_mat.data_ptr(),
                        c_mat.data_ptr(), d_skip.data_ptr<float>(), s_in,
                        y.data_ptr(), state_out.data_ptr<float>(),
                        cum.data_ptr<double>(), states.data_ptr<float>(), ib,
                        il, ih, ip, ig, in, iq, stream)
         : ssd_scan_fwd_fma(x.data_ptr<float>(), dt.data_ptr<float>(),
                            a_log.data_ptr<float>(), b_mat.data_ptr<float>(),
                            c_mat.data_ptr<float>(),
                            d_skip.data_ptr<float>(), s_in,
                            y.data_ptr<float>(), state_out.data_ptr<float>(),
                            cum.data_ptr<double>(), ib, il, ih, ip, ig, in,
                            iq, stream);
  TORCH_CHECK(err == cudaSuccess, "ssd_scan launch failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// The backward of ssd_scan: x, dy (B, L, H, P), b_mat and c_mat (B, L,
// G, N) bfloat16 or float32; dt (B, L, H), a_log and d_skip (H,) float32;
// state_in and dfinal (B, H, N, P) float32, empty for zero.  Outputs,
// float32: dx like x, ddt like dt, db and dc (B, L, H, N) per head, dstate
// (B, H, N, P) (empty without state_in), parts (2, B, H, n_chunks).
// Scratch: cum (B, H, L) float64, states and pulls (B, H, n_chunks, N, P)
// float32; float32 operands: sdot (B, H, n_chunks) float32 and rows (5,
// B, H, L) float64; bfloat16: sdot (B, H, n_chunks, N P / 128) float64 (a
// partial of <S_in, dS> per 128 state entries) and rows (5 + ceil(chunk /
// 64), B, H, L) float64.
void ssd_scan_bwd(const at::Tensor& x, const at::Tensor& dt,
                  const at::Tensor& a_log, const at::Tensor& b_mat,
                  const at::Tensor& c_mat, const at::Tensor& d_skip,
                  const at::Tensor& state_in, const at::Tensor& dy,
                  const at::Tensor& dfinal, int64_t chunk, at::Tensor& dx,
                  at::Tensor& ddt, at::Tensor& db, at::Tensor& dc,
                  at::Tensor& dstate, at::Tensor& parts, at::Tensor& cum,
                  at::Tensor& states, at::Tensor& pulls, at::Tensor& sdot,
                  at::Tensor& rows) {
  const auto xt = x.scalar_type();
  TORCH_CHECK(xt == at::kFloat || xt == at::kBFloat16,
              "ssd_scan_bwd takes float32 or bfloat16 x");
  const bool bf = xt == at::kBFloat16;
  check_cuda(x, "x", xt);
  check_cuda(dy, "dy", xt);
  check_cuda(b_mat, "b_mat", xt);
  check_cuda(c_mat, "c_mat", xt);
  check_cuda(dt, "dt", at::kFloat);
  check_cuda(a_log, "a_log", at::kFloat);
  check_cuda(d_skip, "d_skip", at::kFloat);
  for (const at::Tensor* t : {&dx, &ddt, &db, &dc, &parts, &states, &pulls})
    check_cuda(*t, "an output or scratch", at::kFloat);
  check_cuda(sdot, "sdot", bf ? at::kDouble : at::kFloat);
  check_cuda(cum, "cum", at::kDouble);
  check_cuda(rows, "rows", at::kDouble);
  TORCH_CHECK(x.dim() == 4 && b_mat.dim() == 4 &&
                  b_mat.sizes() == c_mat.sizes() && dy.sizes() == x.sizes(),
              "x and dy must be (B, L, H, P) and b_mat, c_mat (B, L, G, N)");
  const int64_t b = x.size(0), len = x.size(1), h = x.size(2), p = x.size(3);
  const int64_t g = b_mat.size(2), n = b_mat.size(3);
  TORCH_CHECK(chunk >= 1, "chunk must be >= 1");
  const int64_t nc = (len + chunk - 1) / chunk;
  TORCH_CHECK(dt.dim() == 3 && dt.size(0) == b && dt.size(1) == len &&
                  dt.size(2) == h, "dt must be (B, L, H)");
  TORCH_CHECK(b_mat.size(0) == b && b_mat.size(1) == len && h % g == 0,
              "b_mat does not match x");
  TORCH_CHECK(a_log.numel() == h && d_skip.numel() == h,
              "a_log and d_skip must hold H values");
  TORCH_CHECK(dx.numel() == b * len * h * p && ddt.numel() == b * len * h &&
                  db.numel() == b * len * h * n && dc.numel() == db.numel() &&
                  parts.numel() == 2 * b * h * nc,
              "dx, ddt, db, dc or parts has the wrong size");
  const int64_t planes = bf ? 5 + (chunk + 63) / 64 : 5;
  TORCH_CHECK(cum.numel() == b * h * len &&
                  states.numel() == b * h * nc * n * p &&
                  pulls.numel() == states.numel() &&
                  sdot.numel() == b * h * nc * (bf ? n * p / 128 : 1) &&
                  rows.numel() == planes * b * h * len,
              "the scratch has the wrong size");
  const float* s_in = nullptr;
  float* ds_out = nullptr;
  if (state_in.numel() != 0) {
    check_cuda(state_in, "state_in", at::kFloat);
    check_cuda(dstate, "dstate", at::kFloat);
    TORCH_CHECK(state_in.numel() == b * h * n * p &&
                    dstate.numel() == state_in.numel(),
                "state_in and dstate must be (B, H, N, P)");
    s_in = state_in.data_ptr<float>();
    ds_out = dstate.data_ptr<float>();
  }
  const float* df = nullptr;
  if (dfinal.numel() != 0) {
    check_cuda(dfinal, "dfinal", at::kFloat);
    TORCH_CHECK(dfinal.numel() == b * h * n * p, "dfinal must be "
                "(B, H, N, P)");
    df = dfinal.data_ptr<float>();
  }
  const c10::cuda::CUDAGuard guard(x.device());
  const cudaStream_t stream = c10::cuda::getCurrentCUDAStream().stream();
  if (b * len * h * p == 0) return;
  const int ib = static_cast<int>(b), il = static_cast<int>(len),
            ih = static_cast<int>(h), ip = static_cast<int>(p),
            ig = static_cast<int>(g), in = static_cast<int>(n),
            iq = static_cast<int>(chunk);
  const cudaError_t err =
      bf ? ssd_scan_backward(
               x.data_ptr(), dt.data_ptr<float>(), a_log.data_ptr<float>(),
               b_mat.data_ptr(), c_mat.data_ptr(), d_skip.data_ptr<float>(),
               s_in, dy.data_ptr(), df, dx.data_ptr<float>(),
               ddt.data_ptr<float>(), db.data_ptr<float>(),
               dc.data_ptr<float>(), ds_out, parts.data_ptr<float>(),
               cum.data_ptr<double>(), states.data_ptr<float>(),
               pulls.data_ptr<float>(), sdot.data_ptr<double>(),
               rows.data_ptr<double>(), ib, il, ih, ip, ig, in, iq, stream)
         : ssd_scan_backward_fma(
               x.data_ptr<float>(), dt.data_ptr<float>(),
               a_log.data_ptr<float>(), b_mat.data_ptr<float>(),
               c_mat.data_ptr<float>(), d_skip.data_ptr<float>(), s_in,
               dy.data_ptr<float>(), df, dx.data_ptr<float>(),
               ddt.data_ptr<float>(), db.data_ptr<float>(),
               dc.data_ptr<float>(), ds_out, parts.data_ptr<float>(),
               cum.data_ptr<double>(), states.data_ptr<float>(),
               pulls.data_ptr<float>(), sdot.data_ptr<float>(),
               rows.data_ptr<double>(), ib, il, ih, ip, ig, in, iq, stream);
  TORCH_CHECK(err == cudaSuccess, "ssd_scan_bwd launch failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("fused_step_update", &fused_step_update,
        "fused forward/throttle/enqueue update of one VC (CUDA)");
  m.def("fused_decision", &fused_decision,
        "per-hop UGAL divert decision (CUDA)");
  m.def("mask_frontier", &mask_frontier,
        "forward BFS level, sparse product + mask epilogue (CUDA)");
  m.def("mask_backward", &mask_backward,
        "backward dependency level, sparse product + mask epilogue (CUDA)");
  m.def("mask_smem_limit", &mask_smem_limit,
        "shared memory one block may hold on a device, in bytes");
  m.def("flash_fwd", &flash_fwd,
        "flash-attention forward with the row log-sum-exp (CUDA)");
  m.def("flash_dq", &flash_dq, "flash-attention backward, dq (CUDA)");
  m.def("flash_dkv", &flash_dkv,
        "flash-attention backward, dk and dv per q head (CUDA)");
  m.def("ssd_scan", &ssd_scan, "Mamba-2 SSD chunked scan (CUDA)");
  m.def("ssd_scan_bwd", &ssd_scan_bwd,
        "backward of the Mamba-2 SSD chunked scan (CUDA)");
}
