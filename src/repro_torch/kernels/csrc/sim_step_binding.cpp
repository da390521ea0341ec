// PyTorch binding of the port's kernels: the simulator-step kernels in
// sim_step.cu and the mask+GEMM kernels in mask_gemm.cu.
//
// The only file of the extension that includes PyTorch's headers, and
// only the few it needs (the tensor, the pybind11 tensor caster and the
// CUDA stream/guard/launch-check helpers): the catch-all
// <torch/extension.h> would multiply the first build's time.  The
// Python wrappers (repro_torch/kernels/sim_step.py, mask_gemm.py) check
// shapes, dtypes
// and contiguity and allocate every output; this file re-checks what a
// wrong pointer would turn into a fault, launches on PyTorch's current
// stream and checks the launch.

#include <ATen/core/Tensor.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime.h>

#include <torch/csrc/utils/pybind.h>

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
      int lvl, cudaStream_t stream);                                        \
  cudaError_t mask_backward_##SUFFIX(                                       \
      const T* coeff, const int32_t* indptr, const int32_t* indices,        \
      const T* data, const int32_t* dist, const T* sigma, const T* delta,   \
      T* out, int64_t s, int n, int lvl, cudaStream_t stream);

MASK_GEMM_DECLARE(float, f32)
MASK_GEMM_DECLARE(double, f64)

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

void mask_frontier(const at::Tensor& front, const at::Tensor& indptr,
                   const at::Tensor& indices, const at::Tensor& data,
                   const at::Tensor& dist, const at::Tensor& sigma,
                   int64_t lvl, at::Tensor& nxt, at::Tensor& dist_out,
                   at::Tensor& sigma_out, at::Tensor& any_new) {
  check_level(front, indptr, indices, data, dist);
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
        static_cast<int>(n), static_cast<int>(lvl), stream);
  } else {
    err = mask_frontier_f64(
        front.data_ptr<double>(), indptr.data_ptr<int32_t>(),
        indices.data_ptr<int32_t>(), data.data_ptr<double>(),
        dist.data_ptr<int32_t>(), sigma.data_ptr<double>(),
        nxt.data_ptr<double>(), dist_out.data_ptr<int32_t>(),
        sigma_out.data_ptr<double>(), any_new.data_ptr<int32_t>(), s,
        static_cast<int>(n), static_cast<int>(lvl), stream);
  }
  TORCH_CHECK(err == cudaSuccess, "frontier_step launch failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void mask_backward(const at::Tensor& coeff, const at::Tensor& indptr,
                   const at::Tensor& indices, const at::Tensor& data,
                   const at::Tensor& dist, const at::Tensor& sigma,
                   const at::Tensor& delta, int64_t lvl, at::Tensor& out) {
  check_level(coeff, indptr, indices, data, dist);
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
        static_cast<int>(n), static_cast<int>(lvl), stream);
  } else {
    err = mask_backward_f64(
        coeff.data_ptr<double>(), indptr.data_ptr<int32_t>(),
        indices.data_ptr<int32_t>(), data.data_ptr<double>(),
        dist.data_ptr<int32_t>(), sigma.data_ptr<double>(),
        delta.data_ptr<double>(), out.data_ptr<double>(), s,
        static_cast<int>(n), static_cast<int>(lvl), stream);
  }
  TORCH_CHECK(err == cudaSuccess, "backward_step launch failed: ",
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
}
