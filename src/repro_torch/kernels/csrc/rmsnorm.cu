// RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm
// (body _rmsnorm_kernel, :15-18): per row, the fp32 mean of squares, then
// (x * rsqrt(ms + eps)) rounded to x's dtype, then * scale rounded again --
// the Pallas rounding order, which kernels/ref.py::rmsnorm_ref repeats.
//
// What bounds it on the card: bytes. It reads x and scale once and writes
// the output once, two flops per element; at the decode shape (a handful of
// rows of D = 4096) a launch moves tens of KB, so the launch itself, not
// HBM, is what a call costs. Design: one block per row, the row reduced in
// registers and warp shuffles, a second pass re-reads the row from L1/L2;
// no shared-memory staging, no second kernel. Vector loads and several rows
// per block are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ out, int d, float eps) {
  __shared__ float scratch[kWarps];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = repro::to_f32(xr[i]);
    ss += v * v;
  }
  ss = repro::block_sum<kWarps>(ss, scratch);
  const float rs = rsqrtf(ss / static_cast<float>(d) + eps);

  for (int i = threadIdx.x; i < d; i += kThreads) {
    const T normed = repro::from_f32<T>(repro::to_f32(xr[i]) * rs);
    orow[i] = repro::from_f32<T>(repro::to_f32(normed) * repro::to_f32(scale[i]));
  }
}

}  // namespace

extern "C" int repro_rmsnorm(const void* x, const void* scale, void* out,
                             long long rows, int d, float eps, int dtype,
                             void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(rows));
  if (dtype == repro::kFloat32) {
    rmsnorm_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<float*>(out), d, eps);
  } else if (dtype == repro::kBFloat16) {
    rmsnorm_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(scale),
        static_cast<__nv_bfloat16*>(out), d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
