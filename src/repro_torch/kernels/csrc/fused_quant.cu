// Fused int8 absmax quantize + error-feedback residual for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_quant.py::
// fused_quantize_ef (call :70, body _kernel :36-48). For each of z chunks
// (rows) of n values:
//   scale = max(max |x|, 1e-30) / 127
//   q     = int8(clip(rint(x / scale), -127, 127))
// and for chunk ``me`` only, the residual err = x - f32(q) * scale.
// x is fp32 or bf16 (bf16 is widened on load, which is exact, so the
// caller needs no fp32 copy of a bf16 activation).
//
// Bitwise equal to the plain version (kernels/ref.py::fused_quantize_ef_ref):
//   * the absmax is an exact reduction, so its order does not matter;
//   * x / scale and the scale itself are IEEE divisions (nvcc's default
//     -prec-div=true; this build never uses --use_fast_math);
//   * rintf rounds half to even, as torch.round and jnp.round do;
//   * the residual rounds the product, then the difference
//     (__fmul_rn / __fsub_rn): nvcc would otherwise contract it into an FMA.
//
// What bounds it on the card: bytes. Per element it reads x (2 or 4 bytes)
// and writes q (1 byte), plus 4 bytes of residual in chunk ``me``; a few
// operations per element, far below the card's flop-per-byte balance.
//
// Design. Rows of up to kRowMax values (the activation shape: one row per
// token, n = d_model = 4096) run one block per row: the row is read once
// into registers, reduced to its absmax across the block, then quantized
// from the registers. Longer rows (the gradient wire: z = 4 chunks of ~1.5e7
// values) run in two passes over segments of kSeg values: pass one writes
// each segment's absmax to a scratch array, pass two has every block reduce
// its row's partials (the same exact maximum in every block), then quantize
// its segment. Loads are 16-byte vectors when n is a multiple of 4 and
// scalar otherwise (the wrapper checks the 16-byte alignment of x and q).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 32;  // values a thread holds in the one-pass kernel
constexpr long long kRowMax = static_cast<long long>(kThreads) * kItems;  // 8192
constexpr long long kSeg = static_cast<long long>(kThreads) * 64;  // values per segment

template <typename T, int VEC>
struct Vec;
template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
};
template <>
struct Vec<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
};
template <typename T>
struct Vec<T, 1> {
  static __device__ __forceinline__ void load(const T* p, float* v) { v[0] = repro::to_f32(*p); }
};

__device__ __forceinline__ signed char quantize(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));
  return static_cast<signed char>(fminf(fmaxf(r, -127.f), 127.f));
}

template <int VEC>
__device__ __forceinline__ void store_q(signed char* q, const signed char* v) {
  if constexpr (VEC == 4) {
    char4 c;
    c.x = v[0]; c.y = v[1]; c.z = v[2]; c.w = v[3];
    *reinterpret_cast<char4*>(q) = c;
  } else {
    *q = v[0];
  }
}

// Quantize VEC values at offset i of a row, writing q and, in the owned
// row, the residual.
template <int VEC>
__device__ __forceinline__ void emit(const float* v, float scale, signed char* qrow, float* err,
                                     long long i) {
  signed char qv[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) qv[j] = quantize(v[j], scale);
  store_q<VEC>(qrow + i, qv);
  if (err != nullptr) {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      err[i + j] = __fsub_rn(v[j], __fmul_rn(static_cast<float>(qv[j]), scale));
  }
}

__device__ __forceinline__ float scale_of(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-30f), 127.f);
}

// One block per row, n <= kRowMax: the row is read once, into registers.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
quant_rows_kernel(const T* __restrict__ x, signed char* __restrict__ q, float* __restrict__ scales,
                  float* __restrict__ err, long long n, long long me) {
  __shared__ float scratch[kWarps];
  const long long row = blockIdx.x;
  const T* xr = x + row * n;
  float v[kItems];
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < kItems / VEC; ++k) {
    const long long i = (static_cast<long long>(k) * kThreads + threadIdx.x) * VEC;
    if (i < n) {
      Vec<T, VEC>::load(xr + i, v + k * VEC);
#pragma unroll
      for (int j = 0; j < VEC; ++j) amax = fmaxf(amax, fabsf(v[k * VEC + j]));
    }
  }
  amax = repro::block_max<kWarps>(amax, scratch);
  const float scale = scale_of(amax);
  float* e = row == me ? err : nullptr;
#pragma unroll
  for (int k = 0; k < kItems / VEC; ++k) {
    const long long i = (static_cast<long long>(k) * kThreads + threadIdx.x) * VEC;
    if (i < n) emit<VEC>(v + k * VEC, scale, q + row * n, e, i);
  }
  if (threadIdx.x == 0) scales[row] = scale;
}

// Pass one of long rows: the absmax of segment (row, seg) into partial.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
segment_absmax_kernel(const T* __restrict__ x, float* __restrict__ partial, long long n,
                      long long nseg) {
  __shared__ float scratch[kWarps];
  const long long row = blockIdx.x / nseg, seg = blockIdx.x % nseg;
  const T* xr = x + row * n;
  const long long end = min(n, (seg + 1) * kSeg);
  float amax = 0.f;
  for (long long i = seg * kSeg + threadIdx.x * VEC; i < end; i += kThreads * VEC) {
    float v[VEC];
    Vec<T, VEC>::load(xr + i, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) amax = fmaxf(amax, fabsf(v[j]));
  }
  amax = repro::block_max<kWarps>(amax, scratch);
  if (threadIdx.x == 0) partial[blockIdx.x] = amax;
}

// Pass two: every block reduces its row's nseg partials, then quantizes its
// segment; the row's first block writes the scale.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
segment_quant_kernel(const T* __restrict__ x, const float* __restrict__ partial,
                     signed char* __restrict__ q, float* __restrict__ scales,
                     float* __restrict__ err, long long n, long long nseg, long long me) {
  __shared__ float scratch[kWarps];
  const long long row = blockIdx.x / nseg, seg = blockIdx.x % nseg;
  float amax = 0.f;
  for (long long s = threadIdx.x; s < nseg; s += kThreads) amax = fmaxf(amax, partial[row * nseg + s]);
  amax = repro::block_max<kWarps>(amax, scratch);
  const float scale = scale_of(amax);
  const T* xr = x + row * n;
  float* e = row == me ? err : nullptr;
  const long long end = min(n, (seg + 1) * kSeg);
  for (long long i = seg * kSeg + threadIdx.x * VEC; i < end; i += kThreads * VEC) {
    float v[VEC];
    Vec<T, VEC>::load(xr + i, v);
    emit<VEC>(v, scale, q + row * n, e, i);
  }
  if (seg == 0 && threadIdx.x == 0) scales[row] = scale;
}

template <typename T, int VEC>
int launch(const void* x, void* q, void* scales, void* err, void* partial, long long z,
           long long n, long long me, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  signed char* qt = static_cast<signed char*>(q);
  float* st_scales = static_cast<float*>(scales);
  float* et = static_cast<float*>(err);
  if (n <= kRowMax) {
    quant_rows_kernel<T, VEC><<<static_cast<unsigned>(z), kThreads, 0, st>>>(
        xt, qt, st_scales, et, n, me);
    return static_cast<int>(cudaGetLastError());
  }
  const long long nseg = (n + kSeg - 1) / kSeg;
  const unsigned blocks = static_cast<unsigned>(z * nseg);
  float* pt = static_cast<float*>(partial);
  segment_absmax_kernel<T, VEC><<<blocks, kThreads, 0, st>>>(xt, pt, n, nseg);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  segment_quant_kernel<T, VEC><<<blocks, kThreads, 0, st>>>(xt, pt, qt, st_scales, et, n, nseg,
                                                            me);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch floats the wrapper allocates for ``partial``: 0 for rows that run
// in one pass, else z * ceil(n / kSeg).
extern "C" long long repro_fused_quant_scratch(long long z, long long n) {
  return n <= kRowMax ? 0 : z * ((n + kSeg - 1) / kSeg);
}

// x: (z, n) fp32 or bf16 (x_dtype: repro::kFloat32 / kBFloat16), contiguous;
// q: (z, n) int8; scales: (z,) fp32; err: (n,) fp32, written for row ``me``
// (0 <= me < z); partial: repro_fused_quant_scratch(z, n) floats.
extern "C" int repro_fused_quantize_ef(const void* x, int x_dtype, void* q, void* scales,
                                       void* err, void* partial, long long z, long long n,
                                       long long me, void* stream) {
  if (z <= 0 || n <= 0 || me < 0 || me >= z) return static_cast<int>(cudaErrorInvalidValue);
  if (n > kRowMax && z * ((n + kSeg - 1) / kSeg) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (z > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0;
  using bf16 = __nv_bfloat16;
  if (x_dtype == repro::kFloat32)
    return vec ? launch<float, 4>(x, q, scales, err, partial, z, n, me, st)
               : launch<float, 1>(x, q, scales, err, partial, z, n, me, st);
  if (x_dtype == repro::kBFloat16)
    return vec ? launch<bf16, 4>(x, q, scales, err, partial, z, n, me, st)
               : launch<bf16, 1>(x, q, scales, err, partial, z, n, me, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
