// Fused mixed-precision Adam update for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_adam.py::fused_adam
// (call :76, body _adam_kernel :23-44). One pass per element:
//   m' = b1 m + (1 - b1) g;  v' = b2 v + (1 - b2) g^2
//   upd = (m' / bc1) / (sqrt(v' / bc2) + eps) + wd * master
//   master' = master - lr * upd;  p = cast(master')
// g is read as bf16 or fp32 and widened to fp32; p is written, never read.
// The scalars [lr, b1, b2, eps, wd, bc1, bc2, 0] are read from an (8,) fp32
// device tensor, so no host value is baked into a launch and a changing
// learning rate needs no new launch configuration.
//
// What bounds it on the card: bytes. Per element it reads g, master, m, v
// and writes p, master, m, v: 28 bytes with a bf16 g and bf16 p, about 12
// flops, far below the card's flop-per-byte balance. Every pointer is device
// memory: a leaf whose states (or weights) lie in pinned host memory reaches
// the kernel segment by segment through device staging buffers, copied in
// and out by the copy engines on side streams (kernels/fused_adam.py), so
// the kernel never reads across the host link itself; the link's bound (12
// bytes each way per element) applies to those copies.
//
// Design: a grid-stride loop over groups of 4 elements, with 16-byte vector
// loads and stores of the fp32 states (8-byte ones of bf16 g and p); the
// wrapper keeps every pointer 16-byte aligned (segments start on multiples
// of 8 elements).
// The tail past the last whole group runs element by element. Updates are in
// place: the output pointers are the input pointers. One launch per leaf, or
// per segment of a staged leaf; a single launch over all leaves is later
// work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Scalars {
  float lr, b1, b2, eps, wd, bc1, bc2;
};

__device__ __forceinline__ Scalars read_scalars(const float* s) {
  return Scalars{s[0], s[1], s[2], s[3], s[4], s[5], s[6]};
}

// the arithmetic of fused_adam_ref / _adam_kernel, one element
__device__ __forceinline__ float adam_elem(float g, float& master, float& m, float& v,
                                           const Scalars& c) {
  const float m_new = c.b1 * m + (1.f - c.b1) * g;
  const float v_new = c.b2 * v + (1.f - c.b2) * g * g;
  float upd = (m_new / c.bc1) / (sqrtf(v_new / c.bc2) + c.eps);
  upd = upd + c.wd * master;
  master = master - c.lr * upd;
  m = m_new;
  v = v_new;
  return master;
}

template <typename G>
__device__ __forceinline__ float4 load4(const G* g, long long i);
template <>
__device__ __forceinline__ float4 load4<float>(const float* g, long long i) {
  return *reinterpret_cast<const float4*>(g + i);
}
template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(const __nv_bfloat16* g, long long i) {
  const uint2 raw = *reinterpret_cast<const uint2*>(g + i);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename P>
__device__ __forceinline__ void store4(P* p, long long i, float4 x);
template <>
__device__ __forceinline__ void store4<float>(float* p, long long i, float4 x) {
  *reinterpret_cast<float4*>(p + i) = x;
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p, long long i, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&lo);
  raw.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p + i) = raw;
}

template <typename P, typename G>
__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(P* __restrict__ p, const G* __restrict__ g, float* __restrict__ master,
                  float* __restrict__ m, float* __restrict__ v,
                  const float* __restrict__ scalars, long long n) {
  const Scalars c = read_scalars(scalars);
  const long long n4 = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; j < n4;
       j += stride) {
    const long long i = 4 * j;
    const float4 gv = load4<G>(g, i);
    float4 ma = *reinterpret_cast<const float4*>(master + i);
    float4 mv = *reinterpret_cast<const float4*>(m + i);
    float4 vv = *reinterpret_cast<const float4*>(v + i);
    float4 out;
    out.x = adam_elem(gv.x, ma.x, mv.x, vv.x, c);
    out.y = adam_elem(gv.y, ma.y, mv.y, vv.y, c);
    out.z = adam_elem(gv.z, ma.z, mv.z, vv.z, c);
    out.w = adam_elem(gv.w, ma.w, mv.w, vv.w, c);
    *reinterpret_cast<float4*>(master + i) = ma;
    *reinterpret_cast<float4*>(m + i) = mv;
    *reinterpret_cast<float4*>(v + i) = vv;
    store4<P>(p, i, out);
  }
  // the tail: at most 3 elements, one thread each
  const long long t = 4 * n4 + static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t < n) {
    const float ma = adam_elem(repro::to_f32(g[t]), master[t], m[t], v[t], c);
    p[t] = repro::from_f32<P>(ma);
  }
}

template <typename P, typename G>
int launch(void* p, const void* g, void* master, void* m, void* v, const void* scalars,
           long long n, cudaStream_t st) {
  const long long groups = (n + 3) / 4;
  const long long want = (groups + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < 132 * 16 ? want : 132 * 16);
  fused_adam_kernel<P, G><<<blocks, kThreads, 0, st>>>(
      static_cast<P*>(p), static_cast<const G*>(g), static_cast<float*>(master),
      static_cast<float*>(m), static_cast<float*>(v), static_cast<const float*>(scalars), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// In-place update of n elements. p_dtype / g_dtype: repro::kFloat32 or
// kBFloat16; master, m, v fp32; scalars (8,) fp32 on the device.
extern "C" int repro_fused_adam(void* p, const void* g, void* master, void* m, void* v,
                                const void* scalars, long long n, int p_dtype, int g_dtype,
                                void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (p_dtype == repro::kBFloat16 && g_dtype == repro::kBFloat16)
    return launch<bf16, bf16>(p, g, master, m, v, scalars, n, st);
  if (p_dtype == repro::kBFloat16 && g_dtype == repro::kFloat32)
    return launch<bf16, float>(p, g, master, m, v, scalars, n, st);
  if (p_dtype == repro::kFloat32 && g_dtype == repro::kBFloat16)
    return launch<float, bf16>(p, g, master, m, v, scalars, n, st);
  if (p_dtype == repro::kFloat32 && g_dtype == repro::kFloat32)
    return launch<float, float>(p, g, master, m, v, scalars, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
