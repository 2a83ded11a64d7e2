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
//   * x / scale and the scale itself are IEEE divisions (__fdiv_rn; this
//     build never uses --use_fast_math, and never multiplies by a
//     reciprocal);
//   * rintf rounds half to even, as torch.round and jnp.round do;
//   * the residual rounds the product, then the difference
//     (__fmul_rn / __fsub_rn): nvcc would otherwise contract it into an FMA.
//
// What bounds it on the card: bytes, with the arithmetic close behind. Per
// element it reads x (2 or 4 bytes) and writes q (1 byte), plus 4 bytes of
// residual in chunk ``me``. At these rates the arithmetic is not free: the
// IEEE division alone (a MUFU reciprocal and about ten other instructions
// an element) is what a copy that multiplies by the reciprocal saves
// (scripts/quant_chip.py --division-variant; PERF.md). So the kernel keeps
// its other instructions few: q's bytes come out of an add
// (int8_in_low_byte), not a float-to-int conversion.
//
// Design. The host (kernels/fused_quant.py::quant_plan) picks the path and
// the shape of a launch; this file checks the plan and launches it.
//
// One pass (rows up to 1024 threads of 6 loads: every model width the
// configs hold, d 768 to 18432, in bf16 and fp32): a group of
// threads_per_row threads (a power of two, one warp to 1024) holds a row in
// registers. Each thread issues all of its loads (1, 2, 4 or 6 loads of
// ``vec`` values: 16 bytes for fp32 and for bf16 rows with n % 8 == 0, 8
// bytes for bf16 with n % 8 == 4, one value for other n) before it
// reduces. A row of one warp reduces its absmax by shuffles alone, with no
// barrier and no shared memory, and rows of under 256 threads share a
// block of 256 (d 768 bf16: 8 rows of a warp, 3 loads a lane); a wider row
// adds one exchange across its warps through shared memory. Then each
// thread quantizes from its registers and stores q ``vec`` bytes at a time
// (8 for a 16-byte bf16 load), the residual 16 bytes at a time: x is read
// once. Rows take at most 512 threads where 6 loads a thread hold them
// (d 18432 bf16), so that two blocks share an SM and one block's loads
// overlap the other's arithmetic.
//
// Two passes (longer rows: the gradient wire, z = 4 chunks of ~1.5e7
// values, 59 MB each, more than the 50 MB L2): pass one writes the absmax
// of each segment of kSeg values to a scratch array; pass two has every
// block load its segment, reduce its row's partials (the same exact maximum
// in every block), then quantize. Pass two walks the segments in reverse
// block order, so that it starts on the segments pass one read last, the
// likeliest to be still in L2. x is read twice.
//
// Every launch uses programmatic dependent launch (common.cuh): it may be
// scheduled while the previous kernel on the stream drains.
#include "common.cuh"

namespace {

constexpr int kMaxRowThreads = 1024;
constexpr int kSegThreads = 256;
constexpr long long kSeg = 16384;  // values per segment of a two-pass row

// ``E`` values of x as one load (``Raw``), widened to fp32.
template <typename T, int E>
struct Pack;
template <>
struct Pack<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ void widen(const Raw& r, float* v) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Pack<__nv_bfloat16, 4> {
  using Raw = uint2;
  static __device__ __forceinline__ void widen(const Raw& r, float* v) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
};
template <>
struct Pack<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ void widen(const Raw& r, float* v) {
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
};
template <typename T>
struct Pack<T, 1> {
  using Raw = T;
  static __device__ __forceinline__ void widen(const Raw& r, float* v) { v[0] = repro::to_f32(r); }
};

__device__ __forceinline__ float scale_of(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-30f), 127.f);
}

// x / scale rounded half to even and clipped to [-127, 127], as a float.
__device__ __forceinline__ float quantize(float x, float scale) {
  return fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -127.f), 127.f);
}

// An integral float r in [-127, 127] plus 1.5 * 2^23 is exact and holds r's
// two's complement in its low byte: one add where a float-to-int conversion
// would take the conversion unit, which the division's reciprocal and rintf
// already load.
__device__ __forceinline__ uint32_t int8_in_low_byte(float r) {
  return static_cast<uint32_t>(__float_as_int(__fadd_rn(r, 12582912.f)));
}

template <typename T, int E>
__device__ __forceinline__ float absmax_of(const typename Pack<T, E>::Raw& raw, float amax) {
  float v[E];
  Pack<T, E>::widen(raw, v);
#pragma unroll
  for (int j = 0; j < E; ++j) amax = fmaxf(amax, fabsf(v[j]));
  return amax;
}

// Quantize one load of E values at element offset i of a row: q (E bytes in
// one store) and, in the owned row (err non-null), the residual.
template <typename T, int E>
__device__ __forceinline__ void emit(const typename Pack<T, E>::Raw& raw, float scale,
                                     signed char* qrow, float* err, long long i) {
  float v[E], r[E];
  Pack<T, E>::widen(raw, v);
#pragma unroll
  for (int j = 0; j < E; ++j) r[j] = quantize(v[j], scale);
  if constexpr (E == 1) {
    qrow[i] = static_cast<signed char>(int8_in_low_byte(r[0]) & 0xff);
  } else {
    uint32_t w[E / 4];
#pragma unroll
    for (int k = 0; k < E / 4; ++k)
      w[k] = __byte_perm(__byte_perm(int8_in_low_byte(r[4 * k]), int8_in_low_byte(r[4 * k + 1]),
                                     0x0040),
                         __byte_perm(int8_in_low_byte(r[4 * k + 2]),
                                     int8_in_low_byte(r[4 * k + 3]), 0x0040),
                         0x5410);
    if constexpr (E == 8)
      *reinterpret_cast<uint2*>(qrow + i) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<uint32_t*>(qrow + i) = w[0];
  }
  if (err != nullptr) {
    float e[E];
#pragma unroll
    for (int j = 0; j < E; ++j)  // + 0: f32(int8) of a -0.0 quotient is +0.0 (x = -0.0 keeps -0.0)
      e[j] = __fsub_rn(v[j], __fmul_rn(__fadd_rn(r[j], 0.f), scale));
    if constexpr (E == 1) {
      err[i] = e[0];
    } else {
#pragma unroll
      for (int k = 0; k < E / 4; ++k)
        reinterpret_cast<float4*>(err + i)[k] = make_float4(e[4 * k], e[4 * k + 1], e[4 * k + 2],
                                                            e[4 * k + 3]);
    }
  }
}

// One pass: row r is held by threads_per_row (tpr) consecutive threads,
// each with up to V loads in registers (load k of lane l is the row's
// vector k * tpr + l). tpr >= 32, so each warp serves one row.
template <typename T, int E, int V>
__global__ void __launch_bounds__(kMaxRowThreads)
quant_rows_kernel(const T* __restrict__ x, signed char* __restrict__ q,
                  float* __restrict__ scales, float* __restrict__ err, long long z,
                  long long n, long long me, int tpr) {
  using Raw = typename Pack<T, E>::Raw;
  __shared__ float partial[kMaxRowThreads / 32];
  const int lane = threadIdx.x & (tpr - 1);
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool live = row < z;  // the same in every lane of a warp
  const long long nv = n / E;
  Raw raw[V];
  float amax = 0.f;
  repro::wait_for_previous_grid();
  if (live) {
    const Raw* xr = reinterpret_cast<const Raw*>(x + row * n);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const long long i = static_cast<long long>(k) * tpr + lane;
      if (i < nv) raw[k] = xr[i];
    }
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (static_cast<long long>(k) * tpr + lane < nv) amax = absmax_of<T, E>(raw[k], amax);
  }
  amax = repro::warp_max(amax);
  if (tpr > 32) {  // the row's warps exchange their maxima
    if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = amax;
    __syncthreads();
    const int first = threadIdx.x / tpr * (tpr >> 5);
    amax = partial[first];
    for (int w = 1; w < (tpr >> 5); ++w) amax = fmaxf(amax, partial[first + w]);
  }
  if (!live) return;
  const float scale = scale_of(amax);
  signed char* qr = q + row * n;
  float* e = row == me ? err : nullptr;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const long long i = static_cast<long long>(k) * tpr + lane;
    if (i < nv) emit<T, E>(raw[k], scale, qr, e, i * E);
  }
  if (lane == 0) scales[row] = scale;
}

// Two passes, each block one segment (row b / nseg, segment b % nseg):
// every thread loads its kSeg / (kSegThreads * E) vectors of the segment.
template <typename T, int E>
struct Segment {
  using Raw = typename Pack<T, E>::Raw;
  static constexpr int kLoads = static_cast<int>(kSeg / (kSegThreads * E));
  Raw raw[kLoads];
  long long start;

  __device__ __forceinline__ void load(const T* xr, long long seg, long long n) {
    start = seg * kSeg;
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const long long i = start + (static_cast<long long>(k) * kSegThreads + threadIdx.x) * E;
      if (i < n) raw[k] = *reinterpret_cast<const Raw*>(xr + i);
    }
  }
  __device__ __forceinline__ bool has(int k, long long n) const {
    return start + (static_cast<long long>(k) * kSegThreads + threadIdx.x) * E < n;
  }
};

template <typename T, int E>
__global__ void __launch_bounds__(kSegThreads)
segment_absmax_kernel(const T* __restrict__ x, float* __restrict__ partial, long long n,
                      long long nseg) {
  __shared__ float scratch[kSegThreads / 32];
  const long long row = blockIdx.x / nseg, seg = blockIdx.x % nseg;
  Segment<T, E> s;
  repro::wait_for_previous_grid();
  s.load(x + row * n, seg, n);
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < Segment<T, E>::kLoads; ++k)
    if (s.has(k, n)) amax = absmax_of<T, E>(s.raw[k], amax);
  amax = repro::block_max<kSegThreads / 32>(amax, scratch);
  if (threadIdx.x == 0) partial[blockIdx.x] = amax;
}

template <typename T, int E>
__global__ void __launch_bounds__(kSegThreads)
segment_quant_kernel(const T* __restrict__ x, const float* __restrict__ partial,
                     signed char* __restrict__ q, float* __restrict__ scales,
                     float* __restrict__ err, long long n, long long nseg, long long me) {
  __shared__ float scratch[kSegThreads / 32];
  const long long b = gridDim.x - 1 - static_cast<long long>(blockIdx.x);
  const long long row = b / nseg, seg = b % nseg;
  Segment<T, E> s;
  repro::wait_for_previous_grid();
  s.load(x + row * n, seg, n);  // in flight while the partials are reduced
  float amax = 0.f;
  for (long long i = threadIdx.x; i < nseg; i += kSegThreads)
    amax = fmaxf(amax, partial[row * nseg + i]);
  amax = repro::block_max<kSegThreads / 32>(amax, scratch);
  const float scale = scale_of(amax);
  signed char* qr = q + row * n;
  float* e = row == me ? err : nullptr;
#pragma unroll
  for (int k = 0; k < Segment<T, E>::kLoads; ++k)
    if (s.has(k, n))
      emit<T, E>(s.raw[k], scale, qr, e,
                 s.start + (static_cast<long long>(k) * kSegThreads + threadIdx.x) * E);
  if (seg == 0 && threadIdx.x == 0) scales[row] = scale;
}

// Launch paths: the plan's ``path`` (kernels/fused_quant.py PATHS).
constexpr int kPathRows = 0, kPathSegments = 1;

struct Args {
  const void* x;
  void* q;
  void* scales;
  void* err;
  void* partial;
  long long z, n, me;
  int path, tpr, rows, loads;
  cudaStream_t stream;
};

template <typename T, int E, int V>
cudaError_t rows_pass(const Args& a) {
  const unsigned blocks = static_cast<unsigned>((a.z + a.rows - 1) / a.rows);
  return repro::launch_pdl(quant_rows_kernel<T, E, V>, dim3(blocks), dim3(a.tpr * a.rows),
                           true, a.stream, a.x, a.q, a.scales, a.err, a.z, a.n, a.me, a.tpr);
}

template <typename T, int E>
cudaError_t segments_pass(const Args& a) {
  const long long nseg = (a.n + kSeg - 1) / kSeg;
  const dim3 blocks(static_cast<unsigned>(a.z * nseg));
  cudaError_t rc = repro::launch_pdl(segment_absmax_kernel<T, E>, blocks, dim3(kSegThreads),
                                     true, a.stream, a.x, a.partial, a.n, nseg);
  if (rc != cudaSuccess) return rc;
  return repro::launch_pdl(segment_quant_kernel<T, E>, blocks, dim3(kSegThreads), true,
                           a.stream, a.x, a.partial, a.q, a.scales, a.err, a.n, nseg, a.me);
}

template <typename T, int E>
cudaError_t launch(const Args& a) {
  if (a.path == kPathSegments) return segments_pass<T, E>(a);
  switch (a.loads) {
    case 1: return rows_pass<T, E, 1>(a);
    case 2: return rows_pass<T, E, 2>(a);
    case 4: return rows_pass<T, E, 4>(a);
    case 6: return rows_pass<T, E, 6>(a);
    default: return cudaErrorInvalidValue;
  }
}

bool is_pow2(long long v) { return v > 0 && (v & (v - 1)) == 0; }

// The host's plan, checked: what the kernels assume of it.
bool valid(const Args& a, int x_dtype, int vec, long long segment) {
  if (a.z <= 0 || a.n <= 0 || a.me < 0 || a.me >= a.z) return false;
  if (x_dtype == repro::kFloat32 ? vec != 4 && vec != 1 : vec != 8 && vec != 4 && vec != 1)
    return false;
  if (a.n % vec != 0) return false;
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  if (addr(a.x) % 16 || addr(a.q) % 8 || addr(a.err) % 16) return false;
  if (a.path == kPathSegments)
    return segment == kSeg && a.partial != nullptr &&
           a.z * ((a.n + kSeg - 1) / kSeg) <= 0x7fffffffLL;
  return a.path == kPathRows && is_pow2(a.tpr) && a.tpr >= 32 && a.rows >= 1 &&
         static_cast<long long>(a.tpr) * a.rows <= kMaxRowThreads &&
         static_cast<long long>(a.loads) * a.tpr >= a.n / vec &&
         (a.z + a.rows - 1) / a.rows <= 0x7fffffffLL;
}

}  // namespace

// x: (z, n) fp32 or bf16 (x_dtype: repro::kFloat32 / kBFloat16), contiguous,
// 16-byte aligned; q: (z, n) int8; scales: (z,) fp32; err: (n,) fp32,
// written for row ``me`` (0 <= me < z). The plan (kernels/fused_quant.py::
// quant_plan): ``vec`` values a load (n % vec == 0); ``path`` rows (0):
// threads_per_row threads a row, ``rows`` rows a block, loads_per_thread
// loads a thread; or segments (1): segments of ``segment`` values (kSeg),
// with ``partial`` holding z * ceil(n / segment) floats.
extern "C" int repro_fused_quantize_ef(const void* x, int x_dtype, void* q, void* scales,
                                       void* err, void* partial, long long z, long long n,
                                       long long me, int vec, int path, int threads_per_row,
                                       int rows, int loads_per_thread, long long segment,
                                       void* stream) {
  const Args a{x, q, scales, err, partial, z, n, me, path, threads_per_row, rows,
               loads_per_thread, static_cast<cudaStream_t>(stream)};
  if (!valid(a, x_dtype, vec, segment)) return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  cudaError_t rc;
  if (x_dtype == repro::kFloat32)
    rc = vec == 4 ? launch<float, 4>(a) : launch<float, 1>(a);
  else if (x_dtype == repro::kBFloat16)
    rc = vec == 8 ? launch<bf16, 8>(a) : vec == 4 ? launch<bf16, 4>(a) : launch<bf16, 1>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}
