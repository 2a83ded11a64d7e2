// Single-query decode attention over the paged KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py::
// paged_attention (call :125, body _kernel :64-87). Same function: per
// (batch row b, kv head h), the G = Hq / Hkv query rows attend over S cache
// rows; row s is read from the hot ring at ring row s % W when sel[b, s] is
// set, else from the cold store at row s; an additive fp32 mask (0 or
// -1e30) is added; the softmax runs once over the whole row (not online),
// then probs . V in fp32, cast to the output dtype. kernels/ref.py::
// paged_attention_ref is the plain version.
//
// What bounds it on the card: bytes. Each attended cache row is read once
// for K and once for V (2 * hd * itemsize bytes per kv head) against
// 4 * G * hd flops, far below the card's flop-per-byte balance. Cold rows
// may sit in pinned host memory, read in place over the host link through
// unified addressing (no staging copy) -- the link, at a few tens of GB/s,
// then bounds the cold share.
//
// Design:
//   * one block per (b, h), 8 warps; a warp owns cache rows s = warp,
//     warp + 8, ...; each lane holds hd / 32 consecutive elements, so one
//     warp reads one K (or V) row as one contiguous burst;
//   * the G logits of a row come from G warp-shuffle reductions and land
//     in a shared (G, S) fp32 array (G * S * 4 bytes: 16 KiB at G = 4,
//     S = 1024), so the softmax sees the whole row as the reference does;
//   * rows masked at -1e30 get exactly 0 weight (their logit equals the
//     mask in fp32), so their K and V are never loaded when at least one
//     row is attendable -- which also skips host-link reads of cold rows not
//     yet written. A row with every entry masked loads everything, as the
//     reference weights every row equally there;
//   * the probs . V pass keeps G x hd/32 fp32 accumulators per lane and
//     sums the 8 warps' partials through shared memory.
// The wrapper raises when the shared arrays exceed the 227 KB a block may
// use; splitting the row over several blocks (split-KV), wgmma and TMA are
// later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

__host__ __device__ constexpr long long smem_floats(int g, int hd, int s_kv) {
  // logits (G, S) + scaled q (G, hd) + per-warp PV partials (8, G, hd) + reduce scratch
  return static_cast<long long>(g) * s_kv + static_cast<long long>(g) * hd +
         static_cast<long long>(kWarps) * g * hd + kWarps;
}

template <typename T, int G, int HPL>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q,       // (B, Hq, hd)
                       const T* __restrict__ k_hot,   // (B, W, Hkv, hd)
                       const T* __restrict__ v_hot,   // (B, W, Hkv, hd)
                       const T* __restrict__ k_cold,  // (B, S, Hkv, hd)
                       const T* __restrict__ v_cold,  // (B, S, Hkv, hd)
                       const uint8_t* __restrict__ sel,  // (B, S)
                       const float* __restrict__ mask,   // (B, S)
                       T* __restrict__ out,              // (B, Hq, hd)
                       int hkv, int s_kv, int w) {
  constexpr int HD = HPL * 32;
  extern __shared__ float smem[];
  float* logits = smem;                 // (G, S)
  float* q_s = logits + G * s_kv;       // (G, HD)
  float* partial = q_s + G * HD;        // (kWarps, G, HD)
  float* scratch = partial + kWarps * G * HD;  // (kWarps,)

  const int b = blockIdx.x / hkv;
  const int h = blockIdx.x % hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* mrow = mask + static_cast<int64_t>(b) * s_kv;
  const uint8_t* srow = sel + static_cast<int64_t>(b) * s_kv;
  const int64_t q_base = (static_cast<int64_t>(b) * hkv + h) * G * HD;

  // 1. the G query rows in fp32, divided by sqrt(hd) as the reference does
  const float sqrt_hd = sqrtf(static_cast<float>(HD));
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    q_s[i] = repro::to_f32(q[q_base + i]) / sqrt_hd;
  }
  int local_valid = 0;
  for (int s = threadIdx.x; s < s_kv; s += kThreads) local_valid |= (mrow[s] > kNegInf);
  // barrier for q_s as well
  const bool skip_masked = __syncthreads_or(local_valid) != 0;

  auto row_ptr = [&](const T* hot, const T* cold, int s) -> const T* {
    return srow[s] ? hot + ((static_cast<int64_t>(b) * w + (s % w)) * hkv + h) * HD
                   : cold + ((static_cast<int64_t>(b) * s_kv + s) * hkv + h) * HD;
  };

  // 2. logits[g, s] = q_g . k_s + mask[s]
  for (int s = warp; s < s_kv; s += kWarps) {
    const float m = mrow[s];
    if (skip_masked && m <= kNegInf) {
      if (lane < G) logits[lane * s_kv + s] = m;
      continue;
    }
    const T* kr = row_ptr(k_hot, k_cold, s) + lane * HPL;
    float kv[HPL];
#pragma unroll
    for (int i = 0; i < HPL; ++i) kv[i] = repro::to_f32(kr[i]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < HPL; ++i) acc += q_s[g * HD + lane * HPL + i] * kv[i];
      acc = repro::warp_sum(acc);
      if (lane == 0) logits[g * s_kv + s] = acc + m;
    }
  }
  __syncthreads();

  // 3. softmax over the whole row, per query head: max, exp, sum, divide
  for (int g = 0; g < G; ++g) {
    float* lr = logits + g * s_kv;
    float mx = __int_as_float(static_cast<int>(0xff800000u));  // -inf
    for (int s = threadIdx.x; s < s_kv; s += kThreads) mx = fmaxf(mx, lr[s]);
    mx = repro::block_max<kWarps>(mx, scratch);
    float sum = 0.f;
    for (int s = threadIdx.x; s < s_kv; s += kThreads) {
      const float p = expf(lr[s] - mx);
      lr[s] = p;
      sum += p;
    }
    sum = repro::block_sum<kWarps>(sum, scratch);
    for (int s = threadIdx.x; s < s_kv; s += kThreads) lr[s] = lr[s] / sum;
  }
  __syncthreads();

  // 4. out[g] = sum_s probs[g, s] * v_s, fp32
  float acc[G][HPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < HPL; ++i) acc[g][i] = 0.f;
  for (int s = warp; s < s_kv; s += kWarps) {
    if (skip_masked && mrow[s] <= kNegInf) continue;
    const T* vr = row_ptr(v_hot, v_cold, s) + lane * HPL;
    float vv[HPL];
#pragma unroll
    for (int i = 0; i < HPL; ++i) vv[i] = repro::to_f32(vr[i]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float p = logits[g * s_kv + s];
#pragma unroll
      for (int i = 0; i < HPL; ++i) acc[g][i] += p * vv[i];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < HPL; ++i) partial[(warp * G + g) * HD + lane * HPL + i] = acc[g][i];
  __syncthreads();
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    float t = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) t += partial[wi * G * HD + i];
    out[q_base + i] = repro::from_f32<T>(t);
  }
}

template <typename T, int G, int HPL>
int launch(const void* q, const void* k_hot, const void* v_hot, const void* k_cold,
           const void* v_cold, const void* sel, const void* mask, void* out,
           long long batch, int hkv, int s_kv, int w, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(smem_floats(G, HPL * 32, s_kv)) * sizeof(float);
  auto kern = paged_attention_kernel<T, G, HPL>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(static_cast<unsigned>(batch * hkv)), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_hot), static_cast<const T*>(v_hot),
      static_cast<const T*>(k_cold), static_cast<const T*>(v_cold),
      static_cast<const uint8_t*>(sel), static_cast<const float*>(mask),
      static_cast<T*>(out), hkv, s_kv, w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HPL>
int dispatch_groups(int g, const void* q, const void* k_hot, const void* v_hot,
                    const void* k_cold, const void* v_cold, const void* sel,
                    const void* mask, void* out, long long batch, int hkv, int s_kv,
                    int w, cudaStream_t st) {
  switch (g) {
    case 1: return launch<T, 1, HPL>(q, k_hot, v_hot, k_cold, v_cold, sel, mask, out, batch, hkv, s_kv, w, st);
    case 2: return launch<T, 2, HPL>(q, k_hot, v_hot, k_cold, v_cold, sel, mask, out, batch, hkv, s_kv, w, st);
    case 4: return launch<T, 4, HPL>(q, k_hot, v_hot, k_cold, v_cold, sel, mask, out, batch, hkv, s_kv, w, st);
    case 8: return launch<T, 8, HPL>(q, k_hot, v_hot, k_cold, v_cold, sel, mask, out, batch, hkv, s_kv, w, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_head_dim(int hd, int g, const void* q, const void* k_hot, const void* v_hot,
                      const void* k_cold, const void* v_cold, const void* sel,
                      const void* mask, void* out, long long batch, int hkv, int s_kv,
                      int w, cudaStream_t st) {
  switch (hd) {
    case 64: return dispatch_groups<T, 2>(g, q, k_hot, v_hot, k_cold, v_cold, sel, mask, out, batch, hkv, s_kv, w, st);
    case 128: return dispatch_groups<T, 4>(g, q, k_hot, v_hot, k_cold, v_cold, sel, mask, out, batch, hkv, s_kv, w, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Dynamic shared memory one block needs, in bytes.
extern "C" long long repro_paged_attention_smem_bytes(int g, int hd, int s_kv) {
  return smem_floats(g, hd, s_kv) * static_cast<long long>(sizeof(float));
}

extern "C" int repro_paged_attention(const void* q, const void* k_hot, const void* v_hot,
                                     const void* k_cold, const void* v_cold,
                                     const void* sel, const void* mask, void* out,
                                     long long batch, int hkv, int g, int hd, int s_kv,
                                     int w, int dtype, void* stream) {
  if (batch <= 0 || hkv <= 0 || s_kv <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return dispatch_head_dim<float>(hd, g, q, k_hot, v_hot, k_cold, v_cold, sel, mask, out, batch, hkv, s_kv, w, st);
  if (dtype == repro::kBFloat16)
    return dispatch_head_dim<__nv_bfloat16>(hd, g, q, k_hot, v_hot, k_cold, v_cold, sel, mask, out, batch, hkv, s_kv, w, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
