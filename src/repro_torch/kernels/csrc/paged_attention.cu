// Single-query decode attention over the paged KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py::
// paged_attention (call :125, body _kernel :64-87). Same function: per
// (batch row b, kv head h), the G = Hq / Hkv query rows attend over S cache
// rows; row s is read from the hot ring at ring row s % W when sel[b, s] is
// set, else from the cold store at row s; an additive fp32 mask (0 or
// -1e30) is added; softmax over the whole row, then probs . V in fp32, cast
// to the output dtype. kernels/ref.py::paged_attention_ref is the plain
// version, ref.paged_attention_split_ref the plain model of this kernel's
// split-and-combine arithmetic.
//
// What bounds it on the card: bytes. Each attended cache row is read once
// for K and once for V (2 * hd * itemsize bytes per kv head) against
// 4 * G * hd flops, far below the card's flop-per-byte balance. Cold rows
// may sit in pinned host memory, read in place over the host link through
// unified addressing (no staging copy) -- the link, at a few tens of GB/s,
// then bounds the cold share. Reaching either rate takes many loads in
// flight on many SMs, which is what the design is for:
//
//   * split-KV: the grid is (B * Hkv, n_split); each block owns one
//     contiguous range of rows_per_split cache rows (the wrapper chooses
//     both, page-aligned, for one wave of two blocks an SM) and
//     runs an online fp32 softmax over it, leaving a partial (m, l,
//     acc[G][hd]) in fp32 scratch; paged_combine_kernel merges the splits of each (b, h) in
//     split order and casts to q's dtype (one split: the block writes the
//     output itself). No atomics: the output is deterministic;
//   * loads: each lane reads 16 bytes (8 bf16) at a time, so one warp
//     instruction covers 32 / (hd / 8) rows; a warp issues the K and V
//     loads of U such instructions before it uses any of them, and issues
//     the next step's (whose mask and sel it read a step earlier) before it
//     computes this one's, so up to 4 * U 16-byte loads a lane are in
//     flight and none waits on another (plain vector loads: they reach
//     device and pinned host rows alike); blocks of 4 warps;
//   * shared memory holds only the 4 warps' partials (4 * G * hd fp32) and
//     does not grow with S: any cache length runs;
//   * rows masked at -1e30 get exactly 0 weight, and their K and V are
//     never loaded, when at least one row of the whole (b) row is
//     attendable -- every block scans the mask row for that flag (stopping
//     at the first attendable row), so no split decides alone. This also
//     keeps host-link reads away from cold rows not yet written. A row with
//     every entry masked loads everything, as the reference weighs every
//     row equally there. A split with no attendable row enters the combine
//     with m = -inf and weight exactly 0.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // the mask's value for a masked row
constexpr float kMinusInf = -INFINITY;

// elements of T in one 16-byte load
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void widen(const uint4& raw, float* out);
template <>
__device__ __forceinline__ void widen<float>(const uint4& raw, float* out) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
template <>
__device__ __forceinline__ void widen<__nv_bfloat16>(const uint4& raw, float* out) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Does any row of the (b) mask row attend? Block-uniform; stops at the
// first attendable row (row 0 on a causal decode mask).
__device__ __forceinline__ bool row_has_attendable(const float* mrow, int s_kv) {
  for (int base = 0; base < s_kv; base += 4 * kThreads) {
    int found = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = base + i * kThreads + threadIdx.x;
      found |= (s < s_kv && mrow[s] > kNegInf);
    }
    if (__syncthreads_or(found)) return true;
  }
  return false;
}

// Rows [s0, s1) of one (b, kv head): partial (m, l, acc) per query head,
// or the normalised output when the grid has one split.
template <typename T, int G, int HD>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q,       // (B, Hq, hd)
                   const T* __restrict__ k_hot,   // (B, W, Hkv, hd)
                   const T* __restrict__ v_hot,   // (B, W, Hkv, hd)
                   const T* __restrict__ k_cold,  // (B, S, Hkv, hd)
                   const T* __restrict__ v_cold,  // (B, S, Hkv, hd)
                   const uint8_t* __restrict__ sel,  // (B, S)
                   const float* __restrict__ mask,   // (B, S)
                   T* __restrict__ out,              // (B, Hq, hd)
                   float* __restrict__ part,  // (B * Hkv, n_split, G * hd + 2 * G)
                   int hkv, int s_kv, int w, int rows_per_split) {
  constexpr int VEC = Vec<T>::N;   // elements a lane loads at once
  constexpr int LPR = HD / VEC;    // lanes sharing one cache row
  constexpr int RPW = 32 / LPR;    // rows one warp instruction loads
  constexpr int U = G <= 4 ? 4 : 2;  // K (and V) loads a lane keeps in flight
  constexpr int CHUNK = RPW * U;   // rows a warp takes per step
  constexpr int PART = G * HD + 2 * G;
  __shared__ float sm_m[kWarps][G], sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][HD];

  const int bh = blockIdx.x;
  const int b = bh / hkv;
  const int h = bh % hkv;
  const int s0 = blockIdx.y * rows_per_split;
  const int s1 = min(s0 + rows_per_split, s_kv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rg = lane / LPR;           // which of the warp's RPW rows
  const int col = (lane % LPR) * VEC;  // first element of this lane's slice
  const float* mrow = mask + static_cast<int64_t>(b) * s_kv;
  const uint8_t* srow = sel + static_cast<int64_t>(b) * s_kv;
  const int64_t q_base = static_cast<int64_t>(bh) * G * HD;

  // this lane's slice of the G query rows in fp32, divided by sqrt(hd) first
  const float sqrt_hd = sqrtf(static_cast<float>(HD));
  float qr[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < VEC; ++i) qr[g][i] = repro::to_f32(q[q_base + g * HD + col + i]) / sqrt_hd;
  const bool skip_masked = row_has_attendable(mrow, s_kv);

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kMinusInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }

  // one step's rows: where each of the U row groups lies, its mask value
  // and whether it is read; then its K and V
  struct Rows {
    int64_t off[U];
    float mk[U];
    bool live[U], hot[U];
  };
  struct Step {
    uint4 k[U], v[U];
  };
  auto locate = [&](int base, Rows& r) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = base + u * RPW + rg;
      const bool in = s < s1;
      r.mk[u] = in ? mrow[s] : kMinusInf;
      r.live[u] = in && !(skip_masked && r.mk[u] <= kNegInf);
      r.hot[u] = in && srow[s];
      r.off[u] = r.hot[u] ? ((static_cast<int64_t>(b) * w + (s % w)) * hkv + h) * HD + col
                          : ((static_cast<int64_t>(b) * s_kv + s) * hkv + h) * HD + col;
    }
  };
  auto fetch = [&](const Rows& r, Step& st) {
#pragma unroll
    for (int u = 0; u < U; ++u) {  // issue every load before using any
      st.k[u] = make_uint4(0u, 0u, 0u, 0u);
      st.v[u] = st.k[u];
      if (r.live[u]) {
        st.k[u] = *reinterpret_cast<const uint4*>((r.hot[u] ? k_hot : k_cold) + r.off[u]);
        st.v[u] = *reinterpret_cast<const uint4*>((r.hot[u] ? v_hot : v_cold) + r.off[u]);
      }
    }
  };

  // While a step computes, the next step's K and V loads are in flight and
  // the step after that is located (its mask and sel read), so no load
  // waits on another.
  constexpr int kStride = kWarps * CHUNK;
  Rows rcur, rnxt;
  Step cur, nxt;
  int base = s0 + warp * CHUNK;
  if (base < s1) {
    locate(base, rcur);
    fetch(rcur, cur);
  }
  if (base + kStride < s1) locate(base + kStride, rnxt);
  for (; base < s1; base += kStride) {
    Rows rnn;
    if (base + kStride < s1) fetch(rnxt, nxt);
    if (base + 2 * kStride < s1) locate(base + 2 * kStride, rnn);
    float lg[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VEC];
      widen<T>(cur.k[u], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) dot += qr[g][i] * kf[i];
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        lg[u][g] = rcur.live[u] ? dot + rcur.mk[u] : kMinusInf;
      }
    }
    float vf[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) widen<T>(cur.v[u], vf[u]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float cm = lg[0][g];
#pragma unroll
      for (int u = 1; u < U; ++u) cm = fmaxf(cm, lg[u][g]);
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1) cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, o));
      const float m_new = fmaxf(m[g], cm);  // warp-uniform
      if (m_new == kMinusInf) continue;     // nothing attended yet
      const float alpha = expf(m[g] - m_new);  // 0 while m[g] is -inf
      m[g] = m_new;
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[g][i] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = rcur.live[u] ? expf(lg[u][g] - m_new) : 0.f;
        l[g] += p;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[g][i] += p * vf[u][i];
      }
    }
    cur = nxt;
    rcur = rnxt;
    rnxt = rnn;
  }

  // sum the warp's row groups (one m per warp), then the warps in order
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], o);
    }
    if (lane < LPR) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) sm_acc[warp][g][col + i] = acc[g][i];
    }
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
  __syncthreads();
  float* pp = part + (static_cast<int64_t>(bh) * gridDim.y + blockIdx.y) * PART;
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int g = i / HD;
    const int d = i % HD;
    float mx = kMinusInf;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) mx = fmaxf(mx, sm_m[wi][g]);
    float sum_l = 0.f, sum_a = 0.f;
    if (mx != kMinusInf) {
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) {
        const float mw = sm_m[wi][g];
        const float c = mw == kMinusInf ? 0.f : expf(mw - mx);
        sum_l += c * sm_l[wi][g];
        sum_a += c * sm_acc[wi][g][d];
      }
    }
    if (gridDim.y == 1) {  // the whole row: sum_l > 0
      out[q_base + i] = repro::from_f32<T>(sum_a / sum_l);
    } else {
      pp[i] = sum_a;
      if (d == 0) {
        pp[G * HD + 2 * g] = mx;
        pp[G * HD + 2 * g + 1] = sum_l;
      }
    }
  }
}

// Merge the n_split partials of one (b, kv head) in split order: one
// thread per (query head, element). A split with m = -inf weighs 0; at
// least one split attends (or, with every row masked, all do).
template <typename T, int G, int HD>
__global__ void __launch_bounds__(G * HD)
paged_combine_kernel(const float* __restrict__ part, T* __restrict__ out, int n_split) {
  constexpr int PART = G * HD + 2 * G;
  const int i = threadIdx.x;
  const int g = i / HD;
  const float* pb = part + static_cast<int64_t>(blockIdx.x) * n_split * PART;
  float mx = kMinusInf;
  for (int sp = 0; sp < n_split; ++sp) mx = fmaxf(mx, pb[sp * PART + G * HD + 2 * g]);
  float sum_l = 0.f, sum_a = 0.f;
  for (int sp = 0; sp < n_split; ++sp) {
    const float ms = pb[sp * PART + G * HD + 2 * g];
    const float c = ms == kMinusInf ? 0.f : expf(ms - mx);
    sum_l += c * pb[sp * PART + G * HD + 2 * g + 1];
    sum_a += c * pb[sp * PART + i];
  }
  out[static_cast<int64_t>(blockIdx.x) * G * HD + i] = repro::from_f32<T>(sum_a / sum_l);
}

struct Args {
  const void *q, *k_hot, *v_hot, *k_cold, *v_cold, *sel, *mask;
  void *out, *part;
  long long batch;
  int hkv, s_kv, w, rows_per_split, n_split;
};

template <typename T, int G, int HD>
int launch(const Args& a, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(a.batch * a.hkv), static_cast<unsigned>(a.n_split));
  paged_split_kernel<T, G, HD><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_hot),
      static_cast<const T*>(a.v_hot), static_cast<const T*>(a.k_cold),
      static_cast<const T*>(a.v_cold), static_cast<const uint8_t*>(a.sel),
      static_cast<const float*>(a.mask), static_cast<T*>(a.out), static_cast<float*>(a.part),
      a.hkv, a.s_kv, a.w, a.rows_per_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.n_split == 1) return static_cast<int>(e);
  paged_combine_kernel<T, G, HD><<<static_cast<unsigned>(a.batch * a.hkv), G * HD, 0, st>>>(
      static_cast<const float*>(a.part), static_cast<T*>(a.out), a.n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int dispatch_groups(int g, const Args& a, cudaStream_t st) {
  switch (g) {
    case 1: return launch<T, 1, HD>(a, st);
    case 2: return launch<T, 2, HD>(a, st);
    case 4: return launch<T, 4, HD>(a, st);
    case 7: return launch<T, 7, HD>(a, st);
    case 8: return launch<T, 8, HD>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_head_dim(int hd, int g, const Args& a, cudaStream_t st) {
  switch (hd) {
    case 64: return dispatch_groups<T, 64>(g, a, st);
    case 128: return dispatch_groups<T, 128>(g, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// ``part``: fp32 scratch of batch * hkv * n_split * (g * hd + 2 * g) values
// (unused when n_split is 1); rows [i * rows_per_split, (i + 1) *
// rows_per_split) of every (b, kv head) form split i.
extern "C" int repro_paged_attention(const void* q, const void* k_hot, const void* v_hot,
                                     const void* k_cold, const void* v_cold,
                                     const void* sel, const void* mask, void* out, void* part,
                                     long long batch, int hkv, int g, int hd, int s_kv,
                                     int w, int rows_per_split, int n_split, int dtype,
                                     void* stream) {
  if (batch <= 0 || hkv <= 0 || s_kv <= 0 || w <= 0 || rows_per_split <= 0 || n_split <= 0 ||
      static_cast<long long>(rows_per_split) * n_split < s_kv ||
      static_cast<long long>(rows_per_split) * (n_split - 1) >= s_kv || n_split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_hot, v_hot, k_cold, v_cold, sel, mask, out, part,
               batch, hkv, s_kv, w, rows_per_split, n_split};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32) return dispatch_head_dim<float>(hd, g, a, st);
  if (dtype == repro::kBFloat16) return dispatch_head_dim<__nv_bfloat16>(hd, g, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
