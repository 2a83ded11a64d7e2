// FlashAttention forward and backward for Hopper (sm_90a), bf16 in, fp32 math.
//
// Forward replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (call :134, body _fa_kernel :32-86): per query row, an
// online fp32 softmax over key tiles; masks kpos < sk, causal kpos <= qpos,
// window kpos > qpos - window; GQA (query head h reads kv head h / G); p is
// rounded to V's dtype before P.V; out = acc / max(l, 1e-30). It also writes
// the fp32 log-sum-exp m + log(max(l, 1e-30)) that the backward needs, as
// models/layers.py::_mea_forward (:169-206) returns it.
//
// Backward computes models/layers.py::_mea_bwd (:221-256), which has no
// Pallas counterpart, with its rounding points: p = exp(s - lse) in fp32,
// rounded to dout's dtype for dV; ds = p * (dp - delta) * scale rounded to
// q's dtype for dQ and dK. Three kernels: delta = rowsum(dO * O) in fp32;
// dK and dV, one block per (batch, kv head, 64-key tile) looping over the
// query tiles and the G query heads of the group; dQ, one block per (batch,
// query head, 64-row query tile) looping over key tiles. No atomics: every
// output element is written by one block, so the gradients are deterministic.
//
// What bounds them on the card: operations. Forward 4 * hd flops and
// backward 10 * hd flops per attended (q, k) pair and query head, against
// the bf16 tensor-core peak; at S = 4096 a head's K and V (2 MB) are re-read
// from L2, not HBM.
//
// Design (simple first; wgmma, TMA and warp specialisation are later work):
//   * 128 threads, 4 warps; a warp owns 16 rows of the 64-row tile;
//   * tiles of 64 rows x hd staged in shared memory with 16-byte loads,
//     read through the caller's strides (the (B, S, H, hd) layout of the
//     model, no transposes); rows past the sequence are zero-filled;
//   * the products run on the tensor cores through WMMA bf16 16x16x16
//     fragments (mma.sync m16n8k16 underneath) with fp32 accumulation;
//     scores go through shared memory for the elementwise softmax, and the
//     fp32 accumulators (O, dQ, dK, dV) live in shared memory, where the
//     online rescale of O by exp(m_old - m_new) is an elementwise pass;
//   * key tiles outside the causal / window band of the query tile are
//     skipped; inside a live tile masked pairs get p = 0 exactly.
#include <mma.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kThreads = 128;
constexpr int kTile = 64;  // rows of a query tile and of a key tile
constexpr int kWarpRows = 16;
constexpr int kLdP = kTile + 8;  // bf16 (64 x 64) score tiles
constexpr int kLdF = kTile + 4;  // fp32 (64 x 64) score tiles
constexpr float kNegInf = -1e30f;

struct Dims {
  int batch, sq, sk, hq, hkv, group;
  int causal, window, q_offset;
  float scale;
};

// element strides (batch, seq, head) of one (B, S, H, hd) tensor
struct Strides {
  long long b, s, h;
};

template <int HD>
struct Layout {
  static constexpr int kLdB = HD + 8;  // bf16 (64 x hd) tiles
  static constexpr int kLdO = HD + 4;  // fp32 (64 x hd) accumulators
  static constexpr int kTileB = kTile * kLdB * 2;
  static constexpr int kTileO = kTile * kLdO * 4;
  static constexpr int kScoreF = kTile * kLdF * 4;
  static constexpr int kScoreB = kTile * kLdP * 2;
  static constexpr int kRowVec = kTile * 4;
  static constexpr int kFwdSmem = 3 * kTileB + kScoreF + kScoreB + kTileO + kRowVec;
  static constexpr int kDkvSmem = 4 * kTileB + 2 * kScoreF + kScoreB + 2 * kTileO + 2 * kRowVec;
  static constexpr int kDqSmem = 4 * kTileB + 2 * kScoreF + kScoreB + kTileO + 2 * kRowVec;
};

__device__ __forceinline__ bool attends(int qpos, int kpos, const Dims& d) {
  return kpos < d.sk && (!d.causal || kpos <= qpos) && (d.window <= 0 || kpos > qpos - d.window);
}

// Can any (q, k) of query tile q0 and key tile k0 attend? (A necessary
// condition: tiles failing it are skipped; a live tile masks per pair.)
__device__ __forceinline__ bool tile_live(int q0, int k0, const Dims& d) {
  if (q0 >= d.sq || k0 >= d.sk) return false;
  const int qmin = q0 + d.q_offset;
  const int qmax = min(q0 + kTile, d.sq) - 1 + d.q_offset;
  const int kmax = min(k0 + kTile, d.sk) - 1;
  if (d.causal && k0 > qmax) return false;
  if (d.window > 0 && kmax <= qmin - d.window) return false;
  return true;
}

// Rows [row0, row0 + 64) of a (S, hd) slice with row stride ``rs`` into a
// shared (64 x ld) tile; rows at or past ``n`` are zero.
template <int HD, int LD>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* g, long long rs, int row0, int n) {
  constexpr int kVec = HD / 8;
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c = (i % kVec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) val = *reinterpret_cast<const uint4*>(g + (row0 + r) * rs + c);
    *reinterpret_cast<uint4*>(sm + r * LD + c) = val;
  }
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// out (16 x 64, fp32, ld kLdF) = A (16 x hd, row-major, ld lda) . B^T, where
// B is a (64 x hd) row-major tile (ld ldb): the transpose is a col-major read.
template <int HD>
__device__ __forceinline__ void mm_abt(float* out, const bf16* a, int lda, const bf16* b, int ldb) {
#pragma unroll
  for (int nf = 0; nf < kTile / 16; ++nf) {
    FragC c;
    wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      FragA fa;
      FragBCol fb;
      wmma::load_matrix_sync(fa, a + kk * 16, lda);
      wmma::load_matrix_sync(fb, b + nf * 16 * ldb + kk * 16, ldb);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(out + nf * 16, c, kLdF, wmma::mem_row_major);
  }
}

// acc (16 x hd, fp32, ld ldo) += A (16 x 64 bf16, ld kLdP) . B (64 x hd, row-major, ld ldb)
template <int HD>
__device__ __forceinline__ void mm_acc(float* acc, int ldo, const bf16* a, const bf16* b, int ldb) {
#pragma unroll
  for (int nf = 0; nf < HD / 16; ++nf) {
    FragC c;
    wmma::load_matrix_sync(c, acc + nf * 16, ldo, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      FragA fa;
      FragBRow fb;
      wmma::load_matrix_sync(fa, a + kk * 16, kLdP);
      wmma::load_matrix_sync(fb, b + kk * 16 * ldb + nf * 16, ldb);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(acc + nf * 16, c, ldo, wmma::mem_row_major);
  }
}

template <int HD>
__device__ __forceinline__ void zero_rows(float* acc) {
  using L = Layout<HD>;
  for (int i = threadIdx.x; i < kTile * L::kLdO; i += kThreads) acc[i] = 0.f;
}

// Write rows [row0, row0 + 64) (those below n) of a shared fp32 accumulator
// as bf16 through row stride ``rs``.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* g, long long rs, const float* acc, int row0, int n) {
  using L = Layout<HD>;
  for (int i = threadIdx.x; i < kTile * HD; i += kThreads) {
    const int r = i / HD;
    const int c = i % HD;
    if (row0 + r < n) g[(row0 + r) * rs + c] = __float2bfloat16(acc[r * L::kLdO + c]);
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                 Dims d, Strides qs, Strides ks, Strides vs, Strides os) {
  using L = Layout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::kTileB);
  bf16* sV = reinterpret_cast<bf16*>(smem + 2 * L::kTileB);
  float* sS = reinterpret_cast<float*>(smem + 3 * L::kTileB);
  bf16* sP = reinterpret_cast<bf16*>(smem + 3 * L::kTileB + L::kScoreF);
  float* sO = reinterpret_cast<float*>(smem + 3 * L::kTileB + L::kScoreF + L::kScoreB);
  float* sAlpha = sO + kTile * L::kLdO;

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / d.group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wr = warp * kWarpRows;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;

  load_tile<HD, L::kLdB>(sQ, qb, qs.s, q0, d.sq);
  zero_rows<HD>(sO);

  float m_r[kWarpRows], l_r[kWarpRows];
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    m_r[r] = kNegInf;
    l_r[r] = 0.f;
  }

  const int n_kt = (d.sk + kTile - 1) / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    if (!tile_live(q0, kt * kTile, d)) continue;  // uniform over the block
    __syncthreads();  // the previous tile's K / V are consumed
    load_tile<HD, L::kLdB>(sK, kb, ks.s, kt * kTile, d.sk);
    load_tile<HD, L::kLdB>(sV, vb, vs.s, kt * kTile, d.sk);
    __syncthreads();

    float* sSw = sS + wr * kLdF;
    bf16* sPw = sP + wr * kLdP;
    mm_abt<HD>(sSw, sQ + wr * L::kLdB, L::kLdB, sK, L::kLdB);
    __syncwarp();

#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) {  // unrolled: m_r / l_r stay in registers
      const int qpos = q0 + wr + r + d.q_offset;
      const int k0 = kt * kTile + lane;
      const float s0 = sSw[r * kLdF + lane] * d.scale;
      const float s1 = sSw[r * kLdF + lane + 32] * d.scale;
      const bool v0 = attends(qpos, k0, d);
      const bool v1 = attends(qpos, k0 + 32, d);
      const float mx = repro::warp_max(fmaxf(v0 ? s0 : -INFINITY, v1 ? s1 : -INFINITY));
      const float m_new = fmaxf(m_r[r], mx);
      const float p0 = v0 ? expf(s0 - m_new) : 0.f;
      const float p1 = v1 ? expf(s1 - m_new) : 0.f;
      const float alpha = expf(m_r[r] - m_new);
      l_r[r] = l_r[r] * alpha + repro::warp_sum(p0 + p1);
      m_r[r] = m_new;
      sPw[r * kLdP + lane] = __float2bfloat16(p0);
      sPw[r * kLdP + lane + 32] = __float2bfloat16(p1);
      if (lane == 0) sAlpha[wr + r] = alpha;
    }
    __syncwarp();
    float* sOw = sO + wr * L::kLdO;
    for (int i = lane; i < kWarpRows * HD; i += 32) {
      const int r = i / HD;
      sOw[r * L::kLdO + i % HD] *= sAlpha[wr + r];
    }
    __syncwarp();
    mm_acc<HD>(sOw, L::kLdO, sPw, sV, L::kLdB);
    __syncwarp();
  }

  __syncthreads();  // sO is complete (also when no key tile was live)
  // out = acc / max(l, 1e-30); lse = m + log(max(l, 1e-30))
  bf16* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    const int row = q0 + wr + r;
    if (row < d.sq) {
      const float l = fmaxf(l_r[r], 1e-30f);
      for (int c = lane; c < HD; c += 32) {
        ob[row * os.s + c] = __float2bfloat16(sO[(wr + r) * L::kLdO + c] / l);
      }
      if (lane == 0) lse[(static_cast<long long>(b) * d.hq + h) * d.sq + row] = m_r[r] + logf(l);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward: delta = rowsum(dO * O) in fp32, one warp per (b, row, head)
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                   float* __restrict__ delta, Dims d, Strides os, Strides dos) {
  const long long idx = static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  const long long n = static_cast<long long>(d.batch) * d.hq * d.sq;
  if (idx >= n) return;
  const int lane = threadIdx.x & 31;
  const int row = static_cast<int>(idx % d.sq);
  const int h = static_cast<int>((idx / d.sq) % d.hq);
  const int b = static_cast<int>(idx / (static_cast<long long>(d.sq) * d.hq));
  const bf16* orow = o + b * os.b + row * os.s + h * os.h;
  const bf16* drow = dout + b * dos.b + row * dos.s + h * dos.h;
  float acc = 0.f;
  for (int c = lane; c < HD; c += 32) acc += __bfloat162float(orow[c]) * __bfloat162float(drow[c]);
  acc = repro::warp_sum(acc);
  if (lane == 0) delta[idx] = acc;  // (B, Hq, Sq)
}

// ---------------------------------------------------------------------------
// Backward: dK and dV for one (b, kv head, 64-key tile)
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, Dims d,
                  Strides qs, Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs) {
  using L = Layout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::kTileB);
  bf16* sQ = reinterpret_cast<bf16*>(smem + 2 * L::kTileB);
  bf16* sDO = reinterpret_cast<bf16*>(smem + 3 * L::kTileB);
  float* sS = reinterpret_cast<float*>(smem + 4 * L::kTileB);
  float* sDP = reinterpret_cast<float*>(smem + 4 * L::kTileB + L::kScoreF);
  bf16* sP = reinterpret_cast<bf16*>(smem + 4 * L::kTileB + 2 * L::kScoreF);
  float* sDK = reinterpret_cast<float*>(smem + 4 * L::kTileB + 2 * L::kScoreF + L::kScoreB);
  float* sDV = sDK + kTile * L::kLdO;
  float* sLse = sDV + kTile * L::kLdO;
  float* sDelta = sLse + kTile;

  const int k0 = blockIdx.x * kTile;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wr = warp * kWarpRows;

  load_tile<HD, L::kLdB>(sK, k + b * ks.b + kvh * ks.h, ks.s, k0, d.sk);
  load_tile<HD, L::kLdB>(sV, v + b * vs.b + kvh * vs.h, vs.s, k0, d.sk);
  zero_rows<HD>(sDK);
  zero_rows<HD>(sDV);

  float* sSw = sS + wr * kLdF;
  float* sDPw = sDP + wr * kLdF;
  bf16* sPw = sP + wr * kLdP;
  const int n_qt = (d.sq + kTile - 1) / kTile;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    if (!tile_live(q0, k0, d)) continue;
    for (int g = 0; g < d.group; ++g) {
      const int h = kvh * d.group + g;
      __syncthreads();  // the previous (tile, head)'s Q / dO are consumed
      load_tile<HD, L::kLdB>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, d.sq);
      load_tile<HD, L::kLdB>(sDO, dout + b * dos.b + h * dos.h, dos.s, q0, d.sq);
      for (int i = threadIdx.x; i < kTile; i += kThreads) {
        const long long base = (static_cast<long long>(b) * d.hq + h) * d.sq;
        const bool in = q0 + i < d.sq;
        sLse[i] = in ? lse[base + q0 + i] : 0.f;
        sDelta[i] = in ? delta[base + q0 + i] : 0.f;
      }
      __syncthreads();

      // S^T (16 keys x 64 queries) = K_w . Q^T ; dP^T = V_w . dO^T
      mm_abt<HD>(sSw, sK + wr * L::kLdB, L::kLdB, sQ, L::kLdB);
      mm_abt<HD>(sDPw, sV + wr * L::kLdB, L::kLdB, sDO, L::kLdB);
      __syncwarp();
      // p = exp(s * scale - lse) (0 where masked), rounded to dout's dtype for dV
#pragma unroll 1
      for (int r = 0; r < kWarpRows; ++r) {
        const int kpos = k0 + wr + r;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = lane + 32 * half;
          const int qrow = q0 + c;
          const bool ok = qrow < d.sq && attends(qrow + d.q_offset, kpos, d);
          const float p = ok ? expf(sSw[r * kLdF + c] * d.scale - sLse[c]) : 0.f;
          sSw[r * kLdF + c] = p;
          sPw[r * kLdP + c] = __float2bfloat16(p);
        }
      }
      __syncwarp();
      mm_acc<HD>(sDV + wr * L::kLdO, L::kLdO, sPw, sDO, L::kLdB);
      __syncwarp();
      // ds = p * (dp - delta) * scale, rounded to q's dtype for dK
#pragma unroll 1
      for (int r = 0; r < kWarpRows; ++r) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = lane + 32 * half;
          const float ds = sSw[r * kLdF + c] * (sDPw[r * kLdF + c] - sDelta[c]) * d.scale;
          sPw[r * kLdP + c] = __float2bfloat16(ds);
        }
      }
      __syncwarp();
      mm_acc<HD>(sDK + wr * L::kLdO, L::kLdO, sPw, sQ, L::kLdB);
    }
  }
  __syncthreads();
  store_rows<HD>(dk + b * dks.b + kvh * dks.h, dks.s, sDK, k0, d.sk);
  store_rows<HD>(dv + b * dvs.b + kvh * dvs.h, dvs.s, sDV, k0, d.sk);
}

// ---------------------------------------------------------------------------
// Backward: dQ for one (b, query head, 64-row query tile)
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dq, Dims d, Strides qs, Strides ks, Strides vs,
                Strides dos, Strides dqs) {
  using L = Layout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = reinterpret_cast<bf16*>(smem + L::kTileB);
  bf16* sK = reinterpret_cast<bf16*>(smem + 2 * L::kTileB);
  bf16* sV = reinterpret_cast<bf16*>(smem + 3 * L::kTileB);
  float* sS = reinterpret_cast<float*>(smem + 4 * L::kTileB);
  float* sDP = reinterpret_cast<float*>(smem + 4 * L::kTileB + L::kScoreF);
  bf16* sP = reinterpret_cast<bf16*>(smem + 4 * L::kTileB + 2 * L::kScoreF);
  float* sDQ = reinterpret_cast<float*>(smem + 4 * L::kTileB + 2 * L::kScoreF + L::kScoreB);
  float* sLse = sDQ + kTile * L::kLdO;
  float* sDelta = sLse + kTile;

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / d.group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wr = warp * kWarpRows;

  load_tile<HD, L::kLdB>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, d.sq);
  load_tile<HD, L::kLdB>(sDO, dout + b * dos.b + h * dos.h, dos.s, q0, d.sq);
  zero_rows<HD>(sDQ);
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const long long base = (static_cast<long long>(b) * d.hq + h) * d.sq;
    const bool in = q0 + i < d.sq;
    sLse[i] = in ? lse[base + q0 + i] : 0.f;
    sDelta[i] = in ? delta[base + q0 + i] : 0.f;
  }

  float* sSw = sS + wr * kLdF;
  float* sDPw = sDP + wr * kLdF;
  bf16* sPw = sP + wr * kLdP;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;
  const int n_kt = (d.sk + kTile - 1) / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    if (!tile_live(q0, k0, d)) continue;
    __syncthreads();
    load_tile<HD, L::kLdB>(sK, kb, ks.s, k0, d.sk);
    load_tile<HD, L::kLdB>(sV, vb, vs.s, k0, d.sk);
    __syncthreads();

    mm_abt<HD>(sSw, sQ + wr * L::kLdB, L::kLdB, sK, L::kLdB);
    mm_abt<HD>(sDPw, sDO + wr * L::kLdB, L::kLdB, sV, L::kLdB);
    __syncwarp();
#pragma unroll 1
    for (int r = 0; r < kWarpRows; ++r) {
      const int qrow = q0 + wr + r;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        const bool ok = qrow < d.sq && attends(qrow + d.q_offset, k0 + c, d);
        const float p = ok ? expf(sSw[r * kLdF + c] * d.scale - sLse[wr + r]) : 0.f;
        const float ds = p * (sDPw[r * kLdF + c] - sDelta[wr + r]) * d.scale;
        sPw[r * kLdP + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    mm_acc<HD>(sDQ + wr * L::kLdO, L::kLdO, sPw, sK, L::kLdB);
    __syncwarp();
  }
  __syncthreads();
  store_rows<HD>(dq + b * dqs.b + h * dqs.h, dqs.s, sDQ, q0, d.sq);
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

Dims make_dims(const long long* dims, int causal, int window, int q_offset, float scale) {
  Dims d;
  d.batch = static_cast<int>(dims[0]);
  d.sq = static_cast<int>(dims[1]);
  d.sk = static_cast<int>(dims[2]);
  d.hq = static_cast<int>(dims[3]);
  d.hkv = static_cast<int>(dims[4]);
  d.group = d.hq / d.hkv;
  d.causal = causal;
  d.window = window;
  d.q_offset = q_offset;
  d.scale = scale;
  return d;
}

Strides strides_at(const long long* s, int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

template <int HD>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse, const Dims& d,
        const long long* st, cudaStream_t stream) {
  using L = Layout<HD>;
  auto kern = flash_fwd_kernel<HD>;
  cudaError_t e = allow_smem(kern, L::kFwdSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((d.sq + kTile - 1) / kTile, d.hq, d.batch);
  kern<<<grid, kThreads, L::kFwdSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), d, strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3));
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
        const void* lse, void* delta, void* dq, void* dk, void* dv, const Dims& d,
        const long long* st, cudaStream_t stream) {
  using L = Layout<HD>;
  const Strides qs = strides_at(st, 0), ks = strides_at(st, 1), vs = strides_at(st, 2);
  const Strides os = strides_at(st, 3), dos = strides_at(st, 4), dqs = strides_at(st, 5);
  const Strides dks = strides_at(st, 6), dvs = strides_at(st, 7);
  const long long rows = static_cast<long long>(d.batch) * d.hq * d.sq;
  const unsigned delta_blocks = static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32));
  flash_delta_kernel<HD><<<delta_blocks, kThreads, 0, stream>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), static_cast<float*>(delta),
      d, os, dos);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  auto dkdv = flash_dkdv_kernel<HD>;
  e = allow_smem(dkdv, L::kDkvSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dkdv<<<dim3((d.sk + kTile - 1) / kTile, d.hkv, d.batch), kThreads, L::kDkvSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), d,
      qs, ks, vs, dos, dks, dvs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  auto dqk = flash_dq_kernel<HD>;
  e = allow_smem(dqk, L::kDqSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dqk<<<dim3((d.sq + kTile - 1) / kTile, d.hq, d.batch), kThreads, L::kDqSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), d, qs, ks, vs, dos, dqs);
  return static_cast<int>(cudaGetLastError());
}

bool dims_ok(const long long* dims) {
  return dims[0] > 0 && dims[1] > 0 && dims[2] > 0 && dims[3] > 0 && dims[4] > 0 &&
         dims[3] % dims[4] == 0 && dims[3] <= 65535 && dims[0] <= 65535;
}

}  // namespace

// dims: [batch, sq, sk, hq, hkv, hd]; strides: (batch, seq, head) element
// strides of q, k, v, out, each tensor (B, S, H, hd) with a unit hd stride.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                         void* lse, const long long* dims,
                                         const long long* strides, int causal, int window,
                                         int q_offset, float scale, void* stream) {
  if (!dims_ok(dims)) return static_cast<int>(cudaErrorInvalidValue);
  const Dims d = make_dims(dims, causal, window, q_offset, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dims[5]) {
    case 64: return fwd<64>(q, k, v, out, lse, d, strides, st);
    case 128: return fwd<128>(q, k, v, out, lse, d, strides, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// strides: q, k, v, out, dout, dq, dk, dv. ``delta`` is (B, Hq, Sq) fp32 scratch.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* out, const void* dout, const void* lse,
                                         void* delta, void* dq, void* dk, void* dv,
                                         const long long* dims, const long long* strides,
                                         int causal, int window, int q_offset, float scale,
                                         void* stream) {
  if (!dims_ok(dims)) return static_cast<int>(cudaErrorInvalidValue);
  const Dims d = make_dims(dims, causal, window, q_offset, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dims[5]) {
    case 64: return bwd<64>(q, k, v, out, dout, lse, delta, dq, dk, dv, d, strides, st);
    case 128: return bwd<128>(q, k, v, out, dout, lse, delta, dq, dk, dv, d, strides, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
