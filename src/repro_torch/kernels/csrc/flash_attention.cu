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
// live query tiles and the G query heads of the group; dQ, one block per
// (batch, query head, 64-row query tile) looping over the live key tiles.
// No atomics: every output element is written by one block, so the
// gradients are deterministic, bit for bit, from call to call.
//
// What bounds them on the card: operations. Forward 4 * hd flops and
// backward 10 * hd flops per attended (q, k) pair and query head, against
// the bf16 tensor-core peak; at S = 4096 a head's K and V (2 MB) are re-read
// from L2, not HBM.
//
// Both directions run on the same machinery:
//   * one warpgroup (128 threads, 4 warps) issues each product as a 64-row
//     wgmma; the tiles wgmma reads from shared memory sit in its
//     128-byte-swizzle layout, written by cp.async with the swizzle applied
//     by hand, and are read K-major as the B operand of a product over hd
//     (S = Q.K^T, dP = dO.V^T) and MN-major as the B operand of a product
//     over the keys or queries (O = P.V, dV = P^T.dO, dK = dS^T.Q,
//     dQ = dS.K), so the (B, S, H, hd) inputs are read through their
//     strides and no transposed copy exists;
//   * everything fp32 stays in registers: the accumulators for the whole
//     loop and the S (and dP) tiles, on whose fragments the elementwise pass
//     runs; P and dS become bf16 A operands in registers (the fragments of
//     two n8 accumulator tiles are the A fragment of one k16 step), so no
//     score or accumulator tile goes through shared memory;
//   * live tiles form one contiguous range per block (causal bounds it
//     below, the window above), found before the loop so the ring always
//     knows the next live tile; masked pairs in a live tile get p = 0, and
//     tiles wholly inside the band skip the mask; the grids are tile-major,
//     so the longest tiles (the most live partners) start first.
//
// Forward: a block per (batch, 64-row query tile) and NW query heads of one
// kv group, one warpgroup a head, sharing K / V tiles of 64 NW keys: NW = 2
// (128-key tiles, one block an SM) when the group is even, which halves the
// K / V reads from L2 and the steps' fixed costs, else NW = 1 (64-key tiles,
// two blocks an SM). Q is loaded once; K and V stream through a ring of two
// K and two V slots, each loaded a whole step before it is read (K(it + 2)
// and V(it + 1) are issued as step it starts). Step it issues S(it + 1) and
// O += P(it).V(it), and runs the softmax of S(it + 1) while the tensor cores
// work on P(it).V(it); the loop has no branch around a wgmma or a wait, or
// ptxas serializes every wgmma of the kernel (its C7514 note). The online
// softmax runs on S's fragments: a row lives in the 4 threads of a quad, so
// its max needs two shuffles; exp2 with scale * log2(e) folded in; the
// running max starts at -1e30, so exp2(m_old - m_new) is 1 and never NaN for
// a row with nothing attended yet; p is rounded to bf16 against the running
// max (the rounding point of _fa_kernel) and packed straight into the A
// fragments of O += P.V; the fp32 O accumulator (64 registers a thread at hd
// 128) is rescaled in place. Each thread keeps a partial row sum and the
// quad adds them once at the end. A row with nothing attended gives out 0
// and lse -1e30 + log(1e-30) (= -1e30 in fp32), as the plain version.
//
// Backward (dK / dV and dQ kernels): the streamed tiles (Q, dO, lse, delta
// for dK / dV; K and V for dQ) load through a 2-stage cp.async ring; each
// step issues this step's dV / dK (or dQ) products and then the next step's
// S and dP back to back, meant to keep the tensor cores busy while the next
// tiles land, but ptxas serializes these wgmma (its notes C7515, and C7511
// for dK / dV at hd 128, in the build log); shared memory ~98 KB a block
// (hd 128) and registers sized for two blocks (8 warps) an SM.
//
// ptxas's register, shared-memory and spill counts of every kernel are in
// the build log (``chip_smoke.py``'s build line). TMA and warp
// specialisation are later work.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kTile = 64;      // rows of a query tile and of a key tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Dims {
  int batch, sq, sk, hq, hkv, group;
  int causal, window, q_offset;
  float scale;
};

// element strides (batch, seq, head) of one (B, S, H, hd) tensor
struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ bool attends(int qpos, int kpos, const Dims& d) {
  return kpos < d.sk && (!d.causal || kpos <= qpos) && (d.window <= 0 || kpos > qpos - d.window);
}

// Can any (q, k) of the nq query rows from q0 and the nk keys from k0
// attend? (A necessary condition: tiles failing it are skipped; a live
// tile masks per pair.)
__device__ __forceinline__ bool tiles_live(int q0, int nq, int k0, int nk, const Dims& d) {
  if (q0 >= d.sq || k0 >= d.sk) return false;
  const int qmin = q0 + d.q_offset;
  const int qmax = min(q0 + nq, d.sq) - 1 + d.q_offset;
  const int kmax = min(k0 + nk, d.sk) - 1;
  if (d.causal && k0 > qmax) return false;
  if (d.window > 0 && kmax <= qmin - d.window) return false;
  return true;
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
// Helpers of the wgmma kernels
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; zero-filled when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int R>
__device__ __forceinline__ void load_rows_async(float* sm, const float* g, int row0, int n) {
  for (int i = threadIdx.x; i < R; i += kThreads) {
    const bool in = row0 + i < n;
    cp_async4(sm + i, g + (in ? row0 + i : 0), in);
  }
}

// The live tiles of a row of tiles form one contiguous range [lo, hi)
// (causal bounds it below, the window above); hi == lo when none is.
template <typename Live>
__device__ __forceinline__ void live_range(int n, Live live, int& lo, int& hi) {
  lo = n;
  hi = 0;
  for (int i = 0; i < n; ++i) {
    if (live(i)) {
      lo = min(lo, i);
      hi = i + 1;
    }
  }
  if (hi < lo) hi = lo;
}

// Does every (q, k) of the tiles attend? Then the elementwise pass needs no mask.
__device__ __forceinline__ bool tiles_full(int q0, int nq, int k0, int nk, const Dims& d) {
  if (q0 + nq > d.sq || k0 + nk > d.sk) return false;
  if (d.causal && k0 + nk - 1 > q0 + d.q_offset) return false;
  if (d.window > 0 && k0 <= q0 + nq - 1 + d.q_offset - d.window) return false;
  return true;
}

// Store a warp's 16 x HD fp32 accumulator fragments as bf16 rows [row0,
// row0 + 16) (those below n) through row stride ``rs``.
template <int HD>
__device__ __forceinline__ void store_frags(bf16* g, long long rs, float (&acc)[HD / 8][4],
                                            int row0, int n) {
  const int lane = threadIdx.x & 31;
  const int r = row0 + (lane >> 2);
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (r < n)
      *reinterpret_cast<uint32_t*>(g + r * rs + j * 8 + c) = pack_bf16(acc[j][0], acc[j][1]);
    if (r + 8 < n)
      *reinterpret_cast<uint32_t*>(g + (r + 8) * rs + j * 8 + c) = pack_bf16(acc[j][2], acc[j][3]);
  }
}

// ---------------------------------------------------------------------------
// wgmma: a warpgroup (4 warps) issues each product as 64-row wgmma; operands
// in shared memory sit in the 128-byte-swizzled layout the instruction
// reads, written by cp.async; P and dS are A operands in registers. S, dP
// and the accumulators are n8 tiles of mma.sync-style C fragments: warp w of
// the warpgroup holds rows 16w..16w+15, thread (g = lane / 4, t = lane % 4)
// rows g and g + 8, columns 2t and 2t + 1 of each tile.
// ---------------------------------------------------------------------------
// d (64 x 64 fp32 as n8 tiles of mma.sync C fragments, warp w holding rows
// 16w..16w+15) (+)= A (64 x 16, K-major in shared memory) . B^T (B: 64 x 16,
// K-major in shared memory); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 }, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128 fp32, C fragments as above) (+)= A (64 x 16, K-major in
// shared memory) . B^T (B: 128 x 16, K-major in shared memory).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 }, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  if constexpr (N == 128) {
    wgmma_ss_n128(d, desc_a, desc_b, scale_d);
  } else {
    wgmma_ss_n64(d, desc_a, desc_b, scale_d);
  }
}

// d (64 x 64 fp32, C fragments as above) += A (64 x 16 bf16 in registers:
// warp w holds rows 16w..16w+15 as an mma.sync A fragment) . B (16 x 64,
// MN-major in shared memory).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 }, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128 fp32, C fragments as above) += A (64 x 16 bf16 in registers:
// warp w holds rows 16w..16w+15 as an mma.sync A fragment) . B (16 x 128,
// MN-major in shared memory).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 }, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (N == 128) {
    wgmma_rs_n128(d, a, desc_b);
  } else {
    wgmma_rs_n64(d, a, desc_b);
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }
// cp.async writes are generic-proxy writes; wgmma reads through the async proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from moving accumulator registers across an in-flight wgmma
template <int N>
__device__ __forceinline__ void fence_frags(float (&r)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(r[j][e])::"memory");
}

// keep A-operand registers live (and unmoved) until the wgmma reading them is waited for
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[j][e])::"memory");
}

// An R-row, hd-wide bf16 tile in the 128-byte-swizzle layout: hd / 64 column
// blocks of R rows x 128 bytes; the 16-byte chunk c of row r sits at chunk
// c ^ (r % 8) of its row. Tiles start on 1024-byte boundaries. Loaded by the
// block's NT threads.
template <int R, int HD, int NT = kThreads>
__device__ __forceinline__ void load_tile_swizzled(unsigned char* sm, const bf16* g, long long rs,
                                                   int row0, int n) {
  constexpr int kVec = HD / 8;
  for (int i = threadIdx.x; i < R * kVec; i += NT) {
    const int r = i / kVec;
    const int c = i % kVec;
    const bool in = row0 + r < n;
    cp_async16(sm + (c >> 3) * R * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4),
               g + (in ? (row0 + r) * rs + c * 8 : 0), in);
  }
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), 128-byte swizzle.
__device__ __forceinline__ uint64_t gmma_desc(const unsigned char* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
// The k16 step kk along hd of a swizzled R-row tile read K-major (its rows
// are M or N): 8-row groups 1024 bytes apart.
template <int R>
__device__ __forceinline__ uint64_t desc_kmajor(const unsigned char* tile, int kk) {
  return gmma_desc(tile + (kk >> 2) * R * 128 + (kk & 3) * 32, 16, 1024);
}
// Rows [16 kk, 16 kk + 16) of a swizzled R-row tile read MN-major, as the
// (16 x hd) B operand: hd's 64-column blocks R * 128 bytes apart.
template <int R>
__device__ __forceinline__ uint64_t desc_mnmajor(const unsigned char* tile, int kk) {
  return gmma_desc(tile + kk * 2048, R * 128, 1024);
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

template <int HD>
struct WgSmem {
  static constexpr int kTileBytes = 64 * HD * 2;  // a 64-row bf16 tile
  // dK / dV: K, V; 2 stages of (Q, dO); 2 of (lse, delta); alignment slack
  static constexpr int kDkv = 6 * kTileBytes + 4 * 64 * 4 + 1024;
  // dQ: Q, dO; 2 stages of (K, V)
  static constexpr int kDq = 6 * kTileBytes + 1024;
  // forward with nw warpgroups: nw Q tiles, 2 K and 2 V slots of 64 nw rows
  static constexpr int fwd_bytes(int nw) { return 5 * nw * kTileBytes + 1024; }
};

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------
// out and lse for NW query heads of one kv group (one warpgroup each) and one
// 64-row query tile, over key tiles of KT = 64 NW rows. Step it issues
// S(it + 1) = Q.K(it + 1)^T and then O += P(it).V(it), waits for S(it + 1)
// alone and runs its softmax while the tensor cores work on P(it).V(it),
// then waits for that, rescales O and packs P(it + 1); the loads of K(it + 2)
// and V(it + 1), issued at the step's start, have the whole step to land.
template <int HD, int NW>
__global__ void __launch_bounds__(NW * kThreads, 2 / NW)
flash_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       float* __restrict__ lse, Dims d, Strides qs, Strides ks, Strides vs,
                       Strides os) {
  constexpr int NT = NW * kThreads;
  constexpr int KT = NW * kTile;  // keys a step
  constexpr int NK = KT / 8;      // n8 tiles of S across the keys
  constexpr int ND = HD / 8;      // n8 tiles of O across hd
  constexpr int T = WgSmem<HD>::kTileBytes;
  constexpr int TK = NW * T;      // a K or V tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align_1024(smem_raw);  // one tile a warpgroup
  unsigned char* sK = sQ + NW * T;           // 2 slots
  unsigned char* sV = sK + 2 * TK;           // 2 slots

  const int n_qt = (d.sq + kTile - 1) / kTile;
  const int h0 = blockIdx.x * NW;  // NW divides the group: one kv head a block
  const int wg = threadIdx.x / kThreads;
  const int h = h0 + wg;
  const int b = blockIdx.y;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.z)) * kTile;  // the longest rows first
  const int kvh = h0 / d.group;
  const int lane = threadIdx.x & 31;
  const int wq = ((threadIdx.x >> 5) & 3) * 16;
  const int n_kt = (d.sk + KT - 1) / KT;
  int kt_lo, kt_hi;
  live_range(n_kt, [&](int kt) { return tiles_live(q0, kTile, kt * KT, KT, d); }, kt_lo, kt_hi);
  const int n_it = kt_hi - kt_lo;

  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;
  auto load_k = [&](int it) {
    load_tile_swizzled<KT, HD, NT>(sK + (it & 1) * TK, kb, ks.s, (kt_lo + it) * KT, d.sk);
  };
  auto load_v = [&](int it) {
    load_tile_swizzled<KT, HD, NT>(sV + (it & 1) * TK, vb, vs.s, (kt_lo + it) * KT, d.sk);
  };
  unsigned char* myQ = sQ + wg * T;
  float s[NK][4];
  // S = Q . K(it)^T, (64 queries x KT keys)
  auto scores = [&](int it) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<KT>(s, desc_kmajor<kTile>(myQ, kk), desc_kmajor<KT>(sK + (it & 1) * TK, kk),
                   kk > 0);
  };

  const int qrow = q0 + wq + (lane >> 2);  // this thread's rows: qrow and qrow + 8
  const float scale_log2 = d.scale * kLog2e;
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m2[2] = {kNegInf, kNegInf};  // running max of s * scale * log2(e)
  float l[2] = {0.f, 0.f};           // this thread's part of the row sums
  float alpha[2];                    // exp2(m_old - m_new) of the latest softmax
  uint32_t pa[KT / 16][4];           // P: the A operand of O += P.V

  // online softmax of the scores of step it, in place on s: a row's KT
  // scores lie in one quad; s becomes p (0 where masked)
  auto softmax = [&](int it) {
    const int k0 = (kt_lo + it) * KT;
    const bool full = tiles_full(q0, kTile, k0, KT, d);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kpos = k0 + j * 8 + 2 * (lane & 3) + (e & 1);
        const bool ok = full || attends(qrow + 8 * i + d.q_offset, kpos, d);
        s[j][e] = ok ? s[j][e] * scale_log2 : -INFINITY;
        mx[i] = fmaxf(mx[i], s[j][e]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m2[i], mx[i]);  // -1e30 while nothing is attended
      alpha[i] = exp2f(m2[i] - m_new);
      m2[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m2[e >> 1]);  // masked: exp2(-inf) = 0
        l[e >> 1] += p;
        s[j][e] = p;
      }
    }
  };
  // rescale O by the latest alpha and pack p into the A operand
  auto rescale_pack = [&]() {
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
#pragma unroll
    for (int jj = 0; jj < KT / 16; ++jj) {
      pa[jj][0] = pack_bf16(s[2 * jj][0], s[2 * jj][1]);
      pa[jj][1] = pack_bf16(s[2 * jj][2], s[2 * jj][3]);
      pa[jj][2] = pack_bf16(s[2 * jj + 1][0], s[2 * jj + 1][1]);
      pa[jj][3] = pack_bf16(s[2 * jj + 1][2], s[2 * jj + 1][3]);
    }
  };

#pragma unroll
  for (int w = 0; w < NW; ++w)
    load_tile_swizzled<kTile, HD, NT>(sQ + w * T, q + b * qs.b + (h0 + w) * qs.h, qs.s, q0, d.sq);
  if (n_it > 0) {
    load_k(0);
    load_v(0);
  }
  if (n_it > 1) load_k(1);
  cp_async_commit();
  if (n_it > 0) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    wgmma_fence();
    scores(0);
    wgmma_commit();
    wgmma_wait_all();
    fence_frags(s);
    softmax(0);
    rescale_pack();
  }

  // O += P(it).V(it) for the last step; its V has landed once it returns
  auto pv = [&](int it) {
#pragma unroll
    for (int jj = 0; jj < KT / 16; ++jj)
      wgmma_rs<HD>(acc, pa[jj], desc_mnmajor<KT>(sV + (it & 1) * TK, jj));
  };
  // the steps before the last, with no branch around a wgmma or a wait, so
  // ptxas can tell the two groups apart and keep them asynchronous
  for (int it = 0; it + 1 < n_it; ++it) {
    cp_async_wait<0>();  // K(it + 1) and V(it), issued a step ago
    fence_async_smem();
    // every warp has landed its part of them, and is past S(it) and
    // O += P(it - 1).V(it - 1): K(it)'s and V(it - 1)'s slots are free
    __syncthreads();
    if (it + 2 < n_it) load_k(it + 2);
    load_v(it + 1);
    cp_async_commit();
    wgmma_fence();
    scores(it + 1);
    wgmma_commit();
    pv(it);
    wgmma_commit();
    wgmma_wait<1>();  // S(it + 1); P(it).V(it) may still run
    fence_frags(s);
    softmax(it + 1);
    wgmma_wait_all();
    fence_frags(acc);
    fence_frags(pa);
    rescale_pack();
  }
  if (n_it > 0) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    wgmma_fence();
    pv(n_it - 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_frags(acc);
  }

  // out = acc / max(l, 1e-30); lse = m + log(max(l, 1e-30)) in natural log
  float lf[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    lf[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    acc[j][0] /= lf[0];
    acc[j][1] /= lf[0];
    acc[j][2] /= lf[1];
    acc[j][3] /= lf[1];
  }
  store_frags<HD>(out + b * os.b + h * os.h, os.s, acc, q0 + wq, d.sq);
  if ((lane & 3) == 0) {
    const long long row = (static_cast<long long>(b) * d.hq + h) * d.sq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (qrow + 8 * i < d.sq)
        lse[row + qrow + 8 * i] = (m2[i] == kNegInf ? kNegInf : m2[i] * kLn2) + logf(lf[i]);
    }
  }
}

// dK and dV for one (b, kv head, 64-key tile). Each step issues dV, dK +=
// (this step) and then S^T, dP^T of the next step back to back, so the
// tensor cores work while the next tiles are waited for.
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_dkdv_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, Dims d, Strides qs,
                        Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs) {
  constexpr int BR = kTile;   // query rows a step
  constexpr int NQ = BR / 8;  // n8 tiles of S^T across the queries
  constexpr int ND = HD / 8;  // n8 tiles of dK, dV across hd
  constexpr int T = WgSmem<HD>::kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = align_1024(smem_raw);
  unsigned char* sV = sK + T;
  unsigned char* sQ = sV + T;       // 2 stages
  unsigned char* sDO = sQ + 2 * T;  // 2 stages
  float* sLse = reinterpret_cast<float*>(sDO + 2 * T);  // 2 stages
  float* sDelta = sLse + 2 * BR;                        // 2 stages

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kTile;  // tile-major grid: the longest tiles start first
  const int lane = threadIdx.x & 31;
  const int wk = (threadIdx.x >> 5) * 16;
  const int n_qt = (d.sq + BR - 1) / BR;
  int qt_lo, qt_hi;
  live_range(n_qt, [&](int qt) { return tiles_live(qt * BR, BR, k0, kTile, d); }, qt_lo, qt_hi);
  const int n_it = (qt_hi - qt_lo) * d.group;

  auto issue = [&](int it, int stage) {
    const int q0 = (qt_lo + it / d.group) * BR;
    const int h = kvh * d.group + it % d.group;
    const long long row = (static_cast<long long>(b) * d.hq + h) * d.sq;
    load_tile_swizzled<BR, HD>(sQ + stage * T, q + b * qs.b + h * qs.h, qs.s, q0, d.sq);
    load_tile_swizzled<BR, HD>(sDO + stage * T, dout + b * dos.b + h * dos.h, dos.s, q0, d.sq);
    load_rows_async<BR>(sLse + stage * BR, lse + row, q0, d.sq);
    load_rows_async<BR>(sDelta + stage * BR, delta + row, q0, d.sq);
  };
  float s[NQ][4], dp[NQ][4];
  // S^T = K . Q^T and dP^T = V . dO^T, (64 keys x BR queries), from a stage
  // that has landed in shared memory
  auto scores = [&](int stage) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(s, desc_kmajor<kTile>(sK, kk), desc_kmajor<BR>(sQ + stage * T, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(dp, desc_kmajor<kTile>(sV, kk), desc_kmajor<BR>(sDO + stage * T, kk), kk > 0);
    wgmma_commit();
    fence_frags(s);
    fence_frags(dp);
  };
  load_tile_swizzled<kTile, HD>(sK, k + b * ks.b + kvh * ks.h, ks.s, k0, d.sk);
  load_tile_swizzled<kTile, HD>(sV, v + b * vs.b + kvh * vs.h, vs.s, k0, d.sk);
  if (n_it > 0) issue(0, 0);
  cp_async_commit();
  if (n_it > 0) scores(0);

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  const float scale_log2 = d.scale * kLog2e;
  const int krow = k0 + wk + (lane >> 2);
  uint32_t pa[BR / 16][4], dsa[BR / 16][4];  // P^T, dS^T: A operands of dV, dK

  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    wgmma_wait_all();  // this step's scores; the previous step's dV, dK
    fence_frags(s);
    fence_frags(dp);
    fence_frags(dv_acc);
    fence_frags(dk_acc);
    fence_frags(pa);
    fence_frags(dsa);
    __syncthreads();  // the other stage is read by no wgmma now: refill it
    if (it + 1 < n_it) issue(it + 1, stage ^ 1);
    cp_async_commit();
    const float* cLse = sLse + stage * BR;
    const float* cDelta = sDelta + stage * BR;
    const int q0 = (qt_lo + it / d.group) * BR;
    const bool full = tiles_full(q0, BR, k0, kTile, d);

    // p = exp(s * scale - lse), 0 where masked; ds = p * (dp - delta) * scale;
    // P rounds to dout's dtype for dV, dS to q's for dK (A operands)
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = krow + (e >> 1) * 8;
        const int qi = j * 8 + 2 * (lane & 3) + (e & 1);
        const int qrow = q0 + qi;
        const bool ok = full || (qrow < d.sq && attends(qrow + d.q_offset, kpos, d));
        const float p = ok ? exp2f(s[j][e] * scale_log2 - cLse[qi] * kLog2e) : 0.f;
        dp[j][e] = p * (dp[j][e] - cDelta[qi]) * d.scale;
        s[j][e] = p;
      }
    }
#pragma unroll
    for (int jj = 0; jj < BR / 16; ++jj) {
      pa[jj][0] = pack_bf16(s[2 * jj][0], s[2 * jj][1]);
      pa[jj][1] = pack_bf16(s[2 * jj][2], s[2 * jj][3]);
      pa[jj][2] = pack_bf16(s[2 * jj + 1][0], s[2 * jj + 1][1]);
      pa[jj][3] = pack_bf16(s[2 * jj + 1][2], s[2 * jj + 1][3]);
      dsa[jj][0] = pack_bf16(dp[2 * jj][0], dp[2 * jj][1]);
      dsa[jj][1] = pack_bf16(dp[2 * jj][2], dp[2 * jj][3]);
      dsa[jj][2] = pack_bf16(dp[2 * jj + 1][0], dp[2 * jj + 1][1]);
      dsa[jj][3] = pack_bf16(dp[2 * jj + 1][2], dp[2 * jj + 1][3]);
    }
    // dV += P^T . dO and dK += dS^T . Q, (64 keys x hd)
    wgmma_fence();
#pragma unroll
    for (int jj = 0; jj < BR / 16; ++jj)
      wgmma_rs<HD>(dv_acc, pa[jj], desc_mnmajor<BR>(sDO + stage * T, jj));
#pragma unroll
    for (int jj = 0; jj < BR / 16; ++jj)
      wgmma_rs<HD>(dk_acc, dsa[jj], desc_mnmajor<BR>(sQ + stage * T, jj));
    wgmma_commit();
    fence_frags(dv_acc);
    fence_frags(dk_acc);
    fence_frags(pa);
    fence_frags(dsa);
    if (it + 1 < n_it) scores(stage ^ 1);
  }
  wgmma_wait_all();
  fence_frags(dv_acc);
  fence_frags(dk_acc);
  cp_async_wait<0>();
  store_frags<HD>(dk + b * dks.b + kvh * dks.h, dks.s, dk_acc, k0 + wk, d.sk);
  store_frags<HD>(dv + b * dvs.b + kvh * dvs.h, dvs.s, dv_acc, k0 + wk, d.sk);
}

// dQ for one (b, query head, 64-row query tile), with the same overlap:
// dQ += (this step), then S, dP of the next step.
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_dq_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dq, Dims d, Strides qs, Strides ks, Strides vs,
                      Strides dos, Strides dqs) {
  constexpr int NK = kTile / 8;
  constexpr int ND = HD / 8;
  constexpr int T = WgSmem<HD>::kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align_1024(smem_raw);
  unsigned char* sDO = sQ + T;
  unsigned char* sK = sDO + T;     // 2 stages
  unsigned char* sV = sK + 2 * T;  // 2 stages

  const int n_qt = (d.sq + kTile - 1) / kTile;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.z)) * kTile;  // the longest rows first
  const int kvh = h / d.group;
  const int lane = threadIdx.x & 31;
  const int wq = (threadIdx.x >> 5) * 16;
  const int n_kt = (d.sk + kTile - 1) / kTile;
  int kt_lo, kt_hi;
  live_range(n_kt, [&](int kt) { return tiles_live(q0, kTile, kt * kTile, kTile, d); }, kt_lo,
             kt_hi);
  const int n_it = kt_hi - kt_lo;

  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;
  auto issue = [&](int it, int stage) {
    const int k0 = (kt_lo + it) * kTile;
    load_tile_swizzled<kTile, HD>(sK + stage * T, kb, ks.s, k0, d.sk);
    load_tile_swizzled<kTile, HD>(sV + stage * T, vb, vs.s, k0, d.sk);
  };
  float s[NK][4], dp[NK][4];
  // S = Q . K^T and dP = dO . V^T, (64 queries x 64 keys)
  auto scores = [&](int stage) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(s, desc_kmajor<kTile>(sQ, kk), desc_kmajor<kTile>(sK + stage * T, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(dp, desc_kmajor<kTile>(sDO, kk), desc_kmajor<kTile>(sV + stage * T, kk),
                   kk > 0);
    wgmma_commit();
    fence_frags(s);
    fence_frags(dp);
  };
  load_tile_swizzled<kTile, HD>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, d.sq);
  load_tile_swizzled<kTile, HD>(sDO, dout + b * dos.b + h * dos.h, dos.s, q0, d.sq);
  if (n_it > 0) issue(0, 0);
  cp_async_commit();
  if (n_it > 0) scores(0);

  const int qrow = q0 + wq + (lane >> 2);
  const long long row = (static_cast<long long>(b) * d.hq + h) * d.sq;
  float lse_l2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = qrow + 8 * i < d.sq;
    lse_l2[i] = in ? lse[row + qrow + 8 * i] * kLog2e : 0.f;
    dlt[i] = in ? delta[row + qrow + 8 * i] : 0.f;
  }
  float dq_acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;
  const float scale_log2 = d.scale * kLog2e;
  uint32_t dsa[kTile / 16][4];  // dS: the A operand of dQ

  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    wgmma_wait_all();
    fence_frags(s);
    fence_frags(dp);
    fence_frags(dq_acc);
    fence_frags(dsa);
    __syncthreads();
    if (it + 1 < n_it) issue(it + 1, stage ^ 1);
    cp_async_commit();
    const int k0 = (kt_lo + it) * kTile;
    const bool full = tiles_full(q0, kTile, k0, kTile, d);

    // ds = p * (dp - delta) * scale, rounded to q's dtype: the A operand of dS . K
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kpos = k0 + j * 8 + 2 * (lane & 3) + (e & 1);
        const bool ok =
            full || (qrow + 8 * i < d.sq && attends(qrow + 8 * i + d.q_offset, kpos, d));
        const float p = ok ? exp2f(s[j][e] * scale_log2 - lse_l2[i]) : 0.f;
        dp[j][e] = p * (dp[j][e] - dlt[i]) * d.scale;
      }
    }
#pragma unroll
    for (int jj = 0; jj < kTile / 16; ++jj) {
      dsa[jj][0] = pack_bf16(dp[2 * jj][0], dp[2 * jj][1]);
      dsa[jj][1] = pack_bf16(dp[2 * jj][2], dp[2 * jj][3]);
      dsa[jj][2] = pack_bf16(dp[2 * jj + 1][0], dp[2 * jj + 1][1]);
      dsa[jj][3] = pack_bf16(dp[2 * jj + 1][2], dp[2 * jj + 1][3]);
    }
    // dQ += dS . K, (64 queries x hd)
    wgmma_fence();
#pragma unroll
    for (int jj = 0; jj < kTile / 16; ++jj)
      wgmma_rs<HD>(dq_acc, dsa[jj], desc_mnmajor<kTile>(sK + stage * T, jj));
    wgmma_commit();
    fence_frags(dq_acc);
    fence_frags(dsa);
    if (it + 1 < n_it) scores(stage ^ 1);
  }
  wgmma_wait_all();
  fence_frags(dq_acc);
  cp_async_wait<0>();
  store_frags<HD>(dq + b * dqs.b + h * dqs.h, dqs.s, dq_acc, q0 + wq, d.sq);
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

template <int HD, int NW>
int fwd_launch(const void* q, const void* k, const void* v, void* out, void* lse, const Dims& d,
               const long long* st, cudaStream_t stream) {
  auto kern = flash_fwd_wgmma_kernel<HD, NW>;
  constexpr int smem = WgSmem<HD>::fwd_bytes(NW);
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // tile-major grid: blocks dispatch in order, so the longest tiles start first
  const dim3 grid(d.hq / NW, d.batch, (d.sq + kTile - 1) / kTile);
  kern<<<grid, NW * kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), d, strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3));
  return static_cast<int>(cudaGetLastError());
}

// two query heads a block when the group is even, else one (see the note above)
template <int HD>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse, const Dims& d,
        const long long* st, cudaStream_t stream) {
  if (d.group % 2 == 0) return fwd_launch<HD, 2>(q, k, v, out, lse, d, st, stream);
  return fwd_launch<HD, 1>(q, k, v, out, lse, d, st, stream);
}

template <int HD>
int bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
        const void* lse, void* delta, void* dq, void* dk, void* dv, const Dims& d,
        const long long* st, cudaStream_t stream) {
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

  const auto* q_ = static_cast<const bf16*>(q);
  const auto* k_ = static_cast<const bf16*>(k);
  const auto* v_ = static_cast<const bf16*>(v);
  const auto* do_ = static_cast<const bf16*>(dout);
  const auto* lse_ = static_cast<const float*>(lse);
  const auto* delta_ = static_cast<const float*>(delta);
  auto dkdv = flash_dkdv_wgmma_kernel<HD>;
  e = allow_smem(dkdv, WgSmem<HD>::kDkv);
  if (e != cudaSuccess) return static_cast<int>(e);
  // tile-major grids: blocks dispatch in order, so the longest tiles start first
  dkdv<<<dim3(d.hkv, d.batch, (d.sk + kTile - 1) / kTile), kThreads, WgSmem<HD>::kDkv, stream>>>(
      q_, k_, v_, do_, lse_, delta_, static_cast<bf16*>(dk), static_cast<bf16*>(dv), d, qs, ks,
      vs, dos, dks, dvs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  auto dqk = flash_dq_wgmma_kernel<HD>;
  e = allow_smem(dqk, WgSmem<HD>::kDq);
  if (e != cudaSuccess) return static_cast<int>(e);
  dqk<<<dim3(d.hq, d.batch, (d.sq + kTile - 1) / kTile), kThreads, WgSmem<HD>::kDq, stream>>>(
      q_, k_, v_, do_, lse_, delta_, static_cast<bf16*>(dq), d, qs, ks, vs, dos, dqs);
  return static_cast<int>(cudaGetLastError());
}

bool dims_ok(const long long* dims) {
  return dims[0] > 0 && dims[1] > 0 && dims[2] > 0 && dims[3] > 0 && dims[4] > 0 &&
         dims[3] % dims[4] == 0 && dims[3] <= 65535 && dims[0] <= 65535 &&
         (dims[1] + 63) / 64 <= 65535 && (dims[2] + 63) / 64 <= 65535;
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
