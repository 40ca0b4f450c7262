// Fused centralized edge MLP of the depth-2 train branch (bf16 in, f32
// accumulate), forward and backward.
//
// Forward, for every slot k >= 1 of every point n of cloud b:
//   y0  = f32(y[b, j]) - f32(y[b, n]),  j = idx[b, n, k] read as JAX reads
//         an index: a negative one from the end, then clamped to [0, N)
//   h   = bf16(LeakyReLU(y0 * a0 + b0))          (each operation rounded)
//   out[b, k, n, :] = bf16(h @ W1)               (f32 sums, K-major)
// and out[b, 0, n, :] = bf16(z0).
//
// Backward, from the bf16 cotangent g[b, k, n, :] of slots k >= 1:
//   dh   = g @ W1^T (f32 sums),  dpre = dh * (pre >= 0 ? 1 : 0.2)
//   dy0  = dpre * a0
//   dy[b, j] += bf16(dy0),  dy[b, n] -= sum_k dy0 (unrounded)
//   dW1  = sum h^T g,  da0 = sum dpre * y0,  db0 = sum dpre
// with y0 recomputed from y. It runs in two kernels and no float atomics:
// phase 1 (`edge_mlp_bwd_edges`) writes bf16(dy0) of every edge into a
// K-major edge tensor e [B, K, N, C0] (slot 0 unused), each point's self
// term sum_k dy0 as an f64 sum in slot order into self [B, N, C0] f64, and
// dW1 and (da0, db0) as one partial a block ([blocks, C0, C1], [blocks, 2,
// C0]), which the wrapper sums in a fixed order; phase 2
// (`edge_mlp_bwd_sum`) is destination-major over the inverse adjacency of
// the clamped indices (gather_rows.cu's `inverse_adjacency` in its clamp
// mode: each row's edges n K + k ascending): a row starts from 0 - self
// and adds the e rows of its edges with k != 0 in list order, in f64, and
// rounds once to f32. The f32 (or bf16) addends of one (row, channel) sum
// exactly in f64 unless they span more than ~29 binary orders, so dy is
// the exact sum of its addends rounded once: two calls give the same bits,
// and so does the plain version (f64 sums too) where their dy0 agree (the
// f32 sums of dh run in another order).
//
// y [B, N, C0] bf16, idx [B, N, K] i32, ab = (a0, b0) [2, C0] f32, W1
// [C0, C1] bf16, z0 [C1] f32, g [B, K, N, C1] bf16; C0 and C1 one of 16,
// 32, 64, 128 (the wrapper zero-pads: a zero channel stays zero), every
// array 16-byte aligned. Every affine operation is rounded on its own (no
// FMA contraction), as the plain version's.
//
// Replaces the Pallas kernels of deltaconv_tpu/ops/edge_mlp.py:
// `_pallas_fwd` (pallas_call at edge_mlp.py:192, body `_fwd_kernel`) and
// `_pallas_bwd` (edge_mlp.py:244, `_bwd_kernel`). Those gathered the
// neighbour rows with a [(K-1) T, N] one-hot MXU product inside a 56 MB
// VMEM budget, and the forward wrote the f32 y0 of every edge so that the
// backward could skip a second one-hot gather. Here the rows are gathered
// directly (y is 4 MB at the segmentation shape and stays in L2), and the
// backward gathers them again and recomputes y0 bit for bit instead of
// reading a stash (timed on the card against an f32 stash: PERF.md,
// section 6).
//
// Bound on the H100 at the segmentation train shape (B=16, N=2048, K=30,
// C0 = C1 = 64, E = B N (K - 1) = 950,272 edges): the forward writes 126 MB
// of y1 (0.038 ms at 3.35 TB/s) for 7.8 GFLOP; the function of the
// backward reads the same 126 MB of g; this design's backward moves ~0.43
// GB (g, e written and read, the self rows written and read, dy, idx and
// the adjacency), ~0.13 ms. Memory, then, and what the design must do is
// keep enough gathers in flight that the stream of writes never waits.
//
// Design: mma.sync m16n8k16 (bf16, f32 accumulate) on tiles of 16 points
// of one cloud (an m-tile), one slot at a time (an item); every operand
// comes out of shared memory by ldmatrix, every accumulator stays in
// registers, every gather is a cp.async of 16-byte pieces into a ring of
// stages, so the L2 reads of the next items are in flight while an item
// is computed.
// * Forward (`edge_mlp_fwd_kernel`): a block takes one m-tile and reads
//   its [16, K] indices (coalesced, clamped there once), its own rows and
//   W1 (row-major, read as the B operand by ldmatrix.trans) into shared
//   memory; its 4 warps take the slots in turn, each with its own ring of
//   3 stages. A warp builds h in registers directly in the A-fragment
//   layout: ldmatrix of the staged neighbour rows, minus the tile's own
//   rows (a fragment held for all slots), the affine, LeakyReLU and the
//   bf16 round; no h tile in shared memory. The accumulators are rounded
//   to bf16 in registers and written through the warp's consumed stage
//   (a bf16 tile; no f32 tile) as whole 16-byte pieces of the item's 16
//   contiguous K-major rows, evict-first (y1 is read by the next layer).
// * Backward phase 1 (`edge_mlp_bwd_edges_kernel`): everything transposed,
//   so that one register layout serves all three products. A group of C0
//   / 16 warps walks m-tiles (four groups a block at C0 = 64, each with
//   its own shared memory and named barrier, over a fixed grid), warp s
//   owning channels [16 s, 16 s + 16) of C0. Per slot the group stages
//   the 16 gathered y rows and the 16 contiguous g rows by cp.async (a
//   ring of 3 stages, one group barrier a slot; every thread's pieces and
//   offsets fixed for the walk). Warp s computes dh^T = W1[slice] g^T
//   (W1's slice as A fragments in registers for the whole walk, g^T's B
//   fragments by ldmatrix), y0^T and pre^T from ldmatrix.trans of the
//   staged rows and the tile's own rows; the accumulator layout of dh^T
//   is the A-fragment layout of h^T, so LeakyReLU's factor f (h = pre f,
//   dpre = dh f), dy0, the self sums (f64, 8 a lane, slot order), (da0,
//   db0) and h^T for dW1[slice] += h^T g (g's B fragments by
//   ldmatrix.trans; dW1's slice in registers for the whole walk) all sit
//   where the lane already holds them. bf16(dy0) goes by stmatrix.trans
//   into a small bf16 tile, then as whole 16-byte pieces to e's rows.
//   It is bound by instructions, not bytes: 0.126 ms at the segmentation
//   shape against 0.080 for its bytes (PERF.md, section 6).
// * Backward phase 2 (`edge_mlp_bwd_sum_kernel`): C0 / 8 lanes a row, 8
//   channels a lane (16-byte loads of e's rows, f64 sums), the row's list
//   read a group of lanes at a time and broadcast by shuffles, 8 edges'
//   loads in flight.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kTile = 16;       // points of an m-tile: the mma's 16 rows
constexpr int kFwdWarps = 4;    // a forward block: one m-tile, its slots
constexpr int kFwdStages = 3;   // a forward warp's ring of gathered slots
constexpr int kBwdStages = 3;   // a backward group's ring of items
constexpr int kSumThreads = 256;
constexpr int kSumAhead = 8;    // e rows whose loads precede their adds

__device__ __forceinline__ float bf_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float bf_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// Two f32 values rounded to bf16, `lo` in the low half (the lower
// address, the smaller column of a fragment's pair).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// LeakyReLU 0.2 as the larger of v and 0.2 v (v >= 0 ? v : 0.2 v for
// every value, -0.0 and NaN included).
__device__ __forceinline__ float lrelu(float v) {
  return fmaxf(v, __fmul_rn(0.2f, v));
}

__device__ __forceinline__ int clamp_index(int j, int N) {
  if (j < 0) j += N;
  return j < 0 ? 0 : (j >= N ? N - 1 : j);
}

// 16 bytes global -> shared; `on` false zero-fills the destination and
// reads nothing.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool on) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(on ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void stsm4t(void* p, const uint32_t (&r)[4]) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, "
      "%4};\n" ::"r"(a),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Lane addresses of a 16 x 16 block at column c of a tile of row stride
// ld (bf16). A order: lanes 0-15 rows 0-15 at c, lanes 16-31 at c + 8, so
// x4 gives (rows 0-7, c), (8-15, c), (0-7, c + 8), (8-15, c + 8): the A
// fragment of the block, or with .trans the B fragments of two n-tiles of
// a [k, n] row-major tile. Q order: (0-7, c), (0-7, c + 8), (8-15, c),
// (8-15, c + 8).
__device__ __forceinline__ int a_order(int lane, int ld, int c) {
  return (lane & 15) * ld + c + (lane >> 4) * 8;
}

__device__ __forceinline__ int q_order(int lane, int ld, int c) {
  return ((lane & 7) + ((lane >> 4) << 3)) * ld + c + ((lane >> 3) & 1) * 8;
}

// ---- forward -----------------------------------------------------------

template <int T0, int T1>
struct FwdShape {
  static constexpr int C0 = 16 * T0, C1 = 16 * T1;
  static constexpr int LDW = C1 + 8;   // W1 rows in shared memory
  static constexpr int LDS = C0 + 8;   // the tile's own rows
  static constexpr int LD = (C0 > C1 ? C0 : C1) + 8;  // a ring stage's rows
  static constexpr size_t w = 0;
  static constexpr size_t ab = w + (size_t)C0 * LDW * 2;
  static constexpr size_t self = ab + (size_t)2 * C0 * 4;
  static constexpr size_t ring = self + (size_t)kTile * LDS * 2;
  static constexpr size_t idx =
      ring + (size_t)kFwdWarps * kFwdStages * kTile * LD * 2;
  static size_t bytes(int K) { return idx + (size_t)kTile * K * 4; }
};

template <int T0, int T1>
__global__ void __launch_bounds__(kFwdWarps * 32)
    edge_mlp_fwd_kernel(const __nv_bfloat16* __restrict__ y,
                        const int* __restrict__ idx,
                        const float* __restrict__ ab,
                        const __nv_bfloat16* __restrict__ w1,
                        const float* __restrict__ z0,
                        __nv_bfloat16* __restrict__ out, int N, int K) {
  using S = FwdShape<T0, T1>;
  constexpr int C0 = S::C0, C1 = S::C1, LD = S::LD;
  constexpr int kThreads = kFwdWarps * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem + S::w);
  float* s_ab = reinterpret_cast<float*>(smem + S::ab);
  __nv_bfloat16* s_self = reinterpret_cast<__nv_bfloat16*>(smem + S::self);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + S::ring);
  int* s_idx = reinterpret_cast<int*>(smem + S::idx);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int tpc = (N + kTile - 1) / kTile;
  const long long b = blockIdx.x / tpc;
  const int n0 = (blockIdx.x % tpc) * kTile;
  const int rows = min(kTile, N - n0);
  const __nv_bfloat16* yb = y + b * N * C0;

  // W1 and the tile's own rows by cp.async (zeros past N), the affine and
  // the indices (clamped) by plain loads, slot 0's rows written.
  for (int u = tid; u < C0 * (C1 / 8); u += kThreads) {
    const int r = u / (C1 / 8), q = u % (C1 / 8);
    cp16(s_w + r * S::LDW + q * 8, w1 + r * C1 + q * 8, true);
  }
  for (int u = tid; u < kTile * (C0 / 8); u += kThreads) {
    const int p = u / (C0 / 8), q = u % (C0 / 8);
    cp16(s_self + p * S::LDS + q * 8,
         yb + (long long)(p < rows ? n0 + p : 0) * C0 + q * 8, p < rows);
  }
  cp_commit();
  for (int u = tid; u < 2 * C0; u += kThreads) s_ab[u] = ab[u];
  const int* ib = idx + (b * N + n0) * K;
  for (int u = tid; u < kTile * K; u += kThreads)
    s_idx[u] = u < rows * K ? clamp_index(ib[u], N) : 0;
  {
    __nv_bfloat16* o0 = out + (b * K * N + n0) * C1;
    for (int u = tid; u < rows * (C1 / 8); u += kThreads) {
      const int p = u / (C1 / 8), q = u % (C1 / 8);
      uint4 v;
      v.x = pack_bf16(z0[q * 8], z0[q * 8 + 1]);
      v.y = pack_bf16(z0[q * 8 + 2], z0[q * 8 + 3]);
      v.z = pack_bf16(z0[q * 8 + 4], z0[q * 8 + 5]);
      v.w = pack_bf16(z0[q * 8 + 6], z0[q * 8 + 7]);
      *reinterpret_cast<uint4*>(o0 + (long long)p * C1 + q * 8) = v;
    }
  }
  cp_wait<0>();
  __syncthreads();

  // The tile's own rows as A fragments, for every slot of this warp.
  uint32_t sf[T0][4];
#pragma unroll
  for (int ks = 0; ks < T0; ++ks)
    ldsm4(sf[ks], s_self + a_order(lane, S::LDS, ks * 16));

  // Items of this warp: slots 1 + warp, 1 + warp + kFwdWarps, ...
  const int n_items = K - 1 > warp ? (K - 2 - warp) / kFwdWarps + 1 : 0;
  __nv_bfloat16* my_ring = ring + warp * kFwdStages * kTile * LD;
  auto issue = [&](int i) {
    const int k = 1 + warp + i * kFwdWarps;
    __nv_bfloat16* dst = my_ring + (i % kFwdStages) * kTile * LD;
#pragma unroll
    for (int u = lane; u < kTile * (C0 / 8); u += 32) {
      const int p = u / (C0 / 8), q = u % (C0 / 8);
      cp16(dst + p * LD + q * 8,
           yb + (long long)s_idx[p * K + k] * C0 + q * 8, p < rows);
    }
  };
#pragma unroll
  for (int s = 0; s < kFwdStages - 1; ++s) {
    if (s < n_items) issue(s);
    cp_commit();
  }
  for (int i = 0; i < n_items; ++i) {
    cp_wait<kFwdStages - 2>();
    __syncwarp();
    if (i + kFwdStages - 1 < n_items) issue(i + kFwdStages - 1);
    cp_commit();
    const int k = 1 + warp + i * kFwdWarps;
    __nv_bfloat16* st = my_ring + (i % kFwdStages) * kTile * LD;
    // h in the A-fragment layout: lane (g, t) holds rows g, g + 8 and
    // columns 16 ks + 2t, + 1 (registers 0, 1) and + 8, + 9 (2, 3).
    uint32_t h[T0][4];
#pragma unroll
    for (int ks = 0; ks < T0; ++ks) {
      uint32_t yf[4];
      ldsm4(yf, st + a_order(lane, LD, ks * 16));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int c = ks * 16 + 2 * tq + (r >> 1) * 8;
        const float2 av = *reinterpret_cast<const float2*>(s_ab + c);
        const float2 bv = *reinterpret_cast<const float2*>(s_ab + C0 + c);
        const float lo = __fadd_rn(
            __fmul_rn(__fsub_rn(bf_lo(yf[r]), bf_lo(sf[ks][r])), av.x), bv.x);
        const float hi = __fadd_rn(
            __fmul_rn(__fsub_rn(bf_hi(yf[r]), bf_hi(sf[ks][r])), av.y), bv.y);
        h[ks][r] = pack_bf16(lrelu(lo), lrelu(hi));
      }
    }
    __syncwarp();  // the stage's rows are read: it holds the output next
#pragma unroll
    for (int p0 = 0; p0 < T1; p0 += 4) {  // 64 output columns at a time
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < T0; ++ks)
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          if (p0 + pp >= T1) continue;
          uint32_t bw[4];
          ldsm4t(bw, s_w + a_order(lane, S::LDW, (p0 + pp) * 16) +
                         ks * 16 * S::LDW);
          mma_bf16(acc[2 * pp], h[ks], bw[0], bw[1]);
          mma_bf16(acc[2 * pp + 1], h[ks], bw[2], bw[3]);
        }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (p0 + j / 2 >= T1) continue;
        const int col = (2 * p0 + j) * 8 + 2 * tq;
        *reinterpret_cast<uint32_t*>(st + gq * LD + col) =
            pack_bf16(acc[j][0], acc[j][1]);
        *reinterpret_cast<uint32_t*>(st + (gq + 8) * LD + col) =
            pack_bf16(acc[j][2], acc[j][3]);
      }
    }
    __syncwarp();
    // The item's rows are contiguous in the K-major output.
    __nv_bfloat16* dst = out + ((b * K + k) * N + n0) * C1;
#pragma unroll
    for (int u = lane; u < kTile * (C1 / 8); u += 32) {
      const int p = u / (C1 / 8), q = u % (C1 / 8);
      if (p < rows)  // evict-first: y1 is read by the next layer, later
        __stcs(reinterpret_cast<uint4*>(dst + (long long)p * C1 + q * 8),
               *reinterpret_cast<const uint4*>(st + p * LD + q * 8));
    }
  }
}

// ---- backward, phase 1 -------------------------------------------------

// Groups of T0 warps a block: each group walks m-tiles as a block of its
// own would (its own shared memory, a named barrier: ids 1 .. 8), and the
// block adds its groups' dW1 and (da0, db0) into one partial in group
// order. 512 threads a block up to C1 = 64 and C0 >= 32 (128 registers a
// thread: 4 groups at C0 = 64), 256 at C0 = 16 or C1 = 128.
__host__ __device__ constexpr int bwd_groups(int T0, int T1) {
  return T1 > 4 ? (T0 >= 8 ? 1 : 8 / T0) : (T0 == 1 ? 8 : 16 / T0);
}

template <int T0, int T1>
struct BwdShape {
  static constexpr int C0 = 16 * T0, C1 = 16 * T1;
  static constexpr int LDY = C0 + 8, LDG = C1 + 8;
  // A group's region: the ring's gathered y rows and g rows, the tile's
  // own rows, the bf16(dy0) tile (two) and the tile's indices.
  static constexpr size_t ys = 0;
  static constexpr size_t gs = ys + (size_t)kBwdStages * kTile * LDY * 2;
  static constexpr size_t self = gs + (size_t)kBwdStages * kTile * LDG * 2;
  static constexpr size_t et = self + (size_t)kTile * LDY * 2;
  static constexpr size_t idx = et + (size_t)2 * kTile * LDY * 2;
  __host__ __device__ static size_t group(int K) {
    return idx + ((size_t)kTile * K * 4 + 15) / 16 * 16;
  }
  // The groups' regions; after the walk, the block's partial sums.
  static size_t bytes(int K) {
    const size_t walk = bwd_groups(T0, T1) * group(K);
    const size_t sums = (size_t)(C0 * C1 + 2 * C0) * 4;
    return walk > sums ? walk : sums;
  }
};

template <int T0, int T1>
__global__ void __launch_bounds__(32 * T0 * bwd_groups(T0, T1), 1)
    edge_mlp_bwd_edges_kernel(const __nv_bfloat16* __restrict__ y,
                              const int* __restrict__ idx,
                              const float* __restrict__ ab,
                              const __nv_bfloat16* __restrict__ w1,
                              const __nv_bfloat16* __restrict__ g,
                              __nv_bfloat16* __restrict__ e,
                              double* __restrict__ self_sum,
                              float* __restrict__ dw1_part,
                              float* __restrict__ dab_part, int B, int N,
                              int K) {
  using S = BwdShape<T0, T1>;
  constexpr int C0 = S::C0, C1 = S::C1, LDY = S::LDY, LDG = S::LDG;
  constexpr int kGroups = bwd_groups(T0, T1);
  constexpr int kThreads = 32 * T0;  // a group's
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = warp / T0, slice = warp % T0, gtid = tid % kThreads;
  unsigned char* region = smem + grp * S::group(K);
  __nv_bfloat16* s_y = reinterpret_cast<__nv_bfloat16*>(region + S::ys);
  __nv_bfloat16* s_g = reinterpret_cast<__nv_bfloat16*>(region + S::gs);
  __nv_bfloat16* s_self = reinterpret_cast<__nv_bfloat16*>(region + S::self);
  __nv_bfloat16* s_e = reinterpret_cast<__nv_bfloat16*>(region + S::et);
  int* s_idx = reinterpret_cast<int*>(region + S::idx);
  const int gq = lane >> 2, tq = lane & 3;
  const int c_lo = 16 * slice + gq;  // this lane's channels: c_lo, c_lo + 8
  const int tpc = (N + kTile - 1) / kTile, tiles = B * tpc;
  // The group walks the tiles vb, vb + n_vb, ...
  const int vb = (int)blockIdx.x * kGroups + grp;
  const int n_vb = (int)gridDim.x * kGroups;
  auto sync = [&]() {
    asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1), "r"(kThreads)
                 : "memory");
  };

  // W1's rows of this warp's channels as A fragments (m = c0, k = c1).
  uint32_t wa[T1][4];
  {
    const uint32_t* w32 = reinterpret_cast<const uint32_t*>(w1);
#pragma unroll
    for (int ks = 0; ks < T1; ++ks) {
      const int col = ks * 16 + 2 * tq;
      wa[ks][0] = w32[(c_lo * C1 + col) / 2];
      wa[ks][1] = w32[((c_lo + 8) * C1 + col) / 2];
      wa[ks][2] = w32[(c_lo * C1 + col + 8) / 2];
      wa[ks][3] = w32[((c_lo + 8) * C1 + col + 8) / 2];
    }
  }
  const float a_c[2] = {ab[c_lo], ab[c_lo + 8]};
  const float b_c[2] = {ab[C0 + c_lo], ab[C0 + c_lo + 8]};

  float dw[2 * T1][4];
#pragma unroll
  for (int j = 0; j < 2 * T1; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) dw[j][v] = 0.0f;
  float da[2] = {0.0f, 0.0f}, db[2] = {0.0f, 0.0f};

  // This thread's piece of every 16-row tile of C0 channels (the gathered
  // y rows, the tile's own rows, the bf16(dy0) tile: 2 C0 pieces of 16
  // bytes, one a thread), and its kGPer pieces of the g tiles.
  constexpr int kYStage = kTile * LDY, kGStage = kTile * LDG;
  constexpr int kGPieces = kTile * (C1 / 8);
  constexpr int kGPer = (kGPieces + kThreads - 1) / kThreads;
  const int py = gtid / (C0 / 8), qy = gtid % (C0 / 8);
  const int y_off = py * LDY + qy * 8;
  int g_row[kGPer], g_soff[kGPer], g_goff[kGPer];
#pragma unroll
  for (int i = 0; i < kGPer; ++i) {
    const int u = gtid + i * kThreads;
    g_row[i] = u < kGPieces ? u / (C1 / 8) : kTile;  // kTile: no piece
    g_soff[i] = g_row[i] * LDG + (u % (C1 / 8)) * 8;
    g_goff[i] = g_row[i] * C1 + (u % (C1 / 8)) * 8;
  }
  const int sy_off = q_order(lane, LDY, 16 * slice);
  const int e_off = (8 * (lane >> 4) + (lane & 7)) * LDY + 16 * slice +
                    8 * ((lane >> 3) & 1);

  for (int tile = vb; tile < tiles; tile += n_vb) {
    const long long b = tile / tpc;
    const int n0 = (tile - (int)b * tpc) * kTile;
    const int rows = min(kTile, N - n0);
    const bool y_on = py < rows;
    const __nv_bfloat16* yb = y + b * N * C0 + qy * 8;  // + row * C0
    const __nv_bfloat16* gt0 = g + (b * K * N + n0) * C1;  // + k N C1
    __nv_bfloat16* et0 = e + (b * K * N + n0 + py) * C0 + qy * 8;  // + k N C0
    const long long g_step = (long long)N * C1, e_step = (long long)N * C0;
    // The tile's indices, clamped (the last tile's items are all issued).
    const int* ib = idx + (b * N + n0) * K;
    for (int u = gtid; u < kTile * K; u += kThreads)
      s_idx[u] = u < rows * K ? clamp_index(ib[u], N) : 0;
    sync();
    cp16(s_self + y_off, yb + (long long)(y_on ? n0 + py : 0) * C0, y_on);
    const int* my_idx = s_idx + py * K;
    // Slot k's gathered y rows and g rows into stage `stage`.
    auto issue = [&](int k, int stage) {
      cp16(s_y + stage * kYStage + y_off, yb + (long long)my_idx[k] * C0,
           y_on);
      const __nv_bfloat16* gk = gt0 + k * g_step;
#pragma unroll
      for (int i = 0; i < kGPer; ++i)
        if (g_row[i] < kTile)
          cp16(s_g + stage * kGStage + g_soff[i],
               gk + (g_row[i] < rows ? g_goff[i] : 0), g_row[i] < rows);
    };
#pragma unroll
    for (int k = 1; k < kBwdStages; ++k) {
      if (k < K) issue(k, k - 1);
      cp_commit();
    }
    // Lane (g, t), register r, element v: point 2t + v + 8 (r >> 1) of the
    // tile, channel c_lo + 8 (r & 1).
    double self_acc[4][2];
    float sv[4][2];  // the tile's own y values
#pragma unroll
    for (int r = 0; r < 4; ++r) self_acc[r][0] = self_acc[r][1] = 0.0;
    int stage = 0, ahead = kBwdStages - 1;  // consumed and issued stages
    for (int k = 1; k < K; ++k) {
      cp_wait<kBwdStages - 2>();
      sync();
      if (k > 1 && y_on)  // slot k - 1's bf16(dy0) tile to e's rows
        *reinterpret_cast<uint4*>(et0 + (k - 1) * e_step) =
            *reinterpret_cast<const uint4*>(s_e + ((k - 1) & 1) * kYStage +
                                            y_off);
      if (k + kBwdStages - 1 < K) issue(k + kBwdStages - 1, ahead);
      cp_commit();
      ahead = ahead + 1 == kBwdStages ? 0 : ahead + 1;
      if (k == 1) {
        uint32_t sf[4];
        ldsm4t(sf, s_self + sy_off);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          sv[r][0] = bf_lo(sf[r]);
          sv[r][1] = bf_hi(sf[r]);
        }
      }
      const __nv_bfloat16* sy = s_y + stage * kYStage;
      const __nv_bfloat16* sg = s_g + stage * kGStage;
      stage = stage + 1 == kBwdStages ? 0 : stage + 1;
      // pre^T and h^T = pre f, f = LeakyReLU'(pre): lane (g, t) register
      // r holds channel c_lo + 8 (r & 1) of points 2t, 2t + 1 (+ 8 for r
      // >= 2): the A fragment of h^T.
      uint32_t yt[4], hf[4];
      ldsm4t(yt, sy + sy_off);
      float f[4][2];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float h[2];
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const float y0 =
              __fsub_rn(v ? bf_hi(yt[r]) : bf_lo(yt[r]), sv[r][v]);
          const float pre =
              __fadd_rn(__fmul_rn(y0, a_c[r & 1]), b_c[r & 1]);
          f[r][v] = pre >= 0.0f ? 1.0f : 0.2f;
          h[v] = __fmul_rn(pre, f[r][v]);  // pre or 0.2 pre, as lrelu
        }
        hf[r] = pack_bf16(h[0], h[1]);
      }
      // dh^T = W1[slice] g^T: n-tile 0 the points 0-7, n-tile 1 8-15.
      float dh[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) dh[j][v] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < T1; ++ks) {
        uint32_t gb[4];
        ldsm4(gb, sg + q_order(lane, LDG, 16 * ks));
        mma_bf16(dh[0], wa[ks], gb[0], gb[1]);
        mma_bf16(dh[1], wa[ks], gb[2], gb[3]);
      }
      // dW1[slice] += h^T g: g's B fragments (k = point, n = c1) by .trans.
#pragma unroll
      for (int jj = 0; jj < T1; ++jj) {
        uint32_t gt[4];
        ldsm4t(gt, sg + q_order(lane, LDG, 16 * jj));
        mma_bf16(dw[2 * jj], hf, gt[0], gt[2]);
        mma_bf16(dw[2 * jj + 1], hf, gt[1], gt[3]);
      }
      uint32_t ep[4];  // bf16(dy0) pairs, in hf's layout
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float dy0[2];
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const float dpre = __fmul_rn(dh[r >> 1][2 * (r & 1) + v], f[r][v]);
          const float y0 =
              __fsub_rn(v ? bf_hi(yt[r]) : bf_lo(yt[r]), sv[r][v]);
          dy0[v] = __fmul_rn(dpre, a_c[r & 1]);
          self_acc[r][v] += (double)dy0[v];
          da[r & 1] = __fadd_rn(da[r & 1], __fmul_rn(dpre, y0));
          db[r & 1] = __fadd_rn(db[r & 1], dpre);
        }
        ep[r] = pack_bf16(dy0[0], dy0[1]);
      }
      // The pairs are the fragments of four 8 x 8 matrices (channels x
      // points); stored transposed they are the tile's rows of e.
      stsm4t(s_e + (k & 1) * kYStage + e_off, ep);
    }
    cp_wait<0>();
    sync();
    if (K > 1 && y_on)
      *reinterpret_cast<uint4*>(et0 + (K - 1) * e_step) =
          *reinterpret_cast<const uint4*>(s_e + ((K - 1) & 1) * kYStage +
                                          y_off);
    // The tile's self terms, summed in slot order.
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int p = 2 * tq + v + 8 * (r >> 1);
        if (p < rows)
          self_sum[(b * N + n0 + p) * C0 + c_lo + 8 * (r & 1)] =
              self_acc[r][v];
      }
  }

  // The block's partials: each group's dW1 rows (by warp) and (da0, db0)
  // (summed over a lane group in a fixed order) added in group order in
  // shared memory, then written whole.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    da[h] = __fadd_rn(da[h], __shfl_xor_sync(0xffffffffu, da[h], 1));
    da[h] = __fadd_rn(da[h], __shfl_xor_sync(0xffffffffu, da[h], 2));
    db[h] = __fadd_rn(db[h], __shfl_xor_sync(0xffffffffu, db[h], 1));
    db[h] = __fadd_rn(db[h], __shfl_xor_sync(0xffffffffu, db[h], 2));
  }
  float* red = reinterpret_cast<float*>(smem);  // [C0][C1], then [2][C0]
  auto put = [&](float* p, float v, bool add) {
    *p = add ? __fadd_rn(*p, v) : v;
  };
  __syncthreads();
  for (int gg = 0; gg < kGroups; ++gg) {
    if (grp == gg) {
#pragma unroll
      for (int j = 0; j < 2 * T1; ++j) {
        const int col = 8 * j + 2 * tq;
        put(red + c_lo * C1 + col, dw[j][0], gg > 0);
        put(red + c_lo * C1 + col + 1, dw[j][1], gg > 0);
        put(red + (c_lo + 8) * C1 + col, dw[j][2], gg > 0);
        put(red + (c_lo + 8) * C1 + col + 1, dw[j][3], gg > 0);
      }
      if (tq == 0) {
        float* rab = red + C0 * C1;
        put(rab + c_lo, da[0], gg > 0);
        put(rab + c_lo + 8, da[1], gg > 0);
        put(rab + C0 + c_lo, db[0], gg > 0);
        put(rab + C0 + c_lo + 8, db[1], gg > 0);
      }
    }
    __syncthreads();
  }
  float4* part = reinterpret_cast<float4*>(dw1_part +
                                           (long long)blockIdx.x * C0 * C1);
  for (int u = tid; u < C0 * C1 / 4; u += blockDim.x)
    part[u] = reinterpret_cast<const float4*>(red)[u];
  for (int u = tid; u < 2 * C0; u += blockDim.x)
    dab_part[(long long)blockIdx.x * 2 * C0 + u] = red[C0 * C1 + u];
}

// ---- backward, phase 2 -------------------------------------------------

// G = C0 / 8 lanes a row (b, m), lane l holding channels [8 l, 8 l + 8).
template <int G>
__global__ void __launch_bounds__(kSumThreads)
    edge_mlp_bwd_sum_kernel(const __nv_bfloat16* __restrict__ e,
                            const double* __restrict__ self_sum,
                            const int* __restrict__ offsets,
                            const int* __restrict__ edges,
                            float* __restrict__ dy, long long rows, int N,
                            int K) {
  constexpr int C0 = 8 * G;
  const long long r =
      ((long long)blockIdx.x * kSumThreads + threadIdx.x) / G;
  if (r >= rows) return;  // the whole group
  const int l = threadIdx.x % G;
  const unsigned group =
      (G == 32 ? 0xffffffffu : ((1u << G) - 1u))
      << ((threadIdx.x % 32) & ~(G - 1));
  const long long b = r / N;
  const int m = (int)(r - b * N);
  const int start = offsets[b * (N + 1) + m], end = offsets[b * (N + 1) + m + 1];
  const int* list = edges + b * N * K;
  const __nv_bfloat16* eb = e + b * K * N * C0 + l * 8;
  double acc[8];
  {
    const double2* s = reinterpret_cast<const double2*>(self_sum + r * C0 +
                                                        l * 8);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const double2 v = s[i];
      acc[2 * i] = __dsub_rn(0.0, v.x);
      acc[2 * i + 1] = __dsub_rn(0.0, v.y);
    }
  }
  for (int i0 = start; i0 < end; i0 += G) {
    long long mine = -1;  // lane l: the e row of the group's l-th edge
    if (i0 + l < end) {
      const int ed = list[i0 + l];
      const int n = ed / K, k = ed - n * K;
      if (k != 0) mine = ((long long)k * N + n) * C0;
    }
    const int cnt = min(G, end - i0);
    for (int q0 = 0; q0 < cnt; q0 += kSumAhead) {
      uint4 v[kSumAhead];
      bool on[kSumAhead];
#pragma unroll
      for (int q = 0; q < kSumAhead; ++q) {
        const long long at = __shfl_sync(group, mine, (q0 + q) % G, G);
        on[q] = q0 + q < cnt && at >= 0;
        v[q] = on[q] ? __ldcs(reinterpret_cast<const uint4*>(eb + at))
                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int q = 0; q < kSumAhead; ++q) {
        if (!on[q]) continue;
        const uint32_t w[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[2 * i] += (double)bf_lo(w[i]);
          acc[2 * i + 1] += (double)bf_hi(w[i]);
        }
      }
    }
  }
  float4* o = reinterpret_cast<float4*>(dy + r * C0 + l * 8);
  o[0] = make_float4(__double2float_rn(acc[0]), __double2float_rn(acc[1]),
                     __double2float_rn(acc[2]), __double2float_rn(acc[3]));
  o[1] = make_float4(__double2float_rn(acc[4]), __double2float_rn(acc[5]),
                     __double2float_rn(acc[6]), __double2float_rn(acc[7]));
}

// ---- launches ----------------------------------------------------------

int log2_tiles(int c) {  // 16, 32, 64, 128 -> 0, 1, 2, 3; else -1
  for (int i = 0; i < 4; ++i)
    if (c == 16 << i) return i;
  return -1;
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

struct FwdArgs {
  const void *y, *idx, *ab, *w1, *z0;
  void* out;
  int B, N, K;
  cudaStream_t s;
};

template <int T0, int T1>
int launch_fwd(const FwdArgs& a) {
  const size_t smem = FwdShape<T0, T1>::bytes(a.K);
  const cudaError_t err = set_smem(
      reinterpret_cast<const void*>(edge_mlp_fwd_kernel<T0, T1>), smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)a.B * ((a.N + kTile - 1) / kTile);
  edge_mlp_fwd_kernel<T0, T1><<<(unsigned)blocks, kFwdWarps * 32, smem, a.s>>>(
      (const __nv_bfloat16*)a.y, (const int*)a.idx, (const float*)a.ab,
      (const __nv_bfloat16*)a.w1, (const float*)a.z0, (__nv_bfloat16*)a.out,
      a.N, a.K);
  return (int)cudaGetLastError();
}

struct BwdArgs {
  const void *y, *idx, *ab, *w1, *g;
  void *e, *self, *dw1_part, *dab_part;
  int B, N, K, blocks;
  cudaStream_t s;
};

template <int T0, int T1>
int launch_bwd(const BwdArgs& a) {
  const size_t smem = BwdShape<T0, T1>::bytes(a.K);
  const cudaError_t err = set_smem(
      reinterpret_cast<const void*>(edge_mlp_bwd_edges_kernel<T0, T1>), smem);
  if (err != cudaSuccess) return (int)err;
  edge_mlp_bwd_edges_kernel<T0, T1>
      <<<a.blocks, 32 * T0 * bwd_groups(T0, T1), smem, a.s>>>(
      (const __nv_bfloat16*)a.y, (const int*)a.idx, (const float*)a.ab,
      (const __nv_bfloat16*)a.w1, (const __nv_bfloat16*)a.g,
      (__nv_bfloat16*)a.e, (double*)a.self, (float*)a.dw1_part,
      (float*)a.dab_part, a.B, a.N, a.K);
  return (int)cudaGetLastError();
}

// The widths' instantiation: t0, t1 the log2 of C0 / 16 and C1 / 16.
template <template <int, int> class L, typename A>
int dispatch(int t0, int t1, const A& a) {
#define DC_EDGE_T1(T0)                          \
  switch (t1) {                                 \
    case 0: return L<T0, 1>::run(a);            \
    case 1: return L<T0, 2>::run(a);            \
    case 2: return L<T0, 4>::run(a);            \
    default: return L<T0, 8>::run(a);           \
  }
  switch (t0) {
    case 0: DC_EDGE_T1(1)
    case 1: DC_EDGE_T1(2)
    case 2: DC_EDGE_T1(4)
    default: DC_EDGE_T1(8)
  }
#undef DC_EDGE_T1
  return (int)cudaErrorInvalidValue;
}

template <int T0, int T1>
struct FwdLaunch {
  static int run(const FwdArgs& a) { return launch_fwd<T0, T1>(a); }
};

template <int T0, int T1>
struct BwdLaunch {
  static int run(const BwdArgs& a) { return launch_bwd<T0, T1>(a); }
};

}  // namespace

extern "C" int dc_edge_mlp_fwd(const void* y, const void* idx, const void* ab,
                               const void* w1, const void* z0, void* out,
                               int B, int N, int K, int C0, int C1,
                               int device, void* stream) {
  DC_SET_DEVICE(device);
  const int t0 = log2_tiles(C0), t1 = log2_tiles(C1);
  if (K < 1 || t0 < 0 || t1 < 0) return (int)cudaErrorInvalidValue;
  if ((long long)B * N == 0) return (int)cudaGetLastError();
  return dispatch<FwdLaunch>(
      t0, t1, FwdArgs{y, idx, ab, w1, z0, out, B, N, K, (cudaStream_t)stream});
}

// e [B, K, N, C0] bf16 (slot 0 not written), self [B, N, C0] f64;
// blocks: the grid, the rows of the partials ([blocks, C0, C1] and
// [blocks, 2, C0] f32), each written whole.
extern "C" int dc_edge_mlp_bwd_edges(const void* y, const void* idx,
                                     const void* ab, const void* w1,
                                     const void* g, void* e, void* self,
                                     void* dw1_part, void* dab_part, int B,
                                     int N, int K, int C0, int C1, int blocks,
                                     int device, void* stream) {
  DC_SET_DEVICE(device);
  const int t0 = log2_tiles(C0), t1 = log2_tiles(C1);
  if (K < 1 || blocks < 1 || t0 < 0 || t1 < 0)
    return (int)cudaErrorInvalidValue;
  return dispatch<BwdLaunch>(
      t0, t1, BwdArgs{y, idx, ab, w1, g, e, self, dw1_part, dab_part, B, N, K,
                      blocks, (cudaStream_t)stream});
}

// offsets [B, N + 1], edges [B, N K]: the inverse adjacency of the
// clamped indices; dy [B, N, C0] f32 written whole.
extern "C" int dc_edge_mlp_bwd_sum(const void* e, const void* self,
                                   const void* offsets, const void* edges,
                                   void* dy, int B, int N, int K, int C0,
                                   int device, void* stream) {
  DC_SET_DEVICE(device);
  const int t0 = log2_tiles(C0);
  if (K < 1 || t0 < 0) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * N;
  if (rows == 0) return (int)cudaGetLastError();
  const int G = C0 / 8;
  const unsigned blocks =
      (unsigned)((rows * G + kSumThreads - 1) / kSumThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const __nv_bfloat16* ep = (const __nv_bfloat16*)e;
  const double* sp = (const double*)self;
  const int *op = (const int*)offsets, *lp = (const int*)edges;
  float* dp = (float*)dy;
  switch (G) {
    case 2:
      edge_mlp_bwd_sum_kernel<2><<<blocks, kSumThreads, 0, s>>>(
          ep, sp, op, lp, dp, rows, N, K);
      break;
    case 4:
      edge_mlp_bwd_sum_kernel<4><<<blocks, kSumThreads, 0, s>>>(
          ep, sp, op, lp, dp, rows, N, K);
      break;
    case 8:
      edge_mlp_bwd_sum_kernel<8><<<blocks, kSumThreads, 0, s>>>(
          ep, sp, op, lp, dp, rows, N, K);
      break;
    default:
      edge_mlp_bwd_sum_kernel<16><<<blocks, kSumThreads, 0, s>>>(
          ep, sp, op, lp, dp, rows, N, K);
  }
  return (int)cudaGetLastError();
}
