// kNN of query rows against a table (the point-sharded local kNN):
//
//   s(i, c) = 2 (q_i . p_c) - |q_i|^2 - |p_c|^2,  q_i = pos_q[i], p_c = pos_t[c]
//   idx[i, :] = the K table columns with the largest s(i, c)
// pos_q [Nq, 3] f32, pos_t [Nt, 3] f32, mask [Nt] u8 (or none), rows [Nq]
// i32 (the column that is row i's own point) -> idx [Nq, K] i32.
//
// Replaces the Pallas kernel of deltaconv_tpu/ops/knn_topk.py
// (`knn_topk_table`, pallas_call at knn_topk.py:326) in both of its bodies.
// The columns are cut into tiles of `tile_c` (the TPU's 2048; the last
// tile padded with masked columns Nt, Nt + 1, ...):
//
// * exact (`_table_kernel`): the self column scores +2e30 and a masked
//   column -2e30; the order is score descending, then column ascending.
//   The TPU kernel's running top-K after the last tile is the top-K of all
//   columns in that order (for scores above -2e30).
// * quantized (`_table_kernel_q`): within each tile the row's VALID
//   scores (unmasked, not self) are mapped linearly onto 1..65534, the
//   masked columns take 0 (fillers) and the self column 0x7FFF, packed
//   with the local column as ((q - 32768) << 16) | (65535 - l); the
//   tile's K best keys are dequantized (self +2e30, fillers -2e30; a
//   valid key as fma((q - 1) span, 1 / 65533, rmin), the order in which
//   XLA evaluates the JAX kernel's rmin + (q - 1) / scale) and merged
//   across tiles by (score descending, column ascending). The
//   answer depends on the tiling: it is the TPU kernel's function at the
//   same tile_c, which the wrapper passes.
//
// Every score is computed in the JAX kernel's order with each operation
// rounded where XLA rounds it: XLA contracts a product into the sum that
// follows it, so q . p = fma(qz, pz, fma(qx, px, qy py)) and |p|^2 =
// fma(z, z, fma(y, y, x x)), every other operation rounded on its own
// (__fmul_rn/__fadd_rn elsewhere; 2 (q . p) is exact, so fma(2, q . p,
// -|q|^2) rounds as the multiply and subtract do), and the indices are
// bit-equal to the plain version's.
//
// Design: two kernels a call. `knn_table_select_kernel` takes one task
// per (query row, column tile): a block holds 256 query rows and one tile,
// staged in shared memory as (x, y, z, |p|^2) with a NaN norm on masked
// and padded columns (32 KB at tile_c=2048), and a thread a task keeps a
// sorted register list of the tile's best (topk_select.cuh); a candidate
// is compared once with its threshold, 32 a step into a bit mask, and
// only those that pass are walked, in step across the warp, queued and
// inserted. The quantized body makes two passes over the staged tile (the
// task's range, then the keys, a key passing only if its score reaches a
// floor derived from the threshold's level). Each task writes its K best,
// dequantized, to `part` [n_tiles, K, Nq]; `knn_table_merge_kernel`
// merges a row's n_tiles lists by (score descending, column ascending), a
// thread a row. The TPU kernel walked the column tiles in sequence with a
// running list in VMEM scratch; here the tiles are independent tasks (4 a
// row at Nt = 8192, 32 in the 65,536-column repair form), which fills the
// card where a thread a row over all tiles would leave it idle.
//
// Bound on the H100: instruction issue, not memory. The kernel reads
// (Nq + Nt) 12 bytes and writes Nq K 4 bytes, but every (row, column)
// pair needs its score (6 operations) and a compare, the quantized body
// the range too.
#include "common.cuh"
#include "topk_select.cuh"

#include <climits>
#include <cmath>

namespace {

using dc_select::kFull;
using dc_select::score_floor;

constexpr int kThreads = 256;  // tasks (query rows of a tile) a block
constexpr int kStep = 32;  // candidates a thread scores a step
constexpr int kMergeSplit = 4;  // threads a row in the merge
constexpr int kMergeRows = kThreads / kMergeSplit;
constexpr int kMaxTile = 2048;
constexpr float kBig = 1e30f;
constexpr float kInvLevels = 1.0f / 65533.0f;

template <bool kQuantized, int kCap>
using TileSel = dc_select::Selector<
    kQuantized ? dc_select::kKey : dc_select::kScoreId, kCap>;
template <int kCap>
using RowSel = dc_select::Selector<dc_select::kScoreId, kCap, kMergeSplit>;

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

// 2 (q . p) - |q|^2 - |p|^2 in the order of the JAX kernel (knn_topk.py:151);
// q.w and p.w hold the squared norms.
__device__ __forceinline__ float table_score(float4 q, float4 p) {
  const float dot =
      __fmaf_rn(q.z, p.z, __fmaf_rn(q.x, p.x, __fmul_rn(q.y, p.y)));
  return __fsub_rn(__fmaf_rn(2.0f, dot, -q.w), p.w);
}

template <bool kQuantized, int kCap>
__global__ void __launch_bounds__(kThreads, 1)
    knn_table_select_kernel(const float* __restrict__ pos_q,
                            const float* __restrict__ pos_t,
                            const unsigned char* __restrict__ mask,
                            const int* __restrict__ rows,
                            float* __restrict__ part_s,
                            int* __restrict__ part_i, int Nq, int Nt, int K,
                            int tile_c) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* pts = reinterpret_cast<float4*>(smem);
  unsigned char* queue = smem + (size_t)tile_c * sizeof(float4);
  const int tile = blockIdx.y, c0 = tile * tile_c;
  for (int l = threadIdx.x; l < tile_c; l += blockDim.x) {
    const int c = c0 + l;
    float4 p = make_float4(0.0f, 0.0f, 0.0f, NAN);  // masked or padding
    if (c < Nt && (mask == nullptr || mask[c])) {
      p.x = pos_t[3 * c];
      p.y = pos_t[3 * c + 1];
      p.z = pos_t[3 * c + 2];
      p.w = sq3(p.x, p.y, p.z);
    }
    pts[l] = p;
  }
  __syncthreads();

  const int tid = threadIdx.x;
  const int row = blockIdx.x * kThreads + tid;
  // A row past Nq runs as row 0 and writes nothing: every lane meets the
  // warp's votes.
  const bool live = row < Nq;
  const int rr = live ? row : 0;
  float4 q;
  q.x = pos_q[3 * rr];
  q.y = pos_q[3 * rr + 1];
  q.z = pos_q[3 * rr + 2];
  q.w = sq3(q.x, q.y, q.z);
  // The self column's local index (outside [0, tile_c) when not here).
  const int sl = rows[rr] - c0;
  const bool self_here = 0 <= sl && sl < tile_c;
  // A masked self column is an ordinary masked one in the exact body;
  // the quantized body keys it as self all the same.
  const bool self_pinned =
      self_here && (kQuantized || !isnan(pts[self_here ? sl : 0].w));

  TileSel<kQuantized, kCap> sel;
  sel.init(K, queue, kThreads, tid);
  float rmin = 0.0f, span = 0.0f, scale = 0.0f;
  if (kQuantized) {  // the task's range over its valid columns
    float lo = INFINITY, hi = -INFINITY;
    for (int base = 0; base < tile_c; base += kStep) {
      float v[kStep];
#pragma unroll
      for (int u = 0; u < kStep; ++u) v[u] = table_score(q, pts[base + u]);
      // The self column is left out (NaN: fminf/fmaxf ignore it, as they
      // do the masked columns' NaN scores).
      const int d = sl - base;
      if (self_here && 0 <= d && d < kStep) {
#pragma unroll
        for (int u = 0; u < kStep; ++u)
          if (d == u) v[u] = NAN;
      }
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        lo = fminf(lo, v[u]);
        hi = fmaxf(hi, v[u]);
      }
    }
    rmin = isfinite(lo) ? lo : 0.0f;
    const float rmax = isfinite(hi) ? hi : 0.0f;
    span = fmaxf(__fsub_rn(rmax, rmin), 1e-30f);
    scale = __fdiv_rn(65533.0f, span);
  }
  // The self loop is pinned: the list starts with it, and the scan skips
  // it.
  if (self_pinned)
    sel.add(2.0f * kBig, 0x7FFF0000 | (65535 - sl), c0 + sl);
  sel.refresh();

  // A necessary condition of passing the threshold: the score reaches
  // the exact threshold's score, or the floor of the key level that can
  // pass (q = trunc(t) + 1 >= the last key's level). While the threshold
  // is at a masked column's -2e30 (or a filler key), every column goes to
  // the exact compare: a masked column (NaN score) may still pass.
  float thr;
  bool starved;
  auto threshold = [&]() {
    if (kQuantized) {
      starved = !(sel.min_t >= 0.0f);
      thr = score_floor(rmin, scale, sel.min_t);
    } else {
      starved = !(sel.thr_s() > -2.0f * kBig);
      thr = sel.thr_s();
    }
  };
  threshold();
  for (int base = 0; base < tile_c; base += kStep) {
    unsigned maybe = starved ? ~0u : 0u;
#pragma unroll
    for (int u = 0; u < kStep; ++u)
      maybe |= (table_score(q, pts[base + u]) >= thr ? 1u : 0u) << u;
    // The rare path, in step across the warp: one candidate a lane at a
    // time, its score recomputed, the queues merged when one fills.
    while (__any_sync(kFull, maybe)) {
      if (maybe) {
        const int l = base + __ffs(maybe) - 1;
        maybe &= maybe - 1;
        const float v = table_score(q, pts[l]);
        const bool masked = isnan(v);
        const bool skip = self_pinned && l == sl;
        if (kQuantized) {
          int qs = 0;  // a filler's level
          if (!masked) {
            const float t = __fmul_rn(__fsub_rn(v, rmin), scale);
            qs = min(max(__float2int_rz(t) + 1, 1), 65534);
          }
          const int key = (int)((unsigned)(qs - 32768) << 16) | (65535 - l);
          if (!skip && sel.passes(0.0f, key, 0)) sel.push(0.0f, key, 0);
        } else {
          const float vs = masked ? -2.0f * kBig : v;
          if (!skip && sel.passes(vs, 0, c0 + l)) sel.push(vs, 0, c0 + l);
        }
      }
      if (__any_sync(kFull, sel.qn > dc_select::kFlushAt)) {
        sel.flush();
        threshold();
      }
    }
  }
  sel.flush();

  // The task's K best in order, dequantized, to part[tile, r, row].
  sel.front(K);
  for (int r = 0; r < K; ++r) {
    float v = 0.0f;
    int key = 0, o = 0;
    sel.take(v, key, o);
    if (kQuantized) {
      // rmin + (qb - 1) / scale as XLA evaluates the JAX kernel's: the
      // division by 65533 / span becomes a product with span, then with
      // 1 / 65533, fused with the add.
      const int qb = (key >> 16) + 32768;
      v = qb == 65535 ? 2.0f * kBig
                      : (qb == 0 ? -2.0f * kBig
                                 : __fmaf_rn(__fmul_rn((float)(qb - 1), span),
                                             kInvLevels, rmin));
      o = c0 + 65535 - (key & 65535);
    }
    if (live) {
      const long long at = ((long long)tile * K + r) * Nq + row;
      part_s[at] = v;
      part_i[at] = o;
    }
  }
}

// A row's n_tiles lists merged by (score descending, column ascending):
// thread s of the row's 4 inserts the lists of tiles s, s + 4, ... into
// its own list, and the four lists are walked in order (topk_select.cuh's
// group: K rounds of "the best head, popped").
template <int kCap>
__global__ void __launch_bounds__(kThreads, 1)
    knn_table_merge_kernel(const float* __restrict__ part_s,
                           const int* __restrict__ part_i,
                           int* __restrict__ out, int Nq, int K,
                           int n_tiles) {
  const int tid = threadIdx.x, sub = tid % kMergeSplit;
  const int row = blockIdx.x * kMergeRows + tid / kMergeSplit;
  const bool live = row < Nq;
  RowSel<kCap> sel;
  sel.init(K, nullptr, kThreads, tid);
  if (live) {
    for (int t = sub; t < n_tiles; t += kMergeSplit) {
      for (int r = 0; r < K; ++r) {
        const long long at = ((long long)t * K + r) * Nq + row;
        const float v = part_s[at];
        const int o = part_i[at];
        if (sel.passes(v, 0, o)) sel.add(v, 0, o);
      }
    }
  }
  sel.front(K);
  for (int r = 0; r < K; ++r) {
    float v = 0.0f;
    int key = 0, o = 0;
    sel.take(v, key, o);
    if (live && r % kMergeSplit == sub) out[(long long)row * K + r] = o;
  }
}

template <bool kQuantized, int kCap>
int launch_cap(const void* pos_q, const void* pos_t, const void* mask,
               const void* rows, void* part_s, void* part_i, void* idx,
               int Nq, int Nt, int K, int tile_c, cudaStream_t stream) {
  auto select = knn_table_select_kernel<kQuantized, kCap>;
  const size_t smem =
      (size_t)tile_c * sizeof(float4) +
      (size_t)dc_select::kQueue * TileSel<kQuantized, kCap>::kEntryBytes *
          kThreads;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        select, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_tiles = (Nt + tile_c - 1) / tile_c;
  const int row_blocks = (Nq + kThreads - 1) / kThreads;
  select<<<dim3(row_blocks, n_tiles), kThreads, smem, stream>>>(
      (const float*)pos_q, (const float*)pos_t, (const unsigned char*)mask,
      (const int*)rows, (float*)part_s, (int*)part_i, Nq, Nt, K, tile_c);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  knn_table_merge_kernel<kCap><<<(Nq + kMergeRows - 1) / kMergeRows,
                                  kThreads, 0, stream>>>(
      (const float*)part_s, (const int*)part_i, (int*)idx, Nq, K, n_tiles);
  return (int)cudaGetLastError();
}

template <bool kQuantized>
int launch_table(const void* pos_q, const void* pos_t, const void* mask,
                 const void* rows, void* part_s, void* part_i, void* idx,
                 int Nq, int Nt, int K, int tile_c, int device,
                 void* stream) {
  DC_SET_DEVICE(device);
  if (K <= 0 || K > 32 || tile_c < K || tile_c > kMaxTile ||
      tile_c % kStep != 0 || Nt <= 0)
    return (int)cudaErrorInvalidValue;
  if (Nq == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (K <= 20)
    return launch_cap<kQuantized, 20>(pos_q, pos_t, mask, rows, part_s,
                                      part_i, idx, Nq, Nt, K, tile_c, s);
  return launch_cap<kQuantized, 32>(pos_q, pos_t, mask, rows, part_s,
                                    part_i, idx, Nq, Nt, K, tile_c, s);
}

}  // namespace

// The wrapper checks 0 < K <= 32, K <= tile_c <= 2048, tile_c % 32 == 0,
// and allocates part_s [n_tiles, K, Nq] f32 and part_i [n_tiles, K, Nq]
// i32, n_tiles = ceil(Nt / tile_c).
extern "C" int dc_knn_topk_table(const void* pos_q, const void* pos_t,
                                 const void* mask, const void* rows,
                                 void* part_s, void* part_i, void* idx,
                                 int Nq, int Nt, int K, int tile_c, int device,
                                 void* stream) {
  return launch_table<false>(pos_q, pos_t, mask, rows, part_s, part_i, idx,
                             Nq, Nt, K, tile_c, device, stream);
}

extern "C" int dc_knn_topk_table_q(const void* pos_q, const void* pos_t,
                                   const void* mask, const void* rows,
                                   void* part_s, void* part_i, void* idx,
                                   int Nq, int Nt, int K, int tile_c,
                                   int device, void* stream) {
  return launch_table<true>(pos_q, pos_t, mask, rows, part_s, part_i, idx,
                            Nq, Nt, K, tile_c, device, stream);
}
