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
// tile padded with masked columns Nt, Nt + 1, ...), and every row keeps a
// running top-K across the tiles:
//
// * exact (`_table_kernel`): the self column scores +2e30 and a masked
//   column -2e30; the order is score descending, then column ascending.
//   The running top-K after the last tile is the top-K of all columns in
//   that order, which the kernel computes directly: each tile's K rounds
//   take the best of (the running list, the tile) and remove it.
// * quantized (`_table_kernel_q`): within each tile the row's VALID
//   scores (unmasked, not self) are mapped linearly onto 1..65534, the
//   masked columns take 0 (fillers) and the self column 0x7FFF, packed
//   with the local column as ((q - 32768) << 16) | (65535 - l); the
//   tile's K best keys are dequantized (self +2e30, fillers -2e30) and
//   merged with the running list by (score descending, column
//   ascending). The answer depends on the tiling: it is the TPU kernel's
//   function at the same tile_c, which the wrapper passes.
//
// Every score is computed in the JAX kernel's order with each operation
// rounded where XLA rounds it: XLA contracts a product into the sum that
// follows it, so q . p = fma(qz, pz, fma(qx, px, qy py)) and |p|^2 =
// fma(z, z, fma(y, y, x x)), every other operation rounded on its own
// (__fmul_rn/__fadd_rn elsewhere), and the indices are bit-equal to the
// plain version's.
//
// Design: one warp per query row, 8 rows per block. The block stages one
// tile of the table (x, y, z, |p|^2 and the mask; 34 KB at tile_c=2048)
// in shared memory, and each lane keeps its 64 scores or keys of the tile
// in registers; lane r holds entry r of the running list (K <= 32). A
// round is a scan of the lane's registers, one warp reduction of (score,
// column) pairs and a removal. The TPU kernel kept the running list in
// VMEM scratch across its sequential column grid; here the column loop
// runs inside the block, and nothing of the [Nq, Nt] score plane reaches
// device memory.
//
// Bound on the H100: instruction issue, not memory. The kernel reads
// (Nq + Nt) 12 bytes and writes Nq K 4 bytes, but every (row, column)
// pair needs its score (8 operations) and the selection compares it
// (K rounds a tile here; the function needs one pass).
#include "common.cuh"

#include <climits>
#include <cmath>

namespace {

constexpr int kRows = 8;          // query rows (warps) a block
constexpr int kMaxTile = 2048;    // columns of a staged tile
constexpr int kPerLane = kMaxTile / 32;
constexpr float kBig = 1e30f;
constexpr float kEmpty = -3.0e38f;  // the TPU kernel's empty scratch slot
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

// 2 (q . p) - |q|^2 - |p|^2 in the order of the JAX kernel (knn_topk.py:151);
// q.w and p.w hold the squared norms.
__device__ __forceinline__ float table_score(float4 q, float4 p) {
  const float dot = __fmaf_rn(q.z, p.z, __fmaf_rn(q.x, p.x, __fmul_rn(q.y, p.y)));
  return __fsub_rn(__fsub_rn(__fmul_rn(2.0f, dot), q.w), p.w);
}

// (s, i) comes before (t, j): score descending, then index ascending.
__device__ __forceinline__ bool before(float s, int i, float t, int j) {
  return s > t || (s == t && i < j);
}

__device__ __forceinline__ void warp_best(float& s, int& i) {
  for (int o = 16; o; o >>= 1) {
    const float t = __shfl_xor_sync(kFull, s, o);
    const int j = __shfl_xor_sync(kFull, i, o);
    if (before(t, j, s, i)) {
      s = t;
      i = j;
    }
  }
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The running list (lane r < K holds entry r) merged with `K` entries that
// each lane offers through `offer`/`take`: K rounds of "best of the
// union, then remove it", removal by index as in the TPU kernels.
template <typename Offer, typename Take>
__device__ __forceinline__ void merge_rounds(float& run_s, int& run_i, int K,
                                             int lane, Offer offer,
                                             Take take) {
  bool run_live = lane < K;
  float new_s = kEmpty;
  int new_i = 0;
  for (int r = 0; r < K; ++r) {
    float bs = run_live ? run_s : -INFINITY;
    int bi = run_live ? run_i : INT_MAX;
    offer(bs, bi);
    warp_best(bs, bi);
    if (lane == r) {
      new_s = bs;
      new_i = bi;
    }
    if (run_live && run_i == bi) run_live = false;
    take(bi);
  }
  run_s = new_s;
  run_i = new_i;
}

template <bool kQuantized>
__global__ void __launch_bounds__(kRows * 32)
    knn_table_kernel(const float* __restrict__ pos_q,
                     const float* __restrict__ pos_t,
                     const unsigned char* __restrict__ mask,
                     const int* __restrict__ rows, int* __restrict__ out,
                     int Nq, int Nt, int K, int tile_c, int n_tiles) {
  __shared__ float4 pts[kMaxTile];
  __shared__ unsigned char ok[kMaxTile];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRows + (threadIdx.x >> 5);
  const bool live = row < Nq;
  float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int self = -1;
  if (live) {
    q.x = pos_q[3 * row];
    q.y = pos_q[3 * row + 1];
    q.z = pos_q[3 * row + 2];
    q.w = sq3(q.x, q.y, q.z);
    self = rows[row];
  }
  // The TPU kernel's scratch starts at (-3e38, Nt).
  float run_s = kEmpty;
  int run_i = Nt;

  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * tile_c;
    __syncthreads();  // the previous tile is consumed
    for (int l = threadIdx.x; l < tile_c; l += blockDim.x) {
      const int c = c0 + l;
      if (c < Nt) {
        const float x = pos_t[3 * c], y = pos_t[3 * c + 1],
                    z = pos_t[3 * c + 2];
        pts[l] = make_float4(x, y, z, sq3(x, y, z));
        ok[l] = mask == nullptr ? 1 : mask[c];
      } else {
        pts[l] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        ok[l] = 0;
      }
    }
    __syncthreads();
    if (!live) continue;  // the warp still meets every barrier

    if (!kQuantized) {
      float s[kPerLane];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int l = lane + 32 * j;
        float v = -INFINITY;  // beyond the tile: never selected
        if (l < tile_c) {
          v = !ok[l] ? -2.0f * kBig
                     : (c0 + l == self ? 2.0f * kBig : table_score(q, pts[l]));
        }
        s[j] = v;
      }
      merge_rounds(
          run_s, run_i, K, lane,
          [&](float& bs, int& bi) {
#pragma unroll
            for (int j = 0; j < kPerLane; ++j) {
              const int c = c0 + lane + 32 * j;
              if (before(s[j], c, bs, bi)) {
                bs = s[j];
                bi = c;
              }
            }
          },
          [&](int bi) {
#pragma unroll
            for (int j = 0; j < kPerLane; ++j)
              if (c0 + lane + 32 * j == bi) s[j] = -INFINITY;
          });
    } else {
      // Per-row per-tile quantization over the valid scores.
      float s[kPerLane];
      float lo = INFINITY, hi = -INFINITY;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int l = lane + 32 * j;
        s[j] = 0.0f;
        if (l < tile_c && ok[l] && c0 + l != self) {
          s[j] = table_score(q, pts[l]);
          lo = fminf(lo, s[j]);
          hi = fmaxf(hi, s[j]);
        }
      }
      lo = warp_min(lo);
      hi = warp_max(hi);
      const float rmin = isfinite(lo) ? lo : 0.0f;
      const float rmax = isfinite(hi) ? hi : 0.0f;
      const float scale =
          __fdiv_rn(65533.0f, fmaxf(__fsub_rn(rmax, rmin), 1e-30f));
      int key[kPerLane];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int l = lane + 32 * j;
        const int low = 65535 - l;
        if (l >= tile_c) {
          key[j] = INT_MIN;
        } else if (c0 + l == self) {
          key[j] = 0x7FFF0000 | low;
        } else if (ok[l]) {
          int qs = __float2int_rz(__fmul_rn(__fsub_rn(s[j], rmin), scale)) + 1;
          qs = min(max(qs, 1), 65534);
          key[j] = (int)((unsigned)(qs - 32768) << 16) | low;
        } else {
          key[j] = INT_MIN | low;  // a filler, below every valid key
        }
      }
      // The tile's K best keys, dequantized: lane r holds entry r.
      float tile_s = kEmpty;
      int tile_i = Nt;
      for (int r = 0; r < K; ++r) {
        int m = INT_MIN;
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) m = max(m, key[j]);
        m = __reduce_max_sync(kFull, m);
#pragma unroll
        for (int j = 0; j < kPerLane; ++j)
          if (key[j] == m) key[j] = INT_MIN;
        if (lane == r && m != INT_MIN) {
          const int qb = (m >> 16) + 32768;
          float st = __fadd_rn(rmin, __fdiv_rn((float)(qb - 1), scale));
          if (qb == 65535) st = 2.0f * kBig;
          if (qb == 0) st = -2.0f * kBig;
          tile_s = st;
          tile_i = c0 + 65535 - (m & 65535);
        }
      }
      bool tile_live = lane < K;
      merge_rounds(
          run_s, run_i, K, lane,
          [&](float& bs, int& bi) {
            if (tile_live && before(tile_s, tile_i, bs, bi)) {
              bs = tile_s;
              bi = tile_i;
            }
          },
          [&](int bi) {
            if (tile_live && tile_i == bi) tile_live = false;
          });
    }
  }
  if (live && lane < K) out[(long long)row * K + lane] = run_i;
}

template <bool kQuantized>
int launch_table(const void* pos_q, const void* pos_t, const void* mask,
                 const void* rows, void* idx, int Nq, int Nt, int K,
                 int tile_c, int device, void* stream) {
  DC_SET_DEVICE(device);
  if (Nq == 0) return (int)cudaGetLastError();
  const int n_tiles = (Nt + tile_c - 1) / tile_c;
  const dim3 grid((Nq + kRows - 1) / kRows);
  knn_table_kernel<kQuantized><<<grid, kRows * 32, 0, (cudaStream_t)stream>>>(
      (const float*)pos_q, (const float*)pos_t, (const unsigned char*)mask,
      (const int*)rows, (int*)idx, Nq, Nt, K, tile_c, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// The wrapper checks 0 < K <= 32, K <= tile_c <= 2048, tile_c % 32 == 0.
extern "C" int dc_knn_topk_table(const void* pos_q, const void* pos_t,
                                 const void* mask, const void* rows, void* idx,
                                 int Nq, int Nt, int K, int tile_c, int device,
                                 void* stream) {
  return launch_table<false>(pos_q, pos_t, mask, rows, idx, Nq, Nt, K, tile_c,
                             device, stream);
}

extern "C" int dc_knn_topk_table_q(const void* pos_q, const void* pos_t,
                                   const void* mask, const void* rows,
                                   void* idx, int Nq, int Nt, int K,
                                   int tile_c, int device, void* stream) {
  return launch_table<true>(pos_q, pos_t, mask, rows, idx, Nq, Nt, K, tile_c,
                            device, stream);
}
