// Candidate sweep of the Morton-bucketed kNN: for each query of a query
// tile, the K - 1 best columns among its tile's candidate buckets.
//
// The table is Morton-sorted and cut into buckets of `tile_c` columns:
// comb [nb, 4, tile_c] f32 holds each bucket's x, y, z and |p|^2 (4e30
// on invalid columns, so that their scores sink to about -4e30), perm
// [nb * tile_c] i32 the original id of each sorted column. Queries come
// Morton-sorted in tiles of `tile_q`: posq [nqp, 3], sqq [nqp] (|q|^2),
// srow [nqp] (the original id of the query's own column, or -1) and cand
// [nqt, m] (the tile's candidate buckets). A query's candidate plane is
// the concatenation of its tile's m buckets, W = m * tile_c lanes, lane
// j * tile_c + l being column l of bucket cand[t, j]; its scores are
//   s = 2 (q . p) - |p|^2 - |q|^2
// in the order of the JAX kernel's `_scores` (knn_bucketed.py:91-103).
// -> idx [nqp, K - 1] i32 original ids, sc [nqp, K - 1] f32 scores.
//
// Replaces the Pallas kernel of deltaconv_tpu/ops/knn_bucketed.py
// (`knn_topk_bucketed`, pallas_call at knn_bucketed.py:318) in both of its
// bodies:
//
// * exact (`_cand_kernel`): the K - 1 best lanes by (score descending,
//   original id ascending), the self column excluded (-3e38);
// * quantized (`_cand_kernel_q`): the row's valid scores (s > -1e29, not
//   self) are mapped linearly onto 1..65534 over the WHOLE candidate
//   plane, invalid lanes take 0, and each key packs the LANE,
//   ((q - 32768) << 16) | (65535 - lane), so equal quantized scores go to
//   the lowest lane (not the lowest id); the self lane is never picked.
//   The K - 1 best keys are dequantized, fillers to -2e30.
//
// In both bodies a winner that is an invalid column (a filler of a row
// with fewer valid candidates than K - 1) is emitted as `marker` (>= the
// table length), not as its original id: a masked real point never
// appears in the output. (The JAX kernels emit the filler's own id.)
//
// Every score rounds where XLA rounds the JAX kernel's: q . p =
// fma(qz, pz, fma(qx, px, qy py)), the rest operation by operation, so
// the ids are bit-equal to the plain version's.
//
// Design: one block of 16 warps per query tile. The TPU pregathered the
// candidate planes of every tile into device memory (comb[cand], ~100 MB
// at N=65,536) for its DMA engine; here the block reads its m buckets
// straight from the sorted table into shared memory (20 bytes a lane:
// 120 KB at m=24, 160 KB at m=32, tile_c=256) and each warp sweeps the
// plane for its rows. A lane keeps the 32 best of its W/32 lanes in a
// sorted register list (insertion below the list's last entry, which
// soon stops most lanes), and K - 1 rounds of a warp reduction over the
// list heads merge the 32 lists. Nothing of the [nq, W] score planes
// reaches device memory.
//
// Bound on the H100: instruction issue. The kernel reads the sorted table
// once per query tile (from L2: 1 MB at N=65,536) and writes 8 bytes per
// winner; every (query, candidate lane) pair needs its score (8
// operations) and a compare, the quantized body a second pass for the
// row's range and the key.
#include "common.cuh"

#include <climits>
#include <cmath>

namespace {

constexpr int kWarps = 16;      // warps of a block (one query tile)
constexpr int kCap = 32;        // per-lane candidate list, >= K - 1
constexpr float kBig = 1e30f;
constexpr float kEmpty = -3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float cand_score(float qx, float qy, float qz,
                                            float sq, float4 p) {
  const float dot = __fmaf_rn(qz, p.z, __fmaf_rn(qx, p.x, __fmul_rn(qy, p.y)));
  return __fsub_rn(__fsub_rn(__fmul_rn(2.0f, dot), p.w), sq);
}

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

template <bool kQuantized>
__global__ void __launch_bounds__(kWarps * 32)
    knn_cand_kernel(const float* __restrict__ posq,
                    const float* __restrict__ sqq,
                    const int* __restrict__ srow,
                    const float* __restrict__ comb,
                    const int* __restrict__ perm,
                    const int* __restrict__ cand, int* __restrict__ idx_out,
                    float* __restrict__ sc_out, int tile_q, int tile_c, int m,
                    int ks, int marker) {
  extern __shared__ float4 plane[];  // [W] (x, y, z, |p|^2), then [W] ids
  const int W = m * tile_c;
  int* orig = reinterpret_cast<int*>(plane + W);
  const int qt = blockIdx.x;
  for (int l = threadIdx.x; l < W; l += blockDim.x) {
    const int j = l / tile_c, c = l - j * tile_c;
    const long long b = cand[(long long)qt * m + j];
    const float* cb = comb + b * 4 * tile_c;
    plane[l] = make_float4(cb[c], cb[tile_c + c], cb[2 * tile_c + c],
                           cb[3 * tile_c + c]);
    orig[l] = perm[b * tile_c + c];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < tile_q; r += kWarps) {
    const long long row = (long long)qt * tile_q + r;
    const float qx = posq[3 * row], qy = posq[3 * row + 1],
                qz = posq[3 * row + 2];
    const float sq = sqq[row];
    const int self = srow[row];
    int* orow = idx_out + row * ks;
    float* srow_out = sc_out + row * ks;

    if (!kQuantized) {
      float ls[kCap];
      int li[kCap];
#pragma unroll
      for (int t = 0; t < kCap; ++t) {
        ls[t] = -INFINITY;
        li[t] = INT_MAX;
      }
      for (int l = lane; l < W; l += 32) {
        const int o = orig[l];
        const float v = o == self ? kEmpty : cand_score(qx, qy, qz, sq,
                                                        plane[l]);
        if (!before(v, o, ls[kCap - 1], li[kCap - 1])) continue;
#pragma unroll
        for (int t = kCap - 1; t > 0; --t) {
          if (before(v, o, ls[t - 1], li[t - 1])) {
            ls[t] = ls[t - 1];
            li[t] = li[t - 1];
          } else if (before(v, o, ls[t], li[t])) {
            ls[t] = v;
            li[t] = o;
          }
        }
        if (before(v, o, ls[0], li[0])) {
          ls[0] = v;
          li[0] = o;
        }
      }
      for (int r2 = 0; r2 < ks; ++r2) {
        float bs = ls[0];
        int bi = li[0];
        warp_best(bs, bi);
        if (lane == 0) {
          orow[r2] = bs > -1e29f ? bi : marker;
          srow_out[r2] = bs;
        }
        if (li[0] == bi && ls[0] == bs) {  // pop the winner's head
#pragma unroll
          for (int t = 0; t < kCap - 1; ++t) {
            ls[t] = ls[t + 1];
            li[t] = li[t + 1];
          }
          ls[kCap - 1] = -INFINITY;
          li[kCap - 1] = INT_MAX;
        }
      }
    } else {
      float lo = INFINITY, hi = -INFINITY;
      for (int l = lane; l < W; l += 32) {
        const float v = cand_score(qx, qy, qz, sq, plane[l]);
        if (v > -1e29f && orig[l] != self) {
          lo = fminf(lo, v);
          hi = fmaxf(hi, v);
        }
      }
      for (int o = 16; o; o >>= 1) {
        lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
        hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
      }
      const float rmin = isfinite(lo) ? lo : 0.0f;
      const float rmax = isfinite(hi) ? hi : 0.0f;
      const float scale =
          __fdiv_rn(65533.0f, fmaxf(__fsub_rn(rmax, rmin), 1e-30f));
      int lk[kCap];
#pragma unroll
      for (int t = 0; t < kCap; ++t) lk[t] = INT_MIN;
      for (int l = lane; l < W; l += 32) {
        if (orig[l] == self) continue;  // the self lane's key is INT_MIN
        const float v = cand_score(qx, qy, qz, sq, plane[l]);
        int qs = 0;
        if (v > -1e29f) {
          qs = __float2int_rz(__fmul_rn(__fsub_rn(v, rmin), scale)) + 1;
          qs = min(max(qs, 1), 65534);
        }
        const int key = (int)((unsigned)(qs - 32768) << 16) | (65535 - l);
        if (key <= lk[kCap - 1]) continue;
#pragma unroll
        for (int t = kCap - 1; t > 0; --t) {
          if (key > lk[t - 1])
            lk[t] = lk[t - 1];
          else if (key > lk[t])
            lk[t] = key;
        }
        if (key > lk[0]) lk[0] = key;
      }
      for (int r2 = 0; r2 < ks; ++r2) {
        const int best = __reduce_max_sync(kFull, lk[0]);
        if (lane == 0) {
          const int qb = (best >> 16) + 32768;
          float st = __fadd_rn(rmin, __fdiv_rn((float)(qb - 1), scale));
          const bool empty = best == INT_MIN;
          orow[r2] = (empty || qb == 0) ? marker : orig[65535 - (best & 65535)];
          srow_out[r2] = empty ? kEmpty : (qb == 0 ? -2.0f * kBig : st);
        }
        if (lk[0] == best && best != INT_MIN) {
#pragma unroll
          for (int t = 0; t < kCap - 1; ++t) lk[t] = lk[t + 1];
          lk[kCap - 1] = INT_MIN;
        }
      }
    }
  }
}

template <bool kQuantized>
int launch_cand(const void* posq, const void* sqq, const void* srow,
                const void* comb, const void* perm, const void* cand,
                void* idx, void* sc, int nqt, int tile_q, int tile_c, int m,
                int ks, int marker, int device, void* stream) {
  DC_SET_DEVICE(device);
  if (nqt == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)m * tile_c * (sizeof(float4) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      knn_cand_kernel<kQuantized>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  knn_cand_kernel<kQuantized><<<nqt, kWarps * 32, smem,
                                (cudaStream_t)stream>>>(
      (const float*)posq, (const float*)sqq, (const int*)srow,
      (const float*)comb, (const int*)perm, (const int*)cand, (int*)idx,
      (float*)sc, tile_q, tile_c, m, ks, marker);
  return (int)cudaGetLastError();
}

}  // namespace

// The wrapper checks 0 < ks <= 32, m * tile_c <= 65535 and the shared
// memory (20 bytes a lane) against the card's 227 KB.
extern "C" int dc_knn_topk_bucketed(const void* posq, const void* sqq,
                                    const void* srow, const void* comb,
                                    const void* perm, const void* cand,
                                    void* idx, void* sc, int nqt, int tile_q,
                                    int tile_c, int m, int ks, int marker,
                                    int device, void* stream) {
  return launch_cand<false>(posq, sqq, srow, comb, perm, cand, idx, sc, nqt,
                            tile_q, tile_c, m, ks, marker, device, stream);
}

extern "C" int dc_knn_topk_bucketed_q(const void* posq, const void* sqq,
                                      const void* srow, const void* comb,
                                      const void* perm, const void* cand,
                                      void* idx, void* sc, int nqt,
                                      int tile_q, int tile_c, int m, int ks,
                                      int marker, int device, void* stream) {
  return launch_cand<true>(posq, sqq, srow, comb, perm, cand, idx, sc, nqt,
                           tile_q, tile_c, m, ks, marker, device, stream);
}
