// Candidate sweep of the Morton-bucketed kNN: for each query of a query
// tile, the K - 1 best columns among its tile's candidate buckets.
//
// The table is Morton-sorted and cut into buckets of `tile_c` columns:
// comb [nb, 4, ldc] f32 holds each bucket's x, y, z and |p|^2 (4e30 on
// invalid columns, so that their scores sink to about -4e30), perm
// [nb, ldc] i32 the original id of each sorted column (ldc >= tile_c, a
// multiple of 4: the wrapper pads). Queries come Morton-sorted in tiles
// of `tile_q`: posq [nqp, 3], sqq [nqp] (|q|^2), srow [nqp] (the original
// id of the query's own column, or -1) and cand [nqt, m] (the tile's
// candidate buckets). A query's candidate plane is the concatenation of
// its tile's m buckets, W = m * tile_c lanes, lane j * tile_c + l being
// column l of bucket cand[t, j]; its scores are
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
// Bound on the H100: instruction issue. The sweep reads the sorted table
// once per query tile (from L2: 1 MB at N=65,536) and writes 8 bytes per
// winner; every (query, candidate lane) pair needs its score and a
// compare, the quantized body a second pass for the key after the row's
// range.
//
// Design: a block per query tile, a thread per query (a candidate is one
// broadcast shared-memory read for all the tile's queries). The TPU
// pregathered every tile's candidate plane into device memory for its DMA
// engine; here the tile's buckets stream through a ring of 1-4 stages in
// shared memory (20 bytes a lane: 5 KB at tile_c=256), each bucket two
// `cp.async.bulk` copies (its comb block and its ids) issued by one thread
// and completed on the stage's mbarrier, so the next buckets load while
// one is scored; the quantized body streams the buckets twice (the row's
// range, then the keys). Selection against a threshold: each thread keeps
// its K - 1 best in a sorted register list with the threshold at a fixed
// last register, and a shared queue batches the warp's insertions
// (topk_select.cuh, shared with knn_topk.cu and knn_table.cu), so the warp
// pays one merge for up to 32 lanes' candidates instead of one per lane.
// The buckets come nearest first (the home bucket leads), so the
// threshold tightens in the first bucket; a later bucket whose box shows
// that none of its candidates can pass (for every query of a warp) is not
// scored at all, and the range pass skips the buckets whose scores cannot
// widen the range. The skips change no result: the ids and scores stay
// bit-equal to the plain version, which scores every lane.
#include "common.cuh"
#include "topk_select.cuh"

#include <algorithm>
#include <climits>
#include <cmath>

namespace {

using dc_select::kFlushAt;
using dc_select::kFull;
using dc_select::kQueue;

template <bool kQuantized, int kCap>
using Selector = dc_select::Selector<
    kQuantized ? dc_select::kKeyId : dc_select::kScoreId, kCap>;

constexpr float kBig = 1e30f;
constexpr float kEmpty = -3.0e38f;
constexpr int kMaxStages = 4;
constexpr size_t kStageBudget = 16 * 1024;  // the ring's bytes, many
                                            // blocks an SM
constexpr size_t kSmemMax = 232448;

__device__ __forceinline__ float cand_score(float qx, float qy, float qz,
                                            float sq, float px, float py,
                                            float pz, float pw) {
  const float dot = __fmaf_rn(qz, pz, __fmaf_rn(qx, px, __fmul_rn(qy, py)));
  return __fsub_rn(__fsub_rn(__fmul_rn(2.0f, dot), pw), sq);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

struct Ring {
  uint64_t* bar;
  unsigned char* stages;
  int n, ldc;
  size_t bytes;  // a stage: the comb block (16 ldc) and the ids (4 ldc)
};

// The position in the tile's candidate list of the bucket a step reads:
// nearest first; the quantized body's range pass takes the nearest, then
// the farthest, then the rest, so that its running min and max are wide
// early and the middle buckets can be skipped.
__device__ __forceinline__ int bucket_pos(int step, int m, bool quantized) {
  if (!quantized || step >= m) return step % m;
  return step == 0 ? 0 : (step == 1 ? m - 1 : step - 1);
}

// One thread starts the copy of step `step`'s bucket into its stage.
template <bool kQuantized>
__device__ __forceinline__ void issue(const Ring& r, int step,
                                      const float* comb, const int* perm,
                                      const int* cand_row, int m) {
  const long long b = cand_row[bucket_pos(step, m, kQuantized)];
  const int s = step % r.n;
  unsigned char* dst = r.stages + (size_t)s * r.bytes;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect_tx(&r.bar[s], (unsigned)r.bytes);
  bulk_load(dst, comb + b * 4 * r.ldc, 16u * r.ldc, &r.bar[s]);
  bulk_load(dst + 16 * r.ldc, perm + b * r.ldc, 4u * r.ldc, &r.bar[s]);
}

template <bool kQuantized, int kCap>
__global__ void __launch_bounds__(256, 1) knn_cand_kernel(
    const float* __restrict__ posq, const float* __restrict__ sqq,
    const int* __restrict__ srow, const float* __restrict__ comb,
    const int* __restrict__ perm, const int* __restrict__ cand,
    const float* __restrict__ box, int* __restrict__ idx_out,
    float* __restrict__ sc_out, int tile_q, int tile_c, int ldc, int m,
    int ks, int marker, int n_stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  Ring ring;
  ring.bar = reinterpret_cast<uint64_t*>(smem);
  ring.stages = smem + 16 * kMaxStages;
  ring.n = n_stages;
  ring.ldc = ldc;
  ring.bytes = (size_t)20 * ldc;
  const int qt = blockIdx.x, tid = threadIdx.x;
  const int* cand_row = cand + (long long)qt * m;
  const int steps = kQuantized ? 2 * m : m;
  if (tid == 0) {
    for (int s = 0; s < n_stages; ++s) mbar_init(&ring.bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < min(n_stages, steps); ++s)
      issue<kQuantized>(ring, s, comb, perm, cand_row, m);

  const bool live = tid < tile_q;
  const long long row = (long long)qt * tile_q + (live ? tid : 0);
  const float qx = posq[3 * row], qy = posq[3 * row + 1],
              qz = posq[3 * row + 2];
  const float sq = sqq[row];
  const int self = srow[row];

  Selector<kQuantized, kCap> sel;
  sel.init(ks, ring.stages + (size_t)n_stages * ring.bytes, blockDim.x,
           tid);
  float lo = INFINITY, hi = -INFINITY, rmin = 0.0f, scale = 0.0f;

  for (int step = 0; step < steps; ++step) {
    const int s = step % n_stages;
    mbar_wait(&ring.bar[s], (unsigned)(step / n_stages) & 1u);
    const float* pl = reinterpret_cast<const float*>(ring.stages +
                                                     (size_t)s * ring.bytes);
    const int* ids = reinterpret_cast<const int*>(pl + 4 * ldc);
    const bool range_pass = kQuantized && step < m;
    if (kQuantized && step == m) {  // the row's range, then its scale
      rmin = isfinite(lo) ? lo : 0.0f;
      const float rmax = isfinite(hi) ? hi : 0.0f;
      scale = __fdiv_rn(65533.0f, fmaxf(__fsub_rn(rmax, rmin), 1e-30f));
    }
    const int pos = bucket_pos(step, m, kQuantized);
    const int lane0 = pos * tile_c;
    // Skip the bucket when the whole warp can show from its box that no
    // candidate would change anything: every valid score lies below
    // smax = -(distance to the box)^2 + margin (and above smin =
    // -(farthest corner)^2 - margin), the margin 1e-5 (|q|^2 + max |p|^2)
    // covering the f32 rounding of the scores (a few ulps of that sum).
    // Exact: smax below the last entry of a list of valid candidates;
    // quantized keys: smax's level below it; the range: [smin, smax]
    // inside [lo, hi]. An empty box (no valid point) counts as skipped
    // only then, so filler lanes still fill rows that need them.
    bool skip = true;
    if (live) {
      const float* bx = box + 6 * (long long)cand_row[pos];
      float dmin2 = 0.0f, dmax2 = 0.0f, pmax2 = 0.0f;
      const float qc[3] = {qx, qy, qz};
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float blo = __ldg(bx + d), bhi = __ldg(bx + 3 + d);
        const float out = fmaxf(fmaxf(blo - qc[d], qc[d] - bhi), 0.0f);
        const float far = fmaxf(fabsf(qc[d] - blo), fabsf(qc[d] - bhi));
        dmin2 += out * out;
        dmax2 += far * far;
        pmax2 += fmaxf(blo * blo, bhi * bhi);
      }
      const bool empty = !(__ldg(bx) <= __ldg(bx + 3));
      const float margin = 1e-5f * (sq + pmax2) + 1e-30f;
      const float smax = margin - dmin2, smin = -dmax2 - margin;
      if (range_pass) {
        skip = empty || (smax <= hi && smin >= lo);
      } else if (kQuantized) {
        const bool full = sel.min_t >= 0.0f;  // the last key is a valid one
        skip = full && (empty || __fmul_rn(__fsub_rn(smax, rmin), scale) <
                                     sel.min_t);
      } else {
        const bool full = sel.thr_s() > -1e29f;
        skip = full && (empty || smax < sel.thr_s());
      }
    }
    const int span = __all_sync(kFull, skip) ? 0 : tile_c;
    // Eight candidates a step (two 16-byte loads of each plane), then one
    // vote on the queues. The common path is the score and one compare;
    // the self column and the exact key are settled on the rare pass.
    for (int c0 = 0; c0 < span; c0 += 8) {
      float ax[8], ay[8], az[8], aw[8];
      int ao[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + 4 * h;
        if (c < ldc) {
          const float4 px = *reinterpret_cast<const float4*>(pl + c);
          const float4 py = *reinterpret_cast<const float4*>(pl + ldc + c);
          const float4 pz =
              *reinterpret_cast<const float4*>(pl + 2 * ldc + c);
          const float4 pw =
              *reinterpret_cast<const float4*>(pl + 3 * ldc + c);
          const int4 po = *reinterpret_cast<const int4*>(ids + c);
          ax[4 * h] = px.x, ax[4 * h + 1] = px.y, ax[4 * h + 2] = px.z,
          ax[4 * h + 3] = px.w;
          ay[4 * h] = py.x, ay[4 * h + 1] = py.y, ay[4 * h + 2] = py.z,
          ay[4 * h + 3] = py.w;
          az[4 * h] = pz.x, az[4 * h + 1] = pz.y, az[4 * h + 2] = pz.z,
          az[4 * h + 3] = pz.w;
          aw[4 * h] = pw.x, aw[4 * h + 1] = pw.y, aw[4 * h + 2] = pw.z,
          aw[4 * h + 3] = pw.w;
          ao[4 * h] = po.x, ao[4 * h + 1] = po.y, ao[4 * h + 2] = po.z,
          ao[4 * h + 3] = po.w;
        } else {  // past the bucket (tile_c % 8 <= 4): never read
#pragma unroll
          for (int u = 4 * h; u < 4 * h + 4; ++u) {
            ax[u] = ay[u] = az[u] = aw[u] = 0.0f;
            ao[u] = -1;
          }
        }
      }
      // The eight scores first (independent chains), then the compares;
      // only a candidate that passes takes the branch.
      const int lim = live ? min(8, tile_c - c0) : 0;
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = cand_score(qx, qy, qz, sq, ax[u], ay[u], az[u], aw[u]);
      if (range_pass) {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const bool in = u < lim && v[u] > -1e29f && ao[u] != self;
          lo = in ? fminf(lo, v[u]) : lo;
          hi = in ? fmaxf(hi, v[u]) : hi;
        }
      } else {
        float t[8];
        unsigned pass = 0;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          // A necessary condition of passing the list's last entry.
          bool maybe;
          if (kQuantized) {
            t[u] = __fmul_rn(__fsub_rn(v[u], rmin), scale);
            maybe = !(v[u] > -1e29f) || t[u] >= sel.min_t;
          } else {
            maybe = v[u] >= sel.thr_s();
          }
          pass |= (unsigned)(u < lim && maybe) << u;
        }
        if (pass) {
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (!((pass >> u) & 1u)) continue;
            const int o = ao[u];
            if (kQuantized) {
              if (o == self) continue;  // the self lane is never picked
              int q = 0;  // an invalid lane's level
              if (v[u] > -1e29f)
                q = min(max(__float2int_rz(t[u]) + 1, 1), 65534);
              const int key = (int)((unsigned)(q - 32768) << 16) |
                              (65535 - (lane0 + c0 + u));
              if (sel.passes(0.0f, key, o)) sel.push(0.0f, key, o);
            } else {
              const float vs = o == self ? kEmpty : v[u];
              if (sel.passes(vs, 0, o)) sel.push(vs, 0, o);
            }
          }
        }
      }
      if (!range_pass && __any_sync(kFull, sel.qn > kFlushAt)) sel.flush();
    }
    __syncthreads();  // the stage is read: refill it
    if (tid == 0 && step + n_stages < steps)
      issue<kQuantized>(ring, step + n_stages, comb, perm, cand_row, m);
  }
  sel.flush();
  if (!live) return;

  // Entry t >= kCap - ks of the list is the query's (t - kCap + ks)-th.
  int* orow = idx_out + row * ks;
  float* srow_out = sc_out + row * ks;
#pragma unroll
  for (int t = 0; t < kCap; ++t) {
    const int r = t - (kCap - ks);
    if (r < 0) continue;  // the sentinels
    if (kQuantized) {
      const int best = sel.lk[t];
      const int qb = (best >> 16) + 32768;
      const bool empty = best == INT_MIN;
      orow[r] = (empty || qb == 0) ? marker : sel.li[t];
      srow_out[r] = empty ? kEmpty
                          : (qb == 0 ? -2.0f * kBig
                                     : __fadd_rn(rmin, __fdiv_rn(
                                                           (float)(qb - 1),
                                                           scale)));
    } else {
      orow[r] = sel.ls[t] > -1e29f ? sel.li[t] : marker;
      srow_out[r] = sel.ls[t];
    }
  }
}

template <bool kQuantized, int kCap>
int launch_cap(const void* posq, const void* sqq, const void* srow,
               const void* comb, const void* perm, const void* cand,
               const void* box, void* idx, void* sc, int nqt, int tile_q,
               int tile_c, int ldc, int m, int ks, int marker, int stages,
               size_t smem, cudaStream_t stream) {
  auto kernel = knn_cand_kernel<kQuantized, kCap>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<nqt, (tile_q + 31) / 32 * 32, smem, stream>>>(
      (const float*)posq, (const float*)sqq, (const int*)srow,
      (const float*)comb, (const int*)perm, (const int*)cand,
      (const float*)box, (int*)idx, (float*)sc, tile_q, tile_c, ldc, m, ks,
      marker, stages);
  return (int)cudaGetLastError();
}

template <bool kQuantized>
int launch_cand(const void* posq, const void* sqq, const void* srow,
                const void* comb, const void* perm, const void* cand,
                const void* box, void* idx, void* sc, int nqt, int tile_q,
                int tile_c, int ldc, int m, int ks, int marker, int device,
                void* stream) {
  DC_SET_DEVICE(device);
  if (ks <= 0 || ks > 32 || tile_q <= 0 || tile_q > 256 || m <= 0 ||
      tile_c <= 0 || ldc < tile_c || ldc % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (nqt == 0) return (int)cudaGetLastError();
  const size_t stage = (size_t)20 * ldc;
  const int steps = kQuantized ? 2 * m : m;
  int stages = (int)std::min<size_t>(kMaxStages, kStageBudget / stage);
  stages = std::max(1, std::min(stages, steps));
  const int threads = (tile_q + 31) / 32 * 32;
  const size_t smem =
      16 * kMaxStages + stage * stages +
      (size_t)kQueue * Selector<kQuantized, 32>::kEntryBytes * threads;
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define DC_KNN_CAP(cap)                                                     \
  return launch_cap<kQuantized, cap>(posq, sqq, srow, comb, perm, cand, box, \
                                     idx, sc, nqt, tile_q, tile_c, ldc, m,   \
                                     ks, marker, stages, smem, s)
  if (ks <= 20) DC_KNN_CAP(20);  // K = 20, the point-shard config
  DC_KNN_CAP(32);
#undef DC_KNN_CAP
}

}  // namespace

// The wrapper checks 0 < ks <= 32 and m * tile_c <= 65535 (the quantized
// key's lane) and pads the buckets to ldc, a multiple of 4 (16-byte bulk
// copies). box [nb, 6] f32: each bucket's box over its valid points (min
// x, y, z, then max; +inf, -inf when it has none).
extern "C" int dc_knn_topk_bucketed(const void* posq, const void* sqq,
                                    const void* srow, const void* comb,
                                    const void* perm, const void* cand,
                                    const void* box, void* idx, void* sc,
                                    int nqt, int tile_q, int tile_c, int ldc,
                                    int m, int ks, int marker, int device,
                                    void* stream) {
  return launch_cand<false>(posq, sqq, srow, comb, perm, cand, box, idx, sc,
                            nqt, tile_q, tile_c, ldc, m, ks, marker, device,
                            stream);
}

extern "C" int dc_knn_topk_bucketed_q(const void* posq, const void* sqq,
                                      const void* srow, const void* comb,
                                      const void* perm, const void* cand,
                                      const void* box, void* idx, void* sc,
                                      int nqt, int tile_q, int tile_c,
                                      int ldc, int m, int ks, int marker,
                                      int device, void* stream) {
  return launch_cand<true>(posq, sqq, srow, comb, perm, cand, box, idx, sc,
                           nqt, tile_q, tile_c, ldc, m, ks, marker, device,
                           stream);
}
