// Fused kNN: the pairwise scores of a cloud and the K best columns of
// every row, the self loop pinned to slot 0.
//
//   s(n, m) = 2 (q . p_m) - |p_m|^2,  q = pos[b, n], p_m = pos[b, m]
//   idx[b, n, :] = the K columns m with the largest s(n, m)
// pos [B, N, 3] f32 -> idx [B, N, K] i32 (N >= K); `dc_knn_topk_mean_dist`
// also writes md [B, N] f32, the mean Euclidean distance to the K
// winners (self counted as 0): the sum over the rounds, in round order,
// of sqrt(max(|q|^2 - s, 0)) with s the round's winning score (exact) or
// its key dequantized, rmin + ((key >> 16) + 32768) / scale (packed;
// round 0, the self loop, skipped), divided by K (JAX's
// `return_mean_dist`, knn_topk.py:48-69, 94-114).
//
// Replaces the Pallas kernel of deltaconv_tpu/ops/knn_topk.py (`knn_topk`,
// pallas_call at knn_topk.py:391) in both of its bodies:
//
// * exact (`_kernel`): the self column scores 2e30; K rounds each take
//   the row's maximum score, break a tie to the LOWEST column, and set
//   that column to -1e30: the K first columns by (score descending,
//   column ascending), for scores above -1e30.
// * packed (`_kernel_q`, quantized=True): the row's scores are mapped
//   linearly onto [0, 65534] by q = trunc((s - rmin) * 65534 /
//   max(rmax - rmin, 1e-30)) (rmin, rmax over the whole row, self
//   included) and packed with the column into one int32,
//   ((q - 32768) << 16) | (65535 - col); the self column becomes
//   0x7FFF0000 | (65535 - col). Keys are unique, so K rounds of "max,
//   then remove" pick the K largest keys in key order, ties going to the
//   lowest column. The caller takes the exact body above 65535 points.
//
// Every score is computed in the JAX kernel's order with each operation
// rounded on its own (__fmul_rn/__fadd_rn: no FMA contraction; 2 (q . p)
// is exact, so fma(2, q . p, -|p|^2) rounds as the multiply and subtract
// do), so the indices, and the mean distances, are bit-equal to the plain
// version's.
//
// Design (`knn_topk_select_kernel`, K <= 64): a block holds 256 query
// rows of one cloud, a thread a row. It stages the cloud's points as (x,
// y, z, |p|^2) in shared memory (|p|^2 once a point), the whole cloud at
// once up to 8192 points (128 KB) and tiles of 8192 above, and every
// thread reads each staged point as a shared-memory broadcast. A thread
// keeps its row's best in a sorted register list (topk_select.cuh) and
// compares each candidate once with its threshold, 32 candidates a step
// into a bit mask; the few that pass are walked in step across the warp
// (score recomputed, exact key compared, queued), and the warp merges its
// queues when one fills: about K + K ln(N / K) insertions a row. The
// packed body makes two passes over the staged points (the row's range,
// then the keys; a key can pass only if its score reaches a floor derived
// from the threshold's level, so the common path is the score and one
// compare), the exact body one; up to 8192 points both stage the cloud
// once. Then the list is read in order, which writes the ids, and sums
// the mean distance, in the order of the TPU kernel's K sweeps. The
// points are staged by the block's threads, not by a bulk copy: they lie
// as 12-byte points and |p|^2 is computed once a point on the way in. At
// every model shape (B=32, N=1024; B=16, N=2048; B=4, N=8192: 32,768
// rows) the grid is 128 blocks, one an SM.
//
// Above 64 neighbours the list does not fit in registers, and
// `dc_knn_topk_rounds` runs the kernels that the selection replaced: one
// warp a row, K rounds of "max, then remove" over 32 keys a lane in
// registers (N <= 1024), or over the row's scores recomputed every round
// (N > 1024).
//
// Bound on the H100: instruction issue, not memory. The kernel reads
// B N 12 bytes and writes B N K 4 bytes, but every (row, column) pair
// needs its score (6 operations) and a compare, the packed body the range
// too.
#include "common.cuh"
#include "topk_select.cuh"

#include <climits>
#include <cmath>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kKeysPerLane = 32;  // register path: N <= 32 * 32
constexpr int kMaxRegisterN = 32 * kKeysPerLane;
constexpr float kBig = 1e30f;
using dc_select::kFull;
using dc_select::score_floor;

__device__ __forceinline__ float4 load_point(const float* pb, int j) {
  const float x = pb[3 * j], y = pb[3 * j + 1], z = pb[3 * j + 2];
  // |p|^2 summed in the order of the JAX kernel's jnp.sum over (x, y, z).
  const float sq =
      __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
  return make_float4(x, y, z, sq);
}

// 2 (q . p) - |p|^2 in the order of the JAX kernel's `_scores` (2 dot is
// exact: one fma rounds as the multiply and the subtract do).
__device__ __forceinline__ float score(float4 q, float4 p) {
  const float xy = __fadd_rn(__fmul_rn(q.x, p.x), __fmul_rn(q.y, p.y));
  const float dot = __fadd_rn(xy, __fmul_rn(q.z, p.z));
  return __fmaf_rn(2.0f, dot, -p.w);
}

__device__ __forceinline__ int packed_key(float s, float rmin, float scale,
                                          int col) {
  const int q = __float2int_rz(__fmul_rn(__fsub_rn(s, rmin), scale));
  return (int)((unsigned)(q - 32768) << 16) | (65535 - col);
}

__device__ __forceinline__ int self_key(int col) {
  return 0x7FFF0000 | (65535 - col);
}

__device__ __forceinline__ float quant_scale(float rmin, float rmax) {
  return __fdiv_rn(65534.0f, fmaxf(__fsub_rn(rmax, rmin), 1e-30f));
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// One round's term of the mean distance: sqrt(max(|q|^2 - s, 0)).
__device__ __forceinline__ float dist_term(float qsq, float s) {
  return __fsqrt_rn(fmaxf(__fsub_rn(qsq, s), 0.0f));
}

// A packed key's score, dequantized.
__device__ __forceinline__ float key_score(int key, float rmin, float scale) {
  return __fadd_rn(rmin, __fdiv_rn((float)((key >> 16) + 32768), scale));
}

// The rounds route (K > 64), N <= kMaxRegisterN: lane `l` owns columns
// l + 32 j.
template <bool kQuantized>
__global__ void __launch_bounds__(kRowsPerBlock * 32, 1)
    knn_topk_regs_kernel(const float* __restrict__ pos, int* __restrict__ out,
                         float* __restrict__ md, int N, int K) {
  __shared__ float4 pts[kMaxRegisterN];
  const long long b = blockIdx.y;
  const float* pb = pos + b * N * 3;
  for (int j = threadIdx.x; j < N; j += blockDim.x) pts[j] = load_point(pb, j);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= N) return;  // no barrier follows
  const float4 q = pts[row];
  int* orow = out + (b * N + row) * K;

  float s[kKeysPerLane];
#pragma unroll
  for (int j = 0; j < kKeysPerLane; ++j) {
    const int c = lane + 32 * j;
    s[j] = c < N ? score(q, pts[c]) : 0.0f;
  }

  if (kQuantized) {
    float lo = INFINITY, hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeysPerLane; ++j) {
      if (lane + 32 * j < N) {
        lo = fminf(lo, s[j]);
        hi = fmaxf(hi, s[j]);
      }
    }
    lo = warp_min(lo);
    hi = warp_max(hi);
    const float scale = quant_scale(lo, hi);
    int key[kKeysPerLane];
#pragma unroll
    for (int j = 0; j < kKeysPerLane; ++j) {
      const int c = lane + 32 * j;
      key[j] = c >= N    ? INT_MIN
               : c == row ? self_key(c)
                          : packed_key(s[j], lo, scale, c);
    }
    float dsum = 0.0f;
    for (int r = 0; r < K; ++r) {
      int m = INT_MIN;
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) m = max(m, key[j]);
      m = __reduce_max_sync(kFull, m);
      if (lane == 0) orow[r] = 65535 - (m & 65535);
      if (r > 0)
        dsum = __fadd_rn(dsum, dist_term(q.w, key_score(m, lo, scale)));
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j)
        if (key[j] == m) key[j] = INT_MIN;
    }
    if (md != nullptr && lane == 0)
      md[b * N + row] = __fdiv_rn(dsum, (float)K);
  } else {
#pragma unroll
    for (int j = 0; j < kKeysPerLane; ++j) {
      const int c = lane + 32 * j;
      s[j] = c >= N ? -INFINITY : (c == row ? 2.0f * kBig : s[j]);
    }
    float dsum = 0.0f;
    for (int r = 0; r < K; ++r) {
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) m = fmaxf(m, s[j]);
      m = warp_max(m);
      dsum = __fadd_rn(dsum, dist_term(q.w, m));
      int w = INT_MAX;
#pragma unroll
      for (int j = kKeysPerLane - 1; j >= 0; --j)
        if (s[j] >= m) w = lane + 32 * j;
      w = __reduce_min_sync(kFull, w);
      if (lane == 0) orow[r] = w;
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j)
        if (lane + 32 * j == w) s[j] = -kBig;
    }
    if (md != nullptr && lane == 0)
      md[b * N + row] = __fdiv_rn(dsum, (float)K);
  }
}

// The rounds route, N > kMaxRegisterN: every round recomputes the row's
// scores and keeps the best entry that comes after the previous winner in
// the selection order (key order; for the exact body, score descending,
// then column ascending). Equal to the sweeps for scores above -1e30, the
// value the sweeps give a removed column.
template <bool kQuantized>
__global__ void __launch_bounds__(kRowsPerBlock * 32, 1)
    knn_topk_stream_kernel(const float* __restrict__ pos,
                           int* __restrict__ out, float* __restrict__ md,
                           int N, int K) {
  const long long b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= N) return;
  const float* pb = pos + b * N * 3;
  const float4 q = load_point(pb, row);
  int* orow = out + (b * N + row) * K;

  if (kQuantized) {
    float lo = INFINITY, hi = -INFINITY;
    for (int c = lane; c < N; c += 32) {
      const float s = score(q, load_point(pb, c));
      lo = fminf(lo, s);
      hi = fmaxf(hi, s);
    }
    lo = warp_min(lo);
    hi = warp_max(hi);
    const float scale = quant_scale(lo, hi);
    // Above every key: the self key of column 0 is INT_MAX itself.
    long long prev = (long long)INT_MAX + 1;
    float dsum = 0.0f;
    for (int r = 0; r < K; ++r) {
      int m = INT_MIN;
      for (int c = lane; c < N; c += 32) {
        const int key = c == row ? self_key(c)
                                 : packed_key(score(q, load_point(pb, c)), lo,
                                              scale, c);
        if (key < prev) m = max(m, key);
      }
      m = __reduce_max_sync(kFull, m);
      if (lane == 0) orow[r] = 65535 - (m & 65535);
      if (r > 0)
        dsum = __fadd_rn(dsum, dist_term(q.w, key_score(m, lo, scale)));
      prev = m;
    }
    if (md != nullptr && lane == 0)
      md[b * N + row] = __fdiv_rn(dsum, (float)K);
  } else {
    float prev_s = INFINITY;
    int prev_c = -1;
    float dsum = 0.0f;
    for (int r = 0; r < K; ++r) {
      float m = -INFINITY;
      for (int c = lane; c < N; c += 32) {
        const float s = c == row ? 2.0f * kBig : score(q, load_point(pb, c));
        if (s < prev_s || (s == prev_s && c > prev_c)) m = fmaxf(m, s);
      }
      m = warp_max(m);
      int w = INT_MAX;
      for (int c = lane; c < N; c += 32) {
        const float s = c == row ? 2.0f * kBig : score(q, load_point(pb, c));
        if ((s < prev_s || (s == prev_s && c > prev_c)) && s >= m) {
          w = c;
          break;
        }
      }
      w = __reduce_min_sync(kFull, w);
      if (lane == 0) orow[r] = w;
      dsum = __fadd_rn(dsum, dist_term(q.w, m));
      prev_s = m;
      prev_c = w;
    }
    if (md != nullptr && lane == 0)
      md[b * N + row] = __fdiv_rn(dsum, (float)K);
  }
}

int launch_rounds(const void* pos, void* idx, void* md, int B, int N, int K,
                  int quantized, int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N == 0) return (int)cudaGetLastError();
  const dim3 grid((N + kRowsPerBlock - 1) / kRowsPerBlock, B);
  const dim3 block(kRowsPerBlock * 32);
  cudaStream_t s = (cudaStream_t)stream;
  const float* p = (const float*)pos;
  int* o = (int*)idx;
  float* m = (float*)md;
  if (N <= kMaxRegisterN) {
    if (quantized)
      knn_topk_regs_kernel<true><<<grid, block, 0, s>>>(p, o, m, N, K);
    else
      knn_topk_regs_kernel<false><<<grid, block, 0, s>>>(p, o, m, N, K);
  } else {
    if (quantized)
      knn_topk_stream_kernel<true><<<grid, block, 0, s>>>(p, o, m, N, K);
    else
      knn_topk_stream_kernel<false><<<grid, block, 0, s>>>(p, o, m, N, K);
  }
  return (int)cudaGetLastError();
}

// ---- the selection (K <= 64) ------------------------------------------

constexpr int kSelThreads = 256;  // query rows a block, a thread each
constexpr int kStep = 32;  // candidates a thread scores a step
constexpr int kTile = 8192;  // points staged at a time (128 KB)
constexpr int kMaxSelectK = 64;

__host__ __device__ __forceinline__ int round_step(int n) {
  return (n + kStep - 1) / kStep * kStep;
}

// Stages points [t0, t0 + len) of a cloud as (x, y, z, |p|^2); the slots
// after them, up to a multiple of kStep, get a NaN norm: their scores are
// NaN, which passes no threshold compare and which fminf/fmaxf ignore.
__device__ __forceinline__ void stage_points(float4* pts, const float* pb,
                                             int t0, int len) {
  const int padded = round_step(len);
  for (int j = threadIdx.x; j < padded; j += blockDim.x)
    pts[j] = j < len ? load_point(pb, t0 + j)
                     : make_float4(0.0f, 0.0f, 0.0f, NAN);
}

template <bool kQuantized, int kCap>
__global__ void __launch_bounds__(kSelThreads)
    knn_topk_select_kernel(const float* __restrict__ pos,
                           int* __restrict__ out, float* __restrict__ md,
                           int N, int K) {
  using Sel = dc_select::Selector<
      kQuantized ? dc_select::kKey : dc_select::kScoreId, kCap>;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* pts = reinterpret_cast<float4*>(smem);
  unsigned char* queue =
      smem + (size_t)round_step(min(N, kTile)) * sizeof(float4);
  const long long b = blockIdx.y;
  const float* pb = pos + b * N * 3;
  const int tid = threadIdx.x;
  const int row = blockIdx.x * kSelThreads + tid;
  // A row past the cloud (its block's last) runs as row 0 and writes
  // nothing: every lane meets the warp's votes.
  const bool live = row < N;
  const float4 q = load_point(pb, live ? row : 0);
  const int n_tiles = (N + kTile - 1) / kTile;

  Sel sel;
  sel.init(K, queue, kSelThreads, tid);
  float rmin = 0.0f, scale = 0.0f;
  if (kQuantized) {  // the row's range, self included
    float lo = INFINITY, hi = -INFINITY;
    for (int t = 0; t < n_tiles; ++t) {
      const int t0 = t * kTile, len = min(kTile, N - t0);
      if (t > 0) __syncthreads();
      stage_points(pts, pb, t0, len);
      __syncthreads();
      for (int base = 0; base < len; base += kStep) {
        float v[kStep];
#pragma unroll
        for (int u = 0; u < kStep; ++u) v[u] = score(q, pts[base + u]);
#pragma unroll
        for (int u = 0; u < kStep; ++u) {
          lo = fminf(lo, v[u]);
          hi = fmaxf(hi, v[u]);
        }
      }
    }
    rmin = lo;
    scale = quant_scale(lo, hi);
  }
  // The self loop is pinned: the list starts with it, and the scan skips
  // it.
  sel.add(2.0f * kBig, self_key(row), row);
  sel.refresh();
  // A necessary condition of passing the threshold: the score reaches
  // the exact threshold's score, or the packed key's level floor.
  float thr =
      kQuantized ? score_floor(rmin, scale, sel.min_t) : sel.thr_s();
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = t * kTile, len = min(kTile, N - t0);
    if (!kQuantized || n_tiles > 1) {  // else the range pass staged it
      __syncthreads();
      stage_points(pts, pb, t0, len);
      __syncthreads();
    }
    for (int base = 0; base < len; base += kStep) {
      unsigned maybe = 0;  // the step's candidates that reach the floor
#pragma unroll
      for (int u = 0; u < kStep; ++u)
        maybe |= (score(q, pts[base + u]) >= thr ? 1u : 0u) << u;
      // The rare path, in step across the warp: one candidate a lane at a
      // time, its score recomputed (an array read at a runtime index would
      // go to local memory), the queues merged when one fills.
      while (__any_sync(kFull, maybe)) {
        if (maybe) {
          const int l = base + __ffs(maybe) - 1;
          maybe &= maybe - 1;
          const int col = t0 + l;
          const float v = score(q, pts[l]);
          if (kQuantized) {
            const int key = packed_key(v, rmin, scale, col);
            if (col != row && sel.passes(0.0f, key, col))
              sel.push(0.0f, key, col);
          } else if (col != row && sel.passes(v, 0, col)) {
            sel.push(v, 0, col);
          }
        }
        if (__any_sync(kFull, sel.qn > dc_select::kFlushAt)) {
          sel.flush();
          thr = kQuantized ? score_floor(rmin, scale, sel.min_t)
                           : sel.thr_s();
        }
      }
    }
  }
  sel.flush();

  // The row's K best in order: the TPU kernel's rounds.
  sel.front(K);
  int* orow = out + (b * N + row) * K;
  float dsum = 0.0f;
  for (int r = 0; r < K; ++r) {
    float v = 0.0f;
    int key = 0, o = 0;
    sel.take(v, key, o);
    if (kQuantized) {
      o = 65535 - (key & 65535);
      if (r > 0)
        dsum = __fadd_rn(dsum, dist_term(q.w, key_score(key, rmin, scale)));
    } else {
      dsum = __fadd_rn(dsum, dist_term(q.w, v));
    }
    if (live) orow[r] = o;
  }
  if (md != nullptr && live)
    md[b * N + row] = __fdiv_rn(dsum, (float)K);
}

template <bool kQuantized, int kCap>
int launch_select_cap(const float* pos, int* idx, float* md, int B, int N,
                      int K, cudaStream_t stream) {
  using Sel = dc_select::Selector<
      kQuantized ? dc_select::kKey : dc_select::kScoreId, kCap>;
  auto kernel = knn_topk_select_kernel<kQuantized, kCap>;
  const size_t smem =
      (size_t)round_step(N < kTile ? N : kTile) * sizeof(float4) +
      (size_t)dc_select::kQueue * Sel::kEntryBytes * kSelThreads;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((N + kSelThreads - 1) / kSelThreads, B);
  kernel<<<grid, kSelThreads, smem, stream>>>(pos, idx, md, N, K);
  return (int)cudaGetLastError();
}

template <bool kQuantized>
int launch_select_q(const float* pos, int* idx, float* md, int B, int N,
                    int K, cudaStream_t stream) {
  if (K <= 20) return launch_select_cap<kQuantized, 20>(pos, idx, md, B, N,
                                                        K, stream);
  if (K <= 32) return launch_select_cap<kQuantized, 32>(pos, idx, md, B, N,
                                                        K, stream);
  return launch_select_cap<kQuantized, 64>(pos, idx, md, B, N, K, stream);
}

int launch_select(const void* pos, void* idx, void* md, int B, int N, int K,
                  int quantized, int device, void* stream) {
  DC_SET_DEVICE(device);
  if (K <= 0 || K > kMaxSelectK || K > N) return (int)cudaErrorInvalidValue;
  if ((long long)B * N == 0) return (int)cudaGetLastError();
  const float* p = (const float*)pos;
  int* o = (int*)idx;
  float* m = (float*)md;
  cudaStream_t s = (cudaStream_t)stream;
  return quantized ? launch_select_q<true>(p, o, m, B, N, K, s)
                   : launch_select_q<false>(p, o, m, B, N, K, s);
}

}  // namespace

// K <= 64 (the wrapper sends larger K to dc_knn_topk_rounds).
extern "C" int dc_knn_topk(const void* pos, void* idx, int B, int N, int K,
                           int quantized, int device, void* stream) {
  return launch_select(pos, idx, nullptr, B, N, K, quantized, device,
                       stream);
}

extern "C" int dc_knn_topk_mean_dist(const void* pos, void* idx, void* md,
                                     int B, int N, int K, int quantized,
                                     int device, void* stream) {
  return launch_select(pos, idx, md, B, N, K, quantized, device, stream);
}

// Any K <= N; md may be null (no mean distances).
extern "C" int dc_knn_topk_rounds(const void* pos, void* idx, void* md,
                                  int B, int N, int K, int quantized,
                                  int device, void* stream) {
  return launch_rounds(pos, idx, md, B, N, K, quantized, device, stream);
}
