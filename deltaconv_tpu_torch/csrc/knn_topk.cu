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
//   that column to -1e30.
// * packed (`_kernel_q`, quantized=True): the row's scores are mapped
//   linearly onto [0, 65534] by q = trunc((s - rmin) * 65534 /
//   max(rmax - rmin, 1e-30)) (rmin, rmax over the whole row, self
//   included) and packed with the column into one int32,
//   ((q - 32768) << 16) | (65535 - col); the self column becomes
//   0x7FFF0000 | (65535 - col). Keys are unique, so K rounds of "max,
//   then remove" pick columns in key order, ties going to the lowest
//   column. The caller takes the exact body above 65535 points.
//
// Every score is computed in the JAX kernel's order with each operation
// rounded on its own (__fmul_rn/__fadd_rn: no FMA contraction), so the
// indices, and the mean distances, are bit-equal to the plain version's.
//
// Design: one warp per query row, 8 rows of one cloud per block. Up to
// 1024 points the block stages the cloud (x, y, z, |p|^2) in shared
// memory (16 KB) and each lane keeps 32 scores or keys in registers; a
// round is a max over the lane's keys and one warp reduction
// (__reduce_max_sync on the packed keys). Above 1024 points the keys do
// not fit in registers: each round recomputes the row's scores from the
// positions (read through L1) and takes the best key below the previous
// winner, which is the same order. The TPU kernel held a [128, N] score
// tile in VMEM and swept it K times; nothing of the [B, N, N] score plane
// reaches device memory in either design.
//
// Bound on the H100: instruction throughput, not memory. The kernel reads
// B N 12 bytes and writes B N K 4 bytes (3 MB at B=32, N=1024, K=20),
// but the K rounds compare every key of a row: B N^2 K compare-selects
// (671 M), besides the B N^2 scores.
#include "common.cuh"

#include <climits>
#include <cmath>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kKeysPerLane = 32;  // register path: N <= 32 * 32
constexpr int kMaxRegisterN = 32 * kKeysPerLane;
constexpr float kBig = 1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 load_point(const float* pb, int j) {
  const float x = pb[3 * j], y = pb[3 * j + 1], z = pb[3 * j + 2];
  // |p|^2 summed in the order of the JAX kernel's jnp.sum over (x, y, z).
  const float sq =
      __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
  return make_float4(x, y, z, sq);
}

// 2 (q . p) - |p|^2 in the order of the JAX kernel's `_scores`.
__device__ __forceinline__ float score(float4 q, float4 p) {
  const float xy = __fadd_rn(__fmul_rn(q.x, p.x), __fmul_rn(q.y, p.y));
  const float dot = __fadd_rn(xy, __fmul_rn(q.z, p.z));
  return __fsub_rn(__fmul_rn(2.0f, dot), p.w);
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

// N <= kMaxRegisterN: lane `l` owns columns l + 32 j.
template <bool kQuantized>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
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

// N > kMaxRegisterN: every round recomputes the row's scores and keeps the
// best entry that comes after the previous winner in the selection order
// (key order; for the exact body, score descending, then column
// ascending). Equal to the sweeps for scores above -1e30, the value the
// sweeps give a removed column.
template <bool kQuantized>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
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

int launch_knn_topk(const void* pos, void* idx, void* md, int B, int N,
                    int K, int quantized, int device, void* stream) {
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

}  // namespace

extern "C" int dc_knn_topk(const void* pos, void* idx, int B, int N, int K,
                           int quantized, int device, void* stream) {
  return launch_knn_topk(pos, idx, nullptr, B, N, K, quantized, device,
                         stream);
}

extern "C" int dc_knn_topk_mean_dist(const void* pos, void* idx, void* md,
                                     int B, int N, int K, int quantized,
                                     int device, void* stream) {
  return launch_knn_topk(pos, idx, md, B, N, K, quantized, device, stream);
}
