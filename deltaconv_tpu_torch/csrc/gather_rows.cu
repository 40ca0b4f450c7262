// Component-major neighbour-table gather:
//   out[b, c, k, n] = table[b, idx[b, n, k], c]
// table [B, Nt, C] f32, idx [B, N, K] i32 -> out [B, C, K, N] f32; the
// table may be longer than the query rows (the point-sharded build
// gathers a shard's neighbours from the whole cloud's table).
//
// Replaces the Pallas forward of deltaconv_tpu/ops/gather_rows.py
// (`_fwd`, pallas_call at gather_rows.py:205; kernel bodies `_fwd_kernel`
// and `_fwd_kernel_blocked`). The TPU kernel gathered through one-hot
// MXU matmuls on a hi/lo bf16 split of the table, padded C to 8 and the
// point tile to 128 lanes; a CUDA thread loads the f32 row entry
// directly, so the gather is exact and needs no padding.
//
// Bound on the H100: memory. A thread owns one (b, k, n) and writes its
// C outputs, with n the fastest index across the warp, so every store
// of a warp is coalesced; it reads its index once and the C contiguous
// floats of the neighbour's row. The table of one cloud (N * C * 4
// bytes, 36 KB at N=1024, C=9) stays in L1/L2. An index outside
// [0, Nt) gathers 0, as a one-hot row with no match does on the TPU.
//
// Its transpose, the scatter of component-major edge rows:
//   out[b, m, c] = sum over (n, k) with idx[b, n, k] == m of g[b, c, k, n]
// g [B, C, K, N] f32, idx [B, N, K] i32 -> out [B, n_out, C] f32, which
// the caller zero-fills. Replaces `_scatter_impl` (pallas_call at
// gather_rows.py:292, kernel bodies `_bwd_kernel` and
// `_bwd_kernel_blocked`): the backward of the gather and of the
// coefficient-form applies (ops/coef_apply.py), whose feature
// cotangents are edge-row scatters. The TPU kernel contracted a
// transposed one-hot matrix with a hi/lo split of g and carried the
// [N, C] accumulator across its sequential grid, halving the channels
// while the accumulator crowded VMEM. CUDA blocks run in no order, so
// each edge value is added to its row with an atomicAdd. A block owns a
// tile of 32 points and 32 channels and walks the K slots: it reads the
// tile's [32 channels, 32 points] slab of g (coalesced in n) into shared
// memory, then adds it transposed (coalesced in c) to the rows its
// indices name. Bound on the H100: the B*N*K*C atomics in L2 (and the
// read of g, 1.34 GB for the widest apply of the large-cloud train step).
// The order of the adds, and so the last bits of a sum, can change from
// run to run. An index outside [0, n_out) adds nothing.
#include "common.cuh"

namespace {

__global__ void gather_rows_kernel(const float* __restrict__ table,
                                   const int* __restrict__ idx,
                                   float* __restrict__ out, int N, int Nt,
                                   int C, int K) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y;
  const long long b = blockIdx.z;
  if (n >= N) return;
  const int j = idx[(b * N + n) * K + k];
  const bool ok = (unsigned)j < (unsigned)Nt;
  const float* src = table + (b * Nt + (ok ? j : 0)) * C;
  float* dst = out + (b * C * K + k) * N + n;  // + c * K * N
  const long long stride = (long long)K * N;
  for (int c = 0; c < C; ++c) dst[c * stride] = ok ? src[c] : 0.0f;
}

constexpr int kScatterTile = 32;  // points and channels of a block's tile

__global__ void scatter_rows_kernel(const float* __restrict__ g,
                                    const int* __restrict__ idx,
                                    float* __restrict__ out, int N, int C,
                                    int K, int n_out) {
  __shared__ float tile[kScatterTile][kScatterTile + 1];  // [point][chan]
  const int n0 = blockIdx.x * kScatterTile;
  const int c0 = blockIdx.y * kScatterTile;
  const long long b = blockIdx.z;
  const int lane = threadIdx.x % kScatterTile;
  const int rows = blockDim.x / kScatterTile;
  for (int k = 0; k < K; ++k) {
    // Load: lanes along n.
    for (int r = threadIdx.x / kScatterTile; r < kScatterTile; r += rows) {
      const int c = c0 + r, n = n0 + lane;
      tile[lane][r] = (c < C && n < N)
                          ? g[((b * C + c) * K + k) * N + n]
                          : 0.0f;
    }
    __syncthreads();
    // Add: lanes along c, one point a warp.
    for (int r = threadIdx.x / kScatterTile; r < kScatterTile; r += rows) {
      const int n = n0 + r, c = c0 + lane;
      if (n < N && c < C) {
        const int j = idx[(b * N + n) * K + k];
        if ((unsigned)j < (unsigned)n_out)
          atomicAdd(out + (b * n_out + j) * C + c, tile[r][lane]);
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int dc_gather_rows(const void* table, const void* idx, void* out,
                              int B, int N, int Nt, int C, int K, int device,
                              void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C * K == 0) return (int)cudaGetLastError();
  const int threads = 128;
  const dim3 grid((N + threads - 1) / threads, K, B);
  gather_rows_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const int*)idx, (float*)out, N, Nt, C, K);
  return (int)cudaGetLastError();
}

extern "C" int dc_scatter_rows(const void* g, const void* idx, void* out,
                               int B, int N, int C, int K, int n_out,
                               int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C * K == 0) return (int)cudaGetLastError();
  const dim3 grid((N + kScatterTile - 1) / kScatterTile,
                  (C + kScatterTile - 1) / kScatterTile, B);
  scatter_rows_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const int*)idx, (float*)out, N, C, K, n_out);
  return (int)cudaGetLastError();
}

extern "C" const char* dc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
