// Masked neighbour sum: the adjacency counts, the streaming forward and
// its scatter backward.
//
// adjacency: A[b, n, m] = #{k : mask[b, n, k] and idx[b, n, k] == m}
//   idx [B, N, K] i32, mask [B, N, K] bool -> A [B, N, N] f32 (exact
//   counts <= K). Replaces `_adjacency_matrix` (pallas_call at
//   deltaconv_tpu/ops/gather_sum.py:117, kernel body `_adj_kernel`),
//   which built each row tile by K select-accumulates over a column iota.
//   Here a block owns one row (b, n): it zeroes the row in shared memory
//   (N * 4 bytes, at most 48 KB: N <= 12288), one thread adds the row's
//   K counts in slot order, and the block writes the row whole, zeros
//   included, with coalesced stores. No other block writes the row, so
//   no atomics are needed. Bound on the H100: the stores, N * N * 4
//   bytes per cloud (128 MB at B=32, N=1024). The forward A @ h and the
//   backward A^T @ g on the same A are plain batched matmuls
//   (torch.bmm), as the JAX package leaves them to XLA.
//
// gather_sum: out[b, n, c] = sum over k with mask of h[b, idx[b, n, k], c]
//   h [B, N, C] f32 -> out [B, N, C] f32, summed in slot order.
//   Replaces the streaming `_fwd_with_adj` (pallas_call at
//   gather_sum.py:201, kernel body `_fwd_kernel`), which rebuilt the
//   adjacency tile and contracted it on the MXU over a hi/lo split.
//   The layout is gather_max.cu's: a block row per point, c fastest,
//   coalesced loads of h rows from L2. Bound: memory.
//
// gather_sum_bwd: dh[b, idx[b, n, k], c] += g[b, n, c] for valid k
//   idx/mask [B, N, K], g [B, N, C] -> dh [B, N, C] f32, which the
//   caller zero-fills. Replaces `_gather_sum_bwd` (pallas_call at
//   gather_sum.py:255, kernel body `_bwd_kernel`), the transposed
//   adjacency contraction that accumulated over point tiles in a
//   sequential grid. CUDA blocks run in no order, so each (b, n, c)
//   adds its cotangent to its K neighbours' rows with atomicAdd: B*N*K*C
//   atomics, coalesced over c. Bound: the atomics in L2. The order of
//   the adds, and so the last bits of a sum, can change from run to run.
//
// An index outside [0, N) contributes nothing, as a one-hot row with no
// match does on the TPU.
#include "common.cuh"

namespace {

__global__ void adjacency_kernel(const int* __restrict__ idx,
                                 const uint8_t* __restrict__ mask,
                                 float* __restrict__ adj, int N, int K) {
  extern __shared__ float s_row[];  // [N]
  const long long row = (long long)blockIdx.y * N + blockIdx.x;
  for (int m = threadIdx.x; m < N; m += blockDim.x) s_row[m] = 0.0f;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 0; k < K; ++k) {
      const int j = idx[row * K + k];
      if (mask[row * K + k] && (unsigned)j < (unsigned)N) s_row[j] += 1.0f;
    }
  }
  __syncthreads();
  float* out = adj + row * N;
  for (int m = threadIdx.x; m < N; m += blockDim.x) out[m] = s_row[m];
}

__global__ void gather_sum_kernel(const float* __restrict__ h,
                                  const int* __restrict__ idx,
                                  const uint8_t* __restrict__ mask,
                                  float* __restrict__ out, int B, int N,
                                  int C, int K) {
  const long long bn = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (bn >= (long long)B * N) return;
  const long long b = bn / N;
  const int* ir = idx + bn * K;
  const uint8_t* mr = mask + bn * K;
  const float* hb = h + b * N * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) {
      const int j = ir[k];
      if (mr[k] && (unsigned)j < (unsigned)N) acc += hb[(long long)j * C + c];
    }
    out[bn * C + c] = acc;
  }
}

__global__ void gather_sum_bwd_kernel(const int* __restrict__ idx,
                                      const uint8_t* __restrict__ mask,
                                      const float* __restrict__ g,
                                      float* __restrict__ dh, int B, int N,
                                      int C, int K) {
  const long long bn = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (bn >= (long long)B * N) return;
  const long long b = bn / N;
  const int* ir = idx + bn * K;
  const uint8_t* mr = mask + bn * K;
  float* db = dh + b * N * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float gv = g[bn * C + c];
    for (int k = 0; k < K; ++k) {
      const int j = ir[k];
      if (mr[k] && (unsigned)j < (unsigned)N)
        atomicAdd(db + (long long)j * C + c, gv);
    }
  }
}

}  // namespace

extern "C" int dc_adjacency(const void* idx, const void* mask, void* adj,
                            int B, int N, int K, int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N == 0) return (int)cudaGetLastError();
  const int threads = N >= 256 ? 256 : ((N + 31) / 32) * 32;
  adjacency_kernel<<<dim3(N, B), threads, (size_t)N * sizeof(float),
                     (cudaStream_t)stream>>>((const int*)idx,
                                             (const uint8_t*)mask,
                                             (float*)adj, N, K);
  return (int)cudaGetLastError();
}

extern "C" int dc_gather_sum(const void* h, const void* idx, const void* mask,
                             void* out, int B, int N, int C, int K,
                             int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  const dim3 block = dc_row_block(C);
  gather_sum_kernel<<<dc_row_grid(B, N, block), block, 0,
                      (cudaStream_t)stream>>>(
      (const float*)h, (const int*)idx, (const uint8_t*)mask, (float*)out, B,
      N, C, K);
  return (int)cudaGetLastError();
}

extern "C" int dc_gather_sum_bwd(const void* idx, const void* mask,
                                 const void* g, void* dh, int B, int N, int C,
                                 int K, int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  const dim3 block = dc_row_block(C);
  gather_sum_bwd_kernel<<<dc_row_grid(B, N, block), block, 0,
                          (cudaStream_t)stream>>>(
      (const int*)idx, (const uint8_t*)mask, (const float*)g, (float*)dh, B,
      N, C, K);
  return (int)cudaGetLastError();
}
