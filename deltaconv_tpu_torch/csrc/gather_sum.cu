// Masked neighbour sum: the adjacency counts, the streaming forward and
// its scatter backward.
//
// adjacency: A[b, n, m] = #{k : mask[b, n, k] and idx[b, n, k] == m}
//   idx [B, N, K] i32, mask [B, N, K] bool -> A [B, N, N] f32 (exact
//   counts <= K). Replaces `_adjacency_matrix` (pallas_call at
//   deltaconv_tpu/ops/gather_sum.py:117, kernel body `_adj_kernel`),
//   which built each row tile by K select-accumulates over a column iota.
//   Bound on the H100: the stores, N * N * 4 bytes per cloud (134 MB at
//   B=32, N=1024); the K indices of a row are a few bytes beside them.
//   So nothing is staged and nothing is written twice: a warp owns a
//   row (8 rows a block) and holds its K slots' columns in registers
//   (lane s, slot s; K > 32 in passes of 32). It writes the row once,
//   in passes of 32 16-byte float4 chunks (a scalar head and tail where
//   the row does not start on a 16-byte boundary, N % 4 != 0): a chunk's
//   four counts come from the slots whose column falls in the pass (a
//   ballot, then one shuffle a slot), zeros elsewhere. The counts are
//   small integers, exact in f32 in any order, so the result is bit-equal
//   to the plain scatter_add_; no shared memory bounds N, no atomics are
//   needed. The forward A @ h and the backward A^T @ g on the same A are
//   plain batched matmuls (torch.bmm), as the JAX package
//   leaves them to XLA.
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

constexpr int kAdjWarps = 8;  // rows (warps) a block

__device__ __forceinline__ int adj_column(const int* ir, const uint8_t* mr,
                                          int k, int K, int N) {
  if (k >= K) return -1;
  const int j = ir[k];
  return (mr[k] && (unsigned)j < (unsigned)N) ? j : -1;
}

__global__ void adjacency_kernel(const int* __restrict__ idx,
                                 const uint8_t* __restrict__ mask,
                                 float* __restrict__ adj, long long rows,
                                 int N, int K) {
  const long long row = (long long)blockIdx.x * kAdjWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp
  const unsigned all = 0xffffffffu;
  const int* ir = idx + row * K;
  const uint8_t* mr = mask + row * K;
  float* out = adj + row * N;
  // The row's columns: [head) up to the first 16-byte boundary (adj is
  // 16-byte aligned), nvec float4 chunks from head, the tail from tail0.
  const int head = min(N, (int)((4 - (row * N) % 4) % 4));
  const int nvec = (N - head) / 4;
  const int tail0 = head + 4 * nvec;
  // Lane s holds slot k0 + s's column (-1 when masked or outside [0, N)),
  // for K <= 32 the whole row in one register.
  const int col0 = adj_column(ir, mr, lane, K, N);
  if (head > 0 || tail0 < N) {  // the scalar columns, lanes 0-3 each
    float hv = 0.0f, tv = 0.0f;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int c = k0 == 0 ? col0 : adj_column(ir, mr, k0 + lane, K, N);
      unsigned m = __ballot_sync(all, c >= 0 && (c < head || c >= tail0));
      while (m) {
        const int o = __shfl_sync(all, c, __ffs(m) - 1);
        m &= m - 1;
        hv += o == lane;
        tv += o == tail0 + lane;
      }
    }
    if (lane < head) out[lane] = hv;
    if (tail0 + lane < N) out[tail0 + lane] = tv;
  }
  // Chunk v = 32 it + lane of each pass: its four counts from the slots
  // whose column falls in this pass's 128 columns, one shuffle a slot.
  float4* body = reinterpret_cast<float4*>(out + head);
  for (int it = 0; 32 * it < nvec; ++it) {
    const int v = 32 * it + lane;
    float q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int c = k0 == 0 ? col0 : adj_column(ir, mr, k0 + lane, K, N);
      unsigned m = __ballot_sync(
          all, c >= head && c < tail0 && ((c - head) >> 7) == it);
      while (m) {
        const int r = __shfl_sync(all, c, __ffs(m) - 1) - head;
        m &= m - 1;
        if ((r >> 2) == v) {
#pragma unroll
          for (int t = 0; t < 4; ++t) q[t] += (r & 3) == t;
        }
      }
    }
    if (v < nvec) body[v] = make_float4(q[0], q[1], q[2], q[3]);
  }
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
  const long long rows = (long long)B * N;
  if (rows == 0) return (int)cudaGetLastError();
  const long long blocks = (rows + kAdjWarps - 1) / kAdjWarps;
  adjacency_kernel<<<(unsigned int)blocks, 32 * kAdjWarps, 0,
                     (cudaStream_t)stream>>>((const int*)idx,
                                             (const uint8_t*)mask,
                                             (float*)adj, rows, N, K);
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
