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
//   h [B, N, C] f32 -> out [B, N, C] f32, summed in slot order from +0.0.
//   Replaces the streaming `_fwd_with_adj` (pallas_call at
//   gather_sum.py:201, kernel body `_fwd_kernel`), which rebuilt the
//   adjacency tile and contracted it on the MXU over a hi/lo split.
//   Bound: memory, h, idx and mask read once and out written once.
//   Two routes, chosen by shape in ops/gather_sum.py (`sum_slice`, the
//   neighbour max's `max_slice`), the same bits.
//   Route S (`gather_sum`): the sum mode of the neighbour max's staged
//   route (gather_max.cu, `dc_gather_sum_staged`). A block takes a cloud
//   and a slice of Cs channels (rows of 16 P bytes: 4 channels at B=4,
//   N=8192, C=128; 32 at N=1024), copies the slice into shared memory
//   once by cp.async beside a zero row (row N), then a group of P lanes
//   owns a point: its idx and mask are read once a task, four slots'
//   16-byte rows are read from shared memory before their adds, and the
//   adds run in slot order from +0.0. A masked slot and an index outside
//   [0, N) read the zero row; the sum starts at +0.0 and under
//   round-to-nearest never becomes -0.0, so adding +0.0 changes no bit
//   and the result equals the plain version's (every slot added, masked
//   ones as 0.0) bit for bit. Each row of h is read from L2 or memory once
//   a task, where route D read K rows a point from L2 (335 MB for 16.8 MB
//   of h at B=4, N=8192, K=20, C=128).
//   Route D (`gather_sum_direct`, the earlier kernel), where no slice fits
//   a block (above 14,526 points) or K is 0: gather_max.cu's direct
//   layout, a block row per point, c fastest, each slot's idx and mask
//   read from global memory and its h row from L2.
//
// gather_sum_bwd: dh[b, m, c] = sum of g[b, n, c] over the valid edges
//   (n, k) with idx[b, n, k] == m; the inverse adjacency of idx
//   (`ops.inverse_adjacency`: offsets [B, N + 1] and edges [B, N * K],
//   each row's edges n * K + k ascending), mask [B, N, K], g [B, N, C]
//   -> dh [B, N, C] f32. Replaces `_gather_sum_bwd` (pallas_call at
//   gather_sum.py:255, kernel body `_bwd_kernel`), the transposed
//   adjacency contraction that accumulated over point tiles in a
//   sequential grid. Here the sum is destination-major, as scatter_rows
//   (gather_rows.cu): a warp owns a destination row, its lanes hold 32
//   of the row's edges' source points at a time (-1 when masked) and
//   walk the channels (4 a lane where C % 4 == 0), issue the loads of 4
//   edges' g rows before they add them, in list order, in f64, and round
//   the sums once to f32. The f32 addends of one
//   (row, c) sum exactly in f64 unless they span more than 29 binary
//   orders, so dh equals the plain version's f64 sum rounded once, and
//   two calls give the same bits (an earlier kernel added f32 atomics in
//   any order). Bound: the gathers of g rows from L2, K a row.
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

constexpr int kBwdWarps = 8;  // destination rows a block
constexpr int kBwdAhead = 4;  // edges whose loads precede the adds

template <int V>
__global__ void __launch_bounds__(32 * kBwdWarps)
    gather_sum_bwd_kernel(const int* __restrict__ offsets,
                          const int* __restrict__ edges,
                          const uint8_t* __restrict__ mask,
                          const float* __restrict__ g,
                          float* __restrict__ dh, long long rows, int N,
                          int C, int K) {
  const long long bm = (long long)blockIdx.x * kBwdWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (bm >= rows) return;  // the whole warp
  const long long b = bm / N;
  const int* off = offsets + b * (N + 1) + (bm - b * N);
  const int e0 = off[0], e1 = off[1];
  const int* el = edges + b * N * K;
  const uint8_t* mb = mask + b * N * K;
  const float* gb = g + b * N * C;
  for (int p = 0; p * 32 * V < C; ++p) {
    const int c0 = (p * 32 + lane) * V;
    const bool on = c0 < C;
    double acc[V];
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = 0.0;
    for (int e = e0; e < e1; e += 32) {
      int src = -1;  // lane l: the source point of edge e + l
      if (e + lane < e1) {
        const int edge = el[e + lane];
        if (mb[edge]) src = edge / K;
      }
      const int cnt = min(32, e1 - e);
      for (int j = 0; j < cnt; j += kBwdAhead) {
        float v[kBwdAhead][V];
#pragma unroll
        for (int u = 0; u < kBwdAhead; ++u) {
          const int s = __shfl_sync(0xffffffffu, src, (j + u) & 31);
          const float* row = gb + (long long)s * C + c0;
          if (on && j + u < cnt && s >= 0) {
            if constexpr (V == 4) {
              const float4 f = __ldg(reinterpret_cast<const float4*>(row));
              v[u][0] = f.x; v[u][1] = f.y; v[u][2] = f.z; v[u][3] = f.w;
            } else {
              v[u][0] = __ldg(row);
            }
          } else {
#pragma unroll
            for (int q = 0; q < V; ++q) v[u][q] = 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < kBwdAhead; ++u) {
#pragma unroll
          for (int q = 0; q < V; ++q) acc[q] += (double)v[u][q];
        }
      }
    }
    if (on) {
#pragma unroll
      for (int q = 0; q < V; ++q) dh[bm * C + c0 + q] = __double2float_rn(acc[q]);
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

// gather_max.cu: the staged route's sum mode.
int dc_gather_sum_staged(const void* h, const void* idx, const void* mask,
                         void* out, int B, int N, int C, int K, int Cs,
                         int splits, void* stream);

// Route S: Cs channels a slice (16, 32, 64 or 128 bytes a row) and splits
// blocks a task, as ops/gather_sum.py chose them; a shape that does not
// fit is refused (route D takes it).
extern "C" int dc_gather_sum(const void* h, const void* idx, const void* mask,
                             void* out, int B, int N, int C, int K, int Cs,
                             int splits, int device, void* stream) {
  DC_SET_DEVICE(device);
  return dc_gather_sum_staged(h, idx, mask, out, B, N, C, K, Cs, splits,
                              stream);
}

extern "C" int dc_gather_sum_direct(const void* h, const void* idx,
                                    const void* mask, void* out, int B,
                                    int N, int C, int K, int device,
                                    void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  const dim3 block = dc_row_block(C);
  gather_sum_kernel<<<dc_row_grid(B, N, block), block, 0,
                      (cudaStream_t)stream>>>(
      (const float*)h, (const int*)idx, (const uint8_t*)mask, (float*)out, B,
      N, C, K);
  return (int)cudaGetLastError();
}

extern "C" int dc_gather_sum_bwd(const void* offsets, const void* edges,
                                 const void* mask, const void* g, void* dh,
                                 int B, int N, int C, int K, int device,
                                 void* stream) {
  DC_SET_DEVICE(device);
  const long long rows = (long long)B * N;
  if (rows * C == 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((rows + kBwdWarps - 1) / kBwdWarps);
  cudaStream_t s = (cudaStream_t)stream;
  // Four channels a lane where every g row starts on a 16-byte boundary.
  if (C % 4 == 0 && (uintptr_t)g % 16 == 0) {
    gather_sum_bwd_kernel<4><<<blocks, 32 * kBwdWarps, 0, s>>>(
        (const int*)offsets, (const int*)edges, (const uint8_t*)mask,
        (const float*)g, (float*)dh, rows, N, C, K);
  } else {
    gather_sum_bwd_kernel<1><<<blocks, 32 * kBwdWarps, 0, s>>>(
        (const int*)offsets, (const int*)edges, (const uint8_t*)mask,
        (const float*)g, (float*)dh, rows, N, C, K);
  }
  return (int)cudaGetLastError();
}
