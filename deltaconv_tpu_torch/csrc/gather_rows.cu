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
// Bound on the H100: memory, the write of out (23.6 MB of the 27 MB the
// operator build's gather moves at B=32, N=1024, K=20, C=9). Its rows are
// narrow (C = 9 for the build, 3 for conv0's centralized edge tensor), so
// what costs is the reads: a thread a (b, k, n) read idx at a stride of K
// ints (4 useful bytes a 32-byte sector, each sector re-read by K blocks)
// and its neighbour's row as C scalar loads from L1, 32 rows a warp load.
// Here a block takes one cloud and a tile of 128 consecutive points:
// 1. it reads the tile's [128, K] indices once, coalesced (16-byte loads
//    where aligned), into shared memory transposed to [K][128 + 4];
// 2. where the cloud's table fits (Nt * C * 4 bytes up to 96 KB: 36 KB at
//    N=1024, C=9; 24 KB at N=2048, C=3), it stages it in shared memory by
//    cp.async (16 bytes a thread where aligned), so that the rows' random
//    reads cost shared-memory bank conflicts, not L1 lines;
// 3. a warp takes a slot k, a lane 4 consecutive points: it reads their
//    4 indices as one 16-byte shared load, loads 16 channels of their 4
//    rows, then writes each channel's 4 outputs out[b, c, k, n : n + 4]
//    as one 16-byte store (scalar stores where N % 4 != 0), so a warp
//    writes 512 contiguous bytes a channel.
// A table above 96 KB (N=8192's build, 295 KB; the point-shard table)
// takes the direct route, the earlier kernel: a thread a (b, k, n), its
// row read through L1/L2. A form of the tile kernel that read such rows
// through the read-only path was tried and was not faster there.
// An index outside [0, Nt) gathers 0, as a one-hot row with no match does
// on the TPU. Bit-equal to the plain version: it copies values.
//
// Its transpose, the scatter of edge rows:
//   out[b, m, c] = sum over (n, k) with idx[b, n, k] == m of g[b, c, k, n]
// g [B, C, K, N] f32 with any strides, idx [B, N, K] i32 -> out
// [B, n_out, C] f32. Replaces `_scatter_impl` (pallas_call at
// gather_rows.py:292, kernel bodies `_bwd_kernel` and
// `_bwd_kernel_blocked`): the backward of the gather and of the
// coefficient-form applies (ops/coef_apply.py), whose feature cotangents
// are edge-row scatters. The TPU kernel contracted a transposed one-hot
// matrix with a hi/lo split of g and carried the [N, C] accumulator
// across its sequential grid, so its sums ran in a fixed order. CUDA
// blocks run in no order; this design keeps a fixed order with no float
// atomics, destination-major, in two steps:
//
// 1. inverse_adjacency (dc_inverse_adjacency): for each cloud b and row
//    m, the list of edges e = n * K + k with idx[b, n, k] == m, as CSR:
//    offsets [B, n_out + 1] i32 (row m's list is edges[b, offsets[b, m]
//    : offsets[b, m + 1]]) and edges [B, N * K] i32, each list in
//    ascending edge order; an index outside [0, n_out) is listed nowhere
//    (the cloud's tail past offsets[b, n_out] holds -1, one per such
//    edge). One kernel, a block per 256-row tile of a cloud: in one pass
//    over the cloud's idx (each warp a 32nd of it, in order) it counts
//    its rows' edges and the edges below its first row (its place),
//    staging its edges in shared memory in edge order; it scans the
//    counts and each warp writes its edges at their places, so that every
//    list is ascending with no sort, then writes the lists. No global
//    atomics; the result does not depend on the order of the
//    shared-memory ones. In its clamp mode (the edge MLP's backward,
//    edge_mlp.cu) an index is read as JAX's indexing reads it: a negative
//    one counts from the end (+ n_out), then it is clamped to [0, n_out),
//    so every edge is listed.
// 2. scatter_rows (dc_scatter_rows): a group of G lanes (G = 32 from 32
//    vector slots of channels up) owns one output row (b, m) and a tile
//    of channels, reads its edges' rows of g through g's strides, 16-byte
//    float4 loads when the channels are contiguous (c stride 1, as the
//    coefficient VJPs' edge-major views give them), and sums them in
//    ascending edge order in f32 registers, four to eight edges' loads in
//    flight, then writes the row once (a row with no edge is written 0).
//    Component-major rows (the operator build's [B, 9, K, N] cotangent)
//    are read through their strides, a 32-byte sector for each 4-byte
//    value, so that narrow scatter is no faster than the atomic design
//    it replaces; edge-major rows are this kernel's fast layout.
//
// Two calls on the same inputs give the same bits. Bound on the H100: the
// read of g, each edge row once (1.34 GB for conv3's div cotangent in the
// large-cloud train step), and the write of out; the inverse adjacency
// reads idx (once a tile, from L2) and writes 4 + 4 bytes an edge. A
// row's edges are one group's loop, so a hub row (a point in every
// neighbour list) is one long loop.
#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

constexpr int kRowsTile = 128;     // points a block
constexpr int kRowsThreads = 256;  // a warp a slot at a time, 4 points a lane
constexpr int kRowsChans = 16;  // channels whose loads precede their stores
constexpr int kRowsLd = kRowsTile + 4;  // ints a slot of the staged indices
constexpr int kRowsStageMax = 96 * 1024;  // bytes of a staged table
constexpr size_t kRowsSmemMax = 227 * 1024;  // a block's shared memory

__device__ __forceinline__ void rows_cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void rows_cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Shared memory of a block: the tile's indices, then the staged table.
inline size_t gather_rows_smem(int K, int Nt, int C) {
  return ((size_t)K * kRowsLd * 4 + 15) / 16 * 16 + (size_t)Nt * C * 4;
}

// The staged route: kVec: N % 4 == 0 (every output row 16-byte aligned).
template <bool kVec>
__global__ void __launch_bounds__(kRowsThreads)
    gather_rows_kernel(const float* __restrict__ table,
                       const int* __restrict__ idx, float* __restrict__ out,
                       int N, int Nt, int C, int K) {
  extern __shared__ __align__(16) unsigned char rows_smem[];
  int* s_idx = reinterpret_cast<int*>(rows_smem);  // [K][kRowsLd]
  float* s_tab = reinterpret_cast<float*>(
      rows_smem + ((size_t)K * kRowsLd * 4 + 15) / 16 * 16);
  const long long b = blockIdx.y;
  const int n0 = blockIdx.x * kRowsTile;
  const int T = min(kRowsTile, N - n0);
  const float* tb = table + b * Nt * C;
  const int total = Nt * C;
  if (((uintptr_t)tb & 15) == 0) {
    const int v4 = total / 4;
    for (int i = threadIdx.x; i < v4; i += kRowsThreads)
      rows_cp_async16(s_tab + 4 * i, tb + 4 * i);
    for (int i = 4 * v4 + threadIdx.x; i < total; i += kRowsThreads)
      s_tab[i] = tb[i];
  } else {
    for (int i = threadIdx.x; i < total; i += kRowsThreads) s_tab[i] = tb[i];
  }
  // The tile's indices, [T, K] contiguous in idx, transposed.
  const int* ib = idx + (b * N + n0) * K;
  const int TK = T * K;
  if (((uintptr_t)ib & 15) == 0) {
    const int v4 = TK / 4;
    for (int i = threadIdx.x; i < v4; i += kRowsThreads) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(ib) + i);
      const int v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = 4 * i + u, n = e / K;
        s_idx[(e - n * K) * kRowsLd + n] = v[u];
      }
    }
    for (int e = 4 * v4 + threadIdx.x; e < TK; e += kRowsThreads) {
      const int n = e / K;
      s_idx[(e - n * K) * kRowsLd + n] = __ldg(ib + e);
    }
  } else {
    for (int e = threadIdx.x; e < TK; e += kRowsThreads) {
      const int n = e / K;
      s_idx[(e - n * K) * kRowsLd + n] = __ldg(ib + e);
    }
  }
  rows_cp_async_wait_all();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = 4 * lane;  // this lane's first point of the tile
  if (n >= T) return;
  const int np = min(4, T - n);
  const long long plane = (long long)K * N;  // floats between channels
  for (int k = warp; k < K; k += kRowsThreads / 32) {
    int j[4];
    if (np == 4) {
      const int4 q = *reinterpret_cast<const int4*>(s_idx + k * kRowsLd + n);
      j[0] = q.x; j[1] = q.y; j[2] = q.z; j[3] = q.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        j[u] = u < np ? s_idx[k * kRowsLd + n + u] : -1;
    }
    bool ok[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) ok[u] = (unsigned)j[u] < (unsigned)Nt;
    float* dst = out + (b * C * K + k) * N + n0 + n;  // + c * plane
    // kRowsChans channels at a time: all their loads, then the stores.
    for (int c0 = 0; c0 < C; c0 += kRowsChans) {
      float v[kRowsChans][4];
#pragma unroll
      for (int cc = 0; cc < kRowsChans; ++cc) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[cc][u] = ok[u] && c0 + cc < C ? s_tab[j[u] * C + c0 + cc] : 0.0f;
      }
#pragma unroll
      for (int cc = 0; cc < kRowsChans; ++cc) {
        if (c0 + cc >= C) break;
        float* d = dst + (c0 + cc) * plane;
        if (kVec && np == 4) {
          *reinterpret_cast<float4*>(d) =
              make_float4(v[cc][0], v[cc][1], v[cc][2], v[cc][3]);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (u < np) d[u] = v[cc][u];
        }
      }
    }
  }
}

// The direct route (the earlier kernel), for tables above kRowsStageMax:
// a thread a (b, k, n), n fastest across the warp, its row's C floats
// through L1/L2.
__global__ void gather_rows_direct_kernel(const float* __restrict__ table,
                                          const int* __restrict__ idx,
                                          float* __restrict__ out, int N,
                                          int Nt, int C, int K) {
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

template <bool kVec>
int launch_gather_rows(const float* table, const int* idx, float* out, int B,
                       int N, int Nt, int C, int K, size_t smem,
                       cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_rows_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((N + kRowsTile - 1) / kRowsTile, B);
  gather_rows_kernel<kVec><<<grid, kRowsThreads, smem, st>>>(table, idx, out,
                                                             N, Nt, C, K);
  return (int)cudaGetLastError();
}

// -- inverse adjacency --------------------------------------------------

constexpr int kInvThreads = 1024;
constexpr int kInvWarps = kInvThreads / 32;
constexpr int kInvTile = 256;      // rows of a block
constexpr int kInvUnroll = 4;      // loads of idx in flight a lane
// Staged edges a warp (shared memory): a warp's share of a cloud's edges
// points into a 256-row tile about NK / 32 * 256 / n_out times, plus up to
// 256 more where the share's own points (slot 0, the point itself) lie in
// the tile.
constexpr int kInvStage = 512;
constexpr int kInvWarpMax = 128;   // longer lists are ranked by the block
// Dynamic shared memory: the staged edges (id and row) and the tile's
// lists, and each warp's count, then place, of each row of the tile.
constexpr size_t kInvSmem = (size_t)kInvWarps * kInvStage * (4 + 1 + 4) +
                            (size_t)kInvWarps * kInvTile * 4;

__device__ __forceinline__ int warp_sum(int v) {
  for (int d = 16; d > 0; d /= 2) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// Row of an index: itself, or in the clamp mode JAX's reading of it.
template <bool kClamp>
__device__ __forceinline__ int inv_row(int j, int n_out) {
  if constexpr (kClamp) {
    if (j < 0) j += n_out;
    return j < 0 ? 0 : (j >= n_out ? n_out - 1 : j);
  }
  return j;
}

// One pass of warp w over its share of a cloud's edges, edges [start,
// end) with start = w * span: lane l takes V consecutive edges of each
// 32 V, kInvUnroll such loads in flight. It counts the edges that point
// below t0, counts each of the tile's rows in the warp's own counters
// (cw), and stages the tile's edges (id and row) in ascending edge order
// in the warp's region, as far as it holds kInvStage; `staged` (warp
// uniform) counts them all.
template <int V, bool kClamp>
__device__ __forceinline__ void stage_edges(const int* __restrict__ ib,
                                            int NK, int n_out, int t0, int T,
                                            int& below, int& staged,
                                            int* __restrict__ cw,
                                            int* __restrict__ se,
                                            unsigned char* __restrict__ sr) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int span = ((NK + kInvWarps - 1) / kInvWarps + 32 * V - 1) /
                   (32 * V) * (32 * V);
  const int start = warp * span, end = min(NK, start + span);
  for (int e0 = start; e0 < end; e0 += 32 * V * kInvUnroll) {
    int j[kInvUnroll][V];
#pragma unroll
    for (int u = 0; u < kInvUnroll; ++u) {
      const int e = e0 + (u * 32 + lane) * V;
      if constexpr (V == 4) {
        const int4 q = e < end ? *reinterpret_cast<const int4*>(ib + e)
                               : make_int4(-1, -1, -1, -1);
        j[u][0] = q.x; j[u][1] = q.y; j[u][2] = q.z; j[u][3] = q.w;
      } else {
        j[u][0] = e < end ? ib[e] : -1;
      }
    }
#pragma unroll
    for (int u = 0; u < kInvUnroll; ++u) {
      int mine = 0;
      if (e0 + (u * 32 + lane) * V < end)  // not the -1 past the share
#pragma unroll
        for (int c = 0; c < V; ++c) j[u][c] = inv_row<kClamp>(j[u][c], n_out);
#pragma unroll
      for (int c = 0; c < V; ++c) {
        below += (unsigned)j[u][c] < (unsigned)t0;
        mine += (unsigned)(j[u][c] - t0) < (unsigned)T;
      }
      int incl = mine;  // the warp's edges of the tile up to this lane's
      for (int d = 1; d < 32; d *= 2) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
      }
      int at = staged + incl - mine;
      const int e = e0 + (u * 32 + lane) * V;
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const int r = j[u][c] - t0;
        if ((unsigned)r < (unsigned)T) {
          atomicAdd(cw + r, 1);
          if (at < kInvStage) {
            se[at] = e + c;
            sr[at] = (unsigned char)r;
          }
          ++at;
        }
      }
      staged += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
}

// Writes list[0, L) to dst in ascending order (the entries are
// distinct): each entry's place is the number of smaller entries, counted
// by a warp with shuffles over 32-entry chunks.
__device__ __forceinline__ void warp_sort_list(const int* list, int L,
                                               int* __restrict__ dst) {
  const int lane = threadIdx.x % 32;
  for (int i0 = 0; i0 < L; i0 += 32) {
    const int e = i0 + lane < L ? list[i0 + lane] : INT_MAX;
    int rank = 0;
    for (int j0 = 0; j0 < L; j0 += 32) {
      const int other = j0 + lane < L ? list[j0 + lane] : INT_MAX;
      const int span = min(32, L - j0);
      for (int s = 0; s < span; ++s)
        rank += __shfl_sync(0xffffffffu, other, s) < e;
    }
    if (i0 + lane < L) dst[rank] = e;
  }
}

// A block owns rows [t0, t0 + T) of cloud b and builds their lists:
// 1. one pass over the cloud's edges, warp w over the w-th 32nd of them
//    (stage_edges): the edges that point below t0 (the tile's first
//    place, a block sum), each warp's count of each row, and the tile's
//    edges staged in each warp's region in ascending edge order;
// 2. a block scan of the rows' counts gives their offsets, and each
//    warp's place in each row (the counts of the warps before it);
// 3. each warp writes its staged edges at their places, in order, so
//    every list comes out ascending with no sort (shared memory), and
//    the block writes the tile's lists out.
// Where a warp's region overflows (a hub row in the tile), the tile reads
// the cloud's edges a second time, fills its lists in any order in the
// `scratch` buffer and sorts each (warp_sort_list; lists longer than
// kInvWarpMax by the whole block). The last tile writes the total and
// the -1 tail. No global atomics; the result does not depend on the order
// of the shared-memory ones.
template <bool kClamp>
__global__ void __launch_bounds__(kInvThreads)
inverse_adjacency_kernel(const int* __restrict__ idx,
                         int* __restrict__ offsets,
                         int* __restrict__ scratch, int* __restrict__ edges,
                         int N, int K, int n_out) {
  extern __shared__ int smem[];
  int* stage_e = smem;                                   // [warps][stage]
  int* lists = smem + kInvWarps * kInvStage;             // [warps * stage]
  int* cw = smem + 2 * kInvWarps * kInvStage;            // [warps][tile]
  unsigned char* stage_r = reinterpret_cast<unsigned char*>(
      cw + kInvWarps * kInvTile);                        // [warps][stage]
  __shared__ int off[kInvTile + 1];
  __shared__ int red[kInvWarps];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int NK = N * K;
  const long long b = blockIdx.y;
  const int t0 = blockIdx.x * kInvTile;
  const int T = min(kInvTile, n_out - t0);
  const int* ib = idx + b * NK;
  int* eb = edges + b * NK;
  int* ob = offsets + b * (n_out + 1);
  int* my_cw = cw + warp * kInvTile;
  for (int i = tid; i < kInvWarps * kInvTile; i += kInvThreads) cw[i] = 0;
  __syncthreads();
  int below = 0, staged = 0;  // staged: warp-uniform
  if ((reinterpret_cast<uintptr_t>(ib) & 15) == 0 && NK % 4 == 0)
    stage_edges<4, kClamp>(ib, NK, n_out, t0, T, below, staged, my_cw,
                           stage_e + warp * kInvStage,
                           stage_r + warp * kInvStage);
  else
    stage_edges<1, kClamp>(ib, NK, n_out, t0, T, below, staged, my_cw,
                           stage_e + warp * kInvStage,
                           stage_r + warp * kInvStage);
  below = warp_sum(below);
  if (lane == 0) red[warp] = below;
  __syncthreads();
  const int base = warp_sum(red[lane]);
  // Row tid's count (the warps' counts, which become each warp's place
  // within the row), then the exclusive scan of the T counts.
  int c = 0;
  if (tid < T)
    for (int w = 0; w < kInvWarps; ++w) {
      const int n = cw[w * kInvTile + tid];
      cw[w * kInvTile + tid] = c;
      c += n;
    }
  int incl = c;
  for (int d = 1; d < 32; d *= 2) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  const bool any_long = __syncthreads_or(c > kInvWarpMax);
  const bool spill = __syncthreads_or(lane == 0 && staged > kInvStage);
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += red[w];
  incl += before;
  if (tid < T) {
    off[tid] = incl - c;
    ob[t0 + tid] = base + incl - c;
    for (int w = 0; w < kInvWarps; ++w) cw[w * kInvTile + tid] += incl - c;
  }
  if (tid == T - 1) off[T] = incl;
  if (tid == T - 1 && t0 + T == n_out) ob[n_out] = base + incl;
  __syncthreads();
  if (!spill) {
    const unsigned lower = (1u << lane) - 1u;
    const int* se = stage_e + warp * kInvStage;
    const unsigned char* sr = stage_r + warp * kInvStage;
    for (int p0 = 0; p0 < staged; p0 += 32) {
      const int p = p0 + lane;
      const int r = p < staged ? sr[p] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, r);
      if (r >= 0) lists[my_cw[r] + __popc(peers & lower)] = se[p];
      __syncwarp();
      if (r >= 0 && (peers & lower) == 0) my_cw[r] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    for (int i = tid; i < off[T]; i += kInvThreads) eb[base + i] = lists[i];
  } else {
    int* sb = scratch + b * NK + base;
    int* cursor = cw;  // the warps' places are not needed on this path
    for (int i = tid; i < T; i += kInvThreads) cursor[i] = 0;
    __syncthreads();
    for (int e = tid; e < NK; e += kInvThreads) {
      const int r = inv_row<kClamp>(ib[e], n_out) - t0;
      if ((unsigned)r < (unsigned)T) sb[off[r] + atomicAdd(cursor + r, 1)] = e;
    }
    __syncthreads();  // the scratch lists are written (and visible)
    for (int r = warp; r < T; r += kInvWarps) {
      const int L = off[r + 1] - off[r];
      if (L <= kInvWarpMax)
        warp_sort_list(sb + off[r], L, eb + base + off[r]);
    }
    if (any_long)
      for (int r = 0; r < T; ++r) {
        const int L = off[r + 1] - off[r];
        if (L <= kInvWarpMax) continue;
        const int* list = sb + off[r];
        for (int i = tid; i < L; i += kInvThreads) {
          const int e = list[i];
          int rank = 0;
          for (int j = 0; j < L; ++j) rank += list[j] < e;
          eb[base + off[r] + rank] = e;
        }
      }
  }
  if (t0 + T == n_out)
    for (int i = base + off[T] + tid; i < NK; i += kInvThreads) eb[i] = -1;
}

// -- the destination-major sum ----------------------------------------

template <int V>
struct Vec {
  float x[V];
};

// V floats of channels c..c+V-1 of one edge row at p (channel stride sc;
// V > 1 only for sc == 1 and V-aligned rows). Each edge row is read
// once, so the vector loads stream past L1 and L2 (evict first).
template <int V>
__device__ __forceinline__ Vec<V> load_row(const float* __restrict__ p,
                                           int c, long long sc) {
  Vec<V> v;
  if constexpr (V == 4) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p + c));
    v.x[0] = q.x; v.x[1] = q.y; v.x[2] = q.z; v.x[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = __ldcs(reinterpret_cast<const float2*>(p + c));
    v.x[0] = q.x; v.x[1] = q.y;
  } else {
    v.x[0] = p[c * sc];
  }
  return v;
}

constexpr int kSumThreads = 256;

// A group of G = 2^g_log2 lanes per output row (b, m); lane l of the
// group holds vector slots u * G + l (u < U) of the block's channel
// tile. The group loads G of its list's edge ids at once (lane l the
// l-th, which it turns into the edge row's offset in g) and broadcasts
// the offsets by shuffles; R edges' row loads are in flight together,
// and their values are added one edge after another.
template <int V, int U, int R>
__global__ void __launch_bounds__(kSumThreads)
scatter_rows_kernel(const float* __restrict__ g,
                    const int* __restrict__ offsets,
                    const int* __restrict__ edges, float* __restrict__ out,
                    long long rows, int NK, int C, int K, int n_out,
                    int g_log2, long long sb, long long sc, long long sk,
                    long long sn) {
  const int G = 1 << g_log2;
  const long long r =
      ((long long)blockIdx.x * kSumThreads + threadIdx.x) >> g_log2;
  if (r >= rows) return;  // the whole group
  const int lane = threadIdx.x & (G - 1);
  const unsigned group =
      (G == 32 ? 0xffffffffu : ((1u << G) - 1u))
      << ((threadIdx.x % 32) & ~(G - 1));
  const long long b = r / n_out;
  const int m = (int)(r - b * n_out);
  const int* off = offsets + b * (n_out + 1);
  const int start = off[m], end = off[m + 1];
  const int* list = edges + b * NK;
  const float* gb = g + b * sb;
  int cs[U];
  bool on[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    cs[u] = blockIdx.y * (G * V * U) + (u * G + lane) * V;
    on[u] = cs[u] < C;
  }
  float acc[U][V];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int t = 0; t < V; ++t) acc[u][t] = 0.0f;
  for (int i0 = start; i0 < end; i0 += G) {
    long long mine = 0;  // lane l: the offset of the group's l-th edge row
    if (i0 + lane < end) {
      const int e = list[i0 + lane];
      const int n = e / K;
      mine = n * sn + (e - n * K) * sk;
    }
    const int n_ids = min(G, end - i0);
    for (int q0 = 0; q0 < n_ids; q0 += R) {
      Vec<V> v[R][U];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const long long at = __shfl_sync(group, mine, q0 + q, G);
        if (q0 + q < n_ids) {
          const float* p = gb + at;
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (on[u]) v[q][u] = load_row<V>(p, cs[u], sc);
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q)
        if (q0 + q < n_ids)
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (on[u])
#pragma unroll
              for (int t = 0; t < V; ++t) acc[u][t] += v[q][u].x[t];
    }
  }
  float* o = out + r * C;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (!on[u]) continue;
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(o + cs[u]) =
          make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
    } else if constexpr (V == 2) {
      *reinterpret_cast<float2*>(o + cs[u]) =
          make_float2(acc[u][0], acc[u][1]);
    } else {
      o[cs[u]] = acc[u][0];
    }
  }
}

struct ScatterArgs {
  const float* g;
  const int* offsets;
  const int* edges;
  float* out;
  long long rows;
  int NK, C, K, n_out, g_log2;
  long long sb, sc, sk, sn;
};

// Edges in flight: 4 rows of 16 floats a lane at the widest, 8 below.
template <int V, int U>
void launch_scatter(dim3 grid, cudaStream_t stream, const ScatterArgs& a) {
  constexpr int R = V * U >= 8 ? 4 : 8;
  scatter_rows_kernel<V, U, R><<<grid, kSumThreads, 0, stream>>>(
      a.g, a.offsets, a.edges, a.out, a.rows, a.NK, a.C, a.K, a.n_out,
      a.g_log2, a.sb, a.sc, a.sk, a.sn);
}

template <int V>
void launch_scatter_u(int U, dim3 grid, cudaStream_t stream,
                      const ScatterArgs& a) {
  if (U == 1)
    launch_scatter<V, 1>(grid, stream, a);
  else if (U == 2)
    launch_scatter<V, 2>(grid, stream, a);
  else
    launch_scatter<V, 4>(grid, stream, a);
}

}  // namespace

extern "C" int dc_gather_rows(const void* table, const void* idx, void* out,
                              int B, int N, int Nt, int C, int K, int device,
                              void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C * K == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const float* t = (const float*)table;
  const int* ix = (const int*)idx;
  float* o = (float*)out;
  const size_t smem = gather_rows_smem(K, Nt, C);
  if ((long long)Nt * C * 4 <= kRowsStageMax && smem <= kRowsSmemMax) {
    return N % 4 == 0 && ((uintptr_t)out & 15) == 0
               ? launch_gather_rows<true>(t, ix, o, B, N, Nt, C, K, smem, st)
               : launch_gather_rows<false>(t, ix, o, B, N, Nt, C, K, smem,
                                           st);
  }
  const int threads = 128;
  const dim3 grid((N + threads - 1) / threads, K, B);
  gather_rows_direct_kernel<<<grid, threads, 0, st>>>(t, ix, o, N, Nt, C, K);
  return (int)cudaGetLastError();
}

namespace {

template <bool kClamp>
int launch_inverse_adjacency(const int* idx, int* offsets, int* scratch,
                             int* edges, int B, int N, int K, int n_out,
                             cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      inverse_adjacency_kernel<kClamp>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kInvSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)((n_out + kInvTile - 1) / kInvTile), B);
  inverse_adjacency_kernel<kClamp><<<grid, kInvThreads, kInvSmem, st>>>(
      idx, offsets, scratch, edges, N, K, n_out);
  return (int)cudaGetLastError();
}

}  // namespace

// scratch [B, N * K] i32: the unordered lists; clamp: read each index as
// JAX's indexing does (a negative one from the end, then clamped), so
// that every edge is listed.
extern "C" int dc_inverse_adjacency(const void* idx, void* offsets,
                                    void* scratch, void* edges, int B, int N,
                                    int K, int n_out, int clamp, int device,
                                    void* stream) {
  DC_SET_DEVICE(device);
  cudaStream_t st = (cudaStream_t)stream;
  const long long NK = (long long)N * K;
  if (B == 0) return (int)cudaGetLastError();
  if (n_out == 0) {  // every edge out of range
    cudaError_t err = cudaMemsetAsync(offsets, 0, sizeof(int) * B, st);
    if (err == cudaSuccess && NK > 0)
      err = cudaMemsetAsync(edges, 0xff, sizeof(int) * B * NK, st);
    return err == cudaSuccess ? (int)cudaGetLastError() : (int)err;
  }
  return clamp ? launch_inverse_adjacency<true>(
                     (const int*)idx, (int*)offsets, (int*)scratch,
                     (int*)edges, B, N, K, n_out, st)
               : launch_inverse_adjacency<false>(
                     (const int*)idx, (int*)offsets, (int*)scratch,
                     (int*)edges, B, N, K, n_out, st);
}

// g's strides (in floats) for b, c, k, n; out [B, n_out, C] is written
// whole.
extern "C" int dc_scatter_rows(const void* g, const void* offsets,
                               const void* edges, void* out, int B, int N,
                               int C, int K, int n_out, long long sb,
                               long long sc, long long sk, long long sn,
                               int device, void* stream) {
  DC_SET_DEVICE(device);
  const long long rows = (long long)B * n_out;
  if (rows * C == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  // The widest vector that every edge row's channels allow.
  const uintptr_t addr = (uintptr_t)g;
  auto fits = [&](int v) {
    return sc == 1 && C % v == 0 && sb % v == 0 && sk % v == 0 &&
           sn % v == 0 && addr % (sizeof(float) * v) == 0;
  };
  const int V = fits(4) ? 4 : (fits(2) ? 2 : 1);
  const int slots = C / V;  // vector slots of a row
  int g_log2 = 0;
  while ((1 << g_log2) < std::min(slots, 32)) ++g_log2;
  const int G = 1 << g_log2;
  const int need = (slots + G - 1) / G;
  const int U = need >= 3 ? 4 : need;
  const dim3 grid(
      (unsigned int)((rows * G + kSumThreads - 1) / kSumThreads),
      (unsigned int)((slots + G * U - 1) / (G * U)));
  const ScatterArgs a{(const float*)g, (const int*)offsets,
                      (const int*)edges, (float*)out, rows, N * K, C, K,
                      n_out, g_log2, sb, sc, sk, sn};
  if (V == 4)
    launch_scatter_u<4>(U, grid, st, a);
  else if (V == 2)
    launch_scatter_u<2>(U, grid, st, a);
  else
    launch_scatter_u<1>(U, grid, st, a);
  return (int)cudaGetLastError();
}

extern "C" const char* dc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
