// Fused centralized edge MLP of the depth-2 train branch (bf16 in, f32
// accumulate), forward and backward.
//
// Forward, for every slot k >= 1 of every point n of cloud b:
//   y0  = f32(y[b, j]) - f32(y[b, n]),  j = idx[b, n, k] read as JAX reads
//         an index: a negative one from the end, then clamped to [0, N)
//   h   = bf16(LeakyReLU(y0 * a0 + b0))          (each operation rounded)
//   out[b, k, n, :] = bf16(h @ W1)               (f32 sums, K-major)
// and out[b, 0, n, :] = bf16(z0).
//
// Backward, from the bf16 cotangent g[b, k, n, :] of slots k >= 1:
//   dh   = g @ W1^T (f32 sums),  dpre = dh * (pre >= 0 ? 1 : 0.2)
//   dy0  = dpre * a0
//   dy[b, j] += bf16(dy0),  dy[b, n] -= sum_k dy0 (unrounded)
//   dW1  = sum h^T g,  da0 = sum dpre * y0,  db0 = sum dpre
// with y0 recomputed from y. dW1 and (da0, db0)
// are written as one partial a block ([blocks, C0, C1], [blocks, 2, C0]),
// which the wrapper sums in a fixed order. dy is the exact sum of its
// addends rounded once to f32: the edge terms go into an f64 accumulator
// (the caller's scratch, zero-filled inside the call) by atomics, each
// point's self term is summed in f64 in slot order by one thread and
// added to its row once, and a second kernel rounds the accumulator. The
// f32 (or bf16) addends of one (row, channel) sum exactly in f64 unless
// they span more than ~29 binary orders, so two calls give the same bits
// whatever order the atomics land in, and so does the plain version,
// which sums in f64 too.
//
// y [B, N, C0] bf16, idx [B, N, K] i32, ab = (a0, b0) [2, C0] f32, W1
// [C0, C1] bf16, z0 [C1] f32, g [B, K, N, C1] bf16; C0 and C1 multiples
// of 16 up to 128 (the wrapper zero-pads: a zero channel stays zero), every
// array 16-byte aligned. Every affine operation is rounded on its own (no
// FMA contraction), as the plain version's.
//
// Replaces the Pallas kernels of deltaconv_tpu/ops/edge_mlp.py:
// `_pallas_fwd` (pallas_call at edge_mlp.py:192, body `_fwd_kernel`) and
// `_pallas_bwd` (edge_mlp.py:244, `_bwd_kernel`). Those gathered the
// neighbour rows with a [(K-1) T, N] one-hot MXU product inside a 56 MB
// VMEM budget, and the forward wrote the f32 y0 of every edge so that the
// backward could skip a second one-hot gather. Here a warp loads each
// neighbour row directly (y is 4 MB at the segmentation shape and stays
// in L2), and the backward gathers it again and recomputes y0 bit for bit
// instead of reading a stash (timed on the card against an f32 stash and
// kept: PERF.md, section 6).
//
// Bound on the H100 at the segmentation train shape (B=16, N=2048, K=30,
// C0 = C1 = 64): the forward writes 126 MB of y1 (0.038 ms at 3.35
// TB/s) for 7.8 GFLOP (0.008 ms on the tensor cores); the backward reads
// the same 126 MB of g. Memory, then.
// Design: a block takes 16 points (one WMMA row tile); its 8 warps take
// its slots in turn, each slot a 16-row tile: the warp gathers the rows,
// forms h in shared memory and multiplies it by W1 (shared memory, WMMA
// 16x16x16), then stores the tile's 16 contiguous output rows with
// 16-byte stores. The backward's warps form one slot each the same way
// (the cotangent tile, h, dh = g W1^T), add the edge terms of dy with f64
// atomics, leave each dy0 in place of its dh, keep (da0, db0) a lane per
// channel; after each pass of 8 slots the block's threads add the pass's
// dy0 of each (point, channel) to its self sum in slot order (f64
// registers, one thread an element), and every warp adds h^T g of all 8
// to its own tiles of dW1, kept in registers over all the points the
// block walks.
#include "common.cuh"

#include <cuda_bf16.h>
#include <mma.h>

namespace {

constexpr int kWarps = 8;
constexpr int kPoints = 16;   // points a tile: the rows of one WMMA tile
constexpr int kMaxAcc = 8;    // dW1 tiles a warp: (C0 / 16)(C1 / 16) <= 64
// Self sums a thread: a tile's kPoints x C0 (C0 <= 128) elements over the
// block's threads.
constexpr int kSelfPer = kPoints * 128 / (kWarps * 32);

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float lrelu(float v) {
  return v >= 0.0f ? v : __fmul_rn(0.2f, v);
}

// Row strides in shared memory (elements): 8 bf16 or 4 f32 of padding
// keep the rows of a WMMA load off one bank and every row 32-byte aligned.
struct Ld {
  int h0, w1, f0, f1;  // bf16 rows of C0, bf16 rows of C1, f32 of C0, C1
};

__host__ __device__ inline Ld strides(int C0, int C1) {
  return Ld{C0 + 8, C1 + 8, C0 + 4, C1 + 4};
}

// The 8 f32 edge values y0 of 8 channels (16 bytes of bf16 each).
__device__ __forceinline__ void edge8(uint4 yj, uint4 ys, float* y0) {
  const __nv_bfloat16* pj = reinterpret_cast<const __nv_bfloat16*>(&yj);
  const __nv_bfloat16* ps = reinterpret_cast<const __nv_bfloat16*>(&ys);
#pragma unroll
  for (int v = 0; v < 8; ++v)
    y0[v] = __fsub_rn(__bfloat162float(pj[v]), __bfloat162float(ps[v]));
}

// bf16(LeakyReLU(y0 * a0 + b0)) of 8 channels from channel c.
__device__ __forceinline__ uint4 hidden8(const float* y0, const float* ab,
                                         int c, int C0) {
  uint4 r;
  __nv_bfloat16* pr = reinterpret_cast<__nv_bfloat16*>(&r);
#pragma unroll
  for (int v = 0; v < 8; ++v)
    pr[v] = __float2bfloat16_rn(lrelu(__fadd_rn(
        __fmul_rn(y0[v], ab[c + v]), ab[C0 + c + v])));
  return r;
}

__device__ __forceinline__ int nbr(const int* idx, long long bn, int K,
                                   int k, int N) {
  int j = idx[bn * K + k];
  if (j < 0) j += N;
  return j < 0 ? 0 : (j >= N ? N - 1 : j);
}

// W1 [C0, C1] into shared memory rows of stride ld.
__device__ __forceinline__ void load_w1(__nv_bfloat16* w1s,
                                        const __nv_bfloat16* w1, int C0,
                                        int C1, int ld) {
  const int per_row = C1 / 8;
  for (int t = threadIdx.x; t < C0 * per_row; t += blockDim.x) {
    const int r = t / per_row, q = t % per_row;
    reinterpret_cast<uint4*>(w1s + (long long)r * ld)[q] =
        reinterpret_cast<const uint4*>(w1 + (long long)r * C1)[q];
  }
}

// The tile's own rows y[b, n0 + p] (zero past N).
__device__ __forceinline__ void load_self(__nv_bfloat16* yi,
                                          const __nv_bfloat16* yb, int n0,
                                          int rows, int C0, int ld) {
  const int per_row = C0 / 8;
  for (int t = threadIdx.x; t < kPoints * per_row; t += blockDim.x) {
    const int p = t / per_row, q = t % per_row;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (p < rows)
      v = reinterpret_cast<const uint4*>(yb + (long long)(n0 + p) * C0)[q];
    reinterpret_cast<uint4*>(yi + p * ld)[q] = v;
  }
}

struct FwdSmem {
  size_t yi, h, s, total;
};

__host__ __device__ inline FwdSmem fwd_smem(int C0, int C1) {
  const Ld ld = strides(C0, C1);
  FwdSmem m;
  m.yi = (size_t)C0 * ld.w1 * 2;
  m.h = m.yi + (size_t)kPoints * ld.h0 * 2;
  m.s = m.h + (size_t)kWarps * kPoints * ld.h0 * 2;
  m.total = m.s + (size_t)kWarps * kPoints * ld.f1 * 4;
  return m;
}

__global__ void __launch_bounds__(kWarps * 32) edge_mlp_fwd_kernel(
    const __nv_bfloat16* __restrict__ y, const int* __restrict__ idx,
    const float* __restrict__ ab, const __nv_bfloat16* __restrict__ w1,
    const float* __restrict__ z0, __nv_bfloat16* __restrict__ out, int N,
    int K, int C0, int C1) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const Ld ld = strides(C0, C1);
  const FwdSmem lay = fwd_smem(C0, C1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* yi = reinterpret_cast<__nv_bfloat16*>(smem + lay.yi);
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem + lay.h) +
                      warp * kPoints * ld.h0;
  float* sc = reinterpret_cast<float*>(smem + lay.s) + warp * kPoints * ld.f1;

  const int tiles = (N + kPoints - 1) / kPoints;
  const int b = blockIdx.x / tiles, n0 = (blockIdx.x % tiles) * kPoints;
  const int rows = min(kPoints, N - n0);
  const __nv_bfloat16* yb = y + (long long)b * N * C0;
  load_w1(w1s, w1, C0, C1, ld.w1);
  load_self(yi, yb, n0, rows, C0, ld.h0);
  // Slot 0, the zero edge: bf16(z0) on every row.
  for (int t = threadIdx.x; t < rows * C1; t += blockDim.x)
    out[((long long)b * K * N + n0 + t / C1) * C1 + t % C1] =
        __float2bfloat16_rn(z0[t % C1]);
  __syncthreads();

  const int v0 = C0 / 8, v1 = C1 / 8;  // 16-byte vectors a row
  for (int k = 1 + warp; k < K; k += kWarps) {
    for (int t = lane; t < kPoints * v0; t += 32) {
      const int p = t / v0, q = t % v0;
      uint4 hv = make_uint4(0u, 0u, 0u, 0u);
      if (p < rows) {
        const long long bn = (long long)b * N + n0 + p;
        const int j = nbr(idx, bn, K, k, N);
        float y0[8];
        edge8(reinterpret_cast<const uint4*>(yb + (long long)j * C0)[q],
              reinterpret_cast<const uint4*>(yi + p * ld.h0)[q], y0);
        hv = hidden8(y0, ab, q * 8, C0);
      }
      reinterpret_cast<uint4*>(hs + p * ld.h0)[q] = hv;
    }
    __syncwarp();
    for (int nf = 0; nf < C1 / 16; ++nf) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int ks = 0; ks < C0 / 16; ++ks) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> w;
        wmma::load_matrix_sync(a, hs + ks * 16, ld.h0);
        wmma::load_matrix_sync(w, w1s + ks * 16 * ld.w1 + nf * 16, ld.w1);
        wmma::mma_sync(acc, a, w, acc);
      }
      wmma::store_matrix_sync(sc + nf * 16, acc, ld.f1, wmma::mem_row_major);
    }
    __syncwarp();
    // The tile's rows are contiguous in the K-major output.
    __nv_bfloat16* dst = out + (((long long)b * K + k) * N + n0) * C1;
    for (int t = lane; t < rows * v1; t += 32) {
      const int p = t / v1, q = t % v1;
      const float* src = sc + p * ld.f1 + q * 8;
      uint4 o;
      __nv_bfloat16* po = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
      for (int v = 0; v < 8; ++v) po[v] = __float2bfloat16_rn(src[v]);
      reinterpret_cast<uint4*>(dst + (long long)p * C1)[q] = o;
    }
    __syncwarp();
  }
}

struct BwdSmem {
  size_t yi, g, h, yj, d, dab, total;
};

__host__ __device__ inline BwdSmem bwd_smem(int C0, int C1) {
  const Ld ld = strides(C0, C1);
  BwdSmem m;
  m.yi = (size_t)C0 * ld.w1 * 2;
  m.g = m.yi + (size_t)kPoints * ld.h0 * 2;
  m.h = m.g + (size_t)kWarps * kPoints * ld.w1 * 2;
  m.yj = m.h + (size_t)kWarps * kPoints * ld.h0 * 2;
  m.d = m.yj + (size_t)kWarps * kPoints * ld.h0 * 2;
  m.dab = m.d + (size_t)kWarps * kPoints * ld.f0 * 4;
  m.total = m.dab + (size_t)kWarps * 2 * C0 * 4;
  return m;
}

__global__ void __launch_bounds__(kWarps * 32) edge_mlp_bwd_kernel(
    const __nv_bfloat16* __restrict__ y, const int* __restrict__ idx,
    const float* __restrict__ ab, const __nv_bfloat16* __restrict__ w1,
    const __nv_bfloat16* __restrict__ g, double* __restrict__ dy_acc,
    float* __restrict__ dw1_part,
    float* __restrict__ dab_part, int B, int N, int K, int C0, int C1) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const Ld ld = strides(C0, C1);
  const BwdSmem lay = bwd_smem(C0, C1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* yi = reinterpret_cast<__nv_bfloat16*>(smem + lay.yi);
  __nv_bfloat16* gs0 = reinterpret_cast<__nv_bfloat16*>(smem + lay.g);
  __nv_bfloat16* hs0 = reinterpret_cast<__nv_bfloat16*>(smem + lay.h);
  __nv_bfloat16* yj = reinterpret_cast<__nv_bfloat16*>(smem + lay.yj) +
                      warp * kPoints * ld.h0;
  float* ds0 = reinterpret_cast<float*>(smem + lay.d);
  float* ds = ds0 + warp * kPoints * ld.f0;
  float* wdab = reinterpret_cast<float*>(smem + lay.dab);
  __nv_bfloat16* gs = gs0 + warp * kPoints * ld.w1;
  __nv_bfloat16* hs = hs0 + warp * kPoints * ld.h0;

  const int t0 = C0 / 16, t1 = C1 / 16, n_acc = t0 * t1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) wmma::fill_fragment(acc[i], 0.0f);
  load_w1(w1s, w1, C0, C1, ld.w1);
  double self[kSelfPer];  // element threadIdx.x + i blockDim.x of the tile
#pragma unroll
  for (int i = 0; i < kSelfPer; ++i) self[i] = 0.0;
  for (int t = threadIdx.x; t < kWarps * 2 * C0; t += blockDim.x)
    wdab[t] = 0.0f;

  const int v0 = C0 / 8, v1 = C1 / 8;
  const int tiles = (N + kPoints - 1) / kPoints;
  for (int tile = blockIdx.x; tile < B * tiles; tile += gridDim.x) {
    const int b = tile / tiles, n0 = (tile % tiles) * kPoints;
    const int rows = min(kPoints, N - n0);
    const __nv_bfloat16* yb = y + (long long)b * N * C0;
    load_self(yi, yb, n0, rows, C0, ld.h0);
    __syncthreads();
    for (int ks0 = 1; ks0 < K; ks0 += kWarps) {
      const int k = ks0 + warp;
      if (k < K) {
        // The cotangent tile: 16 contiguous rows of g[b, k].
        const __nv_bfloat16* gk = g + (((long long)b * K + k) * N + n0) * C1;
        for (int t = lane; t < kPoints * v1; t += 32) {
          const int p = t / v1, q = t % v1;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (p < rows)
            v = reinterpret_cast<const uint4*>(gk + (long long)p * C1)[q];
          reinterpret_cast<uint4*>(gs + p * ld.w1)[q] = v;
        }
        // The edges again: h (and the gathered rows, for y0 below).
        for (int t = lane; t < kPoints * v0; t += 32) {
          const int p = t / v0, q = t % v0;
          uint4 hv = make_uint4(0u, 0u, 0u, 0u), jv = hv;
          if (p < rows) {
            const long long bn = (long long)b * N + n0 + p;
            jv = reinterpret_cast<const uint4*>(
                yb + (long long)nbr(idx, bn, K, k, N) * C0)[q];
            float y0[8];
            edge8(jv, reinterpret_cast<const uint4*>(yi + p * ld.h0)[q], y0);
            hv = hidden8(y0, ab, q * 8, C0);
          }
          reinterpret_cast<uint4*>(hs + p * ld.h0)[q] = hv;
          reinterpret_cast<uint4*>(yj + p * ld.h0)[q] = jv;
        }
        __syncwarp();
        // dh = g W1^T: W1^T is W1's rows read column-major.
        for (int nf = 0; nf < t0; ++nf) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> d;
          wmma::fill_fragment(d, 0.0f);
          for (int ks = 0; ks < t1; ++ks) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> a;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::col_major> wt;
            wmma::load_matrix_sync(a, gs + ks * 16, ld.w1);
            wmma::load_matrix_sync(wt, w1s + nf * 16 * ld.w1 + ks * 16,
                                   ld.w1);
            wmma::mma_sync(d, a, wt, d);
          }
          wmma::store_matrix_sync(ds + nf * 16, d, ld.f0,
                                  wmma::mem_row_major);
        }
        __syncwarp();
        // The edge terms: a lane a channel, over the tile's rows.
        for (int c = lane; c < C0; c += 32) {
          const float a0 = ab[c], b0 = ab[C0 + c];
          float da = 0.0f, db = 0.0f;
          for (int p = 0; p < rows; ++p) {
            const long long bn = (long long)b * N + n0 + p;
            const float y0 = __fsub_rn(__bfloat162float(yj[p * ld.h0 + c]),
                                       __bfloat162float(yi[p * ld.h0 + c]));
            const float pre = __fadd_rn(__fmul_rn(y0, a0), b0);
            const float dpre =
                __fmul_rn(ds[p * ld.f0 + c], pre >= 0.0f ? 1.0f : 0.2f);
            const float dy0 = __fmul_rn(dpre, a0);
            const long long j = (long long)b * N + nbr(idx, bn, K, k, N);
            atomicAdd(dy_acc + j * C0 + c, (double)round_bf16(dy0));
            ds[p * ld.f0 + c] = dy0;  // the self sum's, after the barrier
            da = __fadd_rn(da, __fmul_rn(dpre, y0));
            db = __fadd_rn(db, dpre);
          }
          wdab[warp * 2 * C0 + c] += da;
          wdab[(warp * 2 + 1) * C0 + c] += db;
        }
      }
      __syncthreads();
      const int n_slots = min(kWarps, K - ks0);
      // The self sums: the pass's dy0 of each element, in slot order.
#pragma unroll
      for (int i = 0; i < kSelfPer; ++i) {
        const int t = threadIdx.x + i * blockDim.x;
        if (t < rows * C0) {
          const float* d = ds0 + (t / C0) * ld.f0 + t % C0;
          for (int s = 0; s < n_slots; ++s)
            self[i] += (double)d[s * kPoints * ld.f0];
        }
      }
      // dW1 += h^T g over the pass's slots: h^T is h read column-major.
#pragma unroll
      for (int i = 0; i < kMaxAcc; ++i) {
        const int t = warp + i * kWarps;
        if (t >= n_acc) break;
        const int ti = t / t1, tj = t % t1;
        for (int s = 0; s < n_slots; ++s) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> ht;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> gt;
          wmma::load_matrix_sync(ht, hs0 + s * kPoints * ld.h0 + ti * 16,
                                 ld.h0);
          wmma::load_matrix_sync(gt, gs0 + s * kPoints * ld.w1 + tj * 16,
                                 ld.w1);
          wmma::mma_sync(acc[i], ht, gt, acc[i]);
        }
      }
      __syncthreads();
    }
    // The self term: minus the unrounded sum over the slots.
#pragma unroll
    for (int i = 0; i < kSelfPer; ++i) {
      const int t = threadIdx.x + i * blockDim.x;
      if (t < rows * C0)
        atomicAdd(dy_acc + ((long long)b * N + n0) * C0 + t, -self[i]);
      self[i] = 0.0;
    }
    __syncthreads();
  }
  float* part = dw1_part + (long long)blockIdx.x * C0 * C1;
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int t = warp + i * kWarps;
    if (t >= n_acc) break;
    wmma::store_matrix_sync(part + (t / t1) * 16 * C1 + (t % t1) * 16, acc[i],
                            C1, wmma::mem_row_major);
  }
  for (int t = threadIdx.x; t < 2 * C0; t += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, wdab[w * 2 * C0 + t]);
    dab_part[(long long)blockIdx.x * 2 * C0 + t] = s;
  }
}

bool widths_ok(int C0, int C1) {
  return C0 > 0 && C1 > 0 && C0 % 16 == 0 && C1 % 16 == 0 &&
         (C0 / 16) * (C1 / 16) <= kWarps * kMaxAcc;
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" int dc_edge_mlp_fwd(const void* y, const void* idx, const void* ab,
                               const void* w1, const void* z0, void* out,
                               int B, int N, int K, int C0, int C1,
                               int device, void* stream) {
  DC_SET_DEVICE(device);
  if (K < 1 || !widths_ok(C0, C1)) return (int)cudaErrorInvalidValue;
  if ((long long)B * N == 0) return (int)cudaGetLastError();
  const size_t smem = fwd_smem(C0, C1).total;
  const cudaError_t err =
      set_smem(reinterpret_cast<const void*>(edge_mlp_fwd_kernel), smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * ((N + kPoints - 1) / kPoints);
  edge_mlp_fwd_kernel<<<(unsigned)blocks, kWarps * 32, smem,
                        (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)y, (const int*)idx, (const float*)ab,
      (const __nv_bfloat16*)w1, (const float*)z0, (__nv_bfloat16*)out, N, K,
      C0, C1);
  return (int)cudaGetLastError();
}

// dy [B, N, C0] f32 out; acc [B, N, C0] f64 scratch (zero-filled here,
// 16-byte aligned); blocks: the grid, the rows of the partials.
extern "C" int dc_edge_mlp_bwd(const void* y, const void* idx, const void* ab,
                               const void* w1, const void* g, void* dy,
                               void* acc, void* dw1_part, void* dab_part,
                               int B, int N, int K, int C0, int C1,
                               int blocks, int device, void* stream) {
  DC_SET_DEVICE(device);
  if (K < 1 || blocks < 1 || !widths_ok(C0, C1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem(C0, C1).total;
  cudaError_t err =
      set_smem(reinterpret_cast<const void*>(edge_mlp_bwd_kernel), smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const long long total = (long long)B * N * C0;
  err = cudaMemsetAsync(acc, 0, total * sizeof(double), s);
  if (err != cudaSuccess) return (int)err;
  edge_mlp_bwd_kernel<<<(unsigned)blocks, kWarps * 32, smem, s>>>(
      (const __nv_bfloat16*)y, (const int*)idx, (const float*)ab,
      (const __nv_bfloat16*)w1, (const __nv_bfloat16*)g, (double*)acc,
      (float*)dw1_part, (float*)dab_part, B, N, K, C0, C1);
  if (total > 0) dc_round_f64(acc, dy, total, s);
  return (int)cudaGetLastError();
}
