// Dense grad/div operators from the per-edge coefficients:
//   w_grad[b, d, n, idx[b, n, k]] += grad_coef[b, n, k, d]
//   w_div [b, d, n, idx[b, n, k]] += div_coef [b, n, k, d]
// idx [B, N, K] i32, grad_coef/div_coef [B, N, K, 2] f32 (or, with
// `planes` set, [B, 2, N, K]: the fused eval build's layout, JAX's
// `densify_coef_planes` entry)
//   -> w_grad, w_div [B, 2, N, N] f32 (`dc_densify`) or bf16
//   (`dc_densify_bf16`), zero where no edge lands; or the quantized
//   int8 planes (`dc_densify_int8`, below). `dc_densify_bwd` is the VJP
//   (below).
//
// Replaces the Pallas kernel of deltaconv_tpu/ops/densify_op.py
// (`densify_coef_planes`, pallas_call at densify_op.py:249) in both of
// its bodies: the f32 `_fwd_kernel` and the bf16 `_fwd_kernel_bf16`. The
// TPU built each row tile in VMEM by K masked select-accumulates over a
// [T, N] column iota; here a block owns one row (b, n) of all four
// planes, stages the row's K indices and coefficients in shared memory,
// and every thread writes its columns once: zero, plus the coefficients
// of the slots that land there. No other block writes the row, so no
// atomics are needed.
//
// Coefficients are ADDED in f32, in slot order, never stored: on the
// masked path the padded kNN slots are clamped to the point itself with
// a zero coefficient (geometry/knn.py), so a column can be hit twice and
// a store would overwrite slot 0's real self coefficient. The TPU kernel
// sums too.
//
// The bf16 body rounds the f32 sum once, to nearest even
// (__float2bfloat16_rn). The TPU's bf16 body rounds each coefficient and
// ORs the bits into place with -0.0 made +0.0; that is the same value,
// because the kNN gives every real slot its own column, a clamped slot
// adds +0.0 to it, and +0.0 + -0.0 is +0.0.
//
// Bound on the H100: the stores, 4 * N * N * 4 bytes per cloud in f32
// (512 MB at B=32, N=1024), half that in bf16, written as 16-byte
// (f32) or 8-byte (bf16) vectors where N % 4 == 0. The K compares per
// stored vector come from shared memory.
//
// `dc_densify_int8`: the int8 serving form. idx, grad_coef, div_coef as
// above and the per-cloud scales s_grad, s_div [B] f32 (max |coef| of
// the cloud's grad or div coefficients, at least 1e-30; torch ops in the
// wrapper) -> w_grad, w_div [B, 2, N, N] int8, each coefficient
// quantized to clip(rint(coef / s * 127), -127, 127): the IEEE division
// (__fdiv_rn), then the product (__fmul_rn), rounded half to even
// (rintf), the order of torch's `round(coef / s * 127)` and of JAX's
// `_quantize_pack` (densify_op.py:143-162). Replaces the Pallas kernel
// `densify_coefs_int8` (pallas_call at densify_op.py:180, body
// `_fwd_kernel_int8`), which packed the four planes' bytes into one int32
// and ORed them into place because Mosaic could not select below 32
// bits. Here a block row (threadIdx.y) owns one row (b, n) of the four
// planes, several rows a block of 256 threads; its threads quantize the
// row's 4 K values into shared memory, one a thread, then each thread
// ADDS the quantized values of the slots that land in its 4 columns, in
// int32, and stores each plane's 4 bytes as one 4-byte word where
// N % 4 == 0, as the bf16 body does (16 columns a thread, with 16-byte
// stores, ran slower on the H100). Adding equals the TPU's OR wherever at
// most one value of a column is nonzero (a clamped padded slot quantizes
// to 0), and it is the JAX CPU fallback's one-hot sum
// (geometry/dense.py:265-278) everywhere. Bound: the stores, 4 * N * N
// bytes per cloud (134 MB at B=32, N=1024).
//
// `dc_densify_bwd`: the VJP of the f32 and bf16 bodies, idx [B, N, K]
// i32 and the cotangents dwg, dwd [B, 2, N, N] f32 -> d_grad, d_div
// [B, N, K, 2] f32 with d[b, n, k, c] = dW[b, c, n, idx[b, n, k]] (an
// index outside [0, N) reads 0). Replaces `_densify_bwd` (pallas_call at
// densify_op.py:281, body `_bwd_kernel`), which scanned all N columns of
// a row tile with a one-hot select per slot; here a thread owns an edge
// (b, n, k) and loads its four entries directly. The K edges of a row
// read one row of each plane, so a warp's loads fall in a few rows.
// Bound: the indices, the 4 entries an edge reads and the outputs.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ void store4(float* row, int q, const float* v) {
  reinterpret_cast<float4*>(row)[q] = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* row, int q,
                                       const float* v) {
  __nv_bfloat162 lo, hi;
  lo.x = __float2bfloat16_rn(v[0]);
  lo.y = __float2bfloat16_rn(v[1]);
  hi.x = __float2bfloat16_rn(v[2]);
  hi.y = __float2bfloat16_rn(v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  reinterpret_cast<uint2*>(row)[q] = u;
}

__device__ __forceinline__ void store1(float* row, int m, float v) {
  row[m] = v;
}

__device__ __forceinline__ void store1(__nv_bfloat16* row, int m, float v) {
  row[m] = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void densify_kernel(const int* __restrict__ idx,
                               const float* __restrict__ grad_coef,
                               const float* __restrict__ div_coef,
                               T* __restrict__ w_grad, T* __restrict__ w_div,
                               int N, int K, int planes) {
  extern __shared__ float smem[];
  int* s_idx = reinterpret_cast<int*>(smem);  // [K]
  float* s_coef = smem + K;                   // [4, K]: g1, g2, d1, d2

  const long long n = blockIdx.x;
  const long long b = blockIdx.y;
  const long long row = (b * N + n) * K;
  // Element (d, k) of the row's coefficients: [B, N, K, 2] or [B, 2, N, K].
  const long long base = planes ? (b * 2 * N + n) * K : row * 2;
  const long long sk = planes ? 1 : 2;
  const long long sd = planes ? (long long)N * K : 1;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    s_idx[k] = idx[row + k];
    s_coef[k] = grad_coef[base + k * sk];
    s_coef[K + k] = grad_coef[base + k * sk + sd];
    s_coef[2 * K + k] = div_coef[base + k * sk];
    s_coef[3 * K + k] = div_coef[base + k * sk + sd];
  }
  __syncthreads();

  const long long nn = (long long)N * N;
  T* rows[4] = {w_grad + (b * 2 + 0) * nn + n * N,
                w_grad + (b * 2 + 1) * nn + n * N,
                w_div + (b * 2 + 0) * nn + n * N,
                w_div + (b * 2 + 1) * nn + n * N};
  if ((N & 3) == 0) {
    for (int q = threadIdx.x; q < N / 4; q += blockDim.x) {
      float acc[4][4] = {};
      for (int k = 0; k < K; ++k) {
        const int j = s_idx[k] - 4 * q;
        if ((unsigned)j < 4u) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (j == c)
#pragma unroll
              for (int p = 0; p < 4; ++p) acc[p][c] += s_coef[p * K + k];
        }
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) store4(rows[p], q, acc[p]);
    }
  } else {
    for (int m = threadIdx.x; m < N; m += blockDim.x) {
      float acc[4] = {};
      for (int k = 0; k < K; ++k)
        if (s_idx[k] == m)
#pragma unroll
          for (int p = 0; p < 4; ++p) acc[p] += s_coef[p * K + k];
#pragma unroll
      for (int p = 0; p < 4; ++p) store1(rows[p], m, acc[p]);
    }
  }
}

template <typename T>
int launch_densify(const void* idx, const void* grad_coef,
                   const void* div_coef, void* w_grad, void* w_div, int B,
                   int N, int K, int planes, int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N == 0) return (int)cudaGetLastError();
  const dim3 grid(N, B);
  const size_t smem = (size_t)K * 5 * sizeof(float);
  densify_kernel<T><<<grid, 256, smem, (cudaStream_t)stream>>>(
      (const int*)idx, (const float*)grad_coef, (const float*)div_coef,
      (T*)w_grad, (T*)w_div, N, K, planes);
  return (int)cudaGetLastError();
}

__global__ void densify_bwd_kernel(const int* __restrict__ idx,
                                   const float* __restrict__ dwg,
                                   const float* __restrict__ dwd,
                                   float2* __restrict__ d_grad,
                                   float2* __restrict__ d_div, int N, int K,
                                   long long edges) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= edges) return;
  const long long bn = e / K;  // the row b * N + n
  const long long b = bn / N;
  const long long nn = (long long)N * N;
  const int j = idx[e];
  float2 g = make_float2(0.0f, 0.0f), d = g;
  if ((unsigned)j < (unsigned)N) {
    const long long at = b * 2 * nn + (bn - b * N) * N + j;
    g = make_float2(dwg[at], dwg[at + nn]);
    d = make_float2(dwd[at], dwd[at + nn]);
  }
  d_grad[e] = g;
  d_div[e] = d;
}

// clip(rint(p / s * 127), -127, 127), each operation rounded on its own.
__device__ __forceinline__ int quantize127(float p, float s) {
  const float v = rintf(__fmul_rn(__fdiv_rn(p, s), 127.0f));
  return (int)fminf(fmaxf(v, -127.0f), 127.0f);
}

// A block row (threadIdx.y) a row (b, n) of the four planes; V columns a
// thread (4 where N % 4 == 0: one 4-byte store a plane, else 1).
template <int V>
__global__ void densify_int8_kernel(const int* __restrict__ idx,
                                    const float* __restrict__ grad_coef,
                                    const float* __restrict__ div_coef,
                                    const float* __restrict__ s_grad,
                                    const float* __restrict__ s_div,
                                    int8_t* __restrict__ w_grad,
                                    int8_t* __restrict__ w_div, int N,
                                    int K) {
  extern __shared__ int ismem[];
  int* s_idx = ismem + threadIdx.y * 5 * K;  // [K]
  int* s_q = s_idx + K;  // [4, K]: g1, g2, d1, d2 quantized

  const long long n = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const long long b = blockIdx.y;
  const long long row = (b * N + n) * K;
  const bool live = n < N;
  const float sg = s_grad[b], sd = s_div[b];
  // One thread a quantized value: s_q[p * K + k] of plane p (g1, g2, d1,
  // d2) and slot k.
  for (int t = threadIdx.x; live && t < 5 * K; t += blockDim.x) {
    if (t >= 4 * K) {
      s_idx[t - 4 * K] = idx[row + t - 4 * K];
      continue;
    }
    const int p = t / K, k = t - p * K;
    const float* coef = p < 2 ? grad_coef : div_coef;
    s_q[t] = quantize127(coef[(row + k) * 2 + (p & 1)], p < 2 ? sg : sd);
  }
  __syncthreads();
  if (!live) return;

  const long long nn = (long long)N * N;
  int8_t* rows[4] = {w_grad + (b * 2 + 0) * nn + n * N,
                     w_grad + (b * 2 + 1) * nn + n * N,
                     w_div + (b * 2 + 0) * nn + n * N,
                     w_div + (b * 2 + 1) * nn + n * N};
  for (int q = threadIdx.x; q < N / V; q += blockDim.x) {
    int acc[4][V] = {};
    for (int k = 0; k < K; ++k) {
      const int j = s_idx[k] - V * q;
      if ((unsigned)j < (unsigned)V) {
#pragma unroll
        for (int c = 0; c < V; ++c)
          if (j == c)
#pragma unroll
            for (int p = 0; p < 4; ++p) acc[p][c] += s_q[p * K + k];
      }
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if constexpr (V == 4) {
        reinterpret_cast<unsigned*>(rows[p])[q] =
            ((unsigned)acc[p][0] & 0xFFu) |
            (((unsigned)acc[p][1] & 0xFFu) << 8) |
            (((unsigned)acc[p][2] & 0xFFu) << 16) |
            (((unsigned)acc[p][3] & 0xFFu) << 24);
      } else {
        rows[p][q] = (int8_t)acc[p][0];
      }
    }
  }
}

}  // namespace

extern "C" int dc_densify_int8(const void* idx, const void* grad_coef,
                               const void* div_coef, const void* s_grad,
                               const void* s_div, void* w_grad, void* w_div,
                               int B, int N, int K, int device,
                               void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N == 0) return (int)cudaGetLastError();
  // One thread per 4 columns (per column where N % 4 != 0) across a row,
  // whole warps, and as many rows as fill 256 threads.
  const bool by4 = (N & 3) == 0;
  const int work = by4 ? N / 4 : N;
  const int threads = work >= 256 ? 256 : ((work + 31) / 32) * 32;
  const dim3 block(threads, 256 / threads);
  const dim3 grid((N + block.y - 1) / block.y, B);
  const size_t smem = (size_t)block.y * K * 5 * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;
  if (by4)
    densify_int8_kernel<4><<<grid, block, smem, s>>>(
        (const int*)idx, (const float*)grad_coef, (const float*)div_coef,
        (const float*)s_grad, (const float*)s_div, (int8_t*)w_grad,
        (int8_t*)w_div, N, K);
  else
    densify_int8_kernel<1><<<grid, block, smem, s>>>(
        (const int*)idx, (const float*)grad_coef, (const float*)div_coef,
        (const float*)s_grad, (const float*)s_div, (int8_t*)w_grad,
        (int8_t*)w_div, N, K);
  return (int)cudaGetLastError();
}

extern "C" int dc_densify(const void* idx, const void* grad_coef,
                          const void* div_coef, void* w_grad, void* w_div,
                          int B, int N, int K, int planes, int device,
                          void* stream) {
  return launch_densify<float>(idx, grad_coef, div_coef, w_grad, w_div, B,
                               N, K, planes, device, stream);
}

extern "C" int dc_densify_bf16(const void* idx, const void* grad_coef,
                               const void* div_coef, void* w_grad,
                               void* w_div, int B, int N, int K, int planes,
                               int device, void* stream) {
  return launch_densify<__nv_bfloat16>(idx, grad_coef, div_coef, w_grad,
                                       w_div, B, N, K, planes, device,
                                       stream);
}

extern "C" int dc_densify_bwd(const void* idx, const void* dwg,
                              const void* dwd, void* d_grad, void* d_div,
                              int B, int N, int K, int device, void* stream) {
  DC_SET_DEVICE(device);
  const long long edges = (long long)B * N * K;
  if (edges == 0) return (int)cudaGetLastError();
  const int threads = 256;
  densify_bwd_kernel<<<(unsigned)((edges + threads - 1) / threads), threads,
                       0, (cudaStream_t)stream>>>(
      (const int*)idx, (const float*)dwg, (const float*)dwd,
      (float2*)d_grad, (float2*)d_div, N, K, edges);
  return (int)cudaGetLastError();
}
