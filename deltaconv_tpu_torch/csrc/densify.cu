// Dense grad/div operators from the per-edge coefficients (f32 output):
//   w_grad[b, d, n, idx[b, n, k]] += grad_coef[b, n, k, d]
//   w_div [b, d, n, idx[b, n, k]] += div_coef [b, n, k, d]
// idx [B, N, K] i32, grad_coef/div_coef [B, N, K, 2] f32
//   -> w_grad, w_div [B, 2, N, N] f32 (zero where no edge lands).
//
// Replaces the f32 Pallas kernel of deltaconv_tpu/ops/densify_op.py
// (`densify_coef_planes`, pallas_call at densify_op.py:249, kernel body
// `_fwd_kernel`). The TPU built each row tile in VMEM by K masked
// select-accumulates over a [T, N] column iota; here a block owns one
// row (b, n) of all four planes, stages the row's K indices and
// coefficients in shared memory, and every thread writes its columns
// once: zero, plus the coefficients of the slots that land there. No
// other block writes the row, so no atomics are needed.
//
// Coefficients are ADDED, in slot order, never stored: on the masked
// path the padded kNN slots are clamped to the point itself with a zero
// coefficient (geometry/knn.py), so a column can be hit twice and a
// store would overwrite slot 0's real self coefficient. The TPU kernel
// sums too.
//
// Bound on the H100: the stores, 4 * N * N * 4 bytes per cloud (512 MB
// at B=32, N=1024), written as 16-byte stores where N % 4 == 0. The K
// compares per stored vector come from shared memory.
#include "common.cuh"

namespace {

__global__ void densify_kernel(const int* __restrict__ idx,
                               const float* __restrict__ grad_coef,
                               const float* __restrict__ div_coef,
                               float* __restrict__ w_grad,
                               float* __restrict__ w_div, int N, int K) {
  extern __shared__ float smem[];
  int* s_idx = reinterpret_cast<int*>(smem);  // [K]
  float* s_coef = smem + K;                   // [4, K]: g1, g2, d1, d2

  const long long n = blockIdx.x;
  const long long b = blockIdx.y;
  const long long row = (b * N + n) * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    s_idx[k] = idx[row + k];
    s_coef[k] = grad_coef[(row + k) * 2];
    s_coef[K + k] = grad_coef[(row + k) * 2 + 1];
    s_coef[2 * K + k] = div_coef[(row + k) * 2];
    s_coef[3 * K + k] = div_coef[(row + k) * 2 + 1];
  }
  __syncthreads();

  const long long nn = (long long)N * N;
  float* rows[4] = {w_grad + (b * 2 + 0) * nn + n * N,
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
      for (int p = 0; p < 4; ++p)
        reinterpret_cast<float4*>(rows[p])[q] =
            make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
    }
  } else {
    for (int m = threadIdx.x; m < N; m += blockDim.x) {
      float acc[4] = {};
      for (int k = 0; k < K; ++k)
        if (s_idx[k] == m)
#pragma unroll
          for (int p = 0; p < 4; ++p) acc[p] += s_coef[p * K + k];
#pragma unroll
      for (int p = 0; p < 4; ++p) rows[p][m] = acc[p];
    }
  }
}

}  // namespace

extern "C" int dc_densify(const void* idx, const void* grad_coef,
                          const void* div_coef, void* w_grad, void* w_div,
                          int B, int N, int K, int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N == 0) return (int)cudaGetLastError();
  const dim3 grid(N, B);
  const size_t smem = (size_t)K * 5 * sizeof(float);
  densify_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      (const int*)idx, (const float*)grad_coef, (const float*)div_coef,
      (float*)w_grad, (float*)w_div, N, K);
  return (int)cudaGetLastError();
}
