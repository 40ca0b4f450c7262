// Per-neighbourhood weighted least squares: the grad/div coefficients of
// every edge from its 12 precomputed edge planes.
//   edges [B, 12, K, N] f32 -> g, d [B, 2, K, N] f32
// planes: u, v, dist, patch, mask, d_xx, d_xy, d_yx, d_yy, d_nx, d_ny,
// avg (the per-cloud mean edge length, broadcast).
//
// Replaces the Pallas forward of deltaconv_tpu/ops/wls_fused.py
// (`_wls_pallas_fwd_impl`, pallas_call at wls_fused.py:162; kernel body
// `_kernel` over the math of `_wls_math`, wls_fused.py:45-137). This
// kernel follows `_wls_math` op for op, including its clamps: 1e-20 in
// the Gaussian denominator and on the Cholesky diagonal, 1e-5 on the
// weight sum. Differences to the JAX math come only from FMA
// contraction and the order of the K sums.
//
// Design: one thread per point (b, n). The TPU kernel put 512 points on
// the lanes and reduced over K on the sublanes; here the K loop runs in
// registers (21 sums of the normal equations, the 6x6 Cholesky factor,
// 6 height coefficients) and each pass over K re-reads the planes. The
// [B, 12, K, N] layout keeps n fastest, so the loads of a warp are
// coalesced in every pass. Bound on the H100: the ~200 flops and one
// expf per edge and pass against 12 * 4 bytes read per edge -- at
// B=32, N=1024, K=20 the kernel reads 31 MB and writes 10 MB, and the
// passes after the first hit L2.
#include "common.cuh"

namespace {

constexpr int NB = 6;  // quadratic patch basis [1, u, v, u^2, uv, v^2]

__device__ __forceinline__ void basis(float u, float v, float* bs) {
  bs[0] = 1.0f;
  bs[1] = u;
  bs[2] = v;
  bs[3] = u * u;
  bs[4] = u * v;
  bs[5] = v * v;
}

__global__ void wls_kernel(const float* __restrict__ edges,
                           float* __restrict__ g, float* __restrict__ d,
                           int K, int N, float kernel_width,
                           float regularizer) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const long long b = blockIdx.y;
  if (n >= N) return;
  const long long plane = (long long)K * N;
  const float* e = edges + b * 12 * plane + n;
  float* gb = g + b * 2 * plane + n;
  float* db = d + b * 2 * plane + n;
#define EDGE(p, k) e[(p) * plane + (long long)(k) * N]

  // 1. Normalized Gaussian weights.
  const float kwa = kernel_width * EDGE(11, 0);
  const float denom = fmaxf(kwa * kwa, 1e-20f);
  float wsum = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float dist = EDGE(2, k);
    wsum += expf(-(dist * dist) / denom) * EDGE(4, k);
  }
  const float wden = fmaxf(wsum, 1e-5f);

  // 2-3. Normal equations A = B^T W B + lam I (upper triangle).
  float A[NB][NB];
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j) A[i][j] = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float dist = EDGE(2, k);
    const float w = expf(-(dist * dist) / denom) * EDGE(4, k) / wden;
    float bs[NB];
    basis(EDGE(0, k), EDGE(1, k), bs);
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int j = i; j < NB; ++j) A[i][j] += w * bs[i] * bs[j];
  }
#pragma unroll
  for (int i = 0; i < NB; ++i) A[i][i] += regularizer;

  // 4. Unrolled Cholesky, A = L L^T.
  float L[NB][NB];
  float inv_d[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    float sdiag = A[j][j];
#pragma unroll
    for (int t = 0; t < j; ++t) sdiag = sdiag - L[j][t] * L[j][t];
    L[j][j] = sqrtf(fmaxf(sdiag, 1e-20f));
    inv_d[j] = 1.0f / L[j][j];
#pragma unroll
    for (int i = j + 1; i < NB; ++i) {
      float soff = A[j][i];
#pragma unroll
      for (int t = 0; t < j; ++t) soff = soff - L[i][t] * L[j][t];
      L[i][j] = soff * inv_d[j];
    }
  }

  // 5-6. Per edge: solve A z = w * basis; the grad coefficients are
  // z[1], z[2]; the height coefficients c = sum_k z * patch.
  float c[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) c[i] = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float dist = EDGE(2, k);
    const float w = expf(-(dist * dist) / denom) * EDGE(4, k) / wden;
    float bs[NB];
    basis(EDGE(0, k), EDGE(1, k), bs);
    float y[NB], z[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      float t = w * bs[i];
#pragma unroll
      for (int kk = 0; kk < i; ++kk) t = t - L[i][kk] * y[kk];
      y[i] = t * inv_d[i];
    }
#pragma unroll
    for (int i = NB - 1; i >= 0; --i) {
      float t = y[i];
#pragma unroll
      for (int kk = i + 1; kk < NB; ++kk) t = t - L[kk][i] * z[kk];
      z[i] = t * inv_d[i];
    }
    const float patch = EDGE(3, k);
#pragma unroll
    for (int i = 0; i < NB; ++i) c[i] += z[i] * patch;
    gb[(long long)k * N] = z[1];
    gb[plane + (long long)k * N] = z[2];
  }

  // 7-9. Per edge: height partials, inverse metric, vector map, div row.
  for (int k = 0; k < K; ++k) {
    const float u = EDGE(0, k);
    const float v = EDGE(1, k);
    const float g1 = gb[(long long)k * N];
    const float g2 = gb[plane + (long long)k * N];
    const float h_x = c[1] + 2.0f * c[3] * u + c[4] * v;
    const float h_y = c[2] + c[4] * u + 2.0f * c[5] * v;
    const float det = 1.0f + h_x * h_x + h_y * h_y;
    const float m11 = (1.0f + h_y * h_y) / det;
    const float m12 = -(h_x * h_y) / det;
    const float m22 = (1.0f + h_x * h_x) / det;
    const float bt11 = EDGE(5, k) + h_x * EDGE(9, k);
    const float bt12 = EDGE(6, k) + h_x * EDGE(10, k);
    const float bt21 = EDGE(7, k) + h_y * EDGE(9, k);
    const float bt22 = EDGE(8, k) + h_y * EDGE(10, k);
    const float M11 = m11 * bt11 + m12 * bt21;
    const float M12 = m11 * bt12 + m12 * bt22;
    const float M21 = m12 * bt11 + m22 * bt21;
    const float M22 = m12 * bt12 + m22 * bt22;
    db[(long long)k * N] = g1 * M11 + g2 * M21;
    db[plane + (long long)k * N] = g1 * M12 + g2 * M22;
  }
#undef EDGE
}

}  // namespace

extern "C" int dc_wls(const void* edges, void* g, void* d, int B, int K,
                      int N, float kernel_width, float regularizer,
                      int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * K * N == 0) return (int)cudaGetLastError();
  const int threads = 128;
  const dim3 grid((N + threads - 1) / threads, B);
  wls_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)edges, (float*)g, (float*)d, K, N, kernel_width,
      regularizer);
  return (int)cudaGetLastError();
}
