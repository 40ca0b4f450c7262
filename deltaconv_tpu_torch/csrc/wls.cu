// Per-neighbourhood weighted least squares: the grad/div coefficients of
// every edge from its 12 precomputed edge planes, and their VJP.
//   `dc_wls`: edges [B, 12, K, N] f32 -> g, d [B, 2, K, N] f32
//   `dc_wls_bwd`: edges and the cotangents ctg, ctd [B, 2, K, N] f32 ->
//     d_edges [B, 12, K, N] f32
// planes: u, v, dist, patch, mask, d_xx, d_xy, d_yx, d_yy, d_nx, d_ny,
// avg (the per-cloud mean edge length, broadcast).
//
// `dc_wls` replaces the Pallas forward of deltaconv_tpu/ops/wls_fused.py
// (`_wls_pallas_fwd_impl`, pallas_call at wls_fused.py:162; kernel body
// `_kernel` over the math of `_wls_math`, wls_fused.py:45-137);
// `dc_wls_bwd` replaces its backward (`_wls_bwd_pallas`, pallas_call at
// wls_fused.py:212; body `_bwd_kernel`, the jax.vjp of `_wls_math` traced
// inside the kernel). Both run the per-point math of wls_body.cuh, which
// follows `_wls_math` op for op, including its clamps: 1e-20 in the
// Gaussian denominator and on the Cholesky diagonal, 1e-5 on the weight
// sum. Differences to the JAX math come only from FMA contraction and the
// order of the K sums.
//
// Design: one thread per point (b, n). The TPU kernel put 512 points on
// the lanes and reduced over K on the sublanes; here the K loop runs in
// registers (21 sums of the normal equations, the 6x6 Cholesky factor,
// 6 height coefficients) and each pass over K re-reads the planes. The
// [B, 12, K, N] layout keeps n fastest, so the loads of a warp are
// coalesced in every pass. The backward's adjoint is derived by hand
// (wls::wls_point_bwd): it redoes the fit, then walks the steps in
// reverse over K in four passes, recomputing each edge's solve instead of
// storing K of them, with d_edges' planes 0-3 as the scratch between the
// passes; the reverse Cholesky's accumulators (dL, d inv_d, dA) stay in
// registers. Bound on the H100: the ~200 flops and one expf per edge and
// pass against 12 * 4 bytes read per edge -- at B=32, N=1024, K=20 the
// forward reads 31 MB and writes 10 MB, the backward reads 42 MB and
// writes 31 MB, and the passes after the first hit L2.
#include "common.cuh"
#include "wls_body.cuh"

namespace {

// The planes of point n of one cloud: edge k's plane p at p * K * N + k * N.
struct PlaneSrc {
  const float* __restrict__ e;
  long long plane;
  int N;
  __host__ __device__ __forceinline__ wls::Edge operator()(int k) const {
    const float* p = e + (long long)k * N;
    return {p[0],         p[plane],     p[2 * plane], p[3 * plane],
            p[4 * plane], p[5 * plane], p[6 * plane], p[7 * plane],
            p[8 * plane], p[9 * plane], p[10 * plane], p[11 * plane]};
  }
};

__global__ void wls_kernel(const float* __restrict__ edges,
                           float* __restrict__ g, float* __restrict__ d,
                           int K, int N, float kernel_width,
                           float regularizer) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const long long b = blockIdx.y;
  if (n >= N) return;
  const long long plane = (long long)K * N;
  const PlaneSrc src{edges + b * 12 * plane + n, plane, N};
  float* gb = g + b * 2 * plane + n;
  float* db = d + b * 2 * plane + n;
  wls::wls_point(
      src, K, kernel_width, regularizer,
      [&](int k, float g1, float g2) {
        gb[(long long)k * N] = g1;
        gb[plane + (long long)k * N] = g2;
      },
      [&](int k, float& g1, float& g2) {
        g1 = gb[(long long)k * N];
        g2 = gb[plane + (long long)k * N];
      },
      [&](int k, float, float, float d1, float d2) {
        db[(long long)k * N] = d1;
        db[plane + (long long)k * N] = d2;
      });
}

__global__ void __launch_bounds__(128)
    wls_bwd_kernel(const float* __restrict__ edges,
                   const float* __restrict__ ctg,
                   const float* __restrict__ ctd, float* __restrict__ de,
                   int K, int N, float kernel_width, float regularizer) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const long long b = blockIdx.y;
  if (n >= N) return;
  const long long plane = (long long)K * N;
  const PlaneSrc src{edges + b * 12 * plane + n, plane, N};
  const float* cg = ctg + b * 2 * plane + n;
  const float* cd = ctd + b * 2 * plane + n;
  float* out = de + b * 12 * plane + n;
  wls::wls_point_bwd(
      src,
      [&](int k, float& g1, float& g2, float& d1, float& d2) {
        const long long at = (long long)k * N;
        g1 = cg[at];
        g2 = cg[plane + at];
        d1 = cd[at];
        d2 = cd[plane + at];
      },
      [&](int p, int k) -> float& {
        return out[p * plane + (long long)k * N];
      },
      K, kernel_width, regularizer);
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

extern "C" int dc_wls_bwd(const void* edges, const void* ctg, const void* ctd,
                          void* de, int B, int K, int N, float kernel_width,
                          float regularizer, int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * K * N == 0) return (int)cudaGetLastError();
  const int threads = 128;
  const dim3 grid((N + threads - 1) / threads, B);
  wls_bwd_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)edges, (const float*)ctg, (const float*)ctd, (float*)de,
      K, N, kernel_width, regularizer);
  return (int)cudaGetLastError();
}
