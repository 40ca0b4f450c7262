// The fused eval build: gather, edge planes and the WLS fit of every
// point in one kernel.
//   pos, normal, x_basis, y_basis [B, N, 3] f32, idx [B, N, K] i32 (the
//   point itself in slot 0), mask [B, N, K] u8, avg [B] f32 ->
//   grad_coef, div_coef [B, 2, N, K] f32 (unnormalized),
//   row_norm [B, N] f32 = sqrt(s1^2 + s2^2), s_d = sum_k |grad_coef[d]|
//
// Replaces the Pallas kernel of deltaconv_tpu/ops/fused_build.py
// (`fused_gather_wls`, pallas_call at fused_build.py:180; body `_kernel`
// with `_edge_planes`). The TPU kernel gathered the table by one-hot
// products per slot, as bf16 hi + lo halves (about 16 mantissa bits),
// and relaid the coefficients point-major per tile. Here one thread owns
// a point: it reads its centre (slot 0's row) once and, in every pass of
// the shared WLS body (wls_body.cuh), gathers each edge's neighbour rows
// in f32 (wls::GatherSrc; the cloud's rows stay in L1/L2) and forms the
// planes in registers, so nothing of the [B, 12, K, N] plane tensor
// reaches device memory. Plane 11 is the cloud's avg.
//
// Bound on the H100: the same arithmetic as the wls forward (~200 flops
// and one expf per edge and pass); its bytes are the cloud's rows, the
// indices and mask, and the coefficients written, 14 MB at B=32, N=1024,
// K=20.
#include "common.cuh"
#include "wls_body.cuh"

namespace {

__global__ void fused_gather_wls_kernel(
    const float* __restrict__ pos, const float* __restrict__ normal,
    const float* __restrict__ x_basis, const float* __restrict__ y_basis,
    const int* __restrict__ idx, const unsigned char* __restrict__ mask,
    const float* __restrict__ avg, float* __restrict__ grad_coef,
    float* __restrict__ div_coef, float* __restrict__ row_norm, int N, int K,
    float kernel_width, float regularizer) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const long long b = blockIdx.y;
  if (n >= N) return;
  const long long cloud = b * N * 3;
  const long long row = (b * N + n) * K;
  wls::GatherSrc src{pos + cloud, x_basis + cloud, y_basis + cloud,
                     idx + row, mask + row, N, avg[b]};
  int c = idx[row];
  c = c < 0 ? 0 : (c >= N ? N - 1 : c);
  const float* p = pos + cloud + 3 * c;
  const float* q = normal + cloud + 3 * c;
  const float* x = x_basis + cloud + 3 * c;
  const float* y = y_basis + cloud + 3 * c;
  src.px = p[0], src.py = p[1], src.pz = p[2];
  src.nx = q[0], src.ny = q[1], src.nz = q[2];
  src.xbx = x[0], src.xby = x[1], src.xbz = x[2];
  src.ybx = y[0], src.yby = y[1], src.ybz = y[2];

  const long long plane = (long long)N * K;
  float* g = grad_coef + b * 2 * plane + (long long)n * K;
  float* d = div_coef + b * 2 * plane + (long long)n * K;
  float s1 = 0.0f, s2 = 0.0f;
  wls::wls_point(
      src, K, kernel_width, regularizer,
      [&](int k, float g1, float g2) {
        g[k] = g1;
        g[plane + k] = g2;
        s1 += fabsf(g1);
        s2 += fabsf(g2);
      },
      [&](int k, float& g1, float& g2) {
        g1 = g[k];
        g2 = g[plane + k];
      },
      [&](int k, float, float, float d1, float d2) {
        d[k] = d1;
        d[plane + k] = d2;
      });
  row_norm[b * N + n] = sqrtf(s1 * s1 + s2 * s2);
}

}  // namespace

extern "C" int dc_fused_gather_wls(const void* pos, const void* normal,
                                   const void* x_basis, const void* y_basis,
                                   const void* idx, const void* mask,
                                   const void* avg, void* grad_coef,
                                   void* div_coef, void* row_norm, int B,
                                   int N, int K, float kernel_width,
                                   float regularizer, int device,
                                   void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * K == 0) return (int)cudaGetLastError();
  const int threads = 128;
  const dim3 grid((N + threads - 1) / threads, B);
  fused_gather_wls_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)pos, (const float*)normal, (const float*)x_basis,
      (const float*)y_basis, (const int*)idx, (const unsigned char*)mask,
      (const float*)avg, (float*)grad_coef, (float*)div_coef,
      (float*)row_norm, N, K, kernel_width, regularizer);
  return (int)cudaGetLastError();
}
