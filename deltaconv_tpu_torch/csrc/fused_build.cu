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
// and relaid the coefficients point-major per tile. Here every edge's
// neighbour rows are gathered in f32 (wls::GatherSrc; the cloud's rows
// stay in L1/L2) and its planes formed in registers, so nothing of the
// [B, 12, K, N] plane tensor reaches device memory. Plane 11 is the
// cloud's avg.
//
// Bound on the H100: the same arithmetic as the wls forward (~180 flops
// and one expf per edge); its bytes are the cloud's rows, the indices and
// mask, and the coefficients written, 14 MB at B=32, N=1024, K=20.
//
// Two routes, chosen by shape in ops/fused_build.py (ops/wls_fused.py
// `wls_split`, as the WLS forward's), within 1e-5 x max of each other.
// The split route (`dc_fused_gather_wls`), wls.cu's split design on the
// gathered edges: a block takes 32 consecutive points of one cloud (the
// lanes) x S warps (slices), warp s gathers the neighbour rows of its E
// edges k = s, s + S, ... of its lane's point once and forms their planes
// once, into registers, and runs wls::fused_split over them: every sum
// over K (the fit's, and s1, s2 of the row norm) is each warp's sum over
// its slots in order, then the warps' partials added in warp order out
// of shared memory (SliceSum, wls_split.cuh), so two calls give the same
// bits. The outputs are point-major, a point's K values contiguous and
// consecutive lanes K floats apart, so each warp puts its coefficients
// in a shared-memory tile of the block's four planes ([4][32][K]) and,
// after the last sum's barrier, the block writes each plane's 32 K
// contiguous floats with coalesced stores. 4 x 5 at K=20, 6 x 5 at K=30.
// The direct route (`dc_fused_gather_wls_direct`, above 40 edges a point,
// never on a model path), the earlier kernel: one thread a point walking
// all K edges in each pass of wls::wls_point, re-gathering the rows and
// re-forming the planes in every pass and keeping the grad coefficients
// between passes in the output.
#include "wls_split.cuh"

namespace {

template <int E>
__global__ void __launch_bounds__(kPoints * kMaxSlices)
    fused_gather_wls_kernel(
        const float* __restrict__ pos, const float* __restrict__ normal,
        const float* __restrict__ x_basis, const float* __restrict__ y_basis,
        const int* __restrict__ idx, const unsigned char* __restrict__ mask,
        const float* __restrict__ avg, float* __restrict__ grad_coef,
        float* __restrict__ div_coef, float* __restrict__ row_norm, int N,
        int K, float kernel_width, float regularizer) {
  extern __shared__ float smem[];  // the sums, then the output tile
  const int lane = threadIdx.x, s = threadIdx.y, S = blockDim.y;
  const int n0 = blockIdx.x * kPoints, n = n0 + lane;
  const long long b = blockIdx.y;
  const bool live = n < N;
  const long long cloud = b * N * 3;
  const long long row = (b * N + (live ? n : n0)) * K;
  const wls::GatherSrc src =
      wls::gather_src(pos + cloud, normal + cloud, x_basis + cloud,
                      y_basis + cloud, idx + row, mask + row, N, avg[b]);
  // Plane p's coefficient of edge k of lane l at tile[(p * 32 + l) * K + k].
  float* tile = smem + S * wls::NA * kPoints;
  float* mine = tile + lane * K;
  const int tk = kPoints * K;
  SliceSum sum{smem, lane, s, S};
  const float rn = wls::fused_split<E>(
      src, s, S, K, live, kernel_width, regularizer, sum,
      [&](int k, float g1, float g2, float d1, float d2) {
        mine[k] = g1;
        mine[tk + k] = g2;
        mine[2 * tk + k] = d1;
        mine[3 * tk + k] = d2;
      });
  // fused_split's last sum ends in a barrier: the tile is whole.
  if (s == 0 && live) row_norm[b * N + n] = rn;
  const int count = min(kPoints, N - n0) * K;  // the block's floats a plane
  const long long plane = (long long)N * K;
  const long long at = b * 2 * plane + (long long)n0 * K;
  for (int e = s * kPoints + lane; e < count; e += S * kPoints) {
    grad_coef[at + e] = tile[e];
    grad_coef[at + plane + e] = tile[tk + e];
    div_coef[at + e] = tile[2 * tk + e];
    div_coef[at + plane + e] = tile[3 * tk + e];
  }
}

// The split route's shared memory: the slices' sums and the output tile.
inline size_t fused_smem(int S, int K) {
  return split_smem(S) + (size_t)4 * kPoints * K * sizeof(float);
}

__global__ void fused_gather_wls_direct_kernel(
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
  const wls::GatherSrc src =
      wls::gather_src(pos + cloud, normal + cloud, x_basis + cloud,
                      y_basis + cloud, idx + row, mask + row, N, avg[b]);
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

// The split route on S warps a block (ops/wls_fused.py `wls_split`); a
// split that does not hold K edges is refused (the direct route takes it).
extern "C" int dc_fused_gather_wls(const void* pos, const void* normal,
                                   const void* x_basis, const void* y_basis,
                                   const void* idx, const void* mask,
                                   const void* avg, void* grad_coef,
                                   void* div_coef, void* row_norm, int B,
                                   int N, int K, int S, float kernel_width,
                                   float regularizer, int device,
                                   void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * K == 0) return (int)cudaGetLastError();
  return split_launch(B, K, N, S, [&](auto e, dim3 grid, dim3 block) {
    fused_gather_wls_kernel<decltype(e)::value>
        <<<grid, block, fused_smem(S, K), (cudaStream_t)stream>>>(
            (const float*)pos, (const float*)normal, (const float*)x_basis,
            (const float*)y_basis, (const int*)idx,
            (const unsigned char*)mask, (const float*)avg, (float*)grad_coef,
            (float*)div_coef, (float*)row_norm, N, K, kernel_width,
            regularizer);
  });
}

extern "C" int dc_fused_gather_wls_direct(
    const void* pos, const void* normal, const void* x_basis,
    const void* y_basis, const void* idx, const void* mask, const void* avg,
    void* grad_coef, void* div_coef, void* row_norm, int B, int N, int K,
    float kernel_width, float regularizer, int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * K == 0) return (int)cudaGetLastError();
  const int threads = 128;
  const dim3 grid((N + threads - 1) / threads, B);
  fused_gather_wls_direct_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)pos, (const float*)normal, (const float*)x_basis,
      (const float*)y_basis, (const int*)idx, (const unsigned char*)mask,
      (const float*)avg, (float*)grad_coef, (float*)div_coef,
      (float*)row_norm, N, K, kernel_width, regularizer);
  return (int)cudaGetLastError();
}
