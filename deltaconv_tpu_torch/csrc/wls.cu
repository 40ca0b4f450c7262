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
// Bound on the H100: bytes. The ~180 f32 operations an edge of the fit
// and ~580 of its VJP take 0.002 and 0.006 ms at B=32, N=1024, K=20,
// against 0.0125 and 0.0219 ms to read the planes (and cotangents) once
// and write the outputs once (31 + 10 MB and 42 + 31 MB). What keeps a
// kernel from that bound is the loads in flight: the TPU kernel put 512
// points on the lanes and reduced over K on the sublanes; a thread a
// point walking its K edges in passes issues one edge's 12 dependent
// loads at a time, and re-reads the planes in every pass.
//
// Design (the split route, `dc_wls`, `dc_wls_bwd`): a block takes 32
// consecutive points of one cloud (the lanes) x S warps (slices); warp s
// holds edges s, s + S, ... of its lane's point, E = ceil(K / S) slots,
// and reads each of their planes (and, in the backward, cotangents) once,
// all up front, into registers: 12E (16E) independent loads a thread,
// each one 128-byte row of a warp. Every sum over K (the weight sum, the
// 21 entries of the normal equations, the 6 height coefficients; in the
// backward c's cotangents, L's and inv_d's, and the weights' dot) is each
// slice's sum over its slots, then the slices' partials added in slice
// order out of shared memory after a barrier (SliceSum, wls_split.cuh):
// the same bits in every slice and in every call. Each slice factors the
// 6x6 system itself (redundantly: no second barrier to broadcast it). The
// per-edge steps run in parallel across the slices straight out of
// registers, and every output plane is written once, coalesced; the
// backward keeps its scratch between the steps in registers. S is the
// fewest warps whose slots (at
// most kMaxEdges) hold K edges, up to kMaxSlices (ops/wls_fused.py
// `wls_split` mirrors the choice): 4 x 5 at K=20, 6 x 5 at K=30; above,
// the direct route. The forward is held to 96 registers (5 blocks of 4
// warps an SM at K=20, no spill); the backward takes what it needs (255
// at E = 5, 2 blocks an SM: capped, it spills and runs slower;
// tools/wls_kernel_variants.py).
//
// The direct route (`dc_wls_direct`, `dc_wls_bwd_direct`, any K): the
// earlier kernels, one thread a point over all K edges in passes
// (wls::wls_point, wls_point_bwd), the backward's scratch in d_edges'
// planes 0-3.
#include "wls_split.cuh"

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

template <int E>
__global__ void __maxnreg__(kFwdRegs)
    wls_split_kernel(const float* __restrict__ edges, float* __restrict__ g,
                     float* __restrict__ d, int K, int N, float kernel_width,
                     float regularizer) {
  extern __shared__ float sums[];
  const int lane = threadIdx.x, s = threadIdx.y, S = blockDim.y;
  const int n = blockIdx.x * kPoints + lane;
  const long long b = blockIdx.y;
  const bool live = n < N;
  const long long plane = (long long)K * N;
  const long long at = b * 12 * plane + (live ? n : 0);
  const PlaneSrc src{edges + at, plane, N};
  float* gb = g + b * 2 * plane + n;
  float* db = d + b * 2 * plane + n;
  SliceSum sum{sums, lane, s, S};
  wls::wls_split<E>(src, s, S, K, live, kernel_width, regularizer, sum,
                    [&](int k, float g1, float g2, float d1, float d2) {
                      const long long o = (long long)k * N;
                      gb[o] = g1;
                      gb[plane + o] = g2;
                      db[o] = d1;
                      db[plane + o] = d2;
                    });
}

template <int E>
__global__ void __launch_bounds__(kPoints * kMaxSlices)
    wls_split_bwd_kernel(const float* __restrict__ edges,
                         const float* __restrict__ ctg,
                         const float* __restrict__ ctd,
                         float* __restrict__ de, int K, int N,
                         float kernel_width, float regularizer) {
  extern __shared__ float sums[];
  const int lane = threadIdx.x, s = threadIdx.y, S = blockDim.y;
  const int n = blockIdx.x * kPoints + lane;
  const long long b = blockIdx.y;
  const bool live = n < N;
  const long long plane = (long long)K * N;
  const long long col = live ? n : 0;
  const PlaneSrc src{edges + b * 12 * plane + col, plane, N};
  const float* cg = ctg + b * 2 * plane + col;
  const float* cd = ctd + b * 2 * plane + col;
  float* out = de + b * 12 * plane + col;
  SliceSum sum{sums, lane, s, S};
  wls::wls_split_bwd<E>(
      src,
      [&](int k, float& g1, float& g2, float& d1, float& d2) {
        const long long o = (long long)k * N;
        g1 = cg[o];
        g2 = cg[plane + o];
        d1 = cd[o];
        d2 = cd[plane + o];
      },
      s, S, K, live, kernel_width, regularizer, sum,
      [&](int p, int k) -> float& {
        return out[p * plane + (long long)k * N];
      });
}

__global__ void wls_direct_kernel(const float* __restrict__ edges,
                                  float* __restrict__ g,
                                  float* __restrict__ d, int K, int N,
                                  float kernel_width, float regularizer) {
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
    wls_bwd_direct_kernel(const float* __restrict__ edges,
                          const float* __restrict__ ctg,
                          const float* __restrict__ ctd,
                          float* __restrict__ de, int K, int N,
                          float kernel_width, float regularizer) {
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
                      int N, int S, float kernel_width, float regularizer,
                      int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * K * N == 0) return (int)cudaGetLastError();
  return split_launch(B, K, N, S, [&](auto e, dim3 grid, dim3 block) {
    wls_split_kernel<decltype(e)::value>
        <<<grid, block, split_smem(S), (cudaStream_t)stream>>>(
            (const float*)edges, (float*)g, (float*)d, K, N, kernel_width,
            regularizer);
  });
}

extern "C" int dc_wls_bwd(const void* edges, const void* ctg, const void* ctd,
                          void* de, int B, int K, int N, int S,
                          float kernel_width, float regularizer, int device,
                          void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * K * N == 0) return (int)cudaGetLastError();
  return split_launch(B, K, N, S, [&](auto e, dim3 grid, dim3 block) {
    wls_split_bwd_kernel<decltype(e)::value>
        <<<grid, block, split_smem(S), (cudaStream_t)stream>>>(
            (const float*)edges, (const float*)ctg, (const float*)ctd,
            (float*)de, K, N, kernel_width, regularizer);
  });
}

extern "C" int dc_wls_direct(const void* edges, void* g, void* d, int B,
                             int K, int N, float kernel_width,
                             float regularizer, int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * K * N == 0) return (int)cudaGetLastError();
  const int threads = 128;
  const dim3 grid((N + threads - 1) / threads, B);
  wls_direct_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)edges, (float*)g, (float*)d, K, N, kernel_width,
      regularizer);
  return (int)cudaGetLastError();
}

extern "C" int dc_wls_bwd_direct(const void* edges, const void* ctg,
                                 const void* ctd, void* de, int B, int K,
                                 int N, float kernel_width, float regularizer,
                                 int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * K * N == 0) return (int)cudaGetLastError();
  const int threads = 128;
  const dim3 grid((N + threads - 1) / threads, B);
  wls_bwd_direct_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)edges, (const float*)ctg, (const float*)ctd, (float*)de,
      K, N, kernel_width, regularizer);
  return (int)cudaGetLastError();
}
