// The split route's device side, shared by the WLS kernels (wls.cu) and
// the fused eval build (fused_build.cu): a block takes kPoints consecutive
// points of one cloud (the lanes) x S warps (slices), slice s holds E of
// each point's edges (wls_body.cuh's split walkers); every sum over K is
// each slice's sum over its slots, then the slices' partials added in
// slice order out of shared memory (SliceSum); split_launch picks E.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "wls_body.cuh"

namespace {

constexpr int kPoints = 32;     // points of a block, one a lane
constexpr int kMaxSlices = 8;   // warps of a block at most
constexpr int kMaxEdges = 5;    // slots of a slice at most
constexpr int kFwdRegs = 96;    // registers of the forward's threads

// The sums over K of the split route: slice s's n partials of its lane's
// point into shared memory ([S][NA][32] floats), a barrier, then every
// slice adds the S partials in slice order; a second barrier before the
// buffer is written again. The loop over the slices stays a loop: unrolled
// over a runtime S it grew each sum into dozens of branches and loads.
struct SliceSum {
  float* buf;
  int lane, s, S;
  template <int n>
  __device__ __forceinline__ void add(float* v) {
    float* mine = buf + s * wls::NA * kPoints + lane;
#pragma unroll
    for (int i = 0; i < n; ++i) mine[i * kPoints] = v[i];
    __syncthreads();
    const float* part = buf + lane;
#pragma unroll
    for (int i = 0; i < n; ++i) v[i] = part[i * kPoints];
#pragma unroll 1
    for (int q = 1; q < S; ++q) {
      part += wls::NA * kPoints;
#pragma unroll
      for (int i = 0; i < n; ++i) v[i] += part[i * kPoints];
    }
    __syncthreads();
  }
};

inline size_t split_smem(int S) {
  return (size_t)S * wls::NA * kPoints * sizeof(float);
}

// The split route's launch: S slices, E = ceil(K / S) slots (at most
// kMaxEdges), else cudaErrorInvalidValue.
template <class Launch>
int split_launch(int B, int K, int N, int S, Launch go) {
  if (S < 1 || S > kMaxSlices) return (int)cudaErrorInvalidValue;
  const int E = (K + S - 1) / S;
  if (E > kMaxEdges) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kPoints - 1) / kPoints, B), block(kPoints, S);
  switch (E) {
    case 1: go(std::integral_constant<int, 1>(), grid, block); break;
    case 2: go(std::integral_constant<int, 2>(), grid, block); break;
    case 3: go(std::integral_constant<int, 3>(), grid, block); break;
    case 4: go(std::integral_constant<int, 4>(), grid, block); break;
    default: go(std::integral_constant<int, 5>(), grid, block); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace
