// Shared helpers of the deltaconv_tpu_torch CUDA kernels.
//
// Every entry point has a plain C interface (loaded with ctypes by
// ops/_lib.py): raw pointers, int sizes, the device index and the
// caller's stream. It selects the device first (this library links its
// own CUDA runtime, so PyTorch's current device is not visible here),
// launches on the given stream without synchronising, allocates
// nothing, and returns cudaGetLastError() so that a refused launch is
// reported by the Python wrapper.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#define DC_SET_DEVICE(dev)                              \
  do {                                                  \
    cudaError_t dc_err_ = cudaSetDevice(dev);           \
    if (dc_err_ != cudaSuccess) return (int)dc_err_;    \
  } while (0)

// Launch shape of the per-point kernels (gather_max.cu, gather_sum.cu):
// a block row (threadIdx.y) per point (b, n), its threads across the
// channels, 256 threads a block.
inline dim3 dc_row_block(int C) {
  const int cw = C >= 256 ? 256 : ((C + 31) / 32) * 32;
  return dim3(cw, 256 / cw);
}

inline dim3 dc_row_grid(int B, int N, dim3 block) {
  const long long rows = (long long)B * N;
  return dim3((unsigned int)((rows + block.y - 1) / block.y));
}

namespace {

// dh = acc rounded to f32 (nearest even), two elements a thread (one
// for the last of an odd count): the last step of the backward kernels
// that sum in an f64 accumulator (gather_max.cu).
__global__ void round_f64_kernel(const double* __restrict__ acc,
                                 float* __restrict__ dh, long long total) {
  const long long pairs = (total + 1) / 2;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < pairs; i += (long long)gridDim.x * blockDim.x) {
    if (2 * i + 1 < total) {
      const double2 a = reinterpret_cast<const double2*>(acc)[i];
      reinterpret_cast<float2*>(dh)[i] =
          make_float2(__double2float_rn(a.x), __double2float_rn(a.y));
    } else {
      dh[2 * i] = __double2float_rn(acc[2 * i]);
    }
  }
}

// Launches round_f64_kernel over `total` elements (acc 16-byte and dh
// 8-byte aligned, as the callers' allocations are).
inline void dc_round_f64(const void* acc, void* dh, long long total,
                         cudaStream_t s) {
  const long long blocks = ((total + 1) / 2 + 255) / 256;
  round_f64_kernel<<<(unsigned)(blocks < 8192 ? blocks : 8192), 256, 0, s>>>(
      (const double*)acc, (float*)dh, total);
}

}  // namespace
