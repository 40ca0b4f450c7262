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
