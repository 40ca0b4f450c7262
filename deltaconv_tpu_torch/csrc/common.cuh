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
