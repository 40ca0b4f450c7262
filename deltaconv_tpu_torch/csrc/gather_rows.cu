// Component-major neighbour-table gather:
//   out[b, c, k, n] = table[b, idx[b, n, k], c]
// table [B, N, C] f32, idx [B, N, K] i32 -> out [B, C, K, N] f32.
//
// Replaces the Pallas forward of deltaconv_tpu/ops/gather_rows.py
// (`_fwd`, pallas_call at gather_rows.py:205; kernel bodies `_fwd_kernel`
// and `_fwd_kernel_blocked`). The TPU kernel gathered through one-hot
// MXU matmuls on a hi/lo bf16 split of the table, padded C to 8 and the
// point tile to 128 lanes; a CUDA thread loads the f32 row entry
// directly, so the gather is exact and needs no padding.
//
// Bound on the H100: memory. A thread owns one (b, k, n) and writes its
// C outputs, with n the fastest index across the warp, so every store
// of a warp is coalesced; it reads its index once and the C contiguous
// floats of the neighbour's row. The table of one cloud (N * C * 4
// bytes, 36 KB at N=1024, C=9) stays in L1/L2. An index outside
// [0, N) gathers 0, as a one-hot row with no match does on the TPU.
#include "common.cuh"

namespace {

__global__ void gather_rows_kernel(const float* __restrict__ table,
                                   const int* __restrict__ idx,
                                   float* __restrict__ out, int N, int C,
                                   int K) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y;
  const long long b = blockIdx.z;
  if (n >= N) return;
  const int j = idx[(b * N + n) * K + k];
  const bool ok = (unsigned)j < (unsigned)N;
  const float* src = table + (b * N + (ok ? j : 0)) * C;
  float* dst = out + (b * C * K + k) * N + n;  // + c * K * N
  const long long stride = (long long)K * N;
  for (int c = 0; c < C; ++c) dst[c * stride] = ok ? src[c] : 0.0f;
}

}  // namespace

extern "C" int dc_gather_rows(const void* table, const void* idx, void* out,
                              int B, int N, int C, int K, int device,
                              void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C * K == 0) return (int)cudaGetLastError();
  const int threads = 128;
  const dim3 grid((N + threads - 1) / threads, K, B);
  gather_rows_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const int*)idx, (float*)out, N, C, K);
  return (int)cudaGetLastError();
}

extern "C" const char* dc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
