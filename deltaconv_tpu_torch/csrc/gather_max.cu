// Masked neighbour max (forward, no winner tracking):
//   out[b, n, c] = max over k with mask[b, n, k] of h[b, idx[b, n, k], c]
// h [B, N, C] f32, idx [B, N, K] i32, mask [B, N, K] bool (one byte)
//   -> out [B, N, C] f32; a row with no valid neighbour gets -3e38.
//
// Replaces the Pallas forward of deltaconv_tpu/ops/gather_max.py
// (`_pallas_fwd`, pallas_call at gather_max.py:230, kernel body
// `_fwd_kernel`) as the f32 eval path reaches it through `gather_max`
// and `masked_nbr_max` (winners=False). The TPU kernel gathered through
// one-hot MXU matmuls on a hi/lo bf16 split of the table and read the
// self slot from its own rows; a CUDA thread loads h directly, so every
// slot, the self slot included, is an exact f32 load.
//
// Bound on the H100: memory. A block row (threadIdx.y) owns one point
// (b, n) and its threads walk the channels, c fastest: the K loads of a
// warp are coalesced rows of h, and the warp reads each idx/mask entry
// as a broadcast. The table of one cloud (N * C * 4 bytes, 1 MB at
// N=1024, C=256) is reused K times from L2. A NaN in a valid slot
// propagates, as jnp.maximum does; an index outside [0, N) gathers 0,
// as a one-hot row with no match does.
#include "common.cuh"

namespace {

constexpr float kNeg = -3.0e38f;

__global__ void gather_max_kernel(const float* __restrict__ h,
                                  const int* __restrict__ idx,
                                  const uint8_t* __restrict__ mask,
                                  float* __restrict__ out, int B, int N,
                                  int C, int K) {
  const long long bn = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (bn >= (long long)B * N) return;
  const long long b = bn / N;
  const int* ir = idx + bn * K;
  const uint8_t* mr = mask + bn * K;
  const float* hb = h + b * N * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float best = kNeg;
    for (int k = 0; k < K; ++k) {
      if (!mr[k]) continue;
      const int j = ir[k];
      const float v =
          (unsigned)j < (unsigned)N ? hb[(long long)j * C + c] : 0.0f;
      if (v > best || v != v) best = v;
      if (best != best) break;
    }
    out[bn * C + c] = best;
  }
}

}  // namespace

extern "C" int dc_gather_max(const void* h, const void* idx, const void* mask,
                             void* out, int B, int N, int C, int K,
                             int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  const int cw = C >= 256 ? 256 : ((C + 31) / 32) * 32;  // channel threads
  const dim3 block(cw, 256 / cw);
  const long long rows = (long long)B * N;
  const unsigned int grid = (unsigned int)((rows + block.y - 1) / block.y);
  gather_max_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)h, (const int*)idx, (const uint8_t*)mask, (float*)out, B,
      N, C, K);
  return (int)cudaGetLastError();
}
