// Masked neighbour max, forward with or without winner tracking, and
// its winner-routed backward.
//
// Forward:
//   out[b, n, c] = max over k with mask[b, n, k] of h[b, idx[b, n, k], c]
// h [B, N, C] f32, idx [B, N, K] i32, mask [B, N, K] bool (one byte)
//   -> out [B, N, C] f32; a row with no valid neighbour gets -3e38.
// With winners it also writes winner [B, N, C] i32: the FIRST slot k
// that holds the maximum (a strict > compare, so a tie goes to the
// lowest slot); 0 on a row with no valid neighbour.
//
// Replaces the Pallas forward of deltaconv_tpu/ops/gather_max.py
// (`_pallas_fwd`, pallas_call at gather_max.py:230, kernel body
// `_fwd_kernel`) in both of its modes: winners=False on the eval path
// (`gather_max`, `masked_nbr_max`) and winners=True in the forward of
// the custom VJP. The TPU kernel gathered through one-hot MXU matmuls on
// a hi/lo bf16 split of the table and read the self slot from its own
// rows; a CUDA thread loads h directly, so every slot, the self slot
// included, is an exact f32 load.
//
// Bound on the H100: memory. A block row (threadIdx.y) owns one point
// (b, n) and its threads walk the channels, c fastest: the K loads of a
// warp are coalesced rows of h, and the warp reads each idx/mask entry
// as a broadcast. The table of one cloud (N * C * 4 bytes, 1 MB at
// N=1024, C=256) is reused K times from L2. A NaN in a valid slot
// propagates, as jnp.maximum does (its winner is 0, as the plain
// version's first-equal search finds no slot equal to NaN); an index
// outside [0, N) gathers 0, as a one-hot row with no match does.
//
// Backward (`gather_max_bwd`):
//   dh[b, idx[b, n, winner[b, n, c]], c] += g[b, n, c]
// idx [B, N, K] i32, winner/g [B, N, C] -> dh [B, n_out, C] f32, which
// the caller zero-fills. Replaces `_pallas_bwd_mm` (pallas_call at
// gather_max.py:362, kernel body `_bwd_mm_kernel`), which routed the
// cotangent as a transposed one-hot MXU contraction over a hi/lo split.
// Here each (b, n, c) adds its one cotangent with an atomicAdd at its
// winner's row: B*N*C atomics in all, coalesced over c, spread over the
// table (a row only collects the channels it won). Bound: the atomics in
// L2. The order of the adds, and so the last bits of a sum, can change
// from run to run, as with scatter_add_ on CUDA.
#include "common.cuh"

namespace {

constexpr float kNeg = -3.0e38f;

template <bool kWinners>
__global__ void gather_max_kernel(const float* __restrict__ h,
                                  const int* __restrict__ idx,
                                  const uint8_t* __restrict__ mask,
                                  float* __restrict__ out,
                                  int* __restrict__ winner, int B, int N,
                                  int C, int K) {
  const long long bn = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (bn >= (long long)B * N) return;
  const long long b = bn / N;
  const int* ir = idx + bn * K;
  const uint8_t* mr = mask + bn * K;
  const float* hb = h + b * N * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float best = kNeg;
    int w = 0;
    for (int k = 0; k < K; ++k) {
      if (!mr[k]) continue;
      const int j = ir[k];
      const float v =
          (unsigned)j < (unsigned)N ? hb[(long long)j * C + c] : 0.0f;
      if (v != v) {  // NaN: propagate, winner 0
        best = v;
        w = 0;
        break;
      }
      if (v > best) {
        best = v;
        w = k;
      }
    }
    out[bn * C + c] = best;
    if (kWinners) winner[bn * C + c] = w;
  }
}

__global__ void gather_max_bwd_kernel(const int* __restrict__ idx,
                                      const int* __restrict__ winner,
                                      const float* __restrict__ g,
                                      float* __restrict__ dh, int B, int N,
                                      int C, int K, int n_out) {
  const long long bn = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (bn >= (long long)B * N) return;
  const long long b = bn / N;
  const int* ir = idx + bn * K;
  float* db = dh + b * n_out * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int w = winner[bn * C + c];
    if ((unsigned)w >= (unsigned)K) continue;
    const int j = ir[w];
    if ((unsigned)j >= (unsigned)n_out) continue;
    atomicAdd(db + (long long)j * C + c, g[bn * C + c]);
  }
}

}  // namespace

extern "C" int dc_gather_max(const void* h, const void* idx, const void* mask,
                             void* out, int B, int N, int C, int K,
                             int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  const dim3 block = dc_row_block(C);
  gather_max_kernel<false><<<dc_row_grid(B, N, block), block, 0,
                               (cudaStream_t)stream>>>(
      (const float*)h, (const int*)idx, (const uint8_t*)mask, (float*)out,
      nullptr, B, N, C, K);
  return (int)cudaGetLastError();
}

extern "C" int dc_gather_max_win(const void* h, const void* idx,
                                 const void* mask, void* out, void* winner,
                                 int B, int N, int C, int K, int device,
                                 void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  const dim3 block = dc_row_block(C);
  gather_max_kernel<true><<<dc_row_grid(B, N, block), block, 0,
                               (cudaStream_t)stream>>>(
      (const float*)h, (const int*)idx, (const uint8_t*)mask, (float*)out,
      (int*)winner, B, N, C, K);
  return (int)cudaGetLastError();
}

extern "C" int dc_gather_max_bwd(const void* idx, const void* winner,
                                 const void* g, void* dh, int B, int N, int C,
                                 int K, int n_out, int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  const dim3 block = dc_row_block(C);
  gather_max_bwd_kernel<<<dc_row_grid(B, N, block), block, 0,
                               (cudaStream_t)stream>>>(
      (const int*)idx, (const int*)winner, (const float*)g, (float*)dh, B, N,
      C, K, n_out);
  return (int)cudaGetLastError();
}
