// Masked neighbour max, forward with or without winner tracking, and
// its winner-routed backward, on f32 or bf16 features.
//
// Forward:
//   out[b, n, c] = max over k with mask[b, n, k] of h[b, idx[b, n, k], c]
// h [B, N, C] f32 or bf16, idx [B, N, K] i32, mask [B, N, K] bool (one
// byte) -> out [B, N, C] of h's type; a row with no valid neighbour gets
// -3e38 (rounded to bf16 for bf16). With winners it also writes winner
// [B, N, C] i32: the FIRST slot k that holds the maximum (a strict >
// compare, so a tie goes to the lowest slot); 0 on a row with no valid
// neighbour. bf16 values are compared in f32 (exact); the max of bf16
// values is a bf16 value, so the bf16 output is lossless.
//
// Replaces the Pallas forward of deltaconv_tpu/ops/gather_max.py
// (`_pallas_fwd`, pallas_call at gather_max.py:230, kernel body
// `_fwd_kernel`) in both of its modes: winners=False on the eval path
// (`gather_max`, `masked_nbr_max`; `gather_max_bf16` on the bf16
// features of a depth-2 conv's per-point MLP in bf16 serving) and
// winners=True in the forward of the custom VJP, with f32 features
// (`gather_max_win`) and with the bf16 features of the mixed-precision
// train step (`gather_max_win_bf16`); bf16 in, bf16 out
// (gather_max.py:218-225). The TPU kernel gathered
// through one-hot MXU matmuls on a hi/lo bf16 split of the f32 table and
// read the self slot from its own rows; a CUDA thread loads h directly,
// so every slot, the self slot included, is an exact load.
//
// Bound on the H100: memory. A block row (threadIdx.y) owns one point
// (b, n) and its threads walk the channels, c fastest (two bf16 channels
// a thread, one 4-byte load, where C is even): the K loads of a warp are
// coalesced rows of h, and the warp reads each idx/mask entry as a
// broadcast. The table of one cloud (N * C * 4 bytes, 1 MB at N=1024,
// C=256 in f32; half that in bf16) is reused K times from L2. A NaN in a
// valid slot propagates, as jnp.maximum does (its winner is 0, as the
// plain version's first-equal search finds no slot equal to NaN); an
// index outside [0, N) gathers 0, as a one-hot row with no match does.
//
// Backward (`gather_max_bwd`, `gather_max_bwd_bf16`):
//   dh[b, idx[b, n, winner[b, n, c]], c] += g[b, n, c]
// idx [B, N, K] i32, winner [B, N, C] i32, g [B, N, C] f32 or bf16 ->
// dh [B, n_out, C] f32, which the caller zero-fills (and casts to h's
// dtype, as the JAX VJP does at gather_max.py:445). Replaces
// `_pallas_bwd_mm` (pallas_call at gather_max.py:362, kernel body
// `_bwd_mm_kernel`), which routed the cotangent as a transposed one-hot
// MXU contraction over a hi/lo split (f32 g) or in one half-width pass
// (bf16 g, `paired=False`). Here each (b, n, c) adds its one cotangent,
// widened to f32, with an atomicAdd at its winner's row: B*N*C atomics
// in all, coalesced over c, spread over the table (a row only collects
// the channels it won). Bound: the atomics in L2. The order of the adds,
// and so the last bits of a sum, can change from run to run, as with
// scatter_add_ on CUDA.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr float kNeg = -3.0e38f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V consecutive channels of row j of the table, widened to f32; 0
// outside [0, N). V == 2 only for bf16 (one 4-byte load).
template <typename T, int V>
__device__ __forceinline__ void load_row(const T* hb, int j, int N, int C,
                                         int c, float* val) {
  if ((unsigned)j >= (unsigned)N) {
#pragma unroll
    for (int v = 0; v < V; ++v) val[v] = 0.0f;
    return;
  }
  const T* p = hb + (long long)j * C + c;
  if constexpr (V == 2) {
    const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(p);
    val[0] = __low2float(pair);
    val[1] = __high2float(pair);
  } else {
    val[0] = to_f32(p[0]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_row(T* p, const float* val) {
  if constexpr (V == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) =
        __floats2bfloat162_rn(val[0], val[1]);
  } else {
    p[0] = from_f32<T>(val[0]);
  }
}

template <typename T, int V, bool kWinners>
__global__ void gather_max_kernel(const T* __restrict__ h,
                                  const int* __restrict__ idx,
                                  const uint8_t* __restrict__ mask,
                                  T* __restrict__ out,
                                  int* __restrict__ winner, int B, int N,
                                  int C, int K) {
  const long long bn = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (bn >= (long long)B * N) return;
  const long long b = bn / N;
  const int* ir = idx + bn * K;
  const uint8_t* mr = mask + bn * K;
  const T* hb = h + b * N * C;
  for (int c = threadIdx.x * V; c < C; c += blockDim.x * V) {
    float best[V], val[V];
    int w[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      best[v] = kNeg;
      w[v] = 0;
    }
    for (int k = 0; k < K; ++k) {
      if (!mr[k]) continue;
      load_row<T, V>(hb, ir[k], N, C, c, val);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (val[v] != val[v]) {  // NaN: propagates, winner 0, sticks
          if (best[v] == best[v]) {
            best[v] = val[v];
            w[v] = 0;
          }
        } else if (val[v] > best[v]) {
          best[v] = val[v];
          w[v] = k;
        }
      }
    }
    store_row<T, V>(out + bn * C + c, best);
    if (kWinners) {
#pragma unroll
      for (int v = 0; v < V; ++v) winner[bn * C + c + v] = w[v];
    }
  }
}

template <typename G>
__global__ void gather_max_bwd_kernel(const int* __restrict__ idx,
                                      const int* __restrict__ winner,
                                      const G* __restrict__ g,
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
    atomicAdd(db + (long long)j * C + c, to_f32(g[bn * C + c]));
  }
}

template <typename T, int V, bool kWinners>
int launch_fwd(const void* h, const void* idx, const void* mask, void* out,
               void* winner, int B, int N, int C, int K, void* stream) {
  const dim3 block = dc_row_block((C + V - 1) / V);
  gather_max_kernel<T, V, kWinners><<<dc_row_grid(B, N, block), block, 0,
                                      (cudaStream_t)stream>>>(
      (const T*)h, (const int*)idx, (const uint8_t*)mask, (T*)out,
      (int*)winner, B, N, C, K);
  return (int)cudaGetLastError();
}

template <typename G>
int launch_bwd(const void* idx, const void* winner, const void* g, void* dh,
               int B, int N, int C, int K, int n_out, void* stream) {
  const dim3 block = dc_row_block(C);
  gather_max_bwd_kernel<G><<<dc_row_grid(B, N, block), block, 0,
                             (cudaStream_t)stream>>>(
      (const int*)idx, (const int*)winner, (const G*)g, (float*)dh, B, N, C,
      K, n_out);
  return (int)cudaGetLastError();
}

// Pairs of channels where every pair is 4-byte aligned.
bool bf16_pairs(const void* h, const void* out, int C) {
  return C % 2 == 0 && (uintptr_t)h % 4 == 0 && (uintptr_t)out % 4 == 0;
}

}  // namespace

extern "C" int dc_gather_max(const void* h, const void* idx, const void* mask,
                             void* out, int B, int N, int C, int K,
                             int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  return launch_fwd<float, 1, false>(h, idx, mask, out, nullptr, B, N, C, K,
                                     stream);
}

extern "C" int dc_gather_max_win(const void* h, const void* idx,
                                 const void* mask, void* out, void* winner,
                                 int B, int N, int C, int K, int device,
                                 void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  return launch_fwd<float, 1, true>(h, idx, mask, out, winner, B, N, C, K,
                                    stream);
}

extern "C" int dc_gather_max_bf16(const void* h, const void* idx,
                                  const void* mask, void* out, int B, int N,
                                  int C, int K, int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  if (bf16_pairs(h, out, C))
    return launch_fwd<__nv_bfloat16, 2, false>(h, idx, mask, out, nullptr, B,
                                               N, C, K, stream);
  return launch_fwd<__nv_bfloat16, 1, false>(h, idx, mask, out, nullptr, B, N,
                                             C, K, stream);
}

extern "C" int dc_gather_max_win_bf16(const void* h, const void* idx,
                                      const void* mask, void* out,
                                      void* winner, int B, int N, int C,
                                      int K, int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  if (bf16_pairs(h, out, C))
    return launch_fwd<__nv_bfloat16, 2, true>(h, idx, mask, out, winner, B,
                                              N, C, K, stream);
  return launch_fwd<__nv_bfloat16, 1, true>(h, idx, mask, out, winner, B, N,
                                            C, K, stream);
}

extern "C" int dc_gather_max_bwd(const void* idx, const void* winner,
                                 const void* g, void* dh, int B, int N, int C,
                                 int K, int n_out, int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  return launch_bwd<float>(idx, winner, g, dh, B, N, C, K, n_out, stream);
}

extern "C" int dc_gather_max_bwd_bf16(const void* idx, const void* winner,
                                      const void* g, void* dh, int B, int N,
                                      int C, int K, int n_out, int device,
                                      void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  return launch_bwd<__nv_bfloat16>(idx, winner, g, dh, B, N, C, K, n_out,
                                   stream);
}
