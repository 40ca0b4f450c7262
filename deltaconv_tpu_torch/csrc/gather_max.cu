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
// dh [B, n_out, C] f32 (cast to h's dtype by the caller, as the JAX VJP
// does at gather_max.py:445), through the caller's scratch acc [B,
// n_out, C] f64, which the call zero-fills first. Replaces
// `_pallas_bwd_mm` (pallas_call at gather_max.py:362, kernel body
// `_bwd_mm_kernel`), which routed the cotangent as a transposed one-hot
// MXU contraction over a hi/lo split (f32 g) or in one half-width pass
// (bf16 g, `paired=False`). Here each (b, n, c) adds its one cotangent,
// widened to f64, with an atomicAdd at its winner's row of acc: B*N*C
// atomics in all, coalesced over c, spread over the table (a row only
// collects the channels it won); a second kernel in the same call rounds
// acc to dh. The f32 (or bf16) addends of one (row, c) sum exactly in
// f64 unless they span more than 29 (bf16: 45) binary orders, so dh is
// the exact sum rounded once to f32, whatever order the atomics land in:
// two calls give the same bits, and so does the plain version. Atomics
// in f32 gave sums whose last bits changed from run to run, and the
// normal gradient of a point with a near-duplicate neighbour (a sum of
// terms ~1/distance that cancel) amplified those bits past 1e-3 x max
// in some runs. Bound: the atomics in L2, plus the accumulator's fill
// and read, 16 bytes a (row, c) beyond the function's own.
//
// Min and max together (`gather_minmax`, `gather_minmax_bf16`, and with
// winners `gather_minmax_win`, `gather_minmax_win_bf16`):
//   mx[b, n, c] = the masked max above, mn[b, n, c] = the masked min,
// with the same layout, loads and NaN rule, a running max (strict >) and
// a running min (strict <, so a tie also goes to the lowest slot) kept
// side by side; a row with no valid neighbour gets (-3e38, +3e38) and
// winners 0. Replaces `_pallas_minmax` (pallas_call at gather_max.py:474,
// kernel body `_minmax_kernel`), which gathered through the same one-hot
// MXU product on a hi/lo split as the max; here every slot is a direct
// load. Bound on the H100: memory, as the max (the same K rows read,
// two outputs written; four with the winners).
//
// Two-map backward (`gather_minmax_bwd`, `gather_minmax_bwd_bf16`):
//   dh[b, idx[b, n, wmx[b, n, c]], c] += gmx[b, n, c]
//   dh[b, idx[b, n, wmn[b, n, c]], c] += gmn[b, n, c]
// into one f64 acc rounded to f32 dh as above, one launch reading idx
// once for both maps: the counterpart of `_pallas_bwd_mm` called with
// two (winner, g) pairs (gather_max.py:528-536). Where the max and the min win at the
// same (row, c) (one valid slot, or equal values) both cotangents add.
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

// One step of a running extreme over the slots: the max (kMin false,
// strict >) or the min (kMin true, strict <), so a tie keeps the lowest
// slot. A NaN propagates, takes winner 0, and sticks.
template <bool kMin>
__device__ __forceinline__ void take(float val, int k, float& best, int& w) {
  if (val != val) {
    if (best == best) {
      best = val;
      w = 0;
    }
  } else if (kMin ? val < best : val > best) {
    best = val;
    w = k;
  }
}

// kMin: also the running min, into out_min (and winner_min).
template <typename T, int V, bool kWinners, bool kMin>
__global__ void gather_max_kernel(const T* __restrict__ h,
                                  const int* __restrict__ idx,
                                  const uint8_t* __restrict__ mask,
                                  T* __restrict__ out,
                                  int* __restrict__ winner,
                                  T* __restrict__ out_min,
                                  int* __restrict__ winner_min, int B, int N,
                                  int C, int K) {
  const long long bn = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (bn >= (long long)B * N) return;
  const long long b = bn / N;
  const int* ir = idx + bn * K;
  const uint8_t* mr = mask + bn * K;
  const T* hb = h + b * N * C;
  for (int c = threadIdx.x * V; c < C; c += blockDim.x * V) {
    float best[V], worst[V], val[V];
    int w[V], wn[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      best[v] = kNeg;
      worst[v] = -kNeg;
      w[v] = wn[v] = 0;
    }
    for (int k = 0; k < K; ++k) {
      if (!mr[k]) continue;
      load_row<T, V>(hb, ir[k], N, C, c, val);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        take<false>(val[v], k, best[v], w[v]);
        if (kMin) take<true>(val[v], k, worst[v], wn[v]);
      }
    }
    store_row<T, V>(out + bn * C + c, best);
    if (kMin) store_row<T, V>(out_min + bn * C + c, worst);
    if (kWinners) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        winner[bn * C + c + v] = w[v];
        if (kMin) winner_min[bn * C + c + v] = wn[v];
      }
    }
  }
}

// One (winner, g) map routed into dh at channel c of point bn.
template <typename G>
__device__ __forceinline__ void route(const int* ir, const int* winner,
                                      const G* g, double* db, long long bn,
                                      int c, int C, int K, int n_out) {
  const int w = winner[bn * C + c];
  if ((unsigned)w >= (unsigned)K) return;
  const int j = ir[w];
  if ((unsigned)j >= (unsigned)n_out) return;
  atomicAdd(db + (long long)j * C + c, (double)to_f32(g[bn * C + c]));
}

// kTwo: a second map (winner2, g2) into the same acc.
template <typename G, bool kTwo>
__global__ void gather_max_bwd_kernel(const int* __restrict__ idx,
                                      const int* __restrict__ winner,
                                      const G* __restrict__ g,
                                      const int* __restrict__ winner2,
                                      const G* __restrict__ g2,
                                      double* __restrict__ acc, int B, int N,
                                      int C, int K, int n_out) {
  const long long bn = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (bn >= (long long)B * N) return;
  const long long b = bn / N;
  const int* ir = idx + bn * K;
  double* db = acc + b * n_out * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    route<G>(ir, winner, g, db, bn, c, C, K, n_out);
    if (kTwo) route<G>(ir, winner2, g2, db, bn, c, C, K, n_out);
  }
}

// dh = acc rounded to f32 (nearest even), two elements a thread (one
// for the last of an odd count).
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

template <typename T, int V, bool kWinners, bool kMin = false>
int launch_fwd(const void* h, const void* idx, const void* mask, void* out,
               void* winner, int B, int N, int C, int K, void* stream,
               void* out_min = nullptr, void* winner_min = nullptr) {
  const dim3 block = dc_row_block((C + V - 1) / V);
  gather_max_kernel<T, V, kWinners, kMin><<<dc_row_grid(B, N, block), block,
                                            0, (cudaStream_t)stream>>>(
      (const T*)h, (const int*)idx, (const uint8_t*)mask, (T*)out,
      (int*)winner, (T*)out_min, (int*)winner_min, B, N, C, K);
  return (int)cudaGetLastError();
}

// acc zero-filled, the atomics into it, then acc rounded into dh (16-
// and 8-byte aligned, as the caller's allocations are).
template <typename G, bool kTwo = false>
int launch_bwd(const void* idx, const void* winner, const void* g, void* dh,
               void* acc, int B, int N, int C, int K, int n_out,
               void* stream, const void* winner2 = nullptr,
               const void* g2 = nullptr) {
  const dim3 block = dc_row_block(C);
  cudaStream_t s = (cudaStream_t)stream;
  const long long total = (long long)B * n_out * C;
  const cudaError_t err = cudaMemsetAsync(acc, 0, total * sizeof(double), s);
  if (err != cudaSuccess) return (int)err;
  if ((long long)B * N * C > 0)
    gather_max_bwd_kernel<G, kTwo><<<dc_row_grid(B, N, block), block, 0,
                                     s>>>(
        (const int*)idx, (const int*)winner, (const G*)g,
        (const int*)winner2, (const G*)g2, (double*)acc, B, N, C, K, n_out);
  const long long blocks = ((total + 1) / 2 + 255) / 256;
  round_f64_kernel<<<(unsigned)(blocks < 8192 ? blocks : 8192), 256, 0, s>>>(
      (const double*)acc, (float*)dh, total);
  return (int)cudaGetLastError();
}

// Pairs of channels where every pair is 4-byte aligned.
bool bf16_pairs(const void* h, const void* out, int C) {
  return C % 2 == 0 && (uintptr_t)h % 4 == 0 && (uintptr_t)out % 4 == 0;
}

// The min/max forward on bf16 features: pairs of channels where h and
// both outputs allow them, else one channel a thread.
template <bool kWinners>
int launch_minmax_bf16(const void* h, const void* idx, const void* mask,
                       void* mx, void* mn, void* wmx, void* wmn, int B, int N,
                       int C, int K, void* stream) {
  if (bf16_pairs(h, mx, C) && bf16_pairs(h, mn, C))
    return launch_fwd<__nv_bfloat16, 2, kWinners, true>(
        h, idx, mask, mx, wmx, B, N, C, K, stream, mn, wmn);
  return launch_fwd<__nv_bfloat16, 1, kWinners, true>(
      h, idx, mask, mx, wmx, B, N, C, K, stream, mn, wmn);
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
                                 const void* g, void* dh, void* acc, int B,
                                 int N, int C, int K, int n_out, int device,
                                 void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * n_out * C == 0) return (int)cudaGetLastError();
  return launch_bwd<float>(idx, winner, g, dh, acc, B, N, C, K, n_out,
                           stream);
}

extern "C" int dc_gather_max_bwd_bf16(const void* idx, const void* winner,
                                      const void* g, void* dh, void* acc,
                                      int B, int N, int C, int K, int n_out,
                                      int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * n_out * C == 0) return (int)cudaGetLastError();
  return launch_bwd<__nv_bfloat16>(idx, winner, g, dh, acc, B, N, C, K,
                                   n_out, stream);
}

extern "C" int dc_gather_minmax(const void* h, const void* idx,
                                const void* mask, void* mx, void* mn, int B,
                                int N, int C, int K, int device,
                                void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  return launch_fwd<float, 1, false, true>(h, idx, mask, mx, nullptr, B, N, C,
                                           K, stream, mn, nullptr);
}

extern "C" int dc_gather_minmax_bf16(const void* h, const void* idx,
                                     const void* mask, void* mx, void* mn,
                                     int B, int N, int C, int K, int device,
                                     void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  return launch_minmax_bf16<false>(h, idx, mask, mx, mn, nullptr, nullptr, B,
                                   N, C, K, stream);
}

extern "C" int dc_gather_minmax_win(const void* h, const void* idx,
                                    const void* mask, void* mx, void* mn,
                                    void* wmx, void* wmn, int B, int N, int C,
                                    int K, int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  return launch_fwd<float, 1, true, true>(h, idx, mask, mx, wmx, B, N, C, K,
                                          stream, mn, wmn);
}

extern "C" int dc_gather_minmax_win_bf16(const void* h, const void* idx,
                                         const void* mask, void* mx, void* mn,
                                         void* wmx, void* wmn, int B, int N,
                                         int C, int K, int device,
                                         void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  return launch_minmax_bf16<true>(h, idx, mask, mx, mn, wmx, wmn, B, N, C, K,
                                  stream);
}

extern "C" int dc_gather_minmax_bwd(const void* idx, const void* wmx,
                                    const void* gmx, const void* wmn,
                                    const void* gmn, void* dh, void* acc,
                                    int B, int N, int C, int K, int n_out,
                                    int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * n_out * C == 0) return (int)cudaGetLastError();
  return launch_bwd<float, true>(idx, wmx, gmx, dh, acc, B, N, C, K, n_out,
                                 stream, wmn, gmn);
}

extern "C" int dc_gather_minmax_bwd_bf16(const void* idx, const void* wmx,
                                         const void* gmx, const void* wmn,
                                         const void* gmn, void* dh,
                                         void* acc, int B, int N, int C,
                                         int K, int n_out, int device,
                                         void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * n_out * C == 0) return (int)cudaGetLastError();
  return launch_bwd<__nv_bfloat16, true>(idx, wmx, gmx, dh, acc, B, N, C, K,
                                         n_out, stream, wmn, gmn);
}
