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
// Bound on the H100: memory, h, idx/mask read once and out (and the
// winners) written once: 0.0210 ms at B=32, N=1024, K=20, f32 C=256
// (0.0310 with winners). A NaN in a valid slot propagates, as jnp.maximum
// does (its winner is 0, as the plain version's first-equal search finds
// no slot equal to NaN); an index outside [0, N) gathers 0, as a one-hot
// row with no match does.
//
// Two routes, chosen by shape in ops/gather_max.py (`max_slice`), the
// same bits.
// Route S, staged (`gather_max`, `gather_max_win`, `_bf16`; with an
// epilogue, the int8 max's route S in gather_max_int8.cu and the bf16
// eval max's in gather_max_bf16.cu; in its sum mode, the neighbour sum's
// route S in gather_sum.cu): any point may
// gather any row of its cloud, so a block takes a task, a cloud b and a
// slice of Cs channels (16 * P bytes a row, P = 1, 2, 4, 8), and copies
// the cloud's slice h[b, :, slice] into shared memory once, by cp.async
// (16, 8 or 4 bytes a copy, the widest the base pointer and the row
// stride allow; 2-byte loads for bf16 rows of an odd stride), beside two
// constant rows: zeros (row N, the row of a valid slot outside the cloud)
// and -inf (row N + 1, the row of a masked slot: -inf never passes the
// strict > of a running max that starts at -3e38, so an all-masked row
// keeps -3e38 and winner 0). Then each point's max comes out of shared
// memory in the max phase of gather_matmul_max_rows.cuh: a group of P
// lanes a point, a 16-byte piece of the slot's row a lane (16-byte rows,
// their pieces XOR-swizzled by row, as the matmul maxes' y slice), four
// slots' reads in flight before the compares, which run in slot order (a
// strict >, so the first winner), the point's idx and mask read once a
// task, three steps ahead; winners stay int32 [B, N, C]. A slice that
// holds a NaN (a block-wide OR after the copy) takes the compares with
// the NaN rules. The widest slice that fits a block (N + 2 rows), no
// wider than h's row; where the tasks are fewer than the SMs, a task's
// points are split over several blocks, each staging the whole slice
// (on the H100 this beat narrower slices at every model shape). Where
// h's row is not a multiple of 16 bytes, the outputs are written one by
// one. Every row of the slice is read from L2 or memory
// once a task (once a block of a split task), and the K slots of a point
// from shared memory: at f32 C=256, 33.5 MB staged and 671 MB of
// shared-memory reads, where route D read the 671 MB from L2.
// Route D, direct (`gather_max_direct`, `gather_max_win_direct`, `_bf16`
// bodies), where no slice fits a block (above 14,526 points), or K is 0,
// or above the bf16 winners' 16 bits: a block row (threadIdx.y) owns one
// point (b, n) and its threads walk the channels, c fastest (two bf16
// channels a thread, one 4-byte load, where C is even): the K loads of a
// warp are coalesced rows of h from L2, and the warp reads each idx/mask
// entry as a broadcast.
//
// Backward (`gather_max_bwd`, `gather_max_bwd_bf16`):
//   dh[b, idx[b, n, winner[b, n, c]], c] += g[b, n, c]
// idx [B, N, K] i32, winner [B, N, C] i32, g [B, N, C] f32 or bf16 ->
// dh [B, n_out, C] f32 (cast to h's dtype by the caller, as the JAX VJP
// does at gather_max.py:445); a winner outside [0, K) or a row outside
// [0, n_out) adds nothing. Replaces `_pallas_bwd_mm` (pallas_call at
// gather_max.py:362, kernel body `_bwd_mm_kernel`), which routed the
// cotangent as a transposed one-hot MXU contraction over a hi/lo split
// (f32 g) or in one half-width pass (bf16 g, `paired=False`). Each (row,
// c)'s addends are summed in f64 and rounded once to f32: the f32 (or
// bf16) addends of one (row, c) sum exactly in f64 unless they span more
// than 29 (bf16: 45) binary orders, so dh is the exact sum rounded once,
// whatever order the adds land in: two calls give the same bits, and so
// does the plain version. (Atomics in f32 gave sums whose last bits
// changed from run to run, and the normal gradient of a point with a
// near-duplicate neighbour, a sum of terms ~1/distance that cancel,
// amplified those bits past 1e-3 x max in some runs.) Bound on the H100:
// memory, idx, winner and g read once and dh written once.
// Two routes, chosen by shape in ops/gather_max.py (`bwd_slice`), the
// same bits.
// Route S, staged (`gather_max_bwd`, `_bf16`): the transpose of the
// forward's route S. A block takes a task, a cloud b, a slice of Cs
// channels (4 to 32) and a range of destination rows, and keeps the
// range's f64 sums, rows x Cs x 8 bytes, in shared memory: it zero-fills
// them, walks all N points of the cloud over its slice (winner and g rows
// coalesced, the winner's row j from the point's idx row, L1), adds each
// g widened to f64 at (j, c) when j lies in its range (a shared-memory
// f64 atomic), and at the end rounds each sum once and writes its dh
// rows. No global scratch, no fill, no second pass. `bwd_slice` takes 8
// channels over one range up to 3,632 rows, then 4 channels over one or
// two ranges (each range re-reads the slice) up to 14,528 rows.
// Route D, direct (`gather_max_bwd_direct`, `_bf16_direct`), the earlier
// kernel: a block row a point, each (b, n, c) adds its cotangent with a
// global f64 atomicAdd at its winner's row of the caller's scratch acc
// [B, n_out, C] f64 (B*N*C atomics, coalesced over c), which the call
// zero-fills first, and a second kernel rounds acc to dh: 16 bytes a
// (row, c) beyond the function's own.
//
// Min and max together (`gather_minmax`, `gather_minmax_bf16`, and with
// winners `gather_minmax_win`, `gather_minmax_win_bf16`):
//   mx[b, n, c] = the masked max above, mn[b, n, c] = the masked min,
// a running max (strict >) and a running min (strict <, so a tie also
// goes to the lowest slot) kept side by side, the NaN rule of the max for
// both (a NaN in a valid slot propagates, takes winner 0 and sticks); a
// row with no valid neighbour gets (-3e38, +3e38) and winners 0.
// Replaces `_pallas_minmax` (pallas_call at gather_max.py:474, kernel body
// `_minmax_kernel`), which gathered through the same one-hot MXU product
// on a hi/lo split as the max. Bound on the H100: memory, as the max (h,
// idx, mask read once, two outputs written; four with the winners: 0.0310
// ms at B=32, N=1024, K=20, f32 C=256, 0.0511 with winners). The max's two
// routes, chosen by `max_slice` as for the max, the same bits.
// Route S (`gather_minmax`, `gather_minmax_win`, `_bf16`): the staged
// kernel in its min/max mode (kEpiMinMax): the slice and its two constant
// rows as for the max, then the max phase keeps the running min (and its
// winners) in registers beside the max's and writes both (all four with
// winners) as whole 16-byte pieces where the rows allow. A masked slot
// reads the -inf row, which never passes the max's > but would win every
// <: the min skips a slot whose row id is N + 1, the id the lane already
// holds, so the min costs no extra shared-memory read. One block an SM.
// Route D (`_direct` bodies, the earlier kernel): route D's layout and
// loads above, every slot's row from L2.
//
// Two-map backward (`gather_minmax_bwd`, `gather_minmax_bwd_bf16`; route D
// `_direct`):
//   dh[b, idx[b, n, wmx[b, n, c]], c] += gmx[b, n, c]
//   dh[b, idx[b, n, wmn[b, n, c]], c] += gmn[b, n, c]
// into one set of f64 sums rounded to f32 dh as above, on the same two
// routes, one launch for both maps: the counterpart of `_pallas_bwd_mm`
// called with two (winner, g) pairs (gather_max.py:528-536). Where the max
// and the min win at the same (row, c) (one valid slot, or equal values)
// both cotangents add.
#include "gather_matmul_max_rows.cuh"

namespace {

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
  dc_round_f64(acc, dh, total, s);
  return (int)cudaGetLastError();
}

// Route S of the backward: one block a task, a cloud b, a slice of CS
// channels from c0 and a range of `rows` destination rows from r0 (a
// task's range index the fastest in blockIdx.x), the range's sums in
// shared memory, acc [rows, CS] f64. Thread t takes channel t % CS of
// points t / CS, t / CS + kBwdThreads / CS, ...: a warp's lanes lie on
// CS channels of 32 / CS points, so one instruction's lanes meet at one
// (row, c) only where two of its points share a winner's row. kAhead
// points a thread load their winner and g before their idx lookups and
// adds. The adds are shared-memory f64 atomics (exact, as in route D:
// any order gives the same bits).
constexpr int kBwdThreads = 512;
constexpr int kAhead = 4;

template <typename G, int CS, bool kTwo>
__global__ void __launch_bounds__(kBwdThreads)
    gather_max_bwd_staged_kernel(const int* __restrict__ idx,
                                 const int* __restrict__ winner,
                                 const G* __restrict__ g,
                                 const int* __restrict__ winner2,
                                 const G* __restrict__ g2,
                                 float* __restrict__ dh, int N, int C, int K,
                                 int n_out, int rows, int ranges) {
  extern __shared__ __align__(16) double acc[];
  const int slices = (C + CS - 1) / CS;
  const int range = blockIdx.x % ranges, bs = blockIdx.x / ranges;
  const int b = bs / slices, c0 = (bs % slices) * CS;
  const int r0 = range * rows, nr = min(rows, n_out - r0);
  const int tid = threadIdx.x, c = tid % CS;
  constexpr int kStride = kBwdThreads / CS;  // points a pass
  for (int e = tid; e < nr * CS; e += kBwdThreads) acc[e] = 0.0;
  __syncthreads();

  const bool c_ok = c0 + c < C;
  const long long pt0 = (long long)b * N;
  // One (winner, g) map's adds for kAhead points p, p + kStride, ...
  auto add_map = [&](const int* wm, const G* gm, int p) {
    int w[kAhead];
    float v[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int pu = p + u * kStride;
      const bool ok = c_ok && pu < N;
      const long long at = (pt0 + pu) * C + c0 + c;
      w[u] = ok ? __ldg(wm + at) : -1;
      v[u] = ok ? to_f32(gm[at]) : 0.0f;
    }
    int j[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      j[u] = (unsigned)w[u] < (unsigned)K
                 ? __ldg(idx + (pt0 + p + u * kStride) * K + w[u])
                 : -1;
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if ((unsigned)(j[u] - r0) < (unsigned)nr)
        atomicAdd(acc + (j[u] - r0) * CS + c, (double)v[u]);
  };
  for (int p = tid / CS; p < N; p += kStride * kAhead) {
    add_map(winner, g, p);
    if (kTwo) add_map(winner2, g2, p);
  }
  __syncthreads();
  for (int e = tid; e < nr * CS; e += kBwdThreads) {
    const int r = e / CS, cc = e % CS;
    if (c0 + cc < C)
      dh[((long long)b * n_out + r0 + r) * C + c0 + cc] =
          __double2float_rn(acc[e]);
  }
}

// Shared memory of a route-S backward block: rows x CS f64;
// ops/gather_max.py (`bwd_smem`) mirrors it.
inline size_t bwd_smem_bytes(int rows, int CS) {
  return (size_t)rows * CS * sizeof(double);
}

template <typename G, int CS, bool kTwo>
int launch_bwd_staged_cs(const void* idx, const void* winner, const void* g,
                         const void* winner2, const void* g2, void* dh,
                         int B, int N, int C, int K, int n_out, int rows,
                         cudaStream_t s) {
  auto kernel = gather_max_bwd_staged_kernel<G, CS, kTwo>;
  const size_t smem = bwd_smem_bytes(rows, CS);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ranges = (n_out + rows - 1) / rows;
  const long long blocks = (long long)B * ((C + CS - 1) / CS) * ranges;
  kernel<<<(unsigned)blocks, kBwdThreads, smem, s>>>(
      (const int*)idx, (const int*)winner, (const G*)g, (const int*)winner2,
      (const G*)g2, (float*)dh, N, C, K, n_out, rows, ranges);
  return (int)cudaGetLastError();
}

// Cs: the slice's channels the wrapper chose (4, 8, 16 or 32), rows: the
// destination rows a block sums (its range); a block that does not fit
// is refused (route D takes those shapes).
template <typename G, bool kTwo = false>
int launch_bwd_staged(const void* idx, const void* winner, const void* g,
                      void* dh, int B, int N, int C, int K, int n_out, int Cs,
                      int rows, void* stream, const void* winner2 = nullptr,
                      const void* g2 = nullptr) {
  if ((long long)B * n_out * C == 0) return (int)cudaGetLastError();
  if ((Cs != 4 && Cs != 8 && Cs != 16 && Cs != 32) || rows < 1 ||
      bwd_smem_bytes(rows, Cs) > kRowsSmemMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (Cs) {
    case 4:
      return launch_bwd_staged_cs<G, 4, kTwo>(idx, winner, g, winner2, g2, dh,
                                              B, N, C, K, n_out, rows, s);
    case 8:
      return launch_bwd_staged_cs<G, 8, kTwo>(idx, winner, g, winner2, g2, dh,
                                              B, N, C, K, n_out, rows, s);
    case 16:
      return launch_bwd_staged_cs<G, 16, kTwo>(idx, winner, g, winner2, g2,
                                               dh, B, N, C, K, n_out, rows,
                                               s);
    default:
      return launch_bwd_staged_cs<G, 32, kTwo>(idx, winner, g, winner2, g2,
                                               dh, B, N, C, K, n_out, rows,
                                               s);
  }
}

// True where a 16-byte piece of a slice holds a NaN (4 f32 or 8 bf16).
__device__ __forceinline__ bool has_nan(uint4 v, float) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  bool nan = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) nan |= (w[i] & 0x7FFFFFFFu) > 0x7F800000u;
  return nan;
}

__device__ __forceinline__ bool has_nan(uint4 v, __nv_bfloat16) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  bool nan = false;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    nan |= (w[i] & 0x7FFFu) > 0x7F80u || ((w[i] >> 16) & 0x7FFFu) > 0x7F80u;
  return nan;
}

// The staged route's epilogues: none (the max, or with winners), the
// int8 form's quantization, the BatchNorm + LeakyReLU of the bf16 eval max;
// its sum mode (gather_sum.cu's route S: f32, no winners) and its min/max
// mode (`gather_minmax`: the max and the min, with or without winners).
constexpr int kEpiNone = 0;
constexpr int kEpiQuant = 1;
constexpr int kEpiAffine = 2;
constexpr int kEpiSum = 3;
constexpr int kEpiMinMax = 4;

// Route S: one block a (task, split), a task a cloud b and a slice of
// kCs = 16 P / sizeof(T) channels; the block stages the slice's N rows
// (and the two constant rows) in shared memory, then takes the max of
// its share of the points. copy_bytes: 16, 8, 4 (cp.async) or 2 (bf16
// loads); vec_out: out (and winner) rows of a multiple of 16 bytes. Two
// blocks an SM (64 registers) for rows of 32 or 64 bytes; 128- and
// 16-byte rows spill at 64 registers and take one (their slices at
// N=1024 and N=8192 leave room for one block anyway), as does every
// row of the affine form (its epilogue spills at 64).
// kEpi kEpiQuant: the int8 form (no winners), its epilogue on the cloud's
// |h| maximum amax[b] (f32 bits, from dc_absmax). kEpiAffine: the bf16
// eval max (no winners) with the epilogue of aff [4, C] f32, with
// sub_self the self row subtracted; the slice's four affine rows read
// from device memory through L1. kEpiSum: the neighbour sum (f32, no
// winners), each point's slots added in slot order from +0.0, a masked
// slot read from the zero row; no NaN scan (a sum needs no NaN rule).
// kEpiMinMax: the min beside the max (strict <, a masked slot skipped by
// its row id), into out_min and, with winners, winner_min; one block an SM
// at every row width (kMinMaxBlocks), its state twice the max's.
constexpr int kMinMaxBlocks = 1;

template <typename T, int P, bool kWinners, int kEpi>
__global__ void __launch_bounds__(
    kRowsWarps * 32,
    kEpi == kEpiMinMax ? kMinMaxBlocks
                       : (P == 2 || P == 4) && kEpi != kEpiAffine ? 2 : 1)
    gather_max_staged_kernel(const T* __restrict__ h,
                             const int* __restrict__ idx,
                             const uint8_t* __restrict__ mask,
                             T* __restrict__ out, int* __restrict__ winner,
                             int N, int C, int K, int splits, int copy_bytes,
                             int vec_out, const unsigned* __restrict__ amax,
                             const float* __restrict__ aff, int sub_self,
                             T* __restrict__ out_min,
                             int* __restrict__ winner_min) {
  constexpr bool kQuant = kEpi == kEpiQuant;
  constexpr bool kSum = kEpi == kEpiSum;
  constexpr bool kMinMax = kEpi == kEpiMinMax;
  constexpr int kRowBytes = 16 * P;
  constexpr int kCs = kRowBytes / (int)sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const int slices = (C + kCs - 1) / kCs;
  const int task = blockIdx.x / splits, split = blockIdx.x % splits;
  const int b = task / slices, c0 = (task % slices) * kCs;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned char* hb = reinterpret_cast<const unsigned char*>(
      h + (long long)b * N * C + c0);
  const long long row_bytes = (long long)C * sizeof(T);
  const int valid_bytes = min(kRowBytes, (C - c0) * (int)sizeof(T));

  // The slice, each row's piece c at piece y_chunk<P>(row, c); bytes past
  // the last channel zero-filled.
  const int units = kRowBytes / copy_bytes;
  for (int e = tid; e < N * units; e += blockDim.x) {
    const int j = e / units, off = (e % units) * copy_bytes;
    unsigned char* dst =
        smem + (j * P + y_chunk<P>(j, off >> 4)) * 16 + (off & 15);
    const bool ok = off < valid_bytes;
    const unsigned char* src = hb + j * row_bytes + (ok ? off : 0);
    if (copy_bytes == 16)
      cp_async16(dst, src, ok);
    else if (copy_bytes == 8)
      cp_async8(dst, src, ok);
    else if (copy_bytes == 4)
      cp_async4(dst, src, ok);
    else
      *reinterpret_cast<unsigned short*>(dst) =
          ok ? *reinterpret_cast<const unsigned short*>(src) : 0;
  }
  // Rows N (zeros) and N + 1 (-inf).
  const unsigned neg_inf = sizeof(T) == 4 ? kNegInfF32 : kNegInf2;
  if (tid < 2 * P)
    reinterpret_cast<uint4*>(smem)[(N + tid / P) * P + tid % P] =
        tid < P ? make_uint4(0u, 0u, 0u, 0u)
                : make_uint4(neg_inf, neg_inf, neg_inf, neg_inf);
  // The affine slice: the device rows from column c0.
  const float* aff_p = kEpi == kEpiAffine ? aff + c0 : nullptr;
  cp_async_commit();
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  const unsigned ys = smem_addr(smem);
  const int chunk = (N + splits - 1) / splits;
  const int p0 = split * chunk, p1 = min(N, p0 + chunk);
  const int nvalid = min(kCs, C - c0);
  // A NaN anywhere in the slice takes the compares with the NaN rules.
  bool any_nan = false;
  if constexpr (!kSum) {
    bool nan_seen = false;
    for (int e = tid; e < N * P; e += blockDim.x)
      nan_seen |= has_nan(lds128(ys + (unsigned)e * 16u), T());
    any_nan = __syncthreads_or(nan_seen) != 0;
  }

  unsigned neg;
  if constexpr (kSum) {  // +0.0 in every word
    neg = 0u;
  } else if constexpr (kQuant) {  // -inf: the max of the valid slots
    neg = sizeof(T) == 4 ? kNegInfF32 : kNegInf2;
  } else if constexpr (sizeof(T) == 4) {
    neg = __float_as_uint(kNeg);
  } else {
    const __nv_bfloat16 nb = __float2bfloat16_rn(kNeg);
    const unsigned bits = *reinterpret_cast<const unsigned short*>(&nb);
    neg = bits | (bits << 16);
  }
  // The int8 form's a = max(max |h|, 1e-30) (a NaN kept, as torch.clamp
  // keeps it) and s = a / 127 as torch computes it on the card: a CUDA
  // tensor divided by a CPU scalar is multiplied by its reciprocal.
  float qa = 0.0f, qs = 0.0f;
  if constexpr (kQuant) {
    const float m = __uint_as_float(amax[b]);
    qa = m != m ? m : fmaxf(m, 1e-30f);
    qs = __fmul_rn(qa, 1.0f / 127.0f);
  }
  const bool self = kEpi == kEpiAffine && sub_self != 0;
  if constexpr (kSum)
    rows_max_phase<T, P, false, false, false, true>(
        ys, idx, mask, nullptr, 0, out, nullptr, b, N, p0, p1, C, c0, nvalid,
        vec_out != 0, K, neg, warp, lane);
  else if (any_nan)
    rows_max_phase<T, P, kWinners, true, kQuant, false, kMinMax>(
        ys, idx, mask, aff_p, C, out, winner, b, N, p0, p1, C, c0,
        nvalid, vec_out != 0, K, neg, warp, lane, qa, qs, self, out_min,
        winner_min);
  else
    rows_max_phase<T, P, kWinners, false, kQuant, false, kMinMax>(
        ys, idx, mask, aff_p, C, out, winner, b, N, p0, p1, C, c0,
        nvalid, vec_out != 0, K, neg, warp, lane, qa, qs, self, out_min,
        winner_min);
}

// Shared memory of a route-S block: N + 2 rows of 16 P bytes;
// ops/gather_max.py (`max_smem`) mirrors it.
inline size_t staged_smem_bytes(int N, int P) {
  return (size_t)(N + 2) * 16 * P;
}

template <typename T, int P, bool kWinners, int kEpi>
int launch_staged_p(const void* h, const void* idx, const void* mask,
                    void* out, void* winner, const void* amax,
                    const void* aff, int sub_self, int B, int N, int C,
                    int K, int splits, int copy_bytes, int vec_out,
                    cudaStream_t s, void* out_min, void* winner_min) {
  auto kernel = gather_max_staged_kernel<T, P, kWinners, kEpi>;
  const size_t smem = staged_smem_bytes(N, P);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int kCs = 16 * P / (int)sizeof(T);
  const long long blocks = (long long)B * ((C + kCs - 1) / kCs) * splits;
  kernel<<<(unsigned)blocks, kRowsWarps * 32, smem, s>>>(
      (const T*)h, (const int*)idx, (const uint8_t*)mask, (T*)out,
      (int*)winner, N, C, K, splits, copy_bytes, vec_out,
      (const unsigned*)amax, (const float*)aff, sub_self, (T*)out_min,
      (int*)winner_min);
  return (int)cudaGetLastError();
}

// Cs: the slice's channels the wrapper chose (16, 32, 64 or 128 bytes a
// row), splits: blocks a task (1 or more). A slice that does not fit a
// block, K of 0, or K above the bf16 winners' 16 bits, is refused (route
// D takes those). kEpi kEpiQuant: the int8 form, on the cloud maxima
// amax; kEpiAffine: the bf16 eval max on aff (sub_self as the kernel
// takes it); kEpiMinMax: the min too, into out_min (and winner_min).
template <typename T, bool kWinners, int kEpi = kEpiNone>
int launch_staged(const void* h, const void* idx, const void* mask,
                  void* out, void* winner, int B, int N, int C, int K, int Cs,
                  int splits, void* stream, const void* amax = nullptr,
                  const void* aff = nullptr, int sub_self = 0,
                  void* out_min = nullptr, void* winner_min = nullptr) {
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  const int row = Cs * (int)sizeof(T);
  const int P = row / 16;
  if (Cs <= 0 || row % 16 != 0 || (P != 1 && P != 2 && P != 4 && P != 8) ||
      splits < 1 || K <= 0 ||
      (kWinners && sizeof(T) == 2 && K > 0xFFFF) ||
      staged_smem_bytes(N, P) > kRowsSmemMax)
    return (int)cudaErrorInvalidValue;
  int copy_bytes = 16;
  while (copy_bytes > (int)sizeof(T) &&
         ((uintptr_t)h % copy_bytes != 0 ||
          ((long long)C * sizeof(T)) % copy_bytes != 0))
    copy_bytes /= 2;
  const int vec_out = ((long long)C * sizeof(T)) % 16 == 0 &&
                      (uintptr_t)out % 16 == 0 &&
                      (uintptr_t)winner % 16 == 0 &&
                      (uintptr_t)out_min % 16 == 0 &&
                      (uintptr_t)winner_min % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (P) {
    case 1:
      return launch_staged_p<T, 1, kWinners, kEpi>(
          h, idx, mask, out, winner, amax, aff, sub_self, B, N,
          C, K, splits, copy_bytes, vec_out, s, out_min, winner_min);
    case 2:
      return launch_staged_p<T, 2, kWinners, kEpi>(
          h, idx, mask, out, winner, amax, aff, sub_self, B, N,
          C, K, splits, copy_bytes, vec_out, s, out_min, winner_min);
    case 4:
      return launch_staged_p<T, 4, kWinners, kEpi>(
          h, idx, mask, out, winner, amax, aff, sub_self, B, N,
          C, K, splits, copy_bytes, vec_out, s, out_min, winner_min);
    default:
      return launch_staged_p<T, 8, kWinners, kEpi>(
          h, idx, mask, out, winner, amax, aff, sub_self, B, N,
          C, K, splits, copy_bytes, vec_out, s, out_min, winner_min);
  }
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
                             void* out, int B, int N, int C, int K, int Cs,
                             int splits, int device, void* stream) {
  DC_SET_DEVICE(device);
  return launch_staged<float, false>(h, idx, mask, out, nullptr, B, N, C, K,
                                     Cs, splits, stream);
}

extern "C" int dc_gather_max_win(const void* h, const void* idx,
                                 const void* mask, void* out, void* winner,
                                 int B, int N, int C, int K, int Cs,
                                 int splits, int device, void* stream) {
  DC_SET_DEVICE(device);
  return launch_staged<float, true>(h, idx, mask, out, winner, B, N, C, K,
                                    Cs, splits, stream);
}

extern "C" int dc_gather_max_bf16(const void* h, const void* idx,
                                  const void* mask, void* out, int B, int N,
                                  int C, int K, int Cs, int splits,
                                  int device, void* stream) {
  DC_SET_DEVICE(device);
  return launch_staged<__nv_bfloat16, false>(h, idx, mask, out, nullptr, B,
                                             N, C, K, Cs, splits, stream);
}

extern "C" int dc_gather_max_win_bf16(const void* h, const void* idx,
                                      const void* mask, void* out,
                                      void* winner, int B, int N, int C,
                                      int K, int Cs, int splits, int device,
                                      void* stream) {
  DC_SET_DEVICE(device);
  return launch_staged<__nv_bfloat16, true>(h, idx, mask, out, winner, B, N,
                                            C, K, Cs, splits, stream);
}

extern "C" int dc_gather_max_direct(const void* h, const void* idx,
                                    const void* mask, void* out, int B, int N,
                                    int C, int K, int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  return launch_fwd<float, 1, false>(h, idx, mask, out, nullptr, B, N, C, K,
                                     stream);
}

extern "C" int dc_gather_max_win_direct(const void* h, const void* idx,
                                        const void* mask, void* out,
                                        void* winner, int B, int N, int C,
                                        int K, int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  return launch_fwd<float, 1, true>(h, idx, mask, out, winner, B, N, C, K,
                                    stream);
}

extern "C" int dc_gather_max_bf16_direct(const void* h, const void* idx,
                                         const void* mask, void* out, int B,
                                         int N, int C, int K, int device,
                                         void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  if (bf16_pairs(h, out, C))
    return launch_fwd<__nv_bfloat16, 2, false>(h, idx, mask, out, nullptr, B,
                                               N, C, K, stream);
  return launch_fwd<__nv_bfloat16, 1, false>(h, idx, mask, out, nullptr, B, N,
                                             C, K, stream);
}

extern "C" int dc_gather_max_win_bf16_direct(const void* h, const void* idx,
                                             const void* mask, void* out,
                                             void* winner, int B, int N,
                                             int C, int K, int device,
                                             void* stream) {
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
                                 int K, int n_out, int Cs, int rows,
                                 int device, void* stream) {
  DC_SET_DEVICE(device);
  return launch_bwd_staged<float>(idx, winner, g, dh, B, N, C, K, n_out, Cs,
                                  rows, stream);
}

extern "C" int dc_gather_max_bwd_bf16(const void* idx, const void* winner,
                                      const void* g, void* dh, int B, int N,
                                      int C, int K, int n_out, int Cs,
                                      int rows, int device, void* stream) {
  DC_SET_DEVICE(device);
  return launch_bwd_staged<__nv_bfloat16>(idx, winner, g, dh, B, N, C, K,
                                          n_out, Cs, rows, stream);
}

extern "C" int dc_gather_max_bwd_direct(const void* idx, const void* winner,
                                        const void* g, void* dh, void* acc,
                                        int B, int N, int C, int K, int n_out,
                                        int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * n_out * C == 0) return (int)cudaGetLastError();
  return launch_bwd<float>(idx, winner, g, dh, acc, B, N, C, K, n_out,
                           stream);
}

extern "C" int dc_gather_max_bwd_bf16_direct(const void* idx,
                                             const void* winner,
                                             const void* g, void* dh,
                                             void* acc, int B, int N, int C,
                                             int K, int n_out, int device,
                                             void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * n_out * C == 0) return (int)cudaGetLastError();
  return launch_bwd<__nv_bfloat16>(idx, winner, g, dh, acc, B, N, C, K,
                                   n_out, stream);
}

// Route S of the min/max: the staged slice of h (Cs channels, `splits`
// blocks a task), the max and the min out of it.
extern "C" int dc_gather_minmax(const void* h, const void* idx,
                                const void* mask, void* mx, void* mn, int B,
                                int N, int C, int K, int Cs, int splits,
                                int device, void* stream) {
  DC_SET_DEVICE(device);
  return launch_staged<float, false, kEpiMinMax>(
      h, idx, mask, mx, nullptr, B, N, C, K, Cs, splits, stream, nullptr,
      nullptr, 0, mn, nullptr);
}

extern "C" int dc_gather_minmax_bf16(const void* h, const void* idx,
                                     const void* mask, void* mx, void* mn,
                                     int B, int N, int C, int K, int Cs,
                                     int splits, int device, void* stream) {
  DC_SET_DEVICE(device);
  return launch_staged<__nv_bfloat16, false, kEpiMinMax>(
      h, idx, mask, mx, nullptr, B, N, C, K, Cs, splits, stream, nullptr,
      nullptr, 0, mn, nullptr);
}

extern "C" int dc_gather_minmax_win(const void* h, const void* idx,
                                    const void* mask, void* mx, void* mn,
                                    void* wmx, void* wmn, int B, int N, int C,
                                    int K, int Cs, int splits, int device,
                                    void* stream) {
  DC_SET_DEVICE(device);
  return launch_staged<float, true, kEpiMinMax>(
      h, idx, mask, mx, wmx, B, N, C, K, Cs, splits, stream, nullptr,
      nullptr, 0, mn, wmn);
}

extern "C" int dc_gather_minmax_win_bf16(const void* h, const void* idx,
                                         const void* mask, void* mx, void* mn,
                                         void* wmx, void* wmn, int B, int N,
                                         int C, int K, int Cs, int splits,
                                         int device, void* stream) {
  DC_SET_DEVICE(device);
  return launch_staged<__nv_bfloat16, true, kEpiMinMax>(
      h, idx, mask, mx, wmx, B, N, C, K, Cs, splits, stream, nullptr,
      nullptr, 0, mn, wmn);
}

// Route D of the min/max (the earlier kernel).
extern "C" int dc_gather_minmax_direct(const void* h, const void* idx,
                                       const void* mask, void* mx, void* mn,
                                       int B, int N, int C, int K, int device,
                                       void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  return launch_fwd<float, 1, false, true>(h, idx, mask, mx, nullptr, B, N, C,
                                           K, stream, mn, nullptr);
}

extern "C" int dc_gather_minmax_bf16_direct(const void* h, const void* idx,
                                            const void* mask, void* mx,
                                            void* mn, int B, int N, int C,
                                            int K, int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  return launch_minmax_bf16<false>(h, idx, mask, mx, mn, nullptr, nullptr, B,
                                   N, C, K, stream);
}

extern "C" int dc_gather_minmax_win_direct(const void* h, const void* idx,
                                           const void* mask, void* mx,
                                           void* mn, void* wmx, void* wmn,
                                           int B, int N, int C, int K,
                                           int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  return launch_fwd<float, 1, true, true>(h, idx, mask, mx, wmx, B, N, C, K,
                                          stream, mn, wmn);
}

extern "C" int dc_gather_minmax_win_bf16_direct(
    const void* h, const void* idx, const void* mask, void* mx, void* mn,
    void* wmx, void* wmn, int B, int N, int C, int K, int device,
    void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  return launch_minmax_bf16<true>(h, idx, mask, mx, mn, wmx, wmn, B, N, C, K,
                                  stream);
}

extern "C" int dc_gather_minmax_bwd(const void* idx, const void* wmx,
                                    const void* gmx, const void* wmn,
                                    const void* gmn, void* dh, int B, int N,
                                    int C, int K, int n_out, int Cs, int rows,
                                    int device, void* stream) {
  DC_SET_DEVICE(device);
  return launch_bwd_staged<float, true>(idx, wmx, gmx, dh, B, N, C, K, n_out,
                                        Cs, rows, stream, wmn, gmn);
}

extern "C" int dc_gather_minmax_bwd_bf16(const void* idx, const void* wmx,
                                         const void* gmx, const void* wmn,
                                         const void* gmn, void* dh, int B,
                                         int N, int C, int K, int n_out,
                                         int Cs, int rows, int device,
                                         void* stream) {
  DC_SET_DEVICE(device);
  return launch_bwd_staged<__nv_bfloat16, true>(
      idx, wmx, gmx, dh, B, N, C, K, n_out, Cs, rows, stream, wmn, gmn);
}

extern "C" int dc_gather_minmax_bwd_direct(const void* idx, const void* wmx,
                                           const void* gmx, const void* wmn,
                                           const void* gmn, void* dh,
                                           void* acc, int B, int N, int C,
                                           int K, int n_out, int device,
                                           void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * n_out * C == 0) return (int)cudaGetLastError();
  return launch_bwd<float, true>(idx, wmx, gmx, dh, acc, B, N, C, K, n_out,
                                 stream, wmn, gmn);
}

extern "C" int dc_gather_minmax_bwd_bf16_direct(
    const void* idx, const void* wmx, const void* gmx, const void* wmn,
    const void* gmn, void* dh, void* acc, int B, int N, int C, int K,
    int n_out, int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * n_out * C == 0) return (int)cudaGetLastError();
  return launch_bwd<__nv_bfloat16, true>(idx, wmx, gmx, dh, acc, B, N, C, K,
                                         n_out, stream, wmn, gmn);
}

// The int8 form's route S (gather_max_int8.cu's `dc_gather_max_int8`):
// the staged max of h (f32, or bf16 where bf16 is 1) with the quantizing
// epilogue on amax [B], the clouds' |h| maxima.
int dc_gather_max_staged_int8(const void* h, const void* idx,
                              const void* mask, const void* amax, void* out,
                              int B, int N, int C, int K, int Cs, int splits,
                              int bf16, void* stream) {
  if (bf16)
    return launch_staged<__nv_bfloat16, false, kEpiQuant>(
        h, idx, mask, out, nullptr, B, N, C, K, Cs, splits, stream, amax);
  return launch_staged<float, false, kEpiQuant>(
      h, idx, mask, out, nullptr, B, N, C, K, Cs, splits, stream, amax);
}

// The neighbour sum's route S (gather_sum.cu's `dc_gather_sum`): the
// staged slice of h f32, each point's slots summed in slot order.
int dc_gather_sum_staged(const void* h, const void* idx, const void* mask,
                         void* out, int B, int N, int C, int K, int Cs,
                         int splits, void* stream) {
  return launch_staged<float, false, kEpiSum>(h, idx, mask, out, nullptr, B,
                                              N, C, K, Cs, splits, stream);
}

// The bf16 eval max's route S (gather_max_bf16.cu's `dc_gather_max_affine`):
// the staged max of h bf16 with the BatchNorm + LeakyReLU epilogue of aff
// [4, C] f32, the self row subtracted where sub_self is 1.
int dc_gather_max_staged_affine(const void* h, const void* idx,
                                const void* mask, const void* aff, void* out,
                                int B, int N, int C, int K, int Cs,
                                int splits, int sub_self, void* stream) {
  return launch_staged<__nv_bfloat16, false, kEpiAffine>(
      h, idx, mask, out, nullptr, B, N, C, K, Cs, splits, stream, nullptr,
      aff, sub_self);
}
