// The int8 serving form's neighbour maxes (the JAX package's int8 mode:
// int8 operators, activations quantized symmetrically per cloud).
//
// `gather_max_int8`:
//   out[b, n, c] = dequant(max over k with mask[b, n, k] of
//                  quant(h[b, idx[b, n, k], c])), 0 on a row with no
//                  valid slot
//   h [B, N, C] f32 or bf16, idx [B, N, K] i32, mask [B, N, K] bool (one
//   byte) -> out [B, N, C] of h's dtype, with the per-cloud quantization
//   of int8_quantize (ops/gather_max.py): a = max(max |h[b]|, 1e-30),
//   quant(v) = rint(fl(fl(v / a) * 127)) (half to even), dequant(q) =
//   fl(q * s), s = a / 127, then h's dtype. An id outside [0, N) gathers
//   0, and quant(0) = 0.
// Replaces the Pallas kernel of deltaconv_tpu/ops/gather_max.py
// (`gather_max_int8`, pallas_call at gather_max.py:1016, body
// `_max_int8_kernel`), which gathered the quantized rows through an int8
// one-hot MXU product into an int32 plane, with XLA's quantization
// before it and the dequantization and zeroing of empty rows after it
// (gather_max.py:964-971, 1034-1036).
// Design: correctly rounded division and multiplication by a positive
// constant and rint are monotone non-decreasing, so max_k quant(x_k) =
// quant(max_k x_k) exactly, ties included: the kernels never form the
// quantized features. Two launches: `absmax` (dc_absmax) reduces each
// cloud's |h| to amax [B] (a warp max, a block max, then one atomicMax a
// block on the f32 bits as unsigned, into a buffer the call zero-fills:
// the bits of non-negative floats order as the floats, and a NaN's |bits|
// exceed inf's, so a NaN wins as vector_norm(inf) gives NaN; many blocks
// a cloud), then route S of the neighbour max (gather_max.cu: the cloud's
// channel slice staged in shared memory, the max out of it, its running
// max from -inf so that it is the valid slots' own max) with a
// quantizing epilogue (`int8_dequant` in gather_matmul_max_rows.cuh): a
// from amax, s = fl(a * fl(1 / 127)), as PyTorch divides a CUDA tensor by
// a CPU scalar on the card (by the reciprocal; the plain version's `a /
// 127.0`), q through an int, then fl(q * s) and h's dtype; a row with no
// valid slot 0, from its mask row. Bit-equal to the plain version
// (quantize, max, dequantize) on finite features. A cloud holding a NaN
// has a = NaN, so every row of it with a valid slot gives NaN, as the
// plain version's NaN scale gives (its quantized NaNs are cast to int8,
// which defines no value; the product is NaN whatever they are). Bound on
// the H100: memory, h read twice (the reduction, then the slice), idx and
// mask read once, out written once: the function's bytes (h once)
// ~0.006 ms at B=32, N=1024, K=20, bf16 C=128.
// Route by shape (`max_slice` in ops/gather_max.py): where no slice fits
// a block (above 14,526 points), route D, the earlier kernel
// (`gather_max_int8_direct`): hq [B, N, C] int8 from int8_quantize in
// torch ops and its scale [B] f32 (a / 127) in, a block row (threadIdx.y)
// a point (b, n), its threads across the channels, four channels a
// thread (one 4-byte load) where C % 4 == 0, the K rows of one cloud's
// int8 table from L2; the int max widened to f32 times the scale (one
// rounding), cast to bf16 for bf16 features.
//
// `gather_matmul_max_int8`:
//   out[b, n, o] = max over valid k of sum_c bf16(xq[b, idx[b, n, k], c])
//                  w[c, o]
//   xq [B, N, C_in] int8, w [C_in, C_out] bf16 (sign already folded in) ->
//   out [B, N, C_out] bf16, -3e38 on a row with no valid slot; f32
//   accumulation; the caller dequantizes by its positive per-cloud scale.
// Replaces `gather_matmul_max_int8` (pallas_call at gather_max.py:1092,
// body `_mm_max_int8_kernel`). Design: the one-product-a-row kernel of the
// bf16 matmul max (gather_matmul_max_rows.cuh, described in
// gather_max_bf16.cu) on int8 rows: row j's product is the same whichever
// point gathers it, and rounding to bf16 is monotone, so the slice of
// bf16(xq[b] @ w) in shared memory holds what every slot reads. The int8
// rows stream by cp.async into int8 ring stages (half a bf16 stage's
// bytes, so two stages leave room for 10,166 points at C_in = 128 where
// bf16 x leaves 10,038) and each 128-row tile is widened once, in shared
// memory, into a bf16 tile (exact, |v| <= 127) for ldmatrix, which reads
// 16-bit elements only; no epilogue, no winners. Bound on the H100: the
// function's bytes (xq, w, idx/mask, the bf16 out: ~0.0073 ms at B=32,
// N=1024, K=20, 128 -> 256; the product, 2.1 GFLOP, 0.002 ms on the
// tensor cores). Route by shape (ops/gather_max.py, `mm_slice` with the
// input's item size): above that size, or with no slice that fits, the
// earlier kernel, `gather_matmul_max_int8_kfold`: the WMMA kernel of
// gather_matmul_max.cuh on int8 rows widened as they are gathered, a
// product a gathered slot (K times the function's).
#include "gather_matmul_max_rows.cuh"

namespace {

__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                 *reinterpret_cast<const unsigned*>(&hi));
}

// V = 4 when C % 4 == 0 (4-byte loads), else 1.
template <typename T, int V>
__global__ void gather_max_int8_kernel(const int8_t* __restrict__ hq,
                                       const int* __restrict__ idx,
                                       const uint8_t* __restrict__ mask,
                                       const float* __restrict__ scale,
                                       T* __restrict__ out, int B, int N,
                                       int C, int K) {
  const long long bn = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (bn >= (long long)B * N) return;
  const long long b = bn / N;
  const int* ir = idx + bn * K;
  const uint8_t* mr = mask + bn * K;
  const int8_t* hb = hq + b * N * C;
  const float s = scale[b];
  bool valid = false;
  for (int k = 0; k < K; ++k) valid |= mr[k] != 0;
  for (int c = threadIdx.x * V; c < C; c += blockDim.x * V) {
    int best[V];
#pragma unroll
    for (int v = 0; v < V; ++v) best[v] = -128;  // below every int8
    for (int k = 0; k < K; ++k) {
      if (!mr[k]) continue;
      const int j = ir[k];
      int val[V];
      if ((unsigned)j >= (unsigned)N) {  // gathers 0, as a one-hot row
#pragma unroll
        for (int v = 0; v < V; ++v) val[v] = 0;
      } else if constexpr (V == 4) {
        const char4 q =
            *reinterpret_cast<const char4*>(hb + (long long)j * C + c);
        val[0] = q.x;
        val[1] = q.y;
        val[2] = q.z;
        val[3] = q.w;
      } else {
        val[0] = hb[(long long)j * C + c];
      }
#pragma unroll
      for (int v = 0; v < V; ++v) best[v] = max(best[v], val[v]);
    }
    float o[V];
#pragma unroll
    for (int v = 0; v < V; ++v)
      o[v] = valid ? __fmul_rn((float)best[v], s) : 0.0f;
    if constexpr (V == 4)
      store4(out + bn * C + c, o);
    else
      store_val(out + bn * C + c, o[0]);
  }
}

template <typename T>
int launch_max_int8(const void* hq, const void* idx, const void* mask,
                    const void* scale, void* out, int B, int N, int C, int K,
                    cudaStream_t s) {
  const int V = (C % 4 == 0) ? 4 : 1;
  // A point's threads across its channel groups (at most 256), as many
  // points a block as fill 256 threads.
  const int groups = (C + V - 1) / V;
  const int tpp = groups < 256 ? groups : 256;
  const dim3 block(tpp, 256 / tpp);
  const long long rows = (long long)B * N;
  const dim3 grid((unsigned)((rows + block.y - 1) / block.y));
  if (V == 4)
    gather_max_int8_kernel<T, 4><<<grid, block, 0, s>>>(
        (const int8_t*)hq, (const int*)idx, (const uint8_t*)mask,
        (const float*)scale, (T*)out, B, N, C, K);
  else
    gather_max_int8_kernel<T, 1><<<grid, block, 0, s>>>(
        (const int8_t*)hq, (const int*)idx, (const uint8_t*)mask,
        (const float*)scale, (T*)out, B, N, C, K);
  return (int)cudaGetLastError();
}

// |h| max of each cloud as f32 bits: kVec 16-byte loads (8 bf16 or 4 f32
// values) where every cloud's data start on 16 bytes, else one value a
// load; `parts` blocks a cloud (blockIdx.x), the cloud blockIdx.y.
template <typename T, bool kVec>
__global__ void absmax_kernel(const T* __restrict__ h,
                              unsigned* __restrict__ amax, long long per) {
  const T* hb = h + (long long)blockIdx.y * per;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  unsigned m = 0u;
  if constexpr (kVec) {
    const uint4* v = reinterpret_cast<const uint4*>(hb);
    const long long n16 = per * (long long)sizeof(T) / 16;
    for (long long i = start; i < n16; i += step) {
      const uint4 q = __ldg(v + i);
      const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (sizeof(T) == 4) {
          m = max(m, w[e] & 0x7FFFFFFFu);
        } else {
          m = max(m, (w[e] & 0x7FFFu) << 16);
          m = max(m, (w[e] >> 16 & 0x7FFFu) << 16);
        }
      }
    }
  } else {
    for (long long i = start; i < per; i += step) {
      if constexpr (sizeof(T) == 4)
        m = max(m, __float_as_uint(hb[i]) & 0x7FFFFFFFu);
      else
        m = max(m, (unsigned)(reinterpret_cast<const unsigned short*>(
                                  hb)[i] & 0x7FFFu) << 16);
    }
  }
  m = __reduce_max_sync(0xffffffffu, m);
  __shared__ unsigned warp_max[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < (int)(blockDim.x >> 5) ? warp_max[lane] : 0u;
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) atomicMax(amax + blockIdx.y, m);
  }
}

constexpr int kAbsmaxThreads = 256;
constexpr int kAbsmaxLoads = 4;    // 16-byte loads a thread, at least
constexpr int kAbsmaxBlocks = 4 * 132;  // about four blocks an SM

template <typename T>
int launch_absmax(const void* h, void* amax, int B, long long per,
                  cudaStream_t s) {
  const cudaError_t err = cudaMemsetAsync(amax, 0, (size_t)B * 4, s);
  if (err != cudaSuccess) return (int)err;
  if (per == 0) return (int)cudaGetLastError();
  const bool vec = (uintptr_t)h % 16 == 0 && (per * sizeof(T)) % 16 == 0;
  const long long units = vec ? per * (long long)sizeof(T) / 16 : per;
  long long parts = (units + kAbsmaxThreads * kAbsmaxLoads - 1) /
                    (kAbsmaxThreads * kAbsmaxLoads);
  const long long most = (kAbsmaxBlocks + B - 1) / B;
  if (parts > most) parts = most;
  if (parts < 1) parts = 1;
  const dim3 grid((unsigned)parts, (unsigned)B);
  if (vec)
    absmax_kernel<T, true><<<grid, kAbsmaxThreads, 0, s>>>(
        (const T*)h, (unsigned*)amax, per);
  else
    absmax_kernel<T, false><<<grid, kAbsmaxThreads, 0, s>>>(
        (const T*)h, (unsigned*)amax, per);
  return (int)cudaGetLastError();
}

}  // namespace

// gather_max.cu: route S of the neighbour max with the int8 epilogue.
int dc_gather_max_staged_int8(const void* h, const void* idx,
                              const void* mask, const void* amax, void* out,
                              int B, int N, int C, int K, int Cs, int splits,
                              int bf16, void* stream);

// amax [B] (4 bytes each): max |h[b]| as f32 bits; h [B, N, C] f32, or
// bf16 where bf16 is 1.
extern "C" int dc_absmax(const void* h, void* amax, int B, int N, int C,
                         int bf16, int device, void* stream) {
  DC_SET_DEVICE(device);
  const long long per = (long long)N * C;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) return launch_absmax<__nv_bfloat16>(h, amax, B, per, s);
  return launch_absmax<float>(h, amax, B, per, s);
}

// Route S: Cs channels a slice and `splits` blocks a task, as
// gather_max's route S (`max_slice`); amax from dc_absmax.
extern "C" int dc_gather_max_int8(const void* h, const void* idx,
                                  const void* mask, const void* amax,
                                  void* out, int B, int N, int C, int K,
                                  int Cs, int splits, int bf16, int device,
                                  void* stream) {
  DC_SET_DEVICE(device);
  return dc_gather_max_staged_int8(h, idx, mask, amax, out, B, N, C, K, Cs,
                                   splits, bf16, stream);
}

// Route D. out_bf16: 1 for bf16 output (bf16 features), 0 for f32.
extern "C" int dc_gather_max_int8_direct(const void* hq, const void* idx,
                                         const void* mask, const void* scale,
                                         void* out, int B, int N, int C,
                                         int K, int out_bf16, int device,
                                         void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (out_bf16)
    return launch_max_int8<__nv_bfloat16>(hq, idx, mask, scale, out, B, N, C,
                                          K, s);
  return launch_max_int8<float>(hq, idx, mask, scale, out, B, N, C, K, s);
}

extern "C" int dc_gather_matmul_max_int8(const void* xq, const void* w,
                                         const void* idx, const void* mask,
                                         void* out, int B, int N, int Cin,
                                         int Cout, int K, int Cs, int device,
                                         void* stream) {
  DC_SET_DEVICE(device);
  return launch_matmul_max_rows<false, int8_t>(xq, w, idx, mask, nullptr,
                                               out, nullptr, B, N, Cin, Cout,
                                               K, Cs, stream);
}

extern "C" int dc_gather_matmul_max_int8_kfold(const void* xq, const void* w,
                                               const void* idx,
                                               const void* mask, void* out,
                                               int B, int N, int Cin,
                                               int Cout, int K, int device,
                                               void* stream) {
  DC_SET_DEVICE(device);
  return launch_matmul_max<false, int8_t>(xq, w, idx, mask, nullptr, out,
                                          nullptr, B, N, Cin, Cout, K,
                                          stream);
}
