// The int8 serving form's neighbour maxes (the JAX package's int8 mode:
// int8 operators, activations quantized symmetrically per cloud).
//
// `gather_max_int8`:
//   out[b, n, c] = scale[b] * max over k with mask[b, n, k] of
//                  hq[b, idx[b, n, k], c], 0 on a row with no valid slot
//   hq [B, N, C] int8 (the quantized features: round(h / max|h| * 127),
//   torch ops in the wrapper), idx [B, N, K] i32, mask [B, N, K] bool (one
//   byte), scale [B] f32 (max|h| / 127) -> out [B, N, C] f32 or bf16, h's
//   dtype: the int max widened to f32, times the scale (one rounding),
//   cast to bf16 for bf16 features (a second one, as the JAX function's
//   `astype`). Max commutes with the positive scale, so this is the
//   quantization of the neighbour max.
// Replaces the Pallas kernel of deltaconv_tpu/ops/gather_max.py
// (`gather_max_int8`, pallas_call at gather_max.py:1016, body
// `_max_int8_kernel`), which gathered through an int8 one-hot MXU product
// into an int32 plane; the dequantization and the zeroing of empty rows,
// XLA after it there (gather_max.py:1034-1036), run here in the kernel,
// so no int32 [B, N, C] plane is written. Design: a block row
// (threadIdx.y) per point (b, n), its threads across the channels, four
// channels a thread (one 4-byte load) where C % 4 == 0; the K rows of one
// cloud's table (N * C bytes, 128 KB at N=1024, C=128) come from L2.
// Bound on the H100: memory, the int8 table and idx/mask read once and
// the output written once.
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

}  // namespace

// out_bf16: 1 for bf16 output (bf16 features), 0 for f32.
extern "C" int dc_gather_max_int8(const void* hq, const void* idx,
                                  const void* mask, const void* scale,
                                  void* out, int B, int N, int C, int K,
                                  int out_bf16, int device, void* stream) {
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
