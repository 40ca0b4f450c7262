// Coefficient-form operator applies, the large-cloud path:
//   grad: y[b, n, d, c] = sum_k g[b, n, k, d] * x[b, idx[b, n, k], c]
//   div:  y[b, n, c]    = sum_k sum_d g[b, n, k, d] * v[b, idx[b, n, k], d, c]
// x [B, N, C] and v [B, N, 2, C] f32 or bf16, g [B, N, K, 2] f32 (the
// grad or div coefficients), idx [B, N, K] i32 -> y [B, N, 2, C] (grad)
// or [B, N, C] (div) in the features' dtype.
//
// Replaces `_grad_fwd_pallas` (pallas_call at
// deltaconv_tpu/ops/coef_apply.py:140, kernel body `_grad_kernel`) and
// `_div_fwd_pallas` (pallas_call at coef_apply.py:173, `_div_kernel`).
// The TPU kernels gathered the neighbour rows through one-hot MXU
// matmuls (f32 tables split hi/lo into two bf16 halves), fitted their
// point tiles to VMEM budgets and wrote the grad component-leading,
// swapped outside. Here a thread loads the neighbour's row directly, so
// the gather is exact, and the grad is written [B, N, 2, C] at once.
//
// Rounding, as the TPU kernel's: the products and sums are f32, each
// rounded on its own (__fmul_rn, __fadd_rn: no FMA contraction), slot
// k = 0..K-1 in turn; div adds component 0's product, then component
// 1's; the f32 accumulators are cast once, at the end, to the features'
// dtype. The plain versions loop in the same order, so the two are
// bit-equal.
//
// Bound on the H100: memory. The layout is gather_max.cu's: a block row
// (threadIdx.y) owns one point (b, n), its threads walk the channels, c
// fastest (two bf16 channels a thread, one 4-byte load, where C is
// even): the K loads of a warp are coalesced rows of the features, and
// the warp reads each index and coefficient pair as a broadcast. The
// features of one cloud (N * C * 4 bytes, 8 MB at N=8192, C=256 in f32)
// are reused K times from L2. Masked edges carry zero coefficients, so
// no mask is read; an index outside [0, N) gathers 0, as a one-hot row
// with no match does on the TPU.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// V consecutive channels at column c of row j (row stride S elements),
// widened to f32; 0 outside [0, N). V == 2 only for bf16.
template <typename T, int V>
__device__ __forceinline__ void load_row(const T* base, int j, int N,
                                         long long S, int c, float* val) {
  if ((unsigned)j >= (unsigned)N) {
#pragma unroll
    for (int v = 0; v < V; ++v) val[v] = 0.0f;
    return;
  }
  const T* p = base + (long long)j * S + c;
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
  } else if constexpr (sizeof(T) == 2) {
    p[0] = __float2bfloat16_rn(val[0]);
  } else {
    p[0] = val[0];
  }
}

template <typename T, int V>
__global__ void coef_grad_kernel(const T* __restrict__ x,
                                 const float2* __restrict__ coef,
                                 const int* __restrict__ idx,
                                 T* __restrict__ out, int B, int N, int C,
                                 int K) {
  const long long bn = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (bn >= (long long)B * N) return;
  const long long b = bn / N;
  const int* ir = idx + bn * K;
  const float2* wr = coef + bn * K;
  const T* xb = x + b * N * C;
  for (int c = threadIdx.x * V; c < C; c += blockDim.x * V) {
    float a0[V], a1[V], val[V];
#pragma unroll
    for (int v = 0; v < V; ++v) a0[v] = a1[v] = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float2 w = wr[k];
      load_row<T, V>(xb, ir[k], N, C, c, val);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        a0[v] = __fadd_rn(a0[v], __fmul_rn(val[v], w.x));
        a1[v] = __fadd_rn(a1[v], __fmul_rn(val[v], w.y));
      }
    }
    T* o = out + bn * 2 * C + c;
    store_row<T, V>(o, a0);
    store_row<T, V>(o + C, a1);
  }
}

template <typename T, int V>
__global__ void coef_div_kernel(const T* __restrict__ v,
                                const float2* __restrict__ coef,
                                const int* __restrict__ idx,
                                T* __restrict__ out, int B, int N, int C,
                                int K) {
  const long long bn = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (bn >= (long long)B * N) return;
  const long long b = bn / N;
  const int* ir = idx + bn * K;
  const float2* wr = coef + bn * K;
  const T* vb = v + b * N * 2 * C;
  const long long row = 2LL * C;
  for (int c = threadIdx.x * V; c < C; c += blockDim.x * V) {
    float acc[V], v0[V], v1[V];
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float2 w = wr[k];
      const int j = ir[k];
      load_row<T, V>(vb, j, N, row, c, v0);
      load_row<T, V>(vb + C, j, N, row, c, v1);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        acc[q] = __fadd_rn(acc[q], __fmul_rn(v0[q], w.x));
        acc[q] = __fadd_rn(acc[q], __fmul_rn(v1[q], w.y));
      }
    }
    store_row<T, V>(out + bn * C + c, acc);
  }
}

template <typename T, int V, bool kGrad>
int launch(const void* in, const void* coef, const void* idx, void* out,
           int B, int N, int C, int K, void* stream) {
  const dim3 block = dc_row_block((C + V - 1) / V);
  const dim3 grid = dc_row_grid(B, N, block);
  if constexpr (kGrad) {
    coef_grad_kernel<T, V><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const T*)in, (const float2*)coef, (const int*)idx, (T*)out, B, N, C,
        K);
  } else {
    coef_div_kernel<T, V><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const T*)in, (const float2*)coef, (const int*)idx, (T*)out, B, N, C,
        K);
  }
  return (int)cudaGetLastError();
}

template <bool kGrad>
int dispatch(const void* in, const void* coef, const void* idx, void* out,
             int B, int N, int C, int K, int bf16, void* stream) {
  if (!bf16)
    return launch<float, 1, kGrad>(in, coef, idx, out, B, N, C, K, stream);
  // Channel pairs where every pair is 4-byte aligned.
  if (C % 2 == 0 && (uintptr_t)in % 4 == 0 && (uintptr_t)out % 4 == 0)
    return launch<__nv_bfloat16, 2, kGrad>(in, coef, idx, out, B, N, C, K,
                                           stream);
  return launch<__nv_bfloat16, 1, kGrad>(in, coef, idx, out, B, N, C, K,
                                         stream);
}

}  // namespace

extern "C" int dc_coef_apply_grad(const void* x, const void* coef,
                                  const void* idx, void* out, int B, int N,
                                  int C, int K, int bf16, int device,
                                  void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  return dispatch<true>(x, coef, idx, out, B, N, C, K, bf16, stream);
}

extern "C" int dc_coef_apply_div(const void* v, const void* coef,
                                 const void* idx, void* out, int B, int N,
                                 int C, int K, int bf16, int device,
                                 void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  return dispatch<false>(v, coef, idx, out, B, N, C, K, bf16, stream);
}
