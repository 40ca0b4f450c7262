// The masked gather-then-matmul max on the tensor cores (the K-fold
// form: a product a gathered slot), shared by the bf16 maxes' and
// gather_matmul_minmax's route above ~10k points (gather_max_bf16.cu) and
// the int8 serving kernel's (gather_max_int8.cu), with the helpers of the
// BatchNorm + LeakyReLU epilogue. The design and its bound are described in
// gather_max_bf16.cu; the input rows are bf16, or int8 widened to bf16
// as they are gathered (exact: |v| <= 127).
#pragma once

#include "common.cuh"

#include <cuda_bf16.h>
#include <mma.h>

namespace {

constexpr float kNeg = -3.0e38f;

// jnp.maximum: a NaN in either operand wins.
__device__ __forceinline__ float nan_max(float best, float v) {
  return (best != best || v <= best) ? best : v;
}

// jnp.minimum: a NaN in either operand wins.
__device__ __forceinline__ float nan_min(float worst, float v) {
  return (worst != worst || v >= worst) ? worst : v;
}

// `_bn_lrelu_epilogue` for one element of the affine (sign, inv, mean,
// bias), each operation rounded on its own.
__device__ __forceinline__ float bn_lrelu_of(float best, float self_val,
                                             bool sub_self, bool valid,
                                             float sign, float inv,
                                             float mean, float bias) {
  float mxb = __bfloat162float(__float2bfloat16_rn(best));
  float h;
  if (sub_self) {
    if (!valid) mxb = 0.0f;
    h = __fmul_rn(sign, __fsub_rn(mxb, self_val));
  } else {
    h = __fmul_rn(sign, mxb);
  }
  float o = __fadd_rn(__fmul_rn(__fsub_rn(h, mean), inv), bias);
  o = o >= 0.0f ? o : __fmul_rn(0.2f, o);
  return valid ? o : 0.0f;
}

// The same; `aff` holds the four [C] rows.
__device__ __forceinline__ float bn_lrelu(float best, float self_val,
                                          bool sub_self, bool valid,
                                          const float* aff, int C, int c) {
  return bn_lrelu_of(best, self_val, sub_self, valid, aff[c], aff[C + c],
                     aff[2 * C + c], aff[3 * C + c]);
}

// Eight consecutive values of a row (vector q), as eight bf16 in one
// 16-byte vector: bf16 rows are read as they are, int8 rows as 8 bytes,
// each value widened to bf16 (exact for |v| <= 127).
__device__ __forceinline__ uint4 load8_bf16(const __nv_bfloat16* row,
                                            int q) {
  return reinterpret_cast<const uint4*>(row)[q];
}

__device__ __forceinline__ float signed_byte(unsigned word, int i) {
  return (float)(signed char)((word >> (8 * i)) & 0xFFu);
}

__device__ __forceinline__ uint4 load8_bf16(const int8_t* row, int q) {
  const uint2 raw = reinterpret_cast<const uint2*>(row)[q];
  const unsigned words[2] = {raw.x, raw.y};
  unsigned out[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 pair =
        __floats2bfloat162_rn(signed_byte(words[i / 2], 2 * (i % 2)),
                              signed_byte(words[i / 2], 2 * (i % 2) + 1));
    out[i] = *reinterpret_cast<const unsigned*>(&pair);
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

constexpr int kMmWarps = 8;
constexpr int kMmPoints = 16;  // points a block: the rows of one WMMA tile
constexpr int kMmSlotsPerPass = 4;  // tiles that share each W fragment

// Row stride of the gathered rows in shared memory, in bf16: 16 bytes of
// padding keep the 16 rows of a WMMA load off one bank.
inline __host__ __device__ int mm_lda(int Cin) { return Cin + 8; }

// Shared memory of a block: the gathered rows, slot-major ([K][16 points]
// x C_in bf16, padded), a 16x16 f32 tile a warp, slot and point validity.
inline size_t mm_smem_bytes(int K, int Cin) {
  return (size_t)K * kMmPoints * mm_lda(Cin) * 2 +
         (size_t)kMmWarps * 256 * 4 + (size_t)K * kMmPoints + kMmPoints;
}

// C_in and C_out are multiples of 16; x 16-byte (bf16) or 8-byte (int8)
// and w 32-byte aligned.
// kWinners: the train-mode form (bf16-rounded products, winner slots, no
// epilogue: `aff` is null).
// kMinMax: also the running min of each lane's cells, into `out_min`
// (`gather_matmul_minmax_kfold`: no winners, no epilogue).
template <bool kWinners, typename Tin, bool kMinMax = false>
__global__ void __launch_bounds__(kMmWarps * 32) gather_matmul_max_kernel(
    const Tin* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const int* __restrict__ idx, const uint8_t* __restrict__ mask,
    const float* __restrict__ aff, __nv_bfloat16* __restrict__ out,
    int* __restrict__ winner, int B, int N, int Cin, int Cout, int K,
    __nv_bfloat16* __restrict__ out_min) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const int rows = K * kMmPoints;  // row r = k * 16 + p
  const int lda = mm_lda(Cin);
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);
  float* scratch = reinterpret_cast<float*>(smem + (size_t)rows * lda * 2);
  uint8_t* slot_ok = reinterpret_cast<uint8_t*>(scratch + kMmWarps * 256);
  uint8_t* point_ok = slot_ok + rows;

  const long long total = (long long)B * N;
  const long long bn0 = (long long)blockIdx.x * kMmPoints;
  const int per_row = Cin / 8;  // 8 values: 16 bytes of bf16 in smem
  for (int t = threadIdx.x; t < rows * per_row; t += blockDim.x) {
    const int r = t / per_row, q = t % per_row;
    const int k = r / kMmPoints;
    const long long bn = bn0 + r % kMmPoints;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (bn < total) {
      const int j = idx[bn * K + k];
      if ((unsigned)j < (unsigned)N)
        val = load8_bf16(x + ((bn / N) * N + j) * Cin, q);
    }
    reinterpret_cast<uint4*>(sa + (long long)r * lda)[q] = val;
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const long long bn = bn0 + r % kMmPoints;
    slot_ok[r] = bn < total && mask[bn * K + r / kMmPoints] != 0;
  }
  for (int p = threadIdx.x; p < kMmPoints; p += blockDim.x) {
    const long long bn = bn0 + p;
    bool any = false;
    if (bn < total)
      for (int k = 0; k < K; ++k) any |= mask[bn * K + k] != 0;
    point_ok[p] = any;
  }
  __syncthreads();

  // Lane `l` owns cells e = l + 32 i (i < 8) of every 16x16 tile: point
  // e / 16, column e % 16. Tile k holds slot k of the 16 points, so the
  // max over the slots is a running max in the lane's registers. A pass
  // runs kMmSlotsPerPass tiles, which share each W fragment and keep that
  // many independent products in flight.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sc = scratch + warp * 256;
  for (int nf = warp; nf < Cout / 16; nf += kMmWarps) {
    float best[8], worst[8];
    int win[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      best[i] = kNeg;
      worst[i] = -kNeg;
      win[i] = 0;
    }
    for (int k0 = 0; k0 < K; k0 += kMmSlotsPerPass) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float>
          acc[kMmSlotsPerPass];
#pragma unroll
      for (int j = 0; j < kMmSlotsPerPass; ++j)
        wmma::fill_fragment(acc[j], 0.0f);
      for (int ks = 0; ks < Cin / 16; ++ks) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf;
        wmma::load_matrix_sync(bf, w + (long long)ks * 16 * Cout + nf * 16,
                               Cout);
#pragma unroll
        for (int j = 0; j < kMmSlotsPerPass; ++j) {
          if (k0 + j >= K) break;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> a;
          wmma::load_matrix_sync(
              a, sa + (long long)(k0 + j) * kMmPoints * lda + ks * 16, lda);
          wmma::mma_sync(acc[j], a, bf, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kMmSlotsPerPass; ++j) {
        const int k = k0 + j;
        if (k >= K) break;
        wmma::store_matrix_sync(sc, acc[j], 16, wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int e = lane + 32 * i;
          if (!slot_ok[k * kMmPoints + e / 16]) continue;
          if (!kWinners) {
            best[i] = nan_max(best[i], sc[e]);
            if (kMinMax) worst[i] = nan_min(worst[i], sc[e]);
            continue;
          }
          const float v = __bfloat162float(__float2bfloat16_rn(sc[e]));
          if (v != v) {  // NaN: propagates, winner 0, sticks
            if (best[i] == best[i]) {
              best[i] = v;
              win[i] = 0;
            }
          } else if (v > best[i]) {
            best[i] = v;
            win[i] = k;
          }
        }
        __syncwarp();
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = lane + 32 * i, p = e / 16, o = nf * 16 + e % 16;
      const long long bn = bn0 + p;
      if (bn >= total) continue;
      const float v = aff ? bn_lrelu(best[i], 0.0f, false, point_ok[p] != 0,
                                     aff, Cout, o)
                          : best[i];
      out[bn * Cout + o] = __float2bfloat16_rn(v);
      if (kMinMax) out_min[bn * Cout + o] = __float2bfloat16_rn(worst[i]);
      if (kWinners) winner[bn * Cout + o] = win[i];
    }
  }
}

// Shared memory of the matmul maxes: above the default 48 KB a kernel
// must opt in (up to 227 KB; beyond that the launch is refused and
// reported).
template <bool kWinners, typename Tin, bool kMinMax = false>
int launch_matmul_max(const void* x, const void* w, const void* idx,
                      const void* mask, const void* aff, void* out,
                      void* winner, int B, int N, int Cin, int Cout, int K,
                      void* stream, void* out_min = nullptr) {
  if ((long long)B * N * Cout == 0) return (int)cudaGetLastError();
  if (Cin % 16 != 0 || Cout % 16 != 0 || Cin == 0 || K <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = mm_smem_bytes(K, Cin);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_matmul_max_kernel<kWinners, Tin, kMinMax>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = ((long long)B * N + kMmPoints - 1) / kMmPoints;
  gather_matmul_max_kernel<kWinners, Tin, kMinMax>
      <<<(unsigned)blocks, kMmWarps * 32, smem, (cudaStream_t)stream>>>(
      (const Tin*)x, (const __nv_bfloat16*)w, (const int*)idx,
      (const uint8_t*)mask, (const float*)aff, (__nv_bfloat16*)out,
      (int*)winner, B, N, Cin, Cout, K, (__nv_bfloat16*)out_min);
  return (int)cudaGetLastError();
}

}  // namespace
