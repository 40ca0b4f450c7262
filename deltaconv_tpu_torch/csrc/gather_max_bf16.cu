// The bf16 neighbour maxes of the DeltaConv scalar branch: the eval ones
// with the BatchNorm + LeakyReLU epilogue in the kernel, and the
// train-mode gather-then-matmul max with winner slots.
//
// `gather_max_affine`:
//   best[b, n, c] = max over k with mask[b, n, k] of h[b, idx[b, n, k], c]
//   h [B, N, C] bf16, idx [B, N, K] i32, mask [B, N, K] bool (one byte),
//   aff [4, C] f32 = (sign, inv, mean, bias) -> out [B, N, C] bf16.
// Replaces the Pallas kernel of deltaconv_tpu/ops/gather_max.py
// (`gather_max_affine`, pallas_call at gather_max.py:666, body
// `_max_affine_kernel`), which gathered through a one-hot MXU product.
//
// `gather_matmul_max`:
//   best[b, n, o] = max over valid k of sum_c x[b, idx[b, n, k], c] w[c, o]
//   x [B, N, C_in] bf16, w [C_in, C_out] bf16 (sign already folded in),
//   aff [4, C_out] f32 or null -> out [B, N, C_out] bf16; the products are
//   accumulated in f32.
// Replaces `gather_matmul_max` (pallas_call at gather_max.py:756, body
// `_mm_max_kernel`).
//
// `gather_matmul_max_win` (the train-mode twin):
//   y[b, n, k, o] = bf16(sum_c x[b, idx[b, n, k], c] w[c, o])
//   out[b, n, o] = max over valid k of y, winner[b, n, o] = the first such
//   k that holds it (strict >, slots in ascending order)
//   x [B, N, C_in] bf16, w [C_in, C_out] bf16 -> out [B, N, C_out] bf16,
//   winner [B, N, C_out] i32; -3e38 and winner 0 on a row with no valid
//   slot; no epilogue. Each slot's f32 product is rounded to bf16 BEFORE it
//   enters the max (gather_max.py:827-837), so values and winners are
//   those of the per-point bf16 product followed by the neighbour max.
// Replaces `_mm_train_pallas_fwd` (pallas_call at gather_max.py:865, body
// `_mm_max_win_kernel`); its backward is the winner-routed scatter of
// gather_max.cu at C_out.
//
// Both eval kernels end in `_bn_lrelu_epilogue` (gather_max.py:584),
// replayed op for op in f32 with every operation rounded on its own (no
// FMA contraction):
// the max rounded to bf16; with `sub_self`, rows with no valid slot set
// to 0 and then sign * (max - h[idx[., 0]]), else sign * max; then
// (h* - mean) * inv + bias, LeakyReLU 0.2, and 0 on rows with no valid
// slot; stored rounded to bf16. Without `aff`, `gather_matmul_max` stores
// the max rounded to bf16 (-3e38 where no slot is valid). The self row is
// read through idx[., 0], which the kNN sets to the point itself; the TPU
// kernel read the point's own row.
//
// `gather_max_affine` design: one thread per (point, channel pair) with
// bf16x2 loads, a block row (threadIdx.y) per point, as gather_max.cu.
// Bound on the H100: memory, the K gathered rows coming from L2 (one
// cloud's table is N * C * 2 bytes, 256 KB at C=128).
//
// `gather_matmul_max` design: a block takes 16 points, gathers their K
// input rows into shared memory slot by slot (16-byte loads; 85 KB at
// K=20, C_in=128, rows padded by 16 bytes against bank conflicts), and
// its 8 warps run the product on the tensor cores with WMMA (16x16x16,
// bf16 in, f32 accumulate), each warp over whole 16-column slices of the
// output; W is read straight from global memory (L1/L2: 64 KB at
// 128 x 256), each fragment once for 4 slots. Tile k holds slot k of the
// 16 points, so after it passes through the warp's shared scratch each
// lane keeps a running max of its 8 cells in registers. Bound on the
// H100: the tensor cores, 2 B N K C_in C_out operations (42.9 GFLOP at
// B=32, N=1024, K=20, 128 -> 256), K times the work of x @ w followed by
// a gather. `gather_matmul_max_win` is the same kernel with the per-slot
// bf16 rounding and a winner slot beside each lane's running max; the
// function it computes is bound by its bytes (x, idx/mask, and the bf16
// out plus the i32 winners: ~62 MB, ~0.019 ms at 128 -> 256), which this
// design, paying the K-fold product, does not approach.
#include "common.cuh"

#include <cuda_bf16.h>
#include <mma.h>

namespace {

constexpr float kNeg = -3.0e38f;

// jnp.maximum: a NaN in either operand wins.
__device__ __forceinline__ float nan_max(float best, float v) {
  return (best != best || v <= best) ? best : v;
}

// `_bn_lrelu_epilogue` for one element; `aff` holds the four [C] rows.
__device__ __forceinline__ float bn_lrelu(float best, float self_val,
                                          bool sub_self, bool valid,
                                          const float* aff, int C, int c) {
  const float sign = aff[c], inv = aff[C + c], mean = aff[2 * C + c],
              bias = aff[3 * C + c];
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

// V consecutive channels of row j of a bf16 table, 0 outside [0, N).
template <int V>
__device__ __forceinline__ void load_row(const __nv_bfloat16* hb, int j,
                                         int N, int C, int c, float* val) {
  if ((unsigned)j >= (unsigned)N) {
#pragma unroll
    for (int v = 0; v < V; ++v) val[v] = 0.0f;
    return;
  }
  const __nv_bfloat16* p = hb + (long long)j * C + c;
  if (V == 2) {
    const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(p);
    val[0] = __bfloat162float(pair.x);
    val[V - 1] = __bfloat162float(pair.y);
  } else {
    val[0] = __bfloat162float(p[0]);
  }
}

// V = 2 when C is even (4-byte loads and stores), else 1.
template <int V>
__global__ void gather_max_affine_kernel(
    const __nv_bfloat16* __restrict__ h, const int* __restrict__ idx,
    const uint8_t* __restrict__ mask, const float* __restrict__ aff,
    __nv_bfloat16* __restrict__ out, int B, int N, int C, int K,
    int sub_self) {
  const long long bn = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (bn >= (long long)B * N) return;
  const long long b = bn / N;
  const int* ir = idx + bn * K;
  const uint8_t* mr = mask + bn * K;
  const __nv_bfloat16* hb = h + b * N * C;
  bool valid = false;
  for (int k = 0; k < K; ++k) valid |= mr[k] != 0;
  for (int c = threadIdx.x * V; c < C; c += blockDim.x * V) {
    float best[V], self_val[V], val[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      best[v] = kNeg;
      self_val[v] = 0.0f;
    }
    for (int k = 0; k < K; ++k) {
      if (!mr[k]) continue;
      load_row<V>(hb, ir[k], N, C, c, val);
#pragma unroll
      for (int v = 0; v < V; ++v) best[v] = nan_max(best[v], val[v]);
    }
    if (sub_self) load_row<V>(hb, ir[0], N, C, c, self_val);
    __nv_bfloat16 o[V];
#pragma unroll
    for (int v = 0; v < V; ++v)
      o[v] = __float2bfloat16_rn(
          bn_lrelu(best[v], self_val[v], sub_self, valid, aff, C, c + v));
    if (V == 2) {
      __nv_bfloat162 pair;
      pair.x = o[0];
      pair.y = o[V - 1];
      *reinterpret_cast<__nv_bfloat162*>(out + bn * C + c) = pair;
    } else {
      out[bn * C + c] = o[0];
    }
  }
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

// C_in and C_out are multiples of 16; x 16-byte and w 32-byte aligned.
// kWinners: the train-mode form (bf16-rounded products, winner slots, no
// epilogue: `aff` is null).
template <bool kWinners>
__global__ void __launch_bounds__(kMmWarps * 32) gather_matmul_max_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const int* __restrict__ idx, const uint8_t* __restrict__ mask,
    const float* __restrict__ aff, __nv_bfloat16* __restrict__ out,
    int* __restrict__ winner, int B, int N, int Cin, int Cout, int K) {
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
  const int per_row = Cin / 8;  // 16-byte vectors
  for (int t = threadIdx.x; t < rows * per_row; t += blockDim.x) {
    const int r = t / per_row, q = t % per_row;
    const int k = r / kMmPoints;
    const long long bn = bn0 + r % kMmPoints;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (bn < total) {
      const int j = idx[bn * K + k];
      if ((unsigned)j < (unsigned)N)
        val = reinterpret_cast<const uint4*>(x + ((bn / N) * N + j) * Cin)[q];
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
    float best[8];
    int win[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      best[i] = kNeg;
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
      if (kWinners) winner[bn * Cout + o] = win[i];
    }
  }
}

// Shared memory of the matmul maxes: above the default 48 KB a kernel
// must opt in (up to 227 KB; beyond that the launch is refused and
// reported).
template <bool kWinners>
int launch_matmul_max(const void* x, const void* w, const void* idx,
                      const void* mask, const void* aff, void* out,
                      void* winner, int B, int N, int Cin, int Cout, int K,
                      void* stream) {
  if ((long long)B * N * Cout == 0) return (int)cudaGetLastError();
  if (Cin % 16 != 0 || Cout % 16 != 0 || Cin == 0 || K <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = mm_smem_bytes(K, Cin);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_matmul_max_kernel<kWinners>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = ((long long)B * N + kMmPoints - 1) / kMmPoints;
  gather_matmul_max_kernel<kWinners><<<(unsigned)blocks, kMmWarps * 32, smem,
                                       (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const int*)idx,
      (const uint8_t*)mask, (const float*)aff, (__nv_bfloat16*)out,
      (int*)winner, B, N, Cin, Cout, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dc_gather_max_affine(const void* h, const void* idx,
                                    const void* mask, const void* aff,
                                    void* out, int B, int N, int C, int K,
                                    int sub_self, int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int V = (C % 2 == 0) ? 2 : 1;
  const dim3 block = dc_row_block((C + V - 1) / V);
  const dim3 grid = dc_row_grid(B, N, block);
  if (V == 2)
    gather_max_affine_kernel<2><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)h, (const int*)idx, (const uint8_t*)mask,
        (const float*)aff, (__nv_bfloat16*)out, B, N, C, K, sub_self);
  else
    gather_max_affine_kernel<1><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)h, (const int*)idx, (const uint8_t*)mask,
        (const float*)aff, (__nv_bfloat16*)out, B, N, C, K, sub_self);
  return (int)cudaGetLastError();
}

extern "C" int dc_gather_matmul_max(const void* x, const void* w,
                                    const void* idx, const void* mask,
                                    const void* aff, void* out, int B, int N,
                                    int Cin, int Cout, int K, int device,
                                    void* stream) {
  DC_SET_DEVICE(device);
  return launch_matmul_max<false>(x, w, idx, mask, aff, out, nullptr, B, N,
                                  Cin, Cout, K, stream);
}

extern "C" int dc_gather_matmul_max_win(const void* x, const void* w,
                                        const void* idx, const void* mask,
                                        void* out, void* winner, int B, int N,
                                        int Cin, int Cout, int K, int device,
                                        void* stream) {
  DC_SET_DEVICE(device);
  return launch_matmul_max<true>(x, w, idx, mask, nullptr, out, winner, B, N,
                                 Cin, Cout, K, stream);
}
