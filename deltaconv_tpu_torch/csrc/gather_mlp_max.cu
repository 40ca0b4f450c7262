// Fused neighbour gather + depth-L eval MLP per edge + masked max, with
// the self-slot merge and the BatchNorm + LeakyReLU epilogue (bf16 in,
// f32 accumulate), the scalar max branch of a depth >= 2 DeltaConv.
//
//   e[b, n, k]  = x[b, idx[b, n, k]]  (minus x[b, n] when centralized:
//                 the difference in f32, rounded to bf16)
//   h_{i+1}     = bf16(LeakyReLU(bf16(h_i @ W_i) * a_i + b_i))  i < L-1
//   z           = bf16(h_{L-1} @ W_{L-1})   (W_{L-1} sign-pre-folded)
//   best[b,n,o] = max over k >= k0 with mask[b, n, k] of z[b, n, k, o]
//   then max with z0 (a [C_out] f32 row, or [B, N, C_out] bf16 rows)
//   where mask[b, n, 0]; with the epilogue (sign, inv, mean, bias):
//   out = LeakyReLU((sign * best - mean) * inv + bias), 0 on rows with no
//   valid slot, stored bf16 (best is NOT rounded to bf16 first);
//   without it out = best in f32, -3e38 where no covered slot is valid.
//
// x [B, N, C_0] bf16, idx [B, N, K] i32, mask [B, N, K] bool (one byte),
// w: the L weights [C_i, C_{i+1}] bf16 one after another (row-major),
// aff: (a_i, b_i) f32 [C_{i+1}] each for the L-1 intermediate layers,
// one after another; every C_i a multiple of 16 (the wrapper zero-pads:
// a zero column adds nothing, a zero affine keeps a padded channel 0);
// x 16-byte, w 32-byte aligned. Every product and every affine operation
// is rounded on its own (no FMA contraction), as the plain version's.
//
// Replaces the Pallas kernel of deltaconv_tpu/ops/gather_mlp_max.py
// (`gather_mlp_max`, pallas_call at gather_mlp_max.py:237, body
// `_kernel`), which gathered the input rows with a one-hot MXU product
// and fitted its tiles to VMEM. Here a block loads each neighbour row
// directly.
//
// Bound on the H100: the tensor cores. At the segmentation config's last
// conv (B=16, N=2048, K=30, 128 -> 256 -> 256) the per-edge MLP is 187
// GFLOP, 0.19 ms at 989 TFLOP/s, against ~13 MB of inputs and outputs.
// Design: a block takes 16 points and walks their slots in passes of S
// (S x 16 rows, S chosen so that two blocks share an SM): it gathers the
// rows into shared memory (16-byte loads), then runs layer after layer
// on the tensor cores with WMMA (16x16x16, bf16 in, f32 accumulate) from
// one shared-memory buffer into the other, each warp over whole
// 16-column slices of the layer's output, its W fragments read from
// global memory (L1/L2) once for the S row tiles of the pass. A tile
// passes through the warp's f32 scratch, where the lanes round it, apply
// the affine and LeakyReLU and store the bf16 activations; the last
// layer's tiles update a running max of the 16 points in shared memory
// (a warp owns its columns, so no two warps touch one cell). The self
// slot and the epilogue run once per point at the end.
#include "common.cuh"

#include <cuda_bf16.h>
#include <mma.h>

#include <algorithm>

namespace {

constexpr float kNeg = -3.0e38f;
constexpr int kWarps = 8;
constexpr int kPoints = 16;  // points a block: the rows of one WMMA tile
constexpr int kMaxLayers = 8;
constexpr int kMaxSlots = 8;  // slots a pass at most
constexpr size_t kSmemTarget = 110 * 1024;  // two blocks an SM

struct MlpShape {
  int L;
  int c[kMaxLayers + 1];        // widths, multiples of 16
  long long w_off[kMaxLayers];  // offset of W_i in w, elements
  int a_off[kMaxLayers];        // offset of (a_i, b_i) in aff
  int ld[2];                    // row strides of the two buffers, bf16
  int slots;                    // S, slots a pass
};

// jnp.maximum: a NaN in either operand wins.
__device__ __forceinline__ float nan_max(float best, float v) {
  return (best != best || v <= best) ? best : v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float lrelu(float v) {
  return v >= 0.0f ? v : __fmul_rn(0.2f, v);
}

// 8 bf16 of a row minus 8 of the self row: f32 difference, rounded.
__device__ __forceinline__ uint4 sub_bf16x8(uint4 a, uint4 s) {
  const __nv_bfloat16* pa = reinterpret_cast<const __nv_bfloat16*>(&a);
  const __nv_bfloat16* ps = reinterpret_cast<const __nv_bfloat16*>(&s);
  uint4 r;
  __nv_bfloat16* pr = reinterpret_cast<__nv_bfloat16*>(&r);
#pragma unroll
  for (int v = 0; v < 8; ++v)
    pr[v] = __float2bfloat16_rn(
        __fsub_rn(__bfloat162float(pa[v]), __bfloat162float(ps[v])));
  return r;
}

// Shared memory: the two activation buffers ([S*16 rows] x ld bf16), a
// 16x16 f32 tile a warp, the running max [16, C_L] f32, slot and point
// validity. Every part starts 32-byte aligned (WMMA).
struct SmemLayout {
  size_t buf1, scratch, best, slot_ok, point_ok, total;
};

__host__ __device__ inline SmemLayout smem_layout(const MlpShape& sh,
                                                  int K) {
  SmemLayout s;
  const size_t rows = (size_t)sh.slots * kPoints;
  s.buf1 = rows * sh.ld[0] * 2;
  s.scratch = s.buf1 + rows * sh.ld[1] * 2;
  s.best = s.scratch + (size_t)kWarps * 256 * 4;
  s.slot_ok = s.best + (size_t)kPoints * sh.c[sh.L] * 4;
  s.point_ok = s.slot_ok + (size_t)K * kPoints;
  s.total = s.point_ok + kPoints;
  return s;
}

__global__ void __launch_bounds__(kWarps * 32) gather_mlp_max_kernel(
    const __nv_bfloat16* __restrict__ x, const int* __restrict__ idx,
    const uint8_t* __restrict__ mask, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ aff, const void* __restrict__ z0,
    const float* __restrict__ epi, void* __restrict__ out, MlpShape sh,
    int B, int N, int K, int centralized, int k0, int z0_mode) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const SmemLayout lay = smem_layout(sh, K);
  __nv_bfloat16* bufs[2] = {
      reinterpret_cast<__nv_bfloat16*>(smem),
      reinterpret_cast<__nv_bfloat16*>(smem + lay.buf1)};
  float* scratch = reinterpret_cast<float*>(smem + lay.scratch);
  float* best = reinterpret_cast<float*>(smem + lay.best);
  uint8_t* slot_ok = smem + lay.slot_ok;  // [K][16]
  uint8_t* point_ok = smem + lay.point_ok;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const long long total = (long long)B * N;
  const long long bn0 = (long long)blockIdx.x * kPoints;
  const int c_in = sh.c[0], c_out = sh.c[sh.L];

  for (int e = tid; e < kPoints * c_out; e += blockDim.x) best[e] = kNeg;
  for (int r = tid; r < K * kPoints; r += blockDim.x) {
    const long long bn = bn0 + r % kPoints;
    slot_ok[r] = bn < total && mask[bn * K + r / kPoints] != 0;
  }
  for (int p = tid; p < kPoints; p += blockDim.x) {
    const long long bn = bn0 + p;
    bool any = false;
    if (bn < total)
      for (int k = 0; k < K; ++k) any |= mask[bn * K + k] != 0;
    point_ok[p] = any;
  }
  __syncthreads();

  float* sc = scratch + warp * 256;
  const int per_row = c_in / 8;  // 16-byte vectors
  for (int ks0 = k0; ks0 < K; ks0 += sh.slots) {
    const int n_slots = min(sh.slots, K - ks0);
    // Gather: row r of the pass is slot ks0 + r / 16 of point r % 16.
    for (int t = tid; t < n_slots * kPoints * per_row; t += blockDim.x) {
      const int r = t / per_row, q = t % per_row;
      const long long bn = bn0 + r % kPoints;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (bn < total) {
        const int j = idx[bn * K + ks0 + r / kPoints];
        if ((unsigned)j < (unsigned)N)
          val = reinterpret_cast<const uint4*>(
              x + ((bn / N) * N + j) * c_in)[q];
        if (centralized)
          val = sub_bf16x8(val,
                           reinterpret_cast<const uint4*>(x + bn * c_in)[q]);
      }
      reinterpret_cast<uint4*>(bufs[0] + (long long)r * sh.ld[0])[q] = val;
    }
    __syncthreads();

    for (int l = 0; l < sh.L; ++l) {
      const __nv_bfloat16* in = bufs[l & 1];
      __nv_bfloat16* nxt = bufs[(l + 1) & 1];
      const int ldi = sh.ld[l & 1], ldo = sh.ld[(l + 1) & 1];
      const int ci = sh.c[l], co = sh.c[l + 1];
      const __nv_bfloat16* wl = w + sh.w_off[l];
      const float* al = aff + sh.a_off[l];
      const bool last = l == sh.L - 1;
      for (int nf = warp; nf < co / 16; nf += kWarps) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMaxSlots];
#pragma unroll
        for (int j = 0; j < kMaxSlots; ++j) wmma::fill_fragment(acc[j], 0.0f);
        for (int ks = 0; ks < ci / 16; ++ks) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> bf;
          wmma::load_matrix_sync(bf, wl + (long long)ks * 16 * co + nf * 16,
                                 co);
#pragma unroll
          for (int j = 0; j < kMaxSlots; ++j) {
            if (j >= n_slots) break;
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> a;
            wmma::load_matrix_sync(
                a, in + (long long)j * kPoints * ldi + ks * 16, ldi);
            wmma::mma_sync(acc[j], a, bf, acc[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < kMaxSlots; ++j) {
          if (j >= n_slots) break;
          wmma::store_matrix_sync(sc, acc[j], 16, wmma::mem_row_major);
          __syncwarp();
          // Lane `lane` owns cells e = lane + 32 i: point e / 16, column
          // e % 16 of the slice.
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int e = lane + 32 * i, p = e / 16, col = nf * 16 + e % 16;
            float v = round_bf16(sc[e]);
            if (!last) {
              v = lrelu(__fadd_rn(__fmul_rn(v, al[col]), al[co + col]));
              nxt[(long long)(j * kPoints + p) * ldo + col] =
                  __float2bfloat16_rn(v);
            } else if (slot_ok[(ks0 + j) * kPoints + p]) {
              best[p * co + col] = nan_max(best[p * co + col], v);
            }
          }
          __syncwarp();
        }
      }
      __syncthreads();
    }
  }

  // The self slot, then the epilogue, once per (point, channel).
  for (int e = tid; e < kPoints * c_out; e += blockDim.x) {
    const int p = e / c_out, o = e % c_out;
    const long long bn = bn0 + p;
    if (bn >= total) continue;
    float v = best[e];
    if (z0_mode != 0 && mask[bn * K] != 0) {
      const float z = z0_mode == 1
          ? static_cast<const float*>(z0)[o]
          : __bfloat162float(
                static_cast<const __nv_bfloat16*>(z0)[bn * c_out + o]);
      v = nan_max(v, z);
    }
    if (epi == nullptr) {
      static_cast<float*>(out)[bn * c_out + o] = v;
      continue;
    }
    const float sign = epi[o], inv = epi[c_out + o], mean = epi[2 * c_out + o],
                bias = epi[3 * c_out + o];
    float r = lrelu(__fadd_rn(
        __fmul_rn(__fsub_rn(__fmul_rn(sign, v), mean), inv), bias));
    static_cast<__nv_bfloat16*>(out)[bn * c_out + o] =
        __float2bfloat16_rn(point_ok[p] ? r : 0.0f);
  }
}

}  // namespace

// dims: host array of the L + 1 widths. z0_mode: 0 none, 1 a [C_L] f32
// row, 2 [B, N, C_L] bf16 rows. epi null: f32 output without epilogue.
extern "C" int dc_gather_mlp_max(const void* x, const void* idx,
                                 const void* mask, const void* w,
                                 const void* aff, const void* z0,
                                 const void* epi, void* out, const void* dims,
                                 int L, int B, int N, int K, int centralized,
                                 int k0, int z0_mode, int device,
                                 void* stream) {
  DC_SET_DEVICE(device);
  if (L < 1 || L > kMaxLayers || K <= 0 || k0 < 0 || k0 > K)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * N == 0) return (int)cudaGetLastError();
  MlpShape sh;
  sh.L = L;
  const int* d = static_cast<const int*>(dims);
  long long w_off = 0;
  int a_off = 0, widest[2] = {0, 0};
  for (int i = 0; i <= L; ++i) {
    if (d[i] <= 0 || d[i] % 16 != 0) return (int)cudaErrorInvalidValue;
    sh.c[i] = d[i];
  }
  for (int i = 0; i < L; ++i) {
    sh.w_off[i] = w_off;
    w_off += (long long)sh.c[i] * sh.c[i + 1];
    sh.a_off[i] = a_off;
    if (i < L - 1) a_off += 2 * sh.c[i + 1];
    // Layer i reads buffer i & 1.
    widest[i & 1] = std::max(widest[i & 1], sh.c[i]);
  }
  // 8 bf16 of padding keep the 16 rows of a WMMA load off one bank.
  sh.ld[0] = widest[0] + 8;
  sh.ld[1] = widest[1] + 8;
  sh.slots = 1;
  const size_t per_slot = (size_t)kPoints * (sh.ld[0] + sh.ld[1]) * 2;
  const size_t fixed = smem_layout(sh, K).total - per_slot;
  if (fixed + per_slot < kSmemTarget)
    sh.slots = (int)std::min((size_t)kMaxSlots,
                             (kSmemTarget - fixed) / per_slot);
  const size_t smem = smem_layout(sh, K).total;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_mlp_max_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = ((long long)B * N + kPoints - 1) / kPoints;
  gather_mlp_max_kernel<<<(unsigned)blocks, kWarps * 32, smem,
                          (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const int*)idx, (const uint8_t*)mask,
      (const __nv_bfloat16*)w, (const float*)aff, z0, (const float*)epi, out,
      sh, B, N, K, centralized, k0, z0_mode);
  return (int)cudaGetLastError();
}
