// The scalar max branch of a depth >= 2 DeltaConv in bf16 serving: the
// eval MLP of every neighbour's row, its masked max, the self-slot merge
// and the BatchNorm + LeakyReLU epilogue (bf16 in, f32 accumulate).
//
//   h_{i+1} = bf16(LeakyReLU(bf16(h_i @ W_i) * a_i + b_i))    i < L-1
//   z       = bf16(h_{L-1} @ W_{L-1})         (W_{L-1} sign-pre-folded)
//   best[b, n, o] = max over k >= k0 with mask[b, n, k] of z(e_k)[o],
//     e_k = x[b, idx[b, n, k]], minus x[b, n] when centralized (the
//     difference in f32, rounded to bf16)
//   then max with z0 (a [C_L] f32 row, or [B, N, C_L] f32 rows rounded to
//   bf16) where mask[b, n, 0]; with the epilogue (sign, inv, mean, bias):
//   out = LeakyReLU((sign * best - mean) * inv + bias), 0 on rows with no
//   valid slot, stored bf16 (best is NOT rounded to bf16 first);
//   without it out = best in f32, -3e38 where no covered slot is valid.
//
// Three entry points:
// * `dc_mlp_rows`: z of every row of x ([R, C_0] -> [R, C_L] bf16).
// * `dc_gather_max_merge`: the masked max over k >= k0 of rows already
//   computed ([B, N, C] bf16), the self slot and the epilogue. When the
//   MLP is not centralized z(x[j]) does not depend on the point that
//   gathers row j, so the wrapper runs these two: the MLP once a point,
//   not once an edge (K - 1 times less work).
// * `dc_gather_mlp_max`: the centralized form, whose per-edge work is
//   genuine (e_k depends on both ends of the edge): MLP and max fused.
//
// x [.., C_0] bf16, idx [B, N, K] i32, mask [B, N, K] bool (one byte);
// w: the L weights one after another, each packed by the wrapper into the
// B fragments of mma.m16n8k16 ([C_i/16][C_{i+1}/16][32 lanes] x 16 bytes:
// lane (g, t) of column pair p and k-step s holds W[16s + 2t + {0, 1, 8,
// 9}][16p + g] and the same of column 16p + 8 + g), so that a warp reads
// a k-step of two n-tiles as one coalesced 16-byte load a lane; aff: (a_i,
// b_i) f32 [C_{i+1}] each for the L-1 intermediate layers; every C_i a
// multiple of 16 (the wrapper zero-pads: a zero column adds nothing, a
// zero affine keeps a padded channel 0). Every product and every affine
// operation is rounded on its own (no FMA contraction), as the plain
// version's.
//
// Replaces the Pallas kernel of deltaconv_tpu/ops/gather_mlp_max.py
// (`gather_mlp_max`, pallas_call at gather_mlp_max.py:237, body
// `_kernel`), which gathered the input rows with a one-hot MXU product
// and ran the MLP on every edge.
//
// Bound on the H100. Not centralized (the segmentation config's conv2,
// B=16, N=2048, K=30, 128 -> 256 -> 256): the function reads x (8.4 MB),
// idx and mask (4.9 MB) and the z0 rows (16.8 MB) and writes 16.8 MB, its
// MLP one a point is 6.4 GFLOP: its bytes, ~0.014 ms. Centralized (conv0,
// 3 -> 64 -> 64, padded to 16): 8.1 GFLOP over the edges, 0.0082 ms on
// the tensor cores.
//
// Design: mma.sync m16n8k16 (bf16, f32 accumulate) with the A tiles
// loaded by ldmatrix from shared memory and the accumulators in
// registers; wgmma would need its 64-row warpgroup tiles and shared-memory
// B descriptors, where these rows come from a gather. A warp owns its rows
// end to end (its own two activation buffers in shared memory, no block
// barrier): layer by layer over column chunks of 64, each k-step one
// ldmatrix.x4 per 16 rows and one 16-byte W load per 16 columns (the next
// k-step's loads issued before this one's products); an intermediate
// chunk's epilogue runs on the accumulator registers and writes bf16
// straight into the other buffer as the next layer's A.
// `mlp_rows`: a warp 32 rows, W from L2 (L1-cached). `gather_mlp_max`
// (centralized): persistent blocks with W in shared memory once per block
// (up to 64 KB of packed weights; wider MLPs read it through L1/L2); a
// warp walks groups of 16 points, each step two slots (an m-tile is one
// slot of its 16 points), so every thread keeps the running max of its
// two points in registers across the slots, on the unrounded products
// (rounding to bf16 is monotone: it is rounded once, at the end); idx and
// mask of a group are loaded once, coalesced. `gather_max_merge`: a group
// of lanes a point (C / 8 of them, a warp at C = 256), each lane 8
// channels with 16-byte loads; the point's idx and mask are loaded once,
// a slot to a lane, and broadcast by shuffles, eight rows in flight.
#include "common.cuh"

#include <cuda_bf16.h>

#include <algorithm>

namespace {

constexpr float kNeg = -3.0e38f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxLayers = 8;
constexpr int kMT = 2;              // m-tiles (16 rows) a warp carries
constexpr int kRows = kMT * 16;     // rows a warp carries
constexpr int kNP = 4;              // column pairs (16 columns) a chunk
constexpr int kWarps = 4;           // warps a block (at most)
constexpr int kPoints = 16;         // points a group (centralized kernel)
constexpr size_t kSmemMax = 232448;  // a block's shared memory on the H100
constexpr size_t kWSmemMax = 64 * 1024;  // W staged in shared memory up to
constexpr int kMergeThreads = 256;
constexpr int kBatch = 4;           // loads in flight a lane (tile fills)
constexpr int kInFlight = 8;        // neighbour rows in flight a lane (merge)

struct MlpShape {
  int L;
  int c[kMaxLayers + 1];        // widths, multiples of 16
  long long w_off[kMaxLayers];  // offset of packed W_i, in 16-byte vectors
  int a_off[kMaxLayers];        // offset of (a_i, b_i) in aff
  int ld[2];                    // row strides of the two buffers, bf16
};

// jnp.maximum: a NaN in either operand wins (one instruction).
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// LeakyReLU 0.2: v >= 0 ? v : 0.2 v, as the larger of the two (a NaN
// stays NaN).
__device__ __forceinline__ float lrelu(float v) {
  return fmaxf(v, __fmul_rn(0.2f, v));
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool kGlobal>
__device__ __forceinline__ uint4 load_w(const uint4* p) {
  if (kGlobal) return __ldg(p);
  return *p;
}

using Acc = float[kMT][2 * kNP][4];

// acc = rows [0, kRows) of `a` (shared, row stride lda) times columns
// [16 p0, 16 (p0 + np)) of the packed W (ksteps x npairs pairs). Lane
// (g, t) = (lane / 4, lane % 4) ends with acc[m][j] = rows 16m + g and
// 16m + g + 8, columns 16 p0 + 8j + 2t and + 1.
template <bool kGlobal>
__device__ __forceinline__ void mma_chunk(const __nv_bfloat16* a, int lda,
                                          const uint4* w, int ksteps,
                                          int npairs, int p0, int np,
                                          Acc& acc, int lane) {
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < 2 * kNP; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;
  const __nv_bfloat16* arow = a + (lane & 15) * lda + (lane >> 4) * 8;
  const uint4* wk = w + (long long)p0 * 32 + lane;
  const long long wstep = (long long)npairs * 32;
  // The next k-step's W fragments load while this one multiplies.
  uint4 b[kNP], bn[kNP];
#pragma unroll
  for (int j = 0; j < kNP; ++j)
    if (j < np) b[j] = load_w<kGlobal>(wk + j * 32);
  for (int ks = 0; ks < ksteps; ++ks) {
    if (ks + 1 < ksteps) {
#pragma unroll
      for (int j = 0; j < kNP; ++j)
        if (j < np) bn[j] = load_w<kGlobal>(wk + (ks + 1) * wstep + j * 32);
    }
    uint32_t af[kMT][4];
#pragma unroll
    for (int m = 0; m < kMT; ++m)
      ldmatrix_x4(af[m], arow + m * 16 * lda + ks * 16);
#pragma unroll
    for (int j = 0; j < kNP; ++j) {
      if (j < np) {
#pragma unroll
        for (int m = 0; m < kMT; ++m) {
          mma_bf16(acc[m][2 * j], af[m], b[j].x, b[j].y);
          mma_bf16(acc[m][2 * j + 1], af[m], b[j].z, b[j].w);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kNP; ++j) b[j] = bn[j];
  }
}

// An intermediate layer's epilogue on the accumulators: bf16(LeakyReLU(
// bf16(acc) * a + b)) into the next layer's A buffer.
__device__ __forceinline__ void hidden_store(const Acc& acc,
                                             __nv_bfloat16* nxt, int ldo,
                                             const float* a, const float* b,
                                             int p0, int np, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2 * kNP; ++j) {
    if (j / 2 >= np) continue;
    const int col = p0 * 16 + j * 8 + 2 * t;
    const float2 av = *reinterpret_cast<const float2*>(a + col);
    const float2 bv = *reinterpret_cast<const float2*>(b + col);
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = lrelu(__fadd_rn(
            __fmul_rn(round_bf16(acc[m][j][2 * h]), av.x), bv.x));
        const float v1 = lrelu(__fadd_rn(
            __fmul_rn(round_bf16(acc[m][j][2 * h + 1]), av.y), bv.y));
        *reinterpret_cast<__nv_bfloat162*>(
            nxt + (m * 16 + g + 8 * h) * ldo + col) =
            __floats2bfloat162_rn(v0, v1);
      }
  }
}

// Layers 0 .. L-2 of the warp's rows, bufs[0] holding the input; the last
// layer's input is left in bufs[(L - 1) & 1].
template <bool kGlobal>
__device__ __forceinline__ void hidden_layers(const MlpShape& sh,
                                              __nv_bfloat16* const (&bufs)[2],
                                              const uint4* w,
                                              const float* aff, Acc& acc,
                                              int lane) {
  for (int l = 0; l + 1 < sh.L; ++l) {
    const int npairs = sh.c[l + 1] / 16;
    const float* al = aff + sh.a_off[l];
    for (int p0 = 0; p0 < npairs; p0 += kNP) {
      const int np = min(kNP, npairs - p0);
      mma_chunk<kGlobal>(bufs[l & 1], sh.ld[l & 1], w + sh.w_off[l],
                         sh.c[l] / 16, npairs, p0, np, acc, lane);
      hidden_store(acc, bufs[(l + 1) & 1], sh.ld[(l + 1) & 1], al,
                   al + sh.c[l + 1], p0, np, lane);
    }
    __syncwarp();
  }
}

__host__ __device__ inline size_t rows_smem(const MlpShape& sh) {
  return (size_t)kRows * (sh.ld[0] + sh.ld[1]) * 2;
}

// mlp_rows: a warp takes kRows rows of x through the whole MLP.
__global__ void __launch_bounds__(kWarps * 32) mlp_rows_kernel(
    const __nv_bfloat16* __restrict__ x, const uint4* __restrict__ w,
    const float* __restrict__ aff, __nv_bfloat16* __restrict__ out,
    MlpShape sh, long long total) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* mine = smem + warp * rows_smem(sh);
  __nv_bfloat16* const bufs[2] = {
      reinterpret_cast<__nv_bfloat16*>(mine),
      reinterpret_cast<__nv_bfloat16*>(mine + (size_t)kRows * sh.ld[0] * 2)};
  const long long row0 =
      ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * kRows;
  if (row0 >= total) return;  // the whole warp: no block barrier below

  const int c0 = sh.c[0], per_row = c0 / 8;
  for (int e0 = lane; e0 < kRows * per_row; e0 += 32 * kBatch) {
    uint4 v[kBatch];  // kBatch loads in flight a lane
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + 32 * u, r = e / per_row, q = e - r * per_row;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (e < kRows * per_row && row0 + r < total)
        v[u] = __ldg(reinterpret_cast<const uint4*>(x + (row0 + r) * c0) + q);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + 32 * u, r = e / per_row, q = e - r * per_row;
      if (e < kRows * per_row)
        reinterpret_cast<uint4*>(bufs[0] + r * sh.ld[0])[q] = v[u];
    }
  }
  __syncwarp();

  Acc acc;
  hidden_layers<true>(sh, bufs, w, aff, acc, lane);
  const int L = sh.L, cl = sh.c[L], npairs = cl / 16;
  const int g = lane >> 2, t = lane & 3;
  for (int p0 = 0; p0 < npairs; p0 += kNP) {
    const int np = min(kNP, npairs - p0);
    mma_chunk<true>(bufs[(L - 1) & 1], sh.ld[(L - 1) & 1], w + sh.w_off[L - 1],
                    sh.c[L - 1] / 16, npairs, p0, np, acc, lane);
#pragma unroll
    for (int j = 0; j < 2 * kNP; ++j) {
      if (j / 2 >= np) continue;
      const int col = p0 * 16 + j * 8 + 2 * t;
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = row0 + m * 16 + g + 8 * h;
          if (row < total)
            *reinterpret_cast<__nv_bfloat162*>(out + row * cl + col) =
                __floats2bfloat162_rn(acc[m][j][2 * h], acc[m][j][2 * h + 1]);
        }
    }
  }
}

// Shared memory of a warp of the centralized kernel: the two activation
// buffers, the group's cloud offsets [16] (i64), idx [16, K] and mask
// [16, K].
__host__ __device__ inline size_t edge_smem(const MlpShape& sh, int K) {
  return (rows_smem(sh) + kPoints * 8 + (size_t)kPoints * K * 5 + 15) / 16 *
         16;
}

// The self slot and the epilogue of one (point, column pair).
__device__ __forceinline__ void finish(float v0, float v1, bool any,
                                       bool slot0, long long bn, int col,
                                       int cl, const void* z0, int z0_mode,
                                       const float* epi, void* out) {
  if (z0_mode != 0 && slot0) {
    float z[2];
    const float* zf = static_cast<const float*>(z0);
    if (z0_mode == 1) {
      z[0] = zf[col];
      z[1] = zf[col + 1];
    } else {
      const float2 zr =
          *reinterpret_cast<const float2*>(zf + bn * cl + col);
      z[0] = round_bf16(zr.x);
      z[1] = round_bf16(zr.y);
    }
    v0 = nan_max(v0, z[0]);
    v1 = nan_max(v1, z[1]);
  }
  if (epi == nullptr) {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + bn * cl + col) =
        make_float2(v0, v1);
    return;
  }
  float r[2] = {v0, v1};
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int o = col + u;
    const float sign = epi[o], inv = epi[cl + o], mean = epi[2 * cl + o],
                bias = epi[3 * cl + o];
    r[u] = any ? lrelu(__fadd_rn(
                     __fmul_rn(__fsub_rn(__fmul_rn(sign, r[u]), mean), inv),
                     bias))
               : 0.0f;
  }
  *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                     bn * cl + col) =
      __floats2bfloat162_rn(r[0], r[1]);
}

// The centralized form: MLP of every edge and max, fused.
template <bool kWSmem>
__global__ void __launch_bounds__(kWarps * 32, 3) gather_mlp_max_kernel(
    const __nv_bfloat16* __restrict__ x, const int* __restrict__ idx,
    const uint8_t* __restrict__ mask, const uint4* __restrict__ w_g,
    long long w_vecs, const float* __restrict__ aff,
    const void* __restrict__ z0, const float* __restrict__ epi,
    void* __restrict__ out, MlpShape sh, int B, int N, int K, int k0,
    int z0_mode) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint4* w = w_g;
  size_t off = 0;
  if (kWSmem) {
    uint4* ws = reinterpret_cast<uint4*>(smem);
    for (long long i = threadIdx.x; i < w_vecs; i += blockDim.x)
      ws[i] = __ldg(w_g + i);
    w = ws;
    off = (size_t)w_vecs * 16;
    __syncthreads();
  }
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* mine = smem + off + warp * edge_smem(sh, K);
  __nv_bfloat16* const bufs[2] = {
      reinterpret_cast<__nv_bfloat16*>(mine),
      reinterpret_cast<__nv_bfloat16*>(mine + (size_t)kRows * sh.ld[0] * 2)};
  long long* cloud_s = reinterpret_cast<long long*>(mine + rows_smem(sh));
  int* idx_s = reinterpret_cast<int*>(cloud_s + kPoints);
  uint8_t* mask_s = reinterpret_cast<uint8_t*>(idx_s + kPoints * K);

  const long long total = (long long)B * N;
  const long long groups = (total + kPoints - 1) / kPoints;
  const int L = sh.L, cl = sh.c[L], npairs = cl / 16;
  const int c0 = sh.c[0], per_row = c0 / 8;
  const uint4* wl = w + sh.w_off[L - 1];
  Acc acc;
  for (long long grp = (long long)blockIdx.x * warps + warp; grp < groups;
       grp += (long long)gridDim.x * warps) {
    const long long bn0 = grp * kPoints;
    const int pts = (int)min((long long)kPoints, total - bn0);
    __syncwarp();  // the previous group is done with idx_s and mask_s
    if (lane < kPoints)  // the first row of the point's cloud in x
      cloud_s[lane] = (bn0 + lane) / N * N * c0;
    for (int e0 = lane; e0 < kPoints * K; e0 += 32 * kBatch) {
      int iv[kBatch], mv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + 32 * u;
        const bool in = e < pts * K;
        iv[u] = in ? idx[bn0 * K + e] : 0;
        mv[u] = in ? mask[bn0 * K + e] : 0;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + 32 * u;
        if (e < kPoints * K) {
          idx_s[e] = iv[u];
          mask_s[e] = (uint8_t)mv[u];
        }
      }
    }
    __syncwarp();
    // The last layer's columns in rounds of kNP pairs (one round at
    // C_L <= 64); a later round recomputes the hidden layers.
    for (int p0 = 0; p0 < npairs; p0 += kNP) {
      const int np = min(kNP, npairs - p0);
      // The running max of the unrounded products: rounding to bf16 is
      // monotone, so it is rounded once at the end, then merged with -3e38
      // as the max over the rounded values would be.
      float best[2 * kNP][4];
#pragma unroll
      for (int j = 0; j < 2 * kNP; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) best[j][e] = -INFINITY;
      for (int s0 = k0; s0 < K; s0 += kMT) {
        // Row 16 m + p: slot s0 + m of point p, minus the point's row.
        for (int e0 = lane; e0 < kRows * per_row; e0 += 32 * kBatch) {
          uint4 v[kBatch], me[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int e = e0 + 32 * u, r = e / per_row, q = e - r * per_row;
            const int p = r & 15, s = s0 + (r >> 4);
            v[u] = me[u] = make_uint4(0u, 0u, 0u, 0u);
            if (e < kRows * per_row && p < pts && s < K) {
              const long long bn = bn0 + p;
              const int j = idx_s[p * K + s];
              if ((unsigned)j < (unsigned)N)
                v[u] = __ldg(reinterpret_cast<const uint4*>(
                                 x + cloud_s[p] + (long long)j * c0) + q);
              me[u] = __ldg(reinterpret_cast<const uint4*>(x + bn * c0) + q);
            }
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int e = e0 + 32 * u, r = e / per_row, q = e - r * per_row;
            if (e < kRows * per_row)
              reinterpret_cast<uint4*>(bufs[0] + r * sh.ld[0])[q] =
                  sub_bf16x8(v[u], me[u]);
          }
        }
        __syncwarp();
        hidden_layers<!kWSmem>(sh, bufs, w, aff, acc, lane);
        mma_chunk<!kWSmem>(bufs[(L - 1) & 1], sh.ld[(L - 1) & 1], wl,
                           sh.c[L - 1] / 16, npairs, p0, np, acc, lane);
#pragma unroll
        for (int m = 0; m < kMT; ++m) {
          const int s = s0 + m;
          const bool ok[2] = {s < K && mask_s[g * K + s] != 0,
                              s < K && mask_s[(g + 8) * K + s] != 0};
#pragma unroll
          for (int j = 0; j < 2 * kNP; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (ok[e >> 1]) best[j][e] = nan_max(best[j][e], acc[m][j][e]);
        }
        __syncwarp();  // the buffers are read before the next gather
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = g + 8 * h;
        if (p >= pts) continue;
        bool any = false;
        for (int k = 0; k < K; ++k) any |= mask_s[p * K + k] != 0;
#pragma unroll
        for (int j = 0; j < 2 * kNP; ++j) {
          if (j / 2 >= np) continue;
          finish(nan_max(kNeg, round_bf16(best[j][2 * h])),
                 nan_max(kNeg, round_bf16(best[j][2 * h + 1])), any,
                 mask_s[p * K] != 0,
                 bn0 + p, p0 * 16 + j * 8 + 2 * t, cl, z0, z0_mode, epi,
                 out);
        }
      }
    }
  }
}

// gather_max_merge: G lanes a point (a power of two), lane q of the group
// channels 8 (q + G i); the point's idx and mask a slot to a lane.
__global__ void __launch_bounds__(kMergeThreads) gather_max_merge_kernel(
    const __nv_bfloat16* __restrict__ rows, const int* __restrict__ idx,
    const uint8_t* __restrict__ mask, const void* __restrict__ z0,
    const float* __restrict__ epi, void* __restrict__ out, int B, int N,
    int C, int K, int k0, int z0_mode, int G) {
  const int lane = threadIdx.x & 31;
  const int q = lane & (G - 1), base = lane & ~(G - 1);
  const long long total = (long long)B * N;
  const long long bn = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const bool live = bn < total;
  const long long b = live ? bn / N : 0;
  const int nq = C / 8;
  const uint4* table = reinterpret_cast<const uint4*>(rows + b * N * C);
  for (int c0 = 0; c0 < nq; c0 += G) {  // the warp's groups in step
    const int cq = c0 + q;
    const bool has = live && cq < nq;
    float best[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) best[v] = kNeg;
    bool any = false;
    for (int kb = 0; kb < K; kb += G) {
      int my_j = -1, my_m = 0;
      if (live && kb + q < K) {
        my_j = idx[bn * K + kb + q];
        my_m = mask[bn * K + kb + q];
      }
      const int n = min(G, K - kb);
      for (int s0 = 0; s0 < n; s0 += kInFlight) {
        uint4 v[kInFlight];
        bool ok[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int s = s0 + u;
          const int src = base + (s < n ? s : 0);
          const int j = __shfl_sync(kFull, my_j, src);
          const int mk = __shfl_sync(kFull, my_m, src);
          any |= s < n && mk != 0;
          ok[u] = has && s < n && kb + s >= k0 && mk != 0 &&
                  (unsigned)j < (unsigned)N;
          v[u] = ok[u] ? __ldg(table + (long long)j * nq + cq)
                       : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          if (!ok[u]) continue;
          const __nv_bfloat16* pv =
              reinterpret_cast<const __nv_bfloat16*>(&v[u]);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            best[e] = nan_max(best[e], __bfloat162float(pv[e]));
        }
      }
    }
    if (!has) continue;
    const bool slot0 = mask[bn * K] != 0;
#pragma unroll
    for (int e = 0; e < 8; e += 2)
      finish(best[e], best[e + 1], any, slot0, bn, cq * 8 + e, C, z0,
             z0_mode, epi, out);
  }
}

// Reads the L + 1 widths and lays out the packed weights and affines.
int mlp_shape(const int* dims, int L, MlpShape& sh) {
  if (L < 1 || L > kMaxLayers) return (int)cudaErrorInvalidValue;
  sh.L = L;
  long long w_off = 0;
  int a_off = 0, widest[2] = {0, 0};
  for (int i = 0; i <= L; ++i) {
    if (dims[i] <= 0 || dims[i] % 16 != 0) return (int)cudaErrorInvalidValue;
    sh.c[i] = dims[i];
  }
  for (int i = 0; i < L; ++i) {
    sh.w_off[i] = w_off;
    w_off += (long long)sh.c[i] * sh.c[i + 1] / 8;
    sh.a_off[i] = a_off;
    if (i < L - 1) a_off += 2 * sh.c[i + 1];
    widest[i & 1] = std::max(widest[i & 1], sh.c[i]);  // layer i reads i & 1
  }
  // 8 bf16 of padding keep the 8 rows of an ldmatrix off one bank.
  sh.ld[0] = widest[0] + 8;
  sh.ld[1] = std::max(widest[1], 8) + 8;
  return 0;
}

long long packed_vecs(const MlpShape& sh) {
  return sh.w_off[sh.L - 1] + (long long)sh.c[sh.L - 1] * sh.c[sh.L] / 8;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <bool kWSmem>
int launch_edge(const void* x, const void* idx, const void* mask,
                const void* w, const void* aff, const void* z0,
                const void* epi, void* out, const MlpShape& sh, int B, int N,
                int K, int k0, int z0_mode, int warps, size_t smem,
                int device, cudaStream_t stream) {
  auto kernel = gather_mlp_max_kernel<kWSmem>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      warps * 32, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long groups = ((long long)B * N + kPoints - 1) / kPoints;
  const long long blocks = std::min((groups + warps - 1) / warps,
                                    (long long)std::max(per_sm, 1) * sms);
  kernel<<<(unsigned)blocks, warps * 32, smem, stream>>>(
      (const __nv_bfloat16*)x, (const int*)idx, (const uint8_t*)mask,
      (const uint4*)w, packed_vecs(sh), (const float*)aff, z0,
      (const float*)epi, out, sh, B, N, K, k0, z0_mode);
  return (int)cudaGetLastError();
}

}  // namespace

// dims: host array of the L + 1 widths; w packed (see above). x [R, C_0]
// -> out [R, C_L] bf16.
extern "C" int dc_mlp_rows(const void* x, const void* w, const void* aff,
                           void* out, const void* dims, int L, long long R,
                           int device, void* stream) {
  DC_SET_DEVICE(device);
  MlpShape sh;
  const int bad = mlp_shape(static_cast<const int*>(dims), L, sh);
  if (bad) return bad;
  if (R <= 0) return (int)cudaGetLastError();
  const size_t per_warp = rows_smem(sh);
  const int warps = (int)std::min((size_t)kWarps, kSmemMax / per_warp);
  if (warps == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = per_warp * warps;
  const cudaError_t err = allow_smem(mlp_rows_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (R + kRows - 1) / kRows;
  mlp_rows_kernel<<<(unsigned)((tiles + warps - 1) / warps), warps * 32,
                    smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const uint4*)w, (const float*)aff,
      (__nv_bfloat16*)out, sh, R);
  return (int)cudaGetLastError();
}

// rows [B, N, C] bf16 (C a multiple of 8). z0_mode: 0 none, 1 a [C] f32
// row, 2 [B, N, C] f32 rows (rounded to bf16 as they are read). epi null:
// f32 output without epilogue.
extern "C" int dc_gather_max_merge(const void* rows, const void* idx,
                                   const void* mask, const void* z0,
                                   const void* epi, void* out, int B, int N,
                                   int C, int K, int k0, int z0_mode,
                                   int device, void* stream) {
  DC_SET_DEVICE(device);
  if (C <= 0 || C % 8 != 0 || K <= 0 || k0 < 0 || k0 > K)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * N;
  if (total == 0) return (int)cudaGetLastError();
  int G = 1;
  while (G < 32 && G < C / 8) G *= 2;
  const long long blocks = (total * G + kMergeThreads - 1) / kMergeThreads;
  gather_max_merge_kernel<<<(unsigned)blocks, kMergeThreads, 0,
                            (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)rows, (const int*)idx, (const uint8_t*)mask, z0,
      (const float*)epi, out, B, N, C, K, k0, z0_mode, G);
  return (int)cudaGetLastError();
}

// The centralized form. dims: host array of the L + 1 widths; z0_mode and
// epi as dc_gather_max_merge's.
extern "C" int dc_gather_mlp_max(const void* x, const void* idx,
                                 const void* mask, const void* w,
                                 const void* aff, const void* z0,
                                 const void* epi, void* out, const void* dims,
                                 int L, int B, int N, int K, int k0,
                                 int z0_mode, int device, void* stream) {
  DC_SET_DEVICE(device);
  MlpShape sh;
  const int bad = mlp_shape(static_cast<const int*>(dims), L, sh);
  if (bad) return bad;
  if (K <= 0 || k0 < 0 || k0 > K) return (int)cudaErrorInvalidValue;
  if ((long long)B * N == 0) return (int)cudaGetLastError();
  const size_t per_warp = edge_smem(sh, K);
  const size_t w_bytes = (size_t)packed_vecs(sh) * 16;
  const bool w_smem =
      w_bytes <= kWSmemMax && w_bytes + per_warp <= kSmemMax;
  const size_t room = kSmemMax - (w_smem ? w_bytes : 0);
  const int warps = (int)std::min((size_t)kWarps, room / per_warp);
  if (warps == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = per_warp * warps + (w_smem ? w_bytes : 0);
  cudaStream_t s = (cudaStream_t)stream;
  return w_smem ? launch_edge<true>(x, idx, mask, w, aff, z0, epi, out, sh,
                                    B, N, K, k0, z0_mode, warps, smem,
                                    device, s)
                : launch_edge<false>(x, idx, mask, w, aff, z0, epi, out, sh,
                                     B, N, K, k0, z0_mode, warps, smem,
                                     device, s);
}
