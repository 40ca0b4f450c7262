// Dense grad/div operators from the per-edge coefficients:
//   w_grad[b, d, n, idx[b, n, k]] += grad_coef[b, n, k, d]
//   w_div [b, d, n, idx[b, n, k]] += div_coef [b, n, k, d]
// idx [B, N, K] i32, grad_coef/div_coef [B, N, K, 2] f32 (or, with
// `planes` set, [B, 2, N, K]: the fused eval build's layout, JAX's
// `densify_coef_planes` entry)
//   -> w_grad, w_div [B, 2, N, N] f32 (`dc_densify`) or bf16
//   (`dc_densify_bf16`), zero where no edge lands; or the quantized
//   int8 planes (`dc_densify_int8`, below). `dc_densify_bwd` is the VJP
//   (below).
//
// Replaces the Pallas kernel of deltaconv_tpu/ops/densify_op.py
// (`densify_coef_planes`, pallas_call at densify_op.py:249) in both of
// its bodies: the f32 `_fwd_kernel` and the bf16 `_fwd_kernel_bf16`. The
// TPU built each row tile in VMEM by K masked select-accumulates over a
// [T, N] column iota; here a block owns one row (b, n) of all four
// planes, stages the row's K indices and coefficients in shared memory,
// and every thread writes its columns once: zero, plus the coefficients
// of the slots that land there. No other block writes the row, so no
// atomics are needed.
//
// Coefficients are ADDED in f32, in slot order, never stored: on the
// masked path the padded kNN slots are clamped to the point itself with
// a zero coefficient (geometry/knn.py), so a column can be hit twice and
// a store would overwrite slot 0's real self coefficient. The TPU kernel
// sums too.
//
// The bf16 body rounds the f32 sum once, to nearest even
// (__float2bfloat16_rn). The TPU's bf16 body rounds each coefficient and
// ORs the bits into place with -0.0 made +0.0; that is the same value,
// because the kNN gives every real slot its own column, a clamped slot
// adds +0.0 to it, and +0.0 + -0.0 is +0.0.
//
// Bound on the H100: the stores, 4 * N * N * 4 bytes per cloud in f32
// (512 MB at B=32, N=1024), half that in bf16, written as 16-byte
// (f32) or 8-byte (bf16) vectors where N % 4 == 0. The K compares per
// stored vector come from shared memory.
//
// `dc_densify_int8`: the int8 serving form. idx, grad_coef, div_coef as
// above (not planes) and amax [2, B]: the |coef| maxima of each cloud's
// grad and div coefficients as f32 bits (gather_max_int8.cu's
// `dc_absmax`, a launch each, on the coefficients viewed [B, N K, 2])
// -> w_grad, w_div [B, 2, N, N] int8 and s_grad, s_div [B] f32. The
// kernel forms s = max(a, 1e-30) (a NaN kept, as torch.clamp keeps it),
// quantizes each coefficient to clip(rint(coef / s * 127), -127, 127):
// the IEEE division (__fdiv_rn), then the product (__fmul_rn), rounded
// half to even (rintf), the order of torch's `round(coef / s * 127)` and
// of JAX's `_quantize_pack` (densify_op.py:143-162), and writes the
// scales s / 127 as PyTorch computes them on the card, fl(s * fl(1 /
// 127)) (a CUDA tensor divided by a CPU scalar is multiplied by its
// reciprocal). Replaces the Pallas kernel `densify_coefs_int8`
// (pallas_call at densify_op.py:180, body `_fwd_kernel_int8`), which
// packed the four planes' bytes into one int32 and ORed them into place
// because Mosaic could not select below 32 bits, with XLA's maxima and
// quantization before it.
// Design: the function writes 4 N^2 bytes a cloud and reads 20 K N
// (134 MB against 13 MB at B=32, N=1024, K=20), so it is its stores. A
// block takes a task: R consecutive rows (b, n0 .. n0 + R - 1) and W
// columns from c0 of the four planes (W = N and R W up to 8192 bytes,
// above that R = 1 and chunks of 8192 columns; ops/densify_op.py chooses
// R and W, `densify_int8_block`). The task's rows of one plane are one
// run of R W bytes of the output (rows n and n + 1 are adjacent when
// W = N), so the block builds each plane's run in shared memory: it
// zero-fills the four images, quantizes the task's R K slots (one a
// thread) into shared memory, then each slot whose column lies in the
// task's and that is the first of its row to land there ADDS the
// quantized values of its row's later slots of the same column (in
// int32, in slot order: a column hit twice sums, as the plain version's
// scatter_add_; a clamped padded slot adds 0) and stores the low bytes
// into the images; then it writes each image with 16-byte stores (the
// bytes before the run's first 16-byte boundary and after its last one
// stored one by one: any N), each output byte once, no memset pass.
// Adding equals the TPU's OR wherever at most one value of a column is
// nonzero, and it is the JAX CPU fallback's one-hot sum
// (geometry/dense.py:265-278) everywhere. Bound on the H100: memory, the
// stores, 4 N^2 bytes a cloud, and the coefficients and ids read once
// (0.0440 ms at B=32, N=1024, K=20); the whole call, `absmax` twice
// included, takes 0.0655 ms of device time there, the earlier kernel
// with the maxima in torch ops 0.1789 (PERF.md).
//
// `dc_densify_bwd`: the VJP of the f32 and bf16 bodies, idx [B, N, K]
// i32 and the cotangents dwg, dwd [B, 2, N, N] f32 -> d_grad, d_div
// [B, N, K, 2] f32 with d[b, n, k, c] = dW[b, c, n, idx[b, n, k]] (an
// index outside [0, N) reads 0). Replaces `_densify_bwd` (pallas_call at
// densify_op.py:281, body `_bwd_kernel`), which scanned all N columns of
// a row tile with a one-hot select per slot; here a thread owns an edge
// (b, n, k) and loads its four entries directly. The K edges of a row
// read one row of each plane, so a warp's loads fall in a few rows.
// Bound: the indices, the 4 entries an edge reads and the outputs.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ void store4(float* row, int q, const float* v) {
  reinterpret_cast<float4*>(row)[q] = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* row, int q,
                                       const float* v) {
  __nv_bfloat162 lo, hi;
  lo.x = __float2bfloat16_rn(v[0]);
  lo.y = __float2bfloat16_rn(v[1]);
  hi.x = __float2bfloat16_rn(v[2]);
  hi.y = __float2bfloat16_rn(v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  reinterpret_cast<uint2*>(row)[q] = u;
}

__device__ __forceinline__ void store1(float* row, int m, float v) {
  row[m] = v;
}

__device__ __forceinline__ void store1(__nv_bfloat16* row, int m, float v) {
  row[m] = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void densify_kernel(const int* __restrict__ idx,
                               const float* __restrict__ grad_coef,
                               const float* __restrict__ div_coef,
                               T* __restrict__ w_grad, T* __restrict__ w_div,
                               int N, int K, int planes) {
  extern __shared__ float smem[];
  int* s_idx = reinterpret_cast<int*>(smem);  // [K]
  float* s_coef = smem + K;                   // [4, K]: g1, g2, d1, d2

  const long long n = blockIdx.x;
  const long long b = blockIdx.y;
  const long long row = (b * N + n) * K;
  // Element (d, k) of the row's coefficients: [B, N, K, 2] or [B, 2, N, K].
  const long long base = planes ? (b * 2 * N + n) * K : row * 2;
  const long long sk = planes ? 1 : 2;
  const long long sd = planes ? (long long)N * K : 1;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    s_idx[k] = idx[row + k];
    s_coef[k] = grad_coef[base + k * sk];
    s_coef[K + k] = grad_coef[base + k * sk + sd];
    s_coef[2 * K + k] = div_coef[base + k * sk];
    s_coef[3 * K + k] = div_coef[base + k * sk + sd];
  }
  __syncthreads();

  const long long nn = (long long)N * N;
  T* rows[4] = {w_grad + (b * 2 + 0) * nn + n * N,
                w_grad + (b * 2 + 1) * nn + n * N,
                w_div + (b * 2 + 0) * nn + n * N,
                w_div + (b * 2 + 1) * nn + n * N};
  if ((N & 3) == 0) {
    for (int q = threadIdx.x; q < N / 4; q += blockDim.x) {
      float acc[4][4] = {};
      for (int k = 0; k < K; ++k) {
        const int j = s_idx[k] - 4 * q;
        if ((unsigned)j < 4u) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (j == c)
#pragma unroll
              for (int p = 0; p < 4; ++p) acc[p][c] += s_coef[p * K + k];
        }
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) store4(rows[p], q, acc[p]);
    }
  } else {
    for (int m = threadIdx.x; m < N; m += blockDim.x) {
      float acc[4] = {};
      for (int k = 0; k < K; ++k)
        if (s_idx[k] == m)
#pragma unroll
          for (int p = 0; p < 4; ++p) acc[p] += s_coef[p * K + k];
#pragma unroll
      for (int p = 0; p < 4; ++p) store1(rows[p], m, acc[p]);
    }
  }
}

template <typename T>
int launch_densify(const void* idx, const void* grad_coef,
                   const void* div_coef, void* w_grad, void* w_div, int B,
                   int N, int K, int planes, int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N == 0) return (int)cudaGetLastError();
  const dim3 grid(N, B);
  const size_t smem = (size_t)K * 5 * sizeof(float);
  densify_kernel<T><<<grid, 256, smem, (cudaStream_t)stream>>>(
      (const int*)idx, (const float*)grad_coef, (const float*)div_coef,
      (T*)w_grad, (T*)w_div, N, K, planes);
  return (int)cudaGetLastError();
}

__global__ void densify_bwd_kernel(const int* __restrict__ idx,
                                   const float* __restrict__ dwg,
                                   const float* __restrict__ dwd,
                                   float2* __restrict__ d_grad,
                                   float2* __restrict__ d_div, int N, int K,
                                   long long edges) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= edges) return;
  const long long bn = e / K;  // the row b * N + n
  const long long b = bn / N;
  const long long nn = (long long)N * N;
  const int j = idx[e];
  float2 g = make_float2(0.0f, 0.0f), d = g;
  if ((unsigned)j < (unsigned)N) {
    const long long at = b * 2 * nn + (bn - b * N) * N + j;
    g = make_float2(dwg[at], dwg[at + nn]);
    d = make_float2(dwd[at], dwd[at + nn]);
  }
  d_grad[e] = g;
  d_div[e] = d;
}

// clip(rint(p / s * 127), -127, 127), each operation rounded on its own.
__device__ __forceinline__ int quantize127(float p, float s) {
  const float v = rintf(__fmul_rn(__fdiv_rn(p, s), 127.0f));
  return (int)fminf(fmaxf(v, -127.0f), 127.0f);
}

constexpr int kDensifyThreads = 256;
constexpr size_t kDensifySmemMax = 232448;  // a block's shared memory, H100

// Shared memory of a densify_int8 block of R rows of W columns: four plane
// images of R W bytes, each with room for its 16-byte alignment shift,
// then R K slots (an id and the four quantized values packed in a word).
// ops/densify_op.py (`densify_int8_smem`) mirrors it.
inline size_t densify_int8_smem_bytes(int R, int W, int K) {
  return (size_t)4 * ((size_t)R * W / 16 + 2) * 16 + (size_t)R * K * 8;
}

// The four quantized values packed in one word, one byte each.
__device__ __forceinline__ int quant_byte(unsigned word, int p) {
  return (int)(signed char)((word >> (8 * p)) & 0xFFu);
}

// One block a task (cloud b, rows n0 .. n0 + R - 1, columns c0 .. c0 + W
// - 1); amax [2, B] f32 bits (grad, then div).
__global__ void __launch_bounds__(kDensifyThreads)
    densify_int8_kernel(const int* __restrict__ idx,
                        const float* __restrict__ grad_coef,
                        const float* __restrict__ div_coef,
                        const unsigned* __restrict__ amax,
                        float* __restrict__ s_grad,
                        float* __restrict__ s_div,
                        int8_t* __restrict__ w_grad,
                        int8_t* __restrict__ w_div, int B, int N, int K,
                        int R, int W) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  const int groups = (N + R - 1) / R, chunks = (N + W - 1) / W;
  const int b = blockIdx.x / (groups * chunks);
  const int task = blockIdx.x % (groups * chunks);
  const int n0 = task / chunks * R, c0 = task % chunks * W;
  const int rows = min(R, N - n0), cols = min(W, N - c0);
  const int len = rows * cols;  // bytes of a plane's run
  const int stride = (R * W / 16 + 2) * 16;
  int* s_idx = reinterpret_cast<int*>(dsmem + 4 * stride);
  unsigned* s_q = reinterpret_cast<unsigned*>(s_idx + R * K);
  const int tid = threadIdx.x;

  float s[2];  // the cloud's grad and div scales
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    const float a = __uint_as_float(amax[o * B + b]);
    s[o] = a != a ? a : fmaxf(a, 1e-30f);
  }
  if (task == 0 && tid == 0) {
    s_grad[b] = __fmul_rn(s[0], 1.0f / 127.0f);
    s_div[b] = __fmul_rn(s[1], 1.0f / 127.0f);
  }
  // Plane p's run in the output and its image: image byte i is run byte
  // i, at shared offset p * stride + shift, so that 16-byte boundaries of
  // the output fall on 16-byte boundaries of the image.
  const long long nn = (long long)N * N;
  int8_t* dst[4];
  int shift[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    dst[p] = (p < 2 ? w_grad : w_div) + (b * 2 + (p & 1)) * nn +
             (long long)n0 * N + c0;
    shift[p] = (int)(reinterpret_cast<uintptr_t>(dst[p]) & 15u);
  }

  for (int e = tid; e < stride / 4; e += blockDim.x)
    reinterpret_cast<uint4*>(dsmem)[e] = make_uint4(0u, 0u, 0u, 0u);
  // The rows' slots are contiguous in idx and the coefficients.
  const long long first = ((long long)b * N + n0) * K;
  for (int e = tid; e < rows * K; e += blockDim.x) {
    const long long at = first + e;
    s_idx[e] = idx[at];
    const int q[4] = {quantize127(grad_coef[2 * at], s[0]),
                      quantize127(grad_coef[2 * at + 1], s[0]),
                      quantize127(div_coef[2 * at], s[1]),
                      quantize127(div_coef[2 * at + 1], s[1])};
    unsigned word = 0u;
#pragma unroll
    for (int p = 0; p < 4; ++p) word |= ((unsigned)q[p] & 0xFFu) << (8 * p);
    s_q[e] = word;
  }
  __syncthreads();

  for (int e = tid; e < rows * K; e += blockDim.x) {
    const int r = e / K, k = e - r * K;
    const int j = s_idx[e];
    if ((unsigned)(j - c0) >= (unsigned)cols) continue;
    const int* ri = s_idx + r * K;
    bool lead = true;  // the first slot of the row at column j
    for (int kk = 0; kk < k; ++kk) lead &= ri[kk] != j;
    if (!lead) continue;
    int sum[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) sum[p] = quant_byte(s_q[e], p);
    for (int kk = k + 1; kk < K; ++kk) {
      if (ri[kk] != j) continue;
#pragma unroll
      for (int p = 0; p < 4; ++p) sum[p] += quant_byte(s_q[r * K + kk], p);
    }
    const int at = r * cols + j - c0;
#pragma unroll
    for (int p = 0; p < 4; ++p)
      dsmem[p * stride + shift[p] + at] = (unsigned char)(sum[p] & 0xFF);
  }
  __syncthreads();

#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const unsigned char* src = dsmem + p * stride + shift[p];
    const int head = min(len, (16 - shift[p]) & 15);
    const int body = (len - head) / 16;
    for (int e = tid; e < body; e += blockDim.x)
      *reinterpret_cast<uint4*>(dst[p] + head + 16 * e) =
          *reinterpret_cast<const uint4*>(src + head + 16 * e);
    if (tid < head) dst[p][tid] = (int8_t)src[tid];
    const int tail = head + 16 * body;
    if (tail + tid < len) dst[p][tail + tid] = (int8_t)src[tail + tid];
  }
}

}  // namespace

// R, W: the rows and columns of a task (`densify_int8_block` in
// ops/densify_op.py); a block that does not fit is refused.
extern "C" int dc_densify_int8(const void* idx, const void* grad_coef,
                               const void* div_coef, const void* amax,
                               void* s_grad, void* s_div, void* w_grad,
                               void* w_div, int B, int N, int K, int R,
                               int W, int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N == 0) return (int)cudaGetLastError();
  const size_t smem = densify_int8_smem_bytes(R, W, K);
  if (R < 1 || W < 1 || (R > 1 && W != N) || smem > kDensifySmemMax)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      densify_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      (long long)B * ((N + R - 1) / R) * ((N + W - 1) / W);
  densify_int8_kernel<<<(unsigned)blocks, kDensifyThreads, smem,
                        (cudaStream_t)stream>>>(
      (const int*)idx, (const float*)grad_coef, (const float*)div_coef,
      (const unsigned*)amax, (float*)s_grad, (float*)s_div,
      (int8_t*)w_grad, (int8_t*)w_div, B, N, K, R, W);
  return (int)cudaGetLastError();
}

extern "C" int dc_densify(const void* idx, const void* grad_coef,
                          const void* div_coef, void* w_grad, void* w_div,
                          int B, int N, int K, int planes, int device,
                          void* stream) {
  return launch_densify<float>(idx, grad_coef, div_coef, w_grad, w_div, B,
                               N, K, planes, device, stream);
}

extern "C" int dc_densify_bf16(const void* idx, const void* grad_coef,
                               const void* div_coef, void* w_grad,
                               void* w_div, int B, int N, int K, int planes,
                               int device, void* stream) {
  return launch_densify<__nv_bfloat16>(idx, grad_coef, div_coef, w_grad,
                                       w_div, B, N, K, planes, device,
                                       stream);
}

extern "C" int dc_densify_bwd(const void* idx, const void* dwg,
                              const void* dwd, void* d_grad, void* d_div,
                              int B, int N, int K, int device, void* stream) {
  DC_SET_DEVICE(device);
  const long long edges = (long long)B * N * K;
  if (edges == 0) return (int)cudaGetLastError();
  const int threads = 256;
  densify_bwd_kernel<<<(unsigned)((edges + threads - 1) / threads), threads,
                       0, (cudaStream_t)stream>>>(
      (const int*)idx, (const float*)dwg, (const float*)dwd,
      (float2*)d_grad, (float2*)d_div, N, K, edges);
  return (int)cudaGetLastError();
}
