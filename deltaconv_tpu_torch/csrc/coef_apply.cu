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
// swapped outside. Here the rows are loaded directly, so the gather is
// exact, and the grad is written [B, N, 2, C] at once.
//
// Rounding, as the TPU kernel's: the products and sums are f32, each
// rounded on its own (__fmul_rn, __fadd_rn: no FMA contraction), slot
// k = 0..K-1 in turn; div adds component 0's product, then component
// 1's; the f32 accumulators are cast once, at the end, to the features'
// dtype. The plain versions loop in the same order, so every route is
// bit-equal to them. Masked edges carry zero coefficients, so no mask is
// read; an index outside [0, N) gathers 0, as a one-hot row with no match
// does on the TPU.
//
// Bound on the H100: memory. The function reads each input once; the
// gathers read K rows a point, 2 GB of rows for one bf16 forward's eight
// applies at B=4, N=8192, K=20 against 0.27 GB of inputs and outputs, so
// what bounds a kernel is how many of those row bytes come from L2 and
// how many loads it keeps in flight. Two routes:
//
// Route A, `coef_apply_grad` / `coef_apply_div` (any shape, no plan): a
// group of G lanes owns a point (G = 32 for rows of 32 vectors or more,
// else the next power of two, at least 4, so narrow rows share a warp
// among 32 / G points). A lane reads VB bytes of a row at a time, the
// widest of 16, 8, 4 (2 for bf16) that the row's byte width and both
// base pointers allow: a bf16 row of C=256 is one warp load. A lane
// of a row wider than G vectors reads two vectors a slot (in passes
// beyond 2G vectors). A warp stages its points' indices and
// coefficients in shared memory once (32 slots at a time, coalesced),
// then issues the row loads of kAhead slots (kAhead / 2 with two
// vectors) before it sums the first of them, in slot order. Blocks
// cover consecutive points, so the grid is batch-major: about one
// cloud's table is live in L2 at a time.
//
// Route B, `coef_apply_grad_plan` / `coef_apply_div_plan` (rows of a
// multiple of 16 bytes and at least 256, with the forward's gather
// plan): the points of a cloud sorted by a Morton code of their
// positions (`coef_plan_order`: each 1024-point chunk sorted by a block,
// then each point ranked against the other chunks) are cut into runs of
// R consecutive points, and each run lists its distinct neighbour rows
// once (`coef_plan_runs`: run_rows, run_count, and each edge's place in
// that list, local_slot). A block takes a run, copies its distinct rows
// into shared memory with cp.async (16 bytes a thread, a chunk of
// channels at a time where the rows exceed the budget), then forms each
// point's sums out of shared memory, in slot order, and writes them at
// the point's own index. A run of 32 surface points with K=20 reads ~110
// distinct rows where route A reads 640, so L2 serves a sixth of the
// bytes; the plan is built once a forward and serves its eight applies.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kWarps = 8;           // warps a block, route A
constexpr int kSlotChunk = 32;      // slots staged at a time, route A
constexpr int kMaxGroupPoints = 8;  // points a warp (G >= 4)
constexpr int kAhead = 8;           // slots whose loads precede the sums
constexpr int kRunThreads = 256;    // threads a block, route B

// VB bytes (one vector) as 32-bit words; VB = 2 keeps its 16 bits in the
// low half of one word.
template <int VB>
constexpr int kWords = VB >= 4 ? VB / 4 : 1;

template <int VB>
__device__ __forceinline__ void load_words(const void* p, unsigned* w) {
  if constexpr (VB == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else if constexpr (VB == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = u.x; w[1] = u.y;
  } else if constexpr (VB == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
}

// The V = VB / sizeof(T) values of a vector in f32 (bf16 widens exactly:
// its bits are the top half of the f32's; element 2i is the low half).
template <typename T, int VB>
__device__ __forceinline__ void unpack(const unsigned* w, float* v) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < kWords<VB>; ++i) v[i] = __uint_as_float(w[i]);
  } else if constexpr (VB == 2) {
    v[0] = __uint_as_float(w[0] << 16);
  } else {
#pragma unroll
    for (int i = 0; i < kWords<VB>; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// The f32 sums cast to T (round to nearest even) and stored as one vector.
template <typename T, int VB>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  if constexpr (VB == 2) {
    *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16_rn(v[0]);
  } else {
    unsigned w[kWords<VB>];
#pragma unroll
    for (int i = 0; i < kWords<VB>; ++i) {
      if constexpr (sizeof(T) == 4) {
        w[i] = __float_as_uint(v[i]);
      } else {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        w[i] = *reinterpret_cast<const unsigned*>(&h);
      }
    }
    if constexpr (VB == 16) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (VB == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<unsigned*>(p) = w[0];
    }
  }
}

// One slot's terms, in the plain version's order: grad adds the value
// times each component's coefficient to that component's sum; div adds
// component 0's product, then component 1's, to one sum.
template <int V, bool kDiv>
__device__ __forceinline__ void add_slot(float* a0, float* a1,
                                         const float* v0, const float* v1,
                                         float2 w) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if constexpr (kDiv) {
      a0[i] = __fadd_rn(a0[i], __fmul_rn(v0[i], w.x));
      a0[i] = __fadd_rn(a0[i], __fmul_rn(v1[i], w.y));
    } else {
      a0[i] = __fadd_rn(a0[i], __fmul_rn(v0[i], w.x));
      a1[i] = __fadd_rn(a1[i], __fmul_rn(v0[i], w.y));
    }
  }
}

// Route A. A group of G lanes a point, 32 / G points a warp; in pass q,
// lane lg of a group reads vectors (q U + u) G + lg, u < U, of each
// component row (U = 2 for rows of more than G vectors: their loads go
// out together, not in a second pass after the first). feat rows hold NC
// * C elements (NC = 2 for div: v[j, 0, :], then v[j, 1, :]); VB divides
// C * sizeof(T) and both base pointers.
template <typename T, int VB, bool kDiv, int U>
__global__ void __launch_bounds__(32 * kWarps)
    coef_warp_kernel(const T* __restrict__ feat,
                     const float2* __restrict__ coef,
                     const int* __restrict__ idx, T* __restrict__ out,
                     long long BN, int N, int C, int K, int G, int passes) {
  constexpr int V = VB / (int)sizeof(T);
  constexpr int NC = kDiv ? 2 : 1;
  constexpr int W = kWords<VB>;
  constexpr int A = kAhead / U;  // slots whose loads go out together
  __shared__ int s_j[kWarps][kMaxGroupPoints * kSlotChunk];
  __shared__ float2 s_w[kWarps][kMaxGroupPoints * kSlotChunk];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int P = 32 / G;
  const int g = lane / G, lg = lane % G;
  const long long pt0 = ((long long)blockIdx.x * kWarps + warp) * P;
  if (pt0 >= BN) return;  // the whole warp
  const long long pt = pt0 + g;
  const bool live = pt < BN;
  const long long b = (live ? pt : pt0) / N;
  const long long row = (long long)NC * C;
  const T* fb = feat + b * N * row;
  const int nv = C / V;
  int* sj = s_j[warp];
  float2* sw = s_w[warp];
  const int* mj = sj + g * kSlotChunk;
  const float2* mw = sw + g * kSlotChunk;
  for (int q = 0; q < passes; ++q) {
    int c0[U];
    bool on[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int vec = (q * U + u) * G + lg;
      on[u] = live && vec < nv;
      c0[u] = vec * V;
    }
    float a0[U][V], a1[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int i = 0; i < V; ++i) a0[u][i] = a1[u][i] = 0.0f;
    }
    for (int k0 = 0; k0 < K; k0 += kSlotChunk) {
      const int kc = min(kSlotChunk, K - k0);
      if (q == 0 || K > kSlotChunk) {  // else the chunk is staged already
        __syncwarp();
        for (int e = lane; e < P * kc; e += 32) {
          const int i = e / kc, kk = e - i * kc;
          const long long p = pt0 + i;
          int j = -1;
          float2 w = make_float2(0.0f, 0.0f);
          if (p < BN) {
            j = idx[p * K + k0 + kk];
            w = coef[p * K + k0 + kk];
          }
          sj[i * kSlotChunk + kk] = j;
          sw[i * kSlotChunk + kk] = w;
        }
        __syncwarp();
      }
      for (int ka = 0; ka < kc; ka += A) {
        unsigned raw[A][U][NC][W];
#pragma unroll
        for (int s = 0; s < A; ++s) {
          const int j = ka + s < kc ? mj[ka + s] : -1;
          const bool in = (unsigned)j < (unsigned)N;
#pragma unroll
          for (int u = 0; u < U; ++u) {
#pragma unroll
            for (int d = 0; d < NC; ++d) {
              if (in && on[u]) {
                load_words<VB>(fb + (long long)j * row + d * C + c0[u],
                               raw[s][u][d]);
              } else {
#pragma unroll
                for (int i = 0; i < W; ++i) raw[s][u][d][i] = 0u;
              }
            }
          }
        }
#pragma unroll
        for (int s = 0; s < A; ++s) {
          if (ka + s < kc) {
            const float2 w = mw[ka + s];
#pragma unroll
            for (int u = 0; u < U; ++u) {
              float v0[V], v1[V];
              unpack<T, VB>(raw[s][u][0], v0);
              unpack<T, VB>(raw[s][u][NC - 1], v1);
              add_slot<V, kDiv>(a0[u], a1[u], v0, v1, w);
            }
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!on[u]) continue;
      if constexpr (kDiv) {
        store_vec<T, VB>(out + pt * C + c0[u], a0[u]);
      } else {
        store_vec<T, VB>(out + 2 * pt * C + c0[u], a0[u]);
        store_vec<T, VB>(out + (2 * pt + 1) * C + c0[u], a1[u]);
      }
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Route B: a block a run of R points. Shared memory: the staged rows
// (budget bytes, 16-byte pieces), then the run's coefficients and local
// slots [R * K] and its point ids [R]. C * sizeof(T) is a multiple of 16
// and feat, out are 16-byte aligned.
template <typename T, bool kDiv>
__global__ void __launch_bounds__(kRunThreads)
    coef_run_kernel(const T* __restrict__ feat,
                    const float2* __restrict__ coef,
                    const int* __restrict__ order,
                    const int* __restrict__ run_rows,
                    const int* __restrict__ run_count,
                    const short* __restrict__ local_slot,
                    T* __restrict__ out, int N, int C, int K, int R,
                    int n_runs, int budget) {
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int NC = kDiv ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int RK = R * K;
  uint4* buf = reinterpret_cast<uint4*>(smem);
  float2* s_w = reinterpret_cast<float2*>(smem + budget);
  int* s_ls = reinterpret_cast<int*>(s_w + RK);
  int* s_pt = s_ls + RK;
  const int run = blockIdx.x;
  const int first = (run % n_runs) * R;
  const int np = min(R, N - first);
  const int count = run_count[run];
  const int* rows = run_rows + (long long)run * RK;
  const long long cloud = (long long)(run / n_runs) * N;
  for (int i = threadIdx.x; i < np; i += blockDim.x)
    s_pt[i] = order[cloud + first + i];
  __syncthreads();
  for (int e = threadIdx.x; e < np * K; e += blockDim.x) {
    const int i = e / K;
    const long long pk = (cloud + s_pt[i]) * K + (e - i * K);
    s_ls[e] = local_slot[pk];
    s_w[e] = coef[pk];
  }
  // Chunks of the channels: as few as the budget allows, evened out.
  const int rb = C * (int)sizeof(T);  // bytes of a component row
  const int pieces = rb / 16;
  const int fit = max(1, min(pieces, budget / (16 * NC * max(count, 1))));
  const int n_chunks = (pieces + fit - 1) / fit;
  const int wp = (pieces + n_chunks - 1) / n_chunks;
  const char* fbytes = reinterpret_cast<const char*>(feat + cloud * NC * C);
  for (int p0 = 0; p0 < pieces; p0 += wp) {
    const int w = min(wp, pieces - p0);
    __syncthreads();  // the last chunk's reads are done
    // Piece t = (r * NC + d) * w + pc: row r's component d, piece pc.
    for (int t = threadIdx.x; t < count * NC * w; t += blockDim.x) {
      const int rd = t / w, pc = t - rd * w;
      const int r = rd / NC, d = rd - r * NC;
      const int j = rows[r];
      const bool ok = (unsigned)j < (unsigned)N;
      cp_async16(buf + t,
                 fbytes + ((long long)(ok ? j : 0) * NC + d) * rb +
                     (long long)(p0 + pc) * 16,
                 ok ? 16 : 0);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int it = threadIdx.x; it < np * w; it += blockDim.x) {
      const int i = it / w, pc = it - i * w;
      const int* ls = s_ls + i * K;
      const float2* ws = s_w + i * K;
      float a0[V], a1[V];
#pragma unroll
      for (int q = 0; q < V; ++q) a0[q] = a1[q] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const int s = ls[k];
        const uint4 u0 = buf[(s * NC) * w + pc];
        const uint4 u1 = buf[(s * NC + NC - 1) * w + pc];
        const unsigned w0[4] = {u0.x, u0.y, u0.z, u0.w};
        const unsigned w1[4] = {u1.x, u1.y, u1.z, u1.w};
        float v0[V], v1[V];
        unpack<T, 16>(w0, v0);
        unpack<T, 16>(w1, v1);
        add_slot<V, kDiv>(a0, a1, v0, v1, ws[k]);
      }
      const long long pt = cloud + s_pt[i];
      const int c0 = (p0 + pc) * V;
      if constexpr (kDiv) {
        store_vec<T, 16>(out + pt * C + c0, a0);
      } else {
        store_vec<T, 16>(out + 2 * pt * C + c0, a0);
        store_vec<T, 16>(out + (2 * pt + 1) * C + c0, a1);
      }
    }
  }
}

// Spreads the 10 low bits of v to bits 0, 3, 6, ..., 27.
__device__ __forceinline__ unsigned spread3(unsigned v) {
  v &= 0x3ffu;
  v = (v | (v << 16)) & 0x030000ffu;
  v = (v | (v << 8)) & 0x0300f00fu;
  v = (v | (v << 4)) & 0x030c30c3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

constexpr int kChunk = 1024;  // keys a block sorts, one a thread

// Bitonic sort of the block's kChunk keys, one a thread, ascending:
// partners in the same warp by shuffles, across warps through s_key.
// The lower of a pair keeps the smaller key in an ascending block of the
// network, the larger in a descending one.
template <typename K>
__device__ __forceinline__ K block_sort(K key, K* s_key) {
  const int t = threadIdx.x;
  for (int size = 2; size <= kChunk; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      K other;
      if (stride >= 32) {
        __syncthreads();
        s_key[t] = key;
        __syncthreads();
        other = s_key[t ^ stride];
      } else {
        other = __shfl_xor_sync(0xffffffffu, key, stride);
      }
      key = (((t & stride) == 0) == ((t & size) == 0)) ? min(key, other)
                                                       : max(key, other);
    }
  }
  return key;
}

// The order's first kernel, a block a (cloud, chunk of kChunk points):
// the bounding box of the cloud's valid points, then each of the chunk's
// points keyed (code << 32 | point) by the Morton code of its position
// quantized to 10 bits an axis in that box (axis a at bits 3i + a; a
// padded point gets 1 << 30, above every code; ~0 past N), sorted. The
// codes round the plain version's f32 operations.
__global__ void __launch_bounds__(kChunk)
    plan_sort_kernel(const float* __restrict__ pos,
                     const unsigned char* __restrict__ mask,
                     unsigned long long* __restrict__ keys, int N,
                     int n_chunks) {
  __shared__ float s_box[6][32];
  __shared__ unsigned long long s_key[kChunk];
  const int t = threadIdx.x;
  const long long cloud = (long long)(blockIdx.x / n_chunks) * N;
  const float* pb = pos + cloud * 3;
  float box[6];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    box[a] = __int_as_float(0x7f800000);  // lo: +inf
    box[3 + a] = -box[a];                 // hi: -inf
  }
  for (int n = t; n < N; n += blockDim.x) {
    if (mask != nullptr && !mask[cloud + n]) continue;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      box[a] = fminf(box[a], pb[3 * n + a]);
      box[3 + a] = fmaxf(box[3 + a], pb[3 * n + a]);
    }
  }
  const int lane = t % 32, warp = t / 32;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    for (int o = 16; o > 0; o >>= 1) {
      const float u = __shfl_xor_sync(0xffffffffu, box[a], o);
      box[a] = a < 3 ? fminf(box[a], u) : fmaxf(box[a], u);
    }
    if (lane == 0) s_box[a][warp] = box[a];
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    box[a] = s_box[a][0];
    for (int i = 1; i < kChunk / 32; ++i)
      box[a] = a < 3 ? fminf(box[a], s_box[a][i]) : fmaxf(box[a], s_box[a][i]);
  }
  const int n = (blockIdx.x % n_chunks) * kChunk + t;
  unsigned long long key = ~0ull;
  if (n < N) {
    unsigned code = 1u << 30;
    if (mask == nullptr || mask[cloud + n]) {
      code = 0;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float scale =
            box[3 + a] > box[a]
                ? __fdiv_rn(1023.0f, __fsub_rn(box[3 + a], box[a]))
                : 0.0f;
        const float u = __fmul_rn(__fsub_rn(pb[3 * n + a], box[a]), scale);
        code |= spread3((unsigned)min((int)u, 1023)) << a;
      }
    }
    key = ((unsigned long long)code << 32) | (unsigned)n;
  }
  keys[(long long)blockIdx.x * kChunk + t] = block_sort(key, s_key);
}

// The order's second kernel: a point's place in its cloud is its place
// in its sorted chunk plus the keys below it in the cloud's other chunks
// (a binary search in each; the keys are distinct).
__global__ void __launch_bounds__(kChunk)
    plan_merge_kernel(const unsigned long long* __restrict__ keys,
                      int* __restrict__ order, int N, int n_chunks) {
  const unsigned long long x = keys[(long long)blockIdx.x * kChunk +
                                    threadIdx.x];
  if (x == ~0ull) return;
  const int chunk = blockIdx.x % n_chunks;
  const unsigned long long* ck =
      keys + (long long)(blockIdx.x - chunk) * kChunk;
  int rank = threadIdx.x;
  for (int c = 0; c < n_chunks; ++c) {
    if (c == chunk) continue;
    int lo = 0, hi = kChunk;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (ck[c * kChunk + mid] < x) lo = mid + 1; else hi = mid;
    }
    rank += lo;
  }
  order[(long long)(blockIdx.x / n_chunks) * N + rank] = (int)(x & 0xffffffffu);
}

// A block a run: its R * K edges' ids (N for one outside [0, N)) keyed
// (id << 10 | edge) and sorted (bitonic, 1024 keys), the first of each
// id counted (a block scan): its rank is the edge's local slot, and the
// ids in rank order are the run's rows (-1 for N, and after count).
__global__ void __launch_bounds__(kChunk)
    plan_runs_kernel(const int* __restrict__ idx,
                     const int* __restrict__ order, int* __restrict__ run_rows,
                     int* __restrict__ run_count,
                     short* __restrict__ local_slot, int N, int K, int R,
                     int n_runs) {
  __shared__ unsigned s_key[kChunk];
  __shared__ int s_pt[kChunk];
  __shared__ int s_scan[32];
  const int run = blockIdx.x, t = threadIdx.x;
  const int first = (run % n_runs) * R;
  const int np = min(R, N - first);
  const long long cloud = (long long)(run / n_runs) * N;
  if (t < np) s_pt[t] = order[cloud + first + t];
  __syncthreads();
  unsigned key = 0xffffffffu;
  if (t < np * K) {
    const int i = t / K;
    const int j = idx[(cloud + s_pt[i]) * K + (t - i * K)];
    key = (((unsigned)j < (unsigned)N ? (unsigned)j : (unsigned)N) << 10) |
          (unsigned)t;
  }
  key = block_sort(key, s_key);
  __syncthreads();
  s_key[t] = key;
  __syncthreads();
  const bool real = key != 0xffffffffu;
  const unsigned id = key >> 10;
  const bool fresh = real && (t == 0 || (s_key[t - 1] >> 10) != id);
  const int lane = t % 32, warp = t / 32;
  const unsigned bal = __ballot_sync(0xffffffffu, fresh);
  const int incl = __popc(bal & ((2u << lane) - 1u));
  if (lane == 31) s_scan[warp] = __popc(bal);
  __syncthreads();
  if (warp == 0) {
    int v = s_scan[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    s_scan[lane] = v;
  }
  __syncthreads();
  const int rank = incl + (warp > 0 ? s_scan[warp - 1] : 0) - 1;
  const int count = s_scan[31];
  int* rr = run_rows + (long long)run * R * K;
  if (real) {
    const int e = (int)(key & 1023u);
    const int i = e / K;
    local_slot[(cloud + s_pt[i]) * K + (e - i * K)] = (short)rank;
    if (fresh) rr[rank] = id < (unsigned)N ? (int)id : -1;
  }
  if (t >= count && t < R * K) rr[t] = -1;
  if (t == 0) run_count[run] = count;
}

bool aligned(const void* p, int bytes) { return (uintptr_t)p % bytes == 0; }

template <typename T, int VB, bool kDiv>
int launch_warp(const void* in, const void* coef, const void* idx, void* out,
                int B, int N, int C, int K, void* stream) {
  const int nv = C * (int)sizeof(T) / VB;
  int G = 4;
  while (G < 32 && G < nv) G *= 2;
  const long long BN = (long long)B * N;
  const long long pts = (long long)kWarps * (32 / G);
  const dim3 grid((unsigned)((BN + pts - 1) / pts));
  cudaStream_t s = (cudaStream_t)stream;
  if (nv <= G) {
    coef_warp_kernel<T, VB, kDiv, 1><<<grid, 32 * kWarps, 0, s>>>(
        (const T*)in, (const float2*)coef, (const int*)idx, (T*)out, BN, N,
        C, K, G, 1);
  } else {
    coef_warp_kernel<T, VB, kDiv, 2><<<grid, 32 * kWarps, 0, s>>>(
        (const T*)in, (const float2*)coef, (const int*)idx, (T*)out, BN, N,
        C, K, G, (nv + 2 * G - 1) / (2 * G));
  }
  return (int)cudaGetLastError();
}

// The widest vector that the row width and both pointers allow.
template <typename T, bool kDiv>
int dispatch_warp(const void* in, const void* coef, const void* idx,
                  void* out, int B, int N, int C, int K, void* stream) {
  const int rb = C * (int)sizeof(T);
  auto fits = [&](int vb) {
    return rb % vb == 0 && aligned(in, vb) && aligned(out, vb);
  };
  if (fits(16))
    return launch_warp<T, 16, kDiv>(in, coef, idx, out, B, N, C, K, stream);
  if (fits(8))
    return launch_warp<T, 8, kDiv>(in, coef, idx, out, B, N, C, K, stream);
  if (sizeof(T) == 4 || fits(4))
    return launch_warp<T, 4, kDiv>(in, coef, idx, out, B, N, C, K, stream);
  if constexpr (sizeof(T) == 2)
    return launch_warp<T, 2, kDiv>(in, coef, idx, out, B, N, C, K, stream);
  return (int)cudaErrorInvalidValue;
}

template <bool kDiv>
int apply_warp(const void* in, const void* coef, const void* idx, void* out,
               int B, int N, int C, int K, int bf16, int device,
               void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  if (bf16)
    return dispatch_warp<__nv_bfloat16, kDiv>(in, coef, idx, out, B, N, C, K,
                                              stream);
  return dispatch_warp<float, kDiv>(in, coef, idx, out, B, N, C, K, stream);
}

template <typename T, bool kDiv>
int launch_run(const void* in, const void* coef, const void* order,
               const void* run_rows, const void* run_count,
               const void* local_slot, void* out, int B, int N, int C, int K,
               int R, int budget, void* stream) {
  const int n_runs = (N + R - 1) / R;
  const int bytes = budget + R * K * (int)(sizeof(float2) + sizeof(int)) +
                    R * (int)sizeof(int);
  auto kernel = coef_run_kernel<T, kDiv>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)(B * n_runs), kRunThreads, bytes,
           (cudaStream_t)stream>>>(
      (const T*)in, (const float2*)coef, (const int*)order,
      (const int*)run_rows, (const int*)run_count, (const short*)local_slot,
      (T*)out, N, C, K, R, n_runs, budget);
  return (int)cudaGetLastError();
}

template <bool kDiv>
int apply_run(const void* in, const void* coef, const void* order,
              const void* run_rows, const void* run_count,
              const void* local_slot, void* out, int B, int N, int C, int K,
              int R, int budget, int bf16, int device, void* stream) {
  DC_SET_DEVICE(device);
  const int sz = bf16 ? 2 : 4;
  if ((C * sz) % 16 != 0 || !aligned(in, 16) || !aligned(out, 16) ||
      R < 1 || R * K > kChunk || budget < 16 * (kDiv ? 2 : 1) * R * K)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  if (bf16)
    return launch_run<__nv_bfloat16, kDiv>(in, coef, order, run_rows,
                                           run_count, local_slot, out, B, N,
                                           C, K, R, budget, stream);
  return launch_run<float, kDiv>(in, coef, order, run_rows, run_count,
                                 local_slot, out, B, N, C, K, R, budget,
                                 stream);
}

}  // namespace

extern "C" int dc_coef_apply_grad(const void* x, const void* coef,
                                  const void* idx, void* out, int B, int N,
                                  int C, int K, int bf16, int device,
                                  void* stream) {
  return apply_warp<false>(x, coef, idx, out, B, N, C, K, bf16, device,
                           stream);
}

extern "C" int dc_coef_apply_div(const void* v, const void* coef,
                                 const void* idx, void* out, int B, int N,
                                 int C, int K, int bf16, int device,
                                 void* stream) {
  return apply_warp<true>(v, coef, idx, out, B, N, C, K, bf16, device,
                          stream);
}

extern "C" int dc_coef_apply_grad_plan(const void* x, const void* coef,
                                       const void* order, const void* run_rows,
                                       const void* run_count,
                                       const void* local_slot, void* out,
                                       int B, int N, int C, int K, int R,
                                       int budget, int bf16, int device,
                                       void* stream) {
  return apply_run<false>(x, coef, order, run_rows, run_count, local_slot,
                          out, B, N, C, K, R, budget, bf16, device, stream);
}

extern "C" int dc_coef_apply_div_plan(const void* v, const void* coef,
                                      const void* order, const void* run_rows,
                                      const void* run_count,
                                      const void* local_slot, void* out,
                                      int B, int N, int C, int K, int R,
                                      int budget, int bf16, int device,
                                      void* stream) {
  return apply_run<true>(v, coef, order, run_rows, run_count, local_slot,
                         out, B, N, C, K, R, budget, bf16, device, stream);
}

extern "C" int dc_coef_plan_order(const void* pos, const void* mask,
                                  void* keys, void* order, int B, int N,
                                  int device, void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N == 0) return (int)cudaGetLastError();
  const int n_chunks = (N + kChunk - 1) / kChunk;
  cudaStream_t s = (cudaStream_t)stream;
  plan_sort_kernel<<<(unsigned)(B * n_chunks), kChunk, 0, s>>>(
      (const float*)pos, (const unsigned char*)mask,
      (unsigned long long*)keys, N, n_chunks);
  plan_merge_kernel<<<(unsigned)(B * n_chunks), kChunk, 0, s>>>(
      (const unsigned long long*)keys, (int*)order, N, n_chunks);
  return (int)cudaGetLastError();
}

extern "C" int dc_coef_plan_runs(const void* idx, const void* order,
                                 void* run_rows, void* run_count,
                                 void* local_slot, int B, int N, int K, int R,
                                 int device, void* stream) {
  DC_SET_DEVICE(device);
  if (R < 1 || R * K > kChunk || N >= (1 << 22))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * N == 0) return (int)cudaGetLastError();
  const int n_runs = (N + R - 1) / R;
  plan_runs_kernel<<<(unsigned)(B * n_runs), kChunk, 0,
                     (cudaStream_t)stream>>>(
      (const int*)idx, (const int*)order, (int*)run_rows, (int*)run_count,
      (short*)local_slot, N, K, R, n_runs);
  return (int)cudaGetLastError();
}
