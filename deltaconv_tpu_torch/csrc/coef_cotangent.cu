// The coefficients' cotangent of a coefficient-form apply, a sampled
// product:
//   grad: d[b, n, k, e] = sum_c x[b, j, c] * ct[b, n, e, c]
//   div:  d[b, n, k, e] = sum_c v[b, j, e, c] * ct[b, n, c]
// with j = idx[b, n, k]; x [B, N, C] or v [B, N, 2, C] f32 (contiguous),
// ct [B, N, 2, C] (grad) or [B, N, C] (div) f32 read through its strides
// (channels contiguous), idx [B, N, K] i32 -> d [B, N, K, 2] f32. An index
// outside [0, N) gives 0.
//
// Replaces no Pallas site of its own. It is the redesign of
// `_densify_bwd` (deltaconv_tpu/ops/densify_op.py:281, the gather of the
// dense operators' [B, 2, N, N] cotangent at the edges' columns) together
// with the product that fed it: differentiated, the dense applies
// (geometry/dense.py) formed that cotangent as g @ x^T, an N x N x C
// product a cloud of which the gather kept K columns of N. The
// coefficient form's VJPs (ops/coef_apply.py) took the same function as a
// [B, C, K, N] gather_rows edge tensor and an einsum. Here only the
// edges' entries are formed: each is the dot of the neighbour's row with
// the point's cotangent row.
//
// Sums: each dot in f64 (the f32 products are exact in f64), in a fixed
// order, rounded once to f32; two calls give the same bits, and the plain
// version (an f64 einsum) agrees to within one f32 ulp where its f64
// order rounds otherwise.
//
// Bound on the H100: memory. The function reads x or v once (the K
// gathers of a row come from L2: a cloud's rows are 0.5 to 8 MB), ct once,
// idx once, and writes d: 58 MB for grad at B=32, N=1024, K=20, C=128.
// Two routes, by the width of an edge's gathered row (C for grad, 2C for
// div):
//
// Wide (more than 16 floats): a group of G lanes (8, 16 or 32: the fewest
// whose two vectors a lane cover the row; 8 for rows of narrower vectors,
// in passes) owns a point; a lane holds its
// vectors of the point's ct row(s) in f64 registers and reads its vectors
// of each neighbour row, the widest aligned vector (16, 8 or 4 bytes), the
// loads of several slots in flight before their products. Slots go in
// chunks of 8: a lane's 16 partial sums (8 slots x 2 components) are
// reduced across the group by a transposed butterfly (at each step a lane
// keeps half of its values and trades the other half with its partner),
// so a chunk costs about 2 f64 shuffles a slot instead of 2 log2(G); the
// tree is fixed, so are the bits. The slots' indices are loaded a chunk
// ahead, coalesced, and broadcast by shuffles. What bounds it is the
// gathers: K rows a point from L2 (671 MB at grad C=256, B=32, N=1024,
// K=20, 20 times the function's input bytes), whatever the f64 work.
//
// Narrow (16 floats or fewer: conv0's C = 3 grad and C = 6 div): a lane
// owns an edge (n, k); a warp's 32 consecutive edges read their indices
// and write their outputs coalesced, the few ct values of a point come
// from L1 to the K lanes that share it, and each lane sums its dot in
// channel order.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;  // slots whose partial sums are reduced together
constexpr int kVecs = 2;   // vectors a lane a row, wide route
constexpr int kInFlight = 32;  // floats of a lane's gathers in flight

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  } else if constexpr (V == 2) {
    const float2 u = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = u.x; v[1] = u.y;
  } else {
    v[0] = __ldg(p);
  }
}

// The transposed butterfly over the G lanes of a group (offsets O, O / 2,
// ..., 1) of CNT values a lane: while CNT > 1 a lane with bit O set keeps
// the upper half of its values, its partner the lower, and each adds the
// half it receives; after that the single value is added to its
// partner's. A lane then holds values [i0, i0 + 16 / min(G, 16)) of the 16,
// i0 = (lg >> max(0, log2 G - 4)) * (16 / min(G, 16)), summed over the
// group.
template <int O, int CNT>
__device__ __forceinline__ void butterfly(double (&v)[2 * kChunk], int lg) {
  if constexpr (CNT > 1) {
    constexpr int H = CNT / 2;
    const bool up = (lg & O) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const double send = up ? v[i] : v[i + H];
      const double keep = up ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    if constexpr (O > 1) butterfly<O / 2, H>(v, lg);
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
    if constexpr (O > 1) butterfly<O / 2, 1>(v, lg);
  }
}

// Wide route. NC = 2 for div (the gathered row is v[j, 0, :] then
// v[j, 1, :]); the point's ct rows are ME = 2 (grad) or 1 (div). In pass
// q, lane lg of a group takes vectors (q kVecs + u) G + lg, u < kVecs, of
// the channels. V divides C, the pointers and the strides.
#define DC_WIDE_PARAMS                                                     \
  const float *__restrict__ feat, const float *__restrict__ ct,            \
      const int *__restrict__ idx, const int *__restrict__ order,          \
      float *__restrict__ out, long long BN, int N, int C, int K,          \
      int passes, long long sb, long long sn, long long se
#define DC_WIDE_ARGS \
  feat, ct, idx, order, out, BN, N, C, K, passes, sb, sn, se

template <int G, int V, bool kDiv>
__device__ __forceinline__ void cotangent_wide(DC_WIDE_PARAMS) {
  constexpr int NC = kDiv ? 2 : 1;
  constexpr int ME = kDiv ? 1 : 2;
  constexpr int P = 32 / G;  // points a warp
  constexpr int PER_SLOT = kVecs * NC * V;
  // Slots whose loads go out together (a divisor of kChunk).
  constexpr int A = PER_SLOT >= kInFlight
                        ? 1
                        : (kInFlight / PER_SLOT < kChunk
                               ? kInFlight / PER_SLOT
                               : kChunk);
  constexpr int LOG_G = G == 32 ? 5 : (G == 16 ? 4 : 3);
  constexpr int SHIFT = LOG_G > 4 ? LOG_G - 4 : 0;
  constexpr int HELD = 2 * kChunk / (G < 16 ? G : 16);  // values a lane
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lg = lane % G, base = lane - lg;
  const long long i0 = ((long long)blockIdx.x * kWarps + warp) * P;
  if (i0 >= BN) return;  // the whole warp
  // The i-th point walked is the order[i]-th of its cloud (a gather
  // plan's Morton order: neighbouring points on one SM share their rows in
  // L1), or the i-th.
  const long long i = i0 + lane / G < BN ? i0 + lane / G : i0;
  const long long b = i / N;
  const long long n = order ? (long long)__ldg(order + i) : i - b * N;
  const bool live = i0 + lane / G < BN && (unsigned long long)n < N;
  const long long pt = b * N + (live ? n : 0);
  const long long row = (long long)NC * C;
  const float* fb = feat + b * N * row;
  const float* cb = ct + b * sb + n * sn;
  const int nv = C / V;
  double cta[kVecs][V], ctb[kVecs][V];
  // A chunk's indices: lane lg < kChunk of a group holds slot k0 + lg; the
  // next chunk's are loaded before this one's rows.
  auto slot_ids = [&](int k0) {
    const int kk = k0 + lg;
    return live && lg < kChunk && kk < K ? __ldg(idx + pt * K + kk) : -1;
  };
  int jn = slot_ids(0);
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int jl = jn;
    jn = slot_ids(k0 + kChunk);
    double part[2 * kChunk];
#pragma unroll
    for (int i = 0; i < 2 * kChunk; ++i) part[i] = 0.0;
    for (int q = 0; q < passes; ++q) {
      bool on[kVecs];
      int c0[kVecs];
#pragma unroll
      for (int u = 0; u < kVecs; ++u) {
        const int vec = (q * kVecs + u) * G + lg;
        on[u] = live && vec < nv;
        c0[u] = vec * V;
      }
      if (passes > 1 || k0 == 0) {  // the point's ct vectors, in f64
#pragma unroll
        for (int u = 0; u < kVecs; ++u) {
          float a[V], c[V];
#pragma unroll
          for (int i = 0; i < V; ++i) a[i] = c[i] = 0.0f;
          if (on[u]) {
            load_vec<V>(cb + c0[u], a);
            if constexpr (ME == 2) load_vec<V>(cb + se + c0[u], c);
          }
#pragma unroll
          for (int i = 0; i < V; ++i) {
            cta[u][i] = (double)a[i];
            ctb[u][i] = (double)c[i];
          }
        }
      }
#pragma unroll
      for (int s0 = 0; s0 < kChunk; s0 += A) {
        if (k0 + s0 >= K) break;  // the last chunk's empty slots (uniform)
        float raw[A][kVecs][NC][V];
#pragma unroll
        for (int s = 0; s < A; ++s) {
          const int j = __shfl_sync(0xffffffffu, jl, base + s0 + s);
          const bool in = (unsigned)j < (unsigned)N;
#pragma unroll
          for (int u = 0; u < kVecs; ++u) {
#pragma unroll
            for (int d = 0; d < NC; ++d) {
              if (in && on[u]) {
                load_vec<V>(fb + (long long)j * row + d * C + c0[u],
                            raw[s][u][d]);
              } else {
#pragma unroll
                for (int i = 0; i < V; ++i) raw[s][u][d][i] = 0.0f;
              }
            }
          }
        }
#pragma unroll
        for (int s = 0; s < A; ++s) {
          double& p0 = part[2 * (s0 + s)];
          double& p1 = part[2 * (s0 + s) + 1];
#pragma unroll
          for (int u = 0; u < kVecs; ++u) {
#pragma unroll
            for (int i = 0; i < V; ++i) {
              if constexpr (kDiv) {
                p0 = fma((double)raw[s][u][0][i], cta[u][i], p0);
                p1 = fma((double)raw[s][u][1][i], cta[u][i], p1);
              } else {
                const double x = (double)raw[s][u][0][i];
                p0 = fma(x, cta[u][i], p0);
                p1 = fma(x, ctb[u][i], p1);
              }
            }
          }
        }
      }
    }
    butterfly<G / 2, 2 * kChunk>(part, lg);
    // Lane lg holds the flat values i0 .. i0 + HELD of the chunk's
    // [kChunk][2] outputs; in a group of 32 two lanes hold each.
    if (live && (lg & ((1 << SHIFT) - 1)) == 0) {
      const int i0 = (lg >> SHIFT) * HELD;
      float* o = out + (pt * K + k0) * 2;
#pragma unroll
      for (int i = 0; i < HELD; ++i)
        if ((i0 + i) / 2 + k0 < K) o[i0 + i] = __double2float_rn(part[i]);
    }
  }
}

// The wide route's kernels. 16-byte vectors: registers capped for 3
// blocks an SM (85), where more warps hide more of the gathers' latency
// (grad C=256 0.167 ms against 0.190 uncapped, B=32, N=1024, K=20,
// H100). Narrower vectors: uncapped; a cap slows them (C=70: 0.064 ms
// uncapped, 0.083 for 3 blocks, 0.097 for 1).
template <int G, bool kDiv>
__global__ void __launch_bounds__(kThreads, 3)
    cotangent_wide_vec4_kernel(DC_WIDE_PARAMS) {
  cotangent_wide<G, 4, kDiv>(DC_WIDE_ARGS);
}

template <int G, int V, bool kDiv>
__global__ void __launch_bounds__(kThreads)
    cotangent_wide_kernel(DC_WIDE_PARAMS) {
  cotangent_wide<G, V, kDiv>(DC_WIDE_ARGS);
}

// Narrow route: a thread an edge e = p K + k of the BN K edges.
template <bool kDiv>
__global__ void __launch_bounds__(kThreads)
    cotangent_narrow_kernel(const float* __restrict__ feat,
                            const float* __restrict__ ct,
                            const int* __restrict__ idx,
                            float2* __restrict__ out, long long edges,
                            int N, int C, int K, long long sb, long long sn,
                            long long se) {
  constexpr int NC = kDiv ? 2 : 1;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= edges) return;
  const long long p = e / K;
  const long long b = p / N, n = p - b * N;
  const int j = __ldg(idx + e);
  double d0 = 0.0, d1 = 0.0;
  if ((unsigned)j < (unsigned)N) {
    const float* r = feat + (b * N + j) * NC * C;
    const float* c = ct + b * sb + n * sn;
    for (int i = 0; i < C; ++i) {
      const double a = (double)__ldg(c + i);
      if constexpr (kDiv) {
        d0 = fma((double)__ldg(r + i), a, d0);
        d1 = fma((double)__ldg(r + C + i), a, d1);
      } else {
        const double x = (double)__ldg(r + i);
        d0 = fma(x, a, d0);
        d1 = fma(x, (double)__ldg(c + se + i), d1);
      }
    }
  }
  out[e] = make_float2(__double2float_rn(d0), __double2float_rn(d1));
}

struct CotArgs {
  const float* feat;
  const float* ct;
  const int* idx;
  const int* order;
  float* out;
  long long BN;
  int N, C, K;
  long long sb, sn, se;
};

template <int G, int V, bool kDiv>
void launch_wide(const CotArgs& a, cudaStream_t st) {
  constexpr int P = 32 / G;
  const long long blocks = (a.BN + kWarps * P - 1) / (kWarps * P);
  const int nv = a.C / V;
  const int passes = (nv + kVecs * G - 1) / (kVecs * G);
  const unsigned grid = (unsigned)blocks;
  if constexpr (V == 4) {
    cotangent_wide_vec4_kernel<G, kDiv><<<grid, kThreads, 0, st>>>(
        a.feat, a.ct, a.idx, a.order, a.out, a.BN, a.N, a.C, a.K, passes,
        a.sb, a.sn, a.se);
  } else {
    cotangent_wide_kernel<G, V, kDiv><<<grid, kThreads, 0, st>>>(
        a.feat, a.ct, a.idx, a.order, a.out, a.BN, a.N, a.C, a.K, passes,
        a.sb, a.sn, a.se);
  }
}

template <bool kDiv>
void launch_cotangent(const CotArgs& a, cudaStream_t st) {
  constexpr int NC = kDiv ? 2 : 1;
  const long long edges = a.BN * a.K;
  if (NC * a.C <= 16) {
    const long long blocks = (edges + kThreads - 1) / kThreads;
    cotangent_narrow_kernel<kDiv><<<(unsigned)blocks, kThreads, 0, st>>>(
        a.feat, a.ct, a.idx, reinterpret_cast<float2*>(a.out), edges, a.N,
        a.C, a.K, a.sb, a.sn, a.se);
    return;
  }
  // The widest vector that the rows, both pointers and ct's strides allow.
  const uintptr_t fa = (uintptr_t)a.feat, ca = (uintptr_t)a.ct;
  auto fits = [&](int v) {
    return a.C % v == 0 && fa % (4 * v) == 0 && ca % (4 * v) == 0 &&
           a.sb % v == 0 && a.sn % v == 0 && (kDiv || a.se % v == 0);
  };
  const int V = fits(4) ? 4 : (fits(2) ? 2 : 1);
  // 16-byte vectors: the fewest lanes a point whose two vectors a lane
  // cover the row. Narrower vectors: 8 lanes a point, in passes (C=70:
  // 0.064 ms against 0.092 with 32 lanes, B=32, N=1024, K=20, H100).
  const int nv = a.C / V;
  if (V == 4) {
    if (nv <= 8 * kVecs)
      launch_wide<8, 4, kDiv>(a, st);
    else if (nv <= 16 * kVecs)
      launch_wide<16, 4, kDiv>(a, st);
    else
      launch_wide<32, 4, kDiv>(a, st);
  } else if (V == 2) {
    launch_wide<8, 2, kDiv>(a, st);
  } else {
    launch_wide<8, 1, kDiv>(a, st);
  }
}

}  // namespace

// ct's strides (in floats) for b, n and, in grad mode, the component e;
// its channels are contiguous. order [B, N] i32 (each cloud's points in
// the order the wide route walks them) or null. out [B, N, K, 2] is
// written whole.
extern "C" int dc_coef_cotangent(const void* feat, const void* ct,
                                 const void* idx, const void* order,
                                 void* out, int B, int N,
                                 int C, int K, int div, long long sb,
                                 long long sn, long long se, int device,
                                 void* stream) {
  DC_SET_DEVICE(device);
  cudaStream_t st = (cudaStream_t)stream;
  const long long edges = (long long)B * N * K;
  if (edges == 0) return (int)cudaGetLastError();
  if (C == 0) {
    const cudaError_t err =
        cudaMemsetAsync(out, 0, sizeof(float) * 2 * edges, st);
    return err == cudaSuccess ? (int)cudaGetLastError() : (int)err;
  }
  const CotArgs a{(const float*)feat, (const float*)ct, (const int*)idx,
                  (const int*)order, (float*)out, (long long)B * N, N, C, K,
                  sb, sn, se};
  if (div)
    launch_cotangent<true>(a, st);
  else
    launch_cotangent<false>(a, st);
  return (int)cudaGetLastError();
}
