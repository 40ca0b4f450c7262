// The per-point weighted least squares fit of the grad/div build, shared
// by the WLS forward (wls.cu), its backward (wls.cu) and the fused eval
// build (fused_build.cu), so the math exists once.
//
// One neighbourhood (a point and its K edges) at a time. An edge source
// `src(k)` returns the twelve plane values of edge k (struct Edge); the
// functions below are inlined, so the fields a pass does not use are
// never loaded or computed. The math is `_wls_math` of
// deltaconv_tpu/ops/wls_fused.py:45-137, operation for operation, with
// its clamps: 1e-20 in the Gaussian denominator and on the Cholesky
// diagonal, 1e-5 on the weight sum.
//
// The reverse-mode derivative of the same steps (the VJP that JAX's
// `_bwd_kernel` traces with jax.vjp, wls_fused.py:195-206) is derived by
// hand and walked in reverse order: the div rows, the inverse metric and
// the basis transform, the height-field sums, both triangular solves, the
// Cholesky factorization, the normal equations, the weights. At a clamp
// it follows jnp.maximum's rule: the derivative passes where the clamped
// value is larger, half of it at a tie, none below.
//
// Each step exists once, as a function of one edge (add_normal,
// edge_solve, frame and their reverses frame_bwd, solve_bwd, normal_bwd,
// weight_bwd) or of the point's sums (factor, factor_bwd), and two
// walkers go through them:
// - wls_point / wls_point_bwd: one thread walks all K edges of a point,
//   one pass over K a step, from any edge source (the direct routes of
//   wls.cu, and fused_build.cu's GatherSrc);
// - wls_split / wls_split_bwd: a point's K edges split over S threads
//   (slices), each holding its E edges in registers, every sum over K
//   taken per slice in edge order and then across the slices in slice
//   order by the caller's `sum` (wls.cu: shared memory and a barrier).
//
// GatherSrc is the edge source of the fused eval build: it gathers each
// edge's neighbour rows and forms the planes on the fly (`gather_src`
// makes one for a point); `fused_split` is the fused build's split walker,
// wls_split on those edges with the row norm beside it.
//
// Host and device: the functions compile for the card and, without
// __CUDACC__, as plain C++.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define WLS_FN __host__ __device__ __forceinline__
#else
#define WLS_FN inline
#endif

namespace wls {

constexpr int NB = 6;  // quadratic patch basis [1, u, v, u^2, uv, v^2]
constexpr int NA = NB * (NB + 1) / 2;  // entries of a symmetric 6x6 matrix

// The twelve planes of one edge, in plane order.
struct Edge {
  float u, v, dist, patch, mask, dxx, dxy, dyx, dyy, dnx, dny, avg;
};

// The planes of point n's edges from the cloud's [N, 3] rows: neighbour
// j = idx[k] (clamped into the cloud), centred on slot 0's row (the point
// itself, as the JAX kernel requires); avg the cloud's mean edge length.
// The planes are those of edge_planes (ops/wls_fused.py).
struct GatherSrc {
  const float* pos;
  const float* xb;
  const float* yb;
  const int* idx;             // [K] of point n
  const unsigned char* mask;  // [K] of point n
  int N;
  float avg;
  float px, py, pz, nx, ny, nz, xbx, xby, xbz, ybx, yby, ybz;  // centre

  WLS_FN Edge operator()(int k) const {
    int j = idx[k];
    j = j < 0 ? 0 : (j >= N ? N - 1 : j);
    const float* p = pos + 3 * j;
    const float* x = xb + 3 * j;
    const float* y = yb + 3 * j;
    const float ox = p[0] - px, oy = p[1] - py, oz = p[2] - pz;
    const float sq = ox * ox + oy * oy + oz * oz;
    Edge e;
    e.u = ox * xbx + oy * xby + oz * xbz;
    e.v = ox * ybx + oy * yby + oz * ybz;
    e.dist = sq > 0.0f ? sqrtf(sq) : 0.0f;
    e.patch = ox * nx + oy * ny + oz * nz;
    e.mask = mask[k] ? 1.0f : 0.0f;
    e.dxx = xbx * x[0] + xby * x[1] + xbz * x[2];
    e.dxy = xbx * y[0] + xby * y[1] + xbz * y[2];
    e.dyx = ybx * x[0] + yby * x[1] + ybz * x[2];
    e.dyy = ybx * y[0] + yby * y[1] + ybz * y[2];
    e.dnx = nx * x[0] + ny * x[1] + nz * x[2];
    e.dny = nx * y[0] + ny * y[1] + nz * y[2];
    e.avg = avg;
    return e;
  }
};

// The edge source of one point: the cloud's [N, 3] rows, the point's
// idx and mask rows [K], centred on slot 0's rows (clamped into the cloud).
WLS_FN GatherSrc gather_src(const float* pos, const float* normal,
                            const float* xb, const float* yb, const int* idx,
                            const unsigned char* mask, int N, float avg) {
  int c = idx[0];
  c = c < 0 ? 0 : (c >= N ? N - 1 : c);
  const float* p = pos + 3 * c;
  const float* q = normal + 3 * c;
  const float* x = xb + 3 * c;
  const float* y = yb + 3 * c;
  return {pos,  xb,   yb,   idx,  mask, N,    avg,  p[0], p[1], p[2],
          q[0], q[1], q[2], x[0], x[1], x[2], y[0], y[1], y[2]};
}

// One neighbourhood's fit.
struct Fit {
  float wden;         // max(sum of raw weights, 1e-5)
  float wgate;        // d wden / d sum: 1 above the clamp, 0.5 at it, 0
  float L[NB][NB];    // Cholesky factor, lower triangle with diagonal
  float inv_d[NB];    // 1 / L[j][j]
  float pgate[NB];    // d L[j][j]^2 / d sdiag, as wgate
  float c[NB];        // height-field coefficients
};

// The index of entry (i, j), i <= j, of a symmetric matrix's upper
// triangle packed row by row.
WLS_FN constexpr int tri(int i, int j) {
  return i * NB - i * (i - 1) / 2 + j - i;
}

// The derivative factor of max(x, floor).
WLS_FN float gate(float x, float floor) {
  return x > floor ? 1.0f : (x == floor ? 0.5f : 0.0f);
}

WLS_FN void basis(float u, float v, float* bs) {
  bs[0] = 1.0f;
  bs[1] = u;
  bs[2] = v;
  bs[3] = u * u;
  bs[4] = u * v;
  bs[5] = v * v;
}

WLS_FN float gauss_denom(float avg, float kernel_width) {
  const float kwa = kernel_width * avg;
  return fmaxf(kwa * kwa, 1e-20f);
}

// exp(-(dist^2) / denom), before the mask.
WLS_FN float gauss(const Edge& e, float kernel_width) {
  return expf(-(e.dist * e.dist) / gauss_denom(e.avg, kernel_width));
}

// The raw weight of edge e (before the normalization by wden).
WLS_FN float raw_weight(const Edge& e, float kernel_width) {
  return gauss(e, kernel_width) * e.mask;
}

// Step 1's sum and its clamp.
WLS_FN void set_wden(float wsum, Fit& f) {
  f.wden = fmaxf(wsum, 1e-5f);
  f.wgate = gate(wsum, 1e-5f);
}

// Step 3 of one edge: w b b^T added to the packed upper triangle A.
WLS_FN void add_normal(float w, const float* bs, float* A) {
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int j = i; j < NB; ++j) A[tri(i, j)] += w * bs[i] * bs[j];
}

// Step 4: the Cholesky factor of A + regularizer I (A packed).
WLS_FN void factor(const float* A, float regularizer, Fit& f) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    float sdiag = A[tri(j, j)] + regularizer;
#pragma unroll
    for (int t = 0; t < j; ++t) sdiag = sdiag - f.L[j][t] * f.L[j][t];
    f.pgate[j] = gate(sdiag, 1e-20f);
    f.L[j][j] = sqrtf(fmaxf(sdiag, 1e-20f));
    f.inv_d[j] = 1.0f / f.L[j][j];
#pragma unroll
    for (int i = j + 1; i < NB; ++i) {
      float soff = A[tri(j, i)];
#pragma unroll
      for (int t = 0; t < j; ++t) soff = soff - f.L[i][t] * f.L[j][t];
      f.L[i][j] = soff * f.inv_d[j];
    }
  }
}

// z = A^-1 rhs through L: forward substitution (y), then back (z).
WLS_FN void solve(const Fit& f, const float* rhs, float* y, float* z) {
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    float t = rhs[i];
#pragma unroll
    for (int kk = 0; kk < i; ++kk) t = t - f.L[i][kk] * y[kk];
    y[i] = t * f.inv_d[i];
  }
#pragma unroll
  for (int i = NB - 1; i >= 0; --i) {
    float t = y[i];
#pragma unroll
    for (int kk = i + 1; kk < NB; ++kk) t = t - f.L[kk][i] * z[kk];
    z[i] = t * f.inv_d[i];
  }
}

// Edge e's solve with its normalized weight w: z = A^-1 (w b) (its grad
// coefficients are z[1], z[2]).
WLS_FN void edge_solve(const Fit& f, float w, const Edge& e, float* bs,
                       float* rhs, float* y, float* z) {
  basis(e.u, e.v, bs);
#pragma unroll
  for (int i = 0; i < NB; ++i) rhs[i] = w * bs[i];
  solve(f, rhs, y, z);
}

// Steps 1-6 of one thread over all K edges: the weights, the normal
// equations, the Cholesky factor and the height coefficients c = sum_k
// z_k patch_k. `on_edge(k, z)` sees every edge's solution once, in edge
// order.
template <class Src, class OnEdge>
WLS_FN void fit(const Src& src, int K, float kernel_width, float regularizer,
                Fit& f, OnEdge on_edge) {
  float wsum = 0.0f;
  for (int k = 0; k < K; ++k) wsum += raw_weight(src(k), kernel_width);
  set_wden(wsum, f);

  float A[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) A[i] = 0.0f;
  for (int k = 0; k < K; ++k) {
    const Edge e = src(k);
    float bs[NB];
    basis(e.u, e.v, bs);
    add_normal(raw_weight(e, kernel_width) / f.wden, bs, A);
  }
  factor(A, regularizer, f);

#pragma unroll
  for (int i = 0; i < NB; ++i) f.c[i] = 0.0f;
  for (int k = 0; k < K; ++k) {
    const Edge e = src(k);
    float bs[NB], rhs[NB], y[NB], z[NB];
    edge_solve(f, raw_weight(e, kernel_width) / f.wden, e, bs, rhs, y, z);
#pragma unroll
    for (int i = 0; i < NB; ++i) f.c[i] += z[i] * e.patch;
    on_edge(k, z);
  }
}

// Steps 7-9 of one edge: height partials, inverse metric, basis
// transform, vector map.
struct Frame {
  float hx, hy, det, m11, m12, m22, bt11, bt12, bt21, bt22, M11, M12, M21,
      M22;
};

WLS_FN void frame(const Fit& f, const Edge& e, Frame& r) {
  r.hx = f.c[1] + 2.0f * f.c[3] * e.u + f.c[4] * e.v;
  r.hy = f.c[2] + f.c[4] * e.u + 2.0f * f.c[5] * e.v;
  r.det = 1.0f + r.hx * r.hx + r.hy * r.hy;
  r.m11 = (1.0f + r.hy * r.hy) / r.det;
  r.m12 = -(r.hx * r.hy) / r.det;
  r.m22 = (1.0f + r.hx * r.hx) / r.det;
  r.bt11 = e.dxx + r.hx * e.dnx;
  r.bt12 = e.dxy + r.hx * e.dny;
  r.bt21 = e.dyx + r.hy * e.dnx;
  r.bt22 = e.dyy + r.hy * e.dny;
  r.M11 = r.m11 * r.bt11 + r.m12 * r.bt21;
  r.M12 = r.m11 * r.bt12 + r.m12 * r.bt22;
  r.M21 = r.m12 * r.bt11 + r.m22 * r.bt21;
  r.M22 = r.m12 * r.bt12 + r.m22 * r.bt22;
}

// The div row of an edge from its grad row and frame.
WLS_FN void div_row(const Frame& r, float g1, float g2, float& d1,
                    float& d2) {
  d1 = g1 * r.M11 + g2 * r.M21;
  d2 = g1 * r.M12 + g2 * r.M22;
}

// The forward of one neighbourhood, one thread over all K edges: out(k,
// g1, g2, d1, d2) receives each edge's grad and div coefficients, in edge
// order. The grad coefficients of the fit's pass are kept by the caller
// (`keep(k, g1, g2)`) and read back (`kept(k, g1, g2)`) for the div rows:
// a register array of K would not fit.
template <class Src, class Keep, class Kept, class Out>
WLS_FN void wls_point(const Src& src, int K, float kernel_width,
                      float regularizer, Keep keep, Kept kept, Out out) {
  Fit f;
  fit(src, K, kernel_width, regularizer, f,
      [&](int k, const float* z) { keep(k, z[1], z[2]); });
  for (int k = 0; k < K; ++k) {
    const Edge e = src(k);
    float g1, g2, d1, d2;
    kept(k, g1, g2);
    Frame r;
    frame(f, e, r);
    div_row(r, g1, g2, d1, d2);
    out(k, g1, g2, d1, d2);
  }
}

// ---- The reverse steps, one edge (or the point's sums) each ----

// Steps 9-7 of one edge in reverse, and 6's partials: the div rows, the
// vector map, the basis transform and the inverse metric back to (h_x,
// h_y), then to c (added to dc), u and v. Given the edge's grad row (g1,
// g2) and the cotangents of its grad and div rows.
struct FrameBwd {
  float du, dv;          // u's and v's first terms
  float dg1, dg2;        // the cotangents of z[1], z[2] so far
  float dxx, dxy, dyx, dyy, dnx, dny;  // planes 5-10, final
};

WLS_FN void frame_bwd(const Fit& f, const Edge& e, float g1, float g2,
                      float ctg1, float ctg2, float t1, float t2, float* dc,
                      FrameBwd& o) {
  Frame r;
  frame(f, e, r);
  o.dg1 = ctg1 + t1 * r.M11 + t2 * r.M12;
  o.dg2 = ctg2 + t1 * r.M21 + t2 * r.M22;
  const float dM11 = t1 * g1, dM21 = t1 * g2;
  const float dM12 = t2 * g1, dM22 = t2 * g2;
  const float dm11 = dM11 * r.bt11 + dM12 * r.bt12;
  const float dm12 =
      dM11 * r.bt21 + dM12 * r.bt22 + dM21 * r.bt11 + dM22 * r.bt12;
  const float dm22 = dM21 * r.bt21 + dM22 * r.bt22;
  const float dbt11 = dM11 * r.m11 + dM21 * r.m12;
  const float dbt12 = dM12 * r.m11 + dM22 * r.m12;
  const float dbt21 = dM11 * r.m12 + dM21 * r.m22;
  const float dbt22 = dM12 * r.m12 + dM22 * r.m22;
  o.dxx = dbt11;
  o.dxy = dbt12;
  o.dyx = dbt21;
  o.dyy = dbt22;
  o.dnx = dbt11 * r.hx + dbt21 * r.hy;
  o.dny = dbt12 * r.hx + dbt22 * r.hy;
  float dhx = dbt11 * e.dnx + dbt12 * e.dny;
  float dhy = dbt21 * e.dnx + dbt22 * e.dny;
  // m11 = P / det, m12 = -Q / det, m22 = R / det with P = 1 + hy^2,
  // Q = hx hy, R = 1 + hx^2, det = 1 + hx^2 + hy^2.
  const float ddet = -(dm11 * r.m11 + dm12 * r.m12 + dm22 * r.m22) / r.det;
  const float dP = dm11 / r.det, dQ = -dm12 / r.det, dR = dm22 / r.det;
  dhx += dQ * r.hy + (dR + ddet) * 2.0f * r.hx;
  dhy += dQ * r.hx + (dP + ddet) * 2.0f * r.hy;
  dc[1] += dhx;
  dc[2] += dhy;
  dc[3] += 2.0f * dhx * e.u;
  dc[4] += dhx * e.v + dhy * e.u;
  dc[5] += 2.0f * dhy * e.v;
  o.du = dhx * 2.0f * f.c[3] + dhy * f.c[4];
  o.dv = dhx * f.c[4] + dhy * 2.0f * f.c[5];
}

// Steps 6-5 of one edge in reverse: the height sums (c's cotangent dc,
// whole) to z and the patch, both triangular solves in reverse to the
// right-hand side w b and to L (dL, strictly lower, and dinv, added to),
// the right-hand side to the weight and to u and v (added to du, dv).
// Given the cotangents dg1, dg2 of the edge's grad row (z[1], z[2]) so
// far; returns the patch's cotangent (final) and the weight's so far.
WLS_FN void solve_bwd(const Fit& f, float w, const Edge& e, const float* dc,
                      float dg1, float dg2, float (&dL)[NB][NB], float* dinv,
                      float& du, float& dv, float& dpatch, float& dw) {
  float bs[NB], rhs[NB], y[NB], z[NB];
  edge_solve(f, w, e, bs, rhs, y, z);
  float dz[NB], dy[NB];
  dpatch = 0.0f;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    dz[i] = dc[i] * e.patch;
    dpatch += dc[i] * z[i];
    dy[i] = 0.0f;
  }
  dz[1] += dg1;
  dz[2] += dg2;
  // Back substitution, reversed: z[i] = t * inv_d[i], t = y[i] - sum
  // over kk > i of L[kk][i] z[kk].
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    float t = y[i];
#pragma unroll
    for (int kk = i + 1; kk < NB; ++kk) t = t - f.L[kk][i] * z[kk];
    const float dt = dz[i] * f.inv_d[i];
    dinv[i] += dz[i] * t;
    dy[i] += dt;
#pragma unroll
    for (int kk = i + 1; kk < NB; ++kk) {
      dL[kk][i] -= dt * z[kk];
      dz[kk] -= dt * f.L[kk][i];
    }
  }
  // Forward substitution, reversed: y[i] = t * inv_d[i], t = rhs[i] -
  // sum over kk < i of L[i][kk] y[kk].
  float drhs[NB];
#pragma unroll
  for (int i = NB - 1; i >= 0; --i) {
    float t = rhs[i];
#pragma unroll
    for (int kk = 0; kk < i; ++kk) t = t - f.L[i][kk] * y[kk];
    const float dt = dy[i] * f.inv_d[i];
    dinv[i] += dy[i] * t;
    drhs[i] = dt;
#pragma unroll
    for (int kk = 0; kk < i; ++kk) {
      dL[i][kk] -= dt * y[kk];
      dy[kk] -= dt * f.L[i][kk];
    }
  }
  // rhs = w b: to the weight and the basis, the basis to u and v.
  dw = 0.0f;
#pragma unroll
  for (int i = 0; i < NB; ++i) dw += drhs[i] * bs[i];
  du += w * (drhs[1] + 2.0f * e.u * drhs[3] + e.v * drhs[4]);
  dv += w * (drhs[2] + e.u * drhs[4] + 2.0f * e.v * drhs[5]);
}

// Step 4 reversed: the Cholesky factorization back to A, columns in
// reverse order. dL (strictly lower) and dinv are the sums over the
// edges; both are consumed. dA: the packed upper triangle.
WLS_FN void factor_bwd(const Fit& f, float (&dL)[NB][NB], float* dinv,
                       float* dA) {
#pragma unroll
  for (int i = 0; i < NA; ++i) dA[i] = 0.0f;
#pragma unroll
  for (int j = 0; j < NB; ++j) dL[j][j] = 0.0f;
#pragma unroll
  for (int j = NB - 1; j >= 0; --j) {
#pragma unroll
    for (int i = NB - 1; i > j; --i) {
      // L[i][j] = soff * inv_d[j]
      const float soff = f.L[i][j] * f.L[j][j];
      const float dsoff = dL[i][j] * f.inv_d[j];
      dinv[j] += dL[i][j] * soff;
      dA[tri(j, i)] += dsoff;
#pragma unroll
      for (int t = 0; t < j; ++t) {
        dL[i][t] -= dsoff * f.L[j][t];
        dL[j][t] -= dsoff * f.L[i][t];
      }
    }
    // inv_d[j] = 1 / L[j][j]; L[j][j] = sqrt(max(sdiag, 1e-20)).
    dL[j][j] -= dinv[j] * f.inv_d[j] * f.inv_d[j];
    const float dsdiag = dL[j][j] * (0.5f / f.L[j][j]) * f.pgate[j];
    dA[tri(j, j)] += dsdiag;
#pragma unroll
    for (int t = 0; t < j; ++t) dL[j][t] -= 2.0f * dsdiag * f.L[j][t];
  }
}

// Step 3 of one edge in reverse: A = sum_k w b b^T (+ lam I) to the
// weight (added to dw) and the basis, the basis to u and v (added to du,
// dv: final). Given A's cotangent dA (packed) and the edge's weight w.
WLS_FN void normal_bwd(float w, const Edge& e, const float* dA, float& dw,
                       float& du, float& dv) {
  float bs[NB], dbs[NB];
  basis(e.u, e.v, bs);
#pragma unroll
  for (int i = 0; i < NB; ++i) dbs[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int j = i; j < NB; ++j) {
      const float t = dA[tri(i, j)];
      dw += t * bs[i] * bs[j];
      dbs[i] += t * w * bs[j];
      dbs[j] += t * w * bs[i];
    }
  du += dbs[1] + 2.0f * e.u * dbs[3] + e.v * dbs[4];
  dv += dbs[2] + e.u * dbs[4] + 2.0f * e.v * dbs[5];
}

// Step 1 of one edge in reverse: w = r / max(sum r, 1e-5), r = exp(-(dist^2)
// / denom) * mask, denom = max((kernel_width avg)^2, 1e-20). Given the
// weight's cotangent dw and the weight sum's dsum; the cotangents of
// dist, mask and avg (planes 2, 4, 11, final).
WLS_FN void weight_bwd(const Fit& f, const Edge& e, float kernel_width,
                       float dw, float dsum, float& ddist, float& dmask,
                       float& davg) {
  const float kwa = kernel_width * e.avg;
  const float denom = fmaxf(kwa * kwa, 1e-20f);
  const float ex = expf(-(e.dist * e.dist) / denom);
  const float dr = dw / f.wden + dsum;
  const float darg = dr * e.mask * ex;
  const float ddenom = darg * (e.dist * e.dist) / (denom * denom);
  ddist = darg * (-(2.0f * e.dist) / denom);
  dmask = dr * ex;
  davg = ddenom * gate(kwa * kwa, 1e-20f) * 2.0f * kwa * kernel_width;
}

// The weight sum's cotangent from sum_k dw_k w_k.
WLS_FN float wsum_bwd(const Fit& f, float dot) {
  return -(dot / f.wden) * f.wgate;
}

// The VJP of wls_point, one thread over all K edges.
// `cot(k, ctg1, ctg2, ctd1, ctd2)` gives edge k's cotangents; `de(p, k)`
// is a float& to the output cotangent of plane p of edge k, which this
// function also uses as scratch between its passes (planes 0-3 before
// their final values).
template <class Src, class Cot, class De>
WLS_FN void wls_point_bwd(const Src& src, const Cot& cot, De de, int K,
                          float kernel_width, float regularizer) {
  Fit f;
  // The forward fit; each edge's grad coefficients parked in planes 2-3.
  fit(src, K, kernel_width, regularizer, f, [&](int k, const float* z) {
    de(2, k) = z[1];
    de(3, k) = z[2];
  });

  // Steps 9-7 and 6's partials. Planes 5-10 are final here; 0-1 take u's
  // and v's first terms, 2-3 the cotangents of z[1] and z[2] so far.
  float dc[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) dc[i] = 0.0f;
  for (int k = 0; k < K; ++k) {
    float ctg1, ctg2, t1, t2;
    cot(k, ctg1, ctg2, t1, t2);
    FrameBwd o;
    frame_bwd(f, src(k), de(2, k), de(3, k), ctg1, ctg2, t1, t2, dc, o);
    de(5, k) = o.dxx;
    de(6, k) = o.dxy;
    de(7, k) = o.dyx;
    de(8, k) = o.dyy;
    de(9, k) = o.dnx;
    de(10, k) = o.dny;
    de(0, k) = o.du;
    de(1, k) = o.dv;
    de(2, k) = o.dg1;
    de(3, k) = o.dg2;
  }

  // Steps 6-5 per edge; plane 3 final, plane 2 the weight's cotangent.
  float dL[NB][NB], dinv[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    dinv[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NB; ++j) dL[i][j] = 0.0f;
  }
  for (int k = 0; k < K; ++k) {
    const Edge e = src(k);
    float dpatch, dw;
    solve_bwd(f, raw_weight(e, kernel_width) / f.wden, e, dc, de(2, k),
              de(3, k), dL, dinv, de(0, k), de(1, k), dpatch, dw);
    de(3, k) = dpatch;
    de(2, k) = dw;
  }

  float dA[NA];
  factor_bwd(f, dL, dinv, dA);

  // Step 3 reversed per edge: u and v final. The weight's cotangent stays
  // in plane 2, and its sum against the weights gives that of the weight
  // sum.
  float dot = 0.0f;
  for (int k = 0; k < K; ++k) {
    const Edge e = src(k);
    const float w = raw_weight(e, kernel_width) / f.wden;
    float dw = de(2, k);
    normal_bwd(w, e, dA, dw, de(0, k), de(1, k));
    de(2, k) = dw;
    dot += dw * w;
  }

  const float dsum = wsum_bwd(f, dot);
  for (int k = 0; k < K; ++k)
    weight_bwd(f, src(k), kernel_width, de(2, k), dsum, de(2, k), de(4, k),
               de(11, k));
}

// ---- The split walkers: a point's K edges over S slices ----
//
// Slice s (of S) of a point holds its edges k = s, s + S, ..., E slots,
// read once from `src` into registers; a slot with k >= K, or every slot
// of a point that is not `live` (outside the cloud), reads nothing and
// adds nothing. Every sum over K is the slice's sum over its slots in
// order, then `sum.template add<n>(v)`: the S slices' n partials added in
// slice order, the totals back in v in every slice. So every slice sees
// the same bits of every sum, factors the same matrix (each slice
// redundantly) and two calls give the same bits. `sum` also orders the
// slices: it must include a barrier after its reads.

// Steps 1-6 over the slots: the slots' edges, the fit, each slot's
// normalized weight w and grad row (g1, g2).
template <int E, class Src, class Sum>
WLS_FN void split_fit(const Src& src, int s, int S, int K, bool live,
                      float kernel_width, float regularizer, Sum& sum,
                      Edge* e, bool* on, Fit& f, float* w, float* g1,
                      float* g2) {
#pragma unroll
  for (int j = 0; j < E; ++j) {
    on[j] = live && s + j * S < K;
    e[j] = on[j] ? src(s + j * S) : Edge{};
  }
  float ws[1] = {0.0f};
#pragma unroll
  for (int j = 0; j < E; ++j) {
    w[j] = raw_weight(e[j], kernel_width);
    if (on[j]) ws[0] += w[j];
  }
  sum.template add<1>(ws);
  set_wden(ws[0], f);

  float A[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) A[i] = 0.0f;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    w[j] = w[j] / f.wden;
    if (on[j]) {
      float bs[NB];
      basis(e[j].u, e[j].v, bs);
      add_normal(w[j], bs, A);
    }
  }
  sum.template add<NA>(A);
  factor(A, regularizer, f);

  float c[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) c[i] = 0.0f;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    float bs[NB], rhs[NB], y[NB], z[NB];
    edge_solve(f, w[j], e[j], bs, rhs, y, z);
    g1[j] = z[1];
    g2[j] = z[2];
    if (on[j]) {
#pragma unroll
      for (int i = 0; i < NB; ++i) c[i] += z[i] * e[j].patch;
    }
  }
  sum.template add<NB>(c);
#pragma unroll
  for (int i = 0; i < NB; ++i) f.c[i] = c[i];
}

// The forward over slice s's slots: out(k, g1, g2, d1, d2) receives each
// of its edges' grad and div coefficients.
template <int E, class Src, class Sum, class Out>
WLS_FN void wls_split(const Src& src, int s, int S, int K, bool live,
                      float kernel_width, float regularizer, Sum& sum,
                      Out out) {
  Edge e[E];
  bool on[E];
  float w[E], g1[E], g2[E];
  Fit f;
  split_fit<E>(src, s, S, K, live, kernel_width, regularizer, sum, e, on, f,
               w, g1, g2);
#pragma unroll
  for (int j = 0; j < E; ++j) {
    if (!on[j]) continue;
    Frame r;
    frame(f, e[j], r);
    float d1, d2;
    div_row(r, g1[j], g2[j], d1, d2);
    out(s + j * S, g1[j], g2[j], d1, d2);
  }
}

// The fused eval build over slice s's slots: wls_split on the gathered
// edges, out(k, g1, g2, d1, d2) as there; returns the point's row norm
// sqrt(s1^2 + s2^2), s_d = sum_k |g_d|, each sum the slice's over its
// slots in order and then across the slices by `sum` (the same bits in
// every call).
template <int E, class Sum, class Out>
WLS_FN float fused_split(const GatherSrc& src, int s, int S, int K, bool live,
                         float kernel_width, float regularizer, Sum& sum,
                         Out out) {
  float sa[2] = {0.0f, 0.0f};
  wls_split<E>(src, s, S, K, live, kernel_width, regularizer, sum,
               [&](int k, float g1, float g2, float d1, float d2) {
                 sa[0] += fabsf(g1);
                 sa[1] += fabsf(g2);
                 out(k, g1, g2, d1, d2);
               });
  sum.template add<2>(sa);
  return sqrtf(sa[0] * sa[0] + sa[1] * sa[1]);
}

// The VJP over slice s's slots: `cot(k, ctg1, ctg2, ctd1, ctd2)` gives
// edge k's cotangents (read once, with the planes); `de(p, k)` a float&
// to the output cotangent of plane p of edge k, each written once. The
// scratch between the steps stays in registers.
template <int E, class Src, class Cot, class Sum, class De>
WLS_FN void wls_split_bwd(const Src& src, const Cot& cot, int s, int S,
                          int K, bool live, float kernel_width,
                          float regularizer, Sum& sum, De de) {
  float ct[E][4];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    ct[j][0] = ct[j][1] = ct[j][2] = ct[j][3] = 0.0f;
    if (live && s + j * S < K)
      cot(s + j * S, ct[j][0], ct[j][1], ct[j][2], ct[j][3]);
  }
  Edge e[E];
  bool on[E];
  float w[E], g1[E], g2[E];
  Fit f;
  split_fit<E>(src, s, S, K, live, kernel_width, regularizer, sum, e, on, f,
               w, g1, g2);

  // Steps 9-7 and 6's partials; planes 5-10 written.
  float dc[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) dc[i] = 0.0f;
  float du[E], dv[E], dg1[E], dg2[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    du[j] = dv[j] = dg1[j] = dg2[j] = 0.0f;
    if (!on[j]) continue;
    const int k = s + j * S;
    FrameBwd o;
    frame_bwd(f, e[j], g1[j], g2[j], ct[j][0], ct[j][1], ct[j][2], ct[j][3],
              dc, o);
    de(5, k) = o.dxx;
    de(6, k) = o.dxy;
    de(7, k) = o.dyx;
    de(8, k) = o.dyy;
    de(9, k) = o.dnx;
    de(10, k) = o.dny;
    du[j] = o.du;
    dv[j] = o.dv;
    dg1[j] = o.dg1;
    dg2[j] = o.dg2;
  }
  sum.template add<NB>(dc);

  // Steps 6-5; plane 3 written. dL's strictly lower triangle and dinv are
  // summed as one packed vector.
  float dL[NB][NB], dinv[NB], dw[E];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    dinv[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NB; ++j) dL[i][j] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < E; ++j) {
    dw[j] = 0.0f;
    if (!on[j]) continue;
    float dpatch;
    solve_bwd(f, w[j], e[j], dc, dg1[j], dg2[j], dL, dinv, du[j], dv[j],
              dpatch, dw[j]);
    de(3, s + j * S) = dpatch;
  }
  float packed[NA];
  {
    int t = 0;
#pragma unroll
    for (int i = 1; i < NB; ++i)
#pragma unroll
      for (int j = 0; j < i; ++j) packed[t++] = dL[i][j];
#pragma unroll
    for (int i = 0; i < NB; ++i) packed[t++] = dinv[i];
  }
  sum.template add<NA>(packed);
  {
    int t = 0;
#pragma unroll
    for (int i = 1; i < NB; ++i)
#pragma unroll
      for (int j = 0; j < i; ++j) dL[i][j] = packed[t++];
#pragma unroll
    for (int i = 0; i < NB; ++i) dinv[i] = packed[t++];
  }

  float dA[NA];
  factor_bwd(f, dL, dinv, dA);

  // Step 3 reversed; planes 0-1 written.
  float dot[1] = {0.0f};
#pragma unroll
  for (int j = 0; j < E; ++j) {
    if (!on[j]) continue;
    normal_bwd(w[j], e[j], dA, dw[j], du[j], dv[j]);
    de(0, s + j * S) = du[j];
    de(1, s + j * S) = dv[j];
    dot[0] += dw[j] * w[j];
  }
  sum.template add<1>(dot);

  // Step 1 reversed; planes 2, 4 and 11 written.
  const float dsum = wsum_bwd(f, dot[0]);
#pragma unroll
  for (int j = 0; j < E; ++j) {
    if (!on[j]) continue;
    const int k = s + j * S;
    weight_bwd(f, e[j], kernel_width, dw[j], dsum, de(2, k), de(4, k),
               de(11, k));
  }
}

}  // namespace wls
