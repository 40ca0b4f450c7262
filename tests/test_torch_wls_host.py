"""The WLS kernels' per-point math (``csrc/wls_body.cuh``) compiled as
plain C++ for the host and held against the plain PyTorch versions on the
CPU, before any card runs it.

``wls_body.cuh`` compiles without ``__CUDACC__``. A small harness
(``_HARNESS`` below, built with the host's C++ compiler into a shared
library loaded with ``ctypes``) runs both walkers of the header over a
batch of edge planes:

- the direct route's ``wls_point`` / ``wls_point_bwd``, a loop over the
  points;
- the split route's ``wls_split`` / ``wls_split_bwd``, each point's K
  edges over S slices of E slots: S host threads, each one slice of every
  point in turn, their sums over K passed through a shared buffer between
  two barriers (``std::barrier``), as the kernel's warps pass them through
  shared memory between two ``__syncthreads``;
- the fused eval build's walkers on ``GatherSrc`` (each edge's neighbour
  rows gathered from the cloud's ``[N, 3]`` rows, its planes formed on the
  fly): ``fused_split`` over S host threads as above (the row norm's sums
  too), and ``wls_point`` over all K edges (the direct route), held
  against ``fused_gather_wls_plain``.

Tolerances, as on the card: the forward within 1e-5 absolute of
``wls_plain`` (FMA contraction and the K sums' order), the VJP's planes
each within 1e-4 x its max of ``wls_bwd_plain`` (the same VJP in another
order). The split route's sums are in a fixed order, so two calls give
the same bits. Skipped where the host has no C++ compiler.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from deltaconv_tpu_torch import ops
from deltaconv_tpu_torch.geometry import build_tangent_basis, knn
from deltaconv_tpu_torch.ops.wls_fused import edge_planes

torch.set_num_threads(1)

_CSRC = Path(ops.__file__).resolve().parent.parent / "csrc"

_HARNESS = r"""
#include <barrier>
#include <thread>
#include <vector>

#include "wls_body.cuh"

namespace {

struct HostSrc {
  const float* e;
  long long plane;
  int N;
  wls::Edge operator()(int k) const {
    const float* p = e + (long long)k * N;
    return {p[0],         p[plane],     p[2 * plane], p[3 * plane],
            p[4 * plane], p[5 * plane], p[6 * plane], p[7 * plane],
            p[8 * plane], p[9 * plane], p[10 * plane], p[11 * plane]};
  }
};

// The slices' sums of one point: each slice's partials into buf[s][i], a
// barrier, every slice adds them in slice order, a barrier.
struct HostSum {
  float* buf;
  int s, S;
  std::barrier<>* bar;
  template <int n>
  void add(float* v) {
    for (int i = 0; i < n; ++i) buf[s * wls::NA + i] = v[i];
    bar->arrive_and_wait();
    for (int i = 0; i < n; ++i) {
      float t = buf[i];
      for (int q = 1; q < S; ++q) t += buf[q * wls::NA + i];
      v[i] = t;
    }
    bar->arrive_and_wait();
  }
};

template <int E>
void split(const float* edges, const float* ctg, const float* ctd, float* g,
           float* d, float* de, int B, int K, int N, int S, float kw,
           float reg) {
  const long long plane = (long long)K * N;
  std::vector<float> buf(S * wls::NA);
  std::barrier<> bar(S);
  std::vector<std::thread> slices;
  for (int s = 0; s < S; ++s)
    slices.emplace_back([&, s] {
      HostSum sum{buf.data(), s, S, &bar};
      for (int b = 0; b < B; ++b)
        for (int n = 0; n < N; ++n) {
          const HostSrc src{edges + b * 12 * plane + n, plane, N};
          if (de == nullptr) {
            float* gb = g + b * 2 * plane + n;
            float* db = d + b * 2 * plane + n;
            wls::wls_split<E>(
                src, s, S, K, true, kw, reg, sum,
                [&](int k, float g1, float g2, float d1, float d2) {
                  gb[(long long)k * N] = g1;
                  gb[plane + (long long)k * N] = g2;
                  db[(long long)k * N] = d1;
                  db[plane + (long long)k * N] = d2;
                });
          } else {
            const float* cg = ctg + b * 2 * plane + n;
            const float* cd = ctd + b * 2 * plane + n;
            float* out = de + b * 12 * plane + n;
            wls::wls_split_bwd<E>(
                src,
                [&](int k, float& g1, float& g2, float& d1, float& d2) {
                  const long long o = (long long)k * N;
                  g1 = cg[o];
                  g2 = cg[plane + o];
                  d1 = cd[o];
                  d2 = cd[plane + o];
                },
                s, S, K, true, kw, reg, sum,
                [&](int p, int k) -> float& {
                  return out[p * plane + (long long)k * N];
                });
          }
        }
    });
  for (auto& t : slices) t.join();
}

}  // namespace

extern "C" int host_wls_split(const float* edges, const float* ctg,
                              const float* ctd, float* g, float* d, float* de,
                              int B, int K, int N, int S, float kw,
                              float reg) {
  switch ((K + S - 1) / S) {
    case 1: split<1>(edges, ctg, ctd, g, d, de, B, K, N, S, kw, reg); break;
    case 2: split<2>(edges, ctg, ctd, g, d, de, B, K, N, S, kw, reg); break;
    case 3: split<3>(edges, ctg, ctd, g, d, de, B, K, N, S, kw, reg); break;
    case 4: split<4>(edges, ctg, ctd, g, d, de, B, K, N, S, kw, reg); break;
    case 5: split<5>(edges, ctg, ctd, g, d, de, B, K, N, S, kw, reg); break;
    default: return 1;
  }
  return 0;
}

namespace {

template <int E>
void fused(const float* pos, const float* nrm, const float* xb,
           const float* yb, const int* idx, const unsigned char* mask,
           const float* avg, float* gc, float* dc, float* rn, int B, int N,
           int K, int S, float kw, float reg) {
  const long long plane = (long long)N * K;
  std::vector<float> buf(S * wls::NA);
  std::barrier<> bar(S);
  std::vector<std::thread> slices;
  for (int s = 0; s < S; ++s)
    slices.emplace_back([&, s] {
      HostSum sum{buf.data(), s, S, &bar};
      for (int b = 0; b < B; ++b)
        for (int n = 0; n < N; ++n) {
          const long long cloud = (long long)b * N * 3;
          const long long row = ((long long)b * N + n) * K;
          const wls::GatherSrc src =
              wls::gather_src(pos + cloud, nrm + cloud, xb + cloud,
                              yb + cloud, idx + row, mask + row, N, avg[b]);
          float* g = gc + b * 2 * plane + (long long)n * K;
          float* d = dc + b * 2 * plane + (long long)n * K;
          const float r = wls::fused_split<E>(
              src, s, S, K, true, kw, reg, sum,
              [&](int k, float g1, float g2, float d1, float d2) {
                g[k] = g1;
                g[plane + k] = g2;
                d[k] = d1;
                d[plane + k] = d2;
              });
          if (s == 0) rn[(long long)b * N + n] = r;
        }
    });
  for (auto& t : slices) t.join();
}

}  // namespace

// The fused eval build over S slices, or with S 0 through wls_point (the
// direct route: one walker over all K edges, the row norm's sums in edge
// order).
extern "C" int host_fused(const float* pos, const float* nrm,
                          const float* xb, const float* yb, const int* idx,
                          const unsigned char* mask, const float* avg,
                          float* gc, float* dc, float* rn, int B, int N, int K,
                          int S, float kw, float reg) {
  if (S > 0) {
    switch ((K + S - 1) / S) {
      case 1: fused<1>(pos, nrm, xb, yb, idx, mask, avg, gc, dc, rn, B, N, K,
                       S, kw, reg); break;
      case 2: fused<2>(pos, nrm, xb, yb, idx, mask, avg, gc, dc, rn, B, N, K,
                       S, kw, reg); break;
      case 3: fused<3>(pos, nrm, xb, yb, idx, mask, avg, gc, dc, rn, B, N, K,
                       S, kw, reg); break;
      case 4: fused<4>(pos, nrm, xb, yb, idx, mask, avg, gc, dc, rn, B, N, K,
                       S, kw, reg); break;
      case 5: fused<5>(pos, nrm, xb, yb, idx, mask, avg, gc, dc, rn, B, N, K,
                       S, kw, reg); break;
      default: return 1;
    }
    return 0;
  }
  const long long plane = (long long)N * K;
  for (int b = 0; b < B; ++b)
    for (int n = 0; n < N; ++n) {
      const long long cloud = (long long)b * N * 3;
      const long long row = ((long long)b * N + n) * K;
      const wls::GatherSrc src =
          wls::gather_src(pos + cloud, nrm + cloud, xb + cloud, yb + cloud,
                          idx + row, mask + row, N, avg[b]);
      float* g = gc + b * 2 * plane + (long long)n * K;
      float* d = dc + b * 2 * plane + (long long)n * K;
      float s1 = 0.0f, s2 = 0.0f;
      wls::wls_point(
          src, K, kw, reg,
          [&](int k, float g1, float g2) {
            g[k] = g1;
            g[plane + k] = g2;
            s1 += fabsf(g1);
            s2 += fabsf(g2);
          },
          [&](int k, float& g1, float& g2) {
            g1 = g[k];
            g2 = g[plane + k];
          },
          [&](int k, float, float, float d1, float d2) {
            d[k] = d1;
            d[plane + k] = d2;
          });
      rn[(long long)b * N + n] = sqrtf(s1 * s1 + s2 * s2);
    }
  return 0;
}

extern "C" void host_wls_point(const float* edges, const float* ctg,
                               const float* ctd, float* g, float* d,
                               float* de, int B, int K, int N, float kw,
                               float reg) {
  const long long plane = (long long)K * N;
  for (int b = 0; b < B; ++b)
    for (int n = 0; n < N; ++n) {
      const HostSrc src{edges + b * 12 * plane + n, plane, N};
      if (de == nullptr) {
        float* gb = g + b * 2 * plane + n;
        float* db = d + b * 2 * plane + n;
        wls::wls_point(
            src, K, kw, reg,
            [&](int k, float g1, float g2) {
              gb[(long long)k * N] = g1;
              gb[plane + (long long)k * N] = g2;
            },
            [&](int k, float& g1, float& g2) {
              g1 = gb[(long long)k * N];
              g2 = gb[plane + (long long)k * N];
            },
            [&](int k, float, float, float d1, float d2) {
              db[(long long)k * N] = d1;
              db[plane + (long long)k * N] = d2;
            });
      } else {
        const float* cg = ctg + b * 2 * plane + n;
        const float* cd = ctd + b * 2 * plane + n;
        float* out = de + b * 12 * plane + n;
        wls::wls_point_bwd(
            src,
            [&](int k, float& g1, float& g2, float& d1, float& d2) {
              const long long o = (long long)k * N;
              g1 = cg[o];
              g2 = cg[plane + o];
              d1 = cd[o];
              d2 = cd[plane + o];
            },
            [&](int p, int k) -> float& {
              return out[p * plane + (long long)k * N];
            },
            K, kw, reg);
      }
    }
}
"""

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler on the host")
    tmp = tmp_path_factory.mktemp("wls_host")
    (tmp / "harness.cpp").write_text(_HARNESS)
    lib = tmp / "libwls_host.so"
    subprocess.run([cxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread",
                    "-I", str(_CSRC), "-o", str(lib),
                    str(tmp / "harness.cpp")], check=True)
    so = ctypes.CDLL(str(lib))
    so.host_wls_split.argtypes = [_P] * 6 + [_I] * 4 + [_F] * 2
    so.host_wls_split.restype = _I
    so.host_wls_point.argtypes = [_P] * 6 + [_I] * 3 + [_F] * 2
    so.host_wls_point.restype = None
    so.host_fused.argtypes = [_P] * 10 + [_I] * 4 + [_F] * 2
    so.host_fused.restype = _I
    return so


def _ptr(t):
    return None if t is None else t.data_ptr()


def _run(so, edges, ctg=None, ctd=None, slices=0):
    """The forward (``ctg`` None: ``(g, d)``) or the VJP of the header's
    split walker over ``slices`` slices, or its direct walker (0)."""
    b, _, k, n = edges.shape
    g = torch.full((b, 2, k, n), float("nan"))
    d = torch.full_like(g, float("nan"))
    de = None if ctg is None else torch.full_like(edges, float("nan"))
    args = [_ptr(edges), _ptr(ctg), _ptr(ctd), _ptr(g), _ptr(d), _ptr(de),
            b, k, n]
    if slices:
        assert so.host_wls_split(*args, slices, 1.0, 1e-3) == 0
    else:
        so.host_wls_point(*args, 1.0, 1e-3)
    return (g, d) if ctg is None else de


def _cloud(case, k, n=70, b=2, seed=0):
    """``b`` ellipsoid clouds of ``n`` points with their normals and
    tangent frames and a kNN graph of ``k`` neighbours, as ``(pos, normal,
    x_basis, y_basis, idx, mask)``: ``uniform``; ``masked`` (cloud 0's
    second half padded, and one point whose every edge is masked, its
    weight sum at the 1e-5 clamp); ``duplicate`` (a neighbour at distance 0
    of its point); ``flat`` (cloud 1 nearly flat, its normals up)."""
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((b, n, 3)).astype(np.float32)
    pos /= np.linalg.norm(pos, axis=-1, keepdims=True)
    axes = rng.uniform(0.5, 1.5, (b, 1, 3)).astype(np.float32)
    nrm = pos / axes
    pos *= axes
    if case == "flat":
        pos[1, :, 2] *= 1e-3
        nrm[1] = (0.0, 0.0, 1.0)
    if case == "duplicate":
        pos[0, 1] = pos[0, 0]
        pos[1, 5:9] = pos[1, 4]
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    pos, nrm = torch.from_numpy(pos), torch.from_numpy(nrm)
    pm = None
    if case == "masked":
        pm = torch.ones((b, n), dtype=torch.bool)
        pm[0, n // 2:] = False
    idx, mask = knn(pos, k, pm)
    if pm is not None:
        mask = mask & pm[:, :, None]
        mask[1, 3] = False  # a point with no valid edge
    xb, yb = build_tangent_basis(nrm)
    return pos, nrm, xb, yb, idx, mask


def _edges(case, k, n=70, b=2, seed=0):
    """The edge planes of :func:`_cloud`'s clouds."""
    pos, nrm, xb, yb, idx, mask = _cloud(case, k, n, b, seed)
    return edge_planes(pos, nrm, xb, yb, idx, mask,
                       mask.any(dim=2).to(torch.float32)).contiguous()


def _cotangents(edges, seed=1):
    b, _, k, n = edges.shape
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(
        rng.standard_normal((b, 2, k, n)).astype(np.float32))
        for _ in range(2))


def _planes_close(got, want, rel):
    assert bool(torch.isfinite(got).all())
    for p in range(got.shape[1]):
        tol = rel * max(float(want[:, p].abs().max()), 1e-30)
        torch.testing.assert_close(got[:, p], want[:, p], rtol=0, atol=tol,
                                   msg=f"plane {p}")


# (case, K, S): the model shapes' routes (K=20 on 4 slices of 5 slots,
# K=30 on 6), K not a multiple of S (13 on 3 slices: 5 slots, 2 empty),
# one slice, one edge, and the hard neighbourhoods at the model's K.
_CASES = [("uniform", 20, 4), ("uniform", 30, 6), ("uniform", 13, 3),
          ("uniform", 9, 2), ("uniform", 12, 8), ("uniform", 5, 1),
          ("uniform", 1, 1), ("masked", 20, 4), ("duplicate", 20, 4),
          ("flat", 20, 4), ("masked", 30, 7)]


@pytest.mark.parametrize("case,k,slices", _CASES)
def test_wls_split_forward_matches_plain(harness, case, k, slices):
    edges = _edges(case, k)
    want = ops.wls_plain(edges, 1.0, 1e-3)
    got = _run(harness, edges, slices=slices)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-5)
    again = _run(harness, edges, slices=slices)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("case,k,slices", _CASES)
def test_wls_split_bwd_matches_plain(harness, case, k, slices):
    edges = _edges(case, k)
    ctg, ctd = _cotangents(edges)
    want = ops.wls_bwd_plain(edges, ctg, ctd, 1.0, 1e-3)
    got = _run(harness, edges, ctg, ctd, slices)
    _planes_close(got, want, 1e-4)
    assert torch.equal(got, _run(harness, edges, ctg, ctd, slices))


@pytest.mark.parametrize("case", ["uniform", "masked", "duplicate", "flat"])
def test_wls_direct_body_matches_plain(harness, case):
    """The direct route's walkers (one thread over all K edges) on the
    same reverse steps as the split route."""
    edges = _edges(case, 20)
    for a, w in zip(_run(harness, edges), ops.wls_plain(edges, 1.0, 1e-3)):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-5)
    ctg, ctd = _cotangents(edges)
    _planes_close(_run(harness, edges, ctg, ctd),
                  ops.wls_bwd_plain(edges, ctg, ctd, 1.0, 1e-3), 1e-4)


def test_wls_split_fully_masked_point(harness):
    """A point with no valid edge: its weight sum at the 1e-5 clamp, where
    no derivative passes; zero grad and div rows, and its cotangents
    (scaled by 1 / 1e-5) each plane within 1e-4 x the point's max of the
    plain version's."""
    edges = _edges("masked", 20)
    assert float(edges[1, 4, :, 3].abs().max()) == 0.0
    g, d = _run(harness, edges, slices=4)
    assert float(g[1, :, :, 3].abs().max()) == 0.0
    assert float(d[1, :, :, 3].abs().max()) == 0.0
    ctg, ctd = _cotangents(edges)
    de = _run(harness, edges, ctg, ctd, 4)
    want = ops.wls_bwd_plain(edges, ctg, ctd, 1.0, 1e-3)
    _planes_close(de[1:, :, :, 3:4], want[1:, :, :, 3:4], 1e-4)


def _fused(so, pos, nrm, xb, yb, idx, mask, avg, slices):
    """The fused eval build of the header's walkers on ``GatherSrc``:
    ``fused_split`` over ``slices`` slices, or ``wls_point`` (0)."""
    b, n, k = idx.shape
    gc = torch.full((b, 2, n, k), float("nan"))
    dc = torch.full_like(gc, float("nan"))
    rn = torch.full((b, n), float("nan"))
    mask_u8 = mask.contiguous().view(torch.uint8)
    assert so.host_fused(*(_ptr(t) for t in (pos, nrm, xb, yb, idx, mask_u8,
                                             avg, gc, dc, rn)),
                         b, n, k, slices, 1.0, 1e-3) == 0
    return gc, dc, rn


# (case, K, S): the fused build's split route at the model shapes (K=20 on
# 4 slices, K=30 on 6), masked clouds at both, a hard neighbourhood, K not
# a multiple of S, and the direct route (S 0) at K=20 and K=30.
_FUSED_CASES = [("uniform", 20, 4), ("masked", 20, 4), ("uniform", 30, 6),
                ("masked", 30, 6), ("duplicate", 20, 4), ("uniform", 13, 3),
                ("masked", 20, 0), ("masked", 30, 0)]


@pytest.mark.parametrize("case,k,slices", _FUSED_CASES)
def test_fused_gather_split_matches_plain(harness, case, k, slices):
    """The fused build's walker on gathered rows (``GatherSrc``) against
    ``fused_gather_wls_plain``: the coefficients within 1e-5 absolute, the
    row norms (sums of K |g| of up to ~10) within 1e-5 relative, as on the
    card; a second call bit-equal."""
    pos, nrm, xb, yb, idx, mask = _cloud(case, k)
    valid = mask.float()
    dist = (pos[:, :, None] - torch.gather(
        pos[:, None].expand(-1, pos.shape[1], -1, -1), 2,
        idx.long()[..., None].expand(-1, -1, -1, 3))).norm(dim=-1)
    avg = ((dist * valid).sum(dim=(1, 2))
           / valid.sum(dim=(1, 2)).clamp(min=1.0)).contiguous()
    want = ops.fused_gather_wls_plain(pos, nrm, xb, yb, idx, mask, avg)
    got = _fused(harness, pos, nrm, xb, yb, idx, mask, avg, slices)
    for a, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-5)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    again = _fused(harness, pos, nrm, xb, yb, idx, mask, avg, slices)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
