// Geodesic farthest-point sampling on point clouds — native CPU
// preprocessing op (the reference keeps this stage native too:
// deltaconv/cpp/sampling.cpp, geometry-central KD-tree + Dijkstra).
//
// Re-implemented from scratch with zero third-party dependencies:
//  * a compact 3-D KD-tree for exact kNN (k neighbors + self in front)
//  * Dijkstra over the kNN graph from each newly selected sample into a
//    shared distance field; the next sample is the argmax of the field
//  * seedable RNG for the initial sample (the reference draws from an
//    unseeded std::random_device; pass seed < 0 for that behavior)
//
// C ABI for ctypes:
//   int geodesic_fps(const double* pts, int64 n, int64 n_samples,
//                    int64 knn_k, int64 seed, int32* out_idx);
//   int knn_graph_cpu(const double* pts, int64 n, int64 k,
//                     int32* out_idx);   // self-loop in slot 0
//
// Build: g++ -O3 -march=native -shared -fPIC -fopenmp geodesic_fps.cpp
//        -o libdeltaconv_fps.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <numeric>
#include <queue>
#include <random>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct KDTree {
  // Flat KD-tree over 3-D points: nodes are point indices arranged by
  // recursive median split.
  const double* pts;  // [n, 3]
  std::vector<int32_t> order;  // point index per tree slot
  std::vector<int8_t> axis;    // split axis per tree slot
  int64_t n;

  explicit KDTree(const double* p, int64_t count) : pts(p), n(count) {
    order.resize(n);
    axis.assign(n, 0);
    std::iota(order.begin(), order.end(), 0);
    build(0, n, 0);
  }

  void build(int64_t lo, int64_t hi, int depth) {
    if (hi - lo <= 1) return;
    // Pick the axis with the largest spread for better balance.
    double mn[3] = {1e300, 1e300, 1e300}, mx[3] = {-1e300, -1e300, -1e300};
    for (int64_t i = lo; i < hi; ++i) {
      const double* q = pts + 3 * order[i];
      for (int d = 0; d < 3; ++d) {
        mn[d] = std::min(mn[d], q[d]);
        mx[d] = std::max(mx[d], q[d]);
      }
    }
    int ax = 0;
    double best = mx[0] - mn[0];
    for (int d = 1; d < 3; ++d)
      if (mx[d] - mn[d] > best) { best = mx[d] - mn[d]; ax = d; }
    int64_t mid = lo + (hi - lo) / 2;
    std::nth_element(
        order.begin() + lo, order.begin() + mid, order.begin() + hi,
        [&](int32_t a, int32_t b) { return pts[3 * a + ax] < pts[3 * b + ax]; });
    axis[mid] = static_cast<int8_t>(ax);
    build(lo, mid, depth + 1);
    build(mid + 1, hi, depth + 1);
  }

  struct Hit {
    double d2;
    int32_t idx;
    bool operator<(const Hit& o) const { return d2 < o.d2; }
  };

  // k nearest neighbors of query point `qi` (excluding `qi` itself).
  void knn(int64_t qi, int64_t k, std::vector<Hit>& heap) const {
    heap.clear();
    const double* q = pts + 3 * qi;
    search(0, n, q, static_cast<int32_t>(qi), k, heap);
    std::sort_heap(heap.begin(), heap.end());
  }

  void search(int64_t lo, int64_t hi, const double* q, int32_t skip,
              int64_t k, std::vector<Hit>& heap) const {
    if (hi <= lo) return;
    int64_t mid = lo + (hi - lo) / 2;
    int32_t p = order[mid];
    if (p != skip) {
      const double* r = pts + 3 * p;
      double d2 = 0;
      for (int d = 0; d < 3; ++d) {
        double t = r[d] - q[d];
        d2 += t * t;
      }
      if (static_cast<int64_t>(heap.size()) < k) {
        heap.push_back({d2, p});
        std::push_heap(heap.begin(), heap.end());
      } else if (d2 < heap.front().d2) {
        std::pop_heap(heap.begin(), heap.end());
        heap.back() = {d2, p};
        std::push_heap(heap.begin(), heap.end());
      }
    }
    if (hi - lo == 1) return;
    int ax = axis[mid];
    double delta = q[ax] - pts[3 * p + ax];
    double worst = (static_cast<int64_t>(heap.size()) < k)
                       ? std::numeric_limits<double>::infinity()
                       : heap.front().d2;
    if (delta <= 0) {
      search(lo, mid, q, skip, k, heap);
      worst = (static_cast<int64_t>(heap.size()) < k)
                  ? std::numeric_limits<double>::infinity()
                  : heap.front().d2;
      if (delta * delta < worst) search(mid + 1, hi, q, skip, k, heap);
    } else {
      search(mid + 1, hi, q, skip, k, heap);
      worst = (static_cast<int64_t>(heap.size()) < k)
                  ? std::numeric_limits<double>::infinity()
                  : heap.front().d2;
      if (delta * delta < worst) search(lo, mid, q, skip, k, heap);
    }
  }
};

// kNN adjacency with self prepended (slot 0), matching the self-first
// convention used throughout the framework.
std::vector<int32_t> build_knn(const double* pts, int64_t n, int64_t k) {
  KDTree tree(pts, n);
  std::vector<int32_t> adj(n * (k + 1));
  int64_t kk = std::min(k, n - 1);
#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    std::vector<KDTree::Hit> heap;
    heap.reserve(kk + 1);
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 64)
#endif
    for (int64_t i = 0; i < n; ++i) {
      tree.knn(i, kk, heap);
      int32_t* row = adj.data() + i * (k + 1);
      row[0] = static_cast<int32_t>(i);
      for (int64_t j = 0; j < kk; ++j) row[1 + j] = heap[j].idx;
      for (int64_t j = kk; j < k; ++j) row[1 + j] = static_cast<int32_t>(i);
    }
  }
  return adj;
}

// Dijkstra from `source` into the shared distance field `dist` —
// relaxations only ever lower distances, so the field accumulates the
// min geodesic distance to the sample set.
void dijkstra_update(const double* pts, const std::vector<int32_t>& adj,
                     int64_t deg, int64_t source, std::vector<double>& dist) {
  using Pair = std::pair<double, int32_t>;
  std::priority_queue<Pair, std::vector<Pair>, std::greater<Pair>> pq;
  dist[source] = 0.0;
  pq.push({0.0, static_cast<int32_t>(source)});
  while (!pq.empty()) {
    auto [d, u] = pq.top();
    pq.pop();
    if (d > dist[u]) continue;
    const double* pu = pts + 3 * u;
    const int32_t* row = adj.data() + static_cast<int64_t>(u) * deg;
    for (int64_t j = 0; j < deg; ++j) {
      int32_t v = row[j];
      if (v == u) continue;
      const double* pv = pts + 3 * v;
      double w = 0;
      for (int d3 = 0; d3 < 3; ++d3) {
        double t = pv[d3] - pu[d3];
        w += t * t;
      }
      w = std::sqrt(w);
      if (d + w < dist[v]) {
        dist[v] = d + w;
        pq.push({dist[v], v});
      }
    }
  }
}

}  // namespace

extern "C" {

int knn_graph_cpu(const double* pts, int64_t n, int64_t k, int32_t* out) {
  if (n <= 0 || k <= 0) return 1;
  auto adj = build_knn(pts, n, k);
  // Drop the self slot: emit [n, k] neighbor indices with self at 0
  // already included in adj's k+1 layout; caller asked for k columns
  // including self.
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = 0; j < k; ++j) out[i * k + j] = adj[i * (k + 1) + j];
  return 0;
}

int geodesic_fps(const double* pts, int64_t n, int64_t n_samples,
                 int64_t knn_k, int64_t seed, int32_t* out) {
  if (n <= 0 || n_samples <= 0) return 1;
  if (n_samples > n) return 2;
  auto adj = build_knn(pts, n, knn_k);  // degree = knn_k + 1 (self first)
  const int64_t deg = knn_k + 1;

  std::vector<double> dist(n, std::numeric_limits<double>::infinity());

  std::mt19937 gen;
  if (seed < 0) {
    std::random_device rd;
    gen.seed(rd());
  } else {
    gen.seed(static_cast<uint32_t>(seed));
  }
  std::uniform_int_distribution<int64_t> pick(0, n - 1);
  out[0] = static_cast<int32_t>(pick(gen));

  for (int64_t s = 1; s < n_samples; ++s) {
    dijkstra_update(pts, adj, deg, out[s - 1], dist);
    out[s] = static_cast<int32_t>(
        std::max_element(dist.begin(), dist.end()) - dist.begin());
  }
  return 0;
}

}  // extern "C"
