// Top-K selection against a threshold in registers, shared by the kNN
// kernels (knn_topk.cu, knn_table.cu, knn_bucketed.cu).
//
// A selecting thread keeps its best entries in a sorted register list
// (best first) of kCap entries, the first kCap - ks of them sentinels
// that nothing passes, so that the list's last entry is the ks-th best:
// the threshold sits at a fixed register (an entry picked at a runtime
// index would put the list in local memory). A candidate is compared once
// with the threshold; only those that pass go to a short per-thread queue
// in shared memory, and when a queue of the warp fills, every lane merges
// its queue into its list at once (an insertion is a fully unrolled
// shift), so the warp pays one merge for up to 32 lanes' candidates.
// `front` and `take` then read the list (or a group's lists) in order.
//
// Three kinds of list:
// * kScoreId: (score, id) pairs ordered by score descending, then id
//   ascending (`before`);
// * kKeyId: unique int keys, descending, with an id carried along;
// * kKey: unique int keys alone (the id rides in the key's low bits).
//
// kGroup > 1 threads (adjacent lanes, a power of two) may hold one row's
// entries, each in its own list; `take` walks the union of the group's
// lists in order: ks rounds of "the group's best head, popped".
#pragma once

#include <climits>
#include <cmath>

namespace dc_select {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kQueue = 12;   // a lane's queue of passing candidates
constexpr int kFlushAt = 4;  // merge when a queue holds more (8 a step)

// (s, i) comes before (t, j): score descending, then index ascending.
__device__ __forceinline__ bool before(float s, int i, float t, int j) {
  return s > t || (s == t && i < j);
}

// Inserts (v, o) into the sorted list (best first); the last entry falls
// off. A no-op for an entry that does not beat the last one.
template <int kCap>
__device__ __forceinline__ void insert(float (&ls)[kCap], int (&li)[kCap],
                                       float v, int o) {
#pragma unroll
  for (int t = kCap - 1; t > 0; --t) {
    const bool up = before(v, o, ls[t - 1], li[t - 1]);
    const bool here = !up && before(v, o, ls[t], li[t]);
    ls[t] = up ? ls[t - 1] : (here ? v : ls[t]);
    li[t] = up ? li[t - 1] : (here ? o : li[t]);
  }
  if (before(v, o, ls[0], li[0])) {
    ls[0] = v;
    li[0] = o;
  }
}

// The same for unique int keys, the ids carried along.
template <int kCap>
__device__ __forceinline__ void insert(int (&lk)[kCap], int (&li)[kCap],
                                       int key, int o) {
#pragma unroll
  for (int t = kCap - 1; t > 0; --t) {
    const bool up = key > lk[t - 1];
    const bool here = !up && key > lk[t];
    lk[t] = up ? lk[t - 1] : (here ? key : lk[t]);
    li[t] = up ? li[t - 1] : (here ? o : li[t]);
  }
  if (key > lk[0]) {
    lk[0] = key;
    li[0] = o;
  }
}

// The same for unique int keys alone.
template <int kCap>
__device__ __forceinline__ void insert(int (&lk)[kCap], int key) {
#pragma unroll
  for (int t = kCap - 1; t > 0; --t) {
    const bool up = key > lk[t - 1];
    const bool here = !up && key > lk[t];
    lk[t] = up ? lk[t - 1] : (here ? key : lk[t]);
  }
  if (key > lk[0]) lk[0] = key;
}

// Packed keys: a floor on the scores whose scaled value t = fl(fl(s -
// rmin) * scale) reaches `level`: t >= level implies s >= rmin + level /
// scale / (1 + 2^-24)^2 > rmin + level / scale (1 - 2^-22), evaluated in
// double, lowered by a margin for its own rounding, and rounded down, so
// that the scan compares a score once instead of forming its key.
__device__ __forceinline__ float score_floor(float rmin, float scale,
                                             float level) {
  if (!(level > 0.0f)) return -INFINITY;
  const double step = (double)level / (double)scale;
  const double bound = (double)rmin + step * (1.0 - 0x1p-22);
  const double margin = 0x1p-50 * (fabs((double)rmin) + step);
  return __double2float_rd(bound - margin);
}

enum Kind { kScoreId, kKeyId, kKey };

// One thread's selection: its list in registers and its queue in shared
// memory (entry u of thread t at u * threads + t of each array).
template <Kind kKind, int kCap, int kGroup = 1>
struct Selector {
  static_assert(kGroup >= 1 && kGroup <= 32 && (kGroup & (kGroup - 1)) == 0,
                "a group is a power of two of adjacent lanes");
  // Bytes of one queue entry: (score, id), (key, id) or the key.
  static constexpr int kEntryBytes = kKind == kKey ? 4 : 8;

  float ls[kCap];
  int lk[kCap], li[kCap];
  float* qv;
  int *qk, *qi;
  int stride, qn;
  // Keys whose 16-bit level is q = trunc(t) + 1 of a scaled score t (or
  // q = trunc(t)) can pass the threshold key only if t >= min_t, its
  // level - 1: (key >> 16) + 32767, -1 while the list is not full.
  float min_t;

  __device__ __forceinline__ void init(int ks, unsigned char* queue,
                                       int threads, int tid) {
#pragma unroll
    for (int t = 0; t < kCap; ++t) {
      const bool sentinel = t < kCap - ks;
      ls[t] = sentinel ? INFINITY : -INFINITY;
      lk[t] = sentinel ? INT_MAX : INT_MIN;
      li[t] = sentinel ? -1 : INT_MAX;
    }
    stride = threads;
    qv = reinterpret_cast<float*>(queue) + tid;
    qk = reinterpret_cast<int*>(queue) + tid;
    qi = reinterpret_cast<int*>(queue) + kQueue * threads + tid;
    qn = 0;
    refresh();
  }

  // The threshold: the list's last entry.
  __device__ __forceinline__ float thr_s() const { return ls[kCap - 1]; }

  __device__ __forceinline__ bool passes(float v, int key, int o) const {
    return kKind == kScoreId ? before(v, o, ls[kCap - 1], li[kCap - 1])
                             : key > lk[kCap - 1];
  }

  // Straight into the list (no queue, no new threshold).
  __device__ __forceinline__ void add(float v, int key, int o) {
    if (kKind == kScoreId)
      insert<kCap>(ls, li, v, o);
    else if (kKind == kKeyId)
      insert<kCap>(lk, li, key, o);
    else
      insert<kCap>(lk, key);
  }

  __device__ __forceinline__ void push(float v, int key, int o) {
    if (kKind == kScoreId)
      qv[qn * stride] = v;
    else
      qk[qn * stride] = key;
    if (kKind != kKey) qi[qn * stride] = o;
    ++qn;
  }

  // min_t from the threshold key, after the list changed.
  __device__ __forceinline__ void refresh() {
    if (kKind != kScoreId) min_t = (float)((lk[kCap - 1] >> 16) + 32767);
  }

  // Every lane of the warp merges its queue (the warp's longest sets the
  // passes), then min_t is refreshed.
  __device__ __forceinline__ void flush() {
    const int passes = __reduce_max_sync(kFull, qn);
    for (int u = 0; u < passes; ++u) {
      if (u < qn) {
        if (kKind == kScoreId)
          insert<kCap>(ls, li, qv[u * stride], qi[u * stride]);
        else if (kKind == kKeyId)
          insert<kCap>(lk, li, qk[u * stride], qi[u * stride]);
        else
          insert<kCap>(lk, qk[u * stride]);
      }
    }
    qn = 0;
    refresh();
  }

  // Moves the list's best entry to index 0: a shift by kCap - ks, in
  // steps of fixed width (empty entries enter at the end).
  __device__ __forceinline__ void front(int ks) {
    const int d = kCap - ks;
#pragma unroll
    for (int e = 0; (1 << e) < kCap; ++e) {
      const int w = 1 << e;
      if (d & w) {
#pragma unroll
        for (int t = 0; t < kCap; ++t) {
          const int from = t + w < kCap ? t + w : t;
          const bool in = t + w < kCap;
          if (kKind == kScoreId) ls[t] = in ? ls[from] : -INFINITY;
          if (kKind != kScoreId) lk[t] = in ? lk[from] : INT_MIN;
          if (kKind != kKey) li[t] = in ? li[from] : INT_MAX;
        }
      }
    }
  }

  // After front(): the group's best remaining entry (score and id, or
  // key), which its owner pops. Every lane of the warp calls it; each gets
  // the entry.
  __device__ __forceinline__ void take(float& v, int& key, int& o) {
    static_assert(kKind != kKeyId, "take: (score, id) lists or keys");
    bool mine;
    if (kKind == kScoreId) {
      float s = ls[0];
      int i = li[0];
#pragma unroll
      for (int w = 1; w < kGroup; w <<= 1) {
        const float t = __shfl_xor_sync(kFull, s, w);
        const int j = __shfl_xor_sync(kFull, i, w);
        if (before(t, j, s, i)) {
          s = t;
          i = j;
        }
      }
      mine = ls[0] == s && li[0] == i;
      v = s;
      o = i;
    } else {
      int k = lk[0];
#pragma unroll
      for (int w = 1; w < kGroup; w <<= 1)
        k = max(k, __shfl_xor_sync(kFull, k, w));
      mine = lk[0] == k;
      key = k;
    }
#pragma unroll
    for (int t = 0; t < kCap; ++t) {
      const bool last = t == kCap - 1;
      const int from = last ? t : t + 1;
      if (kKind == kScoreId) {
        ls[t] = mine ? (last ? -INFINITY : ls[from]) : ls[t];
        li[t] = mine ? (last ? INT_MAX : li[from]) : li[t];
      } else {
        lk[t] = mine ? (last ? INT_MIN : lk[from]) : lk[t];
      }
    }
  }
};

}  // namespace dc_select
