// The matmul maxes with one product a row (gather_max_bf16.cu's
// `gather_matmul_max` and `gather_matmul_max_win`, gather_max_int8.cu's
// `gather_matmul_max_int8`; the design and its bound are described in
// gather_max_bf16.cu): a block takes one task, a cloud b and a slice of
// kCs output columns, computes y = bf16(x[b] @ w[:, slice]) for every row
// of the cloud into shared memory, then takes each point's masked max
// over its K slots out of that slice. x is bf16, or int8 (Tin): int8 rows
// land by cp.async in an int8 ring (half a bf16 stage's bytes) and each
// tile is widened once, in shared memory, into one bf16 tile (exact:
// |v| <= 127) before its ldmatrix reads, which take 16-bit elements only.
#pragma once

#include "gather_matmul_max.cuh"

namespace {

constexpr int kRowsWarps = 16;
constexpr int kTileRows = 128;    // x rows a ring stage: 8 m-tiles
constexpr int kMaxStages = 4;     // x ring stages, as many as fit
constexpr int kBRegSteps = 8;     // k-steps whose B fragments fit registers
constexpr int kRowsInFlight = 4;  // y rows a lane reads before its maxes
constexpr size_t kRowsSmemMax = 232448;  // a block's shared memory, H100
constexpr unsigned kNegInf2 = 0xFF80FF80u;  // two bf16 -inf
constexpr unsigned kNegInfF32 = 0xFF800000u;  // f32 -inf

// Row strides in bf16. An x row is padded by 16 bytes, a W-slice row to
// an odd number of 16-byte chunks, so that the 8 rows of an ldmatrix
// fall on 8 distinct bank groups.
__host__ __device__ inline int rows_ldx(int Cin) { return Cin + 8; }
__host__ __device__ inline int rows_ldw(int Cs) {
  return Cs >= 16 ? Cs + 8 : Cs;
}

// Shared memory of a block with `stages` ring stages: the y slice [N + 2,
// Cs] (row N zeros, the row of a valid slot outside the cloud; row N + 1
// -inf, the row of a masked slot), the affine slice [4, Cs] f32, the W
// slice [Cin, Cs] (padded), the x ring [stages][kTileRows, Cin] (padded
// bf16; for int8 x (in_bytes 1) unpadded int8 stages and one padded bf16
// tile). ops/gather_max.py (`mm_rows_smem`) mirrors it at two stages to
// choose the route.
inline size_t rows_smem_bytes(int N, int Cin, int Cs, int stages,
                              int in_bytes) {
  const size_t ring =
      in_bytes == 2
          ? (size_t)stages * kTileRows * rows_ldx(Cin) * 2
          : (size_t)stages * kTileRows * Cin +
                (size_t)kTileRows * rows_ldx(Cin) * 2;
  return (size_t)(N + 2) * Cs * 2 + (size_t)4 * Cs * 4 +
         (size_t)Cin * rows_ldw(Cs) * 2 + ring;
}

// The y slice keeps row r's 16-byte chunk c (channels 8c .. 8c + 7) at
// chunk c ^ ((r >> kShift) & (P - 1)) of the row, P = Cs / 8 chunks a
// row: the 8 rows of one accumulator store then land on 8 distinct bank
// groups, and a point's group of P lanes still reads its row whole.
// (gather_max.cu's staged slices keep their rows the same way.)
template <int P>
__device__ __forceinline__ int y_chunk(int r, int c) {
  constexpr int kShift = P == 8 ? 0 : P == 4 ? 1 : P == 2 ? 2 : 3;
  return c ^ ((r >> kShift) & (P - 1));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 8 or 4 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `stages` - 1 committed groups are in flight.
__device__ __forceinline__ void cp_async_wait(int stages) {
  if (stages >= 4)
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  else if (stages == 3)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ uint4 lds128(unsigned addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1,
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 0xFFFF in each half where a > b (false where either is NaN).
__device__ __forceinline__ unsigned bf16x2_gt(unsigned a, unsigned b) {
  unsigned r;
  asm("set.gt.u32.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// 0xFFFF in each half where a < b (false where either is NaN).
__device__ __forceinline__ unsigned bf16x2_lt(unsigned a, unsigned b) {
  unsigned r;
  asm("set.lt.u32.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ float bf16_half(unsigned word, int h) {
  return __uint_as_float(h ? (word & 0xFFFF0000u) : (word << 16));
}

// One slot into the running max of 8 channels (4 bf16 pairs), and with
// kWinners the slot index beside each (16-bit halves of `win`). Without
// NaN in the slice: the strict `v > best` of both forms on bf16 pairs, a
// compare and two selects a pair. With NaN (kNan): the rules of the
// K-fold kernel, value by value: with winners a NaN is taken with winner
// 0 and sticks; without, jnp.maximum (a NaN in either wins).
// kMin: the running min instead (strict `v < best`; without winners
// jnp.minimum's NaN rule), and the slot is taken only where `ok` (false
// for a masked slot, whose constant row of -inf would win every `<`).
template <bool kWinners, bool kNan, bool kMin = false>
__device__ __forceinline__ void take_slot(unsigned (&best)[4],
                                          unsigned (&win)[4], uint4 v4,
                                          int k, bool ok = true) {
  const unsigned v[4] = {v4.x, v4.y, v4.z, v4.w};
  const unsigned k2 = (unsigned)k * 0x00010001u;
  const unsigned okm = kMin && !ok ? 0u : 0xFFFFFFFFu;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!kNan) {
      const unsigned gt =
          (kMin ? bf16x2_lt(v[i], best[i]) : bf16x2_gt(v[i], best[i])) & okm;
      best[i] = (v[i] & gt) | (best[i] & ~gt);
      if (kWinners) win[i] = (k2 & gt) | (win[i] & ~gt);
      continue;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned lo = 0xFFFFu << (16 * h);
      const float fv = bf16_half(v[i], h), fb = bf16_half(best[i], h);
      bool take;
      unsigned slot = (unsigned)k;
      if (kWinners) {
        take = fv != fv ? fb == fb : kMin ? fv < fb : fv > fb;
        if (fv != fv) slot = 0u;
      } else {
        take = !(fb != fb || (kMin ? fv >= fb : fv <= fb));
      }
      if (take && (!kMin || ok)) {
        best[i] = (best[i] & ~lo) | (v[i] & lo);
        if (kWinners) win[i] = (win[i] & ~lo) | ((slot << (16 * h)) & lo);
      }
    }
  }
}

// Value h (0 or 1) of a 32-bit word of the running max: a bf16 half, or
// the f32 word itself (h 0).
template <typename T>
__device__ __forceinline__ T value_of(unsigned word, int h);
template <>
__device__ __forceinline__ float value_of<float>(unsigned word, int) {
  return __uint_as_float(word);
}
template <>
__device__ __forceinline__ __nv_bfloat16 value_of<__nv_bfloat16>(
    unsigned word, int h) {
  __nv_bfloat16_raw raw;
  raw.x = (unsigned short)(h ? word >> 16 : word & 0xFFFFu);
  return __nv_bfloat16(raw);
}

// The same for 4 f32 channels (one value a 32-bit word, the winner a
// whole word), with the rules of gather_max.cu's `take`: without NaN a
// strict `v > best` (kMin: `v < best`, only where `ok`) and a select;
// with NaN (kNan) a NaN is taken with winner 0 and sticks.
template <bool kWinners, bool kNan, bool kMin = false>
__device__ __forceinline__ void take_slot_f32(unsigned (&best)[4],
                                              unsigned (&win)[4], uint4 v4,
                                              int k, bool ok = true) {
  const unsigned v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float fv = __uint_as_float(v[i]), fb = __uint_as_float(best[i]);
    bool take = kMin ? fv < fb : fv > fb;
    unsigned slot = (unsigned)k;
    if (kNan && fv != fv) {
      take = fb == fb;
      slot = 0u;
    }
    if (kMin) take = take && ok;
    best[i] = take ? v[i] : best[i];
    if (kWinners) win[i] = take ? slot : win[i];
  }
}

// One slot added into the running sums of 4 f32 channels (the neighbour
// sum's mode of the phase): one rounded f32 add a channel, so the slots
// add in the order they are passed.
__device__ __forceinline__ void add_slot_f32(unsigned (&acc)[4], uint4 v4) {
  const unsigned v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    acc[i] = __float_as_uint(__fadd_rn(__uint_as_float(acc[i]),
                                       __uint_as_float(v[i])));
}

// The int8 form's epilogue (gather_max_int8.cu): the max v of a row's
// slots quantized as int8_quantize quantizes every feature, q = rint(fl(fl(v
// / a) * 127)) (round half to even), then dequantized, fl(q * s), in f32;
// 0 on a row with no valid slot. q goes through an int, so a -0 quotient
// gives +0, as the int8 value does.
__device__ __forceinline__ float int8_dequant(float v, float a, float s,
                                              bool valid) {
  if (!valid) return 0.0f;
  const int q = __float2int_rn(__fmul_rn(__fdiv_rn(v, a), 127.0f));
  return __fmul_rn((float)q, s);
}

// The max phase: a group of P lanes a point (P 16-byte pieces a row of the
// slice), lane q of the group the piece q (8 bf16 or 4 f32 channels of T),
// 16-byte reads of the rows (`ys`, the slice's shared-memory address). A
// block's warps (kRowsWarps) walk the points p0 .. p1 - 1 of cloud b; a
// warp walks its points' slots in steps of SB; in a step each lane of a
// group holds PER consecutive slots of the point (idx and mask, loaded
// once) and passes the row to read round the group by shuffles,
// kRowsInFlight rows in flight: a masked slot reads row N + 1 (-inf) and
// a valid one outside the cloud row N (zeros), so every read is
// unconditional. A step's idx and mask are loaded three steps ahead
// (three register sets, used in turn). The running max starts at `neg`
// (-3e38 in T, in each word) and its winner at 0; out and winner rows are
// `ldo` elements apart, the slice at column col0, of which `nvalid`
// columns are written (whole pieces by 16-byte stores when `vec_out`,
// else one by one). The rows kernel passes the whole cloud, the bf16 slice
// and, with `aff`, the epilogue; gather_max.cu's staged route a share
// of the points of a channel slice of h and, with kQuant, the int8
// epilogue (`int8_dequant`) of the cloud's a and s, or, with `aff` (bf16),
// the BatchNorm + LeakyReLU epilogue, and with `sub_self` the self value
// subtracted: the point's slot-0 row of the slice (row N, zeros, where
// that id lies outside [0, N)), whatever its mask. `aff` holds the
// slice's four rows (sign, inv, mean, bias), `aff_ld` floats apart, from
// the slice's first column (in shared memory or device memory).
// With kSum (f32, no winners; gather_max.cu's neighbour sum) the phase
// sums in place of the max: the running value starts at `neg` (+0.0), a
// masked slot reads row N (zeros) like a valid one outside the cloud, and
// each slot's row is added in slot order (`add_slot_f32`), so a point's sum
// is the same chain of f32 adds as the plain version's.
// With kMinMax (no epilogue; gather_max.cu's `gather_minmax` bodies and
// the rows kernel's `gather_matmul_minmax`) the phase also keeps a running
// min (strict <, from `neg` with its sign flipped: +3e38) and with
// kWinners its winner beside the max, in registers, and writes it to
// out_min (and winner_min) as out (and winner). A masked slot reads row N
// + 1 (-inf), which no strict > takes but every strict < would: the min
// skips a slot whose row id is N + 1, a compare on the id the lane holds.
template <typename T, int P, bool kWinners, bool kNan, bool kQuant = false,
          bool kSum = false, bool kMinMax = false>
__device__ __forceinline__ void rows_max_phase(
    unsigned ys, const int* __restrict__ idx,
    const uint8_t* __restrict__ mask, const float* aff, int aff_ld,
    T* __restrict__ out, int* __restrict__ winner, int b, int N, int p0,
    int p1, int ldo, int col0, int nvalid, bool vec_out, int K,
    unsigned neg, int warp, int lane, float qa = 0.0f, float qs = 0.0f,
    bool sub_self = false, T* __restrict__ out_min = nullptr,
    int* __restrict__ winner_min = nullptr) {
  static_assert(!kSum || (sizeof(T) == 4 && !kWinners && !kQuant),
                "the sum mode takes f32 rows without winners");
  static_assert(!kMinMax || (!kSum && !kQuant),
                "the min/max mode has no epilogue");
  // The sign bit of each value of a word: -3e38 to +3e38.
  constexpr unsigned kSignBits = sizeof(T) == 4 ? 0x80000000u : 0x80008000u;
  constexpr int PW = 32 / P;
  constexpr int V = 16 / sizeof(T);  // channels a piece
  constexpr int SB = P >= kRowsInFlight ? P : kRowsInFlight;  // slots a step
  constexpr int PER = SB / P;  // slots a lane loads a step
  const int q = lane % P, gbase = lane - q, gi = lane / P;
  const int stride = kRowsWarps * PW, first = p0 + warp * PW;
  const int rounds = first < p1 ? (p1 - first + stride - 1) / stride : 0;
  const int nkb = (K + SB - 1) / SB;
  const int steps = rounds * nkb;  // the same for the whole warp

  // The raw idx and mask of this lane's slots of the next step to fetch,
  // PER consecutive ones (0, 0 where there is none); fetches run in step
  // order, three ahead. With K a multiple of PER > 1 and aligned rows
  // (the same for the whole block) a lane's slots come in one 8- or
  // 16-byte load of idx and one 2- or 4-byte load of mask.
  const bool vec = PER > 1 && K % PER == 0 &&
                   reinterpret_cast<uintptr_t>(idx) % (4 * PER) == 0 &&
                   reinterpret_cast<uintptr_t>(mask) % PER == 0;
  int f_it = 0, f_kbi = 0, f_p = first + gi;
  auto fetch = [&](int (&jv)[PER], int (&mv)[PER]) {
#pragma unroll
    for (int i = 0; i < PER; ++i) jv[i] = mv[i] = 0;
    if (f_it++ >= steps) return;
    const int kb = f_kbi * SB, p = f_p;
    if (++f_kbi == nkb) {
      f_kbi = 0;
      f_p += stride;
    }
    if (p >= p1) return;
    const long long at = ((long long)b * N + p) * K + kb + PER * q;
    if constexpr (PER > 1) {
      if (vec && kb + PER * (q + 1) <= K) {  // PER slots in one load each
        if constexpr (PER == 4) {
          const int4 j4 = *reinterpret_cast<const int4*>(idx + at);
          const unsigned m = *reinterpret_cast<const unsigned*>(mask + at);
          jv[0] = j4.x;
          jv[1] = j4.y;
          jv[2] = j4.z;
          jv[3] = j4.w;
#pragma unroll
          for (int i = 0; i < PER; ++i) mv[i] = (m >> (8 * i)) & 0xFF;
        } else {
          const int2 j2 = *reinterpret_cast<const int2*>(idx + at);
          const unsigned m =
              *reinterpret_cast<const unsigned short*>(mask + at);
          jv[0] = j2.x;
          jv[1] = j2.y;
          mv[0] = m & 0xFF;
          mv[1] = m >> 8;
        }
        return;
      }
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      if (kb + PER * q + i < K) {
        jv[i] = idx[at + i];
        mv[i] = mask[at + i];
      }
    }
  };

  // The piece's words as T values h (bf16 halves, or f32 words), stored
  // into `dst` whole (16 bytes) when `vec_out`, else the slice's valid
  // ones one by one.
  auto store_words = [&](T* dst, long long o, const unsigned (&w)[4]) {
    if (vec_out) {
      *reinterpret_cast<uint4*>(dst + o) = make_uint4(w[0], w[1], w[2], w[3]);
      return;
    }
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (V * q + i < nvalid)
        dst[o + i] = value_of<T>(w[i * 4 / V], V == 8 ? i % 2 : 0);
  };
  // The piece's values and their winners (bf16: 16-bit halves unpacked
  // into V words) into `dst` and `wdst`.
  auto store_winners = [&](T* dst, int* wdst, long long o,
                           const unsigned (&vals)[4],
                           const unsigned (&wins)[4]) {
    int wv[V];
#pragma unroll
    for (int i = 0; i < V; ++i)
      wv[i] = V == 8 ? (int)((wins[i / 2] >> (16 * (i % 2))) & 0xFFFF)
                     : (int)wins[i % 4];
    if (!vec_out) {  // column by column, up to the slice's last valid one
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (V * q + i < nvalid) {
          dst[o + i] = value_of<T>(vals[i * 4 / V], V == 8 ? i % 2 : 0);
          wdst[o + i] = wv[i];
        }
      }
      return;
    }
    *reinterpret_cast<uint4*>(dst + o) =
        make_uint4(vals[0], vals[1], vals[2], vals[3]);
    int4* wr = reinterpret_cast<int4*>(wdst + o);
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      wr[i] = make_int4(wv[4 * i], wv[4 * i + 1], wv[4 * i + 2],
                        wv[4 * i + 3]);
  };

  unsigned best[4], win[4];
  unsigned worst[4], wmn[4];  // the running min and its winners (kMinMax)
  bool any = false;  // a valid slot among this lane's own
  int jself = N;     // the point's self row (its slot 0's), with sub_self
  int kbi = 0, r = 0;  // the step's slot block and round
  auto step = [&](int it, const int (&jv)[PER], const int (&mv)[PER]) {
    if (it >= steps) return;
    if (kbi == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        best[i] = neg;
        win[i] = 0u;
        if (kMinMax) {
          worst[i] = neg ^ kSignBits;
          wmn[i] = 0u;
        }
      }
      any = false;
      // Slot 0 is the first slot of the group's first lane (the same
      // for the whole warp: every lane takes the shuffle).
      if (sub_self)
        jself = __shfl_sync(0xffffffffu,
                            (unsigned)jv[0] < (unsigned)N ? jv[0] : N, gbase);
    }
    int jm[PER];  // the y row of each of this lane's slots
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      any |= mv[i] != 0;
      jm[i] = mv[i] == 0 ? (kSum ? N : N + 1)
                         : (unsigned)jv[i] < (unsigned)N ? jv[i] : N;
    }
    const int kb = kbi * SB;
#pragma unroll
    for (int s0 = 0; s0 < SB; s0 += kRowsInFlight) {
      // The same for the whole warp (an `if`, not a `break`: the unrolled
      // loop keeps the slot registers in registers).
      if (kb + s0 >= K) continue;
      uint4 v[kRowsInFlight];
      bool ok[kRowsInFlight];  // not a masked slot (for the min)
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int s = s0 + u;
        const int j = P > 1 ? __shfl_sync(0xffffffffu, jm[s % PER],
                                          gbase + s / PER)
                            : jm[s];
        ok[u] = j != N + 1;
        v[u] = lds128(ys + (unsigned)(j * P + y_chunk<P>(j, q)) * 16u);
      }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int k = kb + s0 + u;
        if constexpr (kSum) {
          add_slot_f32(best, v[u]);
        } else if constexpr (V == 8) {
          take_slot<kWinners, kNan>(best, win, v[u], k);
          if (kMinMax) take_slot<kWinners, kNan, true>(worst, wmn, v[u], k,
                                                       ok[u]);
        } else {
          take_slot_f32<kWinners, kNan>(best, win, v[u], k);
          if (kMinMax)
            take_slot_f32<kWinners, kNan, true>(worst, wmn, v[u], k, ok[u]);
        }
      }
    }
    if (++kbi < nkb) return;
    kbi = 0;
    const int p = first + r * stride + gi;
    ++r;
    // The point's rows are valid if any slot of the group is.
    const bool valid =
        (__ballot_sync(0xffffffffu, any) >> gbase) & ((1u << P) - 1u);
    if (p >= p1 || V * q >= nvalid) return;
    const long long o = ((long long)b * N + p) * ldo + col0 + V * q;
    if constexpr (kQuant) {
      float dq[V];
#pragma unroll
      for (int i = 0; i < V; ++i)
        dq[i] = int8_dequant(V == 8 ? bf16_half(best[i / 2], i % 2)
                                    : __uint_as_float(best[i]),
                             qa, qs, valid);
      unsigned packed[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (V == 8) {
          const __nv_bfloat162 pair =
              __floats2bfloat162_rn(dq[2 * i], dq[2 * i + 1]);
          packed[i] = *reinterpret_cast<const unsigned*>(&pair);
        } else {
          packed[i] = __float_as_uint(dq[i]);
        }
      }
      store_words(out, o, packed);
      return;
    }
    if constexpr (V == 8 && !kWinners) {
      if (aff != nullptr) {  // the BatchNorm + LeakyReLU epilogue
        unsigned self_w[4] = {0u, 0u, 0u, 0u};
        if (sub_self) {
          const uint4 s4 =
              lds128(ys + (unsigned)(jself * P + y_chunk<P>(jself, q)) * 16u);
          self_w[0] = s4.x;
          self_w[1] = s4.y;
          self_w[2] = s4.z;
          self_w[3] = s4.w;
        }
        // The piece's 8 values of each affine row: two 16-byte loads where
        // the piece is whole and aligned (always in shared memory), else
        // the valid ones one by one.
        float a[4][8];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const float* ap = aff + (long long)rr * aff_ld + 8 * q;
          if (8 * q + 8 <= nvalid &&
              (reinterpret_cast<uintptr_t>(ap) & 15u) == 0) {
            const float4 lo = reinterpret_cast<const float4*>(ap)[0];
            const float4 hi = reinterpret_cast<const float4*>(ap)[1];
            const float w8[8] = {lo.x, lo.y, lo.z, lo.w,
                                 hi.x, hi.y, hi.z, hi.w};
#pragma unroll
            for (int i = 0; i < 8; ++i) a[rr][i] = w8[i];
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i)
              a[rr][i] = 8 * q + i < nvalid ? ap[i] : 0.0f;
          }
        }
        unsigned packed[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float v[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * i + h;
            v[h] = bn_lrelu_of(bf16_half(best[i], h), bf16_half(self_w[i], h),
                               sub_self, valid, a[0][e], a[1][e], a[2][e],
                               a[3][e]);
          }
          const __nv_bfloat162 pair = __floats2bfloat162_rn(v[0], v[1]);
          packed[i] = *reinterpret_cast<const unsigned*>(&pair);
        }
        store_words(out, o, packed);
        return;
      }
    }
    if constexpr (!kWinners) {
      store_words(out, o, best);
      if constexpr (kMinMax) store_words(out_min, o, worst);
      return;
    }
    store_winners(out, winner, o, best, win);
    if constexpr (kMinMax) store_winners(out_min, winner_min, o, worst, wmn);
  };

  int jA[PER], mA[PER], jB[PER], mB[PER], jC[PER], mC[PER];
  fetch(jA, mA);
  fetch(jB, mB);
  fetch(jC, mC);
  for (int it = 0; it < steps; it += 3) {
    step(it, jA, mA);
    fetch(jA, mA);
    step(it + 1, jB, mB);
    fetch(jB, mB);
    step(it + 2, jC, mC);
    fetch(jC, mC);
  }
}

// One block a task (cloud b, slice s of kCs columns). C_in and C_out are
// multiples of 16, C_out of kCs; x 16-byte and w 32-byte aligned; aff
// [4, C_out] f32 or null; winner null unless kWinners; `stages` x ring
// stages (2 to kMaxStages). kMinMax (no winners, aff null): also the
// running min of the same bf16 y rows, into out_min.
template <typename Tin, int kCs, bool kWinners, bool kBReg,
          bool kMinMax = false>
__global__ void __launch_bounds__(kRowsWarps * 32, 1)
    gather_matmul_max_rows_kernel(
        const Tin* __restrict__ x,
        const __nv_bfloat16* __restrict__ w, const int* __restrict__ idx,
        const uint8_t* __restrict__ mask, const float* __restrict__ aff,
        __nv_bfloat16* __restrict__ out, int* __restrict__ winner, int N,
        int Cin, int Cout, int K, int stages,
        __nv_bfloat16* __restrict__ out_min) {
  constexpr int P = kCs / 8;  // 16-byte chunks of a y row: n-tiles of 8
  constexpr int TR = kTileRows, MT = TR / 16;  // rows, m-tiles a stage
  constexpr int WPM = kRowsWarps / MT;        // warps an m-tile
  constexpr int NW = P >= WPM ? P / WPM : 1;  // n-tiles a busy warp
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = rows_ldx(Cin), ldw = rows_ldw(kCs);
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem);
  float* aff_s = reinterpret_cast<float*>(ys + (size_t)(N + 2) * kCs);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(aff_s + 4 * kCs);
  constexpr bool kInt8 = sizeof(Tin) == 1;
  // bf16: the ring of padded bf16 stages; int8: the int8 stages, then the
  // bf16 tile that each stage is widened into.
  Tin* ring = reinterpret_cast<Tin*>(ws + (size_t)Cin * ldw);
  __nv_bfloat16* xt = reinterpret_cast<__nv_bfloat16*>(
      ring + (size_t)stages * kTileRows * Cin);
  const int ld_ring = kInt8 ? Cin : ldx;

  const int slices = Cout / kCs;
  const int b = blockIdx.x / slices, col0 = (blockIdx.x % slices) * kCs;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Tin* xb = x + (long long)b * N * Cin;

  // The W slice and the affine slice, once a task.
  for (int e = tid; e < Cin * P; e += blockDim.x) {
    const int r = e / P, c = e % P;
    reinterpret_cast<uint4*>(ws + r * ldw)[c] = __ldg(
        reinterpret_cast<const uint4*>(w + (long long)r * Cout + col0) + c);
  }
  if (aff != nullptr)
    for (int e = tid; e < 4 * kCs; e += blockDim.x)
      aff_s[e] = aff[(e / kCs) * Cout + col0 + e % kCs];

  constexpr int kPer16 = 16 / sizeof(Tin);  // values a 16-byte copy
  const int per_row = Cin / kPer16;
  const int tiles = (N + TR - 1) / TR;
  auto load_tile = [&](int t) {
    if (t >= tiles) return;
    Tin* dst = ring + (t % stages) * TR * ld_ring;
    const int r0 = t * TR;
    for (int e = tid; e < TR * per_row; e += blockDim.x) {
      const int r = e / per_row, c = e % per_row;
      const bool valid = r0 + r < N;
      cp_async16(dst + r * ld_ring + c * kPer16,
                 xb + (long long)(valid ? r0 + r : 0) * Cin + c * kPer16,
                 valid);
    }
  };

  // Product phase: TR-row tiles through the ring, `stages` - 1 loads in
  // flight; warp w takes m-tile w % MT and n-tiles w / MT + WPM jj (none
  // when w / MT >= Cs / 8).
  const int mt = warp % MT, nsel = warp / MT;
  const bool busy = nsel < P;
  const int g = lane >> 2, t4 = lane & 3;
  const int ksteps = Cin / 16;
  const __nv_bfloat16* b_row = ws + (lane & 15) * ldw + nsel * 8;
  // The warp's B fragments of k-step ks (ldmatrix.trans of the W slice).
  auto b_frags = [&](int ks, uint32_t(&bf)[NW][2]) {
#pragma unroll
    for (int jj = 0; jj < NW; ++jj)
      ldsm_x2_trans(bf[jj][0], bf[jj][1],
                    b_row + ks * 16 * ldw + jj * WPM * 8);
  };
  // With C_in <= 128 (kBReg) they stay in registers for the whole task.
  uint32_t breg[kBReg ? kBRegSteps : 1][NW][2];
  if (kBReg) {
    __syncthreads();  // the W slice is staged
    if (busy) {
#pragma unroll
      for (int ks = 0; ks < kBRegSteps; ++ks)
        if (ks < ksteps) b_frags(ks, breg[ks]);
    }
  }
  bool nan_seen = false;
  for (int t = 0; t + 1 < stages; ++t) {
    load_tile(t);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    load_tile(t + stages - 1);
    cp_async_commit();
    cp_async_wait(stages);  // tile t has landed
    __syncthreads();
    const __nv_bfloat16* a_tile;
    if constexpr (kInt8) {  // widened once, 8 values a thread a step
      const int8_t* src = ring + (t % stages) * TR * Cin;
      for (int e = tid; e < TR * (Cin / 8); e += blockDim.x) {
        const int r = e / (Cin / 8), q = e % (Cin / 8);
        reinterpret_cast<uint4*>(xt + r * ldx)[q] =
            load8_bf16(src + r * Cin, q);
      }
      __syncthreads();
      a_tile = xt;
    } else {
      a_tile = ring + (t % stages) * TR * ldx;
    }
    if (busy) {
      const __nv_bfloat16* a_row = a_tile + (mt * 16 + (lane & 15)) * ldx +
                                   (lane >> 4) * 8;
      float acc[NW][4];
#pragma unroll
      for (int jj = 0; jj < NW; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jj][e] = 0.0f;
      // k-step ks + 1's fragments load while ks's products run (two
      // register sets); each accumulator still sums k in steps of 16.
      uint32_t a0[4], a1[4];
      if (kBReg) {
        ldsm_x4(a0, a_row);
#pragma unroll
        for (int ks = 0; ks < kBRegSteps; ks += 2) {
          if (ks + 1 < ksteps) ldsm_x4(a1, a_row + (ks + 1) * 16);
          if (ks < ksteps) {
#pragma unroll
            for (int jj = 0; jj < NW; ++jj)
              mma_16816(acc[jj], a0, breg[ks][jj][0], breg[ks][jj][1]);
          }
          if (ks + 2 < ksteps) ldsm_x4(a0, a_row + (ks + 2) * 16);
          if (ks + 1 < ksteps) {
#pragma unroll
            for (int jj = 0; jj < NW; ++jj)
              mma_16816(acc[jj], a1, breg[ks + 1][jj][0],
                        breg[ks + 1][jj][1]);
          }
        }
      } else {
        uint32_t b0[NW][2], b1[NW][2];
        auto frags = [&](int ks, uint32_t(&a)[4], uint32_t(&bf)[NW][2]) {
          ldsm_x4(a, a_row + ks * 16);
          b_frags(ks, bf);
        };
        auto products = [&](const uint32_t(&a)[4],
                            const uint32_t(&bf)[NW][2]) {
#pragma unroll
          for (int jj = 0; jj < NW; ++jj)
            mma_16816(acc[jj], a, bf[jj][0], bf[jj][1]);
        };
        frags(0, a0, b0);
        for (int ks = 0; ks < ksteps; ks += 2) {
          if (ks + 1 < ksteps) frags(ks + 1, a1, b1);
          products(a0, b0);
          if (ks + 2 < ksteps) frags(ks + 2, a0, b0);
          if (ks + 1 < ksteps) products(a1, b1);
        }
      }
      // Rounded to bf16 and stored from the registers into the y slice.
#pragma unroll
      for (int jj = 0; jj < NW; ++jj) {
        const int jn = nsel + WPM * jj;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = t * TR + mt * 16 + g + 8 * h;
          if (r >= N) continue;
          const float v0 = acc[jj][2 * h], v1 = acc[jj][2 * h + 1];
          nan_seen |= v0 != v0 || v1 != v1;
          *reinterpret_cast<__nv_bfloat162*>(
              ys + r * kCs + y_chunk<P>(r, jn) * 8 + 2 * t4) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    __syncthreads();  // this stage is read before a later load refills it
  }
  // Rows N (zeros) and N + 1 (-inf) for slots that read no row of y.
  if (tid < 2 * P)
    reinterpret_cast<uint4*>(ys + (size_t)(N + tid / P) * kCs)[tid % P] =
        tid < P ? make_uint4(0u, 0u, 0u, 0u)
                : make_uint4(kNegInf2, kNegInf2, kNegInf2, kNegInf2);
  // The y slice is whole; a NaN anywhere in it takes the slower max.
  const bool any_nan = __syncthreads_or(nan_seen) != 0;

  const __nv_bfloat16 neg = __float2bfloat16_rn(kNeg);
  const unsigned neg_bits = *reinterpret_cast<const unsigned short*>(&neg);
  const unsigned neg2 = neg_bits | (neg_bits << 16);
  const unsigned y_addr = smem_addr(ys);
  const float* aff_p = aff != nullptr ? aff_s : nullptr;
  if (any_nan)
    rows_max_phase<__nv_bfloat16, P, kWinners, true, false, false, kMinMax>(
        y_addr, idx, mask, aff_p, kCs, out, winner, b, N, 0, N, Cout, col0,
        kCs, true, K, neg2, warp, lane, 0.0f, 0.0f, false, out_min);
  else
    rows_max_phase<__nv_bfloat16, P, kWinners, false, false, false, kMinMax>(
        y_addr, idx, mask, aff_p, kCs, out, winner, b, N, 0, N, Cout, col0,
        kCs, true, K, neg2, warp, lane, 0.0f, 0.0f, false, out_min);
}

template <typename Tin, int kCs, bool kWinners, bool kMinMax>
int launch_rows(const void* x, const void* w, const void* idx,
                const void* mask, const void* aff, void* out, void* winner,
                int B, int N, int Cin, int Cout, int K, int stages,
                size_t smem, cudaStream_t stream, void* out_min) {
  auto kernel =
      Cin <= 16 * kBRegSteps
          ? gather_matmul_max_rows_kernel<Tin, kCs, kWinners, true, kMinMax>
          : gather_matmul_max_rows_kernel<Tin, kCs, kWinners, false,
                                          kMinMax>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tasks = (long long)B * (Cout / kCs);
  kernel<<<(unsigned)tasks, kRowsWarps * 32, smem, stream>>>(
      (const Tin*)x, (const __nv_bfloat16*)w, (const int*)idx,
      (const uint8_t*)mask, (const float*)aff, (__nv_bfloat16*)out,
      (int*)winner, N, Cin, Cout, K, stages, (__nv_bfloat16*)out_min);
  return (int)cudaGetLastError();
}

// Cs: the slice width the wrapper chose (8, 16, 32 or 64); the ring takes
// as many stages as fit. A shape whose slice does not fit a block with
// two stages, or K above the 16-bit winners, is refused. Tin: bf16 or
// int8 x. kMinMax: the min/max mode (no winners, aff null), the min into
// out_min.
template <bool kWinners, typename Tin = __nv_bfloat16, bool kMinMax = false>
int launch_matmul_max_rows(const void* x, const void* w, const void* idx,
                           const void* mask, const void* aff, void* out,
                           void* winner, int B, int N, int Cin, int Cout,
                           int K, int Cs, void* stream,
                           void* out_min = nullptr) {
  static_assert(!kMinMax || !kWinners, "the min/max mode has no winners");
  if ((long long)B * N * Cout == 0) return (int)cudaGetLastError();
  if (Cin % 16 != 0 || Cout % 16 != 0 || Cin == 0 || K <= 0 || K > 0xFFFF ||
      (Cs != 8 && Cs != 16 && Cs != 32 && Cs != 64) || Cout % Cs != 0)
    return (int)cudaErrorInvalidValue;
  constexpr int in_bytes = sizeof(Tin);
  int stages = kMaxStages;
  while (stages > 2 &&
         rows_smem_bytes(N, Cin, Cs, stages, in_bytes) > kRowsSmemMax)
    --stages;
  const size_t smem = rows_smem_bytes(N, Cin, Cs, stages, in_bytes);
  if (smem > kRowsSmemMax) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (Cs) {
    case 8:
      return launch_rows<Tin, 8, kWinners, kMinMax>(
          x, w, idx, mask, aff, out, winner, B, N, Cin, Cout, K, stages,
          smem, s, out_min);
    case 16:
      return launch_rows<Tin, 16, kWinners, kMinMax>(
          x, w, idx, mask, aff, out, winner, B, N, Cin, Cout, K, stages,
          smem, s, out_min);
    case 32:
      return launch_rows<Tin, 32, kWinners, kMinMax>(
          x, w, idx, mask, aff, out, winner, B, N, Cin, Cout, K, stages,
          smem, s, out_min);
    default:
      return launch_rows<Tin, 64, kWinners, kMinMax>(
          x, w, idx, mask, aff, out, winner, B, N, Cin, Cout, K, stages,
          smem, s, out_min);
  }
}

}  // namespace
