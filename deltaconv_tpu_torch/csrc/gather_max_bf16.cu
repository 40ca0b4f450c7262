// The bf16 neighbour maxes of the DeltaConv scalar branch: the eval ones
// with the BatchNorm + LeakyReLU epilogue in the kernel, and the
// train-mode gather-then-matmul max with winner slots.
//
// `gather_max_affine`:
//   best[b, n, c] = max over k with mask[b, n, k] of h[b, idx[b, n, k], c]
//   h [B, N, C] bf16, idx [B, N, K] i32, mask [B, N, K] bool (one byte),
//   aff [4, C] f32 = (sign, inv, mean, bias) -> out [B, N, C] bf16.
// Replaces the Pallas kernel of deltaconv_tpu/ops/gather_max.py
// (`gather_max_affine`, pallas_call at gather_max.py:666, body
// `_max_affine_kernel`), which gathered through a one-hot MXU product.
//
// `gather_matmul_max`:
//   best[b, n, o] = max over valid k of sum_c x[b, idx[b, n, k], c] w[c, o]
//   x [B, N, C_in] bf16, w [C_in, C_out] bf16 (sign already folded in),
//   aff [4, C_out] f32 or null -> out [B, N, C_out] bf16; the products are
//   accumulated in f32.
// Replaces `gather_matmul_max` (pallas_call at gather_max.py:756, body
// `_mm_max_kernel`).
//
// `gather_matmul_max_win` (the train-mode twin):
//   y[b, n, k, o] = bf16(sum_c x[b, idx[b, n, k], c] w[c, o])
//   out[b, n, o] = max over valid k of y, winner[b, n, o] = the first such
//   k that holds it (strict >, slots in ascending order)
//   x [B, N, C_in] bf16, w [C_in, C_out] bf16 -> out [B, N, C_out] bf16,
//   winner [B, N, C_out] i32; -3e38 and winner 0 on a row with no valid
//   slot; no epilogue. Each slot's f32 product is rounded to bf16 BEFORE it
//   enters the max (gather_max.py:827-837), so values and winners are
//   those of the per-point bf16 product followed by the neighbour max.
// Replaces `_mm_train_pallas_fwd` (pallas_call at gather_max.py:865, body
// `_mm_max_win_kernel`); its backward is the winner-routed scatter of
// gather_max.cu at C_out.
//
// `gather_matmul_minmax` (forward only, as JAX's):
//   mx[b, n, o] = max over valid k of sum_c x[b, idx[b, n, k], c] w[c, o]
//   mn[b, n, o] = min over valid k of the same sums
//   x [B, N, C_in] bf16, w [C_in, C_out] bf16 -> mx, mn [B, N, C_out]
//   bf16, the f32 max and min each rounded to bf16 (rounding is monotone,
//   so this equals rounding each slot first); (-3e38, +3e38) on a row
//   with no valid slot. Replaces the Pallas kernel of `gather_matmul_minmax`
//   (pallas_call at gather_max.py:792, body `_mm_minmax_kernel`), which
//   gathered x through a one-hot MXU product on a hi/lo split and ran the
//   layer on every gathered slot. Here it is the one-product-a-row kernel
//   of `gather_matmul_max` below in its min/max mode: y = bf16(x[b] @ w[:,
//   slice]) once a row into shared memory, then the max phase keeps a
//   running min (bf16 pairs, a strict <, from +3e38) beside its running
//   max and writes both, 16 bytes a lane; no epilogue, no winners. The
//   masked slot's constant row (-inf) would win every <, so the min skips
//   a slot whose row id is N + 1 (the lane holds the id: no extra read).
//   Rounding y to bf16 before the extremes gives the bits of rounding the
//   f32 extremes after (monotone rounding), so the plain version rounds
//   after. Bound on the H100: its bytes (x, w, idx/mask and the two bf16
//   outputs: ~0.0135 ms at B=32, N=1024, K=20, 128 -> 256); its one product
//   a row, 2.1 GFLOP, is 0.002 ms on the tensor cores. Routed by
//   `mm_slice` as `gather_matmul_max`; above its limit (10,038 points at
//   C_in = 128) the K-fold kernel (gather_matmul_max.cuh) in its min/max
//   mode, `gather_matmul_minmax_kfold`, which pays K products a row.
//
// Both eval kernels end in `_bn_lrelu_epilogue` (gather_max.py:584),
// replayed op for op in f32 with every operation rounded on its own (no
// FMA contraction):
// the max rounded to bf16; with `sub_self`, rows with no valid slot set
// to 0 and then sign * (max - h[idx[., 0]]), else sign * max; then
// (h* - mean) * inv + bias, LeakyReLU 0.2, and 0 on rows with no valid
// slot; stored rounded to bf16. Without `aff`, `gather_matmul_max` stores
// the max rounded to bf16 (-3e38 where no slot is valid). The self row is
// read through idx[., 0], which the kNN sets to the point itself; the TPU
// kernel read the point's own row.
//
// `gather_max_affine` design: any point may gather any row of its cloud,
// so the function reads each row of h once (it is K = 20 times smaller
// than the gathered rows). Two routes, chosen by shape in
// ops/gather_max.py (`max_slice`), the same bits.
// Route S (`gather_max_affine`): gather_max.cu's staged route, the
// neighbour max's: a block takes a cloud and a slice of Cs channels (16 to
// 128 bytes of bf16 a row), stages the slice's N rows in shared memory by
// cp.async beside a row of zeros (row N: a valid id outside [0, N)) and
// one of -inf (row N + 1: a masked slot), then the max phase of
// gather_matmul_max_rows.cuh takes each
// point's max out of shared memory (a group of Cs / 8 lanes a point, 16
// bytes of a slot's row a lane, the running max in bf16 pairs from
// bf16(-3e38), a strict > in slot order; a slice holding a NaN takes
// jnp.maximum's rule value by value, so a NaN propagates) and ends in the
// epilogue: `valid` from the point's mask row, with `sub_self` the self
// value read from the slice at the point's slot-0 id (row N where it lies
// outside [0, N), whatever slot 0's mask, as the one-hot slot-0 gather of
// the TPU kernel gives), then `bn_lrelu_of` value by value on the slice's
// four affine rows, read from device memory through L1 (staging them in
// shared memory measured no faster on the H100), and one 16-byte
// store of 8 outputs a lane. The slice rows are read from L2 or
// memory once a task, the K slots of a point from shared memory. Where
// the tasks are fewer than the SMs a task's points split over blocks, each
// staging the whole slice.
// Route D (`gather_max_affine_direct`, the earlier kernel), where no slice
// fits a block (above 14,526 points) or K is 0: one thread per (point,
// channel pair) with bf16x2 loads, a block row (threadIdx.y) per point,
// every slot's row from L2, idx and mask re-read from memory for each
// pair.
// Bound on the H100: memory, h, idx, mask and aff read once and out
// written once: ~0.0060 ms at B=32, N=1024, K=20, C=128 (0.0035 at
// C=64); route D moves the K gathered rows from L2 instead. Route S takes
// 0.0250 ms of device time at C=128, route D 0.0750 (PERF.md).
//
// `gather_matmul_max` and `gather_matmul_max_win` design (the kernel is
// in gather_matmul_max_rows.cuh): the function needs one product a row,
// since row j's x_j @ w is the same whichever point gathers it, and
// rounding to bf16 before the max is the train form's definition and
// changes nothing for the eval form (its epilogue rounds the f32 max, and
// rounding is monotone), so both share one body. A block takes one task,
// a cloud and a slice of Cs output columns (64, 32, 16 or 8: the widest
// whose [N, Cs] bf16 slice of y fits the block's shared memory beside
// the staging buffers, narrowed while twice the tasks still fit one wave
// of the SMs; the wrapper chooses it, `mm_slice` in ops/gather_max.py).
// A block is 16 warps (one block an SM: the slice takes most of its
// shared memory, so the max phase needs the warps to hide its latency).
// Product phase: the W slice [C_in, Cs] is staged once, and with C_in <=
// 128 each warp keeps its B fragments (ldmatrix.trans) in registers for
// the whole task; the cloud's rows of x, contiguous now that nothing is
// gathered, stream in 128-row tiles through a cp.async ring of as many
// stages as fit (two to four); mma.sync m16n8k16 (bf16 in, f32
// accumulate, A by ldmatrix, the next k-step's A loading during this
// one's products) runs on the tensor cores, k in steps of 16 from zero as
// the K-fold kernel's WMMA sums it, so the two routes give the same bits;
// each accumulator is rounded to bf16 and written from the registers into
// the y slice (its 16-byte chunks XOR-swizzled by row, so a store of 8
// rows takes 8 bank groups). The product is ~2 GFLOP at the
// classification shape, a few microseconds at any tensor-core rate, so
// mma.sync, as mlp_rows has it, over wgmma's warpgroup tiles and
// shared-memory descriptors. Max phase, after one block barrier: a group
// of Cs / 8 lanes a point, 8 channels a lane, 16-byte reads of the y rows;
// the point's idx and mask are loaded once, a slot to a lane, three steps
// of slots ahead of their use, and the row to read is passed round the
// group by shuffles (a masked slot reads a constant row of -inf, a valid
// slot outside the cloud one of zeros: no branch); the running max stays
// in registers as bf16 pairs (a compare and a select a pair; #14 keeps
// its 16-bit winner slots beside it, #12 applies the epilogue at the
// end), and out and the winners are written once. y never goes to device
// memory. A slice that holds a NaN (a block-wide OR at the barrier) takes
// a slower max with the K-fold kernel's NaN rules value by value.
// At Cs = 8 (the large clouds) every task reads its cloud's x from L2,
// 32 times over at C_out = 256, and the max phase's 16-byte reads of
// random rows meet in the same banks: the kernel there is about three
// times its classification time.
// Bound on the H100: the function's bytes (x, w, idx/mask, the bf16 out,
// and for the train form the i32 winners: ~62 MB, ~0.019 ms at B=32,
// N=1024, K=20, 128 -> 256; the eval form ~0.0085 ms); its product, 2 B N
// C_in C_out operations, 2.1 GFLOP, is 0.002 ms on the tensor cores.
// Route by shape: above the N at which even an 8-column slice no longer
// fits (10,038 points at C_in = 128), the wrapper takes the earlier
// K-fold kernel, counted as `gather_matmul_max_kfold` and
// `gather_matmul_max_win_kfold`.
//
// The K-fold kernel (gather_matmul_max.cuh, which gather_max_int8.cu
// instantiates on int8 rows and `gather_matmul_minmax_kfold` in its
// min/max mode) is the TPU's gather-then-matmul form: a block takes 16
// points, gathers their K input rows into shared memory (85 KB at K=20,
// C_in=128: two blocks an SM), and its 8 warps run WMMA on every gathered
// slot, each 16x16 tile passed through a warp's shared scratch into a
// running max in registers, W fragments read from L2 once for 4 slots. It pays
// 2 B N K C_in C_out operations (42.9 GFLOP at the classification shape,
// K times the function's), a scratch round trip per slot and K-fold
// gathers: 0.5926 ms (eval) and 0.7787 ms (train) on the H100 at that
// shape, 3.5 and 4.6 times `x @ w` followed by the port's own max.
#include "gather_matmul_max_rows.cuh"

namespace {

// V consecutive channels of row j of a bf16 table, 0 outside [0, N).
template <int V>
__device__ __forceinline__ void load_row(const __nv_bfloat16* hb, int j,
                                         int N, int C, int c, float* val) {
  if ((unsigned)j >= (unsigned)N) {
#pragma unroll
    for (int v = 0; v < V; ++v) val[v] = 0.0f;
    return;
  }
  const __nv_bfloat16* p = hb + (long long)j * C + c;
  if (V == 2) {
    const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(p);
    val[0] = __bfloat162float(pair.x);
    val[V - 1] = __bfloat162float(pair.y);
  } else {
    val[0] = __bfloat162float(p[0]);
  }
}

// Route D. V = 2 when C is even (4-byte loads and stores), else 1.
template <int V>
__global__ void gather_max_affine_direct_kernel(
    const __nv_bfloat16* __restrict__ h, const int* __restrict__ idx,
    const uint8_t* __restrict__ mask, const float* __restrict__ aff,
    __nv_bfloat16* __restrict__ out, int B, int N, int C, int K,
    int sub_self) {
  const long long bn = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (bn >= (long long)B * N) return;
  const long long b = bn / N;
  const int* ir = idx + bn * K;
  const uint8_t* mr = mask + bn * K;
  const __nv_bfloat16* hb = h + b * N * C;
  bool valid = false;
  for (int k = 0; k < K; ++k) valid |= mr[k] != 0;
  for (int c = threadIdx.x * V; c < C; c += blockDim.x * V) {
    float best[V], self_val[V], val[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      best[v] = kNeg;
      self_val[v] = 0.0f;
    }
    for (int k = 0; k < K; ++k) {
      if (!mr[k]) continue;
      load_row<V>(hb, ir[k], N, C, c, val);
#pragma unroll
      for (int v = 0; v < V; ++v) best[v] = nan_max(best[v], val[v]);
    }
    if (sub_self) load_row<V>(hb, ir[0], N, C, c, self_val);
    __nv_bfloat16 o[V];
#pragma unroll
    for (int v = 0; v < V; ++v)
      o[v] = __float2bfloat16_rn(
          bn_lrelu(best[v], self_val[v], sub_self, valid, aff, C, c + v));
    if (V == 2) {
      __nv_bfloat162 pair;
      pair.x = o[0];
      pair.y = o[V - 1];
      *reinterpret_cast<__nv_bfloat162*>(out + bn * C + c) = pair;
    } else {
      out[bn * C + c] = o[0];
    }
  }
}

}  // namespace

// gather_max.cu: route S of the neighbour max with the affine epilogue.
int dc_gather_max_staged_affine(const void* h, const void* idx,
                                const void* mask, const void* aff, void* out,
                                int B, int N, int C, int K, int Cs,
                                int splits, int sub_self, void* stream);

// Route S: Cs channels a slice and `splits` blocks a task, as the
// neighbour max's route S (`max_slice`).
extern "C" int dc_gather_max_affine(const void* h, const void* idx,
                                    const void* mask, const void* aff,
                                    void* out, int B, int N, int C, int K,
                                    int Cs, int splits, int sub_self,
                                    int device, void* stream) {
  DC_SET_DEVICE(device);
  return dc_gather_max_staged_affine(h, idx, mask, aff, out, B, N, C, K, Cs,
                                     splits, sub_self, stream);
}

extern "C" int dc_gather_max_affine_direct(const void* h, const void* idx,
                                           const void* mask, const void* aff,
                                           void* out, int B, int N, int C,
                                           int K, int sub_self, int device,
                                           void* stream) {
  DC_SET_DEVICE(device);
  if ((long long)B * N * C == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int V = (C % 2 == 0) ? 2 : 1;
  const dim3 block = dc_row_block((C + V - 1) / V);
  const dim3 grid = dc_row_grid(B, N, block);
  if (V == 2)
    gather_max_affine_direct_kernel<2><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)h, (const int*)idx, (const uint8_t*)mask,
        (const float*)aff, (__nv_bfloat16*)out, B, N, C, K, sub_self);
  else
    gather_max_affine_direct_kernel<1><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)h, (const int*)idx, (const uint8_t*)mask,
        (const float*)aff, (__nv_bfloat16*)out, B, N, C, K, sub_self);
  return (int)cudaGetLastError();
}

extern "C" int dc_gather_matmul_max(const void* x, const void* w,
                                    const void* idx, const void* mask,
                                    const void* aff, void* out, int B, int N,
                                    int Cin, int Cout, int K, int Cs,
                                    int device, void* stream) {
  DC_SET_DEVICE(device);
  return launch_matmul_max_rows<false>(x, w, idx, mask, aff, out, nullptr,
                                       B, N, Cin, Cout, K, Cs, stream);
}

extern "C" int dc_gather_matmul_max_kfold(const void* x, const void* w,
                                          const void* idx, const void* mask,
                                          const void* aff, void* out, int B,
                                          int N, int Cin, int Cout, int K,
                                          int device, void* stream) {
  DC_SET_DEVICE(device);
  return launch_matmul_max<false, __nv_bfloat16>(
      x, w, idx, mask, aff, out, nullptr, B, N, Cin, Cout, K, stream);
}

extern "C" int dc_gather_matmul_max_win(const void* x, const void* w,
                                        const void* idx, const void* mask,
                                        void* out, void* winner, int B, int N,
                                        int Cin, int Cout, int K, int Cs,
                                        int device, void* stream) {
  DC_SET_DEVICE(device);
  return launch_matmul_max_rows<true>(x, w, idx, mask, nullptr, out, winner,
                                      B, N, Cin, Cout, K, Cs, stream);
}

extern "C" int dc_gather_matmul_max_win_kfold(const void* x, const void* w,
                                              const void* idx,
                                              const void* mask, void* out,
                                              void* winner, int B, int N,
                                              int Cin, int Cout, int K,
                                              int device, void* stream) {
  DC_SET_DEVICE(device);
  return launch_matmul_max<true, __nv_bfloat16>(
      x, w, idx, mask, nullptr, out, winner, B, N, Cin, Cout, K, stream);
}

extern "C" int dc_gather_matmul_minmax(const void* x, const void* w,
                                       const void* idx, const void* mask,
                                       void* mx, void* mn, int B, int N,
                                       int Cin, int Cout, int K, int Cs,
                                       int device, void* stream) {
  DC_SET_DEVICE(device);
  return launch_matmul_max_rows<false, __nv_bfloat16, true>(
      x, w, idx, mask, nullptr, mx, nullptr, B, N, Cin, Cout, K, Cs, stream,
      mn);
}

extern "C" int dc_gather_matmul_minmax_kfold(const void* x, const void* w,
                                             const void* idx,
                                             const void* mask, void* mx,
                                             void* mn, int B, int N, int Cin,
                                             int Cout, int K, int device,
                                             void* stream) {
  DC_SET_DEVICE(device);
  return launch_matmul_max<false, __nv_bfloat16, true>(
      x, w, idx, mask, nullptr, mx, nullptr, B, N, Cin, Cout, K, stream, mn);
}
