// y = Drop(relu(x W1^T + b1)) W2^T + b2 in one pass, forward and backward, with
// the (rows, d_ffn) intermediate never in device memory, for Hopper (sm_90a).
//
// Replaces the TPU kernels transformertts_tpu/ops/pallas/fused_ffn.py: _fwd
// (_fwd_kernel, _hidden) and _bwd (_bwd_kernel).  The plain PyTorch version,
// op for op, is fused_ffn_reference / fused_ffn_backward_reference in
// ../fused_ffn.py.  Numerics as the TPU kernel: x, dy of the storage type T
// (bf16 or fp32); the fp32 weights rounded to T as they are loaded; every
// product summed in fp32; hp = x W1^T + b1, relu and dropout (h / (1 - p) or
// 0) in fp32; hd rounded to T before the second product; b2 added in fp32; y
// rounded to T.  Backward: hp, hd and the mask are recomputed from
// (x, W1, b1, seed); dhd = dy W2; dh = dhd where hp > 0 and the element was
// kept (divided by 1 - p), else 0; dh rounded to T for dx = dh W1 and
// dW1 = dh^T x, but db1 sums the fp32 dh; dW2 = dy^T hd with the rounded hd;
// db2 sums dy.  All four parameter gradients are fp32 sums over all rows.
//
// The weights keep the layout of the PyTorch parameters: W1 (F, D), W2
// (D, F), and so do dW1 and dW2.
//
// Bound: operations (4 N D F forward, 10 N D F backward; 12.9 and 32.2 GFLOP
// at N 12,288, D 256, F 1,024).
//
// fp32 forward and backward: fp32 FMAs on the CUDA cores (TF32 would
// break fp32 parity).  A product that needs a weight tile the other way
// round transposes it on its way into shared memory, rounding it to T.  Two
// weight matrices and the intermediate of a row tile do not fit a block's
// shared memory, so a block of 256 threads takes 64 rows and walks over d_ffn
// in slices of 64 columns: the slice's hp is a 64 x 64 tile (every thread a
// 4 x 4 sub-tile, operands staged in chunks of 32 along d_model), it becomes
// hd in registers, goes to shared memory rounded to T, and its product with
// the slice of W2 is added to the block's (64, 256) fp32 output, which stays
// in registers.  A block owns 256 output columns; a wider D takes one block
// per group of 256 columns (blockIdx.y), each of which recomputes the
// slice's intermediate.  The fp32 backward: one kernel gridded over row
// tiles recomputes hp, forms dh slice by slice and owns dx; a second,
// gridded over (slice of 32 d_ffn columns, chunk of rows), recomputes the
// slice's hd and dh and owns that chunk's partial of dW1, db1, dW2, db2; two
// reduce kernels add the chunks' partials in chunk order.  Seven products.
//
// bf16 forward: both products on the tensor cores (wgmma), two launches.
// (1) ffn_stage_weights_kernel rounds the fp32 weights to bf16 once per call
// into scratch, already in the order and the swizzled layout of the
// kernel's shared memory: per d_ffn slice one record of W1's (S, d_model)
// rows and, per group of 256 output columns, W2's (256, S) columns (S = 64
// up to d_model 256, else 32), so that each is one bulk copy (2 MB read and
// 1 MB written at F 1,024, D 256).  (2) ffn_fwd_tc: a block of two
// warpgroups (one above d_model 256) on their own 64-row tiles of x,
// resident in swizzled shared memory; each slice's weights arrive by bulk
// copies into a ring of one to four stages (an mbarrier a stage), refilled
// by the warp that releases a stage last.  Per slice a warpgroup computes hp =
// x W1s^T (m64nS), applies b1, relu, the mask and the exact division by
// 1 - p at each accumulator element (div_rn, no call), packs hd to bf16
// straight into the A registers of y += hd W2s^T (m64n256, A from
// registers) and goes on; the warpgroups meet only at the ring, so one's
// epilogue runs under the other's products.  To fill the card at 2,048 rows
// the fsplit blocks of a cluster split d_ffn and add their fp32 partial y in
// rank order through distributed shared memory (fused_ffn.py:fwd_plan
// picks fsplit and the ring's depth); bias b2, rounding and 16-byte stores
// after.  A wider D takes one block per group of 256 columns, each of which
// recomputes the slice's intermediate.
//
// bf16 backward: every product a wgmma (hopper.cuh) with bf16 operands and
// fp32 sums, from 128B- and 64B-swizzled tiles that cp.async fills; five
// products, four launches.  (1) The fp32 weights are rounded to bf16 once per
// call into scratch (W1 (Fp, Dp), W2 (Dp, Fp), zero-padded to multiples of
// 64; 2 MB read at F 1,024, D 256).  (2) ffn_dh_tc, four warpgroups on one
// row tile of 64, taking its slices of 32 d_ffn columns in turn (blocks
// split d_ffn where that balances the card): hp = x W1s^T and dhd = dy W2s
// (the W2 tiles read MN-major through the transpose bit), relu, mask and
// dropout applied at each accumulator element through its (row, column),
// the division by 1 - p exact without the division's slow path (div_rn); hd
// and dh go to device memory rounded to bf16 and db1 is summed over the
// tile's rows in fp32.  (3) ffn_grad_tc, two warpgroups a block, the three
// products with a long depth, each a 64 x 256 result of m64n256 wgmmas: dW1 =
// dh^T x and dW2^T = hd^T dy per (pair of 64-wide d_ffn slices, chunk of
// rows) with both operands read MN-major from the row tiles as they lie, and
// dx = dh W1 per pair of row tiles over all of d_ffn.  (4) One reduce kernel
// adds the chunks' dW1 / dW2 partials and
// the row tiles' db1 / db2 partials, each in index order.  No float atomics:
// two runs give the same bits.  Rows beyond N and columns beyond D are
// loaded as zeros and add nothing.
//
// The dropout mask is a function of the logical index (dropout_mask.cuh):
// element (row, col) of the intermediate takes salt = g / mask_rows and
// counter = (g % mask_rows) * f_total + col_off + col, where mask_rows is the
// row-block height the TPU kernel would pick (passed in; it shapes nothing
// but the mask), g the global row (row / t_local) * t_total + row % t_local +
// row_off and col_off the call's first d_ffn column of f_total: a call that
// holds some batch rows and d_ffn columns (data and tensor parallelism)
// drops what the whole call drops; (N, N, 0, F, 0) gives g = row and the
// counter (row % mask_rows) * F + col.  The tensor-core kernels are built
// for the whole call's mask (Mask: the one-device call) and for a shard's
// (MaskMap), so the one-device call's argument struct holds no map: the
// map's five integers there moved ptxas's allocation of ffn_fwd_tc.  The
// fp32 kernels take MaskMap.
//
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

#include "dropout_mask.cuh"
#include "hopper.cuh"
#include "numeric.cuh"
#include "sync.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;        // rows of x in a tile
constexpr int kLd = kRows + 4;   // row length of a 64-wide tile in shared memory
constexpr int kKc = 32;          // d_model columns staged at a time
constexpr int kFs = 64;          // d_ffn columns of a slice (forward, dx kernel)
constexpr int kFc = 16;          // slice columns staged at a time for the second product
constexpr int kFb = 32;          // d_ffn columns of a slice (weight-gradient kernel)
constexpr int kLdF = kFb + 4;    // row length of a 32-wide tile
constexpr int kRc = 16;          // rows staged at a time for the weight-gradient products
constexpr int kJ = 4;            // 64-column groups of a thread's output: 4 x 4 values each
constexpr int kDp = 64 * kJ;     // output columns of a block
constexpr int kLdD = kDp + 4;    // row length of a kDp-wide tile in shared memory
constexpr int kTargetBlocks = 264;  // weight-gradient grid: 2 blocks on each of 132 SMs

struct Mask {
  uint32_t seed, threshold;
  int rows;        // height of a mask block
  float keep_div;  // 1 - p
  int on;
  float inv_keep;  // 1 / (1 - p), rounded to nearest on the host
};

struct MaskMap : Mask {
  int t_local, t_total, row_off;  // the global row map
  int f_total, col_off;           // the global d_ffn width and the call's first column
};

// The mask's per-row constants of local row `row` of a call of F columns:
// the block's base and the counter of column 0.
__device__ __forceinline__ void mask_consts(const Mask& mk, int row, int F, uint32_t& base,
                                            uint32_t& cnt0) {
  base = mk.on ? mask_base(mk.seed, static_cast<uint32_t>(row / mk.rows)) : 0u;
  cnt0 = static_cast<uint32_t>(row % mk.rows) * static_cast<uint32_t>(F);
}

// The same through the global row map (the column offset folded in).
__device__ __forceinline__ void mask_consts(const MaskMap& mk, int row, int, uint32_t& base,
                                            uint32_t& cnt0) {
  const int g = (row / mk.t_local) * mk.t_total + row % mk.t_local + mk.row_off;
  base = mk.on ? mask_base(mk.seed, static_cast<uint32_t>(g / mk.rows)) : 0u;
  cnt0 = static_cast<uint32_t>(g % mk.rows) * static_cast<uint32_t>(mk.f_total) +
         static_cast<uint32_t>(mk.col_off);
}

// Rows r0 .. r0 + kNR - 1, columns c0 .. c0 + kNC - 1 of a row-major
// (n_rows, n_cols) matrix of S, transposed into dst[c * kLdDst + r] as floats
// rounded to T; zeros outside the matrix.  Neighbouring lanes take
// neighbouring rows, so the stores meet no bank conflict; every lane reads
// one 16-byte vector along the row.  n_cols and c0 are multiples of vec<S>().
template <typename S, typename T, int kNR, int kNC, int kLdDst>
__device__ __forceinline__ void stage_transposed(float* dst, const S* src, int n_rows, int n_cols,
                                                 int r0, int c0) {
  constexpr int V = vec<S>();
  for (int idx = threadIdx.x; idx < kNR * (kNC / V); idx += kThreads) {
    const int r = idx % kNR, c = (idx / kNR) * V;
    float v[V];
    if (r0 + r < n_rows && c0 + c < n_cols) {
      load16<S>(src + static_cast<size_t>(r0 + r) * n_cols + c0 + c, v);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) dst[(c + i) * kLdDst + r] = round_t<T>(v[i]);
  }
}

// The same window of the matrix as it lies: dst[r * kLdDst + c].
template <typename S, typename T, int kNR, int kNC, int kLdDst>
__device__ __forceinline__ void stage_rows(float* dst, const S* src, int n_rows, int n_cols,
                                           int r0, int c0) {
  constexpr int V = vec<S>();
  constexpr int kVecs = kNC / V;
  for (int idx = threadIdx.x; idx < kNR * kVecs; idx += kThreads) {
    const int r = idx / kVecs, c = (idx % kVecs) * V;
    float v[V];
    if (r0 + r < n_rows && c0 + c < n_cols) {
      load16<S>(src + static_cast<size_t>(r0 + r) * n_cols + c0 + c, v);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(dst + r * kLdDst + c + i) = make_float4(
          round_t<T>(v[i]), round_t<T>(v[i + 1]), round_t<T>(v[i + 2]), round_t<T>(v[i + 3]));
  }
}

// acc[i][j] += sum_k a[k][4 ty + i] * b[k][kW tx + j] over kKc values of k;
// a (kKc, kLd) and b (kKc, kLdB) hold one k per row.  kW is 4 or 2.
template <int kW, int kLdB>
__device__ __forceinline__ void dot_chunk(const float* a, const float* b, int ty, int tx,
                                          float (&acc)[4][kW]) {
#pragma unroll 8
  for (int k = 0; k < kKc; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * kLd + ty * 4);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    float br[kW];
    if constexpr (kW == 4) {
      const float4 bv = *reinterpret_cast<const float4*>(b + k * kLdB + tx * 4);
      br[0] = bv.x; br[1] = bv.y; br[2] = bv.z; br[3] = bv.w;
    } else {
      const float2 bv = *reinterpret_cast<const float2*>(b + k * kLdB + tx * 2);
      br[0] = bv.x; br[1] = bv.y;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kW; ++j) acc[i][j] += ar[i] * br[j];
  }
}

// acc[i][4 g + j] += sum_c p[c][4 ty + i] * b[c][64 g + 4 tx + j] over n values
// of c: p (n, kLd) by column of the tile, b (n, kLdD) by row.
__device__ __forceinline__ void wide_chunk(const float* p, const float* b, int n, int ty, int tx,
                                           float (&acc)[4][4 * kJ]) {
#pragma unroll 4
  for (int c = 0; c < n; ++c) {
    const float4 pv = *reinterpret_cast<const float4*>(p + c * kLd + ty * 4);
    const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
    for (int g = 0; g < kJ; ++g) {
      const float4 bv = *reinterpret_cast<const float4*>(b + c * kLdD + g * 64 + tx * 4);
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][g * 4 + j] += pr[i] * br[j];
    }
  }
}

// One element of the intermediate from its raw product: hd (fp32, not yet
// rounded) and whether a gradient passes (hp > 0 and kept).  col >= F gives
// zeros: the weights beyond F are staged as zeros and no bias is read.
__device__ __forceinline__ float hidden(float dot, const float* b1, int F, int col, uint32_t base,
                                        uint32_t cnt0, const Mask& mk, bool& pass) {
  const float hp = dot + (col < F ? b1[col] : 0.f);
  const bool keep =
      !mk.on || mask_keep(base, cnt0 + static_cast<uint32_t>(col), mk.threshold);
  pass = hp > 0.f && keep;
  const float h = fmaxf(hp, 0.f);
  if (!mk.on) return h;
  return keep ? h / mk.keep_div : 0.f;
}

// Per-row constants of the mask for the 4 rows of a thread.
__device__ __forceinline__ void mask_rows4(const MaskMap& mk, int row0, int F,
                                           uint32_t (&base)[4], uint32_t (&cnt0)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) mask_consts(mk, row0 + i, F, base[i], cnt0[i]);
}

// 4 floats rounded to T at p (aligned to 4 elements of T)
template <typename T> __device__ __forceinline__ void store4(T* p, const float* v);
template <> __device__ __forceinline__ void store4<float>(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// The block's (64, kDp) fp32 result, plus bias when given, to the first
// n_cols columns at out, whose rows are ld apart.
template <typename T>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[4][4 * kJ],
                                           const float* bias, int N, int n_cols, int ld,
                                           int row0, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= N) continue;
#pragma unroll
    for (int g = 0; g < kJ; ++g) {
      const int col = g * 64 + tx * 4;
      if (col >= n_cols) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = acc[i][g * 4 + j] + (bias ? bias[col + j] : 0.f);
      store4<T>(out + static_cast<size_t>(row) * ld + col, v);
    }
  }
}

// ------------------------------------------------------------------ forward

constexpr size_t kFwdSmem = sizeof(float) * (2 * kKc * kLd + kFs * kLd + kFc * kLdD);

template <typename T>
__global__ void __launch_bounds__(kThreads)
ffn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, T* __restrict__ y, int N, int D, int F, MaskMap mk) {
  extern __shared__ __align__(16) float smem[];
  float* Xc = smem;              // (kKc, kLd): x by column of the tile
  float* W1c = Xc + kKc * kLd;   // (kKc, kLd): W1 slice, one d_model index per row
  float* Ht = W1c + kKc * kLd;   // (kFs, kLd): hd rounded to T, one d_ffn index per row
  float* W2c = Ht + kFs * kLd;   // (kFc, kLdD): W2 slice, one d_ffn index per row
  const int row0 = blockIdx.x * kRows, d0 = blockIdx.y * kDp;
  const float* w2g = w2 + static_cast<size_t>(d0) * F;  // the group's rows of W2
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  float acc[4][4 * kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * kJ; ++j) acc[i][j] = 0.f;
  uint32_t base[4], cnt0[4];
  mask_rows4(mk, row0 + ty * 4, F, base, cnt0);

  for (int f0 = 0; f0 < F; f0 += kFs) {
    float hp[4][4] = {};
    for (int k0 = 0; k0 < D; k0 += kKc) {
      __syncthreads();  // the previous chunk's (and slice's) reads are done
      stage_transposed<T, T, kRows, kKc, kLd>(Xc, x, N, D, row0, k0);
      stage_transposed<float, T, kFs, kKc, kLd>(W1c, w1, F, D, f0, k0);
      __syncthreads();
      dot_chunk<4, kLd>(Xc, W1c, ty, tx, hp);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = f0 + tx * 4 + j;
      float hd[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bool pass;
        hd[i] = round_t<T>(hidden(hp[i][j], b1, F, col, base[i], cnt0[i], mk, pass));
      }
      *reinterpret_cast<float4*>(Ht + (tx * 4 + j) * kLd + ty * 4) =
          make_float4(hd[0], hd[1], hd[2], hd[3]);
    }
    for (int fc = 0; fc < kFs; fc += kFc) {
      __syncthreads();  // Ht is written; the previous chunk's reads are done
      stage_transposed<float, T, kDp, kFc, kLdD>(W2c, w2g, D - d0, F, 0, f0 + fc);
      __syncthreads();
      wide_chunk(Ht + fc * kLd, W2c, kFc, ty, tx, acc);
    }
  }
  store_rows<T>(y + d0, acc, b2 + d0, N, D - d0, D, row0, ty, tx);
}

// ----------------------------------------------------------------- backward

constexpr size_t kDxSmem = sizeof(float) * (4 * kKc * kLd + kFs * kLd + kFc * kLdD);

// Columns d0 .. of dx for one row tile: dh slice by slice, then its product
// with the W1 slice.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ffn_dx_kernel(const T* __restrict__ x, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ w2,
              const T* __restrict__ dy, T* __restrict__ dx, int N, int D, int F, MaskMap mk) {
  extern __shared__ __align__(16) float smem[];
  float* Xc = smem;               // (kKc, kLd): x by column of the tile
  float* Yc = Xc + kKc * kLd;     // (kKc, kLd): dy by column of the tile
  float* W1c = Yc + kKc * kLd;    // (kKc, kLd): W1 slice, one d_model index per row
  float* W2c = W1c + kKc * kLd;   // (kKc, kLd): W2 slice, one d_model index per row
  float* Gt = W2c + kKc * kLd;    // (kFs, kLd): dh rounded to T, one d_ffn index per row
  float* W1r = Gt + kFs * kLd;    // (kFc, kLdD): W1 slice rows as they lie
  const int row0 = blockIdx.x * kRows, d0 = blockIdx.y * kDp;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  float acc[4][4 * kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * kJ; ++j) acc[i][j] = 0.f;
  uint32_t base[4], cnt0[4];
  mask_rows4(mk, row0 + ty * 4, F, base, cnt0);

  for (int f0 = 0; f0 < F; f0 += kFs) {
    float hp[4][4] = {}, dhd[4][4] = {};
    for (int k0 = 0; k0 < D; k0 += kKc) {
      __syncthreads();
      stage_transposed<T, T, kRows, kKc, kLd>(Xc, x, N, D, row0, k0);
      stage_transposed<T, T, kRows, kKc, kLd>(Yc, dy, N, D, row0, k0);
      stage_transposed<float, T, kFs, kKc, kLd>(W1c, w1, F, D, f0, k0);
      stage_rows<float, T, kKc, kFs, kLd>(W2c, w2, D, F, k0, f0);
      __syncthreads();
      dot_chunk<4, kLd>(Xc, W1c, ty, tx, hp);
      dot_chunk<4, kLd>(Yc, W2c, ty, tx, dhd);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = f0 + tx * 4 + j;
      float dh[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bool pass;
        hidden(hp[i][j], b1, F, col, base[i], cnt0[i], mk, pass);
        const float g = mk.on ? dhd[i][j] / mk.keep_div : dhd[i][j];
        dh[i] = round_t<T>(pass ? g : 0.f);
      }
      *reinterpret_cast<float4*>(Gt + (tx * 4 + j) * kLd + ty * 4) =
          make_float4(dh[0], dh[1], dh[2], dh[3]);
    }
    for (int fc = 0; fc < kFs; fc += kFc) {
      __syncthreads();
      stage_rows<float, T, kFc, kDp, kLdD>(W1r, w1, F, D, f0 + fc, d0);
      __syncthreads();
      wide_chunk(Gt + fc * kLd, W1r, kFc, ty, tx, acc);
    }
  }
  store_rows<T>(dx + d0, acc, nullptr, N, D - d0, D, row0, ty, tx);
}

constexpr size_t kDwSmem =
    sizeof(float) * (2 * kKc * kLd + 2 * kKc * kLdF + 2 * kRows * kLdF + 2 * kRc * kLdD + 16 * kFb);

// The partial sums of one chunk of rows for one slice of kFb d_ffn columns.
// pflat holds one record of F D + F + D floats per chunk, dW1 (F, D) | db1
// (F) | db2 (D); pw2 (chunks, F, D) the transpose of dW2.  blockIdx.x is the
// slice, blockIdx.y the chunk of `chunk_rows` rows (a multiple of 64),
// blockIdx.z the group of kDp d_model columns of dW1, dW2 and db2 it owns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ffn_dw_kernel(const T* __restrict__ x, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ w2,
              const T* __restrict__ dy, float* __restrict__ pflat, float* __restrict__ pw2,
              int N, int D, int F, int chunk_rows, MaskMap mk) {
  extern __shared__ __align__(16) float smem[];
  float* Xc = smem;                // (kKc, kLd): x by column of the tile
  float* Yc = Xc + kKc * kLd;      // (kKc, kLd): dy by column of the tile
  float* W1c = Yc + kKc * kLd;     // (kKc, kLdF): W1 slice, one d_model index per row
  float* W2c = W1c + kKc * kLdF;   // (kKc, kLdF): W2 slice, one d_model index per row
  float* Hd = W2c + kKc * kLdF;    // (kRows, kLdF): hd rounded to T, by row
  float* Dh = Hd + kRows * kLdF;   // (kRows, kLdF): dh rounded to T, by row
  float* Xr = Dh + kRows * kLdF;   // (kRc, kLdD): rows of x as they lie
  float* Yr = Xr + kRc * kLdD;     // (kRc, kLdD): rows of dy as they lie
  float* red = Yr + kRc * kLdD;    // (16, kFb): db1 of the 16 thread rows
  const int f0 = blockIdx.x * kFb;
  const int chunk = blockIdx.y, d0 = blockIdx.z * kDp;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row_end = min(N, (chunk + 1) * chunk_rows);

  // products 3 and 4: this thread owns d_ffn columns f0 + 2 ty + {0, 1} and
  // d_model columns d0 + 64 g + 4 tx + {0..3}
  float dw1[2][4 * kJ], dw2[2][4 * kJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4 * kJ; ++j) dw1[i][j] = dw2[i][j] = 0.f;
  float sb1[2] = {0.f, 0.f};  // db1 of columns f0 + 2 tx + {0, 1} over this thread's rows
  float sb2 = 0.f;            // db2 of column d0 + threadIdx.x (first slice only)

  for (int row0 = chunk * chunk_rows; row0 < row_end; row0 += kRows) {
    // products 1 and 2: rows 4 ty + {0..3}, d_ffn columns f0 + 2 tx + {0, 1}
    float hp[4][2] = {}, dhd[4][2] = {};
    for (int k0 = 0; k0 < D; k0 += kKc) {
      __syncthreads();
      stage_transposed<T, T, kRows, kKc, kLd>(Xc, x, N, D, row0, k0);
      stage_transposed<T, T, kRows, kKc, kLd>(Yc, dy, N, D, row0, k0);
      stage_transposed<float, T, kFb, kKc, kLdF>(W1c, w1, F, D, f0, k0);
      stage_rows<float, T, kKc, kFb, kLdF>(W2c, w2, D, F, k0, f0);
      __syncthreads();
      dot_chunk<2, kLdF>(Xc, W1c, ty, tx, hp);
      dot_chunk<2, kLdF>(Yc, W2c, ty, tx, dhd);
    }
    uint32_t base[4], cnt0[4];
    mask_rows4(mk, row0 + ty * 4, F, base, cnt0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float hd[2], dh[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        bool pass;
        hd[j] = round_t<T>(
            hidden(hp[i][j], b1, F, f0 + tx * 2 + j, base[i], cnt0[i], mk, pass));
        const float g = mk.on ? dhd[i][j] / mk.keep_div : dhd[i][j];
        const float d = pass ? g : 0.f;
        sb1[j] += d;
        dh[j] = round_t<T>(d);
      }
      *reinterpret_cast<float2*>(Hd + (ty * 4 + i) * kLdF + tx * 2) = make_float2(hd[0], hd[1]);
      *reinterpret_cast<float2*>(Dh + (ty * 4 + i) * kLdF + tx * 2) = make_float2(dh[0], dh[1]);
    }
    for (int rc = 0; rc < kRows; rc += kRc) {
      __syncthreads();  // Hd, Dh are written; the previous chunk's reads are done
      stage_rows<T, T, kRc, kDp, kLdD>(Xr, x, N, D, row0 + rc, d0);
      stage_rows<T, T, kRc, kDp, kLdD>(Yr, dy, N, D, row0 + rc, d0);
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kRc; ++r) {
        const float2 gv = *reinterpret_cast<const float2*>(Dh + (rc + r) * kLdF + ty * 2);
        const float2 hv = *reinterpret_cast<const float2*>(Hd + (rc + r) * kLdF + ty * 2);
        const float gr[2] = {gv.x, gv.y}, hr[2] = {hv.x, hv.y};
#pragma unroll
        for (int g = 0; g < kJ; ++g) {
          const float4 xv = *reinterpret_cast<const float4*>(Xr + r * kLdD + g * 64 + tx * 4);
          const float4 yv = *reinterpret_cast<const float4*>(Yr + r * kLdD + g * 64 + tx * 4);
          const float xr[4] = {xv.x, xv.y, xv.z, xv.w}, yr[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              dw1[i][g * 4 + j] += gr[i] * xr[j];
              dw2[i][g * 4 + j] += hr[i] * yr[j];
            }
        }
      }
      if (blockIdx.x == 0 && d0 + threadIdx.x < D) {
#pragma unroll
        for (int r = 0; r < kRc; ++r) sb2 += Yr[r * kLdD + threadIdx.x];
      }
    }
  }

  const size_t fd = static_cast<size_t>(F) * D;
  float* rec = pflat + static_cast<size_t>(chunk) * (fd + F + D);
  float* rec2 = pw2 + static_cast<size_t>(chunk) * fd;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int f = f0 + ty * 2 + i;
    if (f >= F) continue;
#pragma unroll
    for (int g = 0; g < kJ; ++g) {
      const int col = d0 + g * 64 + tx * 4;
      if (col >= D) continue;
      const size_t at = static_cast<size_t>(f) * D + col;
      *reinterpret_cast<float4*>(rec + at) =
          make_float4(dw1[i][g * 4], dw1[i][g * 4 + 1], dw1[i][g * 4 + 2], dw1[i][g * 4 + 3]);
      *reinterpret_cast<float4*>(rec2 + at) =
          make_float4(dw2[i][g * 4], dw2[i][g * 4 + 1], dw2[i][g * 4 + 2], dw2[i][g * 4 + 3]);
    }
  }
  // db1: the 16 thread rows' sums, added in thread-row order (every column
  // group holds the same sums; the first writes them)
  red[ty * kFb + tx * 2] = sb1[0];
  red[ty * kFb + tx * 2 + 1] = sb1[1];
  __syncthreads();
  if (blockIdx.z == 0 && threadIdx.x < kFb && f0 + threadIdx.x < F) {
    float s = 0.f;
    for (int t = 0; t < 16; ++t) s += red[t * kFb + threadIdx.x];
    rec[fd + f0 + threadIdx.x] = s;
  }
  if (blockIdx.x == 0 && d0 + threadIdx.x < D) rec[fd + F + d0 + threadIdx.x] = sb2;
}

// out[i] = sum over chunks of part[chunk][i], in chunk order.
__global__ void ffn_reduce_kernel(const float* __restrict__ part, int chunks, size_t n,
                                  float* __restrict__ out) {
  const size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += part[static_cast<size_t>(c) * n + i];
  out[i] = s;
}

// out (D, F) = transpose of the sum over chunks of part (chunks, F, D), in
// chunk order; 32 x 32 tiles through shared memory, block (32, 8).
__global__ void ffn_reduce_transposed_kernel(const float* __restrict__ part, int chunks, int F,
                                             int D, float* __restrict__ out) {
  __shared__ float tile[32][33];
  const int f0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int f = f0 + i, d = d0 + threadIdx.x;
    float s = 0.f;
    if (f < F && d < D)
      for (int c = 0; c < chunks; ++c) s += part[(static_cast<size_t>(c) * F + f) * D + d];
    tile[i][threadIdx.x] = s;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int d = d0 + i, f = f0 + threadIdx.x;
    if (d < D && f < F) out[static_cast<size_t>(d) * F + f] = tile[threadIdx.x][i];
  }
}

// -------------------------------------------- bf16 backward, tensor cores

constexpr int kWg = 128;                     // one warpgroup per block
constexpr int kT = 64;                       // rows of a row tile; columns of a slice, a chunk
constexpr int kGc = 4;                       // d_model chunks of a group: 256 columns
constexpr int kGw = kGc * kT;                // columns of a group
constexpr int kS = 32;                       // d_ffn columns of a slice of the dx kernel
constexpr uint32_t kTileB = kT * kT * 2;     // one swizzled (64, 64) bf16 tile
constexpr uint32_t kHalfB = kS * kT * 2;     // one (32, 64) or (64, 32) tile
constexpr int kDhWgs = 4;                        // warpgroups of the dh kernel
constexpr uint32_t kDhStage = 2 * kGc * kHalfB;  // a slice's W1 and W2 tiles
constexpr size_t kDhSmem =                       // x, dy; a stage a warpgroup; column sums
    2 * kGc * kTileB + kDhWgs * kDhStage + kDhWgs * 4 * kS * sizeof(float) + 1024;
constexpr int kDwStages = 4;
constexpr size_t kDwSmemTc = kDwStages * (2 + kGc) * kTileB + 1024;

template <typename M>
struct TcArgs {
  const bf16* x;    // (N, D)
  const bf16* dy;   // (N, D)
  const bf16* w1;   // (Fp, Dp): W1 rounded to bf16, zeros past F and D
  const bf16* w2;   // (Dp, Fp): W2 the same
  const float* b1;  // (F)
  bf16* dx;         // (N, D)
  bf16* dh;         // (N, Fp): dh rounded to bf16
  bf16* hd;         // (N, Fp): hd rounded to bf16
  float* pdb1;      // (tiles, F): db1 of each row tile
  float* pdb2;      // (tiles, D): db2 of each row tile
  float* pw1;       // (chunks, F, D): dW1 of each chunk of rows
  float* pw2;       // (chunks, D, F): dW2 of each chunk of rows
  int N, D, F, Dp, Fp;
  int spg, fgroups;  // slices of 32 d_ffn columns per group of the dh kernel, groups
  int tpc, chunks;   // row tiles per chunk of the weight-gradient kernel, chunks
  M mk;
};

// W1 (F, D) and W2 (D, F) fp32 -> bf16 (Fp, Dp) and (Dp, Fp), zero-padded;
// two elements a thread.
__global__ void ffn_cast_weights_kernel(const float* __restrict__ w1, const float* __restrict__ w2,
                                        bf16* __restrict__ w1b, bf16* __restrict__ w2b, int D,
                                        int F, int Dp, int Fp) {
  const size_t pairs = static_cast<size_t>(Fp) * Dp / 2;
  for (size_t q = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; q < 2 * pairs;
       q += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const bool second = q >= pairs;
    const size_t e = 2 * (second ? q - pairs : q);
    float2 v = make_float2(0.f, 0.f);
    if (!second) {  // w1b[f][d]
      const int f = static_cast<int>(e / Dp), d = static_cast<int>(e % Dp);
      if (f < F && d < D) v = *reinterpret_cast<const float2*>(w1 + static_cast<size_t>(f) * D + d);
      reinterpret_cast<__nv_bfloat162*>(w1b)[e / 2] = __floats2bfloat162_rn(v.x, v.y);
    } else {  // w2b[d][f]
      const int d = static_cast<int>(e / Fp), f = static_cast<int>(e % Fp);
      if (d < D && f < F) v = *reinterpret_cast<const float2*>(w2 + static_cast<size_t>(d) * F + f);
      reinterpret_cast<__nv_bfloat162*>(w2b)[e / 2] = __floats2bfloat162_rn(v.x, v.y);
    }
  }
}

// hd, dh and the bias partials of one row tile for one group of d_ffn
// slices.  Four warpgroups share the tile's x and dy, which stay in shared
// memory (D <= 256), and take the group's slices of 32 d_ffn columns in
// turn, each with its own weight stage.  Per slice: hp = x W1s^T and dhd =
// dy W2s over all of d_model (the W2 tiles read MN-major); relu, mask and
// dropout at each accumulator element, the division by 1 - p exact
// (div_rn); hd and dh to device memory rounded to bf16, db1 of the tile's
// rows in fp32.  As soon as a warpgroup's two products are done its stage
// loads its next slice, under its epilogue.  Wider d_model: the warpgroups
// go in step, and every K group of 256 columns loads x, dy and weights and
// waits.  blockIdx: (row tile, group of slices).
template <typename M>
__global__ void __launch_bounds__(kDhWgs * kWg, 1) ffn_dh_tc(const TcArgs<M> a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  // the warpgroup index through a shuffle, so that the compiler knows it is
  // the same across each warp: wgmma under a branch it takes for divergent
  // is serialized
  const int tid = threadIdx.x % kWg, wg = __shfl_sync(0xffffffffu, threadIdx.x / kWg, 0);
  const int warp = tid / 32, lane = tid % 32;
  const uint32_t sX = smem_addr(base), sY = sX + kGc * kTileB;
  uint8_t* pStages = base + 2 * kGc * kTileB;
  const uint32_t w1s = smem_addr(pStages) + wg * kDhStage, w2s = w1s + kGc * kHalfB;
  float* red = reinterpret_cast<float*>(pStages + kDhWgs * kDhStage) + wg * 4 * kS;
  const int tile = blockIdx.x, row0 = tile * kT, fg = blockIdx.y;
  const int n_kg = (a.D + kGw - 1) / kGw;
  const bool lockstep = n_kg > 1;
  const int s0 = fg * a.spg, s1 = min(a.Fp / kS, s0 + a.spg);
  const int rounds = (s1 - s0 + kDhWgs - 1) / kDhWgs;

  // db2 of this tile's rows: 16-byte loads, 16 row phases added in order
  if (fg == 0) {
    float* red2 = reinterpret_cast<float*>(pStages);  // (16, 256), before any tile lands there
    for (int c0 = 0; c0 < a.D; c0 += kGw) {
      const int col = c0 + (threadIdx.x % 32) * 8, ph = threadIdx.x / 32;
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = ph; r < kT; r += 16) {
        if (row0 + r < a.N && col < a.D) {
          float v[8];
          load16<bf16>(a.dy + static_cast<size_t>(row0 + r) * a.D + col, v);
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] += v[i];
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) red2[ph * kGw + (threadIdx.x % 32) * 8 + i] = acc[i];
      __syncthreads();
      if (threadIdx.x < kGw && c0 + threadIdx.x < a.D) {
        float s = red2[threadIdx.x];
#pragma unroll
        for (int p = 1; p < 16; ++p) s += red2[p * kGw + threadIdx.x];
        a.pdb2[static_cast<size_t>(tile) * a.D + c0 + threadIdx.x] = s;
      }
      __syncthreads();
    }
  }

  auto load_xdy = [&](int kg) {  // chunk wg of x and dy by warpgroup wg
    const int c0 = kg * kGw + wg * kT;
    if (wg < kGc && c0 < a.Dp) {
      load_tile_async<kT>(sX + wg * kTileB, a.x, a.D, row0, a.N, c0, a.D, tid);
      load_tile_async<kT>(sY + wg * kTileB, a.dy, a.D, row0, a.N, c0, a.D, tid);
    }
  };
  auto load_w = [&](int s, int kg) {  // this warpgroup's stage
#pragma unroll
    for (int j = 0; j < kGc; ++j) {
      const int c0 = kg * kGw + j * kT;
      if (c0 >= a.Dp) continue;
      load_tile_async<kT, kS>(w1s + j * kHalfB, a.w1 + c0, a.Dp, s * kS, a.Fp, tid);
      load_tile_async<kS>(w2s + j * kHalfB, a.w2 + s * kS, a.Fp, c0, a.Dp, tid);
    }
  };

  int rows[2];
  uint32_t mbase[2], cnt0[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rows[h] = row0 + acc_row(tid, h);
    mask_consts(a.mk, rows[h], a.F, mbase[h], cnt0[h]);
  }
  float hp[16], dhd[16];

  if (!lockstep) {
    load_xdy(0);
    if (s0 + wg < s1) load_w(s0 + wg, 0);
    cp_async_commit();
  }
  for (int r = 0; r < rounds; ++r) {
    const int s = s0 + r * kDhWgs + wg;
    const bool live = s < s1;
    for (int kg = 0; kg < n_kg; ++kg) {
      if (lockstep) {
        __syncthreads();  // every read of the previous tiles is done
        load_xdy(kg);
        if (live) load_w(s, kg);
        cp_async_commit();
        cp_async_wait<0>();
        fence_async_shared();
        __syncthreads();
      } else {
        cp_async_wait<0>();
        fence_async_shared();
        if (r == 0) __syncthreads();  // x and dy landed for every warpgroup
        else warpgroup_sync(1 + wg);  // this warpgroup's stage landed
      }
      if (!live) continue;
      const int nc = min(kGc, (a.Dp - kg * kGw) / kT);
      if (kg == 0) {
#pragma unroll
        for (int i = 0; i < 16; ++i) hp[i] = dhd[i] = 0.f;
      }
      fence_regs(hp);
      fence_regs(dhd);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kGc; ++j) {
        if (j >= nc) continue;
        const uint64_t da = make_desc<kT>(sX + j * kTileB), db = make_desc<kT>(w1s + j * kHalfB);
#pragma unroll
        for (int kk = 0; kk < kT / 16; ++kk) wgmma_ss_n32<0, 0>(hp, da + 2 * kk, db + 2 * kk);
      }
      wgmma_commit();
#pragma unroll
      for (int j = 0; j < kGc; ++j) {
        if (j >= nc) continue;
        const uint64_t da = make_desc<kT>(sY + j * kTileB), db = make_desc<kS>(w2s + j * kHalfB);
#pragma unroll
        for (int kk = 0; kk < kT / 16; ++kk) wgmma_ss_n32<0, 1>(dhd, da + 2 * kk, db + 64 * kk);
      }
      wgmma_commit();
      if (kg + 1 < n_kg) {  // more of d_model to sum before the slice is done
        wgmma_wait<0>();
        fence_regs(hp);
        fence_regs(dhd);
        continue;
      }
      float2 bias[4];  // the slice's bias at this thread's columns
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = s * kS + 8 * j + 2 * (tid % 4);
        bias[j] = col < a.F ? *reinterpret_cast<const float2*>(a.b1 + col) : make_float2(0.f, 0.f);
      }
      // hp is done while dhd may still run: hd, and which elements pass
      wgmma_wait<1>();
      fence_regs(hp);
      uint32_t pass_bits = 0u, keep_bits = 0u;
      float hv[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int h = (i / 2) % 2, col = s * kS + acc_col(tid, i);
        const float v = hp[i] + (i % 2 ? bias[i / 4].y : bias[i / 4].x);
        const bool keep =
            !a.mk.on || mask_keep(mbase[h], cnt0[h] + static_cast<uint32_t>(col), a.mk.threshold);
        keep_bits |= (keep ? 1u : 0u) << i;
        pass_bits |= (v > 0.f && keep ? 1u : 0u) << i;
        hv[i] = fmaxf(v, 0.f);
      }
      if (a.mk.on) div_rn(hv, a.mk.keep_div, a.mk.inv_keep);
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int h = (i / 2) % 2, col = s * kS + acc_col(tid, i);
        if (rows[h] < a.N)
          *reinterpret_cast<__nv_bfloat162*>(a.hd + static_cast<size_t>(rows[h]) * a.Fp + col) =
              __floats2bfloat162_rn((keep_bits >> i) & 1u ? hv[i] : 0.f,
                                    (keep_bits >> (i + 1)) & 1u ? hv[i + 1] : 0.f);
      }
      wgmma_wait<0>();
      fence_regs(dhd);
      if (!lockstep && s + kDhWgs < s1) {  // this stage is free: the next slice loads under the epilogue
        load_w(s + kDhWgs, 0);
        cp_async_commit();
      }
      // dh (fp32), its column sums over the tile's rows, dh rounded to bf16
      if (a.mk.on) div_rn(dhd, a.mk.keep_div, a.mk.inv_keep);
#pragma unroll
      for (int i = 0; i < 16; ++i) dhd[i] = ((pass_bits >> i) & 1u) ? dhd[i] : 0.f;
      float colsum[8];  // column 8 (k / 2) + 2 c + k % 2: rows h = 0 and 1
#pragma unroll
      for (int k = 0; k < 8; ++k)
        colsum[k] = dhd[4 * (k / 2) + k % 2] + dhd[4 * (k / 2) + k % 2 + 2];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
#pragma unroll
        for (int k = 0; k < 8; ++k) colsum[k] += __shfl_xor_sync(0xffffffffu, colsum[k], o);
      if (lane < 4) {
#pragma unroll
        for (int k = 0; k < 8; ++k) red[warp * kS + 8 * (k / 2) + 2 * lane + k % 2] = colsum[k];
      }
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int h = (i / 2) % 2, col = s * kS + acc_col(tid, i);
        if (rows[h] < a.N)
          *reinterpret_cast<__nv_bfloat162*>(a.dh + static_cast<size_t>(rows[h]) * a.Fp + col) =
              __floats2bfloat162_rn(dhd[i], dhd[i + 1]);
      }
      warpgroup_sync(1 + wg);  // this warpgroup's column sums are in red
      if (tid < kS && s * kS + tid < a.F)
        a.pdb1[static_cast<size_t>(tile) * a.F + s * kS + tid] =
            red[tid] + red[kS + tid] + red[2 * kS + tid] + red[3 * kS + tid];
    }
  }
}

// The products over a long depth, one launch: per (pair of 64-wide
// d_ffn slices, chunk of rows), product 0 dW1 (64 f x 256 d) = dh^T x and
// product 1 dW2^T (64 f x 256 d) = hd^T dy (partial sums of the chunk);
// product 2, per pair of row tiles, dx (64 rows x 256 d) = dh W1 over all of
// d_ffn.  Two warpgroups a block: on two slices sharing the x or dy tiles
// (products 0, 1), on two row tiles sharing the W1 tiles (product 2).  Each
// warpgroup's 64 x 256 result is one m64n256 product a depth step of 16,
// from its own (64, 64) tile (dh or hd rows read MN-major; dh read K-major
// for dx) and the four shared (64, 64) tiles of a group of 256 d_model
// columns read as one MN-major operand 256 wide (x or dy rows, W1 rows).
// Tiles by cp.async into a four-stage ring, two ahead of the products, which
// run one behind their issue.  blockIdx.x: the weight-gradient blocks (pair
// of slices fastest, then chunk, product, group), then the dx blocks (pair
// of row tiles, group).
__global__ void __launch_bounds__(2 * kWg, 1) ffn_grad_tc(const TcArgs<Mask> a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  constexpr uint32_t kStage = (2 + kGc) * kTileB;  // the two own tiles, then the shared ones
  const uint32_t sBase = smem_addr(base);
  const int tid = threadIdx.x % kWg, wg = __shfl_sync(0xffffffffu, threadIdx.x / kWg, 0);
  const int tiles = (a.N + kT - 1) / kT, slices = a.Fp / kT;
  const int n_dg = (a.D + kGw - 1) / kGw, pairs = (slices + 1) / 2;
  const int dw_blocks = pairs * a.chunks * 2 * n_dg;
  int b = blockIdx.x, prod, dg, own, t0, t1;
  if (b < dw_blocks) {
    own = 2 * (b % pairs) + wg;  // slice
    b /= pairs;
    const int chunk = b % a.chunks;
    b /= a.chunks;
    prod = b / n_dg;
    dg = b % n_dg;
    t0 = chunk * a.tpc;
    t1 = min(tiles, t0 + a.tpc);
  } else {
    b -= dw_blocks;
    prod = 2;
    own = 2 * (b % ((tiles + 1) / 2)) + wg;  // row tile
    dg = b / ((tiles + 1) / 2);
    t0 = 0;
    t1 = slices;
  }
  const bool live = own < (prod == 2 ? tiles : slices);

  auto load = [&](int t, uint32_t st) {  // each warpgroup its own tile and half of the shared
    if (prod == 2) {
      if (live) load_tile_async<kT>(st + wg * kTileB, a.dh + t * kT, a.Fp, own * kT, a.N, tid);
    } else if (live) {
      load_tile_async<kT>(st + wg * kTileB, (prod == 0 ? a.dh : a.hd) + own * kT, a.Fp, t * kT,
                          a.N, tid);
    }
#pragma unroll
    for (int jj = 0; jj < kGc / 2; ++jj) {  // columns past D (or Dp) as zeros
      const int j = wg * (kGc / 2) + jj, c0 = dg * kGw + j * kT;
      if (prod == 2)
        load_tile_async<kT>(st + (2 + j) * kTileB, a.w1, a.Dp, t * kT, a.Fp, c0, a.Dp, tid);
      else
        load_tile_async<kT>(st + (2 + j) * kTileB, prod == 0 ? a.x : a.dy, a.D, t * kT, a.N, c0,
                            a.D, tid);
    }
    cp_async_commit();
  };

  float acc[4 * kT / 2];  // 64 x 256
#pragma unroll
  for (int i = 0; i < 4 * kT / 2; ++i) acc[i] = 0.f;
  // four stages: steps t + 1 and t + 2 load while the products of t - 1 and
  // t run; every iteration commits one copy group, empty past the end
  if (t0 < t1) load(t0, sBase);
  if (t0 + 1 < t1) load(t0 + 1, sBase + kStage); else cp_async_commit();
  for (int t = t0; t < t1; ++t) {
    cp_async_wait<1>();
    fence_async_shared();
    __syncthreads();  // step t landed in both halves; the products of t - 2 are done
    if (t + 2 < t1) load(t + 2, sBase + ((t + 2 - t0) % kDwStages) * kStage);
    else cp_async_commit();
    if (!live) continue;
    const uint32_t st = sBase + ((t - t0) % kDwStages) * kStage;
    const uint64_t dso = make_desc<kT>(st + wg * kTileB);
    const uint64_t dsh = make_desc_lbo<kT>(st + 2 * kTileB, kTileB);  // 256 wide
    fence_regs(acc);
    wgmma_fence();
    if (prod == 2) {  // dh K-major (depth along its row), W1 MN-major
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) wgmma_ss_n256<0, 1>(acc, dso + 2 * kk, dsh + 128 * kk);
    } else {  // dh or hd MN-major, x or dy MN-major
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) wgmma_ss_n256<1, 1>(acc, dso + 128 * kk, dsh + 128 * kk);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the products of t - 1 are done
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (!live) return;

  const int chunk = prod == 2 ? 0 : t0 / a.tpc;
  const size_t fd = static_cast<size_t>(a.F) * a.D;
#pragma unroll
  for (int i = 0; i < 4 * kT / 2; i += 2) {
    const int m = own * kT + acc_row(tid, (i / 2) % 2), d = dg * kGw + acc_col(tid, i);
    if (d >= a.D) continue;
    if (prod == 0) {  // (f, d) of dW1
      if (m < a.F)
        *reinterpret_cast<float2*>(a.pw1 + chunk * fd + static_cast<size_t>(m) * a.D + d) =
            make_float2(acc[i], acc[i + 1]);
    } else if (prod == 1) {  // (f, d) of dW2^T, stored as dW2 (d, f)
      if (m < a.F) {
        float* at = a.pw2 + chunk * fd + static_cast<size_t>(d) * a.F + m;
        at[0] = acc[i];
        at[a.F] = acc[i + 1];
      }
    } else if (m < a.N) {  // (row, d) of dx
      *reinterpret_cast<__nv_bfloat162*>(a.dx + static_cast<size_t>(m) * a.D + d) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

// One launch for every sum of partials, each in the order of its partials.
// Blocks below `bias_blocks`: one warp per 4 columns of db1 | db2 over the
// row tiles (lane l takes tiles l, l + 32, ...; lanes then added in a fixed
// tree).  The others: one thread per 4 values of dW1 and dW2 over the chunks.
// grads: dW1 (F, D) | db1 (F) | db2 (D) | dW2 (D, F).
__global__ void __launch_bounds__(256) ffn_reduce_tc(const TcArgs<Mask> a,
                                                     float* __restrict__ grads, int bias_blocks) {
  const int tiles = (a.N + kT - 1) / kT;
  const size_t fd = static_cast<size_t>(a.F) * a.D;
  if (static_cast<int>(blockIdx.x) < bias_blocks) {
    const int w = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
    const int qf = a.F / 4, qd = a.D / 4;
    if (w >= qf + qd) return;
    const bool b1 = w < qf;
    const int width = b1 ? a.F : a.D, col = 4 * (b1 ? w : w - qf);
    const float* src = (b1 ? a.pdb1 : a.pdb2) + col;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int t = lane; t < tiles; t += 32)
      add4(s, *reinterpret_cast<const float4*>(src + static_cast<size_t>(t) * width));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s.x += __shfl_down_sync(0xffffffffu, s.x, o);
      s.y += __shfl_down_sync(0xffffffffu, s.y, o);
      s.z += __shfl_down_sync(0xffffffffu, s.z, o);
      s.w += __shfl_down_sync(0xffffffffu, s.w, o);
    }
    if (lane == 0)
      *reinterpret_cast<float4*>(grads + fd + (b1 ? 0 : a.F) + col) = s;
    return;
  }
  const size_t q = (blockIdx.x - bias_blocks) * static_cast<size_t>(blockDim.x) + threadIdx.x;
  const size_t qw = fd / 4;
  if (q < 2 * qw) {
    const bool w2 = q >= qw;
    const size_t e = 4 * (w2 ? q - qw : q);
    const float* src = (w2 ? a.pw2 : a.pw1) + e;
    float4 s = *reinterpret_cast<const float4*>(src);
    for (int c = 1; c < a.chunks; ++c) add4(s, *reinterpret_cast<const float4*>(src + c * fd));
    *reinterpret_cast<float4*>(grads + (w2 ? fd + a.F + a.D : 0) + e) = s;
  }
}

// --------------------------------------------- bf16 forward, tensor cores

// Staged weights of the bf16 forward: the fp32 weights rounded to bf16 once
// per call into the order and the swizzled layout the kernel's shared memory
// holds them in, so that one bulk copy moves a slice's W1 part and one its
// W2 part.  Per d_ffn slice s of S columns one record: W1 rows s S .. s S +
// S - 1 as Dp / 64 tiles of (S, 64) (128B swizzle), then for each group g of
// 256 output columns W2 rows 256 g .. 256 g + 255, columns s S .. s S + S - 1
// as one (256, S) tile (128B swizzle for S = 64, 64B for S = 32).  Zeros
// past F, D and Dp.
__host__ __device__ constexpr size_t fwd_w1_bytes(int S, int Dp) {
  return static_cast<size_t>(S) * Dp * 2;
}
__host__ __device__ constexpr size_t fwd_w2_bytes(int S) { return static_cast<size_t>(kGw) * S * 2; }
__host__ __device__ constexpr size_t fwd_record_bytes(int S, int Dp, int n_dg) {
  return fwd_w1_bytes(S, Dp) + n_dg * fwd_w2_bytes(S);
}

// One 16-byte chunk of the staged weights a thread: the chunk's logical
// (row, 8 columns) from its place in the swizzled tile, 8 fp32 loaded (two
// 16-byte loads: D % 8 == 0 and F % 4 == 0 keep each in or out whole),
// rounded to bf16 and stored where the tile wants them.
template <int S>
__global__ void ffn_stage_weights_kernel(const float* __restrict__ w1, const float* __restrict__ w2,
                                         uint8_t* __restrict__ out, int D, int F, int Dp, int Fp,
                                         int n_dg) {
  const size_t w1b = fwd_w1_bytes(S, Dp), w2b = fwd_w2_bytes(S);
  const size_t per_rec = fwd_record_bytes(S, Dp, n_dg) / 16, total = (Fp / S) * per_rec;
  for (size_t q = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; q < total;
       q += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int s = static_cast<int>(q / per_rec);
    const size_t o = (q % per_rec) * 16;  // byte offset inside the record
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (o < w1b) {  // W1 (F, D): tile j, row r, physical chunk cp
      const int j = static_cast<int>(o / (S * 128)), ot = static_cast<int>(o % (S * 128));
      const int r = ot / 128, c = ((ot % 128) / 16) ^ (r % 8);
      const int f = s * S + r, d = j * kT + 8 * c;
      if (f < F && d < D) {
        load16<float>(w1 + static_cast<size_t>(f) * D + d, v);
        load16<float>(w1 + static_cast<size_t>(f) * D + d + 4, v + 4);
      }
    } else {  // W2 (D, F): group g, row r, physical chunk cp of a row of 2 S bytes
      const size_t o2 = o - w1b;
      const int g = static_cast<int>(o2 / w2b), ot = static_cast<int>(o2 % w2b);
      const int r = ot / (2 * S), cp = (ot % (2 * S)) / 16;
      const int c = S == 64 ? cp ^ (r % 8) : cp ^ ((r / 2) % 4);
      const int d = g * kGw + r, f = s * S + 8 * c;
      if (d < D) {
        const float* src = w2 + static_cast<size_t>(d) * F + f;
        if (f < F) load16<float>(src, v);
        if (f + 4 < F) load16<float>(src + 4, v + 4);
      }
    }
    store16<bf16>(reinterpret_cast<bf16*>(out + s * fwd_record_bytes(S, Dp, n_dg) + o), v);
  }
}

constexpr int kLdRed = kGw + 8;  // row length of the forward's fp32 partial y in shared memory

template <typename M>
struct FwdArgs {
  const bf16* x;       // (N, D)
  const uint8_t* wst;  // staged weights (ffn_stage_weights_kernel)
  const float* b1;     // (F)
  const float* b2;     // (D)
  bf16* y;             // (N, D)
  int N, D, F, Dp, Fp;
  int n_dg;    // groups of 256 output columns
  int fsplit;  // blocks of a cluster: each takes one part of the d_ffn slices
  int stages;  // stages of the weight ring
  M mk;
};

// Warpgroups (row tiles of 64) of a block: two for d_model up to 256 (S =
// 64), one above (S = 32), where a row tile's x takes up to 128 KB.
template <int S> __host__ __device__ constexpr int fwd_wgs() { return S == 64 ? 2 : 1; }

// Shared memory of the forward: x tiles and the ring during the loop, the
// fp32 partial y over them after it; then the ring's mbarriers and counters.
__host__ __device__ constexpr size_t fwd_region_bytes(int S, int wgs, int Dp, int stages) {
  return static_cast<size_t>(wgs) * Dp * kT * 2 + stages * (fwd_w1_bytes(S, Dp) + fwd_w2_bytes(S)) >
                 static_cast<size_t>(wgs) * kT * kLdRed * sizeof(float)
             ? static_cast<size_t>(wgs) * Dp * kT * 2 +
                   stages * (fwd_w1_bytes(S, Dp) + fwd_w2_bytes(S))
             : static_cast<size_t>(wgs) * kT * kLdRed * sizeof(float);
}
// ... plus the mbarriers and the alignment of the dynamic shared memory
__host__ __device__ constexpr size_t fwd_smem_bytes(int S, int wgs, int Dp, int stages) {
  return fwd_region_bytes(S, wgs, Dp, stages) + stages * (sizeof(uint64_t) + sizeof(uint32_t)) +
         1024;
}

// y = Drop(relu(x W1^T + b1)) W2^T + b2 for the (wgs x 64)-row block
// blockIdx.y, the output group blockIdx.z of 256 columns and the part
// blockIdx.x of the d_ffn slices (the block's rank in its cluster of fsplit).
// Each slice's W1 and W2 tiles arrive by two bulk copies into a ring of
// stages (an mbarrier a stage counts the bytes); each warpgroup keeps its 64
// rows of x resident and, per slice: hp = x W1s^T (wgmma from shared
// memory, m64nS), bias, relu, mask and the exact division by 1 - p at each
// accumulator element (div_rn), hd packed to bf16 straight into the A
// registers of y += hd W2s^T (m64n256, A from registers), and waits for
// both products.  A stage is refilled by the warp that releases it last (a
// counter a stage), so the warpgroups, each on its own rows, meet only at
// the ring: one's epilogue runs while the other's products do.  (No
// producer warp: registers are allotted per warpgroup, and a third one would
// cap every thread at 168.)  After the slices, a cluster barrier; every
// block stores the fp32 partial y of its row r into block r % fsplit's shared
// memory (distributed shared memory, 16 bytes a store); a cluster barrier;
// block q adds rows q, q + fsplit, ... over the partials in rank order, adds
// b2 and stores y in bf16.  No float atomics: two runs give the same bits.
template <int S, int NC, typename M>
__global__ void __launch_bounds__(fwd_wgs<S>() * kWg, 1) ffn_fwd_tc(const FwdArgs<M> a) {
  constexpr int R = fwd_wgs<S>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  constexpr int nc = NC;  // 64-wide chunks of d_model (a.Dp = 64 NC)
  const uint32_t w1b = static_cast<uint32_t>(fwd_w1_bytes(S, a.Dp));
  const uint32_t w2b = static_cast<uint32_t>(fwd_w2_bytes(S)), stage_b = w1b + w2b;
  uint8_t* ring = base + R * nc * kTileB;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + fwd_region_bytes(S, R, a.Dp, a.stages));
  uint32_t* released = reinterpret_cast<uint32_t*>(full + a.stages);  // warps done with a stage
  const int part = blockIdx.x, row0 = blockIdx.y * R * kT, dg = blockIdx.z;
  const int n_s = a.Fp / S;
  const int s0 = part * n_s / a.fsplit, s1 = (part + 1) * n_s / a.fsplit;
  // the warpgroup index through a shuffle (see ffn_dh_tc)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWg, 0);
  const int tid = threadIdx.x % kWg, lane = threadIdx.x % 32;
  const size_t rec = fwd_record_bytes(S, a.Dp, a.n_dg);

  auto load_slice = [&](int s) {  // slice s into its stage, by one thread
    const int st = (s - s0) % a.stages;
    uint8_t* dst = ring + st * stage_b;
    const uint8_t* src = a.wst + s * rec;
    fence_proxy_async_shared();  // the stage's last reads come before the copy's writes
    mbar_arrive_expect_tx(&full[st], stage_b);
    bulk_copy_g2s(dst, src, w1b, &full[st]);
    bulk_copy_g2s(dst + w1b, src + w1b + static_cast<size_t>(dg) * w2b, w2b, &full[st]);
  };
  // this warp's products have read slice s's stage: the last of the 4 R warps
  // to say so refills the stage with slice s + stages
  auto release = [&](int s) {
    if (lane != 0) return;
    const int st = (s - s0) % a.stages;
    if (atomicAdd(&released[st], 1u) == 4 * R - 1) {
      released[st] = 0u;
      if (s + a.stages < s1) load_slice(s + a.stages);
    }
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(&full[i], 1);
      released[i] = 0u;
    }
    fence_mbarrier_init();
    for (int s = s0; s < s1 && s < s0 + a.stages; ++s) load_slice(s);
  }
  const uint32_t sX = smem_addr(base) + wg * nc * kTileB;
  const int rt0 = row0 + wg * kT;  // this warpgroup's rows
  for (int j = 0; j < nc; ++j)
    load_tile_async<kT>(sX + j * kTileB, a.x, a.D, rt0, a.N, j * kT, a.D, tid);
  cp_async_commit();
  int rows[2];
  uint32_t mbase[2], cnt0[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rows[h] = rt0 + acc_row(tid, h);
    mask_consts(a.mk, rows[h], a.F, mbase[h], cnt0[h]);
  }
  float y[4 * kT / 2];  // 64 x 256
#pragma unroll
  for (int i = 0; i < 4 * kT / 2; ++i) y[i] = 0.f;
  cp_async_wait<0>();
  fence_async_shared();
  __syncthreads();  // x landed; the mbarriers are initialised
  {
    const uint32_t ring_a = smem_addr(ring);
    float hp[S / 2];
    // the second warpgroup starts one product later than the first, so that
    // one's epilogue runs while the other's products do (named barrier 3)
    if (R == 2 && wg == 1) named_bar_sync(3, 2 * kWg);
    if (R == 2 && wg == 0 && s0 == s1) named_bar_arrive(3, 2 * kWg);
    for (int s = s0; s < s1; ++s) {
      const int t = s - s0, st = t % a.stages;
      mbar_wait(&full[st], (t / a.stages) & 1);
      const uint32_t w1s = ring_a + st * stage_b, w2s = w1s + w1b;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < nc; ++j) {  // straight-line: a branch among the products makes
        // ptxas fence them
        const uint64_t da = make_desc<kT>(sX + j * kTileB), db = make_desc<kT>(w1s + j * S * 128);
#pragma unroll
        for (int kk = 0; kk < kT / 16; ++kk) {
          if constexpr (S == 64) {
            if (j + kk == 0) wgmma_ss_n64_first(hp, da, db);
            else wgmma_ss_n64(hp, da + 2 * kk, db + 2 * kk);
          } else {
            if (j + kk == 0) wgmma_ss_n32_first(hp, da, db);
            else wgmma_ss_n32<0, 0>(hp, da + 2 * kk, db + 2 * kk);
          }
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(hp);
      if (R == 2 && wg == 0 && s == s0) named_bar_arrive(3, 2 * kWg);
      // hd at each accumulator element, no branch per element: the mask's
      // counter is (row % mask_rows) F + col, hashed times 0x9E3779B9
      // (wrapping), so a column step is a constant step of the product
      const int col0 = s * S + 2 * (tid % 4);
      uint32_t keep_bits = ~0u;
      if (a.mk.on) {
        uint32_t hbase[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          hbase[h] = (cnt0[h] + static_cast<uint32_t>(col0)) * 0x9E3779B9u;
        keep_bits = 0u;
#pragma unroll
        for (int i = 0; i < S / 2; ++i) {
          const uint32_t step = static_cast<uint32_t>(8 * (i / 4) + i % 2) * 0x9E3779B9u;
          const int h = (i / 2) % 2;
          keep_bits |= (fmix32((hbase[h] + step) ^ mbase[h]) >= a.mk.threshold ? 1u : 0u) << i;
        }
      }
#pragma unroll
      for (int i = 0; i < S / 2; i += 2) {
        const int col = col0 + 8 * (i / 4);
        float2 b = make_float2(0.f, 0.f);
        if (col < a.F) b = __ldg(reinterpret_cast<const float2*>(a.b1 + col));
        hp[i] = fmaxf(hp[i] + b.x, 0.f);
        hp[i + 1] = fmaxf(hp[i + 1] + b.y, 0.f);
      }
      if (a.mk.on) div_rn(hp, a.mk.keep_div, a.mk.inv_keep);
#pragma unroll
      for (int i = 0; i < S / 2; ++i) hp[i] = (keep_bits >> i) & 1u ? hp[i] : 0.f;
      uint32_t afr[S / 16][4];
#pragma unroll
      for (int kk = 0; kk < S / 16; ++kk) acc_to_a(hp, kk, afr[kk]);
      wgmma_fence();
      const uint64_t dw2 = make_desc<S>(w2s);
#pragma unroll
      for (int kk = 0; kk < S / 16; ++kk) wgmma_rs_n256(y, afr[kk], dw2 + 2 * kk);
      wgmma_commit();
      // y's products done before the next slice: with them in flight, ptxas
      // gives the packing of hd the registers of an A operand still being
      // read and serializes every wgmma (C7515).  The other warpgroup's
      // products fill the wait.
      wgmma_wait<0>();
      release(s);
    }
    fence_regs(y);
  }

  // every block of the cluster is done with its x and ring: partials may land
  // there.  The partial of block row r goes to block r % fsplit of the
  // cluster, into slot [rank][r / fsplit] of its (fsplit, R 64 / fsplit,
  // kLdRed) buffer, by stores into distributed shared memory (no waiting on
  // remote loads); then each block adds its slots in rank order.
  if (a.fsplit > 1) cluster_sync();
  else __syncthreads();
  float* red = reinterpret_cast<float*>(base);
  const int rows_per = R * kT / a.fsplit;
  // 16-byte stores: lanes c and c ^ 1 (c = lane % 4) swap halves, so that the
  // even lane holds 4 columns of its row g and the odd lane 4 of row g + 8
  const bool odd = lane & 1;
#pragma unroll
  for (int i = 0; i < 4 * kT / 2; i += 4) {
    const float2 give = odd ? make_float2(y[i], y[i + 1]) : make_float2(y[i + 2], y[i + 3]);
    const float2 got = make_float2(__shfl_xor_sync(0xffffffffu, give.x, 1),
                                   __shfl_xor_sync(0xffffffffu, give.y, 1));
    const float4 v = odd ? make_float4(got.x, got.y, y[i + 2], y[i + 3])
                         : make_float4(y[i], y[i + 1], got.x, got.y);
    const int r = wg * kT + acc_row(tid, odd ? 1 : 0), c = acc_col(tid, i) - (odd ? 2 : 0);
    float* at = red + (part * rows_per + r / a.fsplit) * kLdRed + c;
    if (a.fsplit > 1) dsmem_store4(at, r % a.fsplit, v);
    else *reinterpret_cast<float4*>(at) = v;
  }
  if (a.fsplit > 1) cluster_sync();  // every partial has landed
  else __syncthreads();
  // this block's rows part, part + fsplit, ...: one warp a row, 8 columns a lane
  const int col = dg * kGw + lane * 8;
  for (int j = static_cast<int>(threadIdx.x / 32); j < rows_per;
       j += static_cast<int>(blockDim.x / 32)) {
    const float* src = red + j * kLdRed + lane * 8;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int q = 0; q < a.fsplit; ++q) {  // partials in rank order
      const float4 lo = *reinterpret_cast<const float4*>(src + q * rows_per * kLdRed);
      const float4 hi = *reinterpret_cast<const float4*>(src + q * rows_per * kLdRed + 4);
      v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
      v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
    }
    const int row = row0 + j * a.fsplit + part;
    if (row < a.N && col < a.D) {
      float bias[8];
      load16<float>(a.b2 + col, bias);
      load16<float>(a.b2 + col + 4, bias + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] += bias[i];
      store16<bf16>(a.y + static_cast<size_t>(row) * a.D + col, v);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Chunks of rows the weight-gradient kernel works in, and the rows of one.
void chunking(int N, int F, int& chunks, int& chunk_rows) {
  const int tiles = (N + kRows - 1) / kRows;
  const int slices = (F + kFb - 1) / kFb;
  int want = kTargetBlocks / slices;
  if (want < 1) want = 1;
  if (want > tiles) want = tiles;
  const int tiles_per_chunk = (tiles + want - 1) / want;
  chunks = (tiles + tiles_per_chunk - 1) / tiles_per_chunk;
  chunk_rows = tiles_per_chunk * kRows;
}

int launch_fwd(const float* x, const float* w1, const float* b1, const float* w2, const float* b2,
               float* y, int N, int D, int F, MaskMap mk, cudaStream_t s) {
  cudaError_t err = allow_smem(ffn_fwd_kernel<float>, kFwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kRows - 1) / kRows, (D + kDp - 1) / kDp);
  ffn_fwd_kernel<float><<<grid, kThreads, kFwdSmem, s>>>(x, w1, b1, w2, b2, y, N, D, F, mk);
  return static_cast<int>(cudaGetLastError());
}

// grads: dW1 (F, D) | db1 (F) | db2 (D) | dW2 (D, F); part: per chunk one
// record dW1 | db1 | db2, then per chunk the transpose of dW2.
template <typename T>
int launch_bwd(const void* x, const float* w1, const float* b1, const float* w2, const void* dy,
               void* dx, float* grads, float* part, int N, int D, int F, MaskMap mk,
               cudaStream_t s) {
  cudaError_t err = allow_smem(ffn_dx_kernel<T>, kDxSmem);
  if (err == cudaSuccess) err = allow_smem(ffn_dw_kernel<T>, kDwSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int chunks, chunk_rows;
  chunking(N, F, chunks, chunk_rows);
  const size_t flat = static_cast<size_t>(F) * D + F + D;
  float* pw2 = part + static_cast<size_t>(chunks) * flat;
  const unsigned groups = (D + kDp - 1) / kDp;
  ffn_dx_kernel<T><<<dim3((N + kRows - 1) / kRows, groups), kThreads, kDxSmem, s>>>(
      static_cast<const T*>(x), w1, b1, w2, static_cast<const T*>(dy), static_cast<T*>(dx), N, D,
      F, mk);
  ffn_dw_kernel<T><<<dim3((F + kFb - 1) / kFb, chunks, groups), kThreads, kDwSmem, s>>>(
      static_cast<const T*>(x), w1, b1, w2, static_cast<const T*>(dy), part, pw2, N, D, F,
      chunk_rows, mk);
  ffn_reduce_kernel<<<static_cast<unsigned>((flat + 255) / 256), 256, 0, s>>>(
      part, chunks, flat, grads);
  ffn_reduce_transposed_kernel<<<dim3((F + 31) / 32, (D + 31) / 32), dim3(32, 8), 0, s>>>(
      pw2, chunks, F, D, grads + flat);
  return static_cast<int>(cudaGetLastError());
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// The arguments with the whole call's mask: the same fields, the mask
// without its map (for the kernels that read no mask, and for a call that
// is the whole).
template <template <typename> class A>
A<Mask> unmapped(const A<MaskMap>& a) {
  A<Mask> u;
  std::memcpy(&u, &a, offsetof(A<Mask>, mk));
  u.mk = a.mk;
  return u;
}

template <template <typename> class A>
const A<Mask>& unmapped(const A<Mask>& a) {
  return a;
}

template <typename M>
int launch_bwd_tc(const TcArgs<M>& a, const float* w1, const float* w2, float* grads,
                  cudaStream_t s) {
  cudaError_t err = allow_smem(ffn_dh_tc<M>, kDhSmem);
  if (err == cudaSuccess) err = allow_smem(ffn_grad_tc, kDwSmemTc);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = cdiv(a.N, kT), slices = a.Fp / kT, n_dg = cdiv(a.D, kGw);
  const int pairs = a.Fp * a.Dp;  // both matrices, two elements a thread
  ffn_cast_weights_kernel<<<cdiv(pairs, 256) < 2048 ? cdiv(pairs, 256) : 2048, 256, 0, s>>>(
      w1, w2, const_cast<bf16*>(a.w1), const_cast<bf16*>(a.w2), a.D, a.F, a.Dp, a.Fp);
  ffn_dh_tc<M><<<dim3(tiles, a.fgroups), kDhWgs * kWg, kDhSmem, s>>>(a);
  const int grad_blocks = cdiv(slices, 2) * a.chunks * 2 * n_dg + cdiv(tiles, 2) * n_dg;
  const TcArgs<Mask>& u = unmapped(a);
  ffn_grad_tc<<<grad_blocks, 2 * kWg, kDwSmemTc, s>>>(u);
  const int bias_blocks = cdiv(a.F / 4 + a.D / 4, 8);
  const size_t quads = static_cast<size_t>(a.F) * a.D / 2;
  ffn_reduce_tc<<<bias_blocks + static_cast<int>((quads + 255) / 256), 256, 0, s>>>(u, grads,
                                                                                   bias_blocks);
  return static_cast<int>(cudaGetLastError());
}

// The staged weights, then the forward: a grid of (fsplit, blocks of wgs x
// 64 rows, groups of 256 output columns), clusters of fsplit along x.
template <int S, int NC, typename M>
int launch_fwd_tc(const FwdArgs<M>& a, const float* w1, const float* w2, uint8_t* staged,
                  cudaStream_t s) {
  constexpr int R = fwd_wgs<S>();
  const size_t smem = fwd_smem_bytes(S, R, a.Dp, a.stages);
  cudaError_t err = allow_smem(ffn_fwd_tc<S, NC, M>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t chunks = static_cast<size_t>(a.Fp / S) * fwd_record_bytes(S, a.Dp, a.n_dg) / 16;
  const int stage_blocks = static_cast<int>((chunks + 255) / 256);
  ffn_stage_weights_kernel<S><<<stage_blocks < 2048 ? stage_blocks : 2048, 256, 0, s>>>(
      w1, w2, staged, a.D, a.F, a.Dp, a.Fp, a.n_dg);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.fsplit, cdiv(a.N, R * kT), a.n_dg);
  cfg.blockDim = dim3(R * kWg);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.fsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.fsplit > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, ffn_fwd_tc<S, NC, M>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// d_model of the bf16 forward padded to the width its kernel is built for
// (x and W1 past D are zeros), and the d_ffn columns of a slice.
int fwd_dp(int D) { return D <= kGw ? kGw : (D <= 2 * kGw ? 2 * kGw : 4 * kGw); }
int fwd_slice(int Dp) { return Dp <= kGw ? 64 : 32; }

bool shape_ok(int N, int D, int F, int mask_rows, int t_local, int t_total, int row_off,
              int f_total, int col_off) {
  return N >= 1 && D >= 8 && D % 8 == 0 && F >= 4 && F % 4 == 0 && mask_rows >= 1 &&
         t_local >= 1 && t_total >= t_local && row_off >= 0 && col_off >= 0 &&
         col_off + F <= f_total;
}

MaskMap make_mask(int dropout_on, float keep_div, unsigned threshold, unsigned seed,
                  int mask_rows, int t_local, int t_total, int row_off, int f_total,
                  int col_off) {
  MaskMap mk;
  static_cast<Mask&>(mk) =
      Mask{seed, threshold, mask_rows, keep_div, dropout_on, 1.0f / keep_div};
  mk.t_local = t_local;
  mk.t_total = t_total;
  mk.row_off = row_off;
  mk.f_total = f_total;
  mk.col_off = col_off;
  return mk;
}

// Whether a call of F columns is the whole one (the map is the identity).
bool whole(const MaskMap& mk, int F) {
  return mk.t_local == mk.t_total && mk.row_off == 0 && mk.f_total == F && mk.col_off == 0;
}

template <typename M>
int dispatch_fwd_tc(const FwdArgs<M>& a, const float* w1, const float* w2, uint8_t* st,
                    cudaStream_t s) {
  if (a.Dp == kGw) return launch_fwd_tc<64, 4>(a, w1, w2, st, s);
  if (a.Dp == 2 * kGw) return launch_fwd_tc<32, 8>(a, w1, w2, st, s);
  return launch_fwd_tc<32, 16>(a, w1, w2, st, s);
}

}  // namespace

extern "C" {

// Chunks of rows the backward's partial sums come in for these shapes: part
// must hold chunks * (2 F D + F + D) floats.
int tts_fused_ffn_bwd_chunks(int N, int F) {
  int chunks, chunk_rows;
  chunking(N, F, chunks, chunk_rows);
  return chunks;
}

// Dynamic shared memory per block, bytes, for d_model D: out[0] the fp32 forward,
// out[1] the bf16 backward's dh kernel, out[2] its gradient kernel.
int tts_fused_ffn_shared_bytes(int D, long long* out) {
  if (D < 8 || D % 8) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = static_cast<long long>(kFwdSmem);
  out[1] = static_cast<long long>(kDhSmem);
  out[2] = static_cast<long long>(kDwSmemTc);
  return 0;
}

// fp32, on the CUDA cores.  x, y: (N, D) fp32, contiguous; w1 (F, D), b1
// (F), w2 (D, F), b2 (D) fp32, the PyTorch parameters as they lie.  D is a
// multiple of 8, F a multiple of 4.  With dropout_on, keep_div = 1 - p and
// threshold = uint32(p * 2^32).  t_local, t_total, row_off, f_total,
// col_off: the mask's global row map and d_ffn columns (N, N, 0, F, 0 for
// the whole call); every entry point takes them.
int tts_fused_ffn_fwd(int N, int D, int F, const void* x, const void* w1, const void* b1,
                      const void* w2, const void* b2, void* y, int dropout_on, float keep_div,
                      unsigned threshold, unsigned seed, int mask_rows, int t_local,
                      int t_total, int row_off, int f_total, int col_off, void* stream) {
  if (!shape_ok(N, D, F, mask_rows, t_local, t_total, row_off, f_total, col_off))
    return static_cast<int>(cudaErrorInvalidValue);
  const MaskMap mk = make_mask(dropout_on, keep_div, threshold, seed, mask_rows, t_local, t_total,
                            row_off, f_total, col_off);
  return launch_fwd(static_cast<const float*>(x), static_cast<const float*>(w1),
                    static_cast<const float*>(b1), static_cast<const float*>(w2),
                    static_cast<const float*>(b2), static_cast<float*>(y), N, D, F, mk,
                    static_cast<cudaStream_t>(stream));
}

// bf16 forward, sizes: out[0] the dynamic shared memory of a block with
// `stages` ring stages, out[1] the staged weights' bytes.  D <= 1,024.
int tts_fused_ffn_fwd_tc_bytes(int D, int F, int stages, long long* out) {
  const int Dp = fwd_dp(D), Fp = cdiv(F, kT) * kT;
  if (D < 8 || D % 8 || F < 4 || F % 4 || D > 4 * kGw || stages < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int S = fwd_slice(Dp), R = S == 64 ? fwd_wgs<64>() : fwd_wgs<32>();
  out[0] = static_cast<long long>(fwd_smem_bytes(S, R, Dp, stages));
  out[1] = static_cast<long long>(static_cast<size_t>(Fp / S) *
                                  fwd_record_bytes(S, Dp, cdiv(D, kGw)));
  return 0;
}

// bf16, on the tensor cores.  x, y: (N, D) bf16; w1, b1, w2, b2 fp32 as
// above; D <= 1,024, padded to 256, 512 or 1,024 (fwd_dp).  staged: scratch
// of tts_fused_ffn_fwd_tc_bytes()[1] bytes, 16-byte aligned.  fsplit (1, 2,
// 4 or 8, at most the slices) blocks of a cluster share a row block's d_ffn
// slices; stages of the weight ring.
int tts_fused_ffn_fwd_tc(int N, int D, int F, const void* x, const void* w1, const void* b1,
                         const void* w2, const void* b2, void* y, void* staged, int fsplit,
                         int stages, int dropout_on, float keep_div, unsigned threshold,
                         unsigned seed, int mask_rows, int t_local, int t_total, int row_off,
                         int f_total, int col_off, void* stream) {
  long long bytes[2];
  if (!shape_ok(N, D, F, mask_rows, t_local, t_total, row_off, f_total, col_off) ||
      tts_fused_ffn_fwd_tc_bytes(D, F, stages, bytes) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs<MaskMap> a;
  a.Dp = fwd_dp(D);
  a.Fp = cdiv(F, kT) * kT;
  const int S = fwd_slice(a.Dp);
  if (bytes[0] > 232448 || (fsplit != 1 && fsplit != 2 && fsplit != 4 && fsplit != 8) ||
      fsplit > a.Fp / S)
    return static_cast<int>(cudaErrorInvalidValue);
  a.x = static_cast<const bf16*>(x);
  a.wst = static_cast<const uint8_t*>(staged);
  a.b1 = static_cast<const float*>(b1);
  a.b2 = static_cast<const float*>(b2);
  a.y = static_cast<bf16*>(y);
  a.N = N;
  a.D = D;
  a.F = F;
  a.n_dg = cdiv(D, kGw);
  a.fsplit = fsplit;
  a.stages = stages;
  a.mk = make_mask(dropout_on, keep_div, threshold, seed, mask_rows, t_local, t_total, row_off,
                   f_total, col_off);
  auto s = static_cast<cudaStream_t>(stream);
  auto w1f = static_cast<const float*>(w1);
  auto w2f = static_cast<const float*>(w2);
  auto st = static_cast<uint8_t*>(staged);
  if (whole(a.mk, F)) return dispatch_fwd_tc(unmapped(a), w1f, w2f, st, s);
  return dispatch_fwd_tc(a, w1f, w2f, st, s);
}

// fp32, on the CUDA cores.  dy, dx: (N, D) fp32.  grads: F D + F + D + D F
// floats, in this order dW1 (F, D), db1 (F), db2 (D), dW2 (D, F).  part:
// scratch of tts_fused_ffn_bwd_chunks(N, F) * (2 F D + F + D) floats.
int tts_fused_ffn_bwd(int N, int D, int F, const void* x, const void* w1, const void* b1,
                      const void* w2, const void* dy, void* dx, void* grads, void* part,
                      int dropout_on, float keep_div, unsigned threshold, unsigned seed,
                      int mask_rows, int t_local, int t_total, int row_off, int f_total,
                      int col_off, void* stream) {
  if (!shape_ok(N, D, F, mask_rows, t_local, t_total, row_off, f_total, col_off))
    return static_cast<int>(cudaErrorInvalidValue);
  const MaskMap mk = make_mask(dropout_on, keep_div, threshold, seed, mask_rows, t_local, t_total,
                            row_off, f_total, col_off);
  return launch_bwd<float>(x, static_cast<const float*>(w1), static_cast<const float*>(b1),
                           static_cast<const float*>(w2), dy, dx, static_cast<float*>(grads),
                           static_cast<float*>(part), N, D, F, mk,
                           static_cast<cudaStream_t>(stream));
}

// bf16, on the tensor cores.  x, dy, dx: (N, D) bf16; w1 (F, D), b1 (F),
// w2 (D, F) fp32; grads as above.  Scratch, with Dp and Fp D and F rounded
// up to multiples of 64: w1b (Fp, Dp) and w2b (Dp, Fp) bf16; dh, hd (N, Fp)
// bf16; pdb1 (tiles, F), pdb2 (tiles, D), pw1 (chunks, F, D), pw2 (chunks,
// D, F) fp32 with tiles = ceil(N / 64).  The dh kernel takes the d_ffn slices
// of 32 in fgroups groups of spg (fgroups = ceil(Fp / 32 / spg)), the
// weight-gradient products the row tiles in chunks of tpc (chunks =
// ceil(tiles / tpc)).
int tts_fused_ffn_bwd_tc(int N, int D, int F, const void* x, const void* w1, const void* b1,
                         const void* w2, const void* dy, void* dx, void* grads, void* w1b,
                         void* w2b, void* dh, void* hd, void* pdb1, void* pdb2, void* pw1,
                         void* pw2, int spg, int fgroups, int tpc, int chunks, int dropout_on,
                         float keep_div, unsigned threshold, unsigned seed, int mask_rows,
                         int t_local, int t_total, int row_off, int f_total, int col_off,
                         void* stream) {
  const int Dp = cdiv(D, kT) * kT, Fp = cdiv(F, kT) * kT;
  if (!shape_ok(N, D, F, mask_rows, t_local, t_total, row_off, f_total, col_off) || spg < 1 ||
      fgroups != cdiv(Fp / kS, spg) || tpc < 1 || chunks != cdiv(cdiv(N, kT), tpc))
    return static_cast<int>(cudaErrorInvalidValue);
  TcArgs<MaskMap> a;
  a.x = static_cast<const bf16*>(x);
  a.dy = static_cast<const bf16*>(dy);
  a.w1 = static_cast<const bf16*>(w1b);
  a.w2 = static_cast<const bf16*>(w2b);
  a.b1 = static_cast<const float*>(b1);
  a.dx = static_cast<bf16*>(dx);
  a.dh = static_cast<bf16*>(dh);
  a.hd = static_cast<bf16*>(hd);
  a.pdb1 = static_cast<float*>(pdb1);
  a.pdb2 = static_cast<float*>(pdb2);
  a.pw1 = static_cast<float*>(pw1);
  a.pw2 = static_cast<float*>(pw2);
  a.N = N;
  a.D = D;
  a.F = F;
  a.Dp = Dp;
  a.Fp = Fp;
  a.spg = spg;
  a.fgroups = fgroups;
  a.tpc = tpc;
  a.chunks = chunks;
  a.mk = make_mask(dropout_on, keep_div, threshold, seed, mask_rows, t_local, t_total, row_off,
                   f_total, col_off);
  auto w1f = static_cast<const float*>(w1);
  auto w2f = static_cast<const float*>(w2);
  auto s = static_cast<cudaStream_t>(stream);
  if (whole(a.mk, F)) return launch_bwd_tc(unmapped(a), w1f, w2f, static_cast<float*>(grads), s);
  return launch_bwd_tc(a, w1f, w2f, static_cast<float*>(grads), s);
}

}  // extern "C"
