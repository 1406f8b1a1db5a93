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
// (D, F), and so do dW1 and dW2.  A product that needs a weight tile the
// other way round transposes it on its way into shared memory, so no call
// copies or casts a weight in device memory.
//
// Bound: operations (4 N D F forward, 12.9 GFLOP at N 12,288, D 256, F 1,024,
// against 13.6 MB).  This first version runs them as fp32 FMAs on the CUDA
// cores, not on the tensor cores.  Two weight matrices and the intermediate
// of a row tile do not fit a block's shared memory, so a block of 256
// threads takes 64 rows and walks over d_ffn in slices of 64 columns: the
// slice's hp is a 64 x 64 tile (every thread a 4 x 4 sub-tile, operands
// staged in chunks of 32 along d_model), it becomes hd in registers, goes to
// shared memory rounded to T, and its product with the slice of W2 is added
// to the block's (64, 256) fp32 output, which stays in registers (4 x 16 values
// a thread).  A block owns 256 output columns: a narrower D rides in them, and
// a wider D (512, 1,024) takes one block per group of 256 columns
// (blockIdx.y; blockIdx.z in the weight-gradient kernel), each of which
// recomputes the slice's intermediate from all of d_model.  wgmma and TMA are
// later work.
//
// Backward, sums over all rows without atomics: blocks run in no order, so
// the work is cut by who owns the result.  One kernel gridded over row tiles
// recomputes hp and forms dh slice by slice and owns dx.  A second kernel
// gridded over (slice of 32 d_ffn columns, chunk of rows) recomputes the
// slice's hd and dh for its rows and owns that chunk's partial of the
// slice's dW1 rows, db1 entries and dW2 columns (and, for the first slice,
// db2); the number of chunks is fixed by the shapes.  A reduce kernel adds
// the chunks' partials in chunk order.  Two runs give the same bits.  Rows
// beyond N are read as zeros and add nothing.
//
// The dropout mask is a function of the logical index (dropout_mask.cuh):
// element (row, col) of the intermediate takes salt = row / mask_rows and
// counter = (row % mask_rows) * F + col, where mask_rows is the row-block
// height the TPU kernel would pick (passed in; it shapes nothing but the
// mask).
//
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "dropout_mask.cuh"
#include "numeric.cuh"

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
};

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
__device__ __forceinline__ void mask_rows4(const Mask& mk, int row0, int F, uint32_t (&base)[4],
                                           uint32_t (&cnt0)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + i;
    base[i] = mk.on ? mask_base(mk.seed, static_cast<uint32_t>(row / mk.rows)) : 0u;
    cnt0[i] = static_cast<uint32_t>(row % mk.rows) * static_cast<uint32_t>(F);
  }
}

// 4 floats rounded to T at p (aligned to 4 elements of T)
template <typename T> __device__ __forceinline__ void store4(T* p, const float* v);
template <> __device__ __forceinline__ void store4<float>(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <> __device__ __forceinline__ void store4<bf16>(bf16* p, const float* v) {
  uint2 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
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
               const float* __restrict__ b2, T* __restrict__ y, int N, int D, int F, Mask mk) {
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
              const T* __restrict__ dy, T* __restrict__ dx, int N, int D, int F, Mask mk) {
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
              int N, int D, int F, int chunk_rows, Mask mk) {
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

template <typename T>
int launch_fwd(const void* x, const float* w1, const float* b1, const float* w2, const float* b2,
               void* y, int N, int D, int F, Mask mk, cudaStream_t s) {
  cudaError_t err = allow_smem(ffn_fwd_kernel<T>, kFwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kRows - 1) / kRows, (D + kDp - 1) / kDp);
  ffn_fwd_kernel<T><<<grid, kThreads, kFwdSmem, s>>>(
      static_cast<const T*>(x), w1, b1, w2, b2, static_cast<T*>(y), N, D, F, mk);
  return static_cast<int>(cudaGetLastError());
}

// grads: dW1 (F, D) | db1 (F) | db2 (D) | dW2 (D, F); part: per chunk one
// record dW1 | db1 | db2, then per chunk the transpose of dW2.
template <typename T>
int launch_bwd(const void* x, const float* w1, const float* b1, const float* w2, const void* dy,
               void* dx, float* grads, float* part, int N, int D, int F, Mask mk,
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

bool shape_ok(int N, int D, int F, int mask_rows) {
  return N >= 1 && D >= 8 && D % 8 == 0 && F >= 4 && F % 4 == 0 && mask_rows >= 1;
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

// x, y: (N, D) T, contiguous; w1 (F, D), b1 (F), w2 (D, F), b2 (D) fp32, the
// PyTorch parameters as they lie.  T is bf16 when is_bf16, else fp32.  D is a
// multiple of 8, F a multiple of 4.  With dropout_on, keep_div =
// 1 - p and threshold = uint32(p * 2^32).
int tts_fused_ffn_fwd(int is_bf16, int N, int D, int F, const void* x, const void* w1,
                      const void* b1, const void* w2, const void* b2, void* y, int dropout_on,
                      float keep_div, unsigned threshold, unsigned seed, int mask_rows,
                      void* stream) {
  if (!shape_ok(N, D, F, mask_rows)) return static_cast<int>(cudaErrorInvalidValue);
  const Mask mk{seed, threshold, mask_rows, keep_div, dropout_on};
  auto s = static_cast<cudaStream_t>(stream);
  auto a1 = static_cast<const float*>(w1);
  auto c1 = static_cast<const float*>(b1);
  auto a2 = static_cast<const float*>(w2);
  auto c2 = static_cast<const float*>(b2);
  return is_bf16 ? launch_fwd<bf16>(x, a1, c1, a2, c2, y, N, D, F, mk, s)
                 : launch_fwd<float>(x, a1, c1, a2, c2, y, N, D, F, mk, s);
}

// dy, dx: (N, D) T.  grads: F D + F + D + D F floats, in this order dW1
// (F, D), db1 (F), db2 (D), dW2 (D, F).  part: scratch of
// tts_fused_ffn_bwd_chunks(N, F) * (2 F D + F + D) floats.
int tts_fused_ffn_bwd(int is_bf16, int N, int D, int F, const void* x, const void* w1,
                      const void* b1, const void* w2, const void* dy, void* dx, void* grads,
                      void* part, int dropout_on, float keep_div, unsigned threshold,
                      unsigned seed, int mask_rows, void* stream) {
  if (!shape_ok(N, D, F, mask_rows)) return static_cast<int>(cudaErrorInvalidValue);
  const Mask mk{seed, threshold, mask_rows, keep_div, dropout_on};
  auto s = static_cast<cudaStream_t>(stream);
  auto a1 = static_cast<const float*>(w1);
  auto c1 = static_cast<const float*>(b1);
  auto a2 = static_cast<const float*>(w2);
  auto g = static_cast<float*>(grads);
  auto pt = static_cast<float*>(part);
  return is_bf16 ? launch_bwd<bf16>(x, a1, c1, a2, dy, dx, g, pt, N, D, F, mk, s)
                 : launch_bwd<float>(x, a1, c1, a2, dy, dx, g, pt, N, D, F, mk, s);
}

}  // extern "C"
