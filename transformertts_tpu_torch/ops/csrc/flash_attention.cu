// O = Dropout(softmax(Q K^T / sqrt(D) + key_bias (+ causal))) V, forward and
// backward, with the score matrix never in device memory, for Hopper (sm_90a).
//
// Replaces the TPU kernels transformertts_tpu/ops/pallas/flash_attention.py:
// _fwd (_fwd_kernel :119) and _bwd (_bwd_kernel :181).  The plain PyTorch
// version, op for op, is flash_attention_reference /
// flash_attention_backward_reference in ../flash_attention.py.  Numerics as
// the TPU kernel: operands of the storage type T (bf16 or fp32) with fp32
// accumulation; 1/sqrt(D) folded into Q when it is a power of two, else
// applied to the fp32 scores; the bias added in fp32; causal REPLACES the
// score by -1e9; l is the row sum of e = exp(s - m) before dropout; e is
// rounded to T unnormalised for P V; 1 / (l (1 - p)) multiplies the fp32
// output rows.  In the backward, dO r / (1 - p), e (dP - delta) and
// Q r scale are rounded to T before their products, and r scale multiplies
// the fp32 dQ rows, with r = 1 / l and delta = sum(dO * O) from the stored
// (rounded) O.
//
// Bound on an H100, at the training path's shapes: bytes (Q, K, V, O once;
// 7.64 us forward and 15.16 us backward at the decoder's causal (768, 768),
// B 16, H 4, D 64), the operations (4 D per unmasked (query, key) pair
// forward, 10 D backward) being lighter at the tensor cores' bf16 rate.
// What stands between a kernel and that bound is the per-score work: the
// exp, the masks and the dropout hash of every (query, key) pair.
//
// bf16 (the path's dtype) runs on the tensor cores (hopper.cuh): one
// warpgroup of 128 threads per block owns 64 query rows (forward, dQ) or 64
// keys (dK/dV), and every product is a wgmma with bf16 operands and fp32
// sums: Q K^T and P V forward; S and dP in both backward kernels, then dQ,
// dK and dV.  Operand tiles (64 rows of D = 32 or 64) lie in shared memory
// in bf16, swizzled as the wgmma descriptor names them.  K/V tiles (forward,
// dQ) and Q/dO tiles (dK/dV) arrive by cp.async into a ring of two stages, so
// that tile t + 1 loads while tile t is multiplied; cp.async rather than TMA
// because it needs no tensor map (cuTensorMapEncodeTiled, which makes one, would add
// host time to every call of a host-bound step), reads the strided q|k|v
// views as they are, and zero-fills the rows past Tq or Tk.  P, e_dropped and
// ds0 go from the accumulator registers, packed to bf16, straight into the A
// operand of the next product; V, K, Q r scale and dO r / (1 - p) are B
// operands read through the descriptor's transpose.  The dK/dV kernel
// computes S^T = K Q^T and dP^T = V dO^T, so that its accumulator rows are
// keys; m, l, delta and the mask's per-query hash bases come per query tile
// through shared memory.  Several blocks share an SM (40-70 KB of shared
// memory each), so one block's exp and hash work overlaps another's
// products.  Blocks run heaviest first: the last query tiles of a causal
// forward or dQ, the first key tiles of dK/dV.
//
// fp32 keeps the CUDA-core kernels (flash_fwd_kernel, flash_dq_kernel,
// flash_dkdv_kernel): the tensor cores have no fp32 product (TF32 keeps about
// three digits).  A 64 x 64 score tile per block of 256 threads, every thread
// a 4 x 4 sub-tile, operands staged in shared memory as floats.
//
// Forward: one pass over the key tiles with a running row maximum (online
// softmax); it stores m and l (B, H, Tq) for the backward, which the TPU
// kernel recomputed.  e is therefore rounded to T against the running
// maximum, not the final one: the output can differ from the plain version
// by one rounding of T per term, and not at all in fp32.
//
// Backward: blocks run in no order, so the sums the TPU grid carried from
// step to step become loops inside the block that owns the result: one
// kernel gridded over query tiles loops over key tiles for dQ, one gridded
// over key tiles loops over query tiles for dK and dV.  No atomics: the
// same bits on every run.
//
// Skipped work: a key tile that causal masks for every row of the query
// tile, or whose keys are all padded (bias -1e9), once every row of the query
// tile has a maximum far above -1e9 (its e is exactly 0 then); a row whose
// keys are all padded keeps the TPU kernel's uniform weights over all Tk
// keys.  The bf16 kernels skip both kinds (dK/dV writes zeros for a key tile
// that no query reaches), the fp32 ones the causal kind.
//
// The dropout mask is a function of the logical index (dropout_mask.cuh):
// element (bh, row, col) takes salt = bh * 8192 + row / block_q and counter
// = (row % block_q) * Tk + col, where block_q is the query-block height the
// TPU kernel would pick (passed in; it shapes nothing but the mask).  bh is
// the global batch * head index (mask_b0 + b) * mask_heads + mask_h0 + h, so
// a call that holds some of the batch rows and heads (data and tensor
// parallelism) drops what the whole call drops; (0, H, 0) gives b * H + h.
//
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "dropout_mask.cuh"
#include "hopper.cuh"
#include "numeric.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // query rows and keys of a score tile
constexpr int kLd = kTile + 4;     // row length of a tile stored by column
constexpr float kNegInf = -1e9f;   // models/masks.py NEG_INF
constexpr float kLive = -5e8f;     // a row maximum above this has seen a real score

template <typename T>
struct Args {
  const T* q;  // strides qs
  const T* k;  // strides ks
  const T* v;  // strides vs
  const float* bias;  // (B, Tk)
  T* out;             // (B, Tq, H, D), forward
  float* m;           // (B, H, Tq) row maxima
  float* l;           // (B, H, Tq) row sums of e
  const T* o;         // (B, Tq, H, D), backward
  const T* dout;      // (B, Tq, H, D)
  float* delta;       // (B, H, Tq) scratch
  T* dq;              // (B, Tq, H, D)
  T* dk;              // (B, Tk, H, D)
  T* dv;              // (B, Tk, H, D)
  long long qs[3], ks[3], vs[3];  // batch, row, head strides in elements
  int B, H, Tq, Tk;
  float scale, q_mul, s_mul;  // q_mul = scale, s_mul = 1 when folded; else 1, scale
  float keep_div, inv_keep;   // 1 - p, 1 / (1 - p); both 1 without dropout
  int causal, dropout_on;
  uint32_t threshold, seed;
  int block_q;
  int mask_b0, mask_heads, mask_h0;  // global batch offset, head count, head offset
};

// The global batch * head index of block bh that the dropout mask is keyed
// on.  A call that holds every head (one device, or a data shard) needs no
// division: the branch is the same for every thread.
template <typename T>
__device__ __forceinline__ int mask_bh(const Args<T>& a, int bh) {
  if (a.mask_heads == a.H) return bh + a.mask_b0 * a.H;
  return (a.mask_b0 + bh / a.H) * a.mask_heads + a.mask_h0 + bh % a.H;
}

// Rows row0 .. row0 + 63 of a (rows, D) matrix with row stride `stride`
// into shared memory as floats times mul[row]; rows >= n_rows as zeros.
// kByColumn: dst[d * kLd + r], else dst[r * D + d].  kRound: rounded to T.
template <typename T, int D, bool kByColumn, bool kRound, typename RowMul>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long stride, int row0,
                                          int n_rows, RowMul mul) {
  constexpr int V = vec<T>();
  for (int idx = threadIdx.x; idx < kTile * (D / V); idx += kThreads) {
    const int r = idx / (D / V), d0 = (idx % (D / V)) * V;
    float x[V];
    if (row0 + r < n_rows) {
      load16<T>(src + static_cast<long long>(row0 + r) * stride + d0, x);
      const float f = mul(row0 + r);
#pragma unroll
      for (int i = 0; i < V; ++i) x[i] = kRound ? round_t<T>(x[i] * f) : x[i] * f;
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (kByColumn) dst[(d0 + i) * kLd + r] = x[i];
      else dst[r * D + d0 + i] = x[i];
    }
  }
}

// acc[i][j] += sum_d a[d][4 ty + i] * b[d][4 tx + j], both stored by column.
template <int D>
__device__ __forceinline__ void tile_dot(const float* a, const float* b, int ty, int tx,
                                         float (&acc)[4][4]) {
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 av = *reinterpret_cast<const float4*>(a + d * kLd + ty * 4);
    const float4 bv = *reinterpret_cast<const float4*>(b + d * kLd + tx * 4);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += ar[i] * br[j];
  }
}

// acc[i][j] += sum_c p[c][4 ty + i] * b[c][tx * (D / 16) + j]: p by column
// (row length ld), b by row (row length D), c over the 64 rows of the tile.
template <int D>
__device__ __forceinline__ void tile_acc(const float* p, int ld, const float* b, int ty, int tx,
                                         float (&acc)[4][D / 16]) {
  constexpr int DV = D / 16;
#pragma unroll 4
  for (int c = 0; c < kTile; ++c) {
    const float4 pv = *reinterpret_cast<const float4*>(p + c * ld + ty * 4);
    const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
    float br[DV];
    if constexpr (DV == 4) {
      const float4 bv = *reinterpret_cast<const float4*>(b + c * D + tx * 4);
      br[0] = bv.x; br[1] = bv.y; br[2] = bv.z; br[3] = bv.w;
    } else {
#pragma unroll
      for (int j = 0; j < DV; ++j) br[j] = b[c * D + tx * DV + j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DV; ++j) acc[i][j] += pr[i] * br[j];
  }
}

// max / sum over the 16 threads that share a score row (same ty)
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The masked score of (row, col) from the raw product.
template <typename T>
__device__ __forceinline__ float masked_score(const Args<T>& a, const float* bias, float dot,
                                              int row, int col) {
  if (col >= a.Tk) return -INFINITY;
  if (a.causal && col > row) return kNegInf;
  return dot * a.s_mul + bias[col];
}

struct One {
  __device__ float operator()(int) const { return 1.f; }
};
struct Const {
  float f;
  __device__ float operator()(int) const { return f; }
};

// ------------------------------------------------------------------ forward

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Args<T> a) {
  constexpr int DV = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;             // (D, kLd) by column
  float* Kt = Qt + D * kLd;     // (D, kLd) by column
  float* Vs = Kt + D * kLd;     // (64, D) by row
  float* Pt = Vs + kTile * D;   // (64 keys, kLd) by column: Pt[c][r]
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* q = a.q + b * a.qs[0] + h * a.qs[2];
  const T* k = a.k + b * a.ks[0] + h * a.ks[2];
  const T* v = a.v + b * a.vs[0] + h * a.vs[2];
  const float* bias = a.bias + static_cast<size_t>(b) * a.Tk;

  load_tile<T, D, true, false>(Qt, q, a.qs[1], q0, a.Tq, Const{a.q_mul});

  float m[4], l[4], o[4][DV];
  uint32_t base[4], cnt0[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DV; ++j) o[i][j] = 0.f;
    const int row = q0 + ty * 4 + i;
    base[i] = mask_base(a.seed, static_cast<uint32_t>(mask_bh(a, bh) * 8192 + row / a.block_q));
    cnt0[i] = static_cast<uint32_t>(row % a.block_q) * static_cast<uint32_t>(a.Tk);
  }

  for (int k0 = 0; k0 < a.Tk; k0 += kTile) {
    __syncthreads();  // the previous tile's reads are done
    load_tile<T, D, true, false>(Kt, k, a.ks[1], k0, a.Tk, One{});
    load_tile<T, D, false, false>(Vs, v, a.vs[1], k0, a.Tk, One{});
    __syncthreads();

    float s[4][4] = {};
    tile_dot<D>(Qt, Kt, ty, tx, s);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = masked_score(a, bias, s[i][j], row, k0 + tx * 4 + j);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DV; ++j) o[i][j] *= alpha;
      if (a.dropout_on) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (!mask_keep(base[i], cnt0[i] + static_cast<uint32_t>(k0 + tx * 4 + j), a.threshold))
            s[i][j] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (tx * 4 + j) * kLd + ty * 4) =
          make_float4(round_t<T>(s[0][j]), round_t<T>(s[1][j]), round_t<T>(s[2][j]),
                      round_t<T>(s[3][j]));
    __syncthreads();
    tile_acc<D>(Pt, kLd, Vs, ty, tx, o);

    if (a.causal && k0 + kTile > q0 + kTile - 1) {
      // every later key tile lies above the diagonal for all rows here
      bool live = true;
#pragma unroll
      for (int i = 0; i < 4; ++i) live = live && (q0 + ty * 4 + i >= a.Tq || m[i] > kLive);
      if (__syncthreads_and(live)) break;
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.Tq) continue;
    const float norm = 1.0f / (l[i] * a.keep_div);
    T* out = a.out + ((static_cast<size_t>(b) * a.Tq + row) * a.H + h) * D + tx * DV;
#pragma unroll
    for (int j = 0; j < DV; ++j) out[j] = from_f<T>(o[i][j] * norm);
    if (tx == 0) {
      a.m[static_cast<size_t>(bh) * a.Tq + row] = m[i];
      a.l[static_cast<size_t>(bh) * a.Tq + row] = l[i];
    }
  }
}

// ----------------------------------------------------------------- backward

// delta (B, H, Tq) = sum_d dO * O: D / vec<T>() neighbouring lanes per
// (batch, row, head), one 16-byte load of dO and of O each.
template <typename T, int D>
__global__ void flash_delta_kernel(const Args<T> a) {
  constexpr int V = vec<T>(), kLanes = D / V;
  const long long n = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kLanes;
  const int part = static_cast<int>(threadIdx.x % kLanes);
  const bool in = n < static_cast<long long>(a.B) * a.Tq * a.H;
  float s = 0.f;
  if (in) {
    float x[V], y[V];
    load16<T>(a.dout + n * D + part * V, x);
    load16<T>(a.o + n * D + part * V, y);
#pragma unroll
    for (int i = 0; i < V; ++i) s += x[i] * y[i];
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (in && part == 0) {
    const int h = static_cast<int>(n % a.H);
    const long long br = n / a.H;
    const int row = static_cast<int>(br % a.Tq), b = static_cast<int>(br / a.Tq);
    a.delta[(static_cast<size_t>(b) * a.H + h) * a.Tq + row] = s;
  }
}

// e (kept or dropped) and ds0 of one thread's 4 x 4 sub-tile from its raw
// products s = Q K^T and dp = dO V^T.  On return s holds T(e_dropped) and dp
// holds T(e (dP - delta)); rows >= Tq give zeros.
template <typename T>
__device__ __forceinline__ void backward_tile(const Args<T>& a, const float* bias, int bh, int q0,
                                              int k0, int ty, int tx, const float (&m)[4],
                                              const float (&delta)[4], float (&s)[4][4],
                                              float (&dp)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const uint32_t base =
        mask_base(a.seed, static_cast<uint32_t>(mask_bh(a, bh) * 8192 + row / a.block_q));
    const uint32_t cnt0 = static_cast<uint32_t>(row % a.block_q) * static_cast<uint32_t>(a.Tk);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx * 4 + j;
      float e = 0.f, ed = 0.f, d = 0.f;
      if (row < a.Tq) {
        e = expf(masked_score(a, bias, s[i][j], row, col) - m[i]);
        ed = e;
        d = dp[i][j];
        if (a.dropout_on) {
          if (mask_keep(base, cnt0 + static_cast<uint32_t>(col), a.threshold)) {
            d = d * a.inv_keep;
          } else {
            d = 0.f;
            ed = 0.f;
          }
        }
      }
      s[i][j] = round_t<T>(ed);
      dp[i][j] = round_t<T>(e * (d - delta[i]));
    }
  }
}

// dQ: one block per (query tile, batch * head), looping over key tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(const Args<T> a) {
  constexpr int DV = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;              // (D, kLd) by column
  float* dOt = Qt + D * kLd;     // (D, kLd) by column
  float* Kt = dOt + D * kLd;     // (D, kLd) by column
  float* Vt = Kt + D * kLd;      // (D, kLd) by column
  float* Ks = Vt + D * kLd;      // (64, D) by row
  float* Pt = Ks + kTile * D;    // (64 keys, kLd): ds0 by column
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* q = a.q + b * a.qs[0] + h * a.qs[2];
  const T* k = a.k + b * a.ks[0] + h * a.ks[2];
  const T* v = a.v + b * a.vs[0] + h * a.vs[2];
  const long long ostride = static_cast<long long>(a.H) * D;
  const T* dout = a.dout + (static_cast<long long>(b) * a.Tq * a.H + h) * D;
  const float* bias = a.bias + static_cast<size_t>(b) * a.Tk;

  load_tile<T, D, true, false>(Qt, q, a.qs[1], q0, a.Tq, Const{a.q_mul});
  load_tile<T, D, true, false>(dOt, dout, ostride, q0, a.Tq, One{});

  float m[4], r[4], delta[4], dq[4][DV];
  bool live = true;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const size_t at = static_cast<size_t>(bh) * a.Tq + row;
    m[i] = row < a.Tq ? a.m[at] : 0.f;
    r[i] = row < a.Tq ? 1.0f / a.l[at] : 0.f;
    delta[i] = row < a.Tq ? a.delta[at] : 0.f;
    live = live && (row >= a.Tq || m[i] > kLive);
#pragma unroll
    for (int j = 0; j < DV; ++j) dq[i][j] = 0.f;
  }
  const bool all_live = __syncthreads_and(live);

  for (int k0 = 0; k0 < a.Tk; k0 += kTile) {
    if (a.causal && all_live && k0 > q0 + kTile - 1) break;  // masked for every row: e = 0
    __syncthreads();
    load_tile<T, D, true, false>(Kt, k, a.ks[1], k0, a.Tk, One{});
    load_tile<T, D, true, false>(Vt, v, a.vs[1], k0, a.Tk, One{});
    load_tile<T, D, false, false>(Ks, k, a.ks[1], k0, a.Tk, One{});
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<D>(Qt, Kt, ty, tx, s);
    tile_dot<D>(dOt, Vt, ty, tx, dp);
    backward_tile(a, bias, bh, q0, k0, ty, tx, m, delta, s, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (tx * 4 + j) * kLd + ty * 4) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    __syncthreads();
    tile_acc<D>(Pt, kLd, Ks, ty, tx, dq);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.Tq) continue;
    const float rs = r[i] * a.scale;
    T* out = a.dq + ((static_cast<size_t>(b) * a.Tq + row) * a.H + h) * D + tx * DV;
#pragma unroll
    for (int j = 0; j < DV; ++j) out[j] = from_f<T>(dq[i][j] * rs);
  }
}

// dK, dV: one block per (key tile, batch * head), looping over query tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dkdv_kernel(const Args<T> a) {
  constexpr int DV = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;               // (D, kLd) by column, loaded once
  float* Vt = Kt + D * kLd;       // (D, kLd) by column, loaded once
  float* Qt = Vt + D * kLd;       // (D, kLd) by column
  float* dOt = Qt + D * kLd;      // (D, kLd) by column
  float* Qsc = dOt + D * kLd;     // (64, D) by row: T(Q r scale)
  float* dOsc = Qsc + kTile * D;  // (64, D) by row: T(dO r / (1 - p))
  float* P1 = dOsc + kTile * D;   // (64 rows, kLd) by row: T(e_dropped)[r][c]
  float* P2 = P1 + kTile * kLd;   // (64 rows, kLd) by row: ds0[r][c]
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* q = a.q + b * a.qs[0] + h * a.qs[2];
  const T* k = a.k + b * a.ks[0] + h * a.ks[2];
  const T* v = a.v + b * a.vs[0] + h * a.vs[2];
  const long long ostride = static_cast<long long>(a.H) * D;
  const T* dout = a.dout + (static_cast<long long>(b) * a.Tq * a.H + h) * D;
  const float* bias = a.bias + static_cast<size_t>(b) * a.Tk;
  const float* lrow = a.l + static_cast<size_t>(bh) * a.Tq;

  load_tile<T, D, true, false>(Kt, k, a.ks[1], k0, a.Tk, One{});
  load_tile<T, D, true, false>(Vt, v, a.vs[1], k0, a.Tk, One{});

  float dk[4][DV], dv[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DV; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int q0 = 0; q0 < a.Tq; q0 += kTile) {
    float m[4], delta[4];
    bool live = true;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      const size_t at = static_cast<size_t>(bh) * a.Tq + row;
      m[i] = row < a.Tq ? a.m[at] : 0.f;
      delta[i] = row < a.Tq ? a.delta[at] : 0.f;
      live = live && (row >= a.Tq || m[i] > kLive);
    }
    // also the barrier before this tile's loads overwrite the last one's
    const bool all_live = __syncthreads_and(live);
    if (a.causal && all_live && q0 + kTile - 1 < k0) continue;  // masked for every row: e = 0

    const float scale = a.scale, inv_keep = a.inv_keep;
    load_tile<T, D, true, false>(Qt, q, a.qs[1], q0, a.Tq, Const{a.q_mul});
    load_tile<T, D, true, false>(dOt, dout, ostride, q0, a.Tq, One{});
    load_tile<T, D, false, true>(Qsc, q, a.qs[1], q0, a.Tq,
                                 [=](int row) { return (1.0f / lrow[row]) * scale; });
    load_tile<T, D, false, true>(dOsc, dout, ostride, q0, a.Tq,
                                 [=](int row) { return (1.0f / lrow[row]) * inv_keep; });
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<D>(Qt, Kt, ty, tx, s);
    tile_dot<D>(dOt, Vt, ty, tx, dp);
    backward_tile(a, bias, bh, q0, k0, ty, tx, m, delta, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(P1 + (ty * 4 + i) * kLd + tx * 4) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      *reinterpret_cast<float4*>(P2 + (ty * 4 + i) * kLd + tx * 4) =
          make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
    }
    __syncthreads();
    // here ty indexes keys: dv[c][d] += sum_r P1[r][c] dOsc[r][d], dk likewise
    tile_acc<D>(P1, kLd, dOsc, ty, tx, dv);
    tile_acc<D>(P2, kLd, Qsc, ty, tx, dk);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = k0 + ty * 4 + i;
    if (col >= a.Tk) continue;
    const size_t at = ((static_cast<size_t>(b) * a.Tk + col) * a.H + h) * D + tx * DV;
#pragma unroll
    for (int j = 0; j < DV; ++j) {
      a.dk[at + j] = from_f<T>(dk[i][j]);
      a.dv[at + j] = from_f<T>(dv[i][j]);
    }
  }
}

// ------------------------------------------------------ bf16, tensor cores

constexpr int kWg = 128;  // one warpgroup per block

template <int D> __host__ __device__ constexpr uint32_t tile_bytes() { return kTile * 2 * D; }

__device__ __forceinline__ float ld_bias(const float* bias, int col, int Tk) {
  return col < Tk ? __ldg(bias + col) : -INFINITY;
}

// dead[t] = 1 for the key tiles t whose keys are all padded (bias -1e9 or
// past Tk) or all past `last_row` (causal: masked for every row up to it).
__device__ __forceinline__ void dead_key_tiles(const float* bias, int Tk, int last_row,
                                               uint8_t* dead, int tid) {
  const int lane = tid % 32;
  for (int t = tid / 32; t * kTile < Tk; t += kWg / 32) {
    const int k0 = t * kTile + lane, k1 = k0 + 32;
    const bool pad = (k0 >= Tk || __ldg(bias + k0) <= kNegInf) &&
                     (k1 >= Tk || __ldg(bias + k1) <= kNegInf);
    const bool all = __all_sync(0xffffffffu, pad);
    if (lane == 0) dead[t] = all || t * kTile > last_row;
  }
}

// The next tile after t that is not skipped: skipping needs every row live.
__device__ __forceinline__ int next_tile(int t, int n, bool all_live, const uint8_t* dead) {
  for (++t; t < n && all_live && dead[t]; ++t) {
  }
  return t;
}

// (B, T, H, D) rows of (b, h) as bf16 pairs from fp32 accumulator columns
template <int D, int N>
__device__ __forceinline__ void store_rows(bf16* dst, long long row_stride, int row0, int n_rows,
                                           const float (&acc)[N], const float (&mul)[2],
                                           int tid) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + acc_row(tid, h);
    if (row >= n_rows) continue;
    bf16* p = dst + static_cast<long long>(row) * row_stride;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(p + acc_col(tid, i)) =
          __floats2bfloat162_rn(acc[i] * mul[h], acc[i + 1] * mul[h]);
    }
  }
}

// S (64 x 64) = A B^T over depth D, both K-major tiles in shared memory;
// issued, not committed.
template <int D>
__device__ __forceinline__ void issue_scores(float (&s)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  fence_regs(s);
  wgmma_fence();
  const uint64_t da = make_desc<D>(a), db = make_desc<D>(b);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(s, da + 2 * kk, db + 2 * kk);
}

// acc (64 x D) += P (64 x 64, fp32 accumulator, rounded to bf16) B, B the
// (64, D) tile at b read by its rows (MN-major); issued, not committed.
template <int D>
__device__ __forceinline__ void issue_accumulate(float (&acc)[D / 2], const float (&p)[32],
                                                 uint32_t b) {
  uint32_t a[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) acc_to_a(p, kk, a[kk]);
  fence_regs(acc);
  wgmma_fence();
  const uint64_t db = make_desc<D>(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, a[kk], db + kk * (16 * 2 * D / 16));
}

template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 2], const float (&p)[32], uint32_t b) {
  issue_accumulate<D>(acc, p, b);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
}

// at most 128 registers, so that four blocks share an SM (no spills at D = 64)
template <int D>
__global__ void __launch_bounds__(kWg, 4) flash_fwd_tc(const Args<bf16> a) {
  constexpr uint32_t kB = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  const uint32_t sQ = smem_addr(base), sK = sQ + kB, sV = sK + 2 * kB;  // K, V: 2 stages
  uint8_t* dead = base + 5 * kB;
  const int tid = threadIdx.x, c = tid % 4;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int n_qt = (a.Tq + kTile - 1) / kTile, n_kt = (a.Tk + kTile - 1) / kTile;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * kTile;  // heaviest first
  const bf16* q = a.q + b * a.qs[0] + h * a.qs[2];
  const bf16* k = a.k + b * a.ks[0] + h * a.ks[2];
  const bf16* v = a.v + b * a.vs[0] + h * a.vs[2];
  const float* bias = a.bias + static_cast<size_t>(b) * a.Tk;

  load_tile_async<D>(sQ, q, a.qs[1], q0, a.Tq, tid);
  load_tile_async<D>(sK, k, a.ks[1], 0, a.Tk, tid);
  load_tile_async<D>(sV, v, a.vs[1], 0, a.Tk, tid);
  cp_async_commit();
  dead_key_tiles(bias, a.Tk, a.causal ? min(q0 + kTile, a.Tq) - 1 : a.Tk, dead, tid);

  int row[2];
  float m[2], l[2], o[D / 2];
  uint32_t mbase[2], cnt0[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + acc_row(tid, i);
    m[i] = -INFINITY;
    l[i] = 0.f;
    mbase[i] = mask_base(a.seed, static_cast<uint32_t>(mask_bh(a, bh) * 8192 + row[i] / a.block_q));
    cnt0[i] = static_cast<uint32_t>(row[i] % a.block_q) * static_cast<uint32_t>(a.Tk);
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  for (int t = 0, stage = 0;; stage ^= 1) {
    cp_async_wait_all();
    fence_async_shared();
    const bool live = (row[0] >= a.Tq || m[0] > kLive) && (row[1] >= a.Tq || m[1] > kLive);
    const bool all_live = __syncthreads_and(live);  // tile t landed; the other stage is free
    const int nt = next_tile(t, n_kt, all_live, dead);
    if (nt < n_kt) {
      load_tile_async<D>(sK + (stage ^ 1) * kB, k, a.ks[1], nt * kTile, a.Tk, tid);
      load_tile_async<D>(sV + (stage ^ 1) * kB, v, a.vs[1], nt * kTile, a.Tk, tid);
      cp_async_commit();
    }
    if (!(all_live && dead[t])) {
      const int k0 = t * kTile;
      float s[32];
      issue_scores<D>(s, sQ, sK + stage * kB);
      wgmma_commit();
      float bc[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) bc[j] = ld_bias(bias, k0 + 8 * (j / 2) + 2 * c + j % 2, a.Tk);
      wgmma_wait_all();
      fence_regs(s);

      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i / 2) % 2, col = k0 + acc_col(tid, i);
        float x = s[i] * a.scale + bc[2 * (i / 4) + i % 2];
        if (a.causal && col > row[r]) x = kNegInf;
        if (col >= a.Tk) x = -INFINITY;
        s[i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = __expf(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i / 2) % 2;
        const float e = __expf(s[i] - m[r]);
        sum[r] += e;
        s[i] = (a.dropout_on &&
                !mask_keep(mbase[r], cnt0[r] + static_cast<uint32_t>(k0 + acc_col(tid, i)),
                           a.threshold))
                   ? 0.f
                   : e;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * alpha[r] + sum[r];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];
      accumulate<D>(o, s, sV + stage * kB);
    }
    if (nt >= n_kt) break;
    t = nt;
  }

  const float norm[2] = {1.0f / (l[0] * a.keep_div), 1.0f / (l[1] * a.keep_div)};
  store_rows<D>(a.out + (static_cast<size_t>(b) * a.Tq * a.H + h) * D,
                static_cast<long long>(a.H) * D, q0, a.Tq, o, norm, tid);
  if (c == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= a.Tq) continue;
      a.m[static_cast<size_t>(bh) * a.Tq + row[r]] = m[r];
      a.l[static_cast<size_t>(bh) * a.Tq + row[r]] = l[r];
    }
  }
}

// dQ: one block per (batch * head, query tile), looping over key tiles.
template <int D>
__global__ void __launch_bounds__(kWg) flash_dq_tc(const Args<bf16> a) {
  constexpr uint32_t kB = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  const uint32_t sQ = smem_addr(base), sO = sQ + kB, sK = sO + kB, sV = sK + 2 * kB;
  uint8_t* dead = base + 6 * kB;
  const int tid = threadIdx.x, c = tid % 4;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int n_qt = (a.Tq + kTile - 1) / kTile, n_kt = (a.Tk + kTile - 1) / kTile;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * kTile;
  const bf16* q = a.q + b * a.qs[0] + h * a.qs[2];
  const bf16* k = a.k + b * a.ks[0] + h * a.ks[2];
  const bf16* v = a.v + b * a.vs[0] + h * a.vs[2];
  const long long ostride = static_cast<long long>(a.H) * D;
  const bf16* dout = a.dout + (static_cast<long long>(b) * a.Tq * a.H + h) * D;
  const float* bias = a.bias + static_cast<size_t>(b) * a.Tk;

  dead_key_tiles(bias, a.Tk, a.causal ? min(q0 + kTile, a.Tq) - 1 : a.Tk, dead, tid);
  int row[2];
  float m[2], r[2], delta[2];
  uint32_t mbase[2], cnt0[2];
  bool live = true;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + acc_row(tid, i);
    const bool in = row[i] < a.Tq;
    const size_t at = static_cast<size_t>(bh) * a.Tq + row[i];
    m[i] = in ? a.m[at] : 0.f;
    r[i] = in ? 1.0f / a.l[at] : 0.f;
    delta[i] = in ? a.delta[at] : 0.f;
    live = live && (!in || m[i] > kLive);
    mbase[i] = mask_base(a.seed, static_cast<uint32_t>(mask_bh(a, bh) * 8192 + row[i] / a.block_q));
    cnt0[i] = static_cast<uint32_t>(row[i] % a.block_q) * static_cast<uint32_t>(a.Tk);
  }
  const bool all_live = __syncthreads_and(live);
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  int t = next_tile(-1, n_kt, all_live, dead);
  if (t < n_kt) {
    load_tile_async<D>(sQ, q, a.qs[1], q0, a.Tq, tid);
    load_tile_async<D>(sO, dout, ostride, q0, a.Tq, tid);
    load_tile_async<D>(sK, k, a.ks[1], t * kTile, a.Tk, tid);
    load_tile_async<D>(sV, v, a.vs[1], t * kTile, a.Tk, tid);
    cp_async_commit();
  }
  for (int stage = 0; t < n_kt; stage ^= 1) {
    cp_async_wait_all();
    fence_async_shared();
    __syncthreads();
    const int nt = next_tile(t, n_kt, all_live, dead);
    if (nt < n_kt) {
      load_tile_async<D>(sK + (stage ^ 1) * kB, k, a.ks[1], nt * kTile, a.Tk, tid);
      load_tile_async<D>(sV + (stage ^ 1) * kB, v, a.vs[1], nt * kTile, a.Tk, tid);
      cp_async_commit();
    }
    const int k0 = t * kTile;
    float s[32], dp[32];
    issue_scores<D>(s, sQ, sK + stage * kB);
    issue_scores<D>(dp, sO, sV + stage * kB);
    wgmma_commit();
    float bc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) bc[j] = ld_bias(bias, k0 + 8 * (j / 2) + 2 * c + j % 2, a.Tk);
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rr = (i / 2) % 2, col = k0 + acc_col(tid, i);
      float x = s[i] * a.scale + bc[2 * (i / 4) + i % 2];
      if (a.causal && col > row[rr]) x = kNegInf;
      if (col >= a.Tk) x = -INFINITY;
      float ds = 0.f;
      if (row[rr] < a.Tq) {
        const float e = __expf(x - m[rr]);
        float d = dp[i];
        if (a.dropout_on)
          d = mask_keep(mbase[rr], cnt0[rr] + static_cast<uint32_t>(col), a.threshold)
                  ? d * a.inv_keep
                  : 0.f;
        ds = e * (d - delta[rr]);
      }
      s[i] = ds;
    }
    accumulate<D>(dq, s, sK + stage * kB);
    t = nt;
  }

  const float rs[2] = {r[0] * a.scale, r[1] * a.scale};
  store_rows<D>(a.dq + (static_cast<size_t>(b) * a.Tq * a.H + h) * D, ostride, q0, a.Tq, dq, rs,
                tid);
}

// Per query of a tile, what the dK/dV kernel reads by column.
struct QueryStats {
  float m[kTile], r[kTile], delta[kTile];
  uint32_t base[kTile], cnt0[kTile];
};

__device__ __forceinline__ void load_query_stats(const Args<bf16>& a, int bh, int q0,
                                                 QueryStats& st, int tid) {
  if (tid >= kTile) return;
  const int qq = q0 + tid;
  const bool in = qq < a.Tq;
  const size_t at = static_cast<size_t>(bh) * a.Tq + qq;
  st.m[tid] = in ? a.m[at] : INFINITY;  // e = 0 for queries past Tq
  st.r[tid] = in ? 1.0f / a.l[at] : 0.f;
  st.delta[tid] = in ? a.delta[at] : 0.f;
  st.base[tid] = mask_base(a.seed, static_cast<uint32_t>(mask_bh(a, bh) * 8192 + qq / a.block_q));
  st.cnt0[tid] = static_cast<uint32_t>(qq % a.block_q) * static_cast<uint32_t>(a.Tk);
}

// dst = bf16(src * mul[row]) for a swizzled (64, D) tile (rows keep their place)
template <int D>
__device__ __forceinline__ void scale_rows(uint8_t* dst, const uint8_t* src, const float* rmul,
                                           float mul, int tid) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kWg; ++i) {
    const int idx = tid + kWg * i, rr = idx / kChunks;
    const uint32_t off = swizzled<D>(rr, idx % kChunks);
    const float f = rmul[rr] * mul;
    uint4 u = *reinterpret_cast<const uint4*>(src + off);
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x = __bfloat1622float2(p[j]);
      p[j] = __floats2bfloat162_rn(x.x * f, x.y * f);
    }
    *reinterpret_cast<uint4*>(dst + off) = u;
  }
}

// dK, dV: one block per (batch * head, key tile), looping over query tiles.
template <int D>
__global__ void __launch_bounds__(kWg) flash_dkdv_tc(const Args<bf16> a) {
  constexpr uint32_t kB = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  // K, V once; Q, dO in two stages; T(Q r scale), T(dO r / (1 - p)) of the current tile
  uint8_t* pQ = base + 2 * kB;
  uint8_t* pO = pQ + 2 * kB;
  uint8_t* pQs = pO + 2 * kB;
  uint8_t* pOs = pQs + kB;
  QueryStats* stats = reinterpret_cast<QueryStats*>(pOs + kB);  // two stages
  uint8_t* skip = reinterpret_cast<uint8_t*>(stats + 2);
  const uint32_t sK = smem_addr(base), sV = sK + kB, sQ = smem_addr(pQ), sO = smem_addr(pO);
  const int tid = threadIdx.x, lane = tid % 32;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int n_qt = (a.Tq + kTile - 1) / kTile;
  const int k0 = static_cast<int>(blockIdx.y) * kTile;  // the first key tiles are the heaviest
  const bf16* q = a.q + b * a.qs[0] + h * a.qs[2];
  const bf16* k = a.k + b * a.ks[0] + h * a.ks[2];
  const bf16* v = a.v + b * a.vs[0] + h * a.vs[2];
  const long long ostride = static_cast<long long>(a.H) * D;
  const bf16* dout = a.dout + (static_cast<long long>(b) * a.Tq * a.H + h) * D;
  const float* bias = a.bias + static_cast<size_t>(b) * a.Tk;
  const float* mrow = a.m + static_cast<size_t>(bh) * a.Tq;

  int key[2];
  float kb[2];
  bool pad = true;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = k0 + acc_row(tid, i);
    kb[i] = ld_bias(bias, key[i], a.Tk);
    pad = pad && kb[i] <= kNegInf;
  }
  const bool padded = __syncthreads_and(pad);  // every key of the tile padded
  // skip[t]: no query of tile t reaches these keys (e is exactly 0) and every
  // query of it has seen a live score
  for (int t = tid / 32; t < n_qt; t += kWg / 32) {
    const int qa = t * kTile + lane, qb = qa + 32;
    const bool lv = (qa >= a.Tq || mrow[qa] > kLive) && (qb >= a.Tq || mrow[qb] > kLive);
    const bool all = __all_sync(0xffffffffu, lv);
    const bool masked = a.causal && min((t + 1) * kTile, a.Tq) - 1 < k0;
    if (lane == 0) skip[t] = all && (padded || masked);
  }
  __syncthreads();

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  int t = next_tile(-1, n_qt, true, skip);
  if (t < n_qt) {
    load_tile_async<D>(sK, k, a.ks[1], k0, a.Tk, tid);
    load_tile_async<D>(sV, v, a.vs[1], k0, a.Tk, tid);
    load_tile_async<D>(sQ, q, a.qs[1], t * kTile, a.Tq, tid);
    load_tile_async<D>(sO, dout, ostride, t * kTile, a.Tq, tid);
    cp_async_commit();
    load_query_stats(a, bh, t * kTile, stats[0], tid);
  }
  for (int stage = 0; t < n_qt; stage ^= 1) {
    cp_async_wait_all();
    fence_async_shared();
    __syncthreads();  // tile t and its stats landed; the other stage is free
    const int nt = next_tile(t, n_qt, true, skip);
    if (nt < n_qt) {
      load_tile_async<D>(sQ + (stage ^ 1) * kB, q, a.qs[1], nt * kTile, a.Tq, tid);
      load_tile_async<D>(sO + (stage ^ 1) * kB, dout, ostride, nt * kTile, a.Tq, tid);
      cp_async_commit();
      load_query_stats(a, bh, nt * kTile, stats[stage ^ 1], tid);
    }
    const QueryStats& st = stats[stage];
    const int q0 = t * kTile;
    float s[32], dp[32];
    issue_scores<D>(s, sK, sQ + stage * kB);   // S^T = K Q^T
    issue_scores<D>(dp, sV, sO + stage * kB);  // dP^T = V dO^T
    wgmma_commit();
    // while the products run: the scaled copies the dK and dV products read
    scale_rows<D>(pQs, pQ + stage * kB, st.r, a.scale, tid);
    scale_rows<D>(pOs, pO + stage * kB, st.r, a.inv_keep, tid);
    fence_async_shared();
    __syncthreads();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rr = (i / 2) % 2, ql = acc_col(tid, i);
      float x = s[i] * a.scale + kb[rr];
      if (a.causal && key[rr] > q0 + ql) x = kNegInf;
      if (key[rr] >= a.Tk) x = -INFINITY;
      const float e = __expf(x - st.m[ql]);
      float d = dp[i], ed = e;
      if (a.dropout_on) {
        if (mask_keep(st.base[ql], st.cnt0[ql] + static_cast<uint32_t>(key[rr]), a.threshold)) {
          d = d * a.inv_keep;
        } else {
          d = 0.f;
          ed = 0.f;
        }
      }
      s[i] = ed;
      dp[i] = e * (d - st.delta[ql]);
    }
    issue_accumulate<D>(dv, s, smem_addr(pOs));
    issue_accumulate<D>(dk, dp, smem_addr(pQs));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv);
    fence_regs(dk);
    t = nt;
  }

  const float one[2] = {1.f, 1.f};
  const size_t at = static_cast<size_t>(b) * a.Tk * a.H + h;
  store_rows<D>(a.dk + at * D, ostride, k0, a.Tk, dk, one, tid);
  store_rows<D>(a.dv + at * D, ostride, k0, a.Tk, dv, one, tid);
}

// ------------------------------------------------------------------- launch

template <int D> constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * D * kLd + kTile * D + kTile * kLd);
}
template <int D> constexpr size_t dq_smem() {
  return sizeof(float) * (4 * D * kLd + kTile * D + kTile * kLd);
}
template <int D> constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * D * kLd + 2 * kTile * D + 2 * kTile * kLd);
}
// bf16: 1,024 bytes to align the tiles, the tiles, then per-tile data
template <int D> size_t fwd_tc_smem(int n_kt) { return 1024 + 5 * tile_bytes<D>() + n_kt; }
template <int D> size_t dq_tc_smem(int n_kt) { return 1024 + 6 * tile_bytes<D>() + n_kt; }
template <int D> size_t dkdv_tc_smem(int n_qt) {
  return 1024 + 8 * tile_bytes<D>() + 2 * sizeof(QueryStats) + n_qt;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int D>
int launch_fwd(const Args<float>& a, cudaStream_t s) {
  cudaError_t err = allow_smem(flash_fwd_kernel<float, D>, fwd_smem<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(cdiv(a.Tq, kTile), a.B * a.H);
  flash_fwd_kernel<float, D><<<grid, kThreads, fwd_smem<D>(), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_fwd(const Args<bf16>& a, cudaStream_t s) {
  const size_t smem = fwd_tc_smem<D>(cdiv(a.Tk, kTile));
  cudaError_t err = allow_smem(flash_fwd_tc<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_tc<D><<<dim3(a.B * a.H, cdiv(a.Tq, kTile)), kWg, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
void launch_delta(const Args<T>& a, cudaStream_t s) {
  const long long threads = static_cast<long long>(a.B) * a.Tq * a.H * (D / vec<T>());
  flash_delta_kernel<T, D><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, s>>>(a);
}

template <int D>
int launch_bwd(const Args<float>& a, cudaStream_t s) {
  cudaError_t err = allow_smem(flash_dq_kernel<float, D>, dq_smem<D>());
  if (err == cudaSuccess) err = allow_smem(flash_dkdv_kernel<float, D>, dkdv_smem<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_delta<float, D>(a, s);
  const dim3 qgrid(cdiv(a.Tq, kTile), a.B * a.H);
  flash_dq_kernel<float, D><<<qgrid, kThreads, dq_smem<D>(), s>>>(a);
  const dim3 kgrid(cdiv(a.Tk, kTile), a.B * a.H);
  flash_dkdv_kernel<float, D><<<kgrid, kThreads, dkdv_smem<D>(), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(const Args<bf16>& a, cudaStream_t s) {
  const int n_qt = cdiv(a.Tq, kTile), n_kt = cdiv(a.Tk, kTile);
  const size_t dq = dq_tc_smem<D>(n_kt), dkdv = dkdv_tc_smem<D>(n_qt);
  cudaError_t err = allow_smem(flash_dq_tc<D>, dq);
  if (err == cudaSuccess) err = allow_smem(flash_dkdv_tc<D>, dkdv);
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_delta<bf16, D>(a, s);
  flash_dq_tc<D><<<dim3(a.B * a.H, n_qt), kWg, dq, s>>>(a);
  flash_dkdv_tc<D><<<dim3(a.B * a.H, n_kt), kWg, dkdv, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
Args<T> make_args(int B, int H, int Tq, int Tk, const void* q, const void* k, const void* v,
                  const long long* strides, const void* bias, float scale, int fold, int causal,
                  int dropout_on, float keep_div, float inv_keep, unsigned threshold,
                  unsigned seed, int block_q, int mask_b0, int mask_heads, int mask_h0) {
  Args<T> a{};
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.bias = static_cast<const float*>(bias);
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
  }
  a.B = B; a.H = H; a.Tq = Tq; a.Tk = Tk;
  a.scale = scale;
  a.q_mul = fold ? scale : 1.0f;
  a.s_mul = fold ? 1.0f : scale;
  a.keep_div = dropout_on ? keep_div : 1.0f;
  a.inv_keep = dropout_on ? inv_keep : 1.0f;
  a.causal = causal;
  a.dropout_on = dropout_on;
  a.threshold = threshold;
  a.seed = seed;
  a.block_q = block_q;
  a.mask_b0 = mask_b0;
  a.mask_heads = mask_heads;
  a.mask_h0 = mask_h0;
  return a;
}

bool shape_ok(int B, int H, int Tq, int Tk, int D, int block_q, int mask_b0, int mask_heads,
              int mask_h0) {
  // the fp32 kernels' blockIdx.y carries batch * head; the salt bh * 8192 + row / block_q is
  // the TPU kernel's
  return B >= 1 && H >= 1 && Tq >= 1 && Tk >= 1 && block_q >= 1 && (D == 32 || D == 64) &&
         static_cast<long long>(B) * H <= 65535 && mask_b0 >= 0 && mask_h0 >= 0 &&
         mask_h0 + H <= mask_heads;
}

}  // namespace

extern "C" {

// q (B, Tq, H, D), k and v (B, Tk, H, D) of T through `strides` (9 values in
// elements: batch, row, head of q, then k, then v; the last axis is dense
// and every stride a multiple of 16 bytes); bias (B, Tk) fp32; out
// (B, Tq, H, D) T contiguous; m, l (B, H, Tq) fp32.  T is bf16 when is_bf16,
// else fp32.  D is 32 or 64.  fold: scale is a power of two and rides on Q.
// With dropout_on, keep_div = 1 - p, inv_keep = 1 / (1 - p), threshold =
// uint32(p * 2^32).  mask_b0, mask_heads, mask_h0: where the call's batch
// rows and heads lie in the global ones (0, H, 0 for the whole).
int tts_flash_fwd(int is_bf16, int B, int H, int Tq, int Tk, int D, const void* q, const void* k,
                  const void* v, const long long* strides, const void* bias, void* out, void* m,
                  void* l, float scale, int fold, int causal, int dropout_on, float keep_div,
                  float inv_keep, unsigned threshold, unsigned seed, int block_q, int mask_b0,
                  int mask_heads, int mask_h0, void* stream) {
  if (!shape_ok(B, H, Tq, Tk, D, block_q, mask_b0, mask_heads, mask_h0))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
#define TTS_FLASH_FWD(T)                                                                     \
  {                                                                                          \
    Args<T> a = make_args<T>(B, H, Tq, Tk, q, k, v, strides, bias, scale, fold, causal,      \
                             dropout_on, keep_div, inv_keep, threshold, seed, block_q,       \
                             mask_b0, mask_heads, mask_h0);                                  \
    a.out = static_cast<T*>(out);                                                            \
    a.m = static_cast<float*>(m);                                                            \
    a.l = static_cast<float*>(l);                                                            \
    return D == 32 ? launch_fwd<32>(a, s) : launch_fwd<64>(a, s);                            \
  }
  if (is_bf16) TTS_FLASH_FWD(bf16)
  TTS_FLASH_FWD(float)
#undef TTS_FLASH_FWD
}

// As tts_flash_fwd, plus o and dout (B, Tq, H, D) T contiguous, the
// forward's m and l, delta (B, H, Tq) fp32 scratch, and the results dq
// (B, Tq, H, D), dk, dv (B, Tk, H, D) T contiguous.
int tts_flash_bwd(int is_bf16, int B, int H, int Tq, int Tk, int D, const void* q, const void* k,
                  const void* v, const long long* strides, const void* bias, const void* o,
                  const void* dout, void* m, void* l, void* delta, void* dq, void* dk, void* dv,
                  float scale, int fold, int causal, int dropout_on, float keep_div,
                  float inv_keep, unsigned threshold, unsigned seed, int block_q, int mask_b0,
                  int mask_heads, int mask_h0, void* stream) {
  if (!shape_ok(B, H, Tq, Tk, D, block_q, mask_b0, mask_heads, mask_h0))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
#define TTS_FLASH_BWD(T)                                                                     \
  {                                                                                          \
    Args<T> a = make_args<T>(B, H, Tq, Tk, q, k, v, strides, bias, scale, fold, causal,      \
                             dropout_on, keep_div, inv_keep, threshold, seed, block_q,       \
                             mask_b0, mask_heads, mask_h0);                                  \
    a.o = static_cast<const T*>(o);                                                          \
    a.dout = static_cast<const T*>(dout);                                                    \
    a.m = static_cast<float*>(m);                                                            \
    a.l = static_cast<float*>(l);                                                            \
    a.delta = static_cast<float*>(delta);                                                    \
    a.dq = static_cast<T*>(dq);                                                              \
    a.dk = static_cast<T*>(dk);                                                              \
    a.dv = static_cast<T*>(dv);                                                              \
    return D == 32 ? launch_bwd<32>(a, s) : launch_bwd<64>(a, s);                            \
  }
  if (is_bf16) TTS_FLASH_BWD(bf16)
  TTS_FLASH_BWD(float)
#undef TTS_FLASH_BWD
}

// Dynamic shared memory per block, in bytes, of the forward, dQ and dK/dV
// kernels for these sizes, into out[0..2].
int tts_flash_shared_bytes(int is_bf16, int D, int Tq, int Tk, long long* out) {
  if (D != 32 && D != 64) return static_cast<int>(cudaErrorInvalidValue);
  const int n_qt = cdiv(Tq, kTile), n_kt = cdiv(Tk, kTile);
  const bool d64 = D == 64;
  if (is_bf16) {
    out[0] = d64 ? fwd_tc_smem<64>(n_kt) : fwd_tc_smem<32>(n_kt);
    out[1] = d64 ? dq_tc_smem<64>(n_kt) : dq_tc_smem<32>(n_kt);
    out[2] = d64 ? dkdv_tc_smem<64>(n_qt) : dkdv_tc_smem<32>(n_qt);
  } else {
    out[0] = d64 ? fwd_smem<64>() : fwd_smem<32>();
    out[1] = d64 ? dq_smem<64>() : dq_smem<32>();
    out[2] = d64 ? dkdv_smem<64>() : dkdv_smem<32>();
  }
  return 0;
}

}  // extern "C"
