// O = Dropout(softmax(Q K^T / sqrt(D) + key_bias (+ causal))) V, forward and
// backward, with the score matrix never in device memory, for Hopper (sm_90a).
//
// Replaces the TPU kernels transformertts_tpu/ops/pallas/flash_attention.py:
// _fwd (_fwd_kernel) and _bwd (_bwd_kernel).  The plain PyTorch version, op
// for op, is flash_attention_reference / flash_attention_backward_reference
// in ../flash_attention.py.  Numerics as the TPU kernel: operands of the
// storage type T (bf16 or fp32) with fp32 accumulation; 1/sqrt(D) folded
// into Q when it is a power of two, else applied to the fp32 scores; the
// bias added in fp32; causal REPLACES the score by -1e9; l is the row sum of
// e = exp(s - m) before dropout; e is rounded to T unnormalised for P V;
// 1 / (l (1 - p)) multiplies the fp32 output rows.  In the backward,
// dO r / (1 - p), e (dP - delta) and Q r scale are rounded to T before their
// products, and r scale multiplies the fp32 dQ rows, with r = 1 / l and
// delta = sum(dO * O) from the stored (rounded) O.
//
// Bound: operations (4 Tq Tk D per (batch, head) forward, the bytes are
// those of Q, K, V, O only).  This first version runs them as fp32 FMAs on
// the CUDA cores, not on the tensor cores: a 64 x 64 score tile per block of
// 256 threads, every thread a 4 x 4 sub-tile, operands staged in shared
// memory (transposed where the product reads them by column, so that every
// inner-loop read is one 16-byte vector), K and V taken in tiles of 64 keys
// because one (batch, head)'s K and V at 768 keys do not fit beside the
// rest.  wgmma and TMA are later work.
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
// Key tiles that causal masks entirely are skipped when every row of the
// query tile already has a maximum far above -1e9 (their e is exactly 0
// then); a row whose keys are all padded keeps the TPU kernel's uniform
// weights over all Tk keys.
//
// The dropout mask is a function of the logical index (dropout_mask.cuh):
// element (bh, row, col) takes salt = bh * 8192 + row / block_q and counter
// = (row % block_q) * Tk + col, where block_q is the query-block height the
// TPU kernel would pick (passed in; it shapes nothing but the mask).
//
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "dropout_mask.cuh"
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
};

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
    base[i] = mask_base(a.seed, static_cast<uint32_t>(bh * 8192 + row / a.block_q));
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

// delta (B, H, Tq) = sum_d dO * O, one warp per (batch, row, head).
template <typename T>
__global__ void flash_delta_kernel(const Args<T> a, int D) {
  const int lane = threadIdx.x & 31;
  const long long n = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const long long total = static_cast<long long>(a.B) * a.Tq * a.H;
  if (n >= total) return;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += to_f<T>(a.dout[n * D + d]) * to_f<T>(a.o[n * D + d]);
  s = warp_sum(s);
  if (lane == 0) {
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
        mask_base(a.seed, static_cast<uint32_t>(bh * 8192 + row / a.block_q));
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

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
int launch_fwd(const Args<T>& a, cudaStream_t s) {
  cudaError_t err = allow_smem(flash_fwd_kernel<T, D>, fwd_smem<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Tq + kTile - 1) / kTile, a.B * a.H);
  flash_fwd_kernel<T, D><<<grid, kThreads, fwd_smem<D>(), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd(const Args<T>& a, cudaStream_t s) {
  cudaError_t err = allow_smem(flash_dq_kernel<T, D>, dq_smem<D>());
  if (err == cudaSuccess) err = allow_smem(flash_dkdv_kernel<T, D>, dkdv_smem<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long vectors = static_cast<long long>(a.B) * a.Tq * a.H;
  flash_delta_kernel<T><<<static_cast<unsigned>((vectors + 7) / 8), 256, 0, s>>>(a, D);
  const dim3 qgrid((a.Tq + kTile - 1) / kTile, a.B * a.H);
  flash_dq_kernel<T, D><<<qgrid, kThreads, dq_smem<D>(), s>>>(a);
  const dim3 kgrid((a.Tk + kTile - 1) / kTile, a.B * a.H);
  flash_dkdv_kernel<T, D><<<kgrid, kThreads, dkdv_smem<D>(), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
Args<T> make_args(int B, int H, int Tq, int Tk, const void* q, const void* k, const void* v,
                  const long long* strides, const void* bias, float scale, int fold, int causal,
                  int dropout_on, float keep_div, float inv_keep, unsigned threshold,
                  unsigned seed, int block_q) {
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
  return a;
}

bool shape_ok(int B, int H, int Tq, int Tk, int D, int block_q) {
  // blockIdx.y carries batch * head; the salt bh * 8192 + row / block_q is the TPU kernel's
  return B >= 1 && H >= 1 && Tq >= 1 && Tk >= 1 && block_q >= 1 && (D == 32 || D == 64) &&
         static_cast<long long>(B) * H <= 65535;
}

}  // namespace

extern "C" {

// q (B, Tq, H, D), k and v (B, Tk, H, D) of T through `strides` (9 values in
// elements: batch, row, head of q, then k, then v; the last axis is dense
// and every stride a multiple of 16 bytes); bias (B, Tk) fp32; out
// (B, Tq, H, D) T contiguous; m, l (B, H, Tq) fp32.  T is bf16 when is_bf16,
// else fp32.  D is 32 or 64.  fold: scale is a power of two and rides on Q.
// With dropout_on, keep_div = 1 - p, inv_keep = 1 / (1 - p), threshold =
// uint32(p * 2^32).
int tts_flash_fwd(int is_bf16, int B, int H, int Tq, int Tk, int D, const void* q, const void* k,
                  const void* v, const long long* strides, const void* bias, void* out, void* m,
                  void* l, float scale, int fold, int causal, int dropout_on, float keep_div,
                  float inv_keep, unsigned threshold, unsigned seed, int block_q, void* stream) {
  if (!shape_ok(B, H, Tq, Tk, D, block_q)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
#define TTS_FLASH_FWD(T)                                                                     \
  {                                                                                          \
    Args<T> a = make_args<T>(B, H, Tq, Tk, q, k, v, strides, bias, scale, fold, causal,      \
                             dropout_on, keep_div, inv_keep, threshold, seed, block_q);      \
    a.out = static_cast<T*>(out);                                                            \
    a.m = static_cast<float*>(m);                                                            \
    a.l = static_cast<float*>(l);                                                            \
    return D == 32 ? launch_fwd<T, 32>(a, s) : launch_fwd<T, 64>(a, s);                      \
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
                  float inv_keep, unsigned threshold, unsigned seed, int block_q, void* stream) {
  if (!shape_ok(B, H, Tq, Tk, D, block_q)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
#define TTS_FLASH_BWD(T)                                                                     \
  {                                                                                          \
    Args<T> a = make_args<T>(B, H, Tq, Tk, q, k, v, strides, bias, scale, fold, causal,      \
                             dropout_on, keep_div, inv_keep, threshold, seed, block_q);      \
    a.o = static_cast<const T*>(o);                                                          \
    a.dout = static_cast<const T*>(dout);                                                    \
    a.m = static_cast<float*>(m);                                                            \
    a.l = static_cast<float*>(l);                                                            \
    a.delta = static_cast<float*>(delta);                                                    \
    a.dq = static_cast<T*>(dq);                                                              \
    a.dk = static_cast<T*>(dk);                                                              \
    a.dv = static_cast<T*>(dv);                                                              \
    return D == 32 ? launch_bwd<T, 32>(a, s) : launch_bwd<T, 64>(a, s);                      \
  }
  if (is_bf16) TTS_FLASH_BWD(bf16)
  TTS_FLASH_BWD(float)
#undef TTS_FLASH_BWD
}

}  // extern "C"
