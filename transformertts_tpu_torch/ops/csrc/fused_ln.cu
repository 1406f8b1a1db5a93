// y = LayerNorm(x + Dropout(h)) * gamma + beta in one pass, forward and
// backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels transformertts_tpu/ops/pallas/fused_ln.py: _fwd
// (_fwd_kernel) and _bwd (_bwd_kernel).  The plain PyTorch version, op for
// op, is residual_dropout_layernorm_reference in ../fused_ln.py.  Numerics
// as the TPU kernel: everything fp32 from the loads on, z = x + (keep ?
// h / (1 - p) : 0), mean and E[z^2] - mean^2 (clamped at 0) over the row,
// eps inside the rsqrt; y, dx, dh rounded to the storage type T, dgamma and
// dbeta fp32.  The backward recomputes z, the statistics and the mask, so
// the forward saves nothing but its inputs.
//
// Bound: bytes (forward reads x, h and writes y; backward reads x, h, dy
// and writes dx, dh; about 10 operations per element).  One warp owns a
// row: the lanes read it in 16-byte vectors, neighbouring lanes on
// neighbouring bytes, keep it in registers, and reduce with shuffles, so
// every element is read once.  Rows beyond the grid are taken in strides.
//
// dgamma / dbeta are sums over all rows.  The TPU grid ran in order and
// carried them in scratch; blocks here run in no order, so every block
// writes the partial sums of its rows (warps added in a fixed order) and a
// second kernel adds the blocks' partials in index order: no atomics, the
// same bits on every run.
//
// The dropout mask is a function of the logical index (dropout_mask.cuh):
// element (row, col) takes salt = row / mask_rows and counter =
// (row % mask_rows) * D + col, where mask_rows is the row-block height the
// TPU kernel would pick (passed in; it shapes nothing but the mask).
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
constexpr int kWarps = kThreads / 32;  // rows a block works on at a time
constexpr int kMaxBlocks = 528;        // 4 blocks on each of 132 SMs

struct Mask {
  uint32_t seed, threshold;
  int rows;        // height of a mask block
  float keep_div;  // 1 - p
  int on;
};

// z = x + Dropout(h) of one row into registers (kPerLane values per lane:
// vector v of the lane starts at column (v * 32 + lane) * vec<T>()), the
// keep bits of those values, and the lane's share of sum z and sum z^2.
template <typename T, int kPerLane>
__device__ __forceinline__ void row_z(const T* x, const T* h, int D, int lane, int row,
                                      const Mask& mk, float* z, uint32_t& keep, float& sum,
                                      float& sq) {
  constexpr int V = vec<T>();
  const uint32_t base = mk.on ? mask_base(mk.seed, static_cast<uint32_t>(row / mk.rows)) : 0u;
  const uint32_t row0 = static_cast<uint32_t>(row % mk.rows) * static_cast<uint32_t>(D);
  keep = 0xffffffffu;
  sum = 0.f;
  sq = 0.f;
#pragma unroll
  for (int v = 0; v < kPerLane / V; ++v) {
    const int c0 = (v * 32 + lane) * V;
    if (c0 < D) {
      float xv[V], hv[V];
      load16<T>(x + c0, xv);
      load16<T>(h + c0, hv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float hd = hv[i];
        if (mk.on) {
          if (mask_keep(base, row0 + static_cast<uint32_t>(c0 + i), mk.threshold)) {
            hd = hd / mk.keep_div;
          } else {
            hd = 0.f;
            keep &= ~(1u << (v * V + i));
          }
        }
        const float zz = xv[i] + hd;
        z[v * V + i] = zz;
        sum += zz;
        sq += zz * zz;
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) z[v * V + i] = 0.f;
    }
  }
}

template <typename T, int kPerLane>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ h, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ y, int N, int D, float eps,
              Mask mk) {
  constexpr int V = vec<T>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int row = blockIdx.x * kWarps + warp; row < N; row += gridDim.x * kWarps) {
    const size_t off = static_cast<size_t>(row) * D;
    float z[kPerLane], sum, sq;
    uint32_t keep;
    row_z<T, kPerLane>(x + off, h + off, D, lane, row, mk, z, keep, sum, sq);
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    const float mu = sum / static_cast<float>(D);
    const float var = sq / static_cast<float>(D) - mu * mu;
    const float rstd = rsqrtf(fmaxf(var, 0.f) + eps);
#pragma unroll
    for (int v = 0; v < kPerLane / V; ++v) {
      const int c0 = (v * 32 + lane) * V;
      if (c0 < D) {
        float g[V], b[V], out[V];
        load16<float>(gamma + c0, g);
        load16<float>(beta + c0, b);
        if constexpr (V == 8) {
          load16<float>(gamma + c0 + 4, g + 4);
          load16<float>(beta + c0 + 4, b + 4);
        }
#pragma unroll
        for (int i = 0; i < V; ++i) out[i] = (z[v * V + i] - mu) * rstd * g[i] + b[i];
        store16<T>(y + off + c0, out);
      }
    }
  }
}

// Backward of the rows of this block; part (gridDim.x, 2, D) gets the
// block's sums of dy * zhat and of dy.
template <typename T, int kPerLane>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ h, const float* __restrict__ gamma,
              const T* __restrict__ dy, T* __restrict__ dx, T* __restrict__ dh,
              float* __restrict__ part, int N, int D, float eps, Mask mk) {
  constexpr int V = vec<T>();
  extern __shared__ float acc[];  // (2, D): the block's dgamma | dbeta
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float dg[kPerLane], db[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) dg[i] = db[i] = 0.f;

  for (int row = blockIdx.x * kWarps + warp; row < N; row += gridDim.x * kWarps) {
    const size_t off = static_cast<size_t>(row) * D;
    float z[kPerLane], gf[kPerLane], sum, sq;
    uint32_t keep;
    row_z<T, kPerLane>(x + off, h + off, D, lane, row, mk, z, keep, sum, sq);
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    const float mu = sum / static_cast<float>(D);
    const float var = sq / static_cast<float>(D) - mu * mu;
    const float rstd = rsqrtf(fmaxf(var, 0.f) + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int v = 0; v < kPerLane / V; ++v) {
      const int c0 = (v * 32 + lane) * V;
      if (c0 < D) {
        float g[V], d[V];
        load16<float>(gamma + c0, g);
        if constexpr (V == 8) load16<float>(gamma + c0 + 4, g + 4);
        load16<T>(dy + off + c0, d);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const int k = v * V + i;
          const float zhat = (z[k] - mu) * rstd;
          z[k] = zhat;
          dg[k] += d[i] * zhat;
          db[k] += d[i];
          gf[k] = d[i] * g[i];
          s1 += gf[k];
          s2 += gf[k] * zhat;
        }
      }
    }
    const float m1 = warp_sum(s1) / static_cast<float>(D);
    const float m2 = warp_sum(s2) / static_cast<float>(D);
#pragma unroll
    for (int v = 0; v < kPerLane / V; ++v) {
      const int c0 = (v * 32 + lane) * V;
      if (c0 < D) {
        float ox[V], oh[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const int k = v * V + i;
          const float dz = rstd * (gf[k] - m1 - z[k] * m2);
          ox[i] = dz;
          oh[i] = mk.on ? (((keep >> k) & 1u) ? dz / mk.keep_div : 0.f) : dz;
        }
        store16<T>(dx + off + c0, ox);
        store16<T>(dh + off + c0, oh);
      }
    }
  }

  // the warps' sums, added in warp order
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int v = 0; v < kPerLane / V; ++v) {
        const int c0 = (v * 32 + lane) * V;
        if (c0 < D) {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const int k = v * V + i;
            if (w == 0) {
              acc[c0 + i] = dg[k];
              acc[D + c0 + i] = db[k];
            } else {
              acc[c0 + i] += dg[k];
              acc[D + c0 + i] += db[k];
            }
          }
        }
      }
    }
    __syncthreads();
  }
  float* out = part + static_cast<size_t>(blockIdx.x) * 2 * D;
  for (int c = threadIdx.x; c < 2 * D; c += kThreads) out[c] = acc[c];
}

// dgamma | dbeta (2, D) = the blocks' partials added in block order.
__global__ void ln_reduce_kernel(const float* __restrict__ part, int n_blocks, int two_d,
                                 float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= two_d) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += part[static_cast<size_t>(b) * two_d + c];
  out[c] = s;
}

__global__ void keep_mask_kernel(uint8_t* out, int rows, int cols, uint32_t threshold,
                                 uint32_t seed, uint32_t salt) {
  const uint32_t base = mask_base(seed, salt);
  const size_t n = static_cast<size_t>(rows) * cols;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x)
    out[i] = mask_keep(base, static_cast<uint32_t>(i), threshold) ? 1 : 0;
}

int grid_blocks(int N) {
  const int want = (N + kWarps - 1) / kWarps;
  return want < kMaxBlocks ? want : kMaxBlocks;
}

template <typename T, int kPerLane>
int launch_fwd(const void* x, const void* h, const float* gamma, const float* beta, void* y,
               int N, int D, float eps, Mask mk, cudaStream_t s) {
  ln_fwd_kernel<T, kPerLane><<<grid_blocks(N), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(h), gamma, beta, static_cast<T*>(y), N, D,
      eps, mk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kPerLane>
int launch_bwd(const void* x, const void* h, const float* gamma, const void* dy, void* dx,
               void* dh, float* dgb, float* part, int N, int D, float eps, Mask mk,
               cudaStream_t s) {
  const int blocks = grid_blocks(N);
  ln_bwd_kernel<T, kPerLane><<<blocks, kThreads, sizeof(float) * 2 * D, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(h), gamma, static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<T*>(dh), part, N, D, eps, mk);
  ln_reduce_kernel<<<(2 * D + 255) / 256, 256, 0, s>>>(part, blocks, 2 * D, dgb);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int is_bf16, int N, int D, int mask_rows) {
  const int V = is_bf16 ? 8 : 4;
  return N >= 1 && D >= V && D % V == 0 && D <= 1024 && mask_rows >= 1;
}

}  // namespace

extern "C" {

// Blocks the backward runs for N rows: part must hold this many (2, D) floats.
int tts_fused_ln_bwd_blocks(int N) { return grid_blocks(N); }

// x, h, y: (N, D) T, contiguous; gamma, beta: (D) fp32.  T is bf16 when
// is_bf16, else fp32.  D must be a multiple of 16 bytes of T and <= 1024.
// With dropout_on, keep_div = 1 - p and threshold = uint32(p * 2^32).
int tts_fused_ln_fwd(int is_bf16, int N, int D, const void* x, const void* h, const void* gamma,
                     const void* beta, void* y, float eps, int dropout_on, float keep_div,
                     unsigned threshold, unsigned seed, int mask_rows, void* stream) {
  if (!shape_ok(is_bf16, N, D, mask_rows)) return static_cast<int>(cudaErrorInvalidValue);
  const Mask mk{seed, threshold, mask_rows, keep_div, dropout_on};
  auto s = static_cast<cudaStream_t>(stream);
  auto g = static_cast<const float*>(gamma);
  auto b = static_cast<const float*>(beta);
#define TTS_LN_FWD(T)                                                           \
  (D <= 256   ? launch_fwd<T, 8>(x, h, g, b, y, N, D, eps, mk, s)               \
   : D <= 512 ? launch_fwd<T, 16>(x, h, g, b, y, N, D, eps, mk, s)              \
              : launch_fwd<T, 32>(x, h, g, b, y, N, D, eps, mk, s))
  return is_bf16 ? TTS_LN_FWD(bf16) : TTS_LN_FWD(float);
#undef TTS_LN_FWD
}

// dy, dx, dh: (N, D) T; dgb: (2, D) fp32, dgamma then dbeta; part: scratch
// of tts_fused_ln_bwd_blocks(N) * 2 * D floats.
int tts_fused_ln_bwd(int is_bf16, int N, int D, const void* x, const void* h, const void* gamma,
                     const void* dy, void* dx, void* dh, void* dgb, void* part, float eps,
                     int dropout_on, float keep_div, unsigned threshold, unsigned seed,
                     int mask_rows, void* stream) {
  if (!shape_ok(is_bf16, N, D, mask_rows)) return static_cast<int>(cudaErrorInvalidValue);
  const Mask mk{seed, threshold, mask_rows, keep_div, dropout_on};
  auto s = static_cast<cudaStream_t>(stream);
  auto g = static_cast<const float*>(gamma);
  auto o = static_cast<float*>(dgb);
  auto pt = static_cast<float*>(part);
#define TTS_LN_BWD(T)                                                              \
  (D <= 256   ? launch_bwd<T, 8>(x, h, g, dy, dx, dh, o, pt, N, D, eps, mk, s)     \
   : D <= 512 ? launch_bwd<T, 16>(x, h, g, dy, dx, dh, o, pt, N, D, eps, mk, s)    \
              : launch_bwd<T, 32>(x, h, g, dy, dx, dh, o, pt, N, D, eps, mk, s))
  return is_bf16 ? TTS_LN_BWD(bf16) : TTS_LN_BWD(float);
#undef TTS_LN_BWD
}

// out (rows, cols) uint8: the keep bits of one mask block, for tests.
int tts_keep_mask(int rows, int cols, unsigned threshold, unsigned seed, unsigned salt, void* out,
                  void* stream) {
  if (rows < 1 || cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  keep_mask_kernel<<<256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(out), rows, cols, threshold, seed, salt);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
