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
// every element is read once.  Forward: rows beyond the grid are taken in
// strides.
//
// Backward, one launch.  The caller sizes the grid to the card (about two
// blocks per SM); each block takes a contiguous run of rows, and each warp
// keeps two rows in flight (at D <= 256), their loads issued before the
// first reduction.  dgamma / dbeta are sums over all rows.  The TPU grid ran
// in order and carried them in scratch; blocks here run in no order, so
// each block writes the partial sums of its rows (its warps added in warp
// order after one barrier), the last block of every group of 16 to finish
// adds the group's partials in block order, and the last group to finish
// adds the groups' sums in group order.  "Last" is a ticket counter taken
// with acquire-release ordering after a fence; the last taker sets it back
// to 0, so no call clears it.  No atomic float add: the order of every sum
// is fixed by N and the block count, and two runs give the same bits.
//
// The dropout mask is a function of the logical index (dropout_mask.cuh):
// element (row, col) takes salt = g / mask_rows and counter =
// (g % mask_rows) * D + col, where mask_rows is the row-block height the
// TPU kernel would pick (passed in; it shapes nothing but the mask) and g
// the global row (row / t_local) * t_total + row % t_local + row_off: a call
// that holds some batch rows and a time slice of each (data and sequence
// parallelism) drops what the whole call drops; (N, N, 0) gives g = row.
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
constexpr int kGroup = 16;             // backward blocks whose partials the last of them adds

struct Mask {
  uint32_t seed, threshold;
  int rows;        // height of a mask block
  float keep_div;  // 1 - p
  int on;
  float inv_keep;  // 1 / (1 - p), rounded to nearest on the host
  int t_local, t_total, row_off;  // the global row map
};

// The global row of local row `row` that the dropout mask is keyed on.  A
// call that holds whole time rows (one device, or a data shard: t_local ==
// t_total) runs the instantiation without the division (kMap false).
template <bool kMap>
__device__ __forceinline__ int mask_row(const Mask& mk, int row) {
  if constexpr (kMap) return (row / mk.t_local) * mk.t_total + row % mk.t_local + mk.row_off;
  return row + mk.row_off;
}

// z = x + Dropout(h) of one row into registers (kPerLane values per lane:
// vector v of the lane starts at column (v * 32 + lane) * vec<T>()), the
// keep bits of those values, and the lane's share of sum z and sum z^2.
template <typename T, int kPerLane, bool kMap>
__device__ __forceinline__ void row_z(const T* x, const T* h, int D, int lane, int row,
                                      const Mask& mk, float* z, uint32_t& keep, float& sum,
                                      float& sq) {
  constexpr int V = vec<T>();
  const int grow = mask_row<kMap>(mk, row);
  const uint32_t base = mk.on ? mask_base(mk.seed, static_cast<uint32_t>(grow / mk.rows)) : 0u;
  const uint32_t row0 = static_cast<uint32_t>(grow % mk.rows) * static_cast<uint32_t>(D);
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

template <typename T, int kPerLane, bool kMap>
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
    row_z<T, kPerLane, kMap>(x + off, h + off, D, lane, row, mk, z, keep, sum, sq);
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

// dst[0 .. 2D) = sum over k < n of src[k * 2D + c], added in k order; the
// threads take 4 columns each and keep 8 loads in flight.  src was written
// by other blocks of this launch, so it is read past L1.
__device__ __forceinline__ void sum_partials(const float* src, int n, int two_d, float* dst) {
  constexpr int kBatch = 8;
  for (int c = threadIdx.x * 4; c < two_d; c += kThreads * 4) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = 0; k0 < n; k0 += kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (k0 + k < n)
          v[k] = __ldcg(reinterpret_cast<const float4*>(src + static_cast<size_t>(k0 + k) * two_d + c));
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (k0 + k < n) add4(s, v[k]);
    }
    *reinterpret_cast<float4*>(dst + c) = s;
  }
}

// Ticket of this block at *counter, taken by thread 0 after the block's
// writes are visible device-wide; true in every thread of the block that
// takes the last of `n` tickets, which then reads what the others wrote
// and sets the counter back to 0 for the next launch.
__device__ __forceinline__ bool last_of(unsigned* counter, int n, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned t;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n"
                 : "=r"(t)
                 : "l"(counter)
                 : "memory");
    const bool last = t == static_cast<unsigned>(n - 1);
    if (last) *counter = 0u;
    *flag = last;
  }
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// One launch: dx, dh of the rows of this block and dgamma | dbeta of all
// rows.  Block b takes the contiguous run of rows [b rpb, (b + 1) rpb);
// warp w of it rows w, w + 8, ... of the run, kR rows at a time with every
// load of the kR rows issued before the first reduction.  The warps' sums of
// dy * zhat and dy go through shared memory (one barrier) into the block's
// partial part[b]; the last block of each group of kGroup blocks adds its
// group's partials in block order into group[g], and the last group to
// finish adds the groups' sums in group order into dgb.  Which block is last
// is decided by ticket counters (counters[0] for the groups, counters[1 + g]
// inside group g) that the last taker sets back to 0.  The order of every
// sum is fixed by N and the block count alone: the same bits on every run.
template <typename T, int kPerLane, int kR, bool kMap>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ h, const float* __restrict__ gamma,
              const T* __restrict__ dy, T* __restrict__ dx, T* __restrict__ dh,
              float* __restrict__ part, float* __restrict__ group, float* __restrict__ dgb,
              unsigned* __restrict__ counters, int N, int D, float eps, Mask mk) {
  constexpr int V = vec<T>();
  extern __shared__ __align__(16) float red[];  // (kWarps, 2, D): the warps' dgamma | dbeta
  __shared__ int flag;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rpb = (N + gridDim.x - 1) / gridDim.x;
  const int r0 = blockIdx.x * rpb, r1 = min(N, r0 + rpb);
  const float invD = 1.0f / static_cast<float>(D);

  // gamma stays in registers where they suffice (D <= 512), else is read per row
  constexpr bool kKeepGamma = kPerLane <= 16;
  float g[kKeepGamma ? kPerLane : 1], dg[kPerLane], db[kPerLane];
  auto load_gamma = [&](int v, float* out) {
    const int c0 = (v * 32 + lane) * V;
    load16<float>(gamma + c0, out);
    if constexpr (V == 8) load16<float>(gamma + c0 + 4, out + 4);
  };
#pragma unroll
  for (int v = 0; v < kPerLane / V; ++v) {
#pragma unroll
    for (int i = 0; i < V; ++i) dg[v * V + i] = db[v * V + i] = 0.f;
    if constexpr (kKeepGamma) {
      if ((v * 32 + lane) * V < D) load_gamma(v, g + v * V);
    }
  }

  for (int first = r0 + warp; first < r1; first += kWarps * kR) {
    float xv[kR][kPerLane], hv[kR][kPerLane], dv[kR][kPerLane];
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
      const int row = first + rr * kWarps;
      const size_t off = static_cast<size_t>(row < r1 ? row : first) * D;
#pragma unroll
      for (int v = 0; v < kPerLane / V; ++v) {
        const int c0 = (v * 32 + lane) * V;
        if (c0 < D) {
          load16<T>(x + off + c0, xv[rr] + v * V);
          load16<T>(h + off + c0, hv[rr] + v * V);
          load16<T>(dy + off + c0, dv[rr] + v * V);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) xv[rr][v * V + i] = hv[rr][v * V + i] = dv[rr][v * V + i] = 0.f;
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
      const int row = first + rr * kWarps;  // the same in every lane of the warp
      if (row >= r1) continue;
      const size_t off = static_cast<size_t>(row) * D;
      const int grow = mask_row<kMap>(mk, row);
      const uint32_t base =
          mk.on ? mask_base(mk.seed, static_cast<uint32_t>(grow / mk.rows)) : 0u;
      const uint32_t cnt0 = static_cast<uint32_t>(grow % mk.rows) * static_cast<uint32_t>(D);
      float z[kPerLane], sum = 0.f, sq = 0.f;
      uint32_t keep = 0xffffffffu;
      if (mk.on) div_rn(hv[rr], mk.keep_div, mk.inv_keep);  // h / (1 - p), dropped or not
#pragma unroll
      for (int v = 0; v < kPerLane / V; ++v) {
        const int c0 = (v * 32 + lane) * V;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const int k = v * V + i;
          z[k] = 0.f;
          if (c0 < D) {
            float hd = hv[rr][k];
            if (mk.on && !mask_keep(base, cnt0 + static_cast<uint32_t>(c0 + i), mk.threshold)) {
              hd = 0.f;
              keep &= ~(1u << k);
            }
            z[k] = xv[rr][k] + hd;
            sum += z[k];
            sq += z[k] * z[k];
          }
        }
      }
      sum = warp_sum(sum);
      sq = warp_sum(sq);
      const float mu = sum * invD;
      const float rstd = rsqrtf(fmaxf(sq * invD - mu * mu, 0.f) + eps);
      float s1 = 0.f, s2 = 0.f, gf[kPerLane];
#pragma unroll
      for (int v = 0; v < kPerLane / V; ++v) {
        const int c0 = (v * 32 + lane) * V;
        float gv[V];
        if constexpr (!kKeepGamma) {
          if (c0 < D) load_gamma(v, gv);
        }
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const int k = v * V + i;
          gf[k] = 0.f;
          if (c0 < D) {
            const float zhat = (z[k] - mu) * rstd;
            z[k] = zhat;
            dg[k] += dv[rr][k] * zhat;
            db[k] += dv[rr][k];
            float gk;
            if constexpr (kKeepGamma) {
              gk = g[k];
            } else {
              gk = gv[i];
            }
            gf[k] = dv[rr][k] * gk;
            s1 += gf[k];
            s2 += gf[k] * zhat;
          }
        }
      }
      const float m1 = warp_sum(s1) * invD;
      const float m2 = warp_sum(s2) * invD;
      float dz[kPerLane], dzk[kPerLane];  // dx, and dx / (1 - p)
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) dz[k] = dzk[k] = rstd * (gf[k] - m1 - z[k] * m2);
      if (mk.on) div_rn(dzk, mk.keep_div, mk.inv_keep);
#pragma unroll
      for (int v = 0; v < kPerLane / V; ++v) {
        const int c0 = (v * 32 + lane) * V;
        if (c0 < D) {
          float oh[V];
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const int k = v * V + i;
            oh[i] = mk.on && !((keep >> k) & 1u) ? 0.f : dzk[k];
          }
          store16<T>(dx + off + c0, dz + v * V);
          store16<T>(dh + off + c0, oh);
        }
      }
    }
  }

  // the warps' sums side by side, then added in warp order: one barrier
#pragma unroll
  for (int v = 0; v < kPerLane / V; ++v) {
    const int c0 = (v * 32 + lane) * V;
    if (c0 < D) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        red[warp * 2 * D + c0 + i] = dg[v * V + i];
        red[warp * 2 * D + D + c0 + i] = db[v * V + i];
      }
    }
  }
  __syncthreads();
  const int two_d = 2 * D;
  for (int c = threadIdx.x; c < two_d; c += kThreads) {
    float s = red[c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w * two_d + c];
    part[static_cast<size_t>(blockIdx.x) * two_d + c] = s;
  }

  const int grp = blockIdx.x / kGroup, n_groups = (gridDim.x + kGroup - 1) / kGroup;
  const int in_group = min(kGroup, static_cast<int>(gridDim.x) - grp * kGroup);
  if (!last_of(counters + 1 + grp, in_group, &flag)) return;
  sum_partials(part + static_cast<size_t>(grp) * kGroup * two_d, in_group, two_d,
               group + static_cast<size_t>(grp) * two_d);
  if (!last_of(counters, n_groups, &flag)) return;
  sum_partials(group, n_groups, two_d, dgb);
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
  auto kernel = mk.t_local == mk.t_total ? ln_fwd_kernel<T, kPerLane, false>
                                         : ln_fwd_kernel<T, kPerLane, true>;
  kernel<<<grid_blocks(N), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(h), gamma, beta, static_cast<T*>(y), N, D,
      eps, mk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kPerLane>
int launch_bwd(const void* x, const void* h, const float* gamma, const void* dy, void* dx,
               void* dh, float* dgb, float* part, unsigned* counters, int blocks, int N, int D,
               float eps, Mask mk, cudaStream_t s) {
  constexpr int kR = kPerLane <= 8 ? 2 : 1;  // rows in flight per warp
  auto kernel = mk.t_local == mk.t_total ? ln_bwd_kernel<T, kPerLane, kR, false>
                                         : ln_bwd_kernel<T, kPerLane, kR, true>;
  const size_t smem = sizeof(float) * kWarps * 2 * D;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  float* group = part + static_cast<size_t>(blocks) * 2 * D;
  kernel<<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(h), gamma, static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<T*>(dh), part, group, dgb, counters, N, D, eps, mk);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int is_bf16, int N, int D, int mask_rows, int t_local, int t_total, int row_off) {
  const int V = is_bf16 ? 8 : 4;
  return N >= 1 && D >= V && D % V == 0 && D <= 1024 && mask_rows >= 1 && t_local >= 1 &&
         t_total >= t_local && row_off >= 0;
}

}  // namespace

extern "C" {

// x, h, y: (N, D) T, contiguous; gamma, beta: (D) fp32.  T is bf16 when
// is_bf16, else fp32.  D must be a multiple of 16 bytes of T and <= 1024.
// With dropout_on, keep_div = 1 - p and threshold = uint32(p * 2^32).
// t_local, t_total, row_off: the global row map of the mask (N, N, 0 for
// the whole call).
int tts_fused_ln_fwd(int is_bf16, int N, int D, const void* x, const void* h, const void* gamma,
                     const void* beta, void* y, float eps, int dropout_on, float keep_div,
                     unsigned threshold, unsigned seed, int mask_rows, int t_local, int t_total,
                     int row_off, void* stream) {
  if (!shape_ok(is_bf16, N, D, mask_rows, t_local, t_total, row_off))
    return static_cast<int>(cudaErrorInvalidValue);
  const Mask mk{seed, threshold, mask_rows, keep_div, dropout_on, 1.0f / keep_div,
                t_local, t_total, row_off};
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

// Dynamic shared memory of a backward block for width D, bytes.
long long tts_fused_ln_bwd_shared_bytes(int D) {
  return static_cast<long long>(sizeof(float)) * kWarps * 2 * D;
}

// dy, dx, dh: (N, D) T; dgb: (2, D) fp32, dgamma then dbeta.  blocks:
// 1 .. min(N, kMaxBlocks) blocks of rows; part: scratch of (blocks +
// ceil(blocks / kGroup)) * 2 * D floats; counters: 1 + ceil(blocks /
// kGroup) zeros, which every launch leaves at zero (one set per stream: two
// launches in flight at once must not share it).  t_local, t_total,
// row_off: as for the forward.
int tts_fused_ln_bwd(int is_bf16, int N, int D, const void* x, const void* h, const void* gamma,
                     const void* dy, void* dx, void* dh, void* dgb, void* part, void* counters,
                     int blocks, float eps, int dropout_on, float keep_div, unsigned threshold,
                     unsigned seed, int mask_rows, int t_local, int t_total, int row_off,
                     void* stream) {
  if (!shape_ok(is_bf16, N, D, mask_rows, t_local, t_total, row_off) || blocks < 1 ||
      blocks > N || blocks > kMaxBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  const Mask mk{seed, threshold, mask_rows, keep_div, dropout_on, 1.0f / keep_div,
                t_local, t_total, row_off};
  auto s = static_cast<cudaStream_t>(stream);
  auto g = static_cast<const float*>(gamma);
  auto o = static_cast<float*>(dgb);
  auto pt = static_cast<float*>(part);
  auto ct = static_cast<unsigned*>(counters);
#define TTS_LN_BWD(T)                                                                      \
  (D <= 256   ? launch_bwd<T, 8>(x, h, g, dy, dx, dh, o, pt, ct, blocks, N, D, eps, mk, s)   \
   : D <= 512 ? launch_bwd<T, 16>(x, h, g, dy, dx, dh, o, pt, ct, blocks, N, D, eps, mk, s)  \
              : launch_bwd<T, 32>(x, h, g, dy, dx, dh, o, pt, ct, blocks, N, D, eps, mk, s))
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
