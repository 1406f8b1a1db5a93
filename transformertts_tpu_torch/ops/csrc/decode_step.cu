// One whole Transformer-TTS decoder step for Hopper (sm_90a), B = 1..8.
//
// Replaces the TPU kernels transformertts_tpu/ops/pallas/decode_step.py:
// decode_step (_kernel, batch 1) and decode_step_batched (_kernel_batched).
// The plain PyTorch version of the same function, op for op, is
// decode_step_reference in ../decode_step.py; the numerics follow _kernel:
// T (bf16 or fp32) operands, fp32 accumulation, q scaled in fp32 then cast,
// fp32 softmax and LayerNorm (E[x^2] - mu^2 clamped at 0, eps 1e-5), x cast
// to T after every sublayer while the residual stays fp32.
//
// Bound: bytes.  A step reads every decoder weight once (5.7 MB in bf16 at
// d_model 256, 3 layers, d_ffn 1024) plus each row's cache prefix.  The
// weights do not fit one SM's shared memory, so the step is a chain of
// kernels launched from one C entry point (tts_decode_step):
//
//   gemv   prenet 1 (+ReLU)        gemv   prenet 2 (+ReLU, +alpha*PE[t])
//   per layer:
//     gemv   q|k|v  (LN3 of the previous layer in its prologue; writes the
//                    new K/V rows into the cache at t, in place)
//     self_attn      one block per (head, row), over cache positions < t
//                    plus the current position in closed form
//     gemv   self out-projection
//     gemv   cross q (LN1 in its prologue)
//     cross_attn     one block per (head, row), additive (B, Tp) key bias
//     gemv   cross out-projection
//     gemv   FFN 1 (+ReLU; LN2 in its prologue)
//     gemv   FFN 2
//   gemv   fused mel|stop head (LN3 in its prologue; head-mean position)
//
// A gemv takes its weight as (N, K) row-major (torch's Linear layout) and
// gives each output column one warp: the lanes read the column's weight
// row in 16-byte vectors, neighbouring lanes on neighbouring bytes, so a
// warp load moves 512 contiguous bytes and every block keeps 8 of them in
// flight; the B input rows wait in shared memory.  The attention kernels
// read the caches the same way: a group of dh*sizeof(T)/16 threads covers
// one cache row with 16-byte loads.  LayerNorm needs a whole row, so the
// GEMV that consumes its output recomputes it in every block (B x D
// values, cheap next to the weights); block 0 also stores it as the next
// residual.
//
// Every function returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;                // threads of a gemv block
constexpr int kWarps = kThreads / 32;        // output columns per gemv block
constexpr int kAttnThreads = 128;            // threads of an attention block
constexpr int kMaxBatch = 8;

using bf16 = __nv_bfloat16;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// value rounded to T (round to nearest even), kept as float
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f<T>(from_f<T>(v));
}

// elements of T in one 16-byte vector
template <typename T> __host__ __device__ constexpr int vec() { return 16 / static_cast<int>(sizeof(T)); }

// 16 bytes at p (16-byte aligned) as vec<T>() floats
template <typename T> __device__ __forceinline__ void load16(const T* p, float* out);
template <> __device__ __forceinline__ void load16<float>(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
template <> __device__ __forceinline__ void load16<bf16>(const bf16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum (or max) over the block; every thread gets the result.  `red` holds
// 32 floats of shared memory.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();  // `red` may still be read from a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < n_warps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

enum InMode { kInPlain = 0, kInLayerNorm = 1 };
enum Epilogue { kEpiF32 = 0, kEpiRelu = 1, kEpiReluPe = 2, kEpiQkv = 3, kEpiScale = 4 };

template <typename T>
struct GemvArgs {
  int K, N;
  const T* W;     // (N, K) row-major
  const T* bias;  // (N)
  // input, kInPlain: (B, K) fp32, rounded to T on load
  const float* x;
  // input, kInLayerNorm: x = T(LN(resid + o)) over K, fp32 statistics
  const float* resid;
  const float* o;
  const float* ln_g;
  const float* ln_b;
  float* resid_out;  // block 0 stores the LN output here (null: not kept)
  int round_resid;   // store T(LN) instead of the fp32 LN
  // outputs
  float* out;        // (B, N) fp32; q (B, D) for kEpiQkv; x (B, D) for kEpiReluPe
  float* kv_out;     // kEpiQkv: k|v rows (B, 2D) fp32
  const float* pe;   // kEpiReluPe: alpha * PE[t] (N)
  float scale;       // kEpiScale and the q part of kEpiQkv
  // kEpiQkv: the layer's caches (H, B, n_pos, dh) and new rows (H, B, dh)
  T* k_cache;
  T* v_cache;
  T* k_new;
  T* v_new;
  int H, dh, n_pos, t;
  // head: head-mean of the last cross-attention's expected positions
  const float* pos_parts;  // (B, H)
  float* pos;              // (B)
};

template <typename T, int B, int kEpi>
__device__ __forceinline__ void gemv_store(const GemvArgs<T>& p, int b, int n, float v) {
  if (kEpi == kEpiF32) {
    p.out[b * p.N + n] = v;
  } else if (kEpi == kEpiRelu) {
    p.out[b * p.N + n] = fmaxf(v, 0.f);
  } else if (kEpi == kEpiReluPe) {
    p.out[b * p.N + n] = round_t<T>(fmaxf(v, 0.f) + p.pe[n]);
  } else if (kEpi == kEpiScale) {
    p.out[b * p.N + n] = v * p.scale;
  } else {  // kEpiQkv: N = 3D, columns q | k | v
    const int D = p.N / 3;
    if (n < D) {
      p.out[b * D + n] = v * p.scale;
    } else {
      const int m = n - D;
      p.kv_out[b * 2 * D + m] = v;
      const int which = m / D, h = (m % D) / p.dh, j = m % p.dh;
      const T tv = from_f<T>(v);
      T* cache = which ? p.v_cache : p.k_cache;
      T* row = which ? p.v_new : p.k_new;
      cache[((static_cast<size_t>(h) * B + b) * p.n_pos + p.t) * p.dh + j] = tv;
      row[(static_cast<size_t>(h) * B + b) * p.dh + j] = tv;
    }
  }
}

template <typename T, int B, int kIn, int kEpi>
__global__ void __launch_bounds__(kThreads) gemv_kernel(GemvArgs<T> p) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;  // (B, K) inputs, rounded to T
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = p.K;

  if (kIn == kInPlain) {
    for (int i = tid; i < B * K; i += kThreads) xs[i] = round_t<T>(p.x[i]);
  } else {
    for (int b = warp; b < B; b += kWarps) {  // one warp per row
      float s = 0.f, s2 = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float v = p.resid[b * K + k] + p.o[b * K + k];
        xs[b * K + k] = v;
        s += v;
        s2 += v * v;
      }
      s = warp_sum(s);
      s2 = warp_sum(s2);
      const float mu = s / K;
      const float var = fmaxf(s2 / K - mu * mu, 0.f);
      const float rs = rsqrtf(var + 1e-5f);
      for (int k = lane; k < K; k += 32) {
        const float x32 = (xs[b * K + k] - mu) * rs * p.ln_g[k] + p.ln_b[k];
        const float xt = round_t<T>(x32);
        xs[b * K + k] = xt;
        if (blockIdx.x == 0 && p.resid_out != nullptr)
          p.resid_out[b * K + k] = p.round_resid ? xt : x32;
      }
    }
  }
  __syncthreads();

  constexpr int V = vec<T>();
  const int n = blockIdx.x * kWarps + warp;  // this warp's output column
  if (n < p.N) {
    const T* wr = p.W + static_cast<size_t>(n) * K;
    float acc[B];
#pragma unroll
    for (int b = 0; b < B; ++b) acc[b] = 0.f;
#pragma unroll 2
    for (int k0 = lane * V; k0 < K; k0 += 32 * V) {
      float w[V];
      load16<T>(wr + k0, w);
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const float4* xb = reinterpret_cast<const float4*>(xs + b * K + k0);
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < V / 4; ++i) {
          const float4 x4 = xb[i];
          s += x4.x * w[4 * i] + x4.y * w[4 * i + 1] + x4.z * w[4 * i + 2] + x4.w * w[4 * i + 3];
        }
        acc[b] += s;
      }
    }
    float mine = 0.f;  // lane b keeps row b's sum
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const float v = warp_sum(acc[b]);
      if (lane == b) mine = v;
    }
    if (lane < B) gemv_store<T, B, kEpi>(p, lane, n, mine + to_f<T>(p.bias[n]));
  }

  if (p.pos != nullptr && blockIdx.x == 0 && tid < B) {
    float s = 0.f;
    for (int h = 0; h < p.H; ++h) s += p.pos_parts[tid * p.H + h];
    p.pos[tid] = s / p.H;
  }
}

// Scores of q (dh floats in shared memory, rounded to T) against cache rows
// [0, n) of one (head, row) segment into s[0, n), each plus bias[p] when
// bias is given.  A group of G = dh / vec<T>() threads reads one row with
// 16-byte loads; the block covers kAttnThreads / G rows per pass.
template <typename T>
__device__ void attn_scores(const float* qs, const T* kc, const float* bias, float* s,
                            int n, int dh) {
  constexpr int V = vec<T>();
  const int G = dh / V, P = kAttnThreads / G;
  const int g = threadIdx.x % G, pi = threadIdx.x / G;
  float qv[V];
#pragma unroll
  for (int v = 0; v < V; ++v) qv[v] = qs[g * V + v];
  for (int p0 = 0; p0 < n; p0 += P) {  // same trip count in every thread
    const int pp = p0 + pi;
    float a = 0.f;
    if (pp < n) {
      float kv[V];
      load16<T>(kc + static_cast<size_t>(pp) * dh + g * V, kv);
#pragma unroll
      for (int v = 0; v < V; ++v) a += qv[v] * kv[v];
    }
    for (int o = G / 2; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
    if (g == 0 && pp < n) s[pp] = bias != nullptr ? a + bias[pp] : a;
  }
}

// sum_p round_T(e[p]) * vc[p, :] over p in [0, n) into out[0, dh) (shared
// memory), with part (kAttnThreads * 8 floats) as scratch.
template <typename T>
__device__ void attn_values(const float* e, const T* vc, float* part, float* out,
                            int n, int dh) {
  constexpr int V = vec<T>();
  const int G = dh / V, P = kAttnThreads / G;
  const int g = threadIdx.x % G, pi = threadIdx.x / G;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  for (int pp = pi; pp < n; pp += P) {
    float vv[V];
    load16<T>(vc + static_cast<size_t>(pp) * dh + g * V, vv);
    const float ep = round_t<T>(e[pp]);
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] += ep * vv[v];
  }
#pragma unroll
  for (int v = 0; v < V; ++v) part[pi * dh + g * V + v] = acc[v];
  __syncthreads();
  for (int j = threadIdx.x; j < dh; j += kAttnThreads) {
    float c = 0.f;
    for (int k = 0; k < P; ++k) c += part[k * dh + j];
    out[j] = c;
  }
  __syncthreads();
}

// Self-attention of row b, head h over cache positions [0, t) plus the
// current position, whose score and value come in fp32 (closed form, as
// _kernel folds it).  Grid (H, B).
template <typename T>
__global__ void __launch_bounds__(kAttnThreads) self_attn_kernel(
    const float* __restrict__ q, const float* __restrict__ kv,
    const T* __restrict__ k_cache, const T* __restrict__ v_cache,
    float* __restrict__ ctx, int B, int H, int dh, int n_pos, int t) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[32];
  float* qs = sm;                        // (dh) q rounded to T, then the context sum
  float* part = qs + dh;                 // (kAttnThreads * 8) partial context sums
  float* s = part + kAttnThreads * 8;    // (t) scores, then probabilities
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int D = H * dh;
  const float* qf = q + b * D + h * dh;
  const float* kn = kv + b * 2 * D + h * dh;
  const float* vn = kv + b * 2 * D + D + h * dh;
  const size_t seg = (static_cast<size_t>(h) * B + b) * n_pos * dh;

  float sc = 0.f;
  for (int j = tid; j < dh; j += kAttnThreads) {
    qs[j] = round_t<T>(qf[j]);
    sc += qf[j] * kn[j];
  }
  const float s_cur = block_reduce<false>(sc, red);  // syncs: qs is ready
  attn_scores<T>(qs, k_cache + seg, nullptr, s, t, dh);
  __syncthreads();

  float m = s_cur;
  for (int pp = tid; pp < t; pp += kAttnThreads) m = fmaxf(m, s[pp]);
  m = block_reduce<true>(m, red);
  float den = 0.f;
  for (int pp = tid; pp < t; pp += kAttnThreads) {
    const float e = expf(s[pp] - m);
    s[pp] = e;
    den += e;
  }
  const float e_cur = expf(s_cur - m);
  den = block_reduce<false>(den, red) + e_cur;  // syncs: s holds probabilities

  attn_values<T>(s, v_cache + seg, part, qs, t, dh);
  for (int j = tid; j < dh; j += kAttnThreads)
    ctx[b * D + h * dh + j] = (qs[j] + e_cur * vn[j]) / den;
}

// Cross-attention of row b, head h over its Tp encoder positions with the
// additive key bias of row b; optionally the expected position sum_p P(p)*p
// for the windowed decode.  Grid (H, B).
template <typename T>
__global__ void __launch_bounds__(kAttnThreads) cross_attn_kernel(
    const float* __restrict__ q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const float* __restrict__ bias,
    float* __restrict__ ctx, float* __restrict__ pos_parts,
    int B, int H, int dh, int tp) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[32];
  float* qs = sm;
  float* part = qs + dh;
  float* s = part + kAttnThreads * 8;  // (tp)
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int D = H * dh;
  const size_t seg = (static_cast<size_t>(h) * B + b) * tp * dh;

  for (int j = tid; j < dh; j += kAttnThreads) qs[j] = round_t<T>(q[b * D + h * dh + j]);
  __syncthreads();
  attn_scores<T>(qs, k_cache + seg, bias + static_cast<size_t>(b) * tp, s, tp, dh);
  __syncthreads();

  float m = -3.0e38f;
  for (int pp = tid; pp < tp; pp += kAttnThreads) m = fmaxf(m, s[pp]);
  m = block_reduce<true>(m, red);
  float den = 0.f;
  for (int pp = tid; pp < tp; pp += kAttnThreads) {
    const float e = expf(s[pp] - m);
    s[pp] = e;
    den += e;
  }
  den = block_reduce<false>(den, red);  // syncs: s holds probabilities

  if (pos_parts != nullptr) {
    float ps = 0.f;
    for (int pp = tid; pp < tp; pp += kAttnThreads) ps += (s[pp] / den) * static_cast<float>(pp);
    ps = block_reduce<false>(ps, red);
    if (tid == 0) pos_parts[b * H + h] = ps;
  }

  attn_values<T>(s, v_cache + seg, part, qs, tp, dh);
  for (int j = tid; j < dh; j += kAttnThreads) ctx[b * D + h * dh + j] = qs[j] / den;
}

size_t smem_limit(const void* fn, size_t bytes) {
  // above the default 48 KB a kernel must opt in to more dynamic shared memory
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  return bytes;
}

template <typename T, int B, int kIn, int kEpi>
void gemv(const GemvArgs<T>& a, cudaStream_t stream) {
  auto fn = gemv_kernel<T, B, kIn, kEpi>;
  const size_t smem = smem_limit(reinterpret_cast<const void*>(fn), sizeof(float) * B * a.K);
  fn<<<(a.N + kWarps - 1) / kWarps, kThreads, smem, stream>>>(a);
}

size_t scratch_floats(int B, int H, int dh, int F) {
  const size_t D = static_cast<size_t>(H) * dh;
  const size_t wide = D > static_cast<size_t>(F) ? D : static_cast<size_t>(F);
  return B * (8 * D + wide) + static_cast<size_t>(B) * H;
}

template <typename T, int B>
void run_step(int L, int H, int dh, int F, int n_mels, int d_out, int n_pos, int tp, int t,
              const float* frame, const float* pe_row, const float* cross_bias,
              T* self_k, T* self_v, const T* cross_k, const T* cross_v,
              const void* const* w, float* y, T* k_new, T* v_new, float* pos,
              float* scratch, cudaStream_t stream) {
  const int D = H * dh;
  // dh ** -0.5 rounded once to fp32, as the Python scalar is
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(dh)));
  const size_t BD = static_cast<size_t>(B) * D;
  // scratch: three residual buffers, sublayer output, q, k|v rows,
  // context, wide activations, per-head positions
  float* r1 = scratch;
  float* r2 = r1 + BD;
  float* r3 = r2 + BD;
  float* o = r3 + BD;
  float* q = o + BD;
  float* kv = q + BD;        // 2 * BD
  float* ctx = kv + 2 * BD;
  float* act = ctx + BD;     // B * max(D, F)
  float* pos_parts = act + static_cast<size_t>(B) * (D > F ? D : F);

  auto W = [&](int i) { return static_cast<const T*>(w[i]); };
  const float* ln_g = static_cast<const float*>(w[16]);
  const float* ln_b = static_cast<const float*>(w[17]);
  const size_t DD = static_cast<size_t>(D) * D;
  const size_t lsz = static_cast<size_t>(H) * B * n_pos * dh;   // self cache per layer
  const size_t csz = static_cast<size_t>(H) * B * tp * dh;      // cross cache per layer
  const size_t nsz = static_cast<size_t>(H) * B * dh;           // new rows per layer
  const size_t attn_self_smem = sizeof(float) * (dh + kAttnThreads * 8 + (t > 0 ? t : 1));
  const size_t attn_cross_smem = sizeof(float) * (dh + kAttnThreads * 8 + tp);
  smem_limit(reinterpret_cast<const void*>(self_attn_kernel<T>), attn_self_smem);
  smem_limit(reinterpret_cast<const void*>(cross_attn_kernel<T>), attn_cross_smem);
  const dim3 attn_grid(H, B);

  GemvArgs<T> a{};
  // prenet 1: frame (B, n_mels) -> act (B, D), ReLU
  a.K = n_mels; a.N = D; a.W = W(0); a.bias = W(1); a.x = frame; a.out = act;
  gemv<T, B, kInPlain, kEpiRelu>(a, stream);
  // prenet 2: act -> r1 = T(ReLU(.) + alpha * PE[t])
  a = GemvArgs<T>{};
  a.K = D; a.N = D; a.W = W(2); a.bias = W(3); a.x = act; a.out = r1; a.pe = pe_row;
  gemv<T, B, kInPlain, kEpiReluPe>(a, stream);

  for (int l = 0; l < L; ++l) {
    const float* g = ln_g + static_cast<size_t>(l) * 3 * D;
    const float* bb = ln_b + static_cast<size_t>(l) * 3 * D;
    // q|k|v; input r1 (layer 0) or T(LN3(r3 + o)) of the previous layer
    a = GemvArgs<T>{};
    a.K = D; a.N = 3 * D;
    a.W = W(4) + static_cast<size_t>(l) * 3 * DD; a.bias = W(5) + static_cast<size_t>(l) * 3 * D;
    a.out = q; a.kv_out = kv; a.scale = scale;
    a.k_cache = self_k + l * lsz; a.v_cache = self_v + l * lsz;
    a.k_new = k_new + l * nsz; a.v_new = v_new + l * nsz;
    a.H = H; a.dh = dh; a.n_pos = n_pos; a.t = t;
    if (l == 0) {
      a.x = r1;
      gemv<T, B, kInPlain, kEpiQkv>(a, stream);
    } else {
      a.resid = r3; a.o = o; a.resid_out = r1; a.round_resid = 1;
      a.ln_g = g - D; a.ln_b = bb - D;  // norm3 of layer l - 1
      gemv<T, B, kInLayerNorm, kEpiQkv>(a, stream);
    }
    self_attn_kernel<T><<<attn_grid, kAttnThreads, attn_self_smem, stream>>>(
        q, kv, self_k + l * lsz, self_v + l * lsz, ctx, B, H, dh, n_pos, t);
    // self out-projection -> o
    a = GemvArgs<T>{};
    a.K = D; a.N = D; a.W = W(6) + l * DD; a.bias = W(7) + static_cast<size_t>(l) * D;
    a.x = ctx; a.out = o;
    gemv<T, B, kInPlain, kEpiF32>(a, stream);
    // cross q; prologue LN1(r1 + o) -> r2 (fp32)
    a = GemvArgs<T>{};
    a.K = D; a.N = D; a.W = W(8) + l * DD; a.bias = W(9) + static_cast<size_t>(l) * D;
    a.resid = r1; a.o = o; a.ln_g = g; a.ln_b = bb; a.resid_out = r2;
    a.out = q; a.scale = scale;
    gemv<T, B, kInLayerNorm, kEpiScale>(a, stream);
    cross_attn_kernel<T><<<attn_grid, kAttnThreads, attn_cross_smem, stream>>>(
        q, cross_k + l * csz, cross_v + l * csz, cross_bias, ctx,
        (pos != nullptr && l == L - 1) ? pos_parts : nullptr, B, H, dh, tp);
    // cross out-projection -> o
    a = GemvArgs<T>{};
    a.K = D; a.N = D; a.W = W(10) + l * DD; a.bias = W(11) + static_cast<size_t>(l) * D;
    a.x = ctx; a.out = o;
    gemv<T, B, kInPlain, kEpiF32>(a, stream);
    // FFN 1; prologue LN2(r2 + o) -> r3 (fp32)
    a = GemvArgs<T>{};
    a.K = D; a.N = F; a.W = W(12) + static_cast<size_t>(l) * D * F;
    a.bias = W(13) + static_cast<size_t>(l) * F;
    a.resid = r2; a.o = o; a.ln_g = g + D; a.ln_b = bb + D; a.resid_out = r3;
    a.out = act;
    gemv<T, B, kInLayerNorm, kEpiRelu>(a, stream);
    // FFN 2 -> o
    a = GemvArgs<T>{};
    a.K = F; a.N = D; a.W = W(14) + static_cast<size_t>(l) * F * D;
    a.bias = W(15) + static_cast<size_t>(l) * D;
    a.x = act; a.out = o;
    gemv<T, B, kInPlain, kEpiF32>(a, stream);
  }

  // fused mel|stop head; prologue LN3(r3 + o) of the last layer
  const float* g = ln_g + static_cast<size_t>(L - 1) * 3 * D + 2 * D;
  const float* bb = ln_b + static_cast<size_t>(L - 1) * 3 * D + 2 * D;
  a = GemvArgs<T>{};
  a.K = D; a.N = d_out; a.W = W(18); a.bias = W(19);
  a.resid = r3; a.o = o; a.ln_g = g; a.ln_b = bb; a.out = y;
  a.H = H; a.pos_parts = pos_parts; a.pos = pos;
  gemv<T, B, kInLayerNorm, kEpiF32>(a, stream);
}

template <typename T>
int dispatch(int B, int L, int H, int dh, int F, int n_mels, int d_out, int n_pos, int tp, int t,
             const float* frame, const float* pe_row, const float* cross_bias,
             void* self_k, void* self_v, const void* cross_k, const void* cross_v,
             const void* const* w, float* y, void* k_new, void* v_new, float* pos,
             float* scratch, cudaStream_t stream) {
#define TTS_STEP_CASE(NB)                                                                  \
  case NB:                                                                                 \
    run_step<T, NB>(L, H, dh, F, n_mels, d_out, n_pos, tp, t, frame, pe_row, cross_bias,   \
                    static_cast<T*>(self_k), static_cast<T*>(self_v),                      \
                    static_cast<const T*>(cross_k), static_cast<const T*>(cross_v), w, y,  \
                    static_cast<T*>(k_new), static_cast<T*>(v_new), pos, scratch, stream); \
    break;
  switch (B) {
    TTS_STEP_CASE(1)
    TTS_STEP_CASE(2)
    TTS_STEP_CASE(3)
    TTS_STEP_CASE(4)
    TTS_STEP_CASE(5)
    TTS_STEP_CASE(6)
    TTS_STEP_CASE(7)
    TTS_STEP_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TTS_STEP_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Floats of device scratch one call of tts_decode_step needs.
long tts_decode_step_scratch_floats(int B, int H, int dh, int F) {
  return static_cast<long>(scratch_floats(B, H, dh, F));
}

// One decoder step.  Layouts: frame (B, n_mels) fp32; pe_row (D) fp32;
// cross_bias (B, tp) fp32; self_k/self_v (L, H, B, n_pos, dh) T, updated at
// position t in place; cross_k/cross_v (L, H, B, tp, dh) T; w: the 20
// packed weights in the order of _PACK_ORDER (ops/decode_step.py); y
// (B, d_out) fp32; k_new/v_new (L, H, B, dh) T; pos (B) fp32 or null;
// scratch of tts_decode_step_scratch_floats floats.  T is bf16 when
// is_bf16, else fp32.  Returns cudaGetLastError() after the launches.
int tts_decode_step(int is_bf16, int B, int L, int H, int dh, int F, int n_mels, int d_out,
                    int n_pos, int tp, int t,
                    const void* frame, const void* pe_row, const void* cross_bias,
                    void* self_k, void* self_v, const void* cross_k, const void* cross_v,
                    const void* w, void* y, void* k_new, void* v_new, void* pos,
                    void* scratch, void* stream) {
  if (B < 1 || B > kMaxBatch || dh > kAttnThreads || t < 0 || t >= n_pos)
    return static_cast<int>(cudaErrorInvalidValue);
  // Dynamic shared memory of the largest block: the GEMVs hold their (B, K)
  // inputs, the attention one score per key.  Checked against n_pos, not t,
  // so a decode that cannot reach its last position is refused at t = 0.
  {
    const size_t D = static_cast<size_t>(H) * dh;
    size_t widest = D > static_cast<size_t>(F) ? D : static_cast<size_t>(F);
    if (static_cast<size_t>(n_mels) > widest) widest = n_mels;
    const size_t keys = n_pos > tp ? n_pos : tp;
    const size_t gemv_bytes = sizeof(float) * B * widest;
    const size_t attn_bytes = sizeof(float) * (dh + kAttnThreads * 8 + keys);
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (gemv_bytes > static_cast<size_t>(optin) || attn_bytes > static_cast<size_t>(optin))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto ws = static_cast<const void* const*>(w);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (is_bf16)
    return dispatch<bf16>(B, L, H, dh, F, n_mels, d_out, n_pos, tp, t, f(frame), f(pe_row),
                          f(cross_bias), self_k, self_v, cross_k, cross_v, ws,
                          static_cast<float*>(y), k_new, v_new, static_cast<float*>(pos),
                          static_cast<float*>(scratch), s);
  return dispatch<float>(B, L, H, dh, F, n_mels, d_out, n_pos, tp, t, f(frame), f(pe_row),
                         f(cross_bias), self_k, self_v, cross_k, cross_v, ws,
                         static_cast<float*>(y), k_new, v_new, static_cast<float*>(pos),
                         static_cast<float*>(scratch), s);
}

}  // extern "C"
