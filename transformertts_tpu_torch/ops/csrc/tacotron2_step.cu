// One decoder step of Tacotron 2 (Shen et al., arXiv:1712.05884; NVIDIA's
// recipe) for Hopper: one persistent launch a step.
//
// Replaces no TPU kernel (the JAX package has no Tacotron 2): nothing else
// in ops/ computes an LSTM cell or location-sensitive attention.  The plain
// version, op for op, is ops/tacotron2_step.py:tacotron2_step_reference.
//
// The step is a strict chain, each stage reading all of the one before:
//
//   prenet layer 1 -> prenet layer 2 -> attention LSTM -> query -> energies
//   -> softmax + context -> decoder LSTM -> projection (frame | stop logit)
//
// What bounds it: bytes.  A step reads 18.2 M bf16 parameters (the two
// LSTMs' [W_ih | W_hh] are 7.3 M and 10.5 M of them) for at most 8 rows:
// 2 FLOPs a weight a row, far below the tensor cores, so every product
// runs on the CUDA cores in fp32 from 16-byte loads of bf16 weights, the
// activations rounded to bf16 as a block stages them in shared memory.  In
// practice the chain of eight dependent stages bounds it (latency); the
// weights, 36.4 MB, can stay in the 50-MB L2 from one step to the next.
//
// Design: one cooperative launch of a block an SM (so that every block is
// resident); the stages are separated by a grid barrier (a counter and a
// generation word in global memory, trapping after kSpinLimitNs), and each
// stage's work items ("virtual blocks") are dealt over the blocks.  Eight
// launches a step cost the host ~3 us each and the device a gap each.  The
// matrix stages give a warp each output (the LSTM stage a warp each hidden
// unit, its four gate rows at once, so that the cell's update needs no
// second pass), every lane a 16-byte slice of the row in turn, then a
// butterfly over the warp; every item stages [x; h] of all rows once, with
// several 16-byte loads in flight a thread (a chain of single loads from L2
// was most of each stage's time).  The prenet's layers are two such stages
// whose epilogue is the ReLU and the dropout mask.  Values a stage of the
// same launch wrote are read with ld.global.cg (L2, never a stale L1 line).
// h1 and h2 are double-buffered by the step's parity: an LSTM stage's items
// read all of the old h while others write the new one.  The energies split
// each row's encoder positions into items of kPositions; the location term
// goes through wloc = W_ld W_conv (the dense folded into the 2 x k taps,
// fp32).  The softmax is computed alike by every context item of a row,
// each of which sums a slice of the context's columns.  Sums are in a fixed
// order (no atomics but the barrier's): a step is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "dropout_mask.cuh"
#include "numeric.cuh"
#include "sync.cuh"

namespace {

constexpr int kThreads = 256;       // a block
constexpr int kWarps = kThreads / 32;  // output rows (or hidden units) of a matrix item
constexpr int kPositions = 8;       // encoder positions of one energy item
constexpr int kContextCols = 128;   // context columns of one context item
constexpr int kContextGroups = kThreads / (kContextCols / 8);  // position groups
constexpr int kStage = 4;           // 16-byte loads a thread has in flight while staging

struct Args {
  // weights (ops/tacotron2_step.py:pack_tacotron2_weights)
  const bf16* pw1; const bf16* pw2;
  const bf16* w1; const float* b1;
  const bf16* wq; const float* wloc; const float* v;
  const bf16* w2; const float* b2;
  const bf16* wp; const float* bp;
  // the decode's encoder side
  const bf16* memory; const bf16* pm; const int* lens;
  // state and scratch (Tacotron2State), fp32
  float* h1; float* c1; float* h2; float* c2;
  float* alpha; float* alpha_cum; float* ctx;
  float* p; float* q; float* energy; float* y; float* p1;
  uint32_t* bar;  // the grid barrier: arrivals, generation (zero at first)
  int b, tp, n_mels, prenet, h1d, h2d, enc, att, loc_k;
  int smem[7];
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// 8 bf16 (16 bytes) as floats
__device__ __forceinline__ void unpack8(const uint4& u, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// [s0 | s1 | s2] of every row (fp32, each row of segment i n_i wide, every
// n_i a multiple of 8; the rows of s0 ld0 floats apart, a multiple of 4),
// rounded to bf16, into shared memory as B rows of K = n0 + n1 + n2; four
// floats a load, kStage loads in flight a thread.
template <int B>
__device__ __forceinline__ void stage_rows(bf16* xs, const float* s0, int n0, const float* s1,
                                           int n1, const float* s2, int n2,
                                           long long ld0 = -1) {
  if (ld0 < 0) ld0 = n0;
  const int k_all = n0 + n1 + n2, q_all = k_all / 4, total = B * q_all;
  for (int base = threadIdx.x; base < total; base += kStage * blockDim.x) {
    float4 v[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = base + u * blockDim.x;
      if (i < total) {
        const int r = i / q_all, k = (i - r * q_all) * 4;
        const float* src = k < n0 ? s0 + r * ld0 + k
                                  : (k < n0 + n1 ? s1 + r * n1 + (k - n0)
                                                 : s2 + r * n2 + (k - n0 - n1));
        v[u] = __ldcg(reinterpret_cast<const float4*>(src));
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = base + u * blockDim.x;
      if (i < total) {
        uint2 w;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&w);
        h[0] = __floats2bfloat162_rn(v[u].x, v[u].y);
        h[1] = __floats2bfloat162_rn(v[u].z, v[u].w);
        *reinterpret_cast<uint2*>(xs + 4 * i) = w;
      }
    }
  }
}

// Item vb of an LSTM cell over every row: a warp a hidden unit j, its gate rows j,
// H + j, 2H + j, 3H + j (i, f, g, o) of W = [W_ih | W_hh] (4H x K) against
// [s0 | s1 | s2] (K wide), then c = f c + i g, h = o tanh(c).
template <int B>
__device__ __forceinline__ void lstm_item(int vb, const bf16* W, const float* bias,
                                          const float* s0, int n0, const float* s1, int n1,
                                          const float* s2, int n2, float* h_out, float* c,
                                          int H) {
  extern __shared__ uint4 sm_lstm[];
  const int K = n0 + n1 + n2, K8 = K / 8;
  stage_rows<B>(reinterpret_cast<bf16*>(sm_lstm), s0, n0, s1, n1, s2, n2);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = vb * kWarps + warp;
  if (j >= H) return;
  const uint4* rows[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) rows[g] = reinterpret_cast<const uint4*>(W + (size_t)(g * H + j) * K);
  float acc[4][B];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int r = 0; r < B; ++r) acc[g][r] = 0.0f;
#pragma unroll 2
  for (int v = lane; v < K8; v += 32) {
    float wf[4][8];
#pragma unroll
    for (int g = 0; g < 4; ++g) unpack8(__ldg(rows[g] + v), wf[g]);
#pragma unroll
    for (int r = 0; r < B; ++r) {
      float xf[8];
      unpack8(sm_lstm[r * K8 + v], xf);
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][r] = fmaf(wf[g][e], xf[e], acc[g][r]);
    }
  }
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int r = 0; r < B; ++r) acc[g][r] = warp_sum(acc[g][r]);
  float gi = 0.0f, gf = 0.0f, gg = 0.0f, go = 0.0f;
#pragma unroll
  for (int r = 0; r < B; ++r) {
    if (r == lane) { gi = acc[0][r]; gf = acc[1][r]; gg = acc[2][r]; go = acc[3][r]; }
  }
  if (lane < B) {
    gi += bias[j]; gf += bias[H + j]; gg += bias[2 * H + j]; go += bias[3 * H + j];
    const float cc = sigmoid(gf) * c[lane * H + j] + sigmoid(gi) * tanhf(gg);
    c[lane * H + j] = cc;
    h_out[lane * H + j] = sigmoid(go) * tanhf(cc);
  }
}

// A prenet layer's epilogue: ReLU, then the inference dropout's keep bit of
// (row0 + r, o) under salt 2 t + layer (the counter hash of prenet_keep).
struct Drop {
  int on;  // 0: no epilogue (the query, the projection)
  uint32_t seed, salt, threshold;
  float scale;
  int row0;
};

// Where the projection also puts the step's results in the decode's
// buffers (nothing when frames is null): row r's frame at frames + r
// frames_stride, its stop logit at stops + r stops_stride, and its stop
// vote (sigmoid(logit) >= stop_threshold) or'ed into stopped[r].
struct Emit {
  float* frames = nullptr;
  long long frames_stride = 0;
  float* stops = nullptr;
  long long stops_stride = 0;
  uint8_t* stopped = nullptr;
  float stop_threshold = 0.0f;
};

// Item vb: out[r, o] = W[o] . [s0 | s1] (+ bias[o]) for the kWarps rows o
// of the item, o < N, a warp a row; the rows of s0 ld0 floats apart.  With
// `emit`, output N - 1 is the stop logit and the others the frame.
template <int B>
__device__ __forceinline__ void gemv_item(int vb, const bf16* W, const float* bias,
                                          const float* s0, int n0, long long ld0,
                                          const float* s1, int n1, float* out, int N,
                                          Drop drop, Emit emit = Emit{}) {
  extern __shared__ uint4 sm_gemv[];
  const int K = n0 + n1, K8 = K / 8;
  stage_rows<B>(reinterpret_cast<bf16*>(sm_gemv), s0, n0, s1, n1, nullptr, 0, ld0);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o = vb * kWarps + warp;
  if (o >= N) return;
  const uint4* row = reinterpret_cast<const uint4*>(W + (size_t)o * K);
  float acc[B];
#pragma unroll
  for (int r = 0; r < B; ++r) acc[r] = 0.0f;
#pragma unroll 4
  for (int v = lane; v < K8; v += 32) {
    float wf[8];
    unpack8(__ldg(row + v), wf);
#pragma unroll
    for (int r = 0; r < B; ++r) {
      float xf[8];
      unpack8(sm_gemv[r * K8 + v], xf);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r] = fmaf(wf[e], xf[e], acc[r]);
    }
  }
  const uint32_t base = drop.on ? mask_base(drop.seed, drop.salt) : 0u;
#pragma unroll
  for (int r = 0; r < B; ++r) {
    float s = warp_sum(acc[r]) + (bias ? bias[o] : 0.0f);
    if (drop.on) {
      s = fmaxf(s, 0.0f);
      if (drop.threshold) {
        const uint32_t counter = static_cast<uint32_t>(drop.row0 + r) * N + o;
        s = mask_keep(base, counter, drop.threshold) ? s * drop.scale : 0.0f;
      }
    }
    if (lane == 0) {
      out[r * N + o] = s;
      if (emit.frames != nullptr) {
        if (o < N - 1) {
          emit.frames[r * emit.frames_stride + o] = s;
        } else {
          emit.stops[r * emit.stops_stride] = s;
          if (1.0f / (1.0f + expf(-s)) >= emit.stop_threshold) emit.stopped[r] = 1;
        }
      }
    }
  }
}

// Item vb: e[r, j] = v . tanh(q[r] + wloc [a; a_cum](window at j) + pm[r, j])
// for the kPositions positions j of the item's slice x of row r (vb = r nx +
// x); -inf from the row's length on.
__device__ __forceinline__ void energy_item(int vb, const Args& a) {
  extern __shared__ float sm_e[];
  const int A = a.att, k = a.loc_k, pad = (k - 1) / 2, tp = a.tp;
  const int nx = (tp + kPositions - 1) / kPositions;
  const int r = vb / nx, j0 = (vb - r * nx) * kPositions, span = kPositions + k - 1;
  const int wl_stride = 2 * k + 1;  // odd: the warp's A rows fall in distinct banks
  float* wl = sm_e;                         // A x (2k + 1)
  float* win = wl + A * wl_stride;          // 2 x span: a, a_cum around the block's positions
  float* qv = win + 2 * span;               // A
  float* vv = qv + A;                       // A
  float* part = vv + A;                     // kPositions x A
  const int n4 = A * 2 * k / 4;             // wloc as float4s (A * 2k is a multiple of 4)
  for (int base = threadIdx.x; base < n4; base += kStage * blockDim.x) {
    float4 f[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = base + u * blockDim.x;
      if (i < n4) f[u] = __ldg(reinterpret_cast<const float4*>(a.wloc) + i);
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = base + u * blockDim.x;
      if (i < n4) {
        const float fv[4] = {f[u].x, f[u].y, f[u].z, f[u].w};
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) {
          const int flat = 4 * i + c4, ai = flat / (2 * k);
          wl[ai * wl_stride + flat - ai * 2 * k] = fv[c4];
        }
      }
    }
  }
  for (int i = threadIdx.x; i < 2 * span; i += blockDim.x) {
    const int ch = i / span, pos = j0 - pad + (i - ch * span);
    const float* src = ch ? a.alpha_cum : a.alpha;
    win[i] = (pos >= 0 && pos < tp) ? __ldcg(src + r * tp + pos) : 0.0f;
  }
  for (int i = threadIdx.x; i < A; i += blockDim.x) {
    qv[i] = __ldcg(a.q + r * A + i);
    vv[i] = a.v[i];
  }
  __syncthreads();
  const int len = a.lens[r];
  for (int i = threadIdx.x; i < kPositions * A; i += blockDim.x) {
    const int pj = i / A, ai = i - pj * A, j = j0 + pj;
    float contrib = 0.0f;
    if (j < len) {
      const float* wrow = wl + ai * wl_stride;
      float f = 0.0f;
      for (int ch = 0; ch < 2; ++ch) {
        const float* wc = wrow + ch * k;
        const float* xc = win + ch * span + pj;
        for (int tap = 0; tap < k; ++tap) f = fmaf(wc[tap], xc[tap], f);
      }
      const float z = tanhf(qv[ai] + f + __bfloat162float(a.pm[((size_t)r * tp + j) * A + ai]));
      contrib = vv[ai] * z;
    }
    part[pj * A + ai] = contrib;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  for (int pj = warp; pj < kPositions; pj += n_warps) {
    const int j = j0 + pj;
    float s = 0.0f;
    for (int ai = lane; ai < A; ai += 32) s += part[pj * A + ai];
    s = warp_sum(s);
    if (lane == 0 && j < tp) a.energy[r * tp + j] = j < len ? s : -CUDART_INF_F;
  }
}

// Block-wide reductions in a fixed order.
__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  v = is_max ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < n_warps ? red[lane] : (is_max ? -CUDART_INF_F : 0.0f);
    w = is_max ? warp_max(w) : warp_sum(w);
    if (lane == 0) red[32] = w;
  }
  __syncthreads();
  const float out = red[32];
  __syncthreads();
  return out;
}

// Item vb = r ny + y of row r: the masked softmax of its energies (every
// item of the row computes it alike; the first writes the new attention
// weights and adds them to the running sum) and columns [kContextCols y,
// + kContextCols) of the context sum_j a_j memory_j: a thread 8 columns over
// every kContextGroups-th position, the groups summed in order.
__device__ __forceinline__ void context_item(int vb, const Args& a, float* red) {
  extern __shared__ float sm_c[];  // tp weights, then kContextGroups x kContextCols partial sums
  const int tp = a.tp, E = a.enc, ny = (E + kContextCols - 1) / kContextCols;
  const int r = vb / ny, y = vb - r * ny, len = a.lens[r];
  const int d0 = y * kContextCols;
  float* part = sm_c + tp;
  const float* e = a.energy + (size_t)r * tp;
  float m = -CUDART_INF_F;
  for (int j = threadIdx.x; j < len; j += blockDim.x) m = fmaxf(m, __ldcg(e + j));
  m = block_reduce(m, red, true);
  float s = 0.0f;
  for (int j = threadIdx.x; j < tp; j += blockDim.x) {
    const float x = j < len ? expf(__ldcg(e + j) - m) : 0.0f;
    sm_c[j] = x;
    s += x;
  }
  s = block_reduce(s, red, false);
  for (int j = threadIdx.x; j < tp; j += blockDim.x) {
    const float al = sm_c[j] / s;
    sm_c[j] = al;
    if (y == 0) {
      a.alpha[r * tp + j] = al;
      a.alpha_cum[r * tp + j] += al;
    }
  }
  __syncthreads();
  const int dv = threadIdx.x % (kContextCols / 8), jg = threadIdx.x / (kContextCols / 8);
  const int d = d0 + 8 * dv;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
  if (d < E) {
    const bf16* mem = a.memory + (size_t)r * tp * E + d;
#pragma unroll 4
    for (int j = jg; j < len; j += kContextGroups) {
      float mf[8];
      unpack8(__ldg(reinterpret_cast<const uint4*>(mem + (size_t)j * E)), mf);
      const float al = sm_c[j];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(al, mf[i], acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) part[jg * kContextCols + 8 * dv + i] = acc[i];
  __syncthreads();
  for (int c = threadIdx.x; c < kContextCols && d0 + c < E; c += blockDim.x) {
    float sum = 0.0f;
    for (int g = 0; g < kContextGroups; ++g) sum += part[g * kContextCols + c];
    a.ctx[r * E + d0 + c] = sum;
  }
}

__device__ __forceinline__ uint32_t ld_acquire_gpu(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every block of the grid arrives before any leaves; a block's writes before
// it are seen by every block after it.  `gen`: the generation the barrier
// is at (each thread keeps it; all blocks read it at the launch's start).
__device__ __forceinline__ void grid_sync(uint32_t* bar, uint32_t& gen) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    uint32_t old;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n"
                 : "=r"(old) : "l"(bar) : "memory");
    if (old == gridDim.x - 1) {
      asm volatile("st.relaxed.gpu.global.u32 [%0], 0;\n" ::"l"(bar) : "memory");
      asm volatile("st.release.gpu.global.u32 [%0], %1;\n"
                   ::"l"(bar + 1), "r"(gen + 1u) : "memory");
    } else {
      const unsigned long long t0 = global_timer_ns();
      while (ld_acquire_gpu(bar + 1) == gen) {
        if (global_timer_ns() - t0 > kSpinLimitNs) __trap();
      }
    }
  }
  gen += 1u;
  __syncthreads();
}

struct Step {
  const float* frame;  // the previous frame of each row, rows frame_stride floats apart
  long long frame_stride;
  int t, row0;
  uint32_t seed, threshold;
  float scale;
  Emit emit;
};

// The whole step at position st.t: each stage's items dealt over the grid's
// blocks, a grid barrier between stages.
template <int B>
__global__ void __launch_bounds__(kThreads) tacotron2_step_kernel(Args a, Step st) {
  __shared__ uint32_t gen0;
  __shared__ float red[33];
  if (threadIdx.x == 0) gen0 = ld_acquire_gpu(a.bar + 1);
  __syncthreads();
  uint32_t gen = gen0;
  const int nb = gridDim.x, cur = st.t & 1, nxt = cur ^ 1;
  float* h1_in = a.h1 + (size_t)cur * B * a.h1d;
  float* h1_out = a.h1 + (size_t)nxt * B * a.h1d;
  float* h2_in = a.h2 + (size_t)cur * B * a.h2d;
  float* h2_out = a.h2 + (size_t)nxt * B * a.h2d;
  const uint32_t salt = 2u * static_cast<uint32_t>(st.t);
  const Drop pre0{1, st.seed, salt, st.threshold, st.scale, st.row0};
  const Drop pre1{1, st.seed, salt + 1u, st.threshold, st.scale, st.row0};
  const Drop none{0, 0u, 0u, 0u, 1.0f, 0};
  const int pre_items = (a.prenet + kWarps - 1) / kWarps;

  for (int vb = blockIdx.x; vb < pre_items; vb += nb, __syncthreads())
    gemv_item<B>(vb, a.pw1, nullptr, st.frame, a.n_mels, st.frame_stride, nullptr, 0, a.p1,
                 a.prenet, pre0);
  grid_sync(a.bar, gen);
  for (int vb = blockIdx.x; vb < pre_items; vb += nb, __syncthreads())
    gemv_item<B>(vb, a.pw2, nullptr, a.p1, a.prenet, a.prenet, nullptr, 0, a.p, a.prenet, pre1);
  grid_sync(a.bar, gen);
  for (int vb = blockIdx.x; vb < (a.h1d + kWarps - 1) / kWarps; vb += nb, __syncthreads())
    lstm_item<B>(vb, a.w1, a.b1, a.p, a.prenet, a.ctx, a.enc, h1_in, a.h1d, h1_out, a.c1, a.h1d);
  grid_sync(a.bar, gen);
  for (int vb = blockIdx.x; vb < (a.att + kWarps - 1) / kWarps; vb += nb, __syncthreads())
    gemv_item<B>(vb, a.wq, nullptr, h1_out, a.h1d, a.h1d, nullptr, 0, a.q, a.att, none);
  grid_sync(a.bar, gen);
  for (int vb = blockIdx.x; vb < B * ((a.tp + kPositions - 1) / kPositions);
       vb += nb, __syncthreads())
    energy_item(vb, a);
  grid_sync(a.bar, gen);
  for (int vb = blockIdx.x; vb < B * ((a.enc + kContextCols - 1) / kContextCols);
       vb += nb, __syncthreads())
    context_item(vb, a, red);
  grid_sync(a.bar, gen);
  for (int vb = blockIdx.x; vb < (a.h2d + kWarps - 1) / kWarps; vb += nb, __syncthreads())
    lstm_item<B>(vb, a.w2, a.b2, h1_out, a.h1d, a.ctx, a.enc, h2_in, a.h2d, h2_out, a.c2, a.h2d);
  grid_sync(a.bar, gen);
  for (int vb = blockIdx.x; vb < (a.n_mels + 1 + kWarps - 1) / kWarps; vb += nb, __syncthreads())
    gemv_item<B>(vb, a.wp, a.bp, h2_out, a.h2d, a.h2d, a.ctx, a.enc, a.y, a.n_mels + 1, none,
                 st.emit);
}

// Blocks of one launch: one an SM, all resident (the cooperative launch
// refuses a grid that cannot be); per B, for the shared memory last asked.
template <int B>
cudaError_t launch(const Args& a, const Step& st, cudaStream_t s) {
  static int grid = 0, smem_set = -1;
  int smem = 0;
  for (int i = 0; i < 7; ++i) smem = a.smem[i] > smem ? a.smem[i] : smem;
  cudaError_t err;
  if (smem != smem_set) {
    if ((err = cudaFuncSetAttribute(tacotron2_step_kernel<B>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
      return err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev))) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tacotron2_step_kernel<B>,
                                                             kThreads, smem)))
      return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    grid = sms;
    smem_set = smem;
  }
  void* params[] = {const_cast<Args*>(&a), const_cast<Step*>(&st)};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(tacotron2_step_kernel<B>),
                                     dim3(grid), dim3(kThreads), params, smem, s);
}

}  // namespace

extern "C" {

// sizeof(Args), for the wrapper's check of its mirror.
long tacotron2_step_args_bytes() { return static_cast<long>(sizeof(Args)); }

// The step at position t of a.b rows from the previous frame (a.b rows of
// a.n_mels fp32, rows frame_stride apart).  Returns a CUDA error code.
// `args` is an Args (void here: a type of the unnamed namespace would give
// the function internal linkage).  With frames not null the step also
// writes the frame, the stop logit and the stop vote of each row into the
// decode's buffers (Emit).
int tacotron2_step(const void* args, const float* frame, long long frame_stride, int t,
                   uint32_t seed, uint32_t threshold, float scale, int row0, float* frames,
                   long long frames_stride, float* stops, long long stops_stride,
                   uint8_t* stopped, float stop_threshold, cudaStream_t stream) {
  const Args* a = static_cast<const Args*>(args);
  const Step st{frame, frame_stride, t, row0, seed, threshold, scale,
                Emit{frames, frames_stride, stops, stops_stride, stopped, stop_threshold}};
  switch (a->b) {
    case 1: return launch<1>(*a, st, stream);
    case 2: return launch<2>(*a, st, stream);
    case 3: return launch<3>(*a, st, stream);
    case 4: return launch<4>(*a, st, stream);
    case 5: return launch<5>(*a, st, stream);
    case 6: return launch<6>(*a, st, stream);
    case 7: return launch<7>(*a, st, stream);
    case 8: return launch<8>(*a, st, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
