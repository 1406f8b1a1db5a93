// One whole Transformer-TTS decoder step for Hopper (sm_90a), B = 1..8, as
// ONE persistent kernel launch.
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
// d_model 256, 3 layers, d_ffn 1024; 44 MB at d_model 512, 6 layers, d_ffn
// 2048) plus each row's cache prefix.  At B <= 8 a step does 2 FLOPs per
// weight per row, two orders of magnitude below the tensor cores' roofline
// (295 FLOPs a byte in bf16), so the products stay on the CUDA cores.  What
// costs is latency: the step is a chain of about 10 L dependent stages.
//
// The design:
//
// - A cluster of 16 blocks (12 or 8 where the card cannot hold enough
//   clusters of 16), one per SM, runs the step for R batch rows; the grid
//   has B / R clusters (rows share nothing but the weights).  Dependent stages are separated by the cluster barrier, and a
//   stage hands its outputs to the next by storing them straight into every
//   block's shared memory (distributed shared memory): a stage reads its
//   inputs from its own shared memory, never through L2.  (A grid barrier
//   over all 132 SMs cost 1.47 us on an H100 against 0.74 us for the
//   cluster barrier, and each stage then also paid an L2 round trip for its
//   inputs; PERF.md.)  The stages:
//
//     prenet 1 (+ReLU) | prenet 2 (+ReLU, +alpha*PE[t])
//     per layer:
//       q|k|v (LN3 of the previous layer in the prologue; writes the new
//              K/V rows into the cache at t, in place)
//       self-attention over cache chunks (none at t = 0)
//       self out-projection (prologue: the chunks combined, the current
//              position folded in closed form)
//       cross q (LN1 in the prologue)
//       cross-attention over encoder chunks
//       cross out-projection (prologue: the chunks combined; the expected
//              position of the last layer)
//       FFN 1 (+ReLU; LN2 in the prologue) | FFN 2
//     fused mel|stop head (LN3 in the prologue)
//
//   LayerNorm needs whole rows, so every block recomputes it for its rows
//   (cheap next to the weights) and keeps the residual itself.
// - Weights streamed ahead of the chain.  In every matrix-vector stage each
//   block owns a fixed range of output columns (decode_plan in
//   ../decode_step.py), cut into pieces of at most 32 KB; a column is a row
//   of the (N, K) weight, so a piece is contiguous.  At kernel start the
//   block's thread 0 issues bulk asynchronous copies (cp.async.bulk, one
//   mbarrier per piece) of its pieces into a shared-memory ring, as far as
//   the ring holds them; the rest follow as the pieces before them retire
//   (the plan's "issue after").  A stage waits for its cluster barrier and
//   its own pieces only.  The LayerNorm parameters and the block's biases
//   are loaded once at kernel start.  Each warp takes one output column at
//   a time and reads its weight row from shared memory in 16-byte vectors
//   against the R input rows.
// - Attention over the cluster (flash-decoding).  The keys of every (row,
//   head) are cut into chunks (attn_chunks in ../decode_step.py) and the
//   (row, head, chunk) items spread over the blocks.  Stage A scores the
//   chunk's keys and shares the chunk's max; after a barrier (skipped when
//   a (row, head) is one chunk) stage B takes e = exp(s - m) against the
//   global max m, as the reference rounds it before the value product, and
//   shares l_c = sum e and sum T(e) v; the consuming stage adds the chunks
//   in chunk order.  No atomics: the step is bit-equal from run to run.
//   (Rounding against each chunk's own max would save that barrier but
//   moved a plain model of it past the bf16 tolerance at sharp attention:
//   tests/test_torch_decode_plan.py holds the kernel's order instead.)
//
// - Inference prenet dropout (the JAX package's _prenet_dropout_step), in
//   the epilogues of the two prenet stages only: after the ReLU, and in
//   prenet 2 before + alpha*PE[t], an element is kept when the counter hash
//   of dropout_mask.cuh passes (salt 2 t + layer, counter = the row's index
//   in the whole batch * D + column) and scaled by 1 / (1 - rate).  The
//   kernel is instantiated with and without it (kDrop), each in a library
//   of its own: this file builds the one without (a launch at rate 0 runs
//   the code, registers and spills of the kernel before the option
//   existed), decode_step_dropout.cu includes it to build the one with, so
//   that the two compile in parallel and the dropout library is built only
//   when dropout is asked for.  (Code for the option inside the rate-0
//   kernel moved ptxas's register allocation: up to 1.3 us a step more at
//   B = 1 and spills at bf16 with 3 rows.)
//
// - The verify pass of speculative decoding is a kernel of its own,
//   decode_step_verify.cu, built as a library of its own: it includes this
//   file for the shared parts (Config, Step, Block, stage_w,
//   layer_norm_rows) and defines TTS_DECODE_STEP_VERIFY, under which Step
//   has the pass's fields and this file's entry points are left out, so
//   that the step's kernels keep their code, registers and spills.
//
// Every buffer offset, the plan and the chunks come from the wrapper; the
// kernel checks only what it is handed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "dropout_mask.cuh"
#include "sync.cuh"

namespace {

constexpr int kMaxCluster = 16; // blocks of a cluster (Config::cluster), one per SM
constexpr int kThreads = 512;   // threads of a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;     // batch rows of a launch
constexpr int kMaxPieces = 2048; // weight pieces of a block (table and mbarriers: 24 B each)
constexpr int kMaxStages = 64;  // matrix-vector stages, 3 + 6 L
constexpr int kUnroll = 4;      // cache rows in flight per thread in attention

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

// Sum (or max) over the block in a fixed order; every thread gets the
// result.  `red` holds kWarps floats of shared memory.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();  // `red` may still be read from a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// Shared-memory buffers of a block, in the order of SMEM_BUFFERS in
// ../decode_step.py; Config::off holds their byte offsets.
enum Buffer {
  kBufStages,  // (3 + 6 L) int4: first piece, end piece, bias offset, -
  kBufPieces,  // (n_pieces) int4: first column, end column, ring offset, issue after
  kBufMbar,    // (n_pieces + L + 1) mbarriers: one per piece, one per layer's
               // LayerNorms, one for the plan rows and biases
  kBufRed,     // (2 R kWarps) block reductions
  kBufBias,    // (n_bias) fp32 biases of the block's columns, stage after stage
  kBufLn,      // two slots of one layer's ln_g | ln_b, (3, D) each: layer l in slot l % 2
  kBufRa,      // (R, D) residual: LN3 of the previous layer, then LN2 | each block
  kBufRb,      // (R, D) residual: LN1                              | its own
  kBufO,       // (R, D) sublayer outputs                         | shared by
  kBufQ,       // (R, D) q, scaled                                | the producing
  kBufKv,      // (R, 2D) k | v rows of the step                  | stage with
  kBufAct,     // (R, max(D, F)) T(prenet 1) / T(FFN 1)           | every block
  kBufXs,      // (R, max(D, n_mels)) other matrix-vector inputs, rounded to T
  kBufPm,      // (R H nc_max) chunk maxima            | shared
  kBufPl,      // (R H nc_max) sum e                   | shared
  kBufPpos,    // (R H nc_max) sum e * key             | shared
  kBufPacc,    // (R H nc_max, dh) sum T(e) v         | shared
  kBufMloc,    // the block's items' chunk maxima
  kBufPosh,    // (R H) expected position per head
  kBufPart,    // (P, dh) partial context sums of attention
  kBufScores,  // (items a block, max_keys) scores, then exponentials
  kBufRing,    // the weight ring
  kNumBuffers
};

// What the wrapper fixes once per prepared step (mirrored field for field
// by _StepConfig in ../decode_step.py).
struct Config {
  int cluster, B, R, L, H, dh, F, n_mels, d_out, n_pos, tp;
  int cross_chunk, cross_nc, nc_max, max_keys, n_pieces, n_bias, smem_bytes;
  int off[kNumBuffers];
  int first_piece[kMaxCluster][2];  // columns of each rank's piece 0 (stage 0, ring offset 0)
  float scale;        // dh ** -0.5 rounded once to fp32, as the Python scalar is
  const void* w[20];  // the packed weights in _PACK_ORDER
  const int* stages;  // (cluster, 3 + 6 L, 4) int32: each rank's kBufStages rows
  const int* pieces;  // (cluster, n_pieces, 4) int32: each rank's kBufPieces rows
  const float* bias;  // (cluster, n_bias): each rank's kBufBias
};

// What changes from call to call.
struct Step {
  int t, self_chunk, self_nc, frame_stride;
  const float* frame;       // (B, n_mels), rows frame_stride apart
  const float* pe_row;      // (D) alpha * PE[t]
  const float* cross_bias;  // (B, tp)
  void* self_k;             // (L, H, B, n_pos, dh) T
  void* self_v;
  const void* cross_k;      // (L, H, B, tp, dh) T
  const void* cross_v;
  float* y;                 // (B, d_out)
  void* k_new;              // (L, H, B, dh) T
  void* v_new;
  float* pos;               // (B) or null
  // null, or per block 2 + 2 (2 + 10 L) global-timer stamps (ns): kernel
  // start, (arrival, release) at each cluster barrier, kernel end
  unsigned long long* timeline;
  // prenet dropout (kDrop): keep threshold, hash seed, batch index of the
  // launch's row 0, and the kept elements' scale 1 / (1 - rate)
  uint32_t drop_threshold, drop_seed;
  int drop_row0;
  float drop_scale;
#ifdef TTS_DECODE_STEP_VERIFY
  // the verify pass (kVerify): frame is the true input f0 and prev the one
  // before it (the drafts' slope f0 - prev; prev = frame drafts by holding
  // f0); the accepted frames go to frames_out (the frame buffer's row
  // t r + 1) and their stop logits to stops_out (row t r), 2 m + vote to
  // code; the acceptance tolerance, the stop threshold, the positions left
  // (n_pos - t) and the reduction factor; the byte offsets of the pass's
  // own shared-memory buffers (decode_step_verify.cu's VerifyBuffer).
  // Only the verify library has them: in the step's Step these fields alone
  // moved ptxas's register allocation of the step kernels (bf16 R = 8: 64
  // -> 232 bytes of spill stores).
  const float* prev;
  float* frames_out;
  float* stops_out;
  int* code;
  float tau, stop_threshold;
  int limit, r;
  int voff[3];
#endif
};

#ifdef TTS_DECODE_STEP_DROPOUT
constexpr bool kLibDrop = true;  // the library of decode_step_dropout.cu
#else
constexpr bool kLibDrop = false;
#endif

template <typename T>
struct StageW {
  const T* W;     // (N, K) row-major
  const T* bias;  // (N)
  int N, K;
};

// The weight of matrix-vector stage gs (the order of gemv_stages); each
// row is kPad elements longer than its depth K in memory (row_pad).
template <typename T, int kPad = 0>
__device__ StageW<T> stage_w(const Config& c, int gs) {
  const int D = c.H * c.dh;
  auto W = [&](int i) { return static_cast<const T*>(c.w[i]); };
  if (gs == 0) return {W(0), W(1), D, c.n_mels};
  if (gs == 1) return {W(2), W(3), D, D};
  if (gs == 2 + 6 * c.L) return {W(18), W(19), c.d_out, D};
  const int l = (gs - 2) / 6, j = (gs - 2) % 6;
  const size_t DD = static_cast<size_t>(D) * (D + kPad), DF = static_cast<size_t>(D) * (c.F + kPad);
  const size_t FD = kPad ? static_cast<size_t>(c.F) * (D + kPad) : DF;
  switch (j) {
    case 0: return {W(4) + l * 3 * DD, W(5) + static_cast<size_t>(l) * 3 * D, 3 * D, D};
    case 1: return {W(6) + l * DD, W(7) + static_cast<size_t>(l) * D, D, D};
    case 2: return {W(8) + l * DD, W(9) + static_cast<size_t>(l) * D, D, D};
    case 3: return {W(10) + l * DD, W(11) + static_cast<size_t>(l) * D, D, D};
    case 4: return {W(12) + l * FD, W(13) + static_cast<size_t>(l) * c.F, c.F, D};
    default: return {W(14) + l * DF, W(15) + static_cast<size_t>(l) * D, D, c.F};
  }
}

// Elements of a weight row in the ring: the verify pass's bf16 weights are
// laid out with 8 more a row (16 bytes), so that the tensor cores' 8-row
// loads from shared memory fall in distinct banks.
template <typename T, bool kVerify>
__host__ __device__ constexpr int row_pad() {
  return kVerify && sizeof(T) == 2 ? 8 : 0;
}

// A block's view of its shared memory and of its place in the launch
// (kVerify: of a verify pass, decode_step_verify.cu).
template <typename T, int R, bool kVerify = false>
struct Block {
  const Config& c;
  const Step& s;
  uint8_t* smem;
  int rank, row0;  // rank in the cluster; first batch row of the cluster
  int next_issue;   // the next piece to copy (every thread keeps the cursor)
  int issue_stage;  // the stage of the piece before it
  unsigned long long* stamps;
  int n_sync;

  template <typename U>
  __device__ U* buf(Buffer b) const { return reinterpret_cast<U*>(smem + c.off[b]); }
  __device__ float* f(Buffer b) const { return buf<float>(b); }
  __device__ const int4* stage_rows() const { return buf<const int4>(kBufStages); }
  __device__ const int4* piece_rows() const { return buf<const int4>(kBufPieces); }
  __device__ uint64_t* mbar() const { return buf<uint64_t>(kBufMbar); }


  // Copy the pieces whose ring bytes are free once piece `retired` is used
  // (all of them at -1), up to piece `limit`: warp 0 issues them, a lane a
  // piece; every thread moves its cursor alike.  "Issue after" never
  // decreases along the pieces, so the pieces due are a prefix.
  __device__ void issue_after(int retired, int limit = kMaxPieces) {
    const int4* pr = piece_rows();
    const int lane = threadIdx.x & 31;
    for (;;) {
      const int i = next_issue + lane;
      const bool go = i < c.n_pieces && i < limit && pr[i].w <= retired;
      const int n = __popc(__ballot_sync(0xffffffffu, go));
      if (n == 0) return;
      int gs = issue_stage;
      if (go) {
        while (stage_rows()[gs].y <= i) ++gs;
        if (threadIdx.x < 32) {
          const int4 p = pr[i];
          const StageW<T> sw = stage_w<T, row_pad<T, kVerify>()>(c, gs);
          const int ld = sw.K + row_pad<T, kVerify>();
          const uint32_t bytes = static_cast<uint32_t>(p.y - p.x) * ld * sizeof(T);
          mbar_arrive_expect_tx(&mbar()[i], bytes);
          bulk_copy_g2s(buf<uint8_t>(kBufRing) + p.z, sw.W + static_cast<size_t>(p.x) * ld,
                        bytes, &mbar()[i]);
        }
      }
      issue_stage = __shfl_sync(0xffffffffu, gs, n - 1);
      next_issue += n;
      if (n < 32) return;
    }
  }

  // The barrier between two stages, over the cluster.
  __device__ void sync() {
    __syncthreads();
    if (stamps != nullptr && threadIdx.x == 0) stamps[1 + 2 * n_sync] = global_timer_ns();
    cluster_sync();
    if (stamps != nullptr && threadIdx.x == 0) stamps[2 + 2 * n_sync] = global_timer_ns();
    ++n_sync;
  }

  // x after prenet dropout: element (local row b, column n) of prenet layer
  // `layer`, kept by the counter hash and scaled, or 0.
  __device__ float prenet_drop(float x, int b, int n, int layer) const {
    const uint32_t base = mask_base(s.drop_seed, 2u * static_cast<uint32_t>(s.t) + layer);
    const uint32_t row = static_cast<uint32_t>(s.drop_row0 + row0 + b);
    const uint32_t counter = row * static_cast<uint32_t>(c.H * c.dh) + static_cast<uint32_t>(n);
    return mask_keep(base, counter, s.drop_threshold) ? __fmul_rn(x, s.drop_scale) : 0.f;
  }

  // Store v at element i of buffer b of every block of the cluster (lane r
  // of a warp stores into block r).
  __device__ void share(Buffer b, int i, float v, int lane) const {
    if (lane < c.cluster) dsmem_store(f(b) + i, lane, v);
  }
};

enum Epilogue { kEpiF32, kEpiRelu, kEpiReluPe, kEpiDrop1, kEpiDrop2, kEpiQkv, kEpiScale, kEpiOut };

// Column n's value for each of the R rows: to every block's buffer `out`
// (lane r stores into block r), or to y (kEpiOut); kEpiQkv also writes the
// new K/V rows into the caches at t.
template <typename T, int R, int kEpi>
__device__ __forceinline__ void epilogue(Block<T, R>& blk, Buffer out, int layer, int N, int n,
                                         const float (&v)[R], int lane) {
  const Config& c = blk.c;
  const int D = c.H * c.dh;
#pragma unroll
  for (int b = 0; b < R; ++b) {
    if (kEpi == kEpiOut) {
      if (lane == 0 && blk.row0 + b < c.B) blk.s.y[(blk.row0 + b) * N + n] = v[b];
    } else if (kEpi == kEpiF32) {
      blk.share(out, b * N + n, v[b], lane);
    } else if (kEpi == kEpiRelu) {  // rounded: only a matrix-vector stage reads it
      blk.share(out, b * N + n, round_t<T>(fmaxf(v[b], 0.f)), lane);
    } else if (kEpi == kEpiReluPe) {
      blk.share(out, b * N + n, round_t<T>(fmaxf(v[b], 0.f) + blk.s.pe_row[n]), lane);
    } else if (kEpi == kEpiDrop1) {  // prenet 1 with dropout
      blk.share(out, b * N + n, round_t<T>(blk.prenet_drop(fmaxf(v[b], 0.f), b, n, 0)), lane);
    } else if (kEpi == kEpiDrop2) {  // prenet 2 with dropout, then + alpha * PE[t]
      const float x = blk.prenet_drop(fmaxf(v[b], 0.f), b, n, 1);
      blk.share(out, b * N + n, round_t<T>(x + blk.s.pe_row[n]), lane);
    } else if (kEpi == kEpiScale) {
      blk.share(out, b * N + n, v[b] * c.scale, lane);
    } else {  // kEpiQkv: N = 3D, columns q | k | v
      if (n < D) {
        blk.share(kBufQ, b * D + n, v[b] * c.scale, lane);
      } else {
        const int m = n - D;
        blk.share(kBufKv, b * 2 * D + m, v[b], lane);
        if (lane == kMaxCluster && blk.row0 + b < c.B) {
          const int which = m / D, h = (m % D) / c.dh, j = m % c.dh;
          const size_t row = static_cast<size_t>(h) * c.B + blk.row0 + b;
          const T tv = from_f<T>(v[b]);
          const size_t lsz = static_cast<size_t>(c.H) * c.B * c.n_pos * c.dh;
          T* cache = static_cast<T*>(which ? blk.s.self_v : blk.s.self_k) + layer * lsz;
          T* fresh = static_cast<T*>(which ? blk.s.v_new : blk.s.k_new) +
                     static_cast<size_t>(layer) * c.H * c.B * c.dh;
          cache[(row * c.n_pos + blk.s.t) * c.dh + j] = tv;
          fresh[row * c.dh + j] = tv;
        }
      }
    }
  }
}

// The block's output columns of stage gs: xs (R, K) in shared memory against
// its weight pieces in the ring, one warp per column.  Results go to every
// block's buffer `out` (kEpiOut: to y in global memory).
template <typename T, int R, int kEpi>
__device__ void gemv(Block<T, R>& blk, int gs, Buffer in, Buffer out, int layer = 0) {
  const Config& c = blk.c;
  const int4 st = blk.stage_rows()[gs];
  const StageW<T> sw = stage_w<T>(c, gs);
  const int K = sw.K, N = sw.N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int V = vec<T>();
  const float* xs = blk.f(in);  // (R, K), rounded to T
  const float* bias_s = blk.f(kBufBias) + st.z;
  const int col0 = st.x < st.y ? blk.piece_rows()[st.x].x : 0;
  for (int pc = st.x; pc < st.y; ++pc) {
    const int4 p = blk.piece_rows()[pc];
    mbar_wait(&blk.mbar()[pc], 0);
    const T* piece = reinterpret_cast<const T*>(blk.template buf<uint8_t>(kBufRing) + p.z);
    // two columns a warp at a time, their loads and shuffles interleaved
    for (int n0 = p.x + warp; n0 < p.y; n0 += 2 * kWarps) {
      const int n1 = n0 + kWarps;
      const bool two = n1 < p.y;  // the same in the whole warp
      const T* wr0 = piece + static_cast<size_t>(n0 - p.x) * K;
      const T* wr1 = piece + static_cast<size_t>((two ? n1 : n0) - p.x) * K;
      float acc0[R], acc1[R];
#pragma unroll
      for (int b = 0; b < R; ++b) acc0[b] = acc1[b] = 0.f;
#pragma unroll 2
      for (int k0 = lane * V; k0 < K; k0 += 32 * V) {
        float w0[V], w1[V];
        load16<T>(wr0 + k0, w0);
        load16<T>(wr1 + k0, w1);
#pragma unroll
        for (int b = 0; b < R; ++b) {
          const float4* xb = reinterpret_cast<const float4*>(xs + b * K + k0);
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int i = 0; i < V / 4; ++i) {
            const float4 x4 = xb[i];
            s0 += x4.x * w0[4 * i] + x4.y * w0[4 * i + 1] + x4.z * w0[4 * i + 2] + x4.w * w0[4 * i + 3];
            s1 += x4.x * w1[4 * i] + x4.y * w1[4 * i + 1] + x4.z * w1[4 * i + 2] + x4.w * w1[4 * i + 3];
          }
          acc0[b] += s0;
          acc1[b] += s1;
        }
      }
#pragma unroll
      for (int b = 0; b < R; ++b) {  // the same bits in every lane
        acc0[b] = warp_sum(acc0[b]) + bias_s[n0 - col0];
        acc1[b] = warp_sum(acc1[b]) + bias_s[(two ? n1 : n0) - col0];
      }
      epilogue<T, R, kEpi>(blk, out, layer, N, n0, acc0, lane);
      if (two) epilogue<T, R, kEpi>(blk, out, layer, N, n1, acc1, lane);
    }
    // a piece whose ring bytes the next copy takes: every warp done with it first
    if (blk.next_issue < c.n_pieces && blk.piece_rows()[blk.next_issue].w <= pc) {
      __syncthreads();
      blk.issue_after(pc);
    }
  }
}

// xs (R, K) = T(LN(resid + o)) with fp32 statistics, LayerNorm `norm`
// (0..2) of `layer`; resid_out (a block's own buffer, or null; resid itself
// may be it) keeps the LN output (rounded to T when round_resid) as the
// next residual.
template <typename T, int R, bool kV>
__device__ void layer_norm_rows(Block<T, R, kV>& blk, const float* resid, int layer, int norm,
                                float* resid_out, bool round_resid) {
  const int K = blk.c.H * blk.c.dh;
  const float* g = blk.f(kBufLn) + static_cast<size_t>(layer % 2) * 6 * K + norm * K;
  const float* bb = g + 3 * K;
  const float* o = blk.f(kBufO);
  float* xs = blk.f(kBufXs);
  float* red = blk.f(kBufRed);  // (kWarps, R, 2)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float sum[R], sum2[R];
#pragma unroll
  for (int b = 0; b < R; ++b) {
    sum[b] = sum2[b] = 0.f;
    for (int k = threadIdx.x; k < K; k += kThreads) {
      const float v = resid[b * K + k] + o[b * K + k];
      xs[b * K + k] = v;
      sum[b] += v;
      sum2[b] += v * v;
    }
    sum[b] = warp_sum(sum[b]);
    sum2[b] = warp_sum(sum2[b]);
    if (lane == 0) {
      red[(warp * R + b) * 2] = sum[b];
      red[(warp * R + b) * 2 + 1] = sum2[b];
    }
  }
  __syncthreads();
#pragma unroll
  for (int b = 0; b < R; ++b) {
    float s1 = 0.f, s2 = 0.f;
    for (int w = 0; w < kWarps; ++w) {  // in warp order: every thread the same bits
      s1 += red[(w * R + b) * 2];
      s2 += red[(w * R + b) * 2 + 1];
    }
    const float mu = s1 / K;
    const float var = fmaxf(s2 / K - mu * mu, 0.f);
    const float rs = rsqrtf(var + 1e-5f);
    for (int k = threadIdx.x; k < K; k += kThreads) {
      const float x32 = (xs[b * K + k] - mu) * rs * g[k] + bb[k];
      const float xt = round_t<T>(x32);
      xs[b * K + k] = xt;
      if (resid_out != nullptr) resid_out[b * K + k] = round_resid ? xt : x32;
    }
  }
  __syncthreads();
}

// q . k_new of (local row b, head h) in fp32, the current position's score,
// in one fixed order (lane-strided products, then the shuffle tree), so that
// every warp that computes it gets the same bits.
template <typename T, int R>
__device__ float current_score(const Block<T, R>& blk, int b, int h) {
  const int dh = blk.c.dh, D = blk.c.H * dh, lane = threadIdx.x & 31;
  const float* q = blk.f(kBufQ) + b * D + h * dh;
  const float* kn = blk.f(kBufKv) + b * 2 * D + h * dh;
  float v = 0.f;
  for (int j = lane; j < dh; j += 32) v += q[j] * kn[j];
  return warp_sum(v);
}

// Attention, stage A: scores of the items (row, head, chunk) this block
// owns.  Item = (b * H + h) * nc + chunk, owned by block item % cluster;
// its keys are [chunk * len, min(.. + len, n_keys)) of the (h, row) cache
// segment.  Scores of q (rounded to T) against the keys, plus bias[row, key]
// when given, into the block's scores; the chunk's max into its own slot
// and every block's kBufPm.  A group of G = dh / vec<T>() threads reads one
// cache row with 16-byte loads, P = kThreads / G rows a pass, kUnroll
// passes in flight.
template <typename T, int R>
__device__ void attn_scores(Block<T, R>& blk, const T* kc, const T* vc, const float* bias,
                            int seg_len, int n_keys, int len, int nc) {
  constexpr int V = vec<T>();
  const Config& c = blk.c;
  const int dh = c.dh, D = c.H * dh;
  const int G = dh / V, P = kThreads / G;
  const int g = threadIdx.x % G, pi = threadIdx.x / G;
  const int n_items = R * c.H * nc;
  for (int item = blk.rank, slot = 0; item < n_items; item += c.cluster, ++slot) {
    const int pair = item / nc, chunk = item - pair * nc;
    const int b = pair / c.H, h = pair - b * c.H;
    const int row = min(blk.row0 + b, c.B - 1);  // a padding row of the last cluster repeats one
    const int k0 = chunk * len;
    const int n = min(len, n_keys - k0);
    const size_t seg = ((static_cast<size_t>(h) * c.B + row) * seg_len + k0) * dh;
    const T* kr = kc + seg;
    const T* vc_item = vc + seg;
    const float* br = bias != nullptr ? bias + static_cast<size_t>(row) * c.tp + k0 : nullptr;
    float* sv = blk.f(kBufScores) + static_cast<size_t>(slot) * c.max_keys;
    const float* qs = blk.f(kBufQ) + b * D + h * dh + g * V;
    float qv[V];
#pragma unroll
    for (int v = 0; v < V; ++v) qv[v] = round_t<T>(qs[v]);
    float m = -3.0e38f;
    for (int p0 = 0; p0 < n; p0 += kUnroll * P) {  // the same trip count in every thread
      float kv[kUnroll][V], bv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int pp = p0 + u * P + pi;
        if (pp < n) {
          load16<T>(kr + static_cast<size_t>(pp) * dh + g * V, kv[u]);
          bv[u] = br != nullptr ? br[pp] : 0.f;
          // the value row's bytes into L1, for stage B of the same block
          prefetch_l1(vc_item + static_cast<size_t>(pp) * dh + g * V);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int pp = p0 + u * P + pi;
        float a = 0.f;
        if (pp < n) {
#pragma unroll
          for (int v = 0; v < V; ++v) a += qv[v] * kv[u][v];
        }
        for (int o = G / 2; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
        if (pp < n) {
          a += bv[u];
          m = fmaxf(m, a);
          if (g == 0) sv[pp] = a;
        }
      }
    }
    m = block_reduce<true>(m, blk.f(kBufRed));
    if (threadIdx.x == 0) blk.f(kBufMloc)[slot] = m;
    blk.share(kBufPm, item, m, threadIdx.x);
  }
}

// The global max of (row, head) `pair` from the shared chunk maxima (nc > 1)
// or the block's own (one chunk), and the current position's score for
// self-attention.  A max is exact: every block gets the same value.
template <typename T, int R>
__device__ float pair_max(const Block<T, R>& blk, int pair, int nc, int slot, bool self,
                          float s_cur, bool own) {
  float m = self ? s_cur : -3.0e38f;
  if (own) return fmaxf(m, blk.f(kBufMloc)[slot]);
  for (int ch = 0; ch < nc; ++ch) m = fmaxf(m, blk.f(kBufPm)[pair * nc + ch]);
  return m;
}

// Attention, stage B: for each item, e = exp(s - m) against the global max
// m of its (row, head), as the reference rounds it; shares l_c = sum e,
// (with_pos) sum e * key, and the context sum over T(e) * v.
template <typename T, int R>
__device__ void attn_values(Block<T, R>& blk, const T* vc, int seg_len, int n_keys, int len,
                            int nc, bool self, bool with_pos) {
  constexpr int V = vec<T>();
  const Config& c = blk.c;
  const int dh = c.dh;
  const int G = dh / V, P = kThreads / G;
  const int g = threadIdx.x % G, pi = threadIdx.x / G;
  float* part = blk.f(kBufPart);
  float* red = blk.f(kBufRed);
  const int n_items = R * c.H * nc;
  for (int item = blk.rank, slot = 0; item < n_items; item += c.cluster, ++slot) {
    const int pair = item / nc, chunk = item - pair * nc;
    const int b = pair / c.H, h = pair - b * c.H;
    const int row = min(blk.row0 + b, c.B - 1);
    const int k0 = chunk * len;
    const int n = min(len, n_keys - k0);
    const T* vr = vc + ((static_cast<size_t>(h) * c.B + row) * seg_len + k0) * dh;
    float* ev = blk.f(kBufScores) + static_cast<size_t>(slot) * c.max_keys;
    float vv[kUnroll][V];  // the first values in flight while the exponentials are taken
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pp = u * P + pi;
      if (pp < n) load16<T>(vr + static_cast<size_t>(pp) * dh + g * V, vv[u]);
    }
    const float s_cur = self ? current_score(blk, b, h) : 0.f;
    const float m = pair_max(blk, pair, nc, slot, self, s_cur, nc == 1);
    float den = 0.f, ps = 0.f;
    for (int pp = threadIdx.x; pp < n; pp += kThreads) {
      const float e = expf(ev[pp] - m);
      ev[pp] = e;
      den += e;
      ps += e * static_cast<float>(k0 + pp);
    }
    den = block_reduce<false>(den, red);  // syncs: ev holds the exponentials
    if (with_pos) ps = block_reduce<false>(ps, red);
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    for (int p0 = 0; p0 < n; p0 += kUnroll * P) {
      if (p0 != 0) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int pp = p0 + u * P + pi;
          if (pp < n) load16<T>(vr + static_cast<size_t>(pp) * dh + g * V, vv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int pp = p0 + u * P + pi;
        if (pp < n) {
          const float ep = round_t<T>(ev[pp]);
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] += ep * vv[u][v];
        }
      }
    }
    // the row groups' sums: across a warp's lanes of the same columns by
    // shuffles, then the warps' in warp order
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int v = 0; v < V; ++v)
      for (int o = G; o < 32; o <<= 1) acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], o);
    if ((threadIdx.x & 31) < G) {
#pragma unroll
      for (int v = 0; v < V; ++v) part[warp * dh + g * V + v] = acc[v];
    }
    __syncthreads();
    float* total = part + kWarps * dh;  // (dh)
    if (threadIdx.x < dh) {
      float cs = 0.f;
      for (int w = 0; w < kWarps; ++w) cs += part[w * dh + threadIdx.x];
      total[threadIdx.x] = cs;
    }
    __syncthreads();
    // thread j * cluster + r stores column j into block r
    for (int i = threadIdx.x; i < dh * c.cluster; i += kThreads)
      dsmem_store(blk.f(kBufPacc) + static_cast<size_t>(item) * dh + i / c.cluster, i % c.cluster,
                  total[i / c.cluster]);
    blk.share(kBufPl, item, den, threadIdx.x);
    blk.share(kBufPpos, item, ps, threadIdx.x);
    __syncthreads();  // part and the scores are reused by the next item
  }
}

// xs (R, D) = T(context) from the shared partials of every (row, head),
// added in chunk order; one warp per (row, head).  Self-attention (self)
// adds the current position in closed form: its score q . k_new with the
// fp32 q, its value v_new in fp32.  With pos_out, block 0 of the cluster
// writes the head-mean expected position of each row.
template <typename T, int R>
__device__ void combine_rows(Block<T, R>& blk, int nc, bool self, float* pos_out) {
  const Config& c = blk.c;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int dh = c.dh, D = c.H * dh;
  const float* pl = blk.f(kBufPl);
  const float* pacc = blk.f(kBufPacc);
  float* xs = blk.f(kBufXs);
  float* posh = blk.f(kBufPosh);
  for (int pair = warp; pair < R * c.H; pair += kWarps) {
    const int b = pair / c.H, h = pair - b * c.H;
    const int base = pair * nc;
    float e_cur = 0.f;
    if (self) {
      const float s_cur = current_score(blk, b, h);
      e_cur = expf(s_cur - pair_max(blk, pair, nc, 0, true, s_cur, false));
    }
    float den = 0.f;
    for (int ch = 0; ch < nc; ++ch) den += pl[base + ch];
    den += e_cur;
    for (int j = lane; j < dh; j += 32) {
      float acc = 0.f;
      for (int ch = 0; ch < nc; ++ch) acc += pacc[static_cast<size_t>(base + ch) * dh + j];
      if (self) acc += e_cur * blk.f(kBufKv)[b * 2 * D + D + h * dh + j];
      xs[b * D + h * dh + j] = round_t<T>(acc / den);
    }
    if (pos_out != nullptr && lane == 0) {
      float ps = 0.f;
      for (int ch = 0; ch < nc; ++ch) ps += blk.f(kBufPpos)[base + ch];
      posh[pair] = ps / den;
    }
  }
  __syncthreads();
  if (pos_out != nullptr && blk.rank == 0 && threadIdx.x < R && blk.row0 + threadIdx.x < c.B) {
    float ps = 0.f;
    for (int h = 0; h < c.H; ++h) ps += posh[threadIdx.x * c.H + h];
    pos_out[blk.row0 + threadIdx.x] = ps / c.H;
  }
}

template <typename T, int R, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1) decode_step_kernel(const Config c, const Step s) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int rank = static_cast<int>(cluster_rank());
  Block<T, R> blk{c, s, smem, rank, static_cast<int>(cluster_index()) * R, 0, 0, nullptr, 0};
  const int n_gs = 3 + 6 * c.L;
  const int D = c.H * c.dh;
  if (s.timeline != nullptr)
    blk.stamps = s.timeline + static_cast<size_t>(blockIdx.x) * (6 + 20 * c.L);

  // the block's plan rows and biases, the LayerNorm parameters of the first
  // two layers and the first weight pieces, all by bulk copy
  uint64_t* ln_bar = &blk.mbar()[c.n_pieces];  // one per layer
  uint64_t* plan_bar = &blk.mbar()[c.n_pieces + c.L];
  // thread 0: layer l's LayerNorm parameters into slot l % 2
  auto copy_ln = [&](int l) {
    const uint32_t bytes = static_cast<uint32_t>(3 * D) * sizeof(float);
    float* slot = blk.f(kBufLn) + static_cast<size_t>(l % 2) * 6 * D;
    mbar_arrive_expect_tx(&ln_bar[l], 2 * bytes);
    bulk_copy_g2s(slot, static_cast<const float*>(c.w[16]) + static_cast<size_t>(l) * 3 * D, bytes,
                  &ln_bar[l]);
    bulk_copy_g2s(slot + 3 * D, static_cast<const float*>(c.w[17]) + static_cast<size_t>(l) * 3 * D,
                  bytes, &ln_bar[l]);
  };
  if (threadIdx.x == 0) {
    if (blk.stamps != nullptr) blk.stamps[0] = global_timer_ns();
    for (int i = 0; i <= c.n_pieces + c.L; ++i) mbar_init(&blk.mbar()[i], 1);
    fence_mbarrier_init();
    const uint32_t stage_bytes = n_gs * 16, piece_bytes = c.n_pieces * 16, bias_bytes = c.n_bias * 4;
    mbar_arrive_expect_tx(plan_bar, stage_bytes + piece_bytes + bias_bytes);
    bulk_copy_g2s(blk.template buf<int4>(kBufStages), c.stages + rank * n_gs * 4, stage_bytes, plan_bar);
    bulk_copy_g2s(blk.template buf<int4>(kBufPieces), c.pieces + rank * c.n_pieces * 4, piece_bytes,
                  plan_bar);
    bulk_copy_g2s(blk.f(kBufBias), c.bias + static_cast<size_t>(rank) * c.n_bias, bias_bytes,
                  plan_bar);
    // piece 0 at once, from the launch's own arguments: prenet 1 need not
    // wait for the plan
    const StageW<T> sw = stage_w<T>(c, 0);
    const int c0 = c.first_piece[rank][0], c1 = c.first_piece[rank][1];
    const uint32_t bytes = static_cast<uint32_t>(c1 - c0) * sw.K * sizeof(T);
    mbar_arrive_expect_tx(&blk.mbar()[0], bytes);
    bulk_copy_g2s(blk.template buf<uint8_t>(kBufRing), sw.W + static_cast<size_t>(c0) * sw.K,
                  bytes, &blk.mbar()[0]);
    copy_ln(0);
    if (c.L > 1) copy_ln(1);
  }
  // prenet 1: frame -> act, ReLU
  float* xs = blk.f(kBufXs);
  for (int i = threadIdx.x; i < R * c.n_mels; i += kThreads) {
    const int b = i / c.n_mels, k = i - b * c.n_mels;
    const int row = min(blk.row0 + b, c.B - 1);
    xs[i] = round_t<T>(s.frame[static_cast<size_t>(row) * s.frame_stride + k]);
  }
  __syncthreads();  // the mbarriers are initialised, xs holds the frame
  mbar_wait(plan_bar, 0);
  // the other pieces of the first two stages now, the rest after prenet 1
  blk.next_issue = 1;
  const int early = blk.stage_rows()[2].x;
  blk.issue_after(-1, early);
  cluster_arrive_relaxed();  // waited for before the first store into another block

  cluster_wait();
  gemv<T, R, kDrop ? kEpiDrop1 : kEpiRelu>(blk, 0, kBufXs, kBufAct);
  blk.issue_after(-1);
  blk.sync();
  // prenet 2: act -> residual = T(Drop(ReLU(.)) + alpha * PE[t])
  gemv<T, R, kDrop ? kEpiDrop2 : kEpiReluPe>(blk, 1, kBufAct, kBufRa);
  blk.sync();

  const bool self_attn = s.t > 0;
  const T* self_k = static_cast<const T*>(s.self_k);
  const T* self_v = static_cast<const T*>(s.self_v);
  const size_t lsz = static_cast<size_t>(c.H) * c.B * c.n_pos * c.dh;
  const size_t csz = static_cast<size_t>(c.H) * c.B * c.tp * c.dh;
  for (int l = 0; l < c.L; ++l) {
    const int gs = 2 + 6 * l;
    // q|k|v; input: prenet 2 (layer 0) or T(LN3(residual + o)) of the
    // previous layer, which becomes the residual
    if (l > 0) layer_norm_rows<T, R>(blk, blk.f(kBufRa), l - 1, 2, blk.f(kBufRa), true);
    gemv<T, R, kEpiQkv>(blk, gs, l == 0 ? kBufRa : kBufXs, kBufQ, l);
    // slot (l + 1) % 2 held layer l - 1, whose last LayerNorm was just read
    if (threadIdx.x == 0 && l >= 1 && l + 1 < c.L) {
      fence_proxy_async_shared();
      copy_ln(l + 1);
    }
    blk.sync();
    mbar_wait(&ln_bar[l], 0);
    if (self_attn) {
      attn_scores<T, R>(blk, self_k + l * lsz, self_v + l * lsz, nullptr, c.n_pos, s.t,
                        s.self_chunk, s.self_nc);
      if (s.self_nc > 1)
        blk.sync();
      else
        __syncthreads();  // the block's own scores and max
      attn_values<T, R>(blk, self_v + l * lsz, c.n_pos, s.t, s.self_chunk, s.self_nc, true, false);
      blk.sync();
    }
    // self out-projection -> o
    combine_rows<T, R>(blk, self_attn ? s.self_nc : 0, true, nullptr);
    gemv<T, R, kEpiF32>(blk, gs + 1, kBufXs, kBufO);
    blk.sync();
    // cross q; prologue LN1(residual + o) -> the second residual (fp32)
    layer_norm_rows<T, R>(blk, blk.f(kBufRa), l, 0, blk.f(kBufRb), false);
    gemv<T, R, kEpiScale>(blk, gs + 2, kBufXs, kBufQ);
    blk.sync();
    const bool with_pos = s.pos != nullptr && l == c.L - 1;
    const T* ck = static_cast<const T*>(s.cross_k) + l * csz;
    const T* cv = static_cast<const T*>(s.cross_v) + l * csz;
    attn_scores<T, R>(blk, ck, cv, s.cross_bias, c.tp, c.tp, c.cross_chunk, c.cross_nc);
    if (c.cross_nc > 1)
      blk.sync();
    else
      __syncthreads();
    attn_values<T, R>(blk, cv, c.tp, c.tp, c.cross_chunk, c.cross_nc, false, with_pos);
    blk.sync();
    // cross out-projection -> o
    combine_rows<T, R>(blk, c.cross_nc, false, with_pos ? s.pos : nullptr);
    gemv<T, R, kEpiF32>(blk, gs + 3, kBufXs, kBufO);
    blk.sync();
    // FFN 1; prologue LN2(second residual + o) -> the residual (fp32)
    layer_norm_rows<T, R>(blk, blk.f(kBufRb), l, 1, blk.f(kBufRa), false);
    gemv<T, R, kEpiRelu>(blk, gs + 4, kBufXs, kBufAct);
    blk.sync();
    // FFN 2 -> o
    gemv<T, R, kEpiF32>(blk, gs + 5, kBufAct, kBufO);
    blk.sync();
  }

  // fused mel|stop head; prologue LN3(residual + o) of the last layer
  layer_norm_rows<T, R>(blk, blk.f(kBufRa), c.L - 1, 2, nullptr, false);
  gemv<T, R, kEpiOut>(blk, n_gs - 1, kBufXs, kBufO);
  if (blk.stamps != nullptr) {
    __syncthreads();
    if (threadIdx.x == 0) blk.stamps[1 + 2 * blk.n_sync] = global_timer_ns();
  }
}

template <typename T, int R, bool kDrop>
int launch(const Config& c, const Step& s, cudaStream_t stream) {
  auto fn = decode_step_kernel<T, R, kDrop>;
  static int opted = 0;  // dynamic shared memory this instantiation may take
  if (c.smem_bytes > opted) {
    cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, c.smem_bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = c.smem_bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((c.B + R - 1) / R * c.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(c.smem_bytes);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, fn, c, s));
}

template <typename T, bool kDrop>
int dispatch(const Config& c, const Step& s, cudaStream_t stream) {
  switch (c.R) {
    case 1: return launch<T, 1, kDrop>(c, s, stream);
    case 2: return launch<T, 2, kDrop>(c, s, stream);
    case 3: return launch<T, 3, kDrop>(c, s, stream);
    case 4: return launch<T, 4, kDrop>(c, s, stream);
    case 5: return launch<T, 5, kDrop>(c, s, stream);
    case 6: return launch<T, 6, kDrop>(c, s, stream);
    case 7: return launch<T, 7, kDrop>(c, s, stream);
    case 8: return launch<T, 8, kDrop>(c, s, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Chunks of `len` keys, nc of them, that cover [0, n_keys) once.
bool chunks_cover(int n_keys, int len, int nc) {
  if (n_keys == 0) return true;
  return len > 0 && nc > 0 && static_cast<long>(len) * nc >= n_keys &&
         static_cast<long>(len) * (nc - 1) < n_keys;
}

}  // namespace

extern "C" {

// sizeof(Config), for the wrapper's check of its mirror.
long tts_decode_step_config_bytes() { return static_cast<long>(sizeof(Config)); }

#ifndef TTS_DECODE_STEP_VERIFY  // decode_step_verify.cu has an entry point of its own

// Clusters of `cluster` blocks of the rows-per-cluster instantiation R that
// the card can hold at once with `smem_bytes` of dynamic shared memory a
// block (0 when none).
int tts_decode_step_max_clusters(int is_bf16, int R, int smem_bytes, int cluster) {
  if (R < 1 || R > kMaxRows || cluster < 1 || cluster > kMaxCluster) return 0;
  void (*fns[2][kMaxRows])(const Config, const Step) = {
      {decode_step_kernel<float, 1, kLibDrop>, decode_step_kernel<float, 2, kLibDrop>,
       decode_step_kernel<float, 3, kLibDrop>, decode_step_kernel<float, 4, kLibDrop>,
       decode_step_kernel<float, 5, kLibDrop>, decode_step_kernel<float, 6, kLibDrop>,
       decode_step_kernel<float, 7, kLibDrop>, decode_step_kernel<float, 8, kLibDrop>},
      {decode_step_kernel<bf16, 1, kLibDrop>, decode_step_kernel<bf16, 2, kLibDrop>,
       decode_step_kernel<bf16, 3, kLibDrop>, decode_step_kernel<bf16, 4, kLibDrop>,
       decode_step_kernel<bf16, 5, kLibDrop>, decode_step_kernel<bf16, 6, kLibDrop>,
       decode_step_kernel<bf16, 7, kLibDrop>, decode_step_kernel<bf16, 8, kLibDrop>}};
  auto fn = fns[is_bf16 ? 1 : 0][R - 1];
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes) !=
          cudaSuccess ||
      cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) != cudaSuccess)
    return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, fn, &cfg) != cudaSuccess) return 0;
  return n;
}

// One decoder step, one launch.  `config` is the prepared step's Config
// (host memory); the rest as Step (timeline: null, or B / R * cluster x
// (6 + 20 L) stamps; drop_threshold 0 in this file's library, > 0 in the
// dropout library).  Returns the launch's CUDA error code, or
// cudaErrorInvalidValue for arguments the kernel cannot take.
int tts_decode_step(const void* config, int is_bf16, int t, int self_chunk, int self_nc,
                    unsigned drop_threshold, float drop_scale, unsigned drop_seed, int drop_row0,
                    const void* frame, int frame_stride, const void* pe_row,
                    const void* cross_bias, void* self_k, void* self_v, const void* cross_k,
                    const void* cross_v, void* y, void* k_new, void* v_new, void* pos,
                    void* timeline, void* stream) {
  const Config& c = *static_cast<const Config*>(config);
  const int V = is_bf16 ? 8 : 4;
  const int groups = c.dh / V;
  const int n_gs = 3 + 6 * c.L;
  const int rh = c.R * c.H;
  const int nc_max = c.cluster / rh > 1 ? c.cluster / rh : 1;
  if (c.cluster < 1 || c.cluster > kMaxCluster || c.B < 1 || c.B > kMaxRows || c.R < 1 || c.R > c.B || t < 0 || t >= c.n_pos ||
      (drop_threshold != 0u) != kLibDrop || drop_row0 < 0 ||
      c.n_pieces > kMaxPieces || c.dh % V != 0 || groups > 32 || (groups & (groups - 1)) != 0 ||
      !chunks_cover(t, self_chunk, self_nc) || !chunks_cover(c.tp, c.cross_chunk, c.cross_nc) ||
      c.nc_max != nc_max || self_nc > nc_max || c.cross_nc > nc_max ||
      c.max_keys < c.n_pos || c.max_keys < c.tp || n_gs > kMaxStages)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (c.smem_bytes > optin) return static_cast<int>(cudaErrorInvalidValue);
  Step s;
  s.t = t;
  s.self_chunk = self_chunk;
  s.self_nc = self_nc;
  s.frame_stride = frame_stride;
  s.drop_threshold = drop_threshold;
  s.drop_seed = drop_seed;
  s.drop_row0 = drop_row0;
  s.drop_scale = drop_scale;
  s.frame = static_cast<const float*>(frame);
  s.pe_row = static_cast<const float*>(pe_row);
  s.cross_bias = static_cast<const float*>(cross_bias);
  s.self_k = self_k;
  s.self_v = self_v;
  s.cross_k = cross_k;
  s.cross_v = cross_v;
  s.y = static_cast<float*>(y);
  s.k_new = k_new;
  s.v_new = v_new;
  s.pos = static_cast<float*>(pos);
  s.timeline = static_cast<unsigned long long*>(timeline);
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<bf16, kLibDrop>(c, s, st) : dispatch<float, kLibDrop>(c, s, st);
}
#endif  // TTS_DECODE_STEP_VERIFY

}  // extern "C"
