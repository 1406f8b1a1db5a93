// The verify pass of speculative decoding (the JAX package's
// transformertts_tpu/infer/decode.py:_speculative_decode, which runs it on
// XLA only) for Hopper (sm_90a), as ONE launch of one cluster of 16 blocks:
// decode_verify_kernel<T, K> runs a decoder step for K = 2..8 consecutive
// positions t .. t + K - 1 of one utterance, drafts their inputs, accepts
// the leading run of drafts and writes the accepted frames.  It shares the
// step's stage chain, plan, weight ring and shared-memory buffers
// (decode_step.cu, included; its header says how a step runs) and is built
// as a library of its own, so that the step's kernels keep their code.
// ops/decode_step.py:DecodeVerify prepares and launches it; the plain
// version is verify_pass_reference there.
//
// Row j's input is the draft f0 + j (f0 - prev) (row 0 the true frame f0),
// its PE row alpha*PE[t + j]; Config::B is 1 (the caches' one row), and row
// j writes its K/V at t + j.  Self-attention of row j covers the cached
// prefix [0, t) and, in closed form from the fresh k | v of kBufKv, the
// pass's own positions t .. t + j.
//
// Bound: bytes, as a step's.  A pass reads every decoder weight once for
// all K positions, and the cache prefix and the cross K/V once each; it
// writes K rows of K/V and at most K groups of frames.  What costs is the
// chain of about 10 L dependent stages, and what K adds to each.  The
// design spends K rows where one row costs about as much:
//
// - Matrix-vector stages as K-row products.  bf16: on the tensor cores,
//   mma.sync m16n8k16 (bf16 in, fp32 sums): A is 16 weight rows (output
//   columns) of the block's piece in the ring, B the K positions' inputs
//   (padded to 8 columns) in bf16 (they are rounded to T already, so the
//   bf16 copy is exact).  A warp takes a
//   16-column tile and a slice of the depth; the warps' partial tiles are
//   added in warp order (no atomics).  mma.sync over wgmma: a block owns 16
//   to 256 columns of a stage, so a 64-row wgmma tile would be mostly
//   padding, and the fragments come from ldmatrix on the ring as it is.
//   The weights of this pass are a copy with 8 more elements a row
//   (pack_verify_weights, made once per weights version), so that the 8
//   rows of an ldmatrix lie 16 bytes (K / 8 + 1 chunks, an odd number) apart
//   in the banks.  fp32 stays on the CUDA cores (TF32 would not keep fp32
//   parity): a warp takes two columns and reduces the 2 K partial sums of
//   its lanes together with a transposed butterfly (xor masks 16, 8, 4, 2,
//   1 in that order: 9 shuffles at K = 4 where per-row trees take 40),
//   which adds every sum in warp_sum's order, so each keeps its bits.
//   Either way a stage's results go first into a staging buffer, then to
//   every block of the cluster as 16-byte stores, four columns of a row at
//   a time, spread over all the block's threads (a warp that stores many
//   into other blocks is slow, and the cluster's shared-memory network is
//   what a stage's broadcast is bound by); prenet 1's and FFN 1's outputs
//   travel in bf16, in the layout the next stage's tensor cores read, and
//   the LayerNorm and the attention combine write their output in bf16
//   where the next stage reads it, so that no stage copies its inputs.
//   Sums over warps or slices load every partial first and add them in a
//   fixed order, or run a shuffle tree, instead of a chain of dependent
//   loads.
// - Attention items (head, chunk) that score all K queries: each key and
//   value is read once for the K rows, the keys cut into chunks of at least
//   64 (verify_chunks) so that a prefix of a few hundred keys is spread
//   over the cluster, not scored by one block a head.  The scores of the
//   fresh positions (q of row b against k of row i <= b, fp32) are computed
//   once a layer in every block; each row's max folds them in, and the
//   combine adds them in closed form.  The chunked-softmax order stays the
//   step's: e = exp(s - m) against the global max, the chunks added in chunk
//   order.
// - The acceptance spread over the cluster: in the head stage each block
//   compares its own head columns with the drafts and stores each row's max
//   error and stop vote into every block; after the last barrier every block
//   derives m from them alike and writes its own columns of the m accepted
//   groups; block 0 writes 2 m + vote.

#define TTS_DECODE_STEP_VERIFY
#include "decode_step.cu"

namespace {

constexpr int kTile = 16;    // output columns of one tensor-core product
constexpr int kMaxSegs = 16;  // key segments of attention's value products, at most

// The pass's shared-memory buffers besides the step's (Step::voff holds
// their byte offsets; the layout is ops/decode_step.py:verify_smem_layout).
// kBufPart holds attention's partial sums, or in a matrix-vector stage the
// bf16 inputs and the warps' partial tiles.
enum VerifyBuffer {
  kVFresh,  // (H, R, R) scores of row b's q against row i's fresh k
  kVStage,  // (R, the block's columns) a matrix-vector stage's results
  kVFlags,  // (cluster, 2 R) each block's max draft error | stop vote per row
};

template <typename T, int R>
__device__ __forceinline__ float* vbuf(const Block<T, R, true>& blk, VerifyBuffer b) {
  return reinterpret_cast<float*>(blk.smem + blk.s.voff[b]);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 8 / 2 bytes into the shared memory of block `rank` of the cluster, at the
// offset `local` has in this block (8- / 2-byte aligned).
__device__ __forceinline__ void dsmem_store8(const void* local, uint32_t rank, uint2 v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(local)), "r"(rank));
  asm volatile("st.shared::cluster.v2.b32 [%0], {%1, %2};\n" ::"r"(remote), "r"(v.x), "r"(v.y) : "memory");
}
__device__ __forceinline__ void dsmem_store2(const void* local, uint32_t rank, uint16_t v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(local)), "r"(rank));
  asm volatile("st.shared::cluster.b16 [%0], %1;\n" ::"r"(remote), "h"(v) : "memory");
}

// bf16 pair (lo, hi) as 32 bits
__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Four 8 x 8 bf16 matrices from shared memory (lanes 8 i .. 8 i + 7 give
// matrix i's row addresses), as mma's A fragment.
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// Two, as mma's B fragment (lanes 0 .. 15 give the row addresses).
__device__ __forceinline__ void ldmatrix_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}
// d (16 x 8, fp32) += a (16 x 16, bf16, rows) b (16 x 8, bf16, columns).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The NV (a power of two, at most 32) values of every lane summed over the
// warp at once: a butterfly over the xor masks 16, 8, ..., 1 in that order
// in which, while a lane holds more than one value, it keeps one half of
// them (the upper half when its mask bit is set), adds its partner's of
// that half and hands over the other.  Each sum is added up as warp_sum
// adds one value (own + partner at every mask), so it has warp_sum's bits.
// The lane's sum is left in v[0]; returns the index of its value.
template <int N, int M, int NV>
__device__ __forceinline__ int transposed_step(float (&v)[NV], int lane) {
  if constexpr (N > 1) {  // N values left, mask M
    const bool upper = (lane & M) != 0;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float keep = upper ? v[i + N / 2] : v[i];
      const float give = upper ? v[i] : v[i + N / 2];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, give, M);
    }
    return (upper ? N / 2 : 0) + transposed_step<N / 2, M / 2>(v, lane);
  } else {
#pragma unroll
    for (int m = M; m > 0; m /= 2) v[0] += __shfl_xor_sync(0xffffffffu, v[0], m);
    return 0;
  }
}
template <int NV>
__device__ __forceinline__ int transposed_sum(float (&v)[NV], int lane) {
  return transposed_step<NV, 16>(v, lane);
}

// R rows as a power of two, and the lanes that write a transposed_sum of NV
// values (of the 32 / NV lanes that hold each sum, the lowest)
template <int R>
__host__ __device__ constexpr int pow2_rows() {
  return R <= 2 ? 2 : R <= 4 ? 4 : 8;
}
template <int NV>
__device__ __forceinline__ bool sum_writer(int lane) {
  return (lane & (32 / NV - 1)) == 0;
}

// Element (b, k) of a matrix-vector stage's input of depth D, in bf16 in
// kBufPart (rows D + row_pad apart) where the stage reads it: written by
// the LayerNorm and the attention combine that produce the input, so that
// the stage need not copy it (fp32 stages read xs as it is).
template <typename T, int R>
__device__ __forceinline__ void stage_input(const Block<T, R, true>& blk, int b, int k, float v) {
  if constexpr (sizeof(T) == 2)
    blk.template buf<bf16>(kBufPart)[b * (blk.c.H * blk.c.dh + row_pad<T, true>()) + k] =
        __float2bfloat16(v);
}

// xs (R, K) = T(LN(resid + o)) with fp32 statistics, LayerNorm `norm`
// (0..2) of `layer`, as layer_norm_rows for the pass's R rows: each
// thread's sums of x and x^2 of its columns of every row, then the 2 R sums
// of a warp at once (transposed_sum), then warp b adds row b's of the warps
// (a lane a warp, the shuffle tree) into its statistics; resid_out (a
// block's own buffer, or null; resid itself may be it) keeps the LN output
// (rounded to T when round_resid) as the next residual; stage_input has it
// too.
template <typename T, int R>
__device__ void verify_layer_norm(Block<T, R, true>& blk, const float* resid, int layer, int norm,
                                  float* resid_out, bool round_resid) {
  constexpr int RP = pow2_rows<R>(), NV = 2 * RP;
  const int K = blk.c.H * blk.c.dh;
  const float* g = blk.f(kBufLn) + static_cast<size_t>(layer % 2) * 6 * K + norm * K;
  const float* bb = g + 3 * K;
  const float* o = blk.f(kBufO);
  float* xs = blk.f(kBufXs);
  float* red = blk.f(kBufRed);  // (kWarps, NV) the warps' sums, then (mean, 1 / sigma) a row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float v[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = 0.f;
  for (int k = threadIdx.x; k < K; k += kThreads) {
#pragma unroll
    for (int b = 0; b < R; ++b) {
      const float x = resid[b * K + k] + o[b * K + k];
      xs[b * K + k] = x;
      v[b] += x;
      v[RP + b] += x * x;
    }
  }
  const int at = transposed_sum<NV>(v, lane);
  if (sum_writer<NV>(lane)) red[warp * NV + at] = v[0];
  __syncthreads();
  if (warp < R) {  // warp b: row b's sums over the warps, its mean and 1 / sigma
    float t1 = lane < kWarps ? red[lane * NV + warp] : 0.f;
    float t2 = lane < kWarps ? red[lane * NV + RP + warp] : 0.f;
#pragma unroll
    for (int m = 16; m > 0; m /= 2) {
      t1 += __shfl_xor_sync(0xffffffffu, t1, m);
      t2 += __shfl_xor_sync(0xffffffffu, t2, m);
    }
    if (lane == 0) {
      const float mu = t1 / K;
      red[kWarps * NV + 2 * warp] = mu;
      red[kWarps * NV + 2 * warp + 1] = rsqrtf(fmaxf(t2 / K - mu * mu, 0.f) + 1e-5f);
    }
  }
  __syncthreads();
  const float* stats = red + kWarps * NV;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const float gk = g[k], bk = bb[k];
#pragma unroll
    for (int b = 0; b < R; ++b) {
      const float x32 = (xs[b * K + k] - stats[2 * b]) * stats[2 * b + 1] * gk + bk;
      const float xt = round_t<T>(x32);
      xs[b * K + k] = xt;
      stage_input(blk, b, k, xt);
      if (resid_out != nullptr) resid_out[b * K + k] = round_resid ? xt : x32;
    }
  }
  __syncthreads();
}

// Row j's input, the draft f0 + j (f0 - prev) at column k, in fp32 with
// each operation rounded as the wrapper's plain version rounds it.
__device__ __forceinline__ float draft(const Step& s, int j, int k) {
  return __fadd_rn(s.frame[k], __fmul_rn(static_cast<float>(j), __fsub_rn(s.frame[k], s.prev[k])));
}

// The block's columns [col0, col1) of stage gs, and where column n of row
// b lies in the staging buffer: b * stride + n - base (base = col0 rounded
// down to 4, the stride a multiple of 4, so that four columns from a
// multiple of 4 are one 16-byte vector).
struct Cols {
  int col0, col1, base, stride;
};
template <typename T, int R>
__device__ Cols stage_cols(const Block<T, R, true>& blk, int gs) {
  const int4 st = blk.stage_rows()[gs];
  if (st.x == st.y) return {0, 0, 0, 0};
  const int c0 = blk.piece_rows()[st.x].x, c1 = blk.piece_rows()[st.y - 1].y;
  return {c0, c1, c0 & ~3, (c1 - (c0 & ~3) + 3) & ~3};
}

// Elements a row of kBufAct holds in bf16 (prenet 1's and FFN 1's outputs,
// the bf16 inputs of prenet 2 and FFN 2; fp32 passes keep it in fp32).
__device__ __forceinline__ int act_ld(const Config& c) {
  return (c.H * c.dh > c.F ? c.H * c.dh : c.F) + row_pad<bf16, true>();
}

// Column n's value of row b (bias added) as stage kEpi hands it on: into
// the staging slot `to`, and for kEpiQkv's k | v columns also into the
// cache at t + b and k_new / v_new (L, H, R, dh); kEpiOut also into y.
template <typename T, int R, int kEpi>
__device__ __forceinline__ void verify_epilogue(const Block<T, R, true>& blk, int layer, int N, int n,
                                                int b, float v, float* to) {
  const Config& c = blk.c;
  const Step& s = blk.s;
  const int D = c.H * c.dh;
  if constexpr (kEpi == kEpiOut) {
    s.y[b * N + n] = v;
    *to = v;
  } else if constexpr (kEpi == kEpiF32) {
    *to = v;
  } else if constexpr (kEpi == kEpiRelu) {  // rounded: only a matrix-vector stage reads it
    *to = round_t<T>(fmaxf(v, 0.f));
  } else if constexpr (kEpi == kEpiReluPe) {  // row b's PE row is alpha*PE[t + b]
    *to = round_t<T>(fmaxf(v, 0.f) + s.pe_row[b * N + n]);
  } else if constexpr (kEpi == kEpiScale) {
    *to = v * c.scale;
  } else {  // kEpiQkv: N = 3D, columns q | k | v
    if (n < D) {
      *to = v * c.scale;
    } else {
      *to = v;
      const int m = n - D, which = m / D, h = (m % D) / c.dh, j = m % c.dh;
      const T tv = from_f<T>(v);
      const size_t lsz = static_cast<size_t>(c.H) * c.n_pos * c.dh;
      T* cache = static_cast<T*>(which ? s.self_v : s.self_k) + layer * lsz;
      T* fresh = static_cast<T*>(which ? s.v_new : s.k_new) + static_cast<size_t>(layer) * c.H * R * c.dh;
      cache[(static_cast<size_t>(h) * c.n_pos + s.t + b) * c.dh + j] = tv;
      fresh[(static_cast<size_t>(h) * R + b) * c.dh + j] = tv;
    }
  }
}

// The staged results of the block's columns to buffer `out` of every block
// of the cluster (kEpiQkv: q to kBufQ, k | v to kBufKv), four columns of a
// row in one 16-byte store where all four are the block's; bf16 kEpiRelu
// (to kBufAct) in bf16, rows act_ld apart, four columns in 8 bytes.
template <typename T, int R, int kEpi>
__device__ void verify_broadcast(const Block<T, R, true>& blk, Buffer out, int N, const Cols& cs) {
  const Config& c = blk.c;
  const int D = c.H * c.dh;
  const float* stg = vbuf(blk, kVStage);
  const int groups = cs.stride / 4;
  for (int i = threadIdx.x; i < R * groups * c.cluster; i += kThreads) {
    const int dst = i % c.cluster, e = i / c.cluster;
    const int b = e / groups, n = cs.base + 4 * (e - b * groups);
    if constexpr (kEpi == kEpiRelu && sizeof(T) == 2) {
      const float* from = stg + b * cs.stride + n - cs.base;
      bf16* to16 = blk.template buf<bf16>(kBufAct) + b * act_ld(c) + n;
      if (n >= cs.col0 && n + 4 <= cs.col1) {
        dsmem_store8(to16, dst, make_uint2(bf16x2_bits(from[0], from[1]), bf16x2_bits(from[2], from[3])));
      } else {
        for (int j = 0; j < 4; ++j)
          if (n + j >= cs.col0 && n + j < cs.col1)
            dsmem_store2(to16 + j, dst, __bfloat16_as_ushort(__float2bfloat16(from[j])));
      }
      continue;
    }
    float* to;
    if constexpr (kEpi == kEpiQkv)
      to = n < D ? blk.f(kBufQ) + b * D + n : blk.f(kBufKv) + b * 2 * D + n - D;
    else
      to = blk.f(out) + b * N + n;
    const float* from = stg + b * cs.stride + n - cs.base;
    if (n >= cs.col0 && n + 4 <= cs.col1) {
      dsmem_store4(to, dst, *reinterpret_cast<const float4*>(from));
    } else {
      for (int j = 0; j < 4; ++j)
        if (n + j >= cs.col0 && n + j < cs.col1) dsmem_store(to + j, dst, from[j]);
    }
  }
}

// In the head stage: warp j takes row j over the block's head columns, its
// max |draft_j - the last frame of group j - 1| (j >= 1) and whether any of
// its stop logits has sigmoid >= stop_threshold, and stores both into
// every block's kVFlags at this block's rank.
template <typename T, int R>
__device__ void verify_head_flags(const Block<T, R, true>& blk, const Cols& cs) {
  const Config& c = blk.c;
  const Step& s = blk.s;
  const int nm = c.n_mels, r = s.r;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* stg = vbuf(blk, kVStage);
  float* flags = vbuf(blk, kVFlags) + blk.rank * 2 * R;
  if (warp < R) {
    const int j = warp;
    float err = 0.f;
    bool vote = false;
    for (int n = cs.col0 + lane; n < cs.col1; n += 32) {
      if (j > 0 && n >= (r - 1) * nm && n < r * nm)
        err = fmaxf(err, fabsf(__fsub_rn(draft(s, j, n - (r - 1) * nm),
                                         stg[(j - 1) * cs.stride + n - cs.base])));
      if (n >= r * nm)
        vote |= __frcp_rn(1.f + expf(-stg[j * cs.stride + n - cs.base])) >= s.stop_threshold;
    }
    err = warp_max(err);
    vote = __any_sync(0xffffffffu, vote);
    if (lane < c.cluster) {
      dsmem_store(flags + j, lane, err);
      dsmem_store(flags + R + j, lane, vote ? 1.f : 0.f);
    }
  }
}

// Matrix-vector stage gs: xs (R, K) from buffer `in` (bf16: kBufAct as it
// is, else copied into kBufPart first unless `staged`: stage_input wrote it) against the
// block's weight pieces in the ring; each result, with its bias, through
// verify_epilogue into the staging buffer, then to every block (or, the
// head, into the acceptance's flags).
template <typename T, int R, int kEpi>
__device__ void verify_gemv(Block<T, R, true>& blk, int gs, Buffer in, Buffer out, bool staged,
                            int layer = 0) {
  const Config& c = blk.c;
  const int4 st = blk.stage_rows()[gs];
  const StageW<T> sw = stage_w<T, row_pad<T, true>()>(c, gs);
  const int K = sw.K, N = sw.N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* bias_s = blk.f(kBufBias) + st.z;
  const Cols cs = stage_cols(blk, gs);
  float* stg = vbuf(blk, kVStage);
  const float* xs = blk.f(in);
  const uint8_t* ring = blk.template buf<uint8_t>(kBufRing);
  if constexpr (sizeof(T) == 2) {
    const int ld = K + row_pad<T, true>();
    const int D = c.H * c.dh;
    bf16* x16 = blk.template buf<bf16>(kBufPart);  // (R, ld): the inputs in bf16
    // 2 x (kWarps, 16 columns, R rows), past the widest x16
    float* slots = reinterpret_cast<float*>(x16 + R * ((D > c.n_mels ? D : c.n_mels) + row_pad<T, true>()));
    // B: kBufAct in bf16 as prenet 1 and FFN 1 left it, or x16
    const bool from_act = in == kBufAct;
    const bf16* b16 = from_act ? blk.template buf<bf16>(kBufAct) : x16;
    const int bld = from_act ? act_ld(c) : ld;
    if (!staged && !from_act) {
      for (int i = threadIdx.x; i < R * K / 2; i += kThreads) {
        const int b = i / (K / 2), k = 2 * (i - b * (K / 2));
        const float2 v = *reinterpret_cast<const float2*>(xs + b * K + k);
        *reinterpret_cast<__nv_bfloat162*>(x16 + b * ld + k) = __floats2bfloat162_rn(v.x, v.y);
      }
      __syncthreads();
    }
    const int nk = K / kTile;
    // B rows 0 .. 7 (a row past R repeats row R - 1; its columns of the
    // product are not read), 8 columns of depth from lane 8 on
    const uint32_t b_addr =
        smem_u32(b16) + static_cast<uint32_t>(min(lane & 7, R - 1) * bld + ((lane >> 3) & 1) * 8) * 2;
    for (int pc = st.x; pc < st.y; ++pc) {
      const int4 p = blk.piece_rows()[pc];
      const int ncols = p.y - p.x, nt = (ncols + kTile - 1) / kTile;
      const int ks = min(max(1, kWarps / nt), nk);  // depth slices a tile
      float* slot = slots + (pc & 1) * kWarps * kTile * R;
      mbar_wait(&blk.mbar()[pc], 0);
      if (warp < nt * ks) {
        const int tile = warp / ks, part = warp - tile * ks;
        // A: this lane's row of the tile (a row past the piece repeats its
        // last; its row of the product is not read), depth 8 on from lane 16
        const int row = min(tile * kTile + (lane & 7) + ((lane >> 3) & 1) * 8, ncols - 1);
        const uint32_t a_addr =
            smem_u32(ring + p.z) + static_cast<uint32_t>(row * ld + (lane >> 4) * 8) * 2;
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        const int k1 = (part + 1) * nk / ks;
        for (int kk = part * nk / ks; kk < k1; ++kk) {
          uint32_t a[4], b0, b1;
          ldmatrix_x4(a_addr + kk * 2 * kTile, a);
          ldmatrix_x2(b_addr + kk * 2 * kTile, b0, b1);
          mma_bf16(d, a, b0, b1);
        }
        // d[i]: column lane / 4 + 8 (i / 2), row 2 (lane % 4) + i % 2
        const int j = 2 * (lane & 3);
        float* o = slot + warp * kTile * R + (lane >> 2) * R + j;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (j + i % 2 < R) o[8 * R * (i / 2) + i % 2] = d[i];
      }
      __syncthreads();  // every warp done with the piece; the partial tiles written
      if (blk.next_issue < c.n_pieces && blk.piece_rows()[blk.next_issue].w <= pc) blk.issue_after(pc);
      // the depth slices in order (the other slot takes the next piece's)
      // from the last warp down: warp 0 issues the ring's next copies meanwhile
      for (int i = kThreads - 1 - threadIdx.x; i < ncols * R; i += kThreads) {
        const int col = i / R, b = i - col * R;
        const int tile = col / kTile;
        const float* sp = slot + (tile * ks * kTile + col - tile * kTile) * R + b;
        float sl[kWarps];  // every slice's partial first, then their sum in order
#pragma unroll
        for (int q = 0; q < kWarps; ++q) sl[q] = q < ks ? sp[q * kTile * R] : 0.f;
        float v = 0.f;
#pragma unroll
        for (int q = 0; q < kWarps; ++q)
          if (q < ks) v += sl[q];
        const int n = p.x + col;
        verify_epilogue<T, R, kEpi>(blk, layer, N, n, b, v + bias_s[n - cs.col0],
                                    stg + b * cs.stride + n - cs.base);
      }
    }
  } else {
    constexpr int RP = pow2_rows<R>(), NV = 2 * RP;  // two columns' rows
    constexpr int V = vec<T>();
    for (int pc = st.x; pc < st.y; ++pc) {
      const int4 p = blk.piece_rows()[pc];
      mbar_wait(&blk.mbar()[pc], 0);
      const T* piece = reinterpret_cast<const T*>(ring + p.z);
      // two columns a warp at a time, their loads interleaved, as a step's
      for (int n0 = p.x + warp; n0 < p.y; n0 += 2 * kWarps) {
        const int n1 = n0 + kWarps;
        const bool two = n1 < p.y;  // the same in the whole warp
        const T* wr0 = piece + static_cast<size_t>(n0 - p.x) * K;
        const T* wr1 = piece + static_cast<size_t>((two ? n1 : n0) - p.x) * K;
        float acc[NV];
#pragma unroll
        for (int i = 0; i < NV; ++i) acc[i] = 0.f;
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
            acc[b] += s0;
            acc[RP + b] += s1;
          }
        }
        const int at = transposed_sum<NV>(acc, lane);
        const int col = at / RP, b = at - col * RP;
        if (sum_writer<NV>(lane) && b < R && (col == 0 || two)) {
          const int n = col ? n1 : n0;
          verify_epilogue<T, R, kEpi>(blk, layer, N, n, b, acc[0] + bias_s[n - cs.col0],
                                      stg + b * cs.stride + n - cs.base);
        }
      }
      // a piece whose ring bytes the next copy takes: every warp done with it first
      if (blk.next_issue < c.n_pieces && blk.piece_rows()[blk.next_issue].w <= pc) {
        __syncthreads();
        blk.issue_after(pc);
      }
    }
  }
  __syncthreads();  // the staging buffer holds the block's columns
  if constexpr (kEpi == kEpiOut)
    verify_head_flags(blk, cs);
  else
    verify_broadcast<T, R, kEpi>(blk, out, N, cs);
}

// After the qkv stage: kVFresh (H, R, R) = q of row b (fp32, scaled) . k of
// row i (fp32) for every head, four lanes a score in one fixed order.
template <typename T, int R>
__device__ void fresh_scores(const Block<T, R, true>& blk) {
  const Config& c = blk.c;
  const int dh = c.dh, D = c.H * dh, total = c.H * R * R;
  const int grp = threadIdx.x >> 2, q4 = threadIdx.x & 3;
  const float* q = blk.f(kBufQ);
  const float* kv = blk.f(kBufKv);
  float* sf = vbuf(blk, kVFresh);
  for (int base = 0; base < total; base += kThreads / 4) {  // the same trip count in every lane
    const int idx = base + grp;
    float a = 0.f;
    if (idx < total) {
      const int h = idx / (R * R), b = (idx / R) % R, i = idx % R;
      const float* qr = q + b * D + h * dh;
      const float* kr = kv + i * 2 * D + h * dh;
      // lane q4 takes j = q4 + 4 m', m' = m + i rotated: the rows i of a
      // warp's scores (2 D floats apart, one bank) read other banks
      float c[4] = {0.f, 0.f, 0.f, 0.f};  // four chains, added in order
      const int n4 = dh / 4, rot = i % n4;
      for (int m = 0; m < n4; m += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (m + u < n4) {
            const int mm = m + u + rot;
            const int j = q4 + 4 * (mm < n4 ? mm : mm - n4);
            c[u] += qr[j] * kr[j];
          }
        }
      }
      a = (c[0] + c[1]) + (c[2] + c[3]);
    }
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    a += __shfl_xor_sync(0xffffffffu, a, 2);
    if (idx < total && q4 == 0) sf[idx] = a;
  }
  __syncthreads();
}

// The largest fresh score of row b at head h: over positions t .. t + b.
template <typename T, int R>
__device__ __forceinline__ float fresh_max(const Block<T, R, true>& blk, int h, int b) {
  const float* sf = vbuf(blk, kVFresh) + (h * R + b) * R;
  float m = sf[0];
  for (int i = 1; i <= b; ++i) m = fmaxf(m, sf[i]);
  return m;
}

// Four elements of T at p (8- or 16-byte aligned) as floats.
template <typename T> __device__ __forceinline__ float4 load4(const T* p);
template <> __device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <> __device__ __forceinline__ float4 load4<bf16>(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Attention, stage A: the block's items (head, chunk), item = h * nc +
// chunk owned by block item % cluster; the chunk's keys [chunk * len,
// min(.. + len, n_keys)) of head h's cache segment.  A group of G = dh /
// vec<T>() threads reads one key row with 16-byte loads (P = kThreads / G
// rows a pass) and scores it against the q of every row (rounded to T,
// copied once an item), plus bias[key] when given, into
// the block's scores (R rows of max_keys a slot); each row's max of the
// chunk into the block's kBufMloc and every block's kBufPm at ((b H + h)
// nc + chunk).
template <typename T, int R>
__device__ void verify_scores(Block<T, R, true>& blk, const T* kc, const float* bias,
                              int seg_len, int n_keys, int len, int nc) {
  constexpr int V = vec<T>();
  const Config& c = blk.c;
  const int dh = c.dh, D = c.H * dh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* red = blk.f(kBufRed);
  float* qr = blk.f(kBufPart);  // (R, dh)
  for (int item = blk.rank, slot = 0; item < c.H * nc; item += c.cluster, ++slot) {
    const int h = item / nc, chunk = item - h * nc;
    const int k0 = chunk * len;
    const int n = min(len, n_keys - k0);
    const size_t seg = (static_cast<size_t>(h) * seg_len + k0) * dh;
    const T* kr = kc + seg;
    const float* br = bias != nullptr ? bias + k0 : nullptr;
    float* sv = blk.f(kBufScores) + static_cast<size_t>(slot) * R * c.max_keys;
    for (int i = threadIdx.x; i < R * dh; i += kThreads) {
      const int b = i / dh, j = i - b * dh;
      qr[b * dh + j] = round_t<T>(blk.f(kBufQ)[b * D + h * dh + j]);
    }
    __syncthreads();
    const int G = dh / V, P = kThreads / G;
    const int g = threadIdx.x % G, pi = threadIdx.x / G;
    for (int p0 = 0; p0 < n; p0 += P) {  // the same trip count in every thread
      const int p = p0 + pi;
      float kv[V];
      if (p < n) load16<T>(kr + static_cast<size_t>(p) * dh + g * V, kv);
      const float bp = br != nullptr && p < n ? br[p] : 0.f;
#pragma unroll 2
      for (int b = 0; b < R; ++b) {
        float a = 0.f;
        if (p < n) {
          const float* qb = qr + b * dh + g * V;
#pragma unroll
          for (int v = 0; v < V; ++v) a += qb[v] * kv[v];
        }
        for (int o = G / 2; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
        if (p < n && g == 0) sv[b * c.max_keys + p] = a + bp;
      }
    }
    __syncthreads();
    float m[R];
#pragma unroll
    for (int b = 0; b < R; ++b) {
      m[b] = -3.0e38f;
      for (int p = threadIdx.x; p < n; p += kThreads) m[b] = fmaxf(m[b], sv[b * c.max_keys + p]);
      m[b] = warp_max(m[b]);
    }
    if (lane == 0) {
#pragma unroll
      for (int b = 0; b < R; ++b) red[warp * R + b] = m[b];
    }
    __syncthreads();
    if (warp < R) {  // warp b: row b's max over the warps, to every block
      const int b = warp;
      const float mb = warp_max(lane < kWarps ? red[lane * R + b] : -3.0e38f);
      if (lane < c.cluster) dsmem_store(blk.f(kBufPm) + (b * c.H + h) * nc + chunk, lane, mb);
      if (lane == 0) blk.f(kBufMloc)[slot * R + b] = mb;
    }
    __syncthreads();  // qr and red are reused by the next item
  }
}

// Attention, stage B: for each item, e = exp(s - m) against the global max
// m of each (row, head) (its fresh positions' scores for self-attention,
// and every chunk's max), as the reference rounds it; shares l_c = sum e
// into every block's kBufPl.  Then thread (key segment, row, four columns)
// sums T(e) v over its segment of the chunk's keys; the segments' partials
// are added in a fixed order (four chains) and stored, four columns at a
// time, into every block's kBufPacc.
template <typename T, int R>
__device__ void verify_values(Block<T, R, true>& blk, const T* vc, int seg_len, int n_keys, int len,
                              int nc, bool self) {
  const Config& c = blk.c;
  const int dh = c.dh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int quads = R * dh / 4;  // (row, four columns)
  const int segs = min(kThreads / quads > 1 ? kThreads / quads : 1, kMaxSegs);
  float* part = blk.f(kBufPart);  // (segs, R, dh)
  float* red = blk.f(kBufRed);
  for (int item = blk.rank, slot = 0; item < c.H * nc; item += c.cluster, ++slot) {
    const int h = item / nc, chunk = item - h * nc;
    const int k0 = chunk * len;
    const int n = min(len, n_keys - k0);
    const T* vr = vc + (static_cast<size_t>(h) * seg_len + k0) * dh;
    float* ev = blk.f(kBufScores) + static_cast<size_t>(slot) * R * c.max_keys;
    float m[R];
#pragma unroll
    for (int b = 0; b < R; ++b) m[b] = self ? fresh_max(blk, h, b) : -3.0e38f;
    if (nc == 1) {
#pragma unroll
      for (int b = 0; b < R; ++b) m[b] = fmaxf(m[b], blk.f(kBufMloc)[slot * R + b]);
    } else {
      for (int ch = 0; ch < nc; ++ch) {
#pragma unroll
        for (int b = 0; b < R; ++b) m[b] = fmaxf(m[b], blk.f(kBufPm)[(b * c.H + h) * nc + ch]);
      }
    }
    constexpr int RP = pow2_rows<R>();
    float den[RP];
#pragma unroll
    for (int b = 0; b < RP; ++b) den[b] = 0.f;
    for (int pp = threadIdx.x; pp < n; pp += kThreads) {
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const float e = expf(ev[b * c.max_keys + pp] - m[b]);
        ev[b * c.max_keys + pp] = round_t<T>(e);  // what the value product takes
        den[b] += e;
      }
    }
    const int at = transposed_sum<RP>(den, lane);  // the warp's sum of row `at`
    if (sum_writer<RP>(lane) && at < R) red[warp * R + at] = den[0];
    __syncthreads();  // ev holds T(e), red each warp's sums
    if (warp < R) {  // warp b: row b's sum over the warps (a shuffle tree), to every block
      const int b = warp;
      const float l = warp_sum(lane < kWarps ? red[lane * R + b] : 0.f);
      if (lane < c.cluster) dsmem_store(blk.f(kBufPl) + (b * c.H + h) * nc + chunk, lane, l);
    }
    for (int i = threadIdx.x; i < segs * quads; i += kThreads) {
      const int sg = i / quads, e = i - sg * quads;
      const int b = e / (dh / 4), j = 4 * (e - b * (dh / 4));
      const float* eb = ev + b * c.max_keys;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int p = sg * n / segs; p < (sg + 1) * n / segs; ++p) {
        const float4 v4 = load4<T>(vr + static_cast<size_t>(p) * dh + j);
        a.x += eb[p] * v4.x;
        a.y += eb[p] * v4.y;
        a.z += eb[p] * v4.z;
        a.w += eb[p] * v4.w;
      }
      *reinterpret_cast<float4*>(part + (sg * R + b) * dh + j) = a;
    }
    __syncthreads();
    // thread (row, four columns, block) adds the segments and stores 16 bytes
    const int q4 = dh / 4;
    for (int i = threadIdx.x; i < R * q4 * c.cluster; i += kThreads) {
      const int dst = i % c.cluster, e = i / c.cluster;
      const int b = e / q4, j = 4 * (e - b * q4);
      float4 t4[4];  // segment sg into chain sg % 4, the chains added in order
#pragma unroll
      for (int i4 = 0; i4 < 4; ++i4) t4[i4] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int sg = 0; sg < kMaxSegs; ++sg) {
        if (sg < segs) {
          const float4 u = *reinterpret_cast<const float4*>(part + (sg * R + b) * dh + j);
          t4[sg % 4].x += u.x;
          t4[sg % 4].y += u.y;
          t4[sg % 4].z += u.z;
          t4[sg % 4].w += u.w;
        }
      }
      const float4 t = make_float4((t4[0].x + t4[1].x) + (t4[2].x + t4[3].x),
                                   (t4[0].y + t4[1].y) + (t4[2].y + t4[3].y),
                                   (t4[0].z + t4[1].z) + (t4[2].z + t4[3].z),
                                   (t4[0].w + t4[1].w) + (t4[2].w + t4[3].w));
      dsmem_store4(blk.f(kBufPacc) + static_cast<size_t>((b * c.H + h) * nc + chunk) * dh + j, dst, t);
    }
    __syncthreads();  // part, the scores and red are reused by the next item
  }
}

// xs (R, D) = T(context) from the shared partials of every (row, head),
// added in chunk order; one warp per (row, head).  Self-attention (self)
// adds row b's fresh positions t .. t + b in closed form: their scores
// from kVFresh, their values v_new in fp32 from kBufKv.
template <typename T, int R>
__device__ void verify_combine(Block<T, R, true>& blk, int nc, bool self) {
  const Config& c = blk.c;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int dh = c.dh, D = c.H * dh;
  const float* pm = blk.f(kBufPm);
  const float* pl = blk.f(kBufPl);
  const float* pacc = blk.f(kBufPacc);
  const float* kv = blk.f(kBufKv);
  const float* sf = vbuf(blk, kVFresh);
  float* xs = blk.f(kBufXs);
  for (int pair = warp; pair < R * c.H; pair += kWarps) {
    const int b = pair / c.H, h = pair - b * c.H;
    const int base = pair * nc;
    float m = self ? fresh_max(blk, h, b) : -3.0e38f;
    for (int ch = 0; ch < nc; ++ch) m = fmaxf(m, pm[base + ch]);
    float den = 0.f;
    for (int ch = 0; ch < nc; ++ch) den += pl[base + ch];
    float e[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      e[i] = self && i <= b ? expf(sf[(h * R + b) * R + i] - m) : 0.f;
      if (self && i <= b) den += e[i];
    }
    for (int j = lane; j < dh; j += 32) {
      float acc = 0.f;
      for (int ch = 0; ch < nc; ++ch) acc += pacc[static_cast<size_t>(base + ch) * dh + j];
      if (self) {
#pragma unroll
        for (int i = 0; i < R; ++i)
          if (i <= b) acc += e[i] * kv[i * 2 * D + D + h * dh + j];
      }
      const float x = round_t<T>(acc / den);
      xs[b * D + h * dh + j] = x;
      stage_input(blk, b, h * dh + j, x);
    }
  }
  __syncthreads();
}

// The end of a pass, in every block once every block's flags are in: m is 1
// plus the leading run of j >= 1 whose draft is within tau (the largest
// error over the blocks) and whose group j - 1 did not vote, then at most
// the positions left; the vote is the last accepted group's.  Each block
// writes its own head columns of the m accepted groups (mel columns to
// frames_out, stop logits to stops_out); block 0 writes 2 m + vote.
template <typename T, int R>
__device__ void verify_accept(const Block<T, R, true>& blk, int gs) {
  const Config& c = blk.c;
  const Step& s = blk.s;
  const float* flags = vbuf(blk, kVFlags);
  auto ok = [&](int j) {
    float err = 0.f;
    for (int rk = 0; rk < c.cluster; ++rk) err = fmaxf(err, flags[rk * 2 * R + j]);
    return err <= s.tau;
  };
  auto voted = [&](int j) {
    bool v = false;
    for (int rk = 0; rk < c.cluster; ++rk) v |= flags[rk * 2 * R + R + j] != 0.f;
    return v;
  };
  int m = 1;  // every thread alike
  while (m < R && ok(m) && !voted(m - 1)) ++m;
  const int vote = voted(m - 1);
  m = min(m, s.limit);
  const Cols cs = stage_cols(blk, gs);
  const float* stg = vbuf(blk, kVStage);
  const int rn = s.r * c.n_mels, ncols = cs.col1 - cs.col0;
  for (int i = threadIdx.x; i < m * ncols; i += kThreads) {
    const int b = i / ncols, n = cs.col0 + i - b * ncols;
    const float v = stg[b * cs.stride + n - cs.base];
    if (n < rn)
      s.frames_out[b * rn + n] = v;  // frame b r + n / n_mels of the pass
    else
      s.stops_out[b * s.r + n - rn] = v;
  }
  if (blk.rank == 0 && threadIdx.x == 0) *s.code = 2 * m + vote;
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads, 1) decode_verify_kernel(const Config c, const Step s) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int rank = static_cast<int>(cluster_rank());
  Block<T, R, true> blk{c, s, smem, rank, 0, 0, 0, nullptr, 0};
  const int n_gs = 3 + 6 * c.L;
  const int D = c.H * c.dh;
  if (s.timeline != nullptr)  // a step's stamps and the acceptance's barrier
    blk.stamps = s.timeline + static_cast<size_t>(blockIdx.x) * (8 + 20 * c.L);

  // the block's plan rows and biases, the LayerNorm parameters of the first
  // two layers and the first weight piece, all by bulk copy (as a step)
  uint64_t* ln_bar = &blk.mbar()[c.n_pieces];
  uint64_t* plan_bar = &blk.mbar()[c.n_pieces + c.L];
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
    bulk_copy_g2s(blk.f(kBufBias), c.bias + static_cast<size_t>(rank) * c.n_bias, bias_bytes, plan_bar);
    const StageW<T> sw = stage_w<T, row_pad<T, true>()>(c, 0);
    const int ld = sw.K + row_pad<T, true>();
    const int c0 = c.first_piece[rank][0], c1 = c.first_piece[rank][1];
    const uint32_t bytes = static_cast<uint32_t>(c1 - c0) * ld * sizeof(T);
    mbar_arrive_expect_tx(&blk.mbar()[0], bytes);
    bulk_copy_g2s(blk.template buf<uint8_t>(kBufRing), sw.W + static_cast<size_t>(c0) * ld, bytes,
                  &blk.mbar()[0]);
    copy_ln(0);
    if (c.L > 1) copy_ln(1);
  }
  // prenet 1's input: the drafts
  float* xs = blk.f(kBufXs);
  for (int i = threadIdx.x; i < R * c.n_mels; i += kThreads) {
    const int b = i / c.n_mels, k = i - b * c.n_mels;
    xs[i] = round_t<T>(draft(s, b, k));
  }
  __syncthreads();  // the mbarriers are initialised, xs holds the drafts
  mbar_wait(plan_bar, 0);
  blk.next_issue = 1;
  blk.issue_after(-1, blk.stage_rows()[2].x);
  cluster_arrive_relaxed();  // waited for before the first store into another block

  cluster_wait();
  verify_gemv<T, R, kEpiRelu>(blk, 0, kBufXs, kBufAct, false);
  blk.issue_after(-1);
  blk.sync();
  verify_gemv<T, R, kEpiReluPe>(blk, 1, kBufAct, kBufRa, false);
  blk.sync();

  const bool self_attn = s.t > 0;
  const T* self_k = static_cast<const T*>(s.self_k);
  const T* self_v = static_cast<const T*>(s.self_v);
  const size_t lsz = static_cast<size_t>(c.H) * c.n_pos * c.dh;
  const size_t csz = static_cast<size_t>(c.H) * c.tp * c.dh;
  for (int l = 0; l < c.L; ++l) {
    const int gs = 2 + 6 * l;
    if (l > 0) verify_layer_norm<T, R>(blk, blk.f(kBufRa), l - 1, 2, blk.f(kBufRa), true);
    verify_gemv<T, R, kEpiQkv>(blk, gs, l == 0 ? kBufRa : kBufXs, kBufQ, l > 0, l);
    if (threadIdx.x == 0 && l >= 1 && l + 1 < c.L) {
      fence_proxy_async_shared();
      copy_ln(l + 1);
    }
    blk.sync();
    mbar_wait(&ln_bar[l], 0);
    fresh_scores(blk);
    if (self_attn) {
      verify_scores<T, R>(blk, self_k + l * lsz, nullptr, c.n_pos, s.t,
                          s.self_chunk, s.self_nc);
      if (s.self_nc > 1)
        blk.sync();
      else
        __syncthreads();  // the block's own scores and maxima
      verify_values<T, R>(blk, self_v + l * lsz, c.n_pos, s.t, s.self_chunk, s.self_nc, true);
      blk.sync();
    }
    verify_combine<T, R>(blk, self_attn ? s.self_nc : 0, true);
    verify_gemv<T, R, kEpiF32>(blk, gs + 1, kBufXs, kBufO, true);
    blk.sync();
    verify_layer_norm<T, R>(blk, blk.f(kBufRa), l, 0, blk.f(kBufRb), false);
    verify_gemv<T, R, kEpiScale>(blk, gs + 2, kBufXs, kBufQ, true);
    blk.sync();
    const T* ck = static_cast<const T*>(s.cross_k) + l * csz;
    const T* cv = static_cast<const T*>(s.cross_v) + l * csz;
    verify_scores<T, R>(blk, ck, s.cross_bias, c.tp, c.tp, c.cross_chunk, c.cross_nc);
    if (c.cross_nc > 1)
      blk.sync();
    else
      __syncthreads();
    verify_values<T, R>(blk, cv, c.tp, c.tp, c.cross_chunk, c.cross_nc, false);
    blk.sync();
    verify_combine<T, R>(blk, c.cross_nc, false);
    verify_gemv<T, R, kEpiF32>(blk, gs + 3, kBufXs, kBufO, true);
    blk.sync();
    verify_layer_norm<T, R>(blk, blk.f(kBufRb), l, 1, blk.f(kBufRa), false);
    verify_gemv<T, R, kEpiRelu>(blk, gs + 4, kBufXs, kBufAct, true);
    blk.sync();
    verify_gemv<T, R, kEpiF32>(blk, gs + 5, kBufAct, kBufO, false);
    blk.sync();
  }

  // fused mel|stop head; prologue LN3(residual + o) of the last layer
  verify_layer_norm<T, R>(blk, blk.f(kBufRa), c.L - 1, 2, nullptr, false);
  verify_gemv<T, R, kEpiOut>(blk, n_gs - 1, kBufXs, kBufO, true);
  blk.sync();  // every block's flags in every block
  verify_accept(blk, n_gs - 1);
  if (blk.stamps != nullptr) {
    __syncthreads();
    if (threadIdx.x == 0) blk.stamps[1 + 2 * blk.n_sync] = global_timer_ns();
  }
}

template <typename T, int R>
int launch_verify(const Config& c, const Step& s, cudaStream_t stream) {
  auto fn = decode_verify_kernel<T, R>;
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
  cfg.gridDim = dim3(c.cluster);
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

template <typename T>
int dispatch_verify(const Config& c, const Step& s, cudaStream_t stream) {
  switch (c.R) {
    case 2: return launch_verify<T, 2>(c, s, stream);
    case 3: return launch_verify<T, 3>(c, s, stream);
    case 4: return launch_verify<T, 4>(c, s, stream);
    case 5: return launch_verify<T, 5>(c, s, stream);
    case 6: return launch_verify<T, 6>(c, s, stream);
    case 7: return launch_verify<T, 7>(c, s, stream);
    case 8: return launch_verify<T, 8>(c, s, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// One verify pass at position t, one launch of one cluster.  `config` is
// the prepared pass's Config (R = K rows; B = 1, the caches' one row, so
// that attention reads every row's keys from it; n_pos the cache's
// positions: the decode's n_pos + K; the weights those of
// pack_verify_weights; cross_chunk / cross_nc and nc_max as attn_chunks cuts
// one row; max_keys the longest chunk a block scores); frame / prev the
// fed-back frame and the one before it; pe_rows (K, D) alpha * PE[t .. t +
// K - 1]; cross_bias (1, tp); the caches (L, H, 1, n_pos, dh) and (L, H, 1,
// tp, dh); y (K, d_out), k_new / v_new (L, H, K, dh); frames_out /
// stops_out where the accepted frames and stop logits go (room for K r
// frames), code one int (2 m + vote); limit the positions left (>= 1), r
// the reduction factor; voff the byte offsets of the VerifyBuffer buffers;
// timeline null, or cluster x (8 + 20 L) global-timer stamps (a step's and
// the acceptance's barrier).  Returns the launch's CUDA error code, or
// cudaErrorInvalidValue for arguments the kernel cannot take.
int tts_decode_verify(const void* config, int is_bf16, int t, int self_chunk, int self_nc,
                      const void* frame, const void* prev, const void* pe_rows,
                      const void* cross_bias, void* self_k, void* self_v, const void* cross_k,
                      const void* cross_v, void* y, void* k_new, void* v_new, void* frames_out,
                      void* stops_out, void* code, float tau, float stop_threshold, int limit, int r,
                      const int* voff, void* timeline, void* stream) {
  const Config& c = *static_cast<const Config*>(config);
  const int V = is_bf16 ? 8 : 4;
  const int groups = c.dh / V;
  const int n_gs = 3 + 6 * c.L;
  const int D = c.H * c.dh;
  const int depth = is_bf16 ? kTile : 4;  // every stage's K a multiple of it
  if (c.cluster < 1 || c.cluster > kMaxCluster || c.R < 2 || c.R > kMaxRows || c.B != 1 ||
      t < 0 || t + c.R > c.n_pos || limit < 1 || r < 1 || c.d_out != r * (c.n_mels + 1) ||
      c.n_pieces > kMaxPieces || c.dh % V != 0 || groups > 32 || (groups & (groups - 1)) != 0 ||
      D % depth != 0 || c.F % depth != 0 || c.n_mels % depth != 0 ||
      !chunks_cover(t, self_chunk, self_nc) || !chunks_cover(c.tp, c.cross_chunk, c.cross_nc) ||
      self_nc > c.nc_max || c.cross_nc > c.nc_max || self_chunk > c.max_keys ||
      c.cross_chunk > c.max_keys || n_gs > kMaxStages)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (c.smem_bytes > optin) return static_cast<int>(cudaErrorInvalidValue);
  Step s = {};
  s.t = t;
  s.self_chunk = self_chunk;
  s.self_nc = self_nc;
  s.frame = static_cast<const float*>(frame);
  s.pe_row = static_cast<const float*>(pe_rows);
  s.cross_bias = static_cast<const float*>(cross_bias);
  s.self_k = self_k;
  s.self_v = self_v;
  s.cross_k = cross_k;
  s.cross_v = cross_v;
  s.y = static_cast<float*>(y);
  s.k_new = k_new;
  s.v_new = v_new;
  s.prev = static_cast<const float*>(prev);
  s.frames_out = static_cast<float*>(frames_out);
  s.stops_out = static_cast<float*>(stops_out);
  s.code = static_cast<int*>(code);
  s.tau = tau;
  s.stop_threshold = stop_threshold;
  s.limit = limit;
  s.r = r;
  for (int i = 0; i < 3; ++i) s.voff[i] = voff[i];
  s.timeline = static_cast<unsigned long long*>(timeline);
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_verify<bf16>(c, s, st) : dispatch_verify<float>(c, s, st);
}

}  // extern "C"
