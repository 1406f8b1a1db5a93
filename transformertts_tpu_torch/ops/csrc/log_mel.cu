// log(clip(|DFT(window * frame)| M^T, 1e-5)) for the frames of a batch of
// signals, with the (frames, bins) magnitudes never in device memory, for
// Hopper (sm_90a).  Two kernels, chosen by the wrapper from n_fft alone.
//
// Replaces the TPU kernel transformertts_tpu/ops/pallas/stft.py: log_mel_pallas
// (_kernel).  The plain PyTorch version, op for op that kernel's, is
// log_mel_reference in ../stft.py (the DFT as two dense products).
// Everything is fp32, no TF32: the window, the DFT's twiddles or matrices
// and the mel filterbank M are built on the host in float64 and cast.  The
// TPU wrapper gathered the overlapping frames and multiplied the window
// before its kernel, which writes every sample n_fft / hop times; these
// kernels read the padded signal itself at frame * hop and multiply the
// window as they load.
//
// Bound of the function: about 28 MB (signal in, log-mels out) and, with the
// DFT counted as an FFT, 0.6 GFLOP for 32 signals of 163,840 samples: some
// 9 us either way.
//
// log_mel_fft_kernel, for n_fft a power of two from 256 to 2,048 (every
// configuration of the repo uses 1,024): a block takes a run of fpb frames
// of one signal and copies its (fpb - 1) hop + n_fft samples (cp.async),
// the window and the twiddle table into shared memory once, so each sample
// serves n_fft / hop frames from there.  One warp a frame: the real FFT as
// an n_fft / 2-point complex FFT of the even / odd samples (Stockham stages
// of radix 8, then 4 or 2, in registers, exchanged through the warp's own
// buffer) and the split step; the magnitudes in shared memory; each mel
// band summed over its non-zero weights only, from a (first bin, bins,
// offset) list the wrapper builds from the filterbank, in increasing bin
// order; log-clip into a (n_mels, fpb) tile whose rows are stored whole.
// About 2.5 n_fft log2 n_fft operations a frame where the dense products
// take 4 n_fft bins.
//
// log_mel_kernel, every other n_fft: the DFT as two dense products, 4
// n_fft bins operations per frame (43 GFLOP for the batch above, 0.64 ms at
// the fp32 peak), as the TPU kernel does, as fp32 FMAs on the CUDA cores.
// C and S (2 MB each at n_fft 1,024) do not fit a block's shared memory, so
// a block of 256 threads takes 64 frames of one signal and walks over the
// bins in tiles of 64: the tile's real and imaginary parts are two 64 x 64
// products (every thread a 4 x 4 sub-tile of each, operands staged in chunks
// of 32 samples), their magnitude goes to shared memory, and its product
// with the tile's rows of M^T is added to the block's (64, n_mels) sums in
// registers before the next tile is formed.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;        // frames of a block, and bins of a tile
constexpr int kLd = kTile + 4;   // row length of a 64-wide tile in shared memory
constexpr int kKc = 32;          // samples of a frame staged at a time
constexpr int kMelCols = 8;      // mel columns a thread sums: n_mels <= 16 * 8
constexpr int kMaxMels = 16 * kMelCols;

constexpr size_t kSmem = sizeof(float) * (3 * kKc * kLd + kTile * kLd + kTile * kMaxMels);

// y (B, n) padded signals; window (n_fft); cosm, sinm (n_fft, n_bins); melt
// (n_bins, n_mels); out (B, n_mels, n_frames).  Frame f of signal b is
// y[b, f * hop : f * hop + n_fft] * window.  blockIdx.x is the frame tile,
// blockIdx.y the signal.
__global__ void __launch_bounds__(kThreads)
log_mel_kernel(const float* __restrict__ y, const float* __restrict__ window,
               const float* __restrict__ cosm, const float* __restrict__ sinm,
               const float* __restrict__ melt, float* __restrict__ out, int n, int n_fft, int hop,
               int n_bins, int n_mels, int n_frames, float clip, int vec_ok) {
  extern __shared__ __align__(16) float smem[];
  float* Xc = smem;             // (kKc, kLd): windowed samples, one sample index per row
  float* Cc = Xc + kKc * kLd;   // (kKc, kLd): rows of C, this tile's bins
  float* Sc = Cc + kKc * kLd;   // (kKc, kLd): rows of S
  float* Mg = Sc + kKc * kLd;   // (kTile, kLd): magnitudes, one bin per row
  float* Mt = Mg + kTile * kLd; // (kTile, kMaxMels): this tile's rows of M^T
  const int frame0 = blockIdx.x * kTile;
  const float* sig = y + static_cast<size_t>(blockIdx.y) * n;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  float mel[4][kMelCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMelCols; ++j) mel[i][j] = 0.f;

  for (int bin0 = 0; bin0 < n_bins; bin0 += kTile) {
    float re[4][4] = {}, im[4][4] = {};
    for (int k0 = 0; k0 < n_fft; k0 += kKc) {
      __syncthreads();  // the previous chunk's (and tile's) reads are done
      // lanes along the frames: the stores meet no bank conflict.  Where the
      // addresses allow it every lane reads 16 bytes of its frame at once.
      if (vec_ok) {
        for (int idx = threadIdx.x; idx < (kKc / 4) * kTile; idx += kThreads) {
          const int f = idx % kTile, k = (idx / kTile) * 4;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (frame0 + f < n_frames && k0 + k < n_fft) {
            v = *reinterpret_cast<const float4*>(
                sig + static_cast<size_t>(frame0 + f) * hop + k0 + k);
            const float4 w = *reinterpret_cast<const float4*>(window + k0 + k);
            v.x *= w.x; v.y *= w.y; v.z *= w.z; v.w *= w.w;
          }
          Xc[k * kLd + f] = v.x;
          Xc[(k + 1) * kLd + f] = v.y;
          Xc[(k + 2) * kLd + f] = v.z;
          Xc[(k + 3) * kLd + f] = v.w;
        }
      } else {
        for (int idx = threadIdx.x; idx < kKc * kTile; idx += kThreads) {
          const int f = idx % kTile, k = idx / kTile;
          float v = 0.f;
          if (frame0 + f < n_frames && k0 + k < n_fft)
            v = sig[static_cast<size_t>(frame0 + f) * hop + k0 + k] * window[k0 + k];
          Xc[k * kLd + f] = v;
        }
      }
      // lanes along the bins: coalesced loads
      for (int idx = threadIdx.x; idx < kKc * kTile; idx += kThreads) {
        const int b = idx % kTile, k = idx / kTile;
        float c = 0.f, s = 0.f;
        if (bin0 + b < n_bins && k0 + k < n_fft) {
          const size_t at = static_cast<size_t>(k0 + k) * n_bins + bin0 + b;
          c = cosm[at];
          s = sinm[at];
        }
        Cc[k * kLd + b] = c;
        Sc[k * kLd + b] = s;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kKc; ++k) {
        const float4 xv = *reinterpret_cast<const float4*>(Xc + k * kLd + ty * 4);
        const float4 cv = *reinterpret_cast<const float4*>(Cc + k * kLd + tx * 4);
        const float4 sv = *reinterpret_cast<const float4*>(Sc + k * kLd + tx * 4);
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
        const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
        const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            re[i][j] += xr[i] * cr[j];
            im[i][j] += xr[i] * sr[j];
          }
      }
    }
    // magnitudes of this tile, one bin per row; bins beyond n_bins are zeros
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float m[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) m[i] = sqrtf(re[i][j] * re[i][j] + im[i][j] * im[i][j]);
      *reinterpret_cast<float4*>(Mg + (tx * 4 + j) * kLd + ty * 4) =
          make_float4(m[0], m[1], m[2], m[3]);
    }
    for (int idx = threadIdx.x; idx < kTile * kMaxMels; idx += kThreads) {
      const int c = idx % kMaxMels, b = idx / kMaxMels;
      Mt[idx] = (bin0 + b < n_bins && c < n_mels)
                    ? melt[static_cast<size_t>(bin0 + b) * n_mels + c] : 0.f;
    }
    __syncthreads();
    // mel[i][j] += sum_b mag[4 ty + i][b] * M^T[b][tx + 16 j]
#pragma unroll 4
    for (int b = 0; b < kTile; ++b) {
      const float4 gv = *reinterpret_cast<const float4*>(Mg + b * kLd + ty * 4);
      const float gr[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int j = 0; j < kMelCols; ++j) {
        const float w = Mt[b * kMaxMels + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) mel[i][j] += gr[i] * w;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kMelCols; ++j) {
    const int c = tx + 16 * j;
    if (c >= n_mels) continue;
    float* row = out + (static_cast<size_t>(blockIdx.y) * n_mels + c) * n_frames;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = frame0 + ty * 4 + i;
      if (f < n_frames) row[f] = logf(fmaxf(mel[i][j], clip));
    }
  }
}

// ------------------------------------------------------------ FFT kernel

// The real n_fft-point DFT of a windowed frame as the n_fft / 2-point
// complex FFT of z[m] = x[2m] + i x[2m + 1] (Stockham, radix 8 while it
// divides, then 4 or 2; natural order out), then the split step
//   X[k] = (Z[k] + conj Z[M - k]) / 2 - i W^k (Z[k] - conj Z[M - k]) / 2
// for k = 0 .. M (Z[M] = Z[0]), W = exp(-2 pi i / n_fft) from the table.
// One warp a frame; the stages' exchanges go through the warp's own
// shared-memory buffer (real and imaginary parts apart, one float of
// padding every 32, so the stride-R writes meet few bank conflicts).

constexpr int kFftThreads = 256;
constexpr int kFftWarps = kFftThreads / 32;

__host__ __device__ constexpr int padded(int p) { return p + (p >> 5); }

// Floats of one warp's buffer for an M-point complex FFT: real and
// imaginary parts, the magnitudes (M + 1), rounded up to 4.
__host__ __device__ constexpr int fft_warp_floats(int M) {
  return (2 * padded(M) + M + 1 + 3) / 4 * 4;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}
__device__ __forceinline__ float2 mul_mi(float2 a) { return make_float2(a.y, -a.x); }  // a (-i)

// v[q] <- sum_r v[r] exp(-2 pi i r q / R), in place
__device__ __forceinline__ void dft(float2 (&v)[2]) {
  const float2 a = v[0];
  v[0] = cadd(a, v[1]);
  v[1] = csub(a, v[1]);
}
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2, float2& a3) {
  const float2 t0 = cadd(a0, a2), t1 = csub(a0, a2), t2 = cadd(a1, a3), t3 = mul_mi(csub(a1, a3));
  a0 = cadd(t0, t2);
  a2 = csub(t0, t2);
  a1 = cadd(t1, t3);
  a3 = csub(t1, t3);
}
__device__ __forceinline__ void dft(float2 (&v)[4]) { dft4(v[0], v[1], v[2], v[3]); }
__device__ __forceinline__ void dft(float2 (&v)[8]) {
  constexpr float h = 0.70710678118654752f;  // sqrt(1/2)
  float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
  float2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
  dft4(e0, e1, e2, e3);
  dft4(o0, o1, o2, o3);
  o1 = make_float2(h * (o1.x + o1.y), h * (o1.y - o1.x));   // W8^1
  o2 = mul_mi(o2);                                           // W8^2
  o3 = make_float2(h * (o3.y - o3.x), -h * (o3.x + o3.y));  // W8^3
  v[0] = cadd(e0, o0);
  v[4] = csub(e0, o0);
  v[1] = cadd(e1, o1);
  v[5] = csub(e1, o1);
  v[2] = cadd(e2, o2);
  v[6] = csub(e2, o2);
  v[3] = cadd(e3, o3);
  v[7] = csub(e3, o3);
}

// Radix of the stage that follows Ns points done, for an M-point FFT.
__host__ __device__ constexpr int fft_radix(int M, int Ns) { return Ns * 8 <= M ? 8 : M / Ns; }

// One Stockham stage: butterfly j (of M / R) reads points j + r M / R,
// multiplies point r by W_{Ns R}^{r (j % Ns)} (table entry r (j % Ns)
// n_fft / (Ns R)), transforms, and writes point q at (j / Ns) Ns R + j % Ns
// + q Ns.  The first stage (Ns = 1, no twiddles) reads the windowed frame.
template <int M, int Ns, int R>
__device__ __forceinline__ void fft_stage(float* re, float* im, const float* x, const float* win,
                                          const float2* tw, int lane) {
  constexpr int B = M / R, kPer = (B + 31) / 32;  // butterflies, and per lane
  float2 v[kPer][R];
#pragma unroll
  for (int b = 0; b < kPer; ++b) {
    const int j = lane + 32 * b;
    if (B % 32 && j >= B) continue;
    const int k = j % Ns;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = j + r * B;
      if constexpr (Ns == 1) {
        v[b][r] = make_float2(x[2 * p] * win[2 * p], x[2 * p + 1] * win[2 * p + 1]);
      } else {
        v[b][r] = make_float2(re[padded(p)], im[padded(p)]);
        if (r > 0) v[b][r] = cmul(v[b][r], tw[r * k * (2 * M / (Ns * R))]);
      }
    }
  }
  __syncwarp();  // every lane has read its points before any is overwritten
#pragma unroll
  for (int b = 0; b < kPer; ++b) {
    const int j = lane + 32 * b;
    if (B % 32 && j >= B) continue;
    dft(v[b]);
    const int d = (j / Ns) * Ns * R + j % Ns;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      re[padded(d + q * Ns)] = v[b][q].x;
      im[padded(d + q * Ns)] = v[b][q].y;
    }
  }
  __syncwarp();
}

template <int M, int Ns>
__device__ __forceinline__ void fft_stages(float* re, float* im, const float* x, const float* win,
                                           const float2* tw, int lane) {
  if constexpr (Ns < M) {
    constexpr int R = fft_radix(M, Ns);
    fft_stage<M, Ns, R>(re, im, x, win, tw, lane);
    fft_stages<M, Ns * R>(re, im, x, win, tw, lane);
  }
}

// Signal samples a block holds: its fpb frames at hop, rounded up to 4.
__host__ __device__ constexpr int fft_span(int fpb, int hop, int N) {
  return ((fpb - 1) * hop + N + 3) / 4 * 4;
}
__host__ __device__ constexpr size_t fft_smem_bytes(int N, int hop, int n_mels, int fpb) {
  return sizeof(float) * (static_cast<size_t>(fft_span(fpb, hop, N)) + 3 * N +
                          kFftWarps * fft_warp_floats(N / 2) + n_mels * fpb);
}

// y (B, n) padded signals; window (N); tw (N) complex, W^t; band (n_mels, 3)
// int: first bin, bins, offset of the band's weights in `weights`; out (B,
// n_mels, n_frames).  blockIdx.x: the run of fpb frames, blockIdx.y the
// signal.  The block copies its samples ((fpb - 1) hop + N, each used by
// N / hop frames), the window and the table into shared memory; warp w
// takes frames w, w + 8, ...: FFT, split step and magnitudes, each mel band
// summed over its bins in increasing order (lane c takes bands c, c + 32,
// ...), log-clip into a (n_mels, fpb) tile; the tile's rows are stored
// whole.
template <int N>
__global__ void __launch_bounds__(kFftThreads)
log_mel_fft_kernel(const float* __restrict__ y, const float* __restrict__ window,
                   const float2* __restrict__ tw, const int* __restrict__ band,
                   const float* __restrict__ weights, float* __restrict__ out, int n, int hop,
                   int n_mels, int n_frames, int fpb, float clip) {
  constexpr int M = N / 2;
  extern __shared__ __align__(16) float smem[];
  float* sig = smem;
  float* win = sig + fft_span(fpb, hop, N);
  float2* tws = reinterpret_cast<float2*>(win + N);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* re = reinterpret_cast<float*>(tws + N) + warp * fft_warp_floats(M);
  float* im = re + padded(M);
  float* mag = im + padded(M);
  float* tile = reinterpret_cast<float*>(tws + N) + kFftWarps * fft_warp_floats(M);

  const int frame0 = blockIdx.x * fpb;
  const float* src = y + static_cast<size_t>(blockIdx.y) * n + static_cast<size_t>(frame0) * hop;
  const int span = (fpb - 1) * hop + N, avail = n - frame0 * hop;
  const int count = span < avail ? span : avail;  // samples a valid frame may read
  const uint32_t s_sig = smem_addr(sig);
  int head = 0;  // samples copied 16 bytes at a time
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    head = count / 4 * 4;
    for (int i = threadIdx.x; i < head / 4; i += kFftThreads) cp_async16(s_sig + 16 * i, src + 4 * i, true);
  }
  for (int i = head + threadIdx.x; i < count; i += kFftThreads) cp_async4(s_sig + 4 * i, src + i);
  for (int i = threadIdx.x; i < N / 4; i += kFftThreads)
    cp_async16(smem_addr(win) + 16 * i, window + 4 * i, true);
  for (int i = threadIdx.x; i < N / 2; i += kFftThreads)
    cp_async16(smem_addr(tws) + 16 * i, tw + 2 * i, true);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  for (int f = warp; f < fpb && frame0 + f < n_frames; f += kFftWarps) {
    fft_stages<M, 1>(re, im, sig + f * hop, win, tws, lane);
    for (int k = lane; k <= M; k += 32) {
      const int k1 = k % M, k2 = (M - k) % M;
      const float2 a = make_float2(re[padded(k1)], im[padded(k1)]);
      const float2 b = make_float2(re[padded(k2)], -im[padded(k2)]);  // conj Z[M - k]
      const float2 e = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y + b.y));
      const float2 o = mul_mi(make_float2(0.5f * (a.x - b.x), 0.5f * (a.y - b.y)));
      const float2 xk = cadd(e, cmul(o, tws[k]));
      mag[k] = sqrtf(xk.x * xk.x + xk.y * xk.y);
    }
    __syncwarp();
    for (int c = lane; c < n_mels; c += 32) {
      const int first = __ldg(band + 3 * c), bins = __ldg(band + 3 * c + 1);
      const float* w = weights + __ldg(band + 3 * c + 2);
      float s = 0.f;
      for (int t = 0; t < bins; ++t) s = fmaf(__ldg(w + t), mag[first + t], s);
      tile[c * fpb + f] = logf(fmaxf(s, clip));
    }
    __syncwarp();  // the magnitudes are read before the next frame's FFT
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_mels * fpb; i += kFftThreads) {
    const int c = i / fpb, f = i % fpb;
    if (frame0 + f < n_frames)
      out[(static_cast<size_t>(blockIdx.y) * n_mels + c) * n_frames + frame0 + f] = tile[i];
  }
}

template <int N>
int launch_fft(const float* y, const float* window, const float2* tw, const int* band,
               const float* weights, float* out, int B, int n, int hop, int n_mels,
               int n_frames, int fpb, float clip, cudaStream_t s) {
  const size_t smem = fft_smem_bytes(N, hop, n_mels, fpb);
  cudaError_t err = cudaFuncSetAttribute(log_mel_fft_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_frames + fpb - 1) / fpb, B);
  log_mel_fft_kernel<N><<<grid, kFftThreads, smem, s>>>(y, window, tw, band, weights, out, n, hop,
                                                         n_mels, n_frames, fpb, clip);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y (B, n) fp32 contiguous, already padded: frame f reads samples f * hop ..
// f * hop + n_fft - 1, so n_frames <= 1 + (n - n_fft) / hop.  window (n_fft),
// cosm and sinm (n_fft, n_bins), melt (n_bins, n_mels), out (B, n_mels,
// n_frames), all fp32 contiguous.  n_mels <= 128, B <= 65535.
int tts_log_mel(int B, int n, int n_fft, int hop, int n_bins, int n_mels, int n_frames,
                const void* y, const void* window, const void* cosm, const void* sinm,
                const void* melt, void* out, float clip, void* stream) {
  if (B < 1 || B > 65535 || n_fft < 1 || hop < 1 || n_bins < 1 || n_mels < 1 ||
      n_mels > kMaxMels || n_frames < 1 || n < n_fft ||
      static_cast<long long>(n_frames - 1) * hop + n_fft > n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte loads of a frame: every frame of every signal starts on a
  // multiple of 4 samples
  const int vec_ok = hop % 4 == 0 && n_fft % 4 == 0 && (B == 1 || n % 4 == 0) &&
                     reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(window) % 16 == 0;
  const dim3 grid((n_frames + kTile - 1) / kTile, B);
  log_mel_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(window),
      static_cast<const float*>(cosm), static_cast<const float*>(sinm),
      static_cast<const float*>(melt), static_cast<float*>(out), n, n_fft, hop, n_bins, n_mels,
      n_frames, clip, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

// The FFT kernel, n_fft a power of two from 256 to 2,048.  y (B, n), window
// (n_fft), out as tts_log_mel; tw (n_fft) complex fp32, entry t =
// exp(-2 pi i t / n_fft); band (n_mels, 3) int32 and weights fp32, the
// filterbank's bands (first bin, bins, offset into weights); fpb frames a
// block.
int tts_log_mel_fft(int B, int n, int n_fft, int hop, int n_mels, int n_frames, int fpb,
                    const void* y, const void* window, const void* tw, const void* band,
                    const void* weights, void* out, float clip, void* stream) {
  if (B < 1 || B > 65535 || hop < 1 || n_mels < 1 || n_frames < 1 || fpb < 1 ||
      static_cast<long long>(n_frames - 1) * hop + n_fft > n ||
      fft_smem_bytes(n_fft, hop, n_mels, fpb) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto yy = static_cast<const float*>(y);
  auto ww = static_cast<const float*>(window);
  auto tt = static_cast<const float2*>(tw);
  auto bb = static_cast<const int*>(band);
  auto mw = static_cast<const float*>(weights);
  auto oo = static_cast<float*>(out);
  switch (n_fft) {
    case 256: return launch_fft<256>(yy, ww, tt, bb, mw, oo, B, n, hop, n_mels, n_frames, fpb, clip, s);
    case 512: return launch_fft<512>(yy, ww, tt, bb, mw, oo, B, n, hop, n_mels, n_frames, fpb, clip, s);
    case 1024: return launch_fft<1024>(yy, ww, tt, bb, mw, oo, B, n, hop, n_mels, n_frames, fpb, clip, s);
    case 2048: return launch_fft<2048>(yy, ww, tt, bb, mw, oo, B, n, hop, n_mels, n_frames, fpb, clip, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of the FFT kernel, bytes.
long long tts_log_mel_fft_smem(int n_fft, int hop, int n_mels, int fpb) {
  return static_cast<long long>(fft_smem_bytes(n_fft, hop, n_mels, fpb));
}

}  // extern "C"
