// log(clip(sqrt((X C)^2 + (X S)^2) M^T, 1e-5)) for the windowed frames X of a
// batch of signals, with the (frames, bins) magnitudes never in device
// memory, for Hopper (sm_90a).
//
// Replaces the TPU kernel transformertts_tpu/ops/pallas/stft.py: log_mel_pallas
// (_kernel).  The plain PyTorch version, op for op, is log_mel_reference in
// ../stft.py.  Everything is fp32: C and S are the (n_fft, bins) real and
// imaginary DFT matrices, M^T the (bins, n_mels) mel filterbank, all built on
// the host in float64 and cast.  The TPU wrapper gathered the overlapping
// frames and multiplied the window before its kernel, which writes every
// sample n_fft / hop times; this kernel reads the padded signal itself at
// frame * hop and multiplies the window as it loads.
//
// Bound of the function: about 28 MB (signal in, log-mels out) and, with the
// DFT counted as an FFT, 0.6 GFLOP for 32 signals of 163,840 samples: some 10
// us either way.  This kernel does the DFT as two dense products, 4 n_fft
// bins operations per frame (43 GFLOP for that batch, 0.64 ms at the fp32
// peak), as the TPU kernel does, and runs them as fp32 FMAs on the CUDA
// cores: it is far from the function's bound by design, and an FFT in shared
// memory is the way down.
// C and S (2 MB each) do not fit a block's shared memory, so a block of 256
// threads takes 64 frames of one signal and walks over the bins in tiles of
// 64: the tile's real and imaginary parts are two 64 x 64 products (every
// thread a 4 x 4 sub-tile of each, operands staged in chunks of 32 samples),
// their magnitude goes to shared memory, and its product with the tile's rows
// of M^T is added to the block's (64, n_mels) sums in registers before the
// next tile is formed.  A frame is read once per bin tile, from the L2 cache
// after the first.  wgmma (TF32 would lose the fp32 sums), TMA and a sparse
// mel product are later work.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

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

}  // extern "C"
