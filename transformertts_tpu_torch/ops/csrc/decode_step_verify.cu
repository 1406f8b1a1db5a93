// The verify pass of speculative decoding (the JAX package's
// transformertts_tpu/infer/decode.py:_speculative_decode, which runs it on
// XLA only): decode_step.cu's decode_step_kernel<T, R, false, true> for
// K = R = 2..8 consecutive positions of one utterance in one cluster, built
// as a library of its own (decode_step.cu holds the kernel and says what
// the verify form changes).  ops/decode_step.py:DecodeVerify loads it.
//
// Bound: bytes, as a step's.  A pass reads every decoder weight once for
// all K positions, the cache prefix [0, t) and the cross K/V once each
// (each of the K rows re-reads them through L2 in this first form), and
// writes K rows of K/V and at most K groups of frames.

#define TTS_DECODE_STEP_VERIFY
#include "decode_step.cu"

namespace {

template <typename T>
int dispatch_verify(const Config& c, const Step& s, cudaStream_t stream) {
  switch (c.R) {
    case 2: return launch<T, 2, false, true>(c, s, stream);
    case 3: return launch<T, 3, false, true>(c, s, stream);
    case 4: return launch<T, 4, false, true>(c, s, stream);
    case 5: return launch<T, 5, false, true>(c, s, stream);
    case 6: return launch<T, 6, false, true>(c, s, stream);
    case 7: return launch<T, 7, false, true>(c, s, stream);
    case 8: return launch<T, 8, false, true>(c, s, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// One verify pass at position t, one launch of one cluster.  `config` is
// the prepared pass's Config (R = K rows; B = 1, the caches' one row, so
// that attention reads every row's keys from it; n_pos the cache's
// positions: the decode's n_pos + K); frame / prev the fed-back frame and the one
// before it; pe_rows (K, D) alpha * PE[t .. t + K - 1]; cross_bias (1, tp);
// the caches (L, H, 1, n_pos, dh) and (L, H, 1, tp, dh); y (K, d_out),
// k_new / v_new (L, H, K, dh); frames_out / stops_out where the accepted
// frames and stop logits go (room for K r frames), code one int (2 m +
// vote); limit the positions left (>= 1), r the reduction factor; timeline
// null, or cluster x (8 + 20 L) global-timer stamps (a step's and the
// acceptance's barrier).  Returns
// the launch's CUDA error code, or cudaErrorInvalidValue for arguments the
// kernel cannot take.
int tts_decode_verify(const void* config, int is_bf16, int t, int self_chunk, int self_nc,
                      const void* frame, const void* prev, const void* pe_rows,
                      const void* cross_bias, void* self_k, void* self_v, const void* cross_k,
                      const void* cross_v, void* y, void* k_new, void* v_new, void* frames_out,
                      void* stops_out, void* code, float tau, float stop_threshold, int limit, int r,
                      void* timeline, void* stream) {
  const Config& c = *static_cast<const Config*>(config);
  const int V = is_bf16 ? 8 : 4;
  const int groups = c.dh / V;
  const int n_gs = 3 + 6 * c.L;
  const int rh = c.R * c.H;
  const int nc_max = c.cluster / rh > 1 ? c.cluster / rh : 1;
  const int D = c.H * c.dh;
  if (c.cluster < 1 || c.cluster > kMaxCluster || c.R < 2 || c.R > kMaxRows || c.B != 1 ||
      t < 0 || t + c.R > c.n_pos || limit < 1 || r < 1 || c.d_out != r * (c.n_mels + 1) ||
      c.d_out > (D > c.F ? D : c.F) || c.n_pieces > kMaxPieces || c.dh % V != 0 || groups > 32 ||
      (groups & (groups - 1)) != 0 || !chunks_cover(t, self_chunk, self_nc) ||
      !chunks_cover(c.tp, c.cross_chunk, c.cross_nc) || c.nc_max != nc_max ||
      self_nc > nc_max || c.cross_nc > nc_max || c.max_keys < c.n_pos || c.max_keys < c.tp ||
      n_gs > kMaxStages)
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
  s.timeline = static_cast<unsigned long long*>(timeline);
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_verify<bf16>(c, s, st) : dispatch_verify<float>(c, s, st);
}

}  // extern "C"
