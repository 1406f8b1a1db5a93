// The decode-step kernel with inference prenet dropout (decode_step.cu's
// decode_step_kernel<T, R, true>, its C entry points alike), built as a
// library of its own: decode_step.cu holds the kernel and says why.
// ops/decode_step.py loads this library for a step at a prenet-dropout
// rate above 0.

#define TTS_DECODE_STEP_DROPOUT
#include "decode_step.cu"
