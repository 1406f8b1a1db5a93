// Dropout keep bit of one element as a pure function of its logical index.
//
// Device twin of transformertts_tpu/ops/pallas/dropout_mask.py:keep_mask (and
// of keep_mask in ../dropout_mask.py, which is bit-equal to it): a
// SplitMix-style counter hash in wrapping uint32 arithmetic,
//
//   base = fmix(seed * 0x9E3779B9 ^ fmix(salt * 0xBF58476D))
//   keep = fmix(counter * 0x9E3779B9 ^ base) >= uint32(p * 2^32)
//
// with fmix the murmur3 32-bit finalizer and counter = row * cols + col
// inside the block that `salt` names.  The kernels that drop elements
// (flash_attention.cu, fused_ln.cu) regenerate the mask in their backward
// from the same (seed, salt, counter), so no mask is ever stored.

#pragma once

#include <cstdint>

namespace {

__host__ __device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Per-(seed, salt) base; compute once per block of the mask's geometry.
__host__ __device__ __forceinline__ uint32_t mask_base(uint32_t seed, uint32_t salt) {
  return fmix32((seed * 0x9E3779B9u) ^ fmix32(salt * 0xBF58476Du));
}

__host__ __device__ __forceinline__ bool mask_keep(uint32_t base, uint32_t counter,
                                                   uint32_t threshold) {
  return fmix32((counter * 0x9E3779B9u) ^ base) >= threshold;
}

}  // namespace
