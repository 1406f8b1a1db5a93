// Storage-type helpers shared by the training kernels: T is float or
// __nv_bfloat16, arithmetic is always fp32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

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
template <typename T> __host__ __device__ constexpr int vec() {
  return 16 / static_cast<int>(sizeof(T));
}

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

// vec<T>() floats rounded to T and stored as 16 bytes at p (16-byte aligned)
template <typename T> __device__ __forceinline__ void store16(T* p, const float* in);
template <> __device__ __forceinline__ void store16<float>(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}
template <> __device__ __forceinline__ void store16<bf16>(bf16* p, const float* in) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// a += b, four floats
__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// v[i] / b rounded to nearest even, in place, for b > 0 normal and rb =
// 1 / b rounded to nearest: the product with the reciprocal, corrected twice
// by the exact remainder (fma); an element beyond 2^100 or below 2^-100 in
// magnitude is scaled by 2^-64 or 2^64 first and back after, both exact.
// The bits `v[i] / b` gives, zeros with their sign, for every finite v[i]
// whose quotient is normal (checked for every finite v at p = 0.05, 0.1, 0.2,
// 0.3, 0.5 and every 17th at p = 0.01 .. 0.99 on an H100); a subnormal
// quotient may differ in its last place.  No branch and no call: the full
// division's slow path is a subroutine call, and ptxas serializes every
// wgmma of a function that holds a call.
template <int N>
__device__ __forceinline__ void div_rn(float (&v)[N], float b, float rb) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float m = fabsf(v[i]);
    const bool big = m > 0x1p100f, small = m < 0x1p-100f;
    const float a = v[i] * (big ? 0x1p-64f : (small ? 0x1p64f : 1.f));
    const float q0 = a * rb;
    const float q1 = fmaf(fmaf(-q0, b, a), rb, q0);
    const float q2 = fmaf(fmaf(-q1, b, a), rb, q1);
    v[i] = (a == 0.f ? q0 : q2) * (big ? 0x1p64f : (small ? 0x1p-64f : 1.f));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace
