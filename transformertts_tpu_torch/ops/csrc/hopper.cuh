// Hopper (sm_90a) building blocks in inline PTX: asynchronous copies into
// swizzled shared-memory tiles, shared-memory matrix descriptors, and the
// warpgroup matrix multiply (wgmma) with bf16 operands and fp32 sums.
//
// Tiles are (rows, D) bf16 with D = 32 or 64, one row of 2 D bytes per row
// of the tile, stored in the swizzled layout wgmma reads: the 16-byte chunk
// c of row r lies at r * 2D + 16 (c ^ f(r)), with f(r) = r % 8 for 128-byte
// rows (D = 64, "128B" swizzle) and (r / 2) % 4 for 64-byte rows (D = 32,
// "64B" swizzle).  A tile starts on a 1,024-byte boundary.  The same tile
// serves as a K-major operand (its rows are M or N, D is the depth K) and,
// through the transpose bit, as an MN-major B operand (its rows are the
// depth K, D is N).
//
// Accumulator of m64nNk16, fp32, per thread t of the warpgroup (warp w =
// t / 32, g = (t % 32) / 4, c = t % 4): element i of N / 2 holds
//   row 16 w + g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 c + i % 2.
// The A operand from registers (4 x bf16x2 per thread for 16 columns of
// depth) has the same layout, so an accumulator's k-th 16 columns, packed
// pairwise, are the A operand of a product over those columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of chunk c (16 bytes) of row r in a swizzled tile of width D
template <int D>
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  constexpr int kMask = D == 64 ? 7 : 3;
  const uint32_t off = static_cast<uint32_t>(r * 2 * D + c * 16);
  return off ^ (((off >> 7) & kMask) << 4);
}

// 16 bytes global -> shared, asynchronous; zeros when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// this thread's shared-memory writes (stores, landed cp.async) visible to wgmma
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows row0 .. row0 + 63 of a (n_rows, D) bf16 matrix with row stride
// `stride` (elements) into the swizzled tile at shared address dst, by the
// 128 threads of a warpgroup; rows past n_rows as zeros.
template <int D>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const __nv_bfloat16* src,
                                                long long stride, int row0, int n_rows,
                                                int tid) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = 0; i < 64 * kChunks / 128; ++i) {
    const int idx = tid + 128 * i, r = idx / kChunks, c = idx % kChunks;
    const bool valid = row0 + r < n_rows;
    const __nv_bfloat16* p = valid ? src + static_cast<long long>(row0 + r) * stride + c * 8 : src;
    cp_async16(dst + swizzled<D>(r, c), p, valid);
  }
}

// Shared-memory matrix descriptor of a swizzled tile of width D: 8-row
// groups 8 * 2D bytes apart, layout 128B (D = 64) or 64B (D = 32) swizzle.
// The leading-dimension offset is unused by these layouts (one swizzle atom
// spans the whole width).  Add 2 per 32 bytes to step along K inside a row
// (K-major), or 2D / 8 per row to step over rows (MN-major).
template <int D>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  constexpr uint64_t kLayout = D == 64 ? 1 : 2;
  constexpr uint64_t kSbo = (8 * 2 * D) >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (kSbo << 32) |
         (kLayout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of the accumulator across
// the asynchronous product's issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A operand of depth 16 at columns 16 kk .. 16 kk + 15 of an accumulator.
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&d)[N], int kk, uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
    asm volatile("" : "+r"(a[i])::"memory");  // packed before the wgmma fence
  }
}

#define TTS_ACC8(d, o)                                                                      \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]),           \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

// d (64 x 64) += A (64 x 16, K-major, shared) B^T (B: 64 x 16, K-major, shared)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : TTS_ACC8(d, 0), TTS_ACC8(d, 8), TTS_ACC8(d, 16), TTS_ACC8(d, 24)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x N) += A (64 x 16, registers) B (16 x N, MN-major in shared: the
// depth runs over the tile's rows)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TTS_ACC8(d, 0), TTS_ACC8(d, 8), TTS_ACC8(d, 16), TTS_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : TTS_ACC8(d, 0), TTS_ACC8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef TTS_ACC8

}  // namespace
