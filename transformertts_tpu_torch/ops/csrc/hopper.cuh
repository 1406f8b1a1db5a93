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
// through the transpose bit, as an MN-major operand (its rows are the
// depth K, D is M or N).
//
// Accumulator of m64nNk16, fp32, per thread t of the warpgroup (warp w =
// t / 32, g = (t % 32) / 4, c = t % 4): element i of N / 2 holds
//   row 16 w + g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 c + i % 2.
// (acc_row / acc_col below.)  The A operand from registers (4 x bf16x2 per
// thread for 16 columns of depth) has the same layout, so an accumulator's
// k-th 16 columns, packed pairwise, are the A operand of a product over
// those columns.
//
// A tile is read K-major (its rows are M or N, its columns the depth K:
// step the descriptor by 2 per 16 columns) or, with the operand's transpose
// bit, MN-major (its rows are the depth K, its columns M or N: step by 2D / 8
// per 16 rows).  bf16 takes the transpose bit for A from shared memory as
// well as for B.

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

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

// The thread's accumulator row h (0, 1) and the column of element i inside
// its 64-column tile.
__device__ __forceinline__ int acc_row(int tid, int h) {
  return 16 * (tid / 32) + (tid % 32) / 4 + 8 * h;
}
__device__ __forceinline__ int acc_col(int tid, int i) {
  return 8 * (i / 4) + 2 * (tid % 4) + i % 2;
}

// 16 bytes global -> shared, asynchronous; zeros when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared, asynchronous (through L1: any 4-byte aligned address)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// until at most N of this thread's committed copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// this thread's shared-memory writes (stores, landed cp.async) visible to wgmma
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows row0 .. row0 + kR - 1 of a (n_rows, D) bf16 matrix with row stride
// `stride` (elements) into the swizzled tile at shared address dst, by the
// 128 threads of a warpgroup; rows past n_rows as zeros.  A thread copies
// chunk tid % (D / 8) of rows tid / (D / 8) + 128 / (D / 8) * i: one swizzled
// offset and one source pointer, computed once.
template <int D, int kR = 64>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const __nv_bfloat16* src,
                                                long long stride, int row0, int n_rows,
                                                int tid) {
  constexpr int kChunks = D / 8, kStep = 128 / kChunks;  // rows apart of a thread's chunks
  const int r = tid / kChunks, c = tid % kChunks;
  const uint32_t d0 = dst + swizzled<D>(r, c);  // the swizzle repeats every kStep rows
  const __nv_bfloat16* p = src + static_cast<long long>(row0 + r) * stride + c * 8;
#pragma unroll
  for (int i = 0; i < kR / kStep; ++i) {
    const bool valid = row0 + r + i * kStep < n_rows;
    cp_async16(d0 + i * kStep * 2 * D, valid ? p + i * kStep * stride : src, valid);
  }
}

// The same for columns col0 .. col0 + D - 1 of a matrix with n_cols columns
// (a multiple of 8): chunks past n_cols as zeros too.
template <int D>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const __nv_bfloat16* src,
                                                long long stride, int row0, int n_rows, int col0,
                                                int n_cols, int tid) {
  constexpr int kChunks = D / 8, kStep = 128 / kChunks;
  const int r = tid / kChunks, c = tid % kChunks;
  const bool col_ok = col0 + 8 * c < n_cols;
  const uint32_t d0 = dst + swizzled<D>(r, c);
  const __nv_bfloat16* p = src + static_cast<long long>(row0 + r) * stride + col0 + c * 8;
#pragma unroll
  for (int i = 0; i < 64 / kStep; ++i) {
    const bool valid = col_ok && row0 + r + i * kStep < n_rows;
    cp_async16(d0 + i * kStep * 2 * D, valid ? p + i * kStep * stride : src, valid);
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

// the 128 threads of one warpgroup meet at named barrier `id` (1 .. 15)
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}
// named barrier `id` over `n` threads: wait there, or only arrive (no wait)
__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The same descriptor with leading-dimension offset lbo bytes: for an
// MN-major operand wider than one swizzle atom, the distance between its
// 64-column tiles.
template <int D>
__device__ __forceinline__ uint64_t make_desc_lbo(uint32_t addr, uint32_t lbo) {
  return (make_desc<D>(addr) & ~(0x3FFFull << 16)) | (static_cast<uint64_t>(lbo >> 4) << 16);
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
// until at most N committed groups of products are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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

// d (64 x 32) += A (64 x 16) B (16 x 32), both from shared memory; with kTA
// / kTB = 1 the operand is MN-major (its tile's rows are the depth), else
// K-major
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : TTS_ACC8(d, 0), TTS_ACC8(d, 8)
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
}

#define TTS_OUT8(d, o)                                                                      \
  "=f"(d[o + 0]), "=f"(d[o + 1]), "=f"(d[o + 2]), "=f"(d[o + 3]), "=f"(d[o + 4]),           \
      "=f"(d[o + 5]), "=f"(d[o + 6]), "=f"(d[o + 7])

// d = A B^T, as wgmma_ss_n64 but d's old values neither read nor kept: the
// first product of a sum.  (An accumulator that the products read must be
// defined by a wgmma or before the products in flight began; a move the
// compiler places to keep old values alive serializes every wgmma, C7515.)
__device__ __forceinline__ void wgmma_ss_n64_first(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : TTS_OUT8(d, 0), TTS_OUT8(d, 8), TTS_OUT8(d, 16), TTS_OUT8(d, 24)
      : "l"(da), "l"(db), "r"(0));
}
// d = A B (16 x 32), both K-major, the first product of a sum (as above)
__device__ __forceinline__ void wgmma_ss_n32_first(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : TTS_OUT8(d, 0), TTS_OUT8(d, 8)
      : "l"(da), "l"(db), "r"(0));
}

#undef TTS_OUT8

// d (64 x 256) += A (64 x 16) B (16 x 256), both from shared memory, as
// wgmma_ss_n32; an MN-major B spans tiles of 64 columns whose distance its
// descriptor holds (make_desc_lbo)
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : TTS_ACC8(d, 0), TTS_ACC8(d, 8), TTS_ACC8(d, 16), TTS_ACC8(d, 24), TTS_ACC8(d, 32), TTS_ACC8(d, 40), TTS_ACC8(d, 48), TTS_ACC8(d, 56), TTS_ACC8(d, 64), TTS_ACC8(d, 72), TTS_ACC8(d, 80), TTS_ACC8(d, 88), TTS_ACC8(d, 96), TTS_ACC8(d, 104), TTS_ACC8(d, 112), TTS_ACC8(d, 120)
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
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

// d (64 x 256) += A (64 x 16, registers) B (16 x 256, K-major in shared: the
// tile's 256 rows are N, its columns the depth, one swizzle atom wide)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : TTS_ACC8(d, 0), TTS_ACC8(d, 8), TTS_ACC8(d, 16), TTS_ACC8(d, 24), TTS_ACC8(d, 32), TTS_ACC8(d, 40), TTS_ACC8(d, 48), TTS_ACC8(d, 56), TTS_ACC8(d, 64), TTS_ACC8(d, 72), TTS_ACC8(d, 80), TTS_ACC8(d, 88), TTS_ACC8(d, 96), TTS_ACC8(d, 104), TTS_ACC8(d, 112), TTS_ACC8(d, 120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef TTS_ACC8

}  // namespace
