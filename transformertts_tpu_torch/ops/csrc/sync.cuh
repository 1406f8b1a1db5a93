// Synchronisation and data movement for persistent kernels on Hopper
// (sm_90a), in inline PTX:
//
// - bulk asynchronous copies global -> shared (cp.async.bulk, the TMA unit's
//   plain-bytes form: no tensor map) that complete on an mbarrier in shared
//   memory, and the mbarrier operations around them;
// - thread block clusters: a block's rank, the cluster barrier, and stores
//   into another block's shared memory (distributed shared memory).
//
// An mbarrier wait traps after kSpinLimitNs on the global timer, so a fault
// in a copy's bookkeeping ends the launch with an error instead of hanging
// the card.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned long long kSpinLimitNs = 4000000000ull;  // 4 s

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long global_timer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One thread: an mbarrier expecting `count` arrivals, visible to the block
// (and to the async proxy) once fence_mbarrier_init() and a __syncthreads()
// have followed.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` from bulk copies on this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(shared_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Until the phase with parity `parity` of the mbarrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = shared_addr(bar);
  const unsigned long long t0 = global_timer_ns();
  for (uint32_t n = 1;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (n % 1024 == 0 && global_timer_ns() - t0 > kSpinLimitNs) __trap();
  }
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global to
// shared memory by the TMA unit; completes on `bar`'s transaction count.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          shared_addr(dst)),
      "l"(src), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
}

// Orders this block's earlier generic-proxy accesses of shared memory
// before later async-proxy ones (a bulk copy into bytes just read).
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The cache line at p into this SM's L1, without waiting for it.
__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

// This block's rank in its cluster, and the cluster's index in the grid.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_index() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

// Barrier over every thread of the cluster: shared-memory writes made before
// it, local or remote, are visible to every block of the cluster after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}
// The two halves, for a first barrier that only has to show that every block
// of the cluster has started (its shared memory may then be written).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// v into the shared memory of block `rank` of the cluster, at the offset
// `local` has in this block (distributed shared memory).
__device__ __forceinline__ void dsmem_store(const float* local, uint32_t rank, float v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(shared_addr(local)), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v) : "memory");
}

}  // namespace
