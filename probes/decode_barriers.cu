// Probe for the decode-step kernel's choice of barrier: a grid barrier over
// all SMs (a counter and a generation word in global memory, in four forms)
// against barrier.cluster over one cluster of 16 or 8 blocks (with a
// distributed-shared-memory store each round), and the rate at which 132 vs
// 16 blocks pull a step's weights (warm in L2) into shared memory with
// cp.async.bulk.  Host functions time one launch of many rounds with CUDA
// events.  Built and run by decode_barriers.py.
#include <cuda_runtime.h>
#include <cstdint>
#include <cstdio>
#include "../transformertts_tpu_torch/ops/csrc/sync.cuh"

namespace {
__device__ __forceinline__ uint32_t ld_acquire_gpu(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release_gpu(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ void st_relaxed_gpu(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
// Returns the old value; acquire and release at GPU scope.
__device__ __forceinline__ uint32_t atom_add_acq_rel_gpu(uint32_t* p, uint32_t v) {
  uint32_t old;
  asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// Until the word at p differs from `value` (acquire), or trap.
__device__ __forceinline__ void spin_while_equal(const uint32_t* p, uint32_t value) {
  const unsigned long long t0 = global_timer_ns();
  while (ld_acquire_gpu(p) == value) {
    if (global_timer_ns() - t0 > kSpinLimitNs) __trap();
  }
}

}  // namespace

__global__ void grid_barrier_kernel(uint32_t* state, int iters, int n_blocks) {
  __shared__ uint32_t gen0;
  if (threadIdx.x == 0) gen0 = ld_acquire_gpu(state + 1);
  __syncthreads();
  for (int i = 0; i < iters; ++i) {
    __syncthreads();
    if (threadIdx.x == 0) {
      const uint32_t expect = gen0 + i;
      if (atom_add_acq_rel_gpu(state, 1u) == static_cast<uint32_t>(n_blocks) - 1u) {
        st_relaxed_gpu(state, 0u);
        st_release_gpu(state + 1, i == iters - 1 ? gen0 : expect + 1u);
      } else {
        spin_while_equal(state + 1, expect);
      }
    }
    __syncthreads();
  }
}

__global__ void cluster_barrier_kernel(int iters, float* out, uint32_t cluster) {
  __shared__ float slots[32];
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  float acc = 0.f;
  for (int i = 0; i < iters; ++i) {
    if (threadIdx.x == 0) {  // one float into the next block's shared memory
      uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(&slots[rank % 32])), remote;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"((rank + 1) % cluster));
      asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(remote), "f"(static_cast<float>(i)) : "memory");
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    acc += slots[(rank + cluster - 1) % cluster % 32];
  }
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

// Every block pulls `per_block` bytes (its part of `buf`) into shared memory
// in pieces of at most `piece` bytes, `reps` times.
__global__ void stream_kernel(const uint8_t* buf, int per_block, int piece, int reps) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) { mbar_init(&bar, 1); fence_mbarrier_init(); }
  __syncthreads();
  uint32_t phase = 0;
  for (int r = 0; r < reps; ++r)
    for (int off = 0; off < per_block; off += piece) {
      const int n = per_block - off < piece ? per_block - off : piece;
      if (threadIdx.x == 0) {
        mbar_arrive_expect_tx(&bar, n);
        bulk_copy_g2s(smem, buf + static_cast<size_t>(blockIdx.x) * per_block + off, n, &bar);
      }
      mbar_wait(&bar, phase);
      phase ^= 1;
      __syncthreads();
    }
}


__device__ __forceinline__ void red_release_add(uint32_t* p, uint32_t v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ uint32_t ld_relaxed_gpu(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
// variant 1: CG style, fence + relaxed atomicAdd, relaxed spin then fence
// variant 2: fire-and-forget red.release arrivals; block 0 gathers and releases
// variant 3: a flag word per block (its generation), block 0's warps poll all flags
__global__ void grid_barrier_variant(uint32_t* state, int iters, int n_blocks, int variant) {
  __shared__ uint32_t gen0;
  if (threadIdx.x == 0) gen0 = ld_acquire_gpu(state + 1);
  __syncthreads();
  for (int i = 0; i < iters; ++i) {
    const uint32_t expect = gen0 + i;
    const uint32_t next = i == iters - 1 ? gen0 : expect + 1u;
    __syncthreads();
    if (variant == 1) {
      if (threadIdx.x == 0) {
        __threadfence();
        if (atomicAdd(state, 1u) == static_cast<uint32_t>(n_blocks) - 1u) {
          state[0] = 0;
          __threadfence();
          atomicExch(state + 1, next);
        } else {
          while (ld_relaxed_gpu(state + 1) == expect) {}
          __threadfence();
        }
      }
    } else if (variant == 2) {
      if (blockIdx.x == 0) {
        if (threadIdx.x == 0) {
          const unsigned long long t0 = global_timer_ns();
          while (ld_acquire_gpu(state) != static_cast<uint32_t>(n_blocks) - 1u)
            if (global_timer_ns() - t0 > kSpinLimitNs) __trap();
          st_relaxed_gpu(state, 0u);
          st_release_gpu(state + 1, next);
        }
      } else if (threadIdx.x == 0) {
        red_release_add(state, 1u);
        spin_while_equal(state + 1, expect);
      }
    } else if (variant == 4) {  // monotonic counter: red.release arrivals, everyone polls it
      if (threadIdx.x == 0) {
        red_release_add(state, 1u);
        const uint32_t target = static_cast<uint32_t>(n_blocks) * (i + 1);
        const unsigned long long t0 = global_timer_ns();
        while (ld_acquire_gpu(state) < target)
          if (global_timer_ns() - t0 > kSpinLimitNs) __trap();
      }
    } else {  // 3: flags at state[2 + block]
      if (blockIdx.x == 0) {
        if (threadIdx.x < 32) {
          const unsigned long long t0 = global_timer_ns();
          for (int g = 1 + threadIdx.x; g < n_blocks; g += 32)
            while (ld_acquire_gpu(state + 2 + g) != expect + 1u)
              if (global_timer_ns() - t0 > kSpinLimitNs) __trap();
          __syncwarp();
          if (threadIdx.x == 0) st_release_gpu(state + 1, next);
        }
      } else if (threadIdx.x == 0) {
        st_release_gpu(state + 2 + blockIdx.x, expect + 1u);
        spin_while_equal(state + 1, expect);
      }
    }
    __syncthreads();
  }
  if (variant == 3 && threadIdx.x == 0 && blockIdx.x > 0) state[2 + blockIdx.x] = gen0;  // (probe only)
  if (variant == 4 && threadIdx.x == 0) {  // the last block out resets the counter
    if (atomicAdd(state + 2, 1u) == static_cast<uint32_t>(n_blocks) - 1u) {
      state[0] = 0;
      state[2] = 0;
    }
  }
}

extern "C" {
float probe_grid(int blocks, int iters) {
  uint32_t* state; cudaMalloc(&state, 8); cudaMemset(state, 0, 8);
  cudaFuncSetAttribute(grid_barrier_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
  cudaLaunchConfig_t cfg = {}; cfg.gridDim = dim3(blocks); cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = 200 * 1024;
  cudaLaunchAttribute a[1]; a[0].id = cudaLaunchAttributeCooperative; a[0].val.cooperative = 1;
  cfg.attrs = a; cfg.numAttrs = 1;
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  cudaLaunchKernelEx(&cfg, grid_barrier_kernel, state, 10, blocks);
  cudaEventRecord(e0);
  cudaLaunchKernelEx(&cfg, grid_barrier_kernel, state, iters, blocks);
  cudaEventRecord(e1); cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  uint32_t h[2]; cudaMemcpy(h, state, 8, cudaMemcpyDeviceToHost);
  if (cudaGetLastError() != cudaSuccess || h[0] != 0 || h[1] != 0) { printf("grid barrier fault: %u %u\n", h[0], h[1]); return -1; }
  cudaFree(state);
  return ms * 1000.f / iters;  // us per barrier
}

float probe_variant(int blocks, int iters, int variant) {
  uint32_t* state; cudaMalloc(&state, 4 * 1024); cudaMemset(state, 0, 4 * 1024);
  cudaFuncSetAttribute(grid_barrier_variant, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
  cudaLaunchConfig_t cfg = {}; cfg.gridDim = dim3(blocks); cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = 200 * 1024;
  cudaLaunchAttribute a[1]; a[0].id = cudaLaunchAttributeCooperative; a[0].val.cooperative = 1;
  cfg.attrs = a; cfg.numAttrs = 1;
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  cudaLaunchKernelEx(&cfg, grid_barrier_variant, state, 10, blocks, variant);
  cudaDeviceSynchronize();
  cudaMemset(state, 0, 4 * 1024);
  cudaEventRecord(e0);
  cudaLaunchKernelEx(&cfg, grid_barrier_variant, state, iters, blocks, variant);
  cudaEventRecord(e1); cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  if (cudaGetLastError() != cudaSuccess) return -1;
  cudaFree(state);
  return ms * 1000.f / iters;
}

float probe_cluster(int cluster, int iters) {
  float* out; cudaMalloc(&out, 4096);
  cudaFuncSetAttribute(cluster_barrier_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {}; cfg.gridDim = dim3(cluster); cfg.blockDim = dim3(256);
  cudaLaunchAttribute a[1]; a[0].id = cudaLaunchAttributeClusterDimension;
  a[0].val.clusterDim.x = cluster; a[0].val.clusterDim.y = 1; a[0].val.clusterDim.z = 1;
  cfg.attrs = a; cfg.numAttrs = 1;
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  cudaError_t err = cudaLaunchKernelEx(&cfg, cluster_barrier_kernel, 10, out, (uint32_t)cluster);
  if (err != cudaSuccess) { printf("cluster %d launch: %s\n", cluster, cudaGetErrorString(err)); return -1; }
  cudaEventRecord(e0);
  cudaLaunchKernelEx(&cfg, cluster_barrier_kernel, iters, out, (uint32_t)cluster);
  cudaEventRecord(e1); cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  if (cudaGetLastError() != cudaSuccess) return -1;
  cudaFree(out);
  return ms * 1000.f / iters;
}

float probe_stream(int blocks, long total, int reps) {
  uint8_t* buf; cudaMalloc(&buf, total); cudaMemset(buf, 1, total);
  const int per_block = static_cast<int>((total / blocks) / 16 * 16);
  const int piece = per_block < 200 * 1024 ? per_block : 100 * 1024;
  cudaFuncSetAttribute(stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  stream_kernel<<<blocks, 256, 200 * 1024>>>(buf, per_block, piece, 2);
  cudaEventRecord(e0);
  stream_kernel<<<blocks, 256, 200 * 1024>>>(buf, per_block, piece, reps);
  cudaEventRecord(e1); cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  if (cudaGetLastError() != cudaSuccess) return -1;
  cudaFree(buf);
  return ms * 1000.f / reps;  // us per pass over `total` bytes
}
}
