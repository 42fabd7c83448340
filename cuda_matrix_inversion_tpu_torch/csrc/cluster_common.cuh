// Thread-block-cluster primitives for sm_90a, shared by the kernels that
// spread one matrix over a cluster: the Newton-Schulz band loops
// (ns_cluster_rounds.cuh: K8, K11; ns_quad_rounds.cuh: K1, K6) and the LU
// band kernel (lu_band.cu: K2 past n = 128).  A cluster barrier, the
// peers' shared memory (mapa, st.shared::cluster), mbarriers that bulk
// copies complete, the bulk copy from this CTA's shared memory into a
// peer's, and the launch of a grid of clusters.
//
// Rules the callers keep (W10): a cluster barrier after the mbarriers'
// initialisation and before any access to a peer's shared memory; no CTA
// overwrites a buffer a peer may still read or a push may still copy; no
// CTA exits while a peer may still access its shared memory.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include <cooperative_groups.h>

#include "async_copy.cuh"

namespace {

// The CTA's generic-proxy shared-memory writes made visible to the bulk
// copies issued after the barrier, then the cluster barrier.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "fence.proxy.async.shared::cta;\n"
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// The CTA's generic-proxy shared-memory writes made visible to the bulk
// copies it issues after a barrier of its own threads (each writer runs
// it before that barrier).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ int cluster_rank() {
  return static_cast<int>(cooperative_groups::this_cluster().block_rank());
}

// The shared::cluster address of `p` (a local shared address) in the
// shared memory of the cluster's CTA `rank`.
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_u32(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_peer_f32(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

// An mbarrier of one arrival; the initialisation made visible to the
// cluster (the next cluster barrier orders it before any peer's copy).
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// An mbarrier of `count` arrivals.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// One arrival of this CTA's threads on its own barrier, releasing their
// earlier shared-memory writes to the threads that wait on it.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One arrival on the mbarrier at the shared::cluster address `bar` (a
// peer's, or this CTA's own): a consumer's release of a buffer whose reads
// it has completed (a barrier of its threads after their last use of the
// values read), before the producer overwrites it.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the phase of parity `parity` of a barrier that peers arrive on
// (mbar_arrive_cluster), acquiring at cluster scope.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The barrier's one arrival of this phase, expecting `bytes` of copies.
__device__ __forceinline__ void mbar_arm(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of parity `parity` of the barrier to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Copy `bytes` (a multiple of 16) of this CTA's shared memory at `src` to
// the shared::cluster address `dst`, completing on the mbarrier at the
// shared::cluster address `bar` in the destination CTA.
__device__ __forceinline__ void push_bulk(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
      "bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(smem_u32(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Launch `kernel` as batch clusters of `clusters` CTAs (`threads` threads,
// `smem` bytes of dynamic shared memory each) on `stream`; the launch's
// error.  A cluster the SMs cannot hold fails here, and the caller raises.
template <typename Kernel, typename... Args>
cudaError_t cluster_launch(Kernel kernel, int clusters, int batch,
                           int threads, size_t smem, cudaStream_t stream,
                           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch) * clusters);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
