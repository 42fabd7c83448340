// Asynchronous global -> shared copies on sm_90a (cp.async), shared by the
// kernels that stage device memory in shared memory (gp.cu through
// ns_mma.cuh, lu_bign.cu).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous global -> shared copies (16 bytes: both addresses 16-byte
// aligned; 4 bytes: any float), then wait for all of the thread's copies.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}
