// The cp.async helpers of the kernels that stage rows through a ring in
// shared memory (knn_exact.cu, kmeans_step.cu, maxsim_exact.cu,
// nested_join.cu, nested_aggs.cu): 16- and 4-byte copies from device
// memory, a group's commit and its wait.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// component d of v
__device__ __forceinline__ float lane4(const float4& v, int d) {
  return d == 0 ? v.x : d == 1 ? v.y : d == 2 ? v.z : v.w;
}

}  // namespace
