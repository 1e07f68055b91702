// Descending sort of 64-bit selection keys in global memory, one row of
// p2 keys (a power of two) per query, shared by masked_topk.cu (its keyed
// entry, whose k reaches 65,536) and page_merge.cu (the result page's
// cross-segment selection).
//
// Runs of up to KEY_SORT_RUN keys are bitonic-sorted in shared memory (one
// CTA per run); then each merge pass doubles the run length in global
// memory: a key's place in the merged run is its index in its own run
// plus the number of keys of the partner run that precede it, found by a
// binary search (ties: the first run's keys first, so equal padding keys
// keep distinct places). log2(p2 / KEY_SORT_RUN) passes, no atomics, and
// the result does not depend on thread order.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

// Everything here has internal linkage (the unnamed namespace): each
// library that includes this header keeps its own kernels and its own
// shared-memory opt-in flag. (A function-local static of an inline
// function would be one object shared by every library of the process,
// and the flag set by one library would skip the opt-in of another's
// kernel.)
namespace keysort {
namespace {

constexpr int KEY_SORT_THREADS = 1024;
constexpr int KEY_SORT_RUN = 16384;  // 128 KiB of keys in shared memory

// rows x p2 keys; every run of `run` keys (a power of two) of a row is
// sorted descending in place. grid (p2 / run, rows)
__global__ void __launch_bounds__(KEY_SORT_THREADS)
sort_runs_kernel(unsigned long long* __restrict__ keys, int p2, int run) {
  extern __shared__ unsigned long long a[];
  unsigned long long* base =
      keys + (size_t)blockIdx.y * p2 + (size_t)blockIdx.x * run;
  for (int i = threadIdx.x; i < run; i += blockDim.x) a[i] = base[i];
  __syncthreads();
  for (int kk = 2; kk <= run; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < run; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const bool up = ((i & kk) != 0);  // descending overall
          const unsigned long long x = a[i], y = a[ixj];
          if ((x > y) == up) {
            a[i] = y;
            a[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < run; i += blockDim.x) base[i] = a[i];
}

// merges each pair of sorted runs of `run` keys of src into one sorted
// run of 2 * run keys of dst. grid (chunks, rows)
__global__ void merge_runs_kernel(const unsigned long long* __restrict__ src,
                                  unsigned long long* __restrict__ dst,
                                  int p2, int run) {
  const unsigned long long* s = src + (size_t)blockIdx.y * p2;
  unsigned long long* d = dst + (size_t)blockIdx.y * p2;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < p2;
       i += gridDim.x * blockDim.x) {
    const int pair = i / (2 * run);
    const int off = i - pair * 2 * run;
    const bool first = off < run;
    const int own = first ? off : off - run;
    const unsigned long long* other =
        s + (size_t)pair * 2 * run + (first ? run : 0);
    const unsigned long long x = s[i];
    int lo = 0, hi = run;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const bool before = first ? (other[mid] > x) : (other[mid] >= x);
      if (before)
        lo = mid + 1;
      else
        hi = mid;
    }
    d[(size_t)pair * 2 * run + own + lo] = x;
  }
}

// Sorts every row of keys [rows, p2] descending (p2 a power of two);
// tmp holds as many keys. *sorted is set to the buffer that holds the
// result (keys or tmp). Returns a CUDA error code.
int sort_rows(unsigned long long* keys, unsigned long long* tmp, int rows,
              int p2, unsigned long long** sorted, cudaStream_t st) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        sort_runs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(KEY_SORT_RUN * sizeof(unsigned long long)));
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const int run0 = p2 < KEY_SORT_RUN ? p2 : KEY_SORT_RUN;
  sort_runs_kernel<<<dim3(p2 / run0, rows), KEY_SORT_THREADS,
                     (size_t)run0 * sizeof(unsigned long long), st>>>(
      keys, p2, run0);
  unsigned long long* src = keys;
  unsigned long long* dst = tmp;
  for (int run = run0; run < p2; run <<= 1) {
    int chunks = (p2 + 255) / 256;
    if (chunks > 1024) chunks = 1024;
    merge_runs_kernel<<<dim3(chunks, rows), 256, 0, st>>>(src, dst, p2,
                                                         run);
    unsigned long long* t = src;
    src = dst;
    dst = t;
  }
  *sorted = src;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace keysort
