// K23 nested_aggs: the `nested` and `reverse_nested` aggregations for B
// queries over a segment's Dp rows, one C entry each.
//
// Replaces opensearch_tpu/search/aggs/engine.py:1559-1577 (nested) and
// :1579-1609 (reverse_nested), the reference's scatter-path kinds.
//
// nested_agg: from the eligible rows mask bool [B, Dp] and their bucket
// parent_eff int32 [B, Dp] (-1: none; the context collapsed per query),
// each live nested row on the query's path (nested_path == path_ord[b])
// whose root is eligible and in a bucket is `own` and takes the root's
// bucket (child_eff; -1 elsewhere); counts int32 [B, card] counts them.
//
// reverse_nested_agg: over the selected nested rows (eligible, in a
// bucket), the distinct roots per bucket, counts int32 [B, card], and each
// root's bucket root_eff int32 [B, Dp] (the largest of its rows' buckets,
// -1 for none; own = root_eff >= 0).
//
// What bounds it on an H100: nested, bytes (a gather of the root's mask
// and bucket per nested row, 14 B a (query, row) in and out);
// reverse_nested, the sort of one 64-bit key a (query, row).
//
// Design. Counts are integer atomics (exact, order-free), one per distinct
// bucket of a warp (__match_any_sync), and the root bucket an atomicMax
// of the warp's maximum per root. reverse_nested dedups the (bucket, root) pairs as
// the reference does, by sorting: one key a lane, (bucket + 1) << 32 |
// root for a selected row and 0 otherwise, sorted descending per query by
// key_sort.cuh (the sort of K3-keyed and K21); a run's first key counts
// one root for its bucket.

#include <cuda_runtime.h>
#include <cstdint>

#include "key_sort.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
nested_kernel(const uint8_t* __restrict__ mask,
              const int* __restrict__ parent_eff,
              const uint8_t* __restrict__ live,
              const int* __restrict__ nested_path,
              const int* __restrict__ parent_ptr,
              const int* __restrict__ path_ord, int Dp, int card,
              uint8_t* __restrict__ own, int* __restrict__ child_eff,
              int* __restrict__ counts) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  const size_t base = (size_t)b * Dp;
  int ce = -1;
  if (d < Dp) {
    const int po = path_ord[b];
    const int p = parent_ptr[d];
    if (p >= 0 && po >= 0 && live[d] != 0 && nested_path[d] == po &&
        mask[base + p] != 0) {
      const int pe = parent_eff[base + p];
      if (pe >= 0 && pe < card) ce = pe;
    }
    own[base + d] = ce >= 0 ? 1 : 0;
    child_eff[base + d] = ce;
  }
  // one atomic per distinct bucket of a warp (every lane takes part)
  const unsigned peers = __match_any_sync(0xffffffffu, ce);
  if (ce >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&counts[(size_t)b * card + ce], __popc(peers));
}

// keys [B, p2]: one key a row (0 past Dp and for unselected rows), and
// the root's bucket by atomicMax (root_eff starts at -1)
__global__ void __launch_bounds__(THREADS)
reverse_keys_kernel(const uint8_t* __restrict__ mask,
                    const int* __restrict__ parent_eff,
                    const int* __restrict__ parent_ptr, int Dp, int p2,
                    int card, unsigned long long* __restrict__ keys,
                    int* __restrict__ root_eff) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  int root = -1, pe = -1;
  if (d < Dp) {
    const size_t i = (size_t)b * Dp + d;
    const int p = parent_ptr[d];
    const int e = parent_eff[i];
    if (mask[i] != 0 && p >= 0 && e >= 0 && e < card) {
      root = p;
      pe = e;
    }
  }
  if (d < p2)
    keys[(size_t)b * p2 + d] =
        root >= 0 ? ((unsigned long long)(pe + 1) << 32) | (unsigned)root
                  : 0ull;
  // one atomicMax per distinct root of a warp (every lane takes part)
  const unsigned peers = __match_any_sync(0xffffffffu, root);
  if (root >= 0) {
    const int m = __reduce_max_sync(peers, pe);
    if ((int)(threadIdx.x & 31) == __ffs(peers) - 1)
      atomicMax(&root_eff[(size_t)b * Dp + root], m);
  }
}

// a run's first key counts one distinct root for its bucket (one atomic
// per distinct bucket of a warp)
__global__ void __launch_bounds__(THREADS)
run_count_kernel(const unsigned long long* __restrict__ sorted, int p2,
                 int card, int* __restrict__ counts) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  int bucket = -1;
  if (j < p2) {
    const unsigned long long* row = sorted + (size_t)b * p2;
    const unsigned long long k = row[j];
    if (k != 0ull && (j == 0 || row[j - 1] != k))
      bucket = (int)(k >> 32) - 1;
  }
  const unsigned peers = __match_any_sync(0xffffffffu, bucket);
  if (bucket >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&counts[(size_t)b * card + bucket], __popc(peers));
}

__global__ void __launch_bounds__(THREADS)
fill_kernel(int* __restrict__ out, size_t n, int v) {
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i < n) out[i] = v;
}

__global__ void __launch_bounds__(THREADS)
own_kernel(const int* __restrict__ root_eff, size_t n,
           uint8_t* __restrict__ own) {
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i < n) own[i] = root_eff[i] >= 0 ? 1 : 0;
}

unsigned blocks_of(size_t n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

// mask bool, parent_eff int32 [B, Dp]; live bool, nested_path, parent_ptr
// int32 [Dp]; path_ord int32 [B]; own bool, child_eff int32 [B, Dp];
// counts int32 [B, card], zeroed by the caller.
extern "C" int nested_agg(const uint8_t* mask, const int* parent_eff,
                          const uint8_t* live, const int* nested_path,
                          const int* parent_ptr, const int* path_ord, int B,
                          int Dp, int card, uint8_t* own, int* child_eff,
                          int* counts, void* stream) {
  if (B == 0 || Dp == 0) return 0;
  nested_kernel<<<dim3(blocks_of(Dp), B), THREADS, 0,
                  (cudaStream_t)stream>>>(mask, parent_eff, live,
                                          nested_path, parent_ptr, path_ord,
                                          Dp, card, own, child_eff, counts);
  return (int)cudaGetLastError();
}

// mask bool, parent_eff int32 [B, Dp]; parent_ptr int32 [Dp]; p2 the
// power of two >= Dp; keys: 2 * B * p2 64-bit words of scratch; own bool,
// root_eff int32 [B, Dp]; counts int32 [B, card], zeroed by the caller.
extern "C" int reverse_nested_agg(const uint8_t* mask, const int* parent_eff,
                                  const int* parent_ptr, int B, int Dp,
                                  int p2, int card, unsigned long long* keys,
                                  uint8_t* own, int* root_eff, int* counts,
                                  void* stream) {
  if (p2 < Dp || (p2 & (p2 - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || Dp == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t n = (size_t)B * Dp;
  fill_kernel<<<blocks_of(n), THREADS, 0, st>>>(root_eff, n, -1);
  reverse_keys_kernel<<<dim3(blocks_of(p2), B), THREADS, 0, st>>>(
      mask, parent_eff, parent_ptr, Dp, p2, card, keys, root_eff);
  unsigned long long* sorted = nullptr;
  const int e = keysort::sort_rows(keys, keys + (size_t)B * p2, B, p2,
                                   &sorted, st);
  if (e != 0) return e;
  run_count_kernel<<<dim3(blocks_of(p2), B), THREADS, 0, st>>>(sorted, p2,
                                                               card, counts);
  own_kernel<<<blocks_of(n), THREADS, 0, st>>>(root_eff, n, own);
  return (int)cudaGetLastError();
}

extern "C" const char* nested_aggs_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
