// K21 row_merge: the merge of the multi-shard query phase on one card, and
// its key entry row_value_key.
//
// Replaces opensearch_tpu/parallel/distributed.py's runner merge
// (local_query_phase: the intra-device top-k over the packed rows, the
// all_gather, the replicated top-k and the psum of totals) with
// opensearch_tpu/ops/topk.py:value_merge_key for numeric sorts.
//
// row_value_key: out f32 [Dp], a row's merge key of a numeric sort:
// unique_f32[clip(max_rank)] (desc) or -unique_f32[clip(min_rank)] (asc),
// MISSING_VALUE_KEY (-1e30) where the doc has no value. One thread a doc.
//
// row_merge: R <= 8 rows of K3's keyed output (keys | scores | indices |
// total, 3 k_r + 1 words at the start of row r of an [R, W] buffer) merged
// into the k best, out f32 [4k + 1 + R]: keys | scores | rows | ords (the
// last two as int32 bits) | the total | the R pruned counts. The order is
// lax.top_k's over the row-major concatenation: key descending (-0.0 below
// +0.0), then the lowest position, i.e. row ascending, then rank in row.
//
// What bounds it on an H100: latency. At k = 10 the rows hold 50-80 lanes;
// at k = 65,536 and 8 rows 524,288 lanes (4 MB of 64-bit words) are sorted
// in global memory. Three short launches plus key_sort.cuh's passes.
//
// Design (as K14 page_merge): launch 1 writes one unique 64-bit word per
// lane, (order-preserving u32 of the key) << 32 | ~position; key_sort.cuh
// sorts them descending; launch 3 gathers the first k winners' lanes and
// writes the packed output, and block 0 adds the row totals in row order
// (integers: exact) and copies the pruned counts.

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "key_sort.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_ROWS = 8;
constexpr float MISSING_VALUE_KEY = -1e30f;

// each row's k_r and its first position in the concatenation
struct RowTable {
  int k[MAX_ROWS];
  int off[MAX_ROWS + 1];
};

__device__ __forceinline__ unsigned ord_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float ord_val(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__global__ void __launch_bounds__(THREADS)
value_key_kernel(const float* __restrict__ uniq, const int* __restrict__ rank,
                 const uint8_t* __restrict__ exists, int n_uniq, int Dp,
                 int desc, float* __restrict__ out) {
  const int hi = n_uniq - 1;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < Dp;
       i += gridDim.x * blockDim.x) {
    int r = rank[i];
    r = r < 0 ? 0 : (r > hi ? hi : r);
    const float v = uniq[r];
    out[i] = exists[i] ? (desc ? v : -v) : MISSING_VALUE_KEY;
  }
}

// grid (chunks, R): lane j of row r
__global__ void __launch_bounds__(THREADS)
rekey_kernel(const float* __restrict__ buf, int W, RowTable tab,
             unsigned long long* __restrict__ words) {
  const int r = blockIdx.y;
  const int kr = tab.k[r];
  const float* row = buf + (size_t)r * W;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < kr;
       j += gridDim.x * blockDim.x) {
    const int pos = tab.off[r] + j;
    words[pos] = ((unsigned long long)ord_key(row[j]) << 32) |
                 (0xffffffffu - (unsigned)pos);
  }
}

// grid (chunks): output slot j
__global__ void __launch_bounds__(THREADS)
gather_kernel(const float* __restrict__ buf, int W, int R, RowTable tab,
              int L, const unsigned long long* __restrict__ sorted, int k,
              const int* __restrict__ pruned, int* __restrict__ out) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < k;
       j += gridDim.x * blockDim.x) {
    if (j < L) {
      const unsigned long long word = sorted[j];
      const int pos = (int)(0xffffffffu - (unsigned)word);
      int r = 0;
      while (r + 1 < R && tab.off[r + 1] <= pos) ++r;
      const int kr = tab.k[r];
      const int lane = pos - tab.off[r];
      const float* row = buf + (size_t)r * W;
      out[j] = __float_as_int(ord_val((unsigned)(word >> 32)));
      out[k + j] = __float_as_int(row[kr + lane]);
      out[2 * k + j] = r;
      out[3 * k + j] = __float_as_int(row[2 * kr + lane]);
    } else {
      out[j] = __float_as_int(-INFINITY);
      out[k + j] = 0;
      out[2 * k + j] = 0;
      out[3 * k + j] = 0;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int total = 0;
    for (int r = 0; r < R; ++r)
      total += __float_as_int(buf[(size_t)r * W + 3 * tab.k[r]]);
    out[4 * k] = total;
    for (int r = 0; r < R; ++r) out[4 * k + 1 + r] = pruned[r];
  }
}

int chunks_for(int n) {
  int g = (n + THREADS - 1) / THREADS;
  if (g < 1) g = 1;
  if (g > 1024) g = 1024;
  return g;
}

}  // namespace

// uniq f32 [n_uniq], rank / exists [Dp] (rank: max_rank for desc, min_rank
// for asc); out f32 [Dp].
extern "C" int row_value_key(const float* uniq, const int* rank,
                             const uint8_t* exists, int n_uniq, int Dp,
                             int desc, float* out, void* stream) {
  if (Dp <= 0) return 0;
  if (n_uniq <= 0) return (int)cudaErrorInvalidValue;
  value_key_kernel<<<chunks_for(Dp), THREADS, 0, (cudaStream_t)stream>>>(
      uniq, rank, exists, n_uniq, Dp, desc, out);
  return (int)cudaGetLastError();
}

// buf f32 [R, W] on the card; ks: R host ints (3 k_r + 1 <= W); pruned
// i32 [R] on the card; 0 < k; out int32 [4k + 1 + R]; scratch int64
// [2 * p2], p2 the power of two >= max(sum k_r, 1).
extern "C" int row_merge(const float* buf, int R, int W, const int* ks,
                         const int* pruned, int k, int* out,
                         long long* scratch, void* stream) {
  if (R <= 0 || R > MAX_ROWS || k <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  RowTable tab;
  int L = 0;
  for (int r = 0; r < R; ++r) {
    if (ks[r] < 0 || 3 * ks[r] + 1 > W) return (int)cudaErrorInvalidValue;
    tab.k[r] = ks[r];
    tab.off[r] = L;
    L += ks[r];
  }
  tab.off[R] = L;
  for (int r = R + 1; r <= MAX_ROWS; ++r) tab.off[r] = L;
  for (int r = R; r < MAX_ROWS; ++r) tab.k[r] = 0;
  int p2 = 1;
  while (p2 < (L > 0 ? L : 1)) p2 <<= 1;
  unsigned long long* words = reinterpret_cast<unsigned long long*>(scratch);
  unsigned long long* tmp = words + p2;
  // padding past L sorts last: every lane word is > 0
  cudaError_t e = cudaMemsetAsync(
      words, 0, (size_t)p2 * sizeof(unsigned long long), st);
  if (e != cudaSuccess) return (int)e;
  unsigned long long* sorted = words;
  if (L > 0) {
    int maxk = 0;
    for (int r = 0; r < R; ++r) maxk = ks[r] > maxk ? ks[r] : maxk;
    rekey_kernel<<<dim3(chunks_for(maxk), R), THREADS, 0, st>>>(buf, W, tab,
                                                               words);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int code = keysort::sort_rows(words, tmp, 1, p2, &sorted, st);
    if (code != 0) return code;
  }
  gather_kernel<<<chunks_for(k), THREADS, 0, st>>>(buf, W, R, tab, L, sorted,
                                                   k, pruned, out);
  return (int)cudaGetLastError();
}

extern "C" const char* row_merge_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
