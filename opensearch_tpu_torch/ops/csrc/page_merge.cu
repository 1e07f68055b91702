// K14 page_merge: the single-round-trip result page of one request over S
// segments, out int32 [k_page * (3 + 2 * field + 2 * n_dv) + S].
//
// Replaces opensearch_tpu/search/executor.py:_page_merger.run with
// opensearch_tpu/ops/topk.py:value_merge_key. For each segment's winners
// (its keyed top-k row: keys | scores | indices | total) it
// - re-keys them in field mode by the decoded f32 value
//   (unique_f32[clip(rank)], negated for asc; MISSING_VALUE_KEY = -1e30
//   where the doc lacks the value; -inf kept for ineligible slots), or
//   keeps the row's keys in score mode;
// - selects k_page of the concatenation in lax.top_k's order (key
//   descending, the lowest concatenated position first);
// - writes the reference's packed layout: keys | scores | gids (segment
//   position * stride + index) | field mode: sort rank, sort exists | per
//   docvalue field: rank, exists | the S totals.
//
// What bounds it on an H100: latency. The page is S x ~138 lanes (at most
// S x 65,536), a few KB read and written; three short launches.
//
// Design. A per-segment descriptor table (int64, uploaded by the wrapper)
// carries each segment's row and column pointers. Launch 1 re-keys every
// lane into one unique 64-bit word, (order-preserving u32 of the key) <<
// 32 | ~(concatenated position); the words sort descending (key_sort.cuh:
// lax.top_k's total order, -0.0 below +0.0, the lowest position first
// among equal keys); launch 3 gathers the first k_page winners' lanes and
// decodes each key from its word.

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "key_sort.cuh"

namespace {

constexpr int THREADS = 256;
constexpr float MISSING_VALUE_KEY = -1e30f;
// descriptor slots per segment before the docvalue fields
constexpr int D_ROW = 0, D_K = 1, D_OFF = 2, D_UNIQ = 3, D_NUNIQ = 4,
              D_RANK = 5, D_EXISTS = 6, D_DV = 7;

__device__ __forceinline__ unsigned ord_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float ord_val(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

template <typename T>
__device__ __forceinline__ const T* ptr_at(const long long* d, int slot) {
  return reinterpret_cast<const T*>(d[slot]);
}

// grid (chunks, S): lane j of segment s
__global__ void __launch_bounds__(THREADS)
rekey_kernel(const long long* __restrict__ desc, int ndesc, int field,
             int desc_order, unsigned long long* __restrict__ words) {
  const long long* d = desc + (size_t)blockIdx.y * ndesc;
  const int k = (int)d[D_K];
  const int off = (int)d[D_OFF];
  const float* row = ptr_at<float>(d, D_ROW);
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < k;
       j += gridDim.x * blockDim.x) {
    const float key = row[j];
    float mk = key;
    if (field && key != -INFINITY) {
      const float* uniq = ptr_at<float>(d, D_UNIQ);
      if (uniq == nullptr) {
        mk = MISSING_VALUE_KEY;
      } else {
        const int idx = __float_as_int(row[2 * k + j]);
        const int hi = (int)d[D_NUNIQ] - 1;
        int r = ptr_at<int>(d, D_RANK)[idx];
        r = r < 0 ? 0 : (r > hi ? hi : r);
        const float v = uniq[r];
        mk = ptr_at<uint8_t>(d, D_EXISTS)[idx] ? (desc_order ? v : -v)
                                               : MISSING_VALUE_KEY;
      }
    }
    const int pos = off + j;
    words[pos] = ((unsigned long long)ord_key(mk) << 32) |
                 (0xffffffffu - (unsigned)pos);
  }
}

// grid (chunks): page slot j
__global__ void __launch_bounds__(THREADS)
gather_kernel(const long long* __restrict__ desc, int ndesc, int S,
              int field, int n_dv, int stride,
              const unsigned long long* __restrict__ sorted, int k_page,
              int* __restrict__ out) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < k_page;
       j += gridDim.x * blockDim.x) {
    const unsigned long long word = sorted[j];
    const int pos = (int)(0xffffffffu - (unsigned)word);
    int s = 0;
    while (s + 1 < S && desc[(size_t)(s + 1) * ndesc + D_OFF] <= pos) ++s;
    const long long* d = desc + (size_t)s * ndesc;
    const int k = (int)d[D_K];
    const int lane = pos - (int)d[D_OFF];
    const float* row = ptr_at<float>(d, D_ROW);
    const int idx = __float_as_int(row[2 * k + lane]);
    out[j] = __float_as_int(ord_val((unsigned)(word >> 32)));
    out[k_page + j] = __float_as_int(row[k + lane]);
    out[2 * k_page + j] = s * stride + idx;
    int col = 3;
    if (field) {
      const int* rank = ptr_at<int>(d, D_RANK);
      const uint8_t* ex = ptr_at<uint8_t>(d, D_EXISTS);
      out[col * k_page + j] = rank != nullptr ? rank[idx] : 0;
      out[(col + 1) * k_page + j] = ex != nullptr ? (int)ex[idx] : 0;
      col += 2;
    }
    for (int f = 0; f < n_dv; ++f) {
      const int* rank = ptr_at<int>(d, D_DV + 2 * f);
      const uint8_t* ex = ptr_at<uint8_t>(d, D_DV + 2 * f + 1);
      out[col * k_page + j] = rank != nullptr ? rank[idx] : 0;
      out[(col + 1) * k_page + j] = ex != nullptr ? (int)ex[idx] : 0;
      col += 2;
    }
  }
  if (blockIdx.x == 0) {
    const int tail = k_page * (3 + 2 * field + 2 * n_dv);
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const long long* d = desc + (size_t)s * ndesc;
      out[tail + s] = __float_as_int(
          ptr_at<float>(d, D_ROW)[3 * (int)d[D_K]]);
    }
  }
}

int chunks_for(int n) {
  int g = (n + THREADS - 1) / THREADS;
  if (g < 1) g = 1;
  if (g > 1024) g = 1024;
  return g;
}

}  // namespace

// desc: int64 [S, 7 + 2 * n_dv] on the card (row pointer, k_i, lane offset,
// unique_f32 pointer, its length, the sort rank pointer, the exists
// pointer, then per docvalue field its min_rank and exists pointers; a
// null pointer where the segment has no such column). L = sum k_i,
// 0 < k_page <= L. scratch: int64 [2 * p2], p2 the power of two >= L.
extern "C" int page_merge(const long long* desc, int S, int n_dv, int L,
                          int k_page, int field, int desc_order, int stride,
                          int* out, long long* scratch, void* stream) {
  if (S <= 0 || L <= 0 || k_page <= 0 || k_page > L || n_dv < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int ndesc = D_DV + 2 * n_dv;
  int p2 = 1;
  while (p2 < L) p2 <<= 1;
  unsigned long long* words = reinterpret_cast<unsigned long long*>(scratch);
  unsigned long long* tmp = words + p2;
  // padding past L sorts last: every lane word is > 0
  cudaError_t e = cudaMemsetAsync(
      words, 0, (size_t)p2 * sizeof(unsigned long long), st);
  if (e != cudaSuccess) return (int)e;
  rekey_kernel<<<dim3(chunks_for(L), S), THREADS, 0, st>>>(
      desc, ndesc, field, desc_order, words);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  unsigned long long* sorted = words;
  const int code = keysort::sort_rows(words, tmp, 1, p2, &sorted, st);
  if (code != 0) return code;
  gather_kernel<<<chunks_for(k_page), THREADS, 0, st>>>(
      desc, ndesc, S, field, n_dv, stride, sorted, k_page, out);
  return (int)cudaGetLastError();
}

extern "C" const char* page_merge_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
