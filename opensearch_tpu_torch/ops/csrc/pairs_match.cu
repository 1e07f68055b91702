// K4 pairs_match: per (doc, value) pair of a doc-value column, a test of
// the pair's rank or ordinal -- rank in [lo, hi) of its query row, or
// ord_mask[row][ord] -- OR-ed into a per-doc bool, for B queries at once:
// out u8 [B, Dp].
//
// Replaces opensearch_tpu/ops/bm25.py:_pairs_to_docs, range_match_on_ranks
// and ordinal_terms_match (the range / numeric-terms / keyword-range
// filters of opensearch_tpu/search/plan_eval.py).
//
// What bounds it on an H100: bytes. It reads the column's doc ids and
// ranks (8 B per pair) and writes one byte per doc per query; there is one
// compare per pair and query.
//
// Design.
// - One thread per lane (a pair, or a doc slot on the identity layout)
//   reads the lane's doc id and rank once and loops over the B queries,
//   so the column is read once for the whole batch; for each query the
//   threads of a warp write consecutive bytes of that query's row.
// - Identity layout (a single-valued dense column: lane k holds doc k, -1
//   tail): the per-lane test is written straight into doc slot k, padded
//   with false up to Dp.
// - Otherwise the entry zeroes the output (cudaMemsetAsync on the same
//   stream), then each hit lane stores 1 at out[b][doc]. A doc's lanes all
//   store the same value, so the result is the same whatever order the
//   stores land in: deterministic, no atomics.
// - Padding lanes (doc id -1, rank or ordinal 0) never hit: the pair-valid
//   test masks them before the ord_mask gather, as the reference does.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ bool lane_test(int ord, int q, const int* lo,
                                          const int* hi,
                                          const uint8_t* ord_mask, int up) {
  if (ord_mask != nullptr) {
    return ord >= 0 && ord < up && ord_mask[(size_t)q * up + ord] != 0;
  }
  return ord >= lo[q] && ord < hi[q];
}

__global__ void __launch_bounds__(THREADS)
pairs_match_ident(const int* __restrict__ doc_ids,
                  const int* __restrict__ ords, int n,
                  const int* __restrict__ lo, const int* __restrict__ hi,
                  const uint8_t* __restrict__ ord_mask, int up, int B,
                  int Dp, uint8_t* __restrict__ out) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  if (d >= Dp) return;
  const bool valid = d < n && doc_ids[d] >= 0;
  const int ord = valid ? ords[d] : 0;
  for (int q = 0; q < B; ++q) {
    const bool hit = valid && lane_test(ord, q, lo, hi, ord_mask, up);
    out[(size_t)q * Dp + d] = hit ? 1 : 0;
  }
}

__global__ void __launch_bounds__(THREADS)
pairs_match_scatter(const int* __restrict__ doc_ids,
                    const int* __restrict__ ords, int n,
                    const int* __restrict__ lo, const int* __restrict__ hi,
                    const uint8_t* __restrict__ ord_mask, int up, int B,
                    int Dp, uint8_t* __restrict__ out) {
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= n) return;
  const int doc = doc_ids[lane];
  if (doc < 0 || doc >= Dp) return;
  const int ord = ords[lane];
  for (int q = 0; q < B; ++q) {
    if (lane_test(ord, q, lo, hi, ord_mask, up)) {
      out[(size_t)q * Dp + doc] = 1;
    }
  }
}

}  // namespace

// lo / hi: int32 [B] rank bounds (used when ord_mask is null); ord_mask:
// u8 [B, up]. ident != 0 selects the identity layout. out: u8 [B, Dp].
extern "C" int pairs_match(const int* doc_ids, const int* ords, int n,
                           const int* lo, const int* hi,
                           const uint8_t* ord_mask, int up, int B, int Dp,
                           int ident, uint8_t* out, void* stream) {
  if (B <= 0 || Dp <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (ident) {
    pairs_match_ident<<<(Dp + THREADS - 1) / THREADS, THREADS, 0, s>>>(
        doc_ids, ords, n, lo, hi, ord_mask, up, B, Dp, out);
    return (int)cudaGetLastError();
  }
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)B * Dp, s);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0) return 0;
  pairs_match_scatter<<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      doc_ids, ords, n, lo, hi, ord_mask, up, B, Dp, out);
  return (int)cudaGetLastError();
}

extern "C" const char* pairs_match_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
