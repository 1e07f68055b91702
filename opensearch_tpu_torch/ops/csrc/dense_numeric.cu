// K15 dense_numeric: a per-doc dense value column from a numeric field's
// (doc, value) pairs: the smallest value of each doc (`missing` where the
// doc has none, or where the smallest is not finite) and the doc's number
// of values.
//
// Replaces opensearch_tpu/search/plan_eval.py:dense_numeric (its
// scatter-min and scatter-add over the pairs).
//
// What bounds it on an H100: bytes. It reads each pair's doc id and value
// once (8 B a pair) and writes a value and a count per doc (8 B a doc).
//
// Design. The pairs are grouped by doc, ascending, padding (-1) last, so a
// doc's values are one run. Pass 1 fills every doc with (missing, 0).
// Pass 2 gives one thread to each pair; a thread whose pair starts a run
// (doc_ids[i] != doc_ids[i - 1]) walks the run, folds its minimum and
// length, and writes the doc's two outputs. A doc is written by one thread
// only: no atomics, and a min and a count never round, so the result is
// bit for bit its plain version's.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
dense_fill(float missing, int Dp, float* __restrict__ value,
           int* __restrict__ counts) {
  const long long d = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (d >= Dp) return;
  value[d] = missing;
  counts[d] = 0;
}

__global__ void __launch_bounds__(THREADS)
dense_runs(const int* __restrict__ doc_ids,
           const float* __restrict__ values, int nv, int Dp, float missing,
           float* __restrict__ value, int* __restrict__ counts) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= nv) return;
  const int doc = doc_ids[i];
  if (doc < 0 || doc >= Dp) return;
  if (i > 0 && doc_ids[i - 1] == doc) return;  // not a run start
  float mn = values[i];
  int n = 1;
  for (long long j = i + 1; j < nv && doc_ids[j] == doc; ++j) {
    mn = fminf(mn, values[j]);
    ++n;
  }
  value[doc] = isfinite(mn) ? mn : missing;
  counts[doc] = n;
}

}  // namespace

// doc_ids int32 [nv] (grouped by doc ascending, -1 padding), values f32
// [nv]; value f32 [Dp], counts int32 [Dp].
extern "C" int dense_numeric(const int* doc_ids, const float* values,
                             int nv, int Dp, float missing, float* value,
                             int* counts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (Dp > 0) {
    dense_fill<<<(Dp + THREADS - 1) / THREADS, THREADS, 0, s>>>(
        missing, Dp, value, counts);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (nv > 0) {
    dense_runs<<<(nv + THREADS - 1) / THREADS, THREADS, 0, s>>>(
        doc_ids, values, nv, Dp, missing, value, counts);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* dense_numeric_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
