// K24 binned_scatter: the dynamic-bin route of the aggregation engine,
// per-query binned count / sum / sumsq / min / max.
//
// Replaces the scatter route of opensearch_tpu/search/aggs/engine.py:
// _binned_sums (:1157-1167) as every kind takes it under a dynamic
// context (the per-query buckets that `nested` and `reverse_nested` hand
// their sub-aggregations), the bucket kinds' child-bin scatter-max there,
// and the geo_metric scatters (:1675-1700).
//
// Inputs: lanes int32 [B, n], each query's bin per lane (outside
// [0, total): dropped; the caller folds the eligibility into it); values
// f32 [n] (shared by the queries) or [B, n] (per query), or none (every
// lane contributes cval). Outputs [B, total]: int32 counts, f32 sums of v
// and of v * v, min (+inf where empty) and max (-inf where empty).
//
// What bounds it on an H100: bytes for counts, min and max (one pass over
// the lanes); a sum, the sort of one 64-bit key a lane.
//
// Design. Bins are per query, so no static CSR exists. Counts are integer
// atomics; min and max are integer atomics on order-preserving images of
// the floats: all order-free and exact, and each warp makes one atomic per
// distinct bin of its lanes (__match_any_sync, __reduce_min/max_sync). A sum needs a fixed order: the
// lanes' keys ~(bin << 32 | lane) sort descending per query with
// key_sort.cuh, i.e. by (bin, lane) ascending, dropped lanes (key 0)
// last; a bin's run then is its lanes in lane order. Each run is cut into
// chunks of CHUNK lanes; one thread sums a chunk from 0.0f in order, and
// one thread a (query, bin) sums its chunks from 0.0f in order: K6's two
// levels (binned_reduce.cu). With --fmad=false each addition rounds once,
// so the plain version (ops/binned.py:dynamic_sum_plain) agrees bit for
// bit.

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "key_sort.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 256;   // ops/binned.py CSR_CHUNK
constexpr int NEED_CNT = 1, NEED_SUM = 2, NEED_SUMSQ = 4, NEED_MIN = 8,
              NEED_MAX = 16;

__device__ __forceinline__ int f2o(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float o2f(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

__device__ __forceinline__ float lane_value(const float* values,
                                            int per_query, float cval,
                                            int b, int n, int lane) {
  if (values == nullptr) return cval;
  return per_query ? values[(size_t)b * n + lane] : values[lane];
}

__device__ __forceinline__ unsigned bin_of(unsigned long long key) {
  return (unsigned)((~key) >> 32);
}

// grid-stride init of the [B, total] outputs (and the run counts)
__global__ void __launch_bounds__(THREADS)
init_kernel(size_t n, int* cnt, int* run_cnt, float* sum, float* sumsq,
            int* mn, int* mx) {
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * THREADS) {
    if (cnt) cnt[i] = 0;
    if (run_cnt) run_cnt[i] = 0;
    if (sum) sum[i] = 0.0f;
    if (sumsq) sumsq[i] = 0.0f;
    if (mn) mn[i] = f2o(INFINITY);
    if (mx) mx[i] = f2o(-INFINITY);
  }
}

// one thread a (query, lane): the atomics, one per distinct bin of a warp
// (the warp's count, minimum and maximum of that bin's lanes), and the
// lane's sort key
__global__ void __launch_bounds__(THREADS)
lane_kernel(const int* __restrict__ lanes, int n, int total,
            const float* __restrict__ values, int per_query, float cval,
            int p2, int* cnt, int* run_cnt, int* mn, int* mx,
            unsigned long long* __restrict__ keys) {
  const int l = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  int bin = -1;
  if (l < n) {
    const int x = lanes[(size_t)b * n + l];
    if (x >= 0 && x < total) bin = x;
  }
  if (keys && l < p2)
    keys[(size_t)b * p2 + l] =
        bin >= 0 ? ~(((unsigned long long)bin << 32) | (unsigned)l) : 0ull;
  // every lane takes part in the match
  const unsigned peers = __match_any_sync(0xffffffffu, bin);
  if (bin < 0) return;
  const size_t o = (size_t)b * total + bin;
  const bool leader = (int)(threadIdx.x & 31) == __ffs(peers) - 1;
  if (leader && cnt) atomicAdd(&cnt[o], __popc(peers));
  if (leader && run_cnt) atomicAdd(&run_cnt[o], __popc(peers));
  if (mn || mx) {
    const int v = f2o(lane_value(values, per_query, cval, b, n, l));
    if (mn) {
      const int m = __reduce_min_sync(peers, v);
      if (leader) atomicMin(&mn[o], m);
    }
    if (mx) {
      const int m = __reduce_max_sync(peers, v);
      if (leader) atomicMax(&mx[o], m);
    }
  }
}

// a run's first position: where its bin's lanes start in the sorted row
__global__ void __launch_bounds__(THREADS)
run_start_kernel(const unsigned long long* __restrict__ sorted, int p2,
                 int total, int* __restrict__ run_start) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (j >= p2) return;
  const unsigned long long* row = sorted + (size_t)b * p2;
  const unsigned long long k = row[j];
  if (k == 0ull) return;
  const unsigned bin = bin_of(k);
  if (j == 0 || bin_of(row[j - 1]) != bin)
    run_start[(size_t)b * total + bin] = j;
}

// one thread a chunk start: the chunk's lanes summed from 0 in order
__global__ void __launch_bounds__(THREADS)
chunk_kernel(const unsigned long long* __restrict__ sorted, int p2,
             int total, const int* __restrict__ run_start,
             const float* __restrict__ values, int per_query, float cval,
             int n, int want_sum, int want_sumsq,
             float* __restrict__ part_sum, float* __restrict__ part_sq) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (j >= p2) return;
  const unsigned long long* row = sorted + (size_t)b * p2;
  const unsigned long long k = row[j];
  if (k == 0ull) return;
  const unsigned bin = bin_of(k);
  if ((j - run_start[(size_t)b * total + bin]) % CHUNK != 0) return;
  float s = 0.0f, s2 = 0.0f;
  for (int t = 0; t < CHUNK && j + t < p2; ++t) {
    const unsigned long long kk = row[j + t];
    if (kk == 0ull || bin_of(kk) != bin) break;
    const int lane = (int)(unsigned)(~kk);
    const float v = lane_value(values, per_query, cval, b, n, lane);
    s = s + v;
    s2 = s2 + v * v;
  }
  if (want_sum) part_sum[(size_t)b * p2 + j] = s;
  if (want_sumsq) part_sq[(size_t)b * p2 + j] = s2;
}

// one thread a (query, bin): the bin's chunk partials summed from 0 in
// order; min / max decoded from their ordered images
__global__ void __launch_bounds__(THREADS)
bin_kernel(int total, int p2, const int* __restrict__ run_start,
           const int* __restrict__ run_cnt,
           const float* __restrict__ part_sum,
           const float* __restrict__ part_sq, float* sum, float* sumsq,
           int* mn, int* mx) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (t >= total) return;
  const size_t o = (size_t)b * total + t;
  if (mn) reinterpret_cast<float*>(mn)[o] = o2f(mn[o]);
  if (mx) reinterpret_cast<float*>(mx)[o] = o2f(mx[o]);
  if (run_cnt == nullptr) return;
  const int c = run_cnt[o];
  if (c == 0) return;
  const size_t rs = (size_t)b * p2 + run_start[o];
  float s = 0.0f, s2 = 0.0f;
  for (int off = 0; off < c; off += CHUNK) {
    if (sum) s = s + part_sum[rs + off];
    if (sumsq) s2 = s2 + part_sq[rs + off];
  }
  if (sum) sum[o] = s;
  if (sumsq) sumsq[o] = s2;
}

unsigned blocks_of(size_t n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

// lanes int32 [B, n]; values f32 [n] or [B, n] (per_query) or null
// (cval); needs: cnt 1 | sum 2 | sumsq 4 | min 8 | max 16; p2 the power
// of two >= n (sums only); keys: 2 * B * p2 64-bit words, partial: 2 * B
// * p2 floats, scratch: 2 * B * total ints (sums only); outputs [B,
// total], null where not needed (min / max f32 written through their
// int images).
extern "C" int binned_scatter(const int* lanes, int B, int n, int total,
                              const float* values, int per_query, float cval,
                              int needs, int p2, unsigned long long* keys,
                              float* partial, int* scratch, int* cnt,
                              float* sum, float* sumsq, float* mn, float* mx,
                              void* stream) {
  const bool sums = (needs & (NEED_SUM | NEED_SUMSQ)) != 0;
  if (B <= 0 || n <= 0 || total <= 0) return (int)cudaErrorInvalidValue;
  if (sums && (p2 < n || (p2 & (p2 - 1)) != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int* c = (needs & NEED_CNT) ? cnt : nullptr;
  int* imn = (needs & NEED_MIN) ? reinterpret_cast<int*>(mn) : nullptr;
  int* imx = (needs & NEED_MAX) ? reinterpret_cast<int*>(mx) : nullptr;
  float* s = (needs & NEED_SUM) ? sum : nullptr;
  float* s2 = (needs & NEED_SUMSQ) ? sumsq : nullptr;
  int* run_cnt = sums ? scratch : nullptr;
  int* run_start = sums ? scratch + (size_t)B * total : nullptr;
  const size_t outs = (size_t)B * total;
  unsigned init_blocks = blocks_of(outs);
  if (init_blocks > 65535u) init_blocks = 65535u;
  init_kernel<<<init_blocks, THREADS, 0, st>>>(outs, c, run_cnt, s, s2, imn,
                                               imx);
  lane_kernel<<<dim3(blocks_of(sums ? p2 : n), B), THREADS, 0, st>>>(
      lanes, n, total, values, per_query, cval, p2, c, run_cnt, imn, imx,
      sums ? keys : nullptr);
  if (sums) {
    unsigned long long* sorted = nullptr;
    const int e = keysort::sort_rows(keys, keys + (size_t)B * p2, B, p2,
                                     &sorted, st);
    if (e != 0) return e;
    run_start_kernel<<<dim3(blocks_of(p2), B), THREADS, 0, st>>>(
        sorted, p2, total, run_start);
    chunk_kernel<<<dim3(blocks_of(p2), B), THREADS, 0, st>>>(
        sorted, p2, total, run_start, values, per_query, cval, n,
        s != nullptr, s2 != nullptr, partial, partial + (size_t)B * p2);
  }
  if (sums || imn || imx)
    bin_kernel<<<dim3(blocks_of(total), B), THREADS, 0, st>>>(
        total, p2, run_start, run_cnt, partial, partial + (size_t)B * p2, s,
        s2, imn, imx);
  return (int)cudaGetLastError();
}

extern "C" const char* binned_scatter_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
