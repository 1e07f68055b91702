// K6 binned_reduce: per-bin reductions of dynamic per-lane contributions
// over static bins, for B queries at once: count (i32), sum and sum of
// squares (f32), min and max (f32), each [B, total], only the ones asked.
//
// Replaces opensearch_tpu/search/aggs/engine.py:_binned_sums' one-hot GEMM
// and scatter-add routes, the min / max scatters of the metric kinds and
// the child-bin scatter-max of bucket_ord / bucket_num.
//
// What bounds it on an H100: bytes. Per query it reads each binned lane's
// position (4 B), doc id (4 B, pairs layouts), mask byte(s) and value
// (4 B); it writes five numbers per bin at most. The arithmetic is a few
// flops per lane.
//
// Design. The bins are static for a plan and segment, so the caller
// builds once a CSR of the binned lanes grouped by bin (stable, so lanes
// keep their order inside a bin) and cut into chunks of at most 256
// lanes that never cross a bin. Pass 1: one warp per (chunk, query)
// gathers the mask for its lanes, each thread folds its lanes in order and
// the warp combines the 32 threads in a fixed shuffle tree into the
// chunk's partials. Pass 2: one warp per (bin, query) folds the bin's
// chunk partials the same way. Where the items are small (at most 4 lanes
// per chunk on average in pass 1, at most 4 chunks per bin in pass 2, as
// with one bin per doc) one thread takes an item and folds it in order
// instead of a warp. The choice depends on the static sizes only. Every
// sum is taken in one fixed order, with no float atomics, so the result
// is the same bits from run to run. A lane's value is values[lane], or a
// constant when values is null; with mask null every lane counts (the
// static child-bin max).

#include <cuda_runtime.h>
#include <cstdint>
#include <math_constants.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int NEED_CNT = 1, NEED_SUM = 2, NEED_SUMSQ = 4, NEED_MIN = 8,
              NEED_MAX = 16;

struct Acc {
  int cnt;
  float sum, sq, mn, mx;
};

__device__ __forceinline__ Acc acc_zero() {
  return Acc{0, 0.0f, 0.0f, CUDART_INF_F, -CUDART_INF_F};
}

__device__ __forceinline__ Acc warp_fold(Acc a) {
  for (int off = 16; off > 0; off >>= 1) {
    a.cnt += __shfl_down_sync(FULL, a.cnt, off);
    a.sum += __shfl_down_sync(FULL, a.sum, off);
    a.sq += __shfl_down_sync(FULL, a.sq, off);
    a.mn = fminf(a.mn, __shfl_down_sync(FULL, a.mn, off));
    a.mx = fmaxf(a.mx, __shfl_down_sync(FULL, a.mx, off));
  }
  return a;
}

// fold lanes [s, e) of the CSR, every `step`-th from s, into a
__device__ __forceinline__ void fold_lanes(
    Acc& a, const int* __restrict__ lane_order, int s, int e, int step,
    const uint8_t* mrow, const uint8_t* prow, int Dp,
    const int* __restrict__ doc_ids, const float* __restrict__ values,
    float cval) {
  for (int i = s; i < e; i += step) {
    const int l = lane_order[i];
    const int doc = doc_ids != nullptr ? doc_ids[l] : l;
    if (doc < 0 || doc >= Dp) continue;
    if (mrow != nullptr && mrow[doc] == 0) continue;
    if (prow != nullptr && prow[doc] == 0) continue;
    const float v = values != nullptr ? values[l] : cval;
    a.cnt += 1;
    a.sum += v;
    a.sq += v * v;
    a.mn = fminf(a.mn, v);
    a.mx = fmaxf(a.mx, v);
  }
}

__device__ __forceinline__ void fold_partials(
    Acc& a, int s, int e, int step, size_t row, const int* p_cnt,
    const float* p_sum, const float* p_sq, const float* p_mn,
    const float* p_mx) {
  for (int i = s; i < e; i += step) {
    const size_t o = row + i;
    if (p_cnt) a.cnt += p_cnt[o];
    if (p_sum) a.sum += p_sum[o];
    if (p_sq) a.sq += p_sq[o];
    if (p_mn) a.mn = fminf(a.mn, p_mn[o]);
    if (p_mx) a.mx = fmaxf(a.mx, p_mx[o]);
  }
}

__device__ __forceinline__ void store(const Acc& a, size_t o, int* cnt,
                                      float* sum, float* sq, float* mn,
                                      float* mx) {
  if (cnt) cnt[o] = a.cnt;
  if (sum) sum[o] = a.sum;
  if (sq) sq[o] = a.sq;
  if (mn) mn[o] = a.mn;
  if (mx) mx[o] = a.mx;
}

// PER_THREAD: one thread per (chunk, query), else one warp
template <bool PER_THREAD>
__global__ void __launch_bounds__(THREADS)
binned_reduce_chunks(const int* __restrict__ lane_order,
                     const int* __restrict__ chunk_start, int nch,
                     const uint8_t* __restrict__ mask,
                     const uint8_t* __restrict__ pmask, int Dp,
                     const int* __restrict__ doc_ids,
                     const float* __restrict__ values, float cval, int B,
                     int* __restrict__ p_cnt, float* __restrict__ p_sum,
                     float* __restrict__ p_sq, float* __restrict__ p_mn,
                     float* __restrict__ p_mx) {
  const int lane = PER_THREAD ? 0 : (threadIdx.x & 31);
  const long long item = PER_THREAD
      ? (long long)blockIdx.x * THREADS + threadIdx.x
      : (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (item >= (long long)nch * B) return;  // warp-uniform in warp mode
  const int b = (int)(item % B);
  const int c = (int)(item / B);
  const uint8_t* mrow = mask != nullptr ? mask + (size_t)b * Dp : nullptr;
  const uint8_t* prow = pmask != nullptr ? pmask + (size_t)b * Dp : nullptr;
  Acc a = acc_zero();
  fold_lanes(a, lane_order, chunk_start[c] + lane, chunk_start[c + 1],
             PER_THREAD ? 1 : 32, mrow, prow, Dp, doc_ids, values, cval);
  if (!PER_THREAD) a = warp_fold(a);
  if (lane == 0) {
    store(a, (size_t)b * nch + c, p_cnt, p_sum, p_sq, p_mn, p_mx);
  }
}

// PER_THREAD: one thread per (bin, query), else one warp
template <bool PER_THREAD>
__global__ void __launch_bounds__(THREADS)
binned_reduce_bins(const int* __restrict__ bin_chunk, int total, int nch,
                   int B, const int* __restrict__ p_cnt,
                   const float* __restrict__ p_sum,
                   const float* __restrict__ p_sq,
                   const float* __restrict__ p_mn,
                   const float* __restrict__ p_mx, int* __restrict__ cnt,
                   float* __restrict__ sum, float* __restrict__ sq,
                   float* __restrict__ mn, float* __restrict__ mx) {
  const int lane = PER_THREAD ? 0 : (threadIdx.x & 31);
  const long long item = PER_THREAD
      ? (long long)blockIdx.x * THREADS + threadIdx.x
      : (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (item >= (long long)total * B) return;  // warp-uniform in warp mode
  const int b = (int)(item % B);
  const int bin = (int)(item / B);
  Acc a = acc_zero();
  fold_partials(a, bin_chunk[bin] + lane, bin_chunk[bin + 1],
                PER_THREAD ? 1 : 32, (size_t)b * nch, p_cnt, p_sum, p_sq,
                p_mn, p_mx);
  if (!PER_THREAD) a = warp_fold(a);
  if (lane == 0) store(a, (size_t)b * total + bin, cnt, sum, sq, mn, mx);
}

// blocks for `items` work items of one thread (per_thread) or one warp
long long blocks_for(long long items, bool per_thread) {
  const long long per_block = per_thread ? THREADS : WARPS;
  return (items + per_block - 1) / per_block;
}

}  // namespace

// CSR: lane_order int32 [nnz] (lanes grouped by bin), chunk_start int32
// [nch + 1] (offsets into lane_order), bin_chunk int32 [total + 1] (first
// chunk of each bin). mask / pmask: u8 [B, Dp] or null; doc_ids int32 [n]
// or null (lane k is doc k); values f32 [n] or null (then cval). scratch:
// 5 * B * nch 32-bit words. Outputs [B, total], null where not asked.
extern "C" int binned_reduce(const int* lane_order, int nnz,
                             const int* chunk_start, int nch,
                             const int* bin_chunk, int total,
                             const uint8_t* mask, const uint8_t* pmask,
                             int Dp, const int* doc_ids,
                             const float* values, float cval, int needs,
                             int B, void* scratch, int* cnt, float* sum,
                             float* sq, float* mn, float* mx, void* stream) {
  if (B <= 0 || total <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t part = (size_t)B * nch;
  int* p_cnt = (needs & NEED_CNT) ? (int*)scratch : nullptr;
  float* p_sum = (needs & NEED_SUM) ? (float*)scratch + part : nullptr;
  float* p_sq = (needs & NEED_SUMSQ) ? (float*)scratch + 2 * part : nullptr;
  float* p_mn = (needs & NEED_MIN) ? (float*)scratch + 3 * part : nullptr;
  float* p_mx = (needs & NEED_MAX) ? (float*)scratch + 4 * part : nullptr;
  const bool thread_chunks = (long long)nnz <= 4LL * nch;
  const bool thread_bins = (long long)nch <= 4LL * total;
  const long long g1 = blocks_for((long long)nch * B, thread_chunks);
  const long long g2 = blocks_for((long long)total * B, thread_bins);
  if (g1 > 0x7fffffffLL || g2 > 0x7fffffffLL) {
    return (int)cudaErrorInvalidConfiguration;
  }
  if (nch > 0) {
    if (thread_chunks) {
      binned_reduce_chunks<true><<<(unsigned)g1, THREADS, 0, s>>>(
          lane_order, chunk_start, nch, mask, pmask, Dp, doc_ids, values,
          cval, B, p_cnt, p_sum, p_sq, p_mn, p_mx);
    } else {
      binned_reduce_chunks<false><<<(unsigned)g1, THREADS, 0, s>>>(
          lane_order, chunk_start, nch, mask, pmask, Dp, doc_ids, values,
          cval, B, p_cnt, p_sum, p_sq, p_mn, p_mx);
    }
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  int* o_cnt = (needs & NEED_CNT) ? cnt : nullptr;
  float* o_sum = (needs & NEED_SUM) ? sum : nullptr;
  float* o_sq = (needs & NEED_SUMSQ) ? sq : nullptr;
  float* o_mn = (needs & NEED_MIN) ? mn : nullptr;
  float* o_mx = (needs & NEED_MAX) ? mx : nullptr;
  if (thread_bins) {
    binned_reduce_bins<true><<<(unsigned)g2, THREADS, 0, s>>>(
        bin_chunk, total, nch, B, p_cnt, p_sum, p_sq, p_mn, p_mx, o_cnt,
        o_sum, o_sq, o_mn, o_mx);
  } else {
    binned_reduce_bins<false><<<(unsigned)g2, THREADS, 0, s>>>(
        bin_chunk, total, nch, B, p_cnt, p_sum, p_sq, p_mn, p_mx, o_cnt,
        o_sum, o_sq, o_mn, o_mx);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* binned_reduce_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
