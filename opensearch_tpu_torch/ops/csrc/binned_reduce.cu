// K6 binned_reduce: per-bin reductions of dynamic per-lane contributions
// over static bins, for B queries at once: count (i32), sum and sum of
// squares (f32), min and max (f32), each [B, total], only the ones asked.
//
// Replaces opensearch_tpu/search/aggs/engine.py:_binned_sums' one-hot GEMM
// and scatter-add routes, the min / max scatters of the metric kinds and
// the child-bin scatter-max of bucket_ord / bucket_num.
//
// What bounds it on an H100: bytes. It reads each query's mask byte(s)
// once and each binned lane's doc id (4 B, pairs layouts) and value (4 B)
// once; it writes five numbers per bin at most. The arithmetic is a few
// flops per lane.
//
// Design. The bins are static for a plan and segment, so the caller
// builds once a CSR of the binned lanes grouped by bin (stable, so lanes
// keep their order inside a bin) and cut into chunks of at most 256
// lanes that never cross a bin, and beside it the lanes' doc ids and
// values in CSR order, which the folds read coalesced, and the chunks'
// order by their first lane. Pass 0 packs each query's mask (AND its
// pmask) into bits in doc order with 16-byte loads: bit j of word w is
// doc 32w + j, the order of ops/binned.py pack_bits; a query's words are
// Dp / 8 bytes. Where the CSR holds fewer lanes than Dp / 32 (a sparse
// field), a 32-byte sector a lane reads less than the pack's whole mask:
// the wrapper then packs nothing and the folds test each lane's mask
// (and pmask) bytes. Pass 1: one warp per chunk, the chunks taken by their
// first lane, so that the bins' chunks in flight cover one window of
// docs and every query's words for it stay in L2: the warp holds its
// chunk's doc ids and values in registers and folds the chunk for each
// query in turn, each thread every 32nd lane of the chunk in order, then
// the warp's 32 threads in a fixed shuffle tree into the chunk's
// partials. Each query's mask is thus read once, in doc order, and each
// lane once. Pass 2: one warp per (bin, query) folds the bin's chunk
// partials the same way. Where the items are small (at most 4 lanes per
// chunk on average in pass 1, at most 4 chunks per bin in pass 2, as with
// one bin per doc) one thread takes an item and folds it in order
// instead of a warp. The choice depends on the static sizes only. Every
// sum is taken in one fixed order, with no float atomics, so the result
// is the same bits from run to run, and the same as a fold that gathers
// the mask bytes in this order. A lane's value is values[lane], or a
// constant when values is null. With mask null every lane counts (the
// static child-bin max): that route reads lane_order, doc ids and values
// through the CSR, and packs nothing.

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

__device__ __forceinline__ Acc warp_fold(Acc a, int needs = 31) {
  for (int off = 16; off > 0; off >>= 1) {
    if (needs & NEED_CNT) a.cnt += __shfl_down_sync(FULL, a.cnt, off);
    if (needs & NEED_SUM) a.sum += __shfl_down_sync(FULL, a.sum, off);
    if (needs & NEED_SUMSQ) a.sq += __shfl_down_sync(FULL, a.sq, off);
    if (needs & NEED_MIN)
      a.mn = fminf(a.mn, __shfl_down_sync(FULL, a.mn, off));
    if (needs & NEED_MAX)
      a.mx = fmaxf(a.mx, __shfl_down_sync(FULL, a.mx, off));
  }
  return a;
}

__device__ __forceinline__ void add(Acc& a, float v, int needs) {
  if (needs & NEED_CNT) a.cnt += 1;
  if (needs & NEED_SUM) a.sum += v;
  if (needs & NEED_SUMSQ) a.sq += v * v;
  if (needs & NEED_MIN) a.mn = fminf(a.mn, v);
  if (needs & NEED_MAX) a.mx = fmaxf(a.mx, v);
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

// four bytes -> four bits (byte k nonzero -> bit k)
__device__ __forceinline__ unsigned nib4(unsigned x) {
  const unsigned f = __vcmpne4(x, 0u) & 0x01010101u;
  return (f * 0x01020408u) >> 24;
}

__device__ __forceinline__ unsigned bits16(uint4 q) {
  return nib4(q.x) | nib4(q.y) << 4 | nib4(q.z) << 8 | nib4(q.w) << 12;
}

// Pass 0: words[b][w] bit j = mask[b][32w + j] (AND pmask), 0 past Dp.
// One thread a half word (16 docs: one 16-byte load of each mask where
// `vec` and the 16 docs lie below Dp); even and odd threads join halves.
__global__ void __launch_bounds__(THREADS)
pack_kernel(const uint8_t* __restrict__ mask,
            const uint8_t* __restrict__ pmask, int Dp, int W, int B, int vec,
            unsigned* __restrict__ words) {
  const long long h = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long halves = 2LL * W;
  unsigned bits = 0;
  long long b = 0, g = 0;
  if (h < halves * B) {
    b = h / halves;
    g = h - b * halves;
    const long long d0 = g * 16;
    const uint8_t* mrow = mask + b * Dp;
    const uint8_t* prow = pmask != nullptr ? pmask + b * Dp : nullptr;
    if (vec && d0 + 16 <= Dp) {
      bits = bits16(*reinterpret_cast<const uint4*>(mrow + d0));
      if (prow != nullptr)
        bits &= bits16(*reinterpret_cast<const uint4*>(prow + d0));
    } else {
      for (int j = 0; j < 16 && d0 + j < Dp; ++j) {
        const bool ok = mrow[d0 + j] != 0
            && (prow == nullptr || prow[d0 + j] != 0);
        bits |= (unsigned)ok << j;
      }
    }
  }
  const unsigned hi = __shfl_down_sync(FULL, bits, 1);
  if (h < halves * B && (g & 1) == 0) words[b * W + g / 2] = bits | hi << 16;
}

// Where the mask was not packed (a sparse field): mask AND pmask at doc d
// of one query's rows, both bytes loaded before the test.
__device__ __forceinline__ bool byte_ok(const uint8_t* __restrict__ mrow,
                                        const uint8_t* __restrict__ prow,
                                        int d) {
  const uint8_t m = mrow[d];
  const uint8_t pm = prow != nullptr ? prow[d] : (uint8_t)1;
  return (m != 0) & (pm != 0);
}

// Pass 1: the chunk partials. With a mask: CSR entry i is doc docs[i]
// with value vals[i] (both in CSR order), eligible where its bit of
// `words` is set (BYTES: where byte_ok of the mask rows says so), and
// the chunks are visited in `order` (by their first lane, so that the
// chunks in flight share a narrow window of docs and of every query's
// mask). Without (one query, every lane counts): entry i is lane
// lane_order[i], doc docs[lane] (or the lane) with value vals[lane].
// vals null: cval. PER_THREAD: one thread per (chunk, query), else one
// warp per chunk looping over the queries; a warp holds a chunk of at
// most 32 * REG entries in registers across its queries (larger chunks
// are read again for each query).
constexpr int REG = 8;

template <bool PER_THREAD, bool BYTES>
__global__ void __launch_bounds__(THREADS, 6)
binned_reduce_chunks(const int* __restrict__ lane_order,
                     const int* __restrict__ chunk_start,
                     const int* __restrict__ order, int nch,
                     const unsigned* __restrict__ words, int W, int Dp,
                     const int* __restrict__ docs,
                     const float* __restrict__ vals, float cval, int B,
                     int needs, int* __restrict__ p_cnt,
                     float* __restrict__ p_sum, float* __restrict__ p_sq,
                     float* __restrict__ p_mn, float* __restrict__ p_mx,
                     const uint8_t* __restrict__ mask,
                     const uint8_t* __restrict__ pmask) {
  const int lane = PER_THREAD ? 0 : (threadIdx.x & 31);
  const long long item = PER_THREAD
      ? (long long)blockIdx.x * THREADS + threadIdx.x
      : (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (item >= (PER_THREAD ? (long long)nch * B : nch)) return;
  const int k_th = PER_THREAD ? (int)(item / B) : (int)item;
  const int c = order != nullptr ? order[k_th] : k_th;
  const int b0 = PER_THREAD ? (int)(item % B) : 0;
  const int b1 = PER_THREAD ? b0 + 1 : B;
  const int s = chunk_start[c] + lane, e = chunk_start[c + 1];
  const int step = PER_THREAD ? 1 : 32;
  // entry i: its doc (-1: none in [0, Dp)) and its value
  auto entry = [&](int i, int& doc, float& v) {
    const int at = BYTES || words != nullptr ? i : lane_order[i];
    doc = docs != nullptr ? docs[at] : at;
    if (doc >= Dp) doc = -1;
    v = vals != nullptr ? vals[at] : cval;
  };
  const bool regs = !PER_THREAD && e - chunk_start[c] <= 32 * REG;
  int dk[REG];
  float vk[REG];
  if (regs) {
#pragma unroll
    for (int k = 0; k < REG; ++k) {
      dk[k] = -1;
      vk[k] = cval;
      if (s + 32 * k < e) entry(s + 32 * k, dk[k], vk[k]);
    }
  }
  for (int b = b0; b < b1; ++b) {
    const unsigned* row = words != nullptr ? words + (size_t)b * W : nullptr;
    const uint8_t* mrow = BYTES ? mask + (size_t)b * Dp : nullptr;
    const uint8_t* prow = BYTES && pmask != nullptr
        ? pmask + (size_t)b * Dp : nullptr;
    Acc a = acc_zero();
    if (regs) {
      // every load in flight before the first test
      unsigned wk[REG];
#pragma unroll
      for (int k = 0; k < REG; ++k) {
        if (BYTES)
          wk[k] = dk[k] >= 0 && byte_ok(mrow, prow, dk[k]) ? ~0u : 0u;
        else
          wk[k] = row != nullptr && dk[k] >= 0 ? row[dk[k] >> 5] : ~0u;
      }
#pragma unroll
      for (int k = 0; k < REG; ++k) {
        if (dk[k] >= 0 && ((wk[k] >> (dk[k] & 31)) & 1u) != 0)
          add(a, vk[k], needs);
      }
    } else {
      for (int i = s; i < e; i += step) {
        int doc;
        float v;
        entry(i, doc, v);
        if (doc < 0) continue;
        if (BYTES) {
          if (!byte_ok(mrow, prow, doc)) continue;
        } else if (row != nullptr
                   && ((row[doc >> 5] >> (doc & 31)) & 1u) == 0) {
          continue;
        }
        add(a, v, needs);
      }
    }
    if (!PER_THREAD) a = warp_fold(a, needs);
    if (lane == 0)
      store(a, (size_t)b * nch + c, p_cnt, p_sum, p_sq, p_mn, p_mx);
  }
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
// With a mask: docs_ord int32 [nnz] / vals_ord f32 [nnz] (or null) the
// lanes' doc ids / values in CSR order, chunk_order int32 [nch] the
// chunks by their first lane, words u32 [B, W] (W = ceil(Dp / 32)) the
// packed bits' scratch, or null: then the folds read each lane's mask and
// pmask bytes and nothing is packed (the wrapper's choice where the lanes
// are sparse: ops/binned.py PACK_DOCS_PER_LANE); vec: 16-byte loads of the
// mask rows allowed (Dp % 16 == 0, aligned rows).
extern "C" int binned_reduce(const int* lane_order, int nnz,
                             const int* chunk_start, int nch,
                             const int* bin_chunk, int total,
                             const uint8_t* mask, const uint8_t* pmask,
                             int Dp, const int* doc_ids,
                             const float* values, float cval, int needs,
                             int B, void* scratch, int* cnt, float* sum,
                             float* sq, float* mn, float* mx,
                             const int* docs_ord, const float* vals_ord,
                             const int* chunk_order, unsigned* words, int W,
                             int vec, void* stream) {
  if (B <= 0 || total <= 0) return 0;
  if (mask != nullptr && (docs_ord == nullptr || chunk_order == nullptr
                          || (words != nullptr && W != (Dp + 31) / 32)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t part = (size_t)B * nch;
  int* p_cnt = (needs & NEED_CNT) ? (int*)scratch : nullptr;
  float* p_sum = (needs & NEED_SUM) ? (float*)scratch + part : nullptr;
  float* p_sq = (needs & NEED_SUMSQ) ? (float*)scratch + 2 * part : nullptr;
  float* p_mn = (needs & NEED_MIN) ? (float*)scratch + 3 * part : nullptr;
  float* p_mx = (needs & NEED_MAX) ? (float*)scratch + 4 * part : nullptr;
  const bool thread_chunks = (long long)nnz <= 4LL * nch;
  const bool thread_bins = (long long)nch <= 4LL * total;
  const long long g1 = blocks_for(
      thread_chunks ? (long long)nch * B : nch, thread_chunks);
  const long long g2 = blocks_for((long long)total * B, thread_bins);
  const long long g0 = (2LL * W * B + THREADS - 1) / THREADS;
  if (g1 > 0x7fffffffLL || g2 > 0x7fffffffLL || g0 > 0x7fffffffLL) {
    return (int)cudaErrorInvalidConfiguration;
  }
  if (nch > 0) {
    if (mask != nullptr && words != nullptr) {
      pack_kernel<<<(unsigned)g0, THREADS, 0, s>>>(mask, pmask, Dp, W, B,
                                                   vec, words);
    }
    // without a mask: one query, the CSR's lanes gathered as they are;
    // a mask not packed: its bytes
    const bool bytes = mask != nullptr && words == nullptr;
    const unsigned* w = mask != nullptr ? words : nullptr;
    const int* o = mask != nullptr ? chunk_order : nullptr;
    const int* d = mask != nullptr ? docs_ord : doc_ids;
    const float* v = mask != nullptr ? vals_ord : values;
    const uint8_t* bm = bytes ? mask : nullptr;
    const uint8_t* bp = bytes ? pmask : nullptr;
    if (thread_chunks && bytes) {
      binned_reduce_chunks<true, true><<<(unsigned)g1, THREADS, 0, s>>>(
          lane_order, chunk_start, o, nch, w, W, Dp, d, v, cval, B, needs,
          p_cnt, p_sum, p_sq, p_mn, p_mx, bm, bp);
    } else if (thread_chunks) {
      binned_reduce_chunks<true, false><<<(unsigned)g1, THREADS, 0, s>>>(
          lane_order, chunk_start, o, nch, w, W, Dp, d, v, cval, B, needs,
          p_cnt, p_sum, p_sq, p_mn, p_mx, bm, bp);
    } else if (bytes) {
      binned_reduce_chunks<false, true><<<(unsigned)g1, THREADS, 0, s>>>(
          lane_order, chunk_start, o, nch, w, W, Dp, d, v, cval, B, needs,
          p_cnt, p_sum, p_sq, p_mn, p_mx, bm, bp);
    } else {
      binned_reduce_chunks<false, false><<<(unsigned)g1, THREADS, 0, s>>>(
          lane_order, chunk_start, o, nch, w, W, Dp, d, v, cval, B, needs,
          p_cnt, p_sum, p_sq, p_mn, p_mx, bm, bp);
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
