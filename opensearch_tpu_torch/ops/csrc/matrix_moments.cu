// K16 matrix_moments: the partial sums of a matrix_stats aggregation for B
// queries at once, per parent bin: for each field f, the count of eligible
// docs with a value and the sums of v, v^2, v^3, v^4; for each pair of
// fields (a, b), the count of eligible docs with both and the sums of
// a*b, a and b.
//
// Replaces opensearch_tpu/search/aggs/engine.py:_eval_agg's matrix_stats
// kind: its 5F + 4F(F-1)/2 masked scatter-adds.
//
// What bounds it on an H100: bytes. It reads the query mask (and the
// parent mask) once per doc and query, each field's dense value and its
// exists flag, and the static bin layout; it writes a few numbers per bin.
// A term costs a few flops per doc.
//
// Design. The parent bins are static for a plan and a segment, so the
// caller builds once the CSR of the docs grouped by bin (doc order kept
// inside a bin), cut into chunks that never cross a bin (K6's layout,
// ops/binned.py:bin_csr, with chunks of 2,048 docs,
// ops/agg_kernels.py:MOMENTS_CHUNK). Pass 1: one warp per (chunk,
// query) folds the chunk's docs into every term group -- one per field,
// one per pair -- every thread every 32nd doc in order, then the 32
// threads in a fixed shuffle tree: the groups' chunk partials (a count
// and four sums). Up to four fields, a doc's flags and values load once
// for all groups; past four, the groups take turns. (Four queries a warp,
// sharing those loads, ran 1.8x slower: 60 accumulators a thread.) Pass 2
// folds each (bin, query, group)'s chunk partials the same way: one warp,
// every thread every 32nd partial, or, where the caller's largest bin has
// more than 256 chunks (the root's one bin of 8,192 at Dp = 2^24), one
// block of eight warps, every thread every 256th partial, the shuffle tree
// in each warp and then the eight warps' results in order. No float
// atomics: two runs give the same bits. Powers are v^3 = (v*v)*v and
// v^4 = (v*v)*(v*v), as the reference's integer_pow; a sum that overflows
// f32 stays inf, as the reference's does.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

struct Acc {
  int cnt;
  float s[4];
};

__device__ __forceinline__ Acc warp_fold(Acc a) {
  for (int off = 16; off > 0; off >>= 1) {
    a.cnt += __shfl_down_sync(FULL, a.cnt, off);
#pragma unroll
    for (int k = 0; k < 4; ++k) a.s[k] += __shfl_down_sync(FULL, a.s[k], off);
  }
  return a;
}

__device__ __forceinline__ void store_partial(const Acc& a, int g, int b,
                                              long long c, int G, int B,
                                              int nch, int* p_cnt,
                                              float* p_sum) {
  const size_t o = ((size_t)g * B + b) * nch + c;
  p_cnt[o] = a.cnt;
#pragma unroll
  for (int k = 0; k < 4; ++k) p_sum[(size_t)k * G * B * nch + o] = a.s[k];
}

// F <= 4 fields: one warp per (chunk, query) loads each doc's flags and
// values once and feeds every group's accumulators (fields first, then
// the pairs a < b in order), then folds each group: per group the same
// order as moments_chunks.
template <int F>
__global__ void __launch_bounds__(THREADS)
moments_chunks_fused(const int* __restrict__ lane_order,
                     const int* __restrict__ chunk_start, int nch,
                     const uint8_t* __restrict__ mask,
                     const uint8_t* __restrict__ pmask, int Dp,
                     const float* __restrict__ vals,
                     const uint8_t* __restrict__ exists, int B,
                     int* __restrict__ p_cnt, float* __restrict__ p_sum) {
  constexpr int G = F + F * (F - 1) / 2;
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (item >= (long long)nch * B) return;  // warp-uniform
  const int b = (int)(item % B);
  const long long c = item / B;
  const uint8_t* mrow = mask + (size_t)b * Dp;
  const uint8_t* prow = pmask != nullptr ? pmask + (size_t)b * Dp : nullptr;
  Acc acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = Acc{0, {0.0f, 0.0f, 0.0f, 0.0f}};
  const int e = chunk_start[c + 1];
  for (int i = chunk_start[c] + lane; i < e; i += 32) {
    const int doc = lane_order[i];
    if (doc < 0 || doc >= Dp) continue;
    if (mrow[doc] == 0) continue;
    if (prow != nullptr && prow[doc] == 0) continue;
    float v[F];
    bool ex[F];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      ex[f] = exists[(size_t)f * Dp + doc] != 0;
      v[f] = vals[(size_t)f * Dp + doc];
    }
#pragma unroll
    for (int f = 0; f < F; ++f) {
      if (!ex[f]) continue;
      const float x = v[f], x2 = x * x;
      acc[f].cnt += 1;
      acc[f].s[0] += x;
      acc[f].s[1] += x2;
      acc[f].s[2] += x2 * x;
      acc[f].s[3] += x2 * x2;
    }
    int g = F;
#pragma unroll
    for (int fa = 0; fa < F; ++fa) {
#pragma unroll
      for (int fb = fa + 1; fb < F; ++fb, ++g) {
        if (!ex[fa] || !ex[fb]) continue;
        acc[g].cnt += 1;
        acc[g].s[0] += v[fa] * v[fb];
        acc[g].s[1] += v[fa];
        acc[g].s[2] += v[fb];
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const Acc a = warp_fold(acc[g]);
    if (lane == 0) store_partial(a, g, b, c, G, B, nch, p_cnt, p_sum);
  }
}

// the fields (a, b) of pair p: the pairs a < b in order
__device__ __forceinline__ void pair_fields(int p, int F, int& a, int& b) {
  a = 0;
  while (p >= F - 1 - a) {
    p -= F - 1 - a;
    ++a;
  }
  b = a + 1 + p;
}

// any F: one warp per (chunk, query) folds one group at a time (g < F:
// field g; else pair g - F), in the fused kernel's order, so both give
// the same bits
__global__ void __launch_bounds__(THREADS)
moments_chunks(const int* __restrict__ lane_order,
               const int* __restrict__ chunk_start, int nch,
               const uint8_t* __restrict__ mask,
               const uint8_t* __restrict__ pmask, int Dp,
               const float* __restrict__ vals,
               const uint8_t* __restrict__ exists, int F, int G, int B,
               int* __restrict__ p_cnt, float* __restrict__ p_sum) {
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (item >= (long long)nch * B) return;  // warp-uniform
  const int b = (int)(item % B);
  const long long c = item / B;
  const uint8_t* mrow = mask + (size_t)b * Dp;
  const uint8_t* prow = pmask != nullptr ? pmask + (size_t)b * Dp : nullptr;
  const int s = chunk_start[c], e = chunk_start[c + 1];
  for (int g = 0; g < G; ++g) {
    const bool field = g < F;
    int fa = g, fb = g;
    if (!field) pair_fields(g - F, F, fa, fb);
    const float* va = vals + (size_t)fa * Dp;
    const float* vb = vals + (size_t)fb * Dp;
    const uint8_t* ea = exists + (size_t)fa * Dp;
    const uint8_t* eb = exists + (size_t)fb * Dp;
    Acc a{0, {0.0f, 0.0f, 0.0f, 0.0f}};
    for (int i = s + lane; i < e; i += 32) {
      const int doc = lane_order[i];
      if (doc < 0 || doc >= Dp) continue;
      if (mrow[doc] == 0) continue;
      if (prow != nullptr && prow[doc] == 0) continue;
      if (ea[doc] == 0 || eb[doc] == 0) continue;
      const float x = va[doc];
      a.cnt += 1;
      if (field) {
        const float x2 = x * x;
        a.s[0] += x;
        a.s[1] += x2;
        a.s[2] += x2 * x;
        a.s[3] += x2 * x2;
      } else {
        const float y = vb[doc];
        a.s[0] += x * y;
        a.s[1] += x;
        a.s[2] += y;
      }
    }
    a = warp_fold(a);
    if (lane == 0) store_partial(a, g, b, c, G, B, nch, p_cnt, p_sum);
  }
}

// BLOCK false: one warp per (bin, query, group), every 32nd partial per
// thread, then the shuffle tree; true: one block, every 256th partial per
// thread, the shuffle tree in each warp, then the eight warps' results in
// order
template <bool BLOCK>
__global__ void __launch_bounds__(THREADS)
moments_bins(const int* __restrict__ bin_chunk, int total, int nch, int G,
             int B, const int* __restrict__ p_cnt,
             const float* __restrict__ p_sum, int* __restrict__ cnt,
             float* __restrict__ sum) {
  __shared__ Acc part[WARPS];
  const int lane = threadIdx.x & 31;
  const int step = BLOCK ? THREADS : 32;
  const int first = BLOCK ? (int)threadIdx.x : lane;
  const long long item = BLOCK
      ? (long long)blockIdx.x
      : (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (item >= (long long)total * B * G) return;  // block-uniform by BLOCK
  const int bin = (int)(item % total);
  const int b = (int)((item / total) % B);
  const int g = (int)(item / ((long long)total * B));
  const size_t row = ((size_t)g * B + b) * nch;
  const size_t plane = (size_t)G * B * nch;
  Acc a{0, {0.0f, 0.0f, 0.0f, 0.0f}};
  for (int i = bin_chunk[bin] + first; i < bin_chunk[bin + 1]; i += step) {
    a.cnt += p_cnt[row + i];
#pragma unroll
    for (int k = 0; k < 4; ++k) a.s[k] += p_sum[k * plane + row + i];
  }
  a = warp_fold(a);
  if (BLOCK) {
    if (lane == 0) part[threadIdx.x >> 5] = a;
    __syncthreads();
    if (threadIdx.x != 0) return;
    a = part[0];
    for (int w = 1; w < WARPS; ++w) {
      a.cnt += part[w].cnt;
#pragma unroll
      for (int k = 0; k < 4; ++k) a.s[k] += part[w].s[k];
    }
  }
  if (lane == 0) {
    const size_t o = ((size_t)g * B + b) * total + bin;
    cnt[o] = a.cnt;
#pragma unroll
    for (int k = 0; k < 4; ++k) sum[(size_t)k * G * B * total + o] = a.s[k];
  }
}

long long warp_blocks(long long items) {
  return (items + WARPS - 1) / WARPS;
}

}  // namespace

// CSR of the parent bins over doc lanes (lane_order int32 [nnz],
// chunk_start int32 [nch + 1], bin_chunk int32 [total + 1]); mask / pmask
// u8 [B, Dp] (pmask may be null); vals f32 [F, Dp]; exists u8 [F, Dp];
// G = F + F(F-1)/2 groups; block_fold: pass 2 by block (else by warp).
// scratch: 5 * G * B * nch words. Outputs: cnt int32 [G, B, total], sum
// f32 [4, G, B, total].
extern "C" int matrix_moments(const int* lane_order, int nnz,
                              const int* chunk_start, int nch,
                              const int* bin_chunk, int total,
                              const uint8_t* mask, const uint8_t* pmask,
                              int Dp, const float* vals,
                              const uint8_t* exists, int F, int G, int B,
                              int block_fold, void* scratch,
                              int* cnt, float* sum, void* stream) {
  (void)nnz;
  if (B <= 0 || total <= 0 || G <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int* p_cnt = (int*)scratch;
  float* p_sum = (float*)scratch + (size_t)G * B * nch;
  const long long g1 = warp_blocks((long long)nch * B);
  const long long items2 = (long long)total * B * G;
  const long long g2 = block_fold ? items2 : warp_blocks(items2);
  if (g1 > 0x7fffffffLL || g2 > 0x7fffffffLL) {
    return (int)cudaErrorInvalidConfiguration;
  }
  if (nch > 0) {
    const unsigned grid = (unsigned)g1;
    switch (F) {
      case 1:
        moments_chunks_fused<1><<<grid, THREADS, 0, s>>>(
            lane_order, chunk_start, nch, mask, pmask, Dp, vals, exists, B,
            p_cnt, p_sum);
        break;
      case 2:
        moments_chunks_fused<2><<<grid, THREADS, 0, s>>>(
            lane_order, chunk_start, nch, mask, pmask, Dp, vals, exists, B,
            p_cnt, p_sum);
        break;
      case 3:
        moments_chunks_fused<3><<<grid, THREADS, 0, s>>>(
            lane_order, chunk_start, nch, mask, pmask, Dp, vals, exists, B,
            p_cnt, p_sum);
        break;
      case 4:
        moments_chunks_fused<4><<<grid, THREADS, 0, s>>>(
            lane_order, chunk_start, nch, mask, pmask, Dp, vals, exists, B,
            p_cnt, p_sum);
        break;
      default:
        moments_chunks<<<grid, THREADS, 0, s>>>(
            lane_order, chunk_start, nch, mask, pmask, Dp, vals, exists, F,
            G, B, p_cnt, p_sum);
    }
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (block_fold) {
    moments_bins<true><<<(unsigned)g2, THREADS, 0, s>>>(
        bin_chunk, total, nch, G, B, p_cnt, p_sum, cnt, sum);
  } else {
    moments_bins<false><<<(unsigned)g2, THREADS, 0, s>>>(
        bin_chunk, total, nch, G, B, p_cnt, p_sum, cnt, sum);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* matrix_moments_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
