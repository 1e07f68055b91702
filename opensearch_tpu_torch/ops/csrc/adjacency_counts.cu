// K17 adjacency_counts: the cell counts of an adjacency_matrix aggregation
// for B queries at once: for every pair of filters i <= j and every parent
// bin c, the number of docs that match filter i and filter j, the query
// (and the parent condition) and lie in bin c.
//
// Replaces opensearch_tpu/search/aggs/engine.py:_eval_agg's adjacency
// kind: its n(n+1)/2 masked scatter-adds.
//
// What bounds it on an H100: bytes. It reads the n filter masks, the query
// mask and the parent mask once per doc and query (one byte each) and,
// under a parent bucket, the doc's static parent bin; the arithmetic is a
// popcount per pair and 16 docs.
//
// Design. A thread takes 16 consecutive docs of one query at a time (one
// 16-byte load per mask; Dp is a multiple of 16) and ANDs the query mask
// (and the parent mask) into each filter's 16 flags, one byte a doc. At
// the root (every doc in bin 0, n <= 8) it adds popcount(f_i & f_j) of the
// four words to a register counter per pair, folds the counters over its
// warp and adds them to the output with one integer atomic per pair and
// warp. Under a parent bucket, each doc with a flag set reads its bin and
// adds one to the cell of each pair it is in, in shared memory where the
// cells fit (else in global memory), then the block adds its shared cells
// to the output. Integer adds commute exactly, so the counts are the same
// from run to run and equal their plain version's.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_FILTERS = 32;
constexpr int ROOT_MAX_FILTERS = 8;
constexpr int ROOT_MAX_PAIRS = ROOT_MAX_FILTERS * (ROOT_MAX_FILTERS + 1) / 2;
constexpr int SHARED_CELLS = 12288;  // 48 KB of int counters

struct MaskPtrs {
  const uint8_t* m[MAX_FILTERS];
};

__device__ __forceinline__ uint4 load16(const uint8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ uint4 and4(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

__device__ __forceinline__ int popc4(uint4 a) {
  return __popc(a.x) + __popc(a.y) + __popc(a.z) + __popc(a.w);
}

__device__ __forceinline__ unsigned byte_of(uint4 a, int k) {
  const unsigned w = k < 4 ? a.x : (k < 8 ? a.y : (k < 12 ? a.z : a.w));
  return (w >> (8 * (k & 3))) & 0xffu;
}

// the query's eligible flags of 16 docs, one byte a doc (0 or 1)
__device__ __forceinline__ uint4 eligible16(const uint8_t* mrow,
                                            const uint8_t* prow, int d) {
  uint4 ok = load16(mrow + d);
  if (prow != nullptr) ok = and4(ok, load16(prow + d));
  return ok;
}

__global__ void __launch_bounds__(THREADS)
adjacency_root(MaskPtrs masks, int n, const uint8_t* __restrict__ mask,
               const uint8_t* __restrict__ pmask, int Dp,
               int* __restrict__ out) {
  const int b = blockIdx.y;
  const int P = n * (n + 1) / 2;
  const size_t row = (size_t)b * Dp;
  const uint8_t* mrow = mask + row;
  const uint8_t* prow = pmask != nullptr ? pmask + row : nullptr;
  int acc[ROOT_MAX_PAIRS];
#pragma unroll
  for (int p = 0; p < ROOT_MAX_PAIRS; ++p) acc[p] = 0;
  const int groups = Dp / 16;
  for (int t = blockIdx.x * THREADS + threadIdx.x; t < groups;
       t += gridDim.x * THREADS) {
    const int d = t * 16;
    const uint4 ok = eligible16(mrow, prow, d);
    if ((ok.x | ok.y | ok.z | ok.w) == 0) continue;
    uint4 f[ROOT_MAX_FILTERS];
#pragma unroll
    for (int i = 0; i < ROOT_MAX_FILTERS; ++i) {
      if (i < n) f[i] = and4(load16(masks.m[i] + row + d), ok);
    }
    int p = 0;
#pragma unroll
    for (int i = 0; i < ROOT_MAX_FILTERS; ++i) {
#pragma unroll
      for (int j = i; j < ROOT_MAX_FILTERS; ++j) {
        if (j < n) acc[p] += popc4(and4(f[i], f[j]));
        if (j < n) ++p;
      }
    }
  }
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < ROOT_MAX_PAIRS; ++p) {
    if (p < P) {
      const int v = __reduce_add_sync(0xffffffffu, acc[p]);
      if (lane == 0 && v != 0) atomicAdd(out + (size_t)b * P + p, v);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
adjacency_binned(MaskPtrs masks, int n, const uint8_t* __restrict__ mask,
                 const uint8_t* __restrict__ pmask, int Dp,
                 const int* __restrict__ pbin, int card,
                 int* __restrict__ out) {
  extern __shared__ int cells[];
  const int b = blockIdx.y;
  const int P = n * (n + 1) / 2;
  const long long ncell = (long long)P * card;
  const bool shared = ncell <= SHARED_CELLS;
  int* dst = shared ? cells : out + (size_t)b * ncell;
  if (shared) {
    for (int k = threadIdx.x; k < ncell; k += THREADS) cells[k] = 0;
    __syncthreads();
  }
  const size_t row = (size_t)b * Dp;
  const uint8_t* mrow = mask + row;
  const uint8_t* prow = pmask != nullptr ? pmask + row : nullptr;
  const int groups = Dp / 16;
  for (int t = blockIdx.x * THREADS + threadIdx.x; t < groups;
       t += gridDim.x * THREADS) {
    const int d = t * 16;
    const uint4 ok = eligible16(mrow, prow, d);
    if ((ok.x | ok.y | ok.z | ok.w) == 0) continue;
    uint4 f[MAX_FILTERS];
    unsigned any = 0;
    for (int i = 0; i < n; ++i) {
      f[i] = and4(load16(masks.m[i] + row + d), ok);
      any |= f[i].x | f[i].y | f[i].z | f[i].w;
    }
    if (any == 0) continue;
    for (int k = 0; k < 16; ++k) {
      const int c = pbin != nullptr ? pbin[d + k] : 0;
      if (c < 0 || c >= card) continue;
      unsigned bits = 0;  // bit i: the doc matches filter i
      for (int i = 0; i < n; ++i) bits |= byte_of(f[i], k) << i;
      if (bits == 0) continue;
      int p = 0;
      for (int i = 0; i < n; ++i) {
        for (int j = i; j < n; ++j, ++p) {
          if (((bits >> i) & 1u) && ((bits >> j) & 1u)) {
            atomicAdd(dst + (size_t)p * card + c, 1);
          }
        }
      }
    }
  }
  if (shared) {
    __syncthreads();
    for (int k = threadIdx.x; k < ncell; k += THREADS) {
      if (cells[k] != 0) atomicAdd(out + (size_t)b * ncell + k, cells[k]);
    }
  }
}

}  // namespace

// masks: n pointers to u8 [B, Dp] filter masks; mask / pmask u8 [B, Dp]
// (pmask may be null); pbin int32 [Dp] the static parent bin (-1: none) or
// null (every doc in bin 0, card 1). out int32 [B, n(n+1)/2, card], zeroed
// here. Dp % 16 == 0 and 16-byte aligned rows.
extern "C" int adjacency_counts(const uint8_t* const* masks, int n,
                                const uint8_t* mask, const uint8_t* pmask,
                                int Dp, const int* pbin, int card, int B,
                                int* out, void* stream) {
  if (n <= 0 || n > MAX_FILTERS || Dp % 16 != 0 || card <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int P = n * (n + 1) / 2;
  cudaError_t e = cudaMemsetAsync(
      out, 0, sizeof(int) * (size_t)B * P * card, s);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0 || Dp == 0) return 0;
  MaskPtrs mp;
  for (int i = 0; i < MAX_FILTERS; ++i) mp.m[i] = i < n ? masks[i] : nullptr;
  const int groups = Dp / 16;
  int gx = (groups + THREADS - 1) / THREADS;
  if (gx > 128) gx = 128;
  const dim3 grid(gx, B);
  if (pbin == nullptr && card == 1 && n <= ROOT_MAX_FILTERS) {
    adjacency_root<<<grid, THREADS, 0, s>>>(mp, n, mask, pmask, Dp, out);
  } else {
    const long long ncell = (long long)P * card;
    const size_t smem = ncell <= SHARED_CELLS ? sizeof(int) * ncell : 0;
    adjacency_binned<<<grid, THREADS, smem, s>>>(mp, n, mask, pmask, Dp,
                                                 pbin, card, out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* adjacency_counts_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
