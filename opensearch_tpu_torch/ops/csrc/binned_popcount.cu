// K5 binned_popcount: per-bin counts of a query's eligible (doc, value)
// lanes against static per-bin lane bitmasks, for B queries at once:
// out i32 [B, card].
//
// Replaces opensearch_tpu/search/aggs/engine.py:_pack_bits, the fused
// bucket_bits / presence_bits kinds of _eval_agg, and the popcount route
// of _binned_sums (bucket counts, doc counts, cardinality presence).
//
// What bounds it on an H100: bytes. Per query it reads one mask byte (two
// with pmask) per lane and, for every 32-lane word that holds an eligible
// lane, the card bin words of that column (4 B each); it writes card ints.
// The bin words are static and shared by the B queries: consecutive CTAs
// take the same lane range for different queries, so they meet in L2.
//
// Design. One warp takes 32 consecutive words (1,024 lanes). For each
// word it reads ok = mask[b][doc(lane)] (AND pmask[b][doc(lane)]), where
// doc(lane) = doc_ids[lane] or the lane itself on the identity / doc-space
// layouts, and __ballot_sync packs the 32 flags: bit j of word w is lane
// 32w + j, the reference's _pack_bits word bit for bit. Lane i keeps word
// i. Then, bin by bin, each lane popcounts its word AND the bin's word
// (coalesced: 32 consecutive words of one bin row), the warp sums the 32
// counts and lane 0 adds them to the CTA's shared bin counter. Words with
// no eligible lane skip their bin reads. At the end the CTA adds its
// counters to out with integer atomics. Integer sums are exact in any
// order, so the result is deterministic.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TILES = 4;                          // 32-word tiles per warp
constexpr int CTA_WORDS = WARPS * TILES * 32;     // 32,768 lanes per CTA

__global__ void __launch_bounds__(THREADS)
binned_popcount_kernel(const uint8_t* __restrict__ mask,
                       const uint8_t* __restrict__ pmask, int Dp,
                       const int* __restrict__ doc_ids, int nw,
                       const unsigned* __restrict__ binbits, int card, int B,
                       int* __restrict__ out) {
  extern __shared__ int s_count[];  // [card]
  const int b = blockIdx.x % B;
  const int chunk = blockIdx.x / B;
  for (int i = threadIdx.x; i < card; i += THREADS) s_count[i] = 0;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint8_t* mrow = mask + (size_t)b * Dp;
  const uint8_t* prow = pmask != nullptr ? pmask + (size_t)b * Dp : nullptr;
  for (int t = 0; t < TILES; ++t) {
    const int w0 = chunk * CTA_WORDS + (warp * TILES + t) * 32;
    if (w0 >= nw) break;  // warp-uniform
    const int nwt = min(32, nw - w0);
    unsigned mine = 0;
    for (int i = 0; i < nwt; ++i) {
      const int l = (w0 + i) * 32 + lane;
      const int doc = doc_ids != nullptr ? doc_ids[l] : l;
      bool ok = false;
      if (doc >= 0 && doc < Dp) {
        ok = mrow[doc] != 0;
        if (prow != nullptr) ok = ok && prow[doc] != 0;
      }
      const unsigned word = __ballot_sync(FULL, ok);
      if (lane == i) mine = word;
    }
    if (!__any_sync(FULL, mine != 0)) continue;
    const unsigned* col = binbits + w0 + lane;
    for (int bin = 0; bin < card; ++bin) {
      // mine != 0 only on lanes < nwt, so the read stays in the row
      const unsigned bits =
          mine != 0 ? (__ldg(col + (size_t)bin * nw) & mine) : 0u;
      const unsigned c = __reduce_add_sync(FULL, (unsigned)__popc(bits));
      if (lane == 0 && c != 0) atomicAdd(&s_count[bin], (int)c);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < card; i += THREADS) {
    if (s_count[i] != 0) atomicAdd(&out[(size_t)b * card + i], s_count[i]);
  }
}

}  // namespace

// mask / pmask: u8 [B, Dp] (pmask may be null); doc_ids: int32 [n] or null
// (lane k is doc k); n % 32 == 0; binbits: u32 [card, n / 32]. out: i32
// [B, card], zeroed here first.
extern "C" int binned_popcount(const uint8_t* mask, const uint8_t* pmask,
                               int Dp, const int* doc_ids, int n,
                               const unsigned* binbits, int card, int B,
                               int* out, void* stream) {
  if (B <= 0 || card <= 0) return 0;
  if (n % 32 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)B * card * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  const int nw = n / 32;
  if (nw == 0) return 0;
  const long long chunks = (nw + CTA_WORDS - 1) / CTA_WORDS;
  const long long grid = chunks * B;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  binned_popcount_kernel<<<(unsigned)grid, THREADS, card * sizeof(int), s>>>(
      mask, pmask, Dp, doc_ids, nw, binbits, card, B, out);
  return (int)cudaGetLastError();
}

extern "C" const char* binned_popcount_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
