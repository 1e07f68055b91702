// K3 masked_topk: the dense query phase's eligibility, total and exact
// masked top-k over per-doc scores of B queries, out f32 [B, 2k+1] packed
// rows (k scores | k doc indices as int32 bits | total as int32 bits).
//
// Replaces opensearch_tpu/search/executor.py:build_batched_query_phase
// (`one`: eligible = matches & live & root & in_seg & score >= min_score,
// total = sum(eligible), lax.top_k over the masked scores via
// _topk_or_empty, packed by _pack_row).
//
// What bounds it on an H100: bytes. The least work reads each doc's score
// (4 B) and match flag (1 B) once per query plus the shared live / root
// masks, and writes 8 B per selected doc; the selection itself is a few
// integer ops per doc.
//
// Design. Every lane gets one unique, order-preserving 64-bit key:
// (order-preserving u32 of the masked f32 score) << 32 | (~index), so key
// descending is score descending with ties to the lowest index, and -inf
// (ineligible) lanes still order by index after every eligible one: the
// lax.top_k contract, which torch.topk does not promise. An exact radix
// select over the keys finds a threshold T that exactly k keys reach in at
// most 8 passes of 8 bits (it stops once a digit's keys are all needed)
// (each pass a histogram of the next digit over the lanes whose higher
// digits match, built in shared memory and summed with integer atomics,
// then a one-warp scan per query), a collect pass copies the k keys >= T,
// and one CTA per query bitonic-sorts them in shared memory (k <= 16384).
// The lanes of a warp that fall in one histogram bin add to it once (a
// warp match vote): the first digits of real keys are few. Each pass
// re-reads the scores and flags, so this version moves up to 9x the least
// bytes; a fused histogram over wider digits is the next step.
//
// A second entry, masked_topk_threshold, serves selections past MAX_K (a
// `knn` node's k, an IVF probe's block budget), whose callers need the SET
// of the k winners, not their order: the same radix select finds each
// row's threshold T, then one pass marks every eligible finite lane whose
// key is >= T (u8 [B, Dp]). The keys are unique, so exactly the k winners
// of masked_topk are marked; the shared-memory sort, which caps k, is
// skipped.
//
// A third entry, masked_topk_keyed, is the general path's query phase
// (opensearch_tpu/search/executor.py:build_query_phase): the same
// eligibility and total, but the top-k is taken over a per-doc sort key
// shared by the batch (K13's output; the scores themselves when no key is
// given), and the output carries the keys, the scores at the winners and
// the winners: f32 [B, 3k+1]. Its k reaches 65,536 (search_after's
// k-growth), past one CTA's shared memory: the radix select and collect
// are K3's, and the k collected keys sort in global memory
// (key_sort.cuh: runs of 16,384 bitonic-sorted in shared memory, then
// merge passes). Keys order totally, as lax.top_k orders them (-0.0
// below +0.0; equal keys to the lowest index).

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "key_sort.cuh"

namespace {

constexpr int HIST_THREADS = 256;
constexpr int SORT_THREADS = 1024;
constexpr int MAX_K = 16384;

__device__ __forceinline__ unsigned ord_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float ord_val(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

struct Rows {
  const float* scores;
  const uint8_t* matches;
  const uint8_t* live;
  const uint8_t* root;
  const float* min_score;
  int Dp;
  int num_docs;
  const float* key;  // masked_topk_keyed: the shared [Dp] sort key or null
};

__device__ __forceinline__ bool eligible(const Rows& r, int q, int i,
                                         float* score) {
  const float s = r.scores[(size_t)q * r.Dp + i];
  *score = s;
  return r.matches[(size_t)q * r.Dp + i] && r.live[i] && r.root[i] &&
         i < r.num_docs && s >= r.min_score[q];
}

__device__ __forceinline__ unsigned long long lane_key(bool elig, float s,
                                                       int i) {
  return ((unsigned long long)ord_key(elig ? s : -INFINITY) << 32) |
         (0xffffffffu - (unsigned)i);
}

// one lane's eligibility and selection key: the score (K3), or for the
// keyed entry the sort key (the score without one)
template <bool KEYED>
__device__ __forceinline__ unsigned long long row_key(const Rows& r, int q,
                                                      int i, bool* elig) {
  float s;
  const bool e = eligible(r, q, i, &s);
  *elig = e;
  if (KEYED) {
    return lane_key(e, r.key != nullptr ? r.key[i] : s, i);
  }
  return lane_key(e, s, i);
}

__global__ void init_kernel(unsigned long long* prefix, unsigned* krem,
                            unsigned* count, int* total, unsigned* hist,
                            int B, int k) {
  const int q = blockIdx.x;
  for (int d = threadIdx.x; d < 256; d += blockDim.x) hist[q * 256 + d] = 0;
  if (threadIdx.x == 0) {
    prefix[q] = 0;
    krem[q] = (unsigned)k;
    count[q] = 0;
    total[q] = 0;
  }
}

template <bool KEYED>
__global__ void __launch_bounds__(HIST_THREADS)
hist_kernel(Rows r, int pass, const unsigned long long* __restrict__ prefix,
            const unsigned* __restrict__ krem, unsigned* __restrict__ hist,
            int* __restrict__ total) {
  __shared__ unsigned s_hist[256];
  __shared__ int s_cnt;
  const int q = blockIdx.y;
  // the prefix already isolates the row's k keys (select_kernel)
  if (pass > 0 && krem[q] == 0) return;
  for (int d = threadIdx.x; d < 256; d += blockDim.x) s_hist[d] = 0;
  if (threadIdx.x == 0) s_cnt = 0;
  __syncthreads();
  const int shift = 56 - 8 * pass;
  const unsigned long long hi_mask =
      pass == 0 ? 0ull : (~0ull << (shift + 8));
  const unsigned long long pfx = prefix[q] & hi_mask;
  int cnt = 0;
  // every warp runs the loop as often as its block (the bound depends on
  // `base` alone), so the warp votes below see all 32 lanes
  for (int base = blockIdx.x * blockDim.x; base < r.Dp;
       base += gridDim.x * blockDim.x) {
    const int i = base + threadIdx.x;
    bool hit = false;
    unsigned digit = 0;
    if (i < r.Dp) {
      bool e;
      const unsigned long long key = row_key<KEYED>(r, q, i, &e);
      cnt += e;
      hit = (key & hi_mask) == pfx;
      digit = (unsigned)(key >> shift) & 0xffu;
    }
    // the lanes of a warp that share a digit add once: real keys share
    // few top digits (a rank's or a score's exponent), and one shared
    // counter hit by every lane would serialize the warp
    const unsigned active = __ballot_sync(0xffffffffu, hit);
    if (hit) {
      const unsigned peers = __match_any_sync(active, digit);
      if ((threadIdx.x & 31) == __ffs(peers) - 1)
        atomicAdd(&s_hist[digit], (unsigned)__popc(peers));
    }
  }
  if (pass == 0 && cnt) atomicAdd(&s_cnt, cnt);
  __syncthreads();
  for (int d = threadIdx.x; d < 256; d += blockDim.x)
    if (s_hist[d]) atomicAdd(&hist[q * 256 + d], s_hist[d]);
  if (pass == 0 && threadIdx.x == 0 && s_cnt) atomicAdd(&total[q], s_cnt);
}

// per query: the digit holding the krem-th largest key among the lanes
// matching the prefix; fixes that digit and clears the histogram
__global__ void select_kernel(int pass, unsigned long long* prefix,
                              unsigned* krem, unsigned* hist) {
  const int q = blockIdx.x;
  const int shift = 56 - 8 * pass;
  if (threadIdx.x == 0) {
    const unsigned kr = krem[q];
    unsigned cum = 0;
    for (int d = 255; kr > 0 && d >= 0; --d) {
      const unsigned c = hist[q * 256 + d];
      if (cum + c >= kr) {
        // when the digit's keys are all needed, the prefix (lower bits
        // zero) is a threshold that takes exactly the k keys: done
        krem[q] = cum + c == kr ? 0u : kr - cum;
        prefix[q] |= (unsigned long long)d << shift;
        break;
      }
      cum += c;
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < 256; d += blockDim.x) hist[q * 256 + d] = 0;
}

// copies each row's keys >= its threshold (exactly k: the keys are
// unique) to cand[q * stride + 0..k), in no particular order
template <bool KEYED>
__global__ void __launch_bounds__(HIST_THREADS)
collect_kernel(Rows r, int k, int stride,
               const unsigned long long* __restrict__ prefix,
               unsigned* __restrict__ count,
               unsigned long long* __restrict__ cand) {
  const int q = blockIdx.y;
  const unsigned long long thr = prefix[q];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < r.Dp;
       i += gridDim.x * blockDim.x) {
    bool e;
    const unsigned long long key = row_key<KEYED>(r, q, i, &e);
    if (key >= thr) {
      const unsigned pos = atomicAdd(&count[q], 1u);
      if (pos < (unsigned)k) cand[(size_t)q * stride + pos] = key;
    }
  }
}

__global__ void __launch_bounds__(SORT_THREADS)
sort_out_kernel(const unsigned long long* __restrict__ cand,
                const int* __restrict__ total, int k, int p2,
                float* __restrict__ out) {
  extern __shared__ unsigned long long a[];
  const int q = blockIdx.x;
  for (int i = threadIdx.x; i < p2; i += blockDim.x)
    a[i] = i < k ? cand[(size_t)q * k + i] : 0ull;
  __syncthreads();
  for (int kk = 2; kk <= p2; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p2; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const bool up = ((i & kk) != 0);  // descending overall
          const unsigned long long x = a[i], y = a[ixj];
          if ((x > y) == up) {
            a[i] = y;
            a[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  float* o = out + (size_t)q * (2 * k + 1);
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const unsigned long long key = a[i];
    o[i] = ord_val((unsigned)(key >> 32));
    o[k + i] = __int_as_float((int)(0xffffffffu - (unsigned)key));
  }
  if (threadIdx.x == 0) o[2 * k] = __int_as_float(total[q]);
}

__global__ void __launch_bounds__(HIST_THREADS)
mark_kernel(Rows r, const unsigned long long* __restrict__ prefix,
            uint8_t* __restrict__ mark) {
  const int q = blockIdx.y;
  const unsigned long long thr = prefix[q];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < r.Dp;
       i += gridDim.x * blockDim.x) {
    float s;
    const bool e = eligible(r, q, i, &s);
    mark[(size_t)q * r.Dp + i] =
        e && s > -INFINITY && lane_key(e, s, i) >= thr;
  }
}

// The radix select shared by the entries: per row, prefix[q] ends as a
// threshold that exactly the k largest lane keys reach (the k-th largest
// key, or a prefix of it when its digit's keys are all among the k;
// k > 0); total[q] counts the eligible lanes.
template <bool KEYED>
void radix_select(const Rows& r, int B, int k, unsigned long long* prefix,
                  unsigned* krem, unsigned* count, int* total,
                  unsigned* hist, const dim3& grid, cudaStream_t st) {
  init_kernel<<<B, 256, 0, st>>>(prefix, krem, count, total, hist, B, k);
  const int passes = k > 0 ? 8 : 1;
  for (int pass = 0; pass < passes; ++pass) {
    hist_kernel<KEYED><<<grid, HIST_THREADS, 0, st>>>(r, pass, prefix, krem,
                                                      hist, total);
    if (k > 0) select_kernel<<<B, 256, 0, st>>>(pass, prefix, krem, hist);
  }
}

// the keyed entry's rows: [k keys | k scores at the winners | k indices
// as int32 bits | the total as int32 bits]. grid (chunks, B)
__global__ void keyed_out_kernel(const unsigned long long* __restrict__ sorted,
                                 int p2, Rows r,
                                 const int* __restrict__ total, int k,
                                 float* __restrict__ out) {
  const int q = blockIdx.y;
  float* o = out + (size_t)q * (3 * (size_t)k + 1);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < k;
       i += gridDim.x * blockDim.x) {
    const unsigned long long key = sorted[(size_t)q * p2 + i];
    const int idx = (int)(0xffffffffu - (unsigned)key);
    o[i] = ord_val((unsigned)(key >> 32));
    o[k + i] = r.scores[(size_t)q * r.Dp + idx];
    o[2 * k + i] = __int_as_float(idx);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) o[3 * k] = __int_as_float(total[q]);
}

// a row's lanes in chunks of at least 8 a thread, at most 256 CTAs a row
// (up to 1,024 for fewer than 4 rows, so one row still fills the card)
dim3 lane_grid(int Dp, int B) {
  int chunks = (Dp + HIST_THREADS * 8 - 1) / (HIST_THREADS * 8);
  const int cap = B >= 4 ? 256 : 1024;
  if (chunks > cap) chunks = cap;
  return dim3(chunks, B);
}

}  // namespace

extern "C" int masked_topk(const float* scores, const uint8_t* matches,
                           const uint8_t* live, const uint8_t* root,
                           const float* min_score, int B, int Dp,
                           int num_docs, int k, float* out,
                           long long* scratch, void* stream) {
  if (B <= 0) return 0;
  if (k < 0 || k > MAX_K || k > Dp) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // scratch (int64 slots): prefix [B] | krem, count, total (u32 x 3B) |
  // hist (u32 [B, 256]) | candidate keys (u64 [B, k])
  unsigned long long* prefix = reinterpret_cast<unsigned long long*>(scratch);
  unsigned* meta = reinterpret_cast<unsigned*>(scratch + B);
  unsigned* krem = meta;
  unsigned* count = meta + B;
  int* total = reinterpret_cast<int*>(meta + 2 * B);
  unsigned* hist = reinterpret_cast<unsigned*>(scratch + 4 * (size_t)B);
  unsigned long long* cand =
      reinterpret_cast<unsigned long long*>(scratch + 260 * (size_t)B);
  const Rows r{scores, matches, live, root, min_score, Dp, num_docs,
               nullptr};

  const dim3 grid = lane_grid(Dp, B);
  radix_select<false>(r, B, k, prefix, krem, count, total, hist, grid, st);
  if (k > 0)
    collect_kernel<false><<<grid, HIST_THREADS, 0, st>>>(r, k, k, prefix,
                                                         count, cand);
  int p2 = 1;
  while (p2 < k) p2 <<= 1;
  const size_t smem = (size_t)p2 * sizeof(unsigned long long);
  // the shared-memory opt-in is per device function: set it once
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        sort_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(MAX_K * sizeof(unsigned long long)));
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  sort_out_kernel<<<B, SORT_THREADS, smem, st>>>(cand, total, k, p2, out);
  return (int)cudaGetLastError();
}

// The winners' mark for any 0 <= k <= Dp: mark u8 [B, Dp] is 1 at every
// eligible finite lane among the row's k best keys. scratch: int64
// [B * 260], laid out as masked_topk's without the candidate keys.
extern "C" int masked_topk_threshold(const float* scores,
                                     const uint8_t* matches,
                                     const uint8_t* live,
                                     const uint8_t* root,
                                     const float* min_score, int B, int Dp,
                                     int num_docs, int k, uint8_t* mark,
                                     long long* scratch, void* stream) {
  if (B <= 0 || Dp <= 0) return 0;
  if (k < 0 || k > Dp) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (k == 0)
    return (int)cudaMemsetAsync(mark, 0, (size_t)B * Dp, st);
  unsigned long long* prefix = reinterpret_cast<unsigned long long*>(scratch);
  unsigned* meta = reinterpret_cast<unsigned*>(scratch + B);
  unsigned* hist = reinterpret_cast<unsigned*>(scratch + 4 * (size_t)B);
  const Rows r{scores, matches, live, root, min_score, Dp, num_docs,
               nullptr};
  const dim3 grid = lane_grid(Dp, B);
  radix_select<false>(r, B, k, prefix, meta, meta + B,
               reinterpret_cast<int*>(meta + 2 * B), hist, grid, st);
  mark_kernel<<<grid, HIST_THREADS, 0, st>>>(r, prefix, mark);
  return (int)cudaGetLastError();
}

// The general path's query phase: out f32 [B, 3k+1] for any 0 <= k <=
// Dp; `key` is the shared [Dp] sort key, or null to select by score.
// scratch: int64 [B * (260 + 2 * p2)], p2 the power of two >= k: K3's
// select state, then the collected keys and the merge buffer.
extern "C" int masked_topk_keyed(const float* scores, const uint8_t* matches,
                                 const uint8_t* live, const uint8_t* root,
                                 const float* min_score, const float* key,
                                 int B, int Dp, int num_docs, int k,
                                 float* out, long long* scratch,
                                 void* stream) {
  if (B <= 0) return 0;
  if (k < 0 || k > Dp) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int p2 = 1;
  while (p2 < k) p2 <<= 1;
  unsigned long long* prefix = reinterpret_cast<unsigned long long*>(scratch);
  unsigned* meta = reinterpret_cast<unsigned*>(scratch + B);
  unsigned* krem = meta;
  unsigned* count = meta + B;
  int* total = reinterpret_cast<int*>(meta + 2 * B);
  unsigned* hist = reinterpret_cast<unsigned*>(scratch + 4 * (size_t)B);
  unsigned long long* cand =
      reinterpret_cast<unsigned long long*>(scratch + 260 * (size_t)B);
  unsigned long long* tmp = cand + (size_t)B * p2;
  const Rows r{scores, matches, live, root, min_score, Dp, num_docs, key};

  const dim3 grid = lane_grid(Dp, B);
  radix_select<true>(r, B, k, prefix, krem, count, total, hist, grid, st);
  unsigned long long* sorted = cand;
  if (k > 0) {
    // padding past k sorts last: every lane key is > 0
    cudaError_t e = cudaMemsetAsync(
        cand, 0, (size_t)B * p2 * sizeof(unsigned long long), st);
    if (e != cudaSuccess) return (int)e;
    collect_kernel<true><<<grid, HIST_THREADS, 0, st>>>(r, k, p2, prefix,
                                                        count, cand);
    const int code = keysort::sort_rows(cand, tmp, B, p2, &sorted, st);
    if (code != 0) return code;
  }
  int chunks = (k + 255) / 256;
  if (chunks < 1) chunks = 1;
  if (chunks > 256) chunks = 256;
  keyed_out_kernel<<<dim3(chunks, B), 256, 0, st>>>(sorted, p2, r, total, k,
                                                    out);
  return (int)cudaGetLastError();
}

extern "C" const char* masked_topk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
