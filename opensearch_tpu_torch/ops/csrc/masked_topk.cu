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
// select over the keys finds the k-th largest key T in 8 passes of 8 bits
// (each pass a histogram of the next digit over the lanes whose higher
// digits match, built in shared memory and summed with integer atomics,
// then a one-warp scan per query), a collect pass copies the k keys >= T,
// and one CTA per query bitonic-sorts them in shared memory (k <= 16384).
// Each pass re-reads the scores and flags, so this simple version moves
// about 8x the least bytes; a fused histogram and an early exit once the
// prefix isolates k lanes are the next steps.

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

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

__global__ void __launch_bounds__(HIST_THREADS)
hist_kernel(Rows r, int pass, const unsigned long long* __restrict__ prefix,
            unsigned* __restrict__ hist, int* __restrict__ total) {
  __shared__ unsigned s_hist[256];
  __shared__ int s_cnt;
  const int q = blockIdx.y;
  for (int d = threadIdx.x; d < 256; d += blockDim.x) s_hist[d] = 0;
  if (threadIdx.x == 0) s_cnt = 0;
  __syncthreads();
  const int shift = 56 - 8 * pass;
  const unsigned long long hi_mask =
      pass == 0 ? 0ull : (~0ull << (shift + 8));
  const unsigned long long pfx = prefix[q] & hi_mask;
  int cnt = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < r.Dp;
       i += gridDim.x * blockDim.x) {
    float s;
    const bool e = eligible(r, q, i, &s);
    cnt += e;
    const unsigned long long key = lane_key(e, s, i);
    if ((key & hi_mask) == pfx)
      atomicAdd(&s_hist[(unsigned)(key >> shift) & 0xffu], 1u);
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
    for (int d = 255; d >= 0; --d) {
      const unsigned c = hist[q * 256 + d];
      if (cum + c >= kr) {
        krem[q] = kr - cum;
        prefix[q] |= (unsigned long long)d << shift;
        break;
      }
      cum += c;
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < 256; d += blockDim.x) hist[q * 256 + d] = 0;
}

__global__ void __launch_bounds__(HIST_THREADS)
collect_kernel(Rows r, int k, const unsigned long long* __restrict__ prefix,
               unsigned* __restrict__ count,
               unsigned long long* __restrict__ cand) {
  const int q = blockIdx.y;
  const unsigned long long thr = prefix[q];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < r.Dp;
       i += gridDim.x * blockDim.x) {
    float s;
    const bool e = eligible(r, q, i, &s);
    const unsigned long long key = lane_key(e, s, i);
    if (key >= thr) {
      const unsigned pos = atomicAdd(&count[q], 1u);
      if (pos < (unsigned)k) cand[(size_t)q * k + pos] = key;
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
  const Rows r{scores, matches, live, root, min_score, Dp, num_docs};

  init_kernel<<<B, 256, 0, st>>>(prefix, krem, count, total, hist, B, k);
  int chunks = (Dp + HIST_THREADS * 8 - 1) / (HIST_THREADS * 8);
  if (chunks > 256) chunks = 256;
  const dim3 grid(chunks, B);
  const int passes = k > 0 ? 8 : 1;
  for (int pass = 0; pass < passes; ++pass) {
    hist_kernel<<<grid, HIST_THREADS, 0, st>>>(r, pass, prefix, hist, total);
    if (k > 0) select_kernel<<<B, 256, 0, st>>>(pass, prefix, krem, hist);
  }
  if (k > 0) collect_kernel<<<grid, HIST_THREADS, 0, st>>>(r, k, prefix,
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

extern "C" const char* masked_topk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
