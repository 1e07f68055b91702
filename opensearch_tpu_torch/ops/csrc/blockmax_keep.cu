// K20 blockmax_keep: block-max phase A for B text-clause queries against one
// segment, out keep u8 [B, QB] and pruned i32 [B].
//
// Replaces opensearch_tpu/ops/bm25.py:blockmax_keep_mask. Per lane (posting
// block of the clause) the upper bound of any doc's score in it,
//   self_ub = max(w, 0) * (k1 + 1) * bscale * post_bound[id],
//   ub      = self_ub + (S - tmax[tid]),
// with tmax the per-term maximum of self_ub and S their sum. The 8 lanes of
// highest ub (ties to the lowest lane) are scored exactly; theta is the
// k-th best eligible doc score of that slice (-inf with fewer, or when the
// query has a min_score floor); keep = ub >= theta, and pruned counts the
// real lanes dropped. Every doc of the true top k survives: its score is at
// most the ub of every block holding one of its postings, and theta is at
// most the true k-th best.
//
// What bounds it on an H100: latency. Per query it reads QB x 16 B of lane
// data and bounds, then 1,024 postings (8 B each) and their norms; the work
// is two 1,024-key bitonic sorts in shared memory and a few block-wide
// reductions, one CTA per query.
//
// Design. One CTA of 1024 threads per query. tmax is a shared-memory
// atomicMax over the f32 bits of non-negative bounds (order-free, hence
// deterministic); thread 0 sums it term by term, the plain version's
// order. The slice is chosen by 8 block-wide argmax rounds over (ordered ub
// bits << 32 | ~lane). The slice's 1,024 (doc, partial, hit) entries sort
// by the unique key (doc << 10 | position), so equal docs keep their
// position order (the reference ravels the slice in that order); each
// doc's first entry sums the next n_terms - 1 entries of the same doc left
// to right (adding +0.0 once where the window leaves the doc, as the
// reference's masked window does); theta is the k-th entry of a descending
// sort of the candidates. Built with --fmad=false: every operation rounds
// like the plain version's.

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

namespace {

constexpr int THREADS = 1024;
constexpr int SLICE = 8;
constexpr int SLOTS = SLICE * 128;
constexpr int POS_BITS = 10;
constexpr int MAX_TERMS = 1024;
constexpr unsigned SENTINEL = 0x7fffffffu;
constexpr float MIN_SCORE_OFF = -1e30f;

__device__ __forceinline__ unsigned ord_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float ord_val(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// In-place bitonic sort of SLOTS unique u64 keys by the whole CTA.
__device__ void bitonic_sort(unsigned long long* a, bool descending) {
  for (int kk = 2; kk <= SLOTS; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      const int i = threadIdx.x;
      const int ixj = i ^ j;
      if (ixj > i) {
        const bool up = ((i & kk) == 0) != descending;
        const unsigned long long x = a[i], y = a[ixj];
        if ((x > y) == up) {
          a[i] = y;
          a[ixj] = x;
        }
      }
      __syncthreads();
    }
  }
}

// Block-wide max of one u64 per thread; every thread gets the result.
__device__ unsigned long long block_max(unsigned long long v,
                                        unsigned long long* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u > v ? u : v;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = red[threadIdx.x];
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long u = __shfl_xor_sync(0xffffffffu, v, o);
      v = u > v ? u : v;
    }
    if (threadIdx.x == 0) red[32] = v;
  }
  __syncthreads();
  v = red[32];
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(THREADS, 1)
blockmax_keep_kernel(const int* __restrict__ ids, const float* __restrict__ w,
                     const int* __restrict__ tid,
                     const float* __restrict__ bscale,
                     const int* __restrict__ row,
                     const float* __restrict__ avgdl,
                     const float* __restrict__ bb,
                     const float* __restrict__ k1v,
                     const int* __restrict__ min_hits,
                     const float* __restrict__ min_score,
                     const float* __restrict__ post_bound,
                     const int* __restrict__ post_docs,
                     const float* __restrict__ post_tf,
                     const int* __restrict__ norms,
                     const float* __restrict__ length_table,
                     const uint8_t* __restrict__ live,
                     const uint8_t* __restrict__ root, int QB, int Dp,
                     int NB, int n_terms, int k, uint8_t* __restrict__ keep,
                     int* __restrict__ pruned, float* __restrict__ ub_g) {
  __shared__ unsigned s_tmax[MAX_TERMS];
  __shared__ unsigned long long s_keys[SLOTS];
  __shared__ float s_part[SLOTS];
  __shared__ unsigned s_doc[SLOTS];
  __shared__ unsigned long long s_red[33];
  __shared__ int s_slice[SLICE];
  __shared__ float s_total;
  __shared__ float s_theta;
  __shared__ int s_pruned;

  const int q = blockIdx.x;
  const int t = threadIdx.x;
  const int* qids = ids + (size_t)q * QB;
  const float* qw = w + (size_t)q * QB;
  const int* qtid = tid + (size_t)q * QB;
  float* ub = ub_g + (size_t)q * QB;
  const float K1 = k1v[q];
  const float K1p1 = K1 + 1.0f;
  const float scale = bscale[q];

  for (int i = t; i < n_terms; i += THREADS) s_tmax[i] = 0u;
  if (t == 0) s_pruned = 0;
  __syncthreads();

  // per-lane self bound and the per-term maxima
  for (int lane = t; lane < QB; lane += THREADS) {
    const int id = qids[lane];
    const bool real = id >= 0;
    float self = 0.0f;
    if (real) {
      const float wl = qw[lane];
      const float w_pos = wl > 0.0f ? wl : 0.0f;
      self = ((w_pos * K1p1) * scale) * post_bound[id < NB ? id : 0];
      if (self > 0.0f) atomicMax(&s_tmax[qtid[lane]], __float_as_uint(self));
    }
    ub[lane] = self;
  }
  __syncthreads();
  if (t == 0) {
    float total = 0.0f;
    for (int i = 0; i < n_terms; ++i) total = total + __uint_as_float(s_tmax[i]);
    s_total = total;
  }
  __syncthreads();
  const float S = s_total;
  for (int lane = t; lane < QB; lane += THREADS) {
    const bool real = qids[lane] >= 0;
    const float tm = __uint_as_float(s_tmax[real ? qtid[lane] : 0]);
    ub[lane] = ub[lane] + (S - tm);
  }
  __syncthreads();

  // the slice: the SLICE lanes of highest ub among the real ones
  for (int r = 0; r < SLICE; ++r) {
    unsigned long long best = 0ull;
    for (int lane = t; lane < QB; lane += THREADS) {
      bool taken = false;
      for (int p = 0; p < r; ++p) taken |= s_slice[p] == lane;
      if (taken) continue;
      const float m = qids[lane] >= 0 ? ub[lane] : -INFINITY;
      const unsigned long long key =
          ((unsigned long long)ord_key(m) << 32) | (0xffffffffu - lane);
      best = key > best ? key : best;
    }
    best = block_max(best, s_red);
    if (t == 0) s_slice[r] = (int)(0xffffffffu - (unsigned)best);
    __syncthreads();
  }

  // exact scores of the slice's postings, keyed (doc << 10 | position)
  {
    const int i = t;  // SLOTS == THREADS
    const int lane = s_slice[i >> 7];
    const int lid = qids[lane];
    const bool s_real = lid >= 0;
    const size_t off = (size_t)(s_real ? lid : 0) * 128 + (i & 127);
    const int doc = post_docs[off];
    const float tf = post_tf[off];
    const bool valid = doc >= 0 && s_real;
    const int safe = valid ? doc : 0;
    const float A = avgdl[q];
    const float B = bb[q];
    const float dl = length_table[norms[(size_t)row[q] * Dp + safe]];
    const float c = (1.0f - B) + (B * dl) / A;
    const float denom = tf + K1 * c;
    const float p = ((qw[lane] * tf) * K1p1) / denom;
    const bool elig0 = valid && live[safe] && root[safe];
    s_keys[i] = ((unsigned long long)(elig0 ? (unsigned)doc : SENTINEL)
                 << POS_BITS) | (unsigned)i;
    s_part[i] = elig0 ? p : 0.0f;
  }
  __syncthreads();
  bitonic_sort(s_keys, false);
  {
    const int i = t;
    const unsigned long long key = s_keys[i];
    s_doc[i] = (unsigned)(key >> POS_BITS);
  }
  __syncthreads();
  float cand;
  {
    const int i = t;
    const unsigned d = s_doc[i];
    const float p0 = s_part[s_keys[i] & (SLOTS - 1)];
    float tot = p0;
    int hits = d < SENTINEL;
    int j = 1;
    for (; j < n_terms; ++j) {
      if (i + j >= SLOTS || s_doc[i + j] != d) break;
      tot = tot + s_part[s_keys[i + j] & (SLOTS - 1)];
      hits += d < SENTINEL;
    }
    if (j < n_terms) tot = tot + 0.0f;
    const bool head = i == 0 || s_doc[i - 1] != d;
    const bool elig = head && d < SENTINEL && hits >= min_hits[q];
    cand = elig ? tot : -INFINITY;
  }
  __syncthreads();
  s_keys[t] = ((unsigned long long)ord_key(cand) << 32) |
              (0xffffffffu - (unsigned)t);
  __syncthreads();
  bitonic_sort(s_keys, true);
  if (t == 0) {
    const int kk = k < SLOTS ? k : SLOTS;
    float theta = ord_val((unsigned)(s_keys[kk - 1] >> 32));
    if (min_score[q] > MIN_SCORE_OFF) theta = -INFINITY;
    s_theta = theta;
  }
  __syncthreads();
  const float theta = s_theta;
  int dropped = 0;
  for (int lane = t; lane < QB; lane += THREADS) {
    const bool kp = ub[lane] >= theta;
    keep[(size_t)q * QB + lane] = kp;
    dropped += (qids[lane] >= 0) && !kp;
  }
  if (dropped) atomicAdd(&s_pruned, dropped);
  __syncthreads();
  if (t == 0) pruned[q] = s_pruned;
}

}  // namespace

extern "C" int blockmax_keep(const int* ids, const float* w, const int* tid,
                             const float* bscale, const int* row,
                             const float* avgdl, const float* b,
                             const float* k1, const int* min_hits,
                             const float* min_score, const float* post_bound,
                             const int* post_docs, const float* post_tf,
                             const int* norms, const float* length_table,
                             const uint8_t* live, const uint8_t* root, int B,
                             int QB, int Dp, int NB, int n_terms, int k,
                             uint8_t* keep, int* pruned, float* scratch,
                             void* stream) {
  if (B <= 0) return 0;
  if (QB < SLICE || n_terms < 1 || n_terms > MAX_TERMS || k < 1 ||
      k > SLOTS)
    return (int)cudaErrorInvalidValue;
  blockmax_keep_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      ids, w, tid, bscale, row, avgdl, b, k1, min_hits, min_score,
      post_bound, post_docs, post_tf, norms, length_table, live, root, QB, Dp,
      NB, n_terms, k, keep, pruned, scratch);
  return (int)cudaGetLastError();
}

extern "C" const char* blockmax_keep_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
