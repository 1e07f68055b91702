// K1 bm25_candidate: the candidate-buffer query phase of B single-text-clause
// queries against one segment, out f32 [B, 2k+1] packed rows
// (k scores | k doc ids as int32 bits | total as int32 bits).
//
// Replaces opensearch_tpu/search/executor.py:build_candidate_query_phase
// (`one`, family bm25_candidate): gather the clause's QB posting blocks,
// the BM25 partial per lane, a stable sort of (doc, partial, hit) by doc, an
// exact backward windowed run-sum over <= n_terms lanes, min_hits / live /
// root / min_score eligibility with the total, and the top-k over the buffer.
//
// What bounds it on an H100: per query it reads QB x 128 x 8 B of postings
// plus a norm per posting, which is little; the work is the in-CTA sorting
// (two bitonic sorts of n = QB x 128 <= 16384 keys, n log^2 n / 4
// compare-exchanges each in shared memory) and one CTA per query, so at
// small B most SMs idle. Latency-bound on shared-memory passes.
//
// Design. One CTA of 1024 threads per query. The whole buffer lives in
// dynamic shared memory: u64 sort keys (doc << 14 | lane) and the f32
// partial by lane, 12 B x 16384 = 192 KB of the 227 KB a block may use.
// Putting the lane in the key makes every key unique, so the bitonic sort
// is stable by construction: a doc's lanes stay in lane order and the run
// total at the run's end is p[end] + p[end-1] + ... + p[end-m+1], added left
// to right like the reference (never a cumsum difference). The top-k sorts
// the buffer again on (ordered score bits << 32 | ~lane): score descending,
// ties to the lowest lane (= lowest doc), -inf lanes in lane order, the
// order of lax.top_k. Padding lanes gather row 0 and are masked; a padding
// lane keeps doc 2^30 as its key, as in the reference. Built with
// --fmad=false, so the partial rounds exactly like the plain version.

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

namespace {

constexpr int THREADS = 1024;
constexpr int MAX_LANES = 16384;
constexpr int PER_THREAD = MAX_LANES / THREADS;
constexpr unsigned PAD_DOC = 1u << 30;
constexpr int LANE_BITS = 14;

__device__ __forceinline__ unsigned ord_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float ord_val(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// In-place bitonic sort of n (a power of two) unique u64 keys.
__device__ void bitonic_sort(unsigned long long* a, int n, bool descending) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const bool up = ((i & k) == 0) != descending;
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
}

__global__ void __launch_bounds__(THREADS, 1)
bm25_candidate_kernel(const int* __restrict__ ids, const float* __restrict__ w,
                      const int* __restrict__ row,
                      const float* __restrict__ avgdl,
                      const float* __restrict__ bb,
                      const float* __restrict__ k1v,
                      const int* __restrict__ min_hits,
                      const float* __restrict__ boost,
                      const float* __restrict__ min_score,
                      const int* __restrict__ post_docs,
                      const float* __restrict__ post_tf,
                      const int* __restrict__ norms,
                      const float* __restrict__ length_table,
                      const uint8_t* __restrict__ live,
                      const uint8_t* __restrict__ root, int QB, int Dp,
                      int n_terms, int constant, int k,
                      float* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  __shared__ int s_total;
  const int n = QB * 128;
  unsigned long long* keys = smem;                 // [n]
  float* part = reinterpret_cast<float*>(smem + n);  // [n], by lane
  int* docs = reinterpret_cast<int*>(part);          // reused after phase 2

  const int q = blockIdx.x;
  const int t = threadIdx.x;
  const float A = avgdl[q];
  const float B = bb[q];
  const float K1 = k1v[q];
  const float K1p1 = K1 + 1.0f;
  const int* nrow = norms + (size_t)row[q] * Dp;
  const int* qids = ids + (size_t)q * QB;
  const float* qw = w + (size_t)q * QB;
  if (t == 0) s_total = 0;

  // phase 1: gather and partials; key = (doc or PAD_DOC) << 14 | lane
  for (int lane = t; lane < n; lane += THREADS) {
    const int blk = lane >> 7;
    const int id = qids[blk];
    const bool lane_real = id >= 0;
    const size_t off = (size_t)(lane_real ? id : 0) * 128 + (lane & 127);
    const int doc = post_docs[off];
    const float tf = post_tf[off];
    const bool valid = doc >= 0;
    const float dl = length_table[nrow[valid ? doc : 0]];
    const float c = (1.0f - B) + (B * dl) / A;
    const float denom = tf + K1 * c;
    const float p = ((qw[blk] * tf) * K1p1) / denom;
    const bool real = valid && lane_real;
    keys[lane] = ((unsigned long long)(real ? (unsigned)doc : PAD_DOC)
                  << LANE_BITS) | (unsigned)lane;
    part[lane] = real ? p : 0.0f;
  }
  __syncthreads();
  bitonic_sort(keys, n, false);

  // phase 2: exact windowed run-sum, eligibility and total at run ends
  const int mh = min_hits[q];
  const float bst = boost[q];
  const float msc = min_score[q];
  float ms[PER_THREAD];
  int md[PER_THREAD];
  int cnt = 0;
#pragma unroll
  for (int r = 0; r < PER_THREAD; ++r) {
    const int i = t + r * THREADS;
    ms[r] = -INFINITY;
    md[r] = 0;
    if (i < n) {
      const unsigned long long key = keys[i];
      const unsigned doc = (unsigned)(key >> LANE_BITS);
      const int hit = doc != PAD_DOC;
      float run = part[key & (MAX_LANES - 1)];
      int h = hit;
      for (int j = 1; j < n_terms && i - j >= 0; ++j) {
        const unsigned long long kp = keys[i - j];
        if ((unsigned)(kp >> LANE_BITS) != doc) break;
        run = run + part[kp & (MAX_LANES - 1)];
        h += hit;
      }
      const bool is_end =
          i == n - 1 || (unsigned)(keys[i + 1] >> LANE_BITS) != doc;
      const float score = constant ? bst : run;
      const bool elig = is_end && doc < PAD_DOC && h >= mh && live[doc] &&
                        root[doc] && score >= msc;
      ms[r] = elig ? score : -INFINITY;
      md[r] = (int)doc;
      cnt += elig;
    }
  }
  if (cnt) atomicAdd(&s_total, cnt);
  __syncthreads();

  // phase 3: top-k over the buffer, key = ordered score << 32 | ~position
#pragma unroll
  for (int r = 0; r < PER_THREAD; ++r) {
    const int i = t + r * THREADS;
    if (i < n) {
      keys[i] = ((unsigned long long)ord_key(ms[r]) << 32) |
                (0xffffffffu - (unsigned)i);
      docs[i] = md[r];
    }
  }
  __syncthreads();
  bitonic_sort(keys, n, true);

  float* o = out + (size_t)q * (2 * k + 1);
  const int k_eff = min(k, n);
  for (int r = t; r < k; r += THREADS) {
    if (r < k_eff) {
      const unsigned long long key = keys[r];
      o[r] = ord_val((unsigned)(key >> 32));
      o[k + r] = __int_as_float(docs[0xffffffffu - (unsigned)key]);
    } else {
      o[r] = -INFINITY;
      o[k + r] = __int_as_float(0);
    }
  }
  if (t == 0) o[2 * k] = __int_as_float(s_total);
}

}  // namespace

extern "C" int bm25_candidate(const int* ids, const float* w, const int* row,
                              const float* avgdl, const float* b,
                              const float* k1, const int* min_hits,
                              const float* boost, const float* min_score,
                              const int* post_docs, const float* post_tf,
                              const int* norms, const float* length_table,
                              const uint8_t* live, const uint8_t* root, int B,
                              int QB, int Dp, int n_terms, int constant, int k,
                              float* out, void* stream) {
  const int n = QB * 128;
  if (B <= 0) return 0;
  if (n > MAX_LANES || (n & (n - 1)) != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n * (sizeof(unsigned long long) + sizeof(float));
  // the shared-memory opt-in is per device function: set it once
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        bm25_candidate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(MAX_LANES * (sizeof(unsigned long long) + sizeof(float))));
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  bm25_candidate_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      ids, w, row, avgdl, b, k1, min_hits, boost, min_score, post_docs,
      post_tf, norms, length_table, live, root, QB, Dp, n_terms, constant, k,
      out);
  return (int)cudaGetLastError();
}

extern "C" const char* bm25_candidate_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
