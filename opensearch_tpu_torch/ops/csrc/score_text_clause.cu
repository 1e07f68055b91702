// K2 score_text_clause: one BM25 text clause of B queries scored into dense
// per-doc vectors, scores f32 [B, Dp] and hit counts i32 [B, Dp].
//
// Replaces opensearch_tpu/ops/bm25.py:score_text_clause (a gather of the
// clause's [QB, 128] posting blocks, the BM25 partial per lane, and a
// scatter-add into [Dp]); with K20's keep mask [B, QB] (`block_keep`) a
// dropped lane adds nothing.
//
// What bounds it on an H100: bytes. Per query it reads QB posting blocks
// (128 x (4 B doc + 4 B tf)), one norm byte-as-int per posting and writes
// the dense [Dp] scores and hits (8 B per doc); the arithmetic is a handful
// of flops per posting. For a head-term query at Dp = 2^20 the 8 MB dense
// write dominates.
//
// Design. The reference adds a doc's partials in lane order starting from
// zero (XLA's scatter-add); float atomics would add them in no fixed order.
// So this kernel "pulls": each CTA owns CHUNK docs of one query and keeps
// their scores and hits in shared memory. It walks the clause's blocks in
// lane order, skips a block whose doc range [first, last] misses its
// chunk, and lets its 128 threads add the block's 128 lanes at once. One
// term lists a doc at most once, so the lanes of one block hit distinct
// docs: a plain += is race-free, and a barrier between blocks keeps every
// doc's additions in lane order. Scores are bit-for-bit the reference's
// (built with --fmad=false, IEEE division) and identical from run to run.
// Each CTA reads every block's first and last doc (2 x 4 B of L2 traffic
// per block per CTA) to decide which blocks to walk.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int LANES = 128;   // posting block width = threads per CTA
constexpr int CHUNK = 4096;  // docs owned by one CTA (32 KB of shared)

__global__ void __launch_bounds__(LANES)
score_text_clause_kernel(const int* __restrict__ ids,
                         const uint8_t* __restrict__ keep,
                         const float* __restrict__ w,
                         const int* __restrict__ row,
                         const float* __restrict__ avgdl,
                         const float* __restrict__ bb,
                         const float* __restrict__ k1v,
                         const int* __restrict__ post_docs,
                         const float* __restrict__ post_tf,
                         const int* __restrict__ norms,
                         const float* __restrict__ length_table,
                         int QB, int Dp, int NB,
                         float* __restrict__ scores,
                         int* __restrict__ hits) {
  __shared__ float s_score[CHUNK];
  __shared__ int s_hits[CHUNK];
  __shared__ int s_blk[LANES];
  __shared__ float s_w[LANES];
  __shared__ int s_take[LANES];

  const int q = blockIdx.y;
  const int t = threadIdx.x;
  const int d0 = blockIdx.x * CHUNK;
  const int d1 = min(d0 + CHUNK, Dp);
  for (int i = t; i < CHUNK; i += LANES) {
    s_score[i] = 0.0f;
    s_hits[i] = 0;
  }
  const float A = avgdl[q];
  const float B = bb[q];
  const float K1 = k1v[q];
  const float K1p1 = K1 + 1.0f;
  const int* nrow = norms + (size_t)row[q] * Dp;
  const int* qids = ids + (size_t)q * QB;
  const float* qw = w + (size_t)q * QB;

  for (int j0 = 0; j0 < QB; j0 += LANES) {
    __syncthreads();  // the previous group's s_blk / s_w are consumed
    const int j = j0 + t;
    int id = -1;
    int take = 0;
    float wj = 0.0f;
    if (j < QB) {
      id = qids[j];
      wj = qw[j];
      if (id >= 0 && id < NB &&
          (keep == nullptr || keep[(size_t)q * QB + j])) {
        const int* pd = post_docs + (size_t)id * LANES;
        const int first = pd[0];
        int last = pd[LANES - 1];
        if (last < 0) last = INT_MAX;  // a term's partly filled last block
        take = first >= 0 && first < d1 && last >= d0;
      }
    }
    s_blk[t] = id;
    s_w[t] = wj;
    s_take[t] = take;
    __syncthreads();
    const int nj = min(LANES, QB - j0);
    for (int jj = 0; jj < nj; ++jj) {
      if (!s_take[jj]) continue;  // uniform across the CTA
      const size_t off = (size_t)s_blk[jj] * LANES + t;
      const int doc = post_docs[off];
      if (doc >= d0 && doc < d1) {
        const float tf = post_tf[off];
        const float dl = length_table[nrow[doc]];
        const float c = (1.0f - B) + (B * dl) / A;
        const float denom = tf + K1 * c;
        const float p = ((s_w[jj] * tf) * K1p1) / denom;
        s_score[doc - d0] += p;
        s_hits[doc - d0] += 1;
      }
      __syncthreads();  // the next block may hit the same docs
    }
  }
  __syncthreads();
  float* qs = scores + (size_t)q * Dp;
  int* qh = hits + (size_t)q * Dp;
  for (int i = d0 + t; i < d1; i += LANES) {
    qs[i] = s_score[i - d0];
    qh[i] = s_hits[i - d0];
  }
}

}  // namespace

// keep: u8 [B, QB] (K20's mask) or null.
extern "C" int score_text_clause(const int* ids, const uint8_t* keep,
                                 const float* w,
                                 const int* row, const float* avgdl,
                                 const float* b, const float* k1,
                                 const int* post_docs, const float* post_tf,
                                 const int* norms, const float* length_table,
                                 int B, int QB, int Dp, int NB, float* scores,
                                 int* hits, void* stream) {
  if (B <= 0 || Dp <= 0) return 0;
  dim3 grid((Dp + CHUNK - 1) / CHUNK, B);
  score_text_clause_kernel<<<grid, LANES, 0, (cudaStream_t)stream>>>(
      ids, keep, w, row, avgdl, b, k1, post_docs, post_tf, norms,
      length_table, QB,
      Dp, NB, scores, hits);
  return (int)cudaGetLastError();
}

extern "C" const char* score_text_clause_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
