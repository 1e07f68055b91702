// K2 score_text_clause: one BM25 text clause of B queries scored into dense
// per-doc vectors, scores f32 [B, Dp] and hit counts i32 [B, Dp].
//
// Replaces opensearch_tpu/ops/bm25.py:score_text_clause (a gather of the
// clause's [QB, 128] posting blocks, the BM25 partial per lane, and a
// scatter-add into [Dp]); with K20's keep mask [B, QB] (`block_keep`) a
// dropped lane adds nothing.
//
// What bounds it on an H100: bytes. Per query it reads its posting blocks
// (128 x (4 B doc + 4 B tf)) and one norm per posting, and writes the dense
// [Dp] scores and hits (8 B per doc); the arithmetic is a handful of flops
// per posting. At Dp = 2^20 the 8 MB a query of dense writes dominates.
//
// Order. The reference adds a doc's partials in lane order starting from
// zero (XLA's scatter-add); float atomics would add them in no fixed
// order. So each CTA owns CHUNK docs of one query, keeps their sums in
// shared memory and "pulls" the blocks that reach them in ascending lane
// j. One term lists a doc at most once, so the 128 lanes of one block hit
// distinct docs: a plain += is race-free within a block, and a barrier
// between blocks keeps every doc's additions in lane order. Scores are bit
// for bit the plain version's (built with --fmad=false, IEEE division)
// and identical from run to run.
//
// Design (two launches and a memset).
// 1. bucket_kernel, one warp per lane (q, j) that is real and kept: reads
//    the block's 128 docs once, takes the least and greatest doc in
//    [0, Dp), and sets bit j in the bitmap of every chunk between them:
//    bits u32 [B, nch, W], W = ceil(QB / 32). A chunk's set bits, read in
//    word order, are its blocks in ascending j: the order the sums need,
//    with no count, scan or sort. (Its scratch is B * nch * W * 4 bytes,
//    QB / (64 * CHUNK) of the dense output: 512 KiB at B=32, QB=1024,
//    Dp=2^20, CHUNK=8,192.) The first version let every CTA scan all QB
//    lanes and load each block's first and last doc: twice the output's
//    bytes in L2 sectors, and each round a chain of dependent loads.
// 2. clause_score_kernel, one CTA per (chunk, query): warp 0 expands the
//    chunk's bitmap into a list in shared memory (32 words, up to 1,024
//    blocks, at a time); then SLOTS listed blocks at a time are gathered
//    by all THREADS threads (PER lanes a thread, every load of the stage
//    issued before the first is used: id, doc, then tf and norm, then the
//    length table), and the staged (chunk offset, partial) pairs are
//    added to the chunk's sums in list order, one barrier per block, by
//    the block's 128 lanes; between barriers only shared memory is
//    touched. Scores and hits leave with 16-byte stores where the rows
//    allow them.
// A CTA owns CHUNK = 2^13 docs with 512 threads (84 KiB of shared memory,
// two CTAs an SM). A throwaway probe on an H100 timed 2^11 / 2^12 docs
// with 256 threads beside it: 2^13 was the fastest at B=32 (a larger chunk
// lists a block on fewer chunks, so fewer of its lanes are loaded for
// nothing) and within a microsecond of the others at B=1 (PERF.md).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int LANES = 128;          // posting block width
constexpr int BUCKET_THREADS = 256;  // 8 warps, one lane (q, j) each
constexpr int LIST_WORDS = 32;      // bitmap words expanded at a time
constexpr int SLOTS = 16;           // blocks gathered per stage
constexpr int CHUNK_LOG = 13;       // docs a scorer CTA owns: 2^13
constexpr int CHUNK = 1 << CHUNK_LOG;
constexpr int THREADS = 512;        // the scorer's CTA

// the scorer's shared memory: the chunk's sums and hits, the staged
// (offset, partial) pairs, the list
constexpr size_t SCORE_SMEM = (size_t)8 * CHUNK + (size_t)SLOTS * LANES * 8
                               + (size_t)LIST_WORDS * 32 * 4;

__global__ void __launch_bounds__(BUCKET_THREADS)
bucket_kernel(const int* __restrict__ ids, const uint8_t* __restrict__ keep,
              const int* __restrict__ post_docs, long long lanes, int QB,
              int Dp, int NB, int nch, int W,
              uint32_t* __restrict__ bits) {
  const long long g = ((long long)blockIdx.x * BUCKET_THREADS + threadIdx.x)
                      >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= lanes) return;              // uniform across the warp
  const int id = ids[g];
  if (id < 0 || id >= NB || (keep != nullptr && !keep[g])) return;
  const int* pd = post_docs + (size_t)id * LANES;
  int lo = INT_MAX, hi = -1;
#pragma unroll
  for (int k = 0; k < LANES / 32; ++k) {
    const int d = pd[lane + 32 * k];
    if (d >= 0 && d < Dp) {
      lo = min(lo, d);
      hi = max(hi, d);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (hi < 0) return;
  const int q = (int)(g / QB);
  const int j = (int)(g - (long long)q * QB);
  uint32_t* word = bits + (size_t)q * nch * W + (j >> 5);
  const uint32_t bit = 1u << (j & 31);
  for (int c = (lo >> CHUNK_LOG) + lane; c <= (hi >> CHUNK_LOG); c += 32)
    atomicOr(word + (size_t)c * W, bit);
}

__global__ void __launch_bounds__(THREADS)
clause_score_kernel(const uint32_t* __restrict__ bits,
                    const int* __restrict__ ids, const float* __restrict__ w,
                    const int* __restrict__ row,
                    const float* __restrict__ avgdl,
                    const float* __restrict__ bb,
                    const float* __restrict__ k1v,
                    const int* __restrict__ post_docs,
                    const float* __restrict__ post_tf,
                    const int* __restrict__ norms,
                    const float* __restrict__ length_table, int QB, int Dp,
                    int nch, int W, float* __restrict__ scores,
                    int* __restrict__ hits) {
  constexpr int PER = SLOTS * LANES / THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_score = reinterpret_cast<float*>(smem);
  int* s_hits = reinterpret_cast<int*>(s_score + CHUNK);
  int* s_off = s_hits + CHUNK;                      // [SLOTS][128], -1: none
  float* s_part = reinterpret_cast<float*>(s_off + SLOTS * LANES);
  int* s_list = reinterpret_cast<int*>(s_part + SLOTS * LANES);
  __shared__ int s_n;

  const int c = blockIdx.x;
  const int q = blockIdx.y;
  const int t = threadIdx.x;
  const int d0 = c << CHUNK_LOG;
  const int d1 = min(d0 + CHUNK, Dp);
  for (int i = t; i < CHUNK / 4; i += THREADS) {
    reinterpret_cast<float4*>(s_score)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    reinterpret_cast<int4*>(s_hits)[i] = make_int4(0, 0, 0, 0);
  }
  const float A = avgdl[q];
  const float B = bb[q];
  const float K1 = k1v[q];
  const float K1p1 = K1 + 1.0f;
  const int* nrow = norms + (size_t)row[q] * Dp;
  const int* qids = ids + (size_t)q * QB;
  const float* qw = w + (size_t)q * QB;
  const uint32_t* brow = bits + ((size_t)q * nch + c) * W;

  for (int w0 = 0; w0 < W; w0 += LIST_WORDS) {
    __syncthreads();  // the zeroing is done, the last list consumed
    if (t < 32) {
      uint32_t word = w0 + t < W ? brow[w0 + t] : 0u;
      const int cnt = __popc(word);
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (t >= o) incl += v;
      }
      int pos = incl - cnt;
      while (word) {
        s_list[pos++] = ((w0 + t) << 5) + __ffs(word) - 1;
        word &= word - 1;
      }
      if (t == 31) s_n = incl;
    }
    __syncthreads();
    const int n = s_n;
    for (int base = 0; base < n; base += SLOTS) {
      const int ns = min(SLOTS, n - base);
      int doc[PER];
      float wj[PER];
      size_t at[PER];  // the lane's posting: block id * 128 + lane
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int p = t + i * THREADS;
        const int slot = p >> 7;
        doc[i] = -1;
        wj[i] = 0.0f;
        at[i] = 0;
        if (slot < ns) {
          const int j = s_list[base + slot];
          at[i] = (size_t)qids[j] * LANES + (p & (LANES - 1));
          doc[i] = post_docs[at[i]];
          wj[i] = qw[j];
        }
      }
      float tf[PER];
      int nb[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        tf[i] = 0.0f;
        nb[i] = 0;
        if (doc[i] >= d0 && doc[i] < d1) {
          tf[i] = post_tf[at[i]];
          nb[i] = nrow[doc[i]];
        } else {
          doc[i] = -1;
        }
      }
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int p = t + i * THREADS;
        float part = 0.0f;
        if (doc[i] >= 0) {
          const float dl = length_table[nb[i]];
          const float cc = (1.0f - B) + (B * dl) / A;
          const float denom = tf[i] + K1 * cc;
          part = ((wj[i] * tf[i]) * K1p1) / denom;
        }
        s_off[p] = doc[i] >= 0 ? doc[i] - d0 : -1;
        s_part[p] = part;
      }
      __syncthreads();
      for (int s = 0; s < ns; ++s) {  // list order: ascending j
        if (t < LANES) {
          const int off = s_off[s * LANES + t];
          if (off >= 0) {
            s_score[off] += s_part[s * LANES + t];
            s_hits[off] += 1;
          }
        }
        __syncthreads();  // the next block may hit the same docs
      }
    }
  }
  __syncthreads();
  float* qs = scores + (size_t)q * Dp + d0;
  int* qh = hits + (size_t)q * Dp + d0;
  const int nd = d1 - d0;
  const bool vec = (nd & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(qs) |
                     reinterpret_cast<uintptr_t>(qh)) & 15) == 0;
  if (vec) {
    for (int i = t; i < nd / 4; i += THREADS) {
      reinterpret_cast<float4*>(qs)[i] =
          reinterpret_cast<const float4*>(s_score)[i];
      reinterpret_cast<int4*>(qh)[i] = reinterpret_cast<const int4*>(s_hits)[i];
    }
  } else {
    for (int i = t; i < nd; i += THREADS) {
      qs[i] = s_score[i];
      qh[i] = s_hits[i];
    }
  }
}

}  // namespace

// keep: u8 [B, QB] (K20's mask) or null; bits: u32 scratch of
// B * ceil(Dp / 2^13) * ceil(QB / 32) words (ops/bm25.py:
// text_clause_scratch_words), bits_words its size, checked here.
extern "C" int score_text_clause(const int* ids, const uint8_t* keep,
                                 const float* w,
                                 const int* row, const float* avgdl,
                                 const float* b, const float* k1,
                                 const int* post_docs, const float* post_tf,
                                 const int* norms, const float* length_table,
                                 int B, int QB, int Dp, int NB,
                                 float* scores, int* hits, uint32_t* bits,
                                 long long bits_words, void* stream) {
  if (B <= 0 || Dp <= 0) return 0;
  if (B > 65535 || QB < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nch = (int)(((long long)Dp + CHUNK - 1) >> CHUNK_LOG);
  const int W = QB > 0 ? (QB + 31) / 32 : 0;
  if (bits_words < (long long)B * nch * W) return (int)cudaErrorInvalidValue;
  if (W > 0) {
    cudaError_t e = cudaMemsetAsync(
        bits, 0, (size_t)B * nch * W * sizeof(uint32_t), s);
    if (e != cudaSuccess) return (int)e;
    const long long lanes = (long long)B * QB;
    const long long ctas = (lanes * 32 + BUCKET_THREADS - 1) / BUCKET_THREADS;
    bucket_kernel<<<(unsigned)ctas, BUCKET_THREADS, 0, s>>>(
        ids, keep, post_docs, lanes, QB, Dp, NB, nch, W, bits);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        clause_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SCORE_SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  clause_score_kernel<<<dim3(nch, B), THREADS, SCORE_SMEM, s>>>(
      bits, ids, w, row, avgdl, b, k1, post_docs, post_tf, norms,
      length_table, QB, Dp, nch, W, scores, hits);
  return (int)cudaGetLastError();
}

extern "C" const char* score_text_clause_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
