// K7 knn_exact: the exact k-NN scan. Per doc row v of a [Dp, dims] f32
// vector column and per query q of a [B, dims] batch, the raw similarity
// of the doc in the field's space and its k-NN plugin score, out f32
// [B, Dp]:
//   l2:           raw = -((|v|^2 - 2 v.q) + |q|^2), score = 1 / (1 + max(-raw, 0))
//   cosinesimil:  raw = v.q / max(sqrt|v|^2 * sqrt|q|^2, 1e-30),
//                 score = (1 + clip(raw, -1, 1)) / 2
//   innerproduct: raw = v.q, score = raw + 1 if raw >= 0 else 1 / (1 - raw)
// Every sum runs in dim order, one rounding per multiply and per add
// (__fmul_rn / __fadd_rn), so the kernel equals its plain PyTorch version
// (ops/knn.py:exact_knn_scores_plain) bit for bit.
//
// Replaces opensearch_tpu/ops/knn.py:raw_similarity, space_score and
// exact_knn_scores (the exact branch of the `knn` plan in
// opensearch_tpu/search/plan_eval.py).
//
// A second entry, knn_topk_mark, turns K3's packed top-k rows into the
// `knn` node's matches and scores (opensearch_tpu/ops/knn.py:
// knn_match_topk after its lax.top_k): the k winners of each row keep their
// score and match, every other doc gets 0 / false.
//
// What bounds it on an H100: at B = 32 and 128 dims, the B * Dp * dims
// multiply-adds (two f32 operations each, no FMA) and the bytes of the
// column (read once per 32 queries) are of the same order.
//
// Design.
// - One CTA owns ROWS = 128 doc rows, one per thread, and up to NQ
//   queries (NQ = 1, 8 or 32 by batch size; grid.y walks query chunks).
// - The dims run in chunks of DC = 32: the CTA stages its rows' chunk in
//   shared memory with coalesced loads (row stride DC + 1: no bank
//   conflicts when each thread walks its own row) and the queries' chunk
//   transposed ([dim][query]), so one 128-bit broadcast load feeds four
//   queries. Each thread keeps NQ dot products and |v|^2 in registers and
//   reads every element of its row once per query chunk.
// - |q|^2 per query comes from a one-thread-per-query pass, in dim order.
// - The scores are written row-major per query: consecutive threads write
//   consecutive docs.
// - knn_topk_mark zeroes the outputs, then one thread per (query, slot)
//   with a finite score stores the doc's score and a 1; the winners of a
//   row are distinct docs, so no two stores meet.

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "knn_score.cuh"

namespace {

constexpr int ROWS = 128;
constexpr int DC = 32;

template <int NQ>
__global__ void __launch_bounds__(ROWS)
knn_exact_kernel(const float* __restrict__ vectors,
                 const float* __restrict__ queries,
                 const float* __restrict__ qn, int B, int Dp, int dims,
                 int space, float* __restrict__ out) {
  __shared__ float tile[ROWS * (DC + 1)];
  __shared__ __align__(16) float qt[DC * NQ];
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * ROWS;
  const int q0 = blockIdx.y * NQ;
  const int nq = min(NQ, B - q0);
  float dots[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) dots[q] = 0.0f;
  float dn = 0.0f;
  for (int j0 = 0; j0 < dims; j0 += DC) {
    const int dc = min(DC, dims - j0);
    __syncthreads();
    for (int i = t; i < ROWS * DC; i += ROWS) {
      const int r = i / DC, c = i % DC;
      tile[r * (DC + 1) + c] =
          (c < dc && r0 + r < Dp)
              ? vectors[(size_t)(r0 + r) * dims + j0 + c] : 0.0f;
    }
    for (int i = t; i < NQ * DC; i += ROWS) {
      const int c = i / NQ, q = i % NQ;
      qt[c * NQ + q] = (c < dc && q < nq)
                           ? queries[(size_t)(q0 + q) * dims + j0 + c]
                           : 0.0f;
    }
    __syncthreads();
    const float* row = tile + t * (DC + 1);
    for (int c = 0; c < dc; ++c) {
      const float v = row[c];
      dn = __fadd_rn(dn, __fmul_rn(v, v));
      if constexpr (NQ % 4 == 0) {
        const float4* q4 = reinterpret_cast<const float4*>(qt + c * NQ);
#pragma unroll
        for (int g = 0; g < NQ / 4; ++g) {
          const float4 x = q4[g];
          dots[4 * g] = __fadd_rn(dots[4 * g], __fmul_rn(v, x.x));
          dots[4 * g + 1] = __fadd_rn(dots[4 * g + 1], __fmul_rn(v, x.y));
          dots[4 * g + 2] = __fadd_rn(dots[4 * g + 2], __fmul_rn(v, x.z));
          dots[4 * g + 3] = __fadd_rn(dots[4 * g + 3], __fmul_rn(v, x.w));
        }
      } else {
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          dots[q] = __fadd_rn(dots[q], __fmul_rn(v, qt[c * NQ + q]));
      }
    }
  }
  const int d = r0 + t;
  if (d >= Dp) return;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    if (q < nq)
      out[(size_t)(q0 + q) * Dp + d] =
          space_score(dots[q], dn, qn[q0 + q], space);
  }
}

template <int NQ>
int launch(const float* vectors, const float* queries, const float* qn,
           int B, int Dp, int dims, int space, float* out, cudaStream_t s) {
  const dim3 grid((Dp + ROWS - 1) / ROWS, (B + NQ - 1) / NQ);
  knn_exact_kernel<NQ><<<grid, ROWS, 0, s>>>(vectors, queries, qn, B, Dp,
                                             dims, space, out);
  return (int)cudaGetLastError();
}

__global__ void mark_kernel(const float* __restrict__ packed,
                            const float* __restrict__ scores, int B, int k,
                            int Dp, float* __restrict__ out,
                            uint8_t* __restrict__ matches) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * k) return;
  const int b = i / k, j = i % k;
  const float* row = packed + (size_t)b * (2 * k + 1);
  if (!(row[j] > -INFINITY)) return;
  const int d = __float_as_int(row[k + j]);
  if (d < 0 || d >= Dp) return;
  const size_t at = (size_t)b * Dp + d;
  matches[at] = 1;
  out[at] = scores[at];
}

}  // namespace

// vectors: f32 [Dp, dims]; queries: f32 [B, dims]; space: 0 l2,
// 1 cosinesimil, 2 innerproduct; qn: f32 [B] scratch; out: f32 [B, Dp].
extern "C" int knn_exact(const float* vectors, const float* queries, int B,
                         int Dp, int dims, int space, float* qn, float* out,
                         void* stream) {
  if (B <= 0 || Dp <= 0) return 0;
  if (dims <= 0 || space < 0 || space > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  query_norms<<<(B + 127) / 128, 128, 0, s>>>(queries, B, dims, qn);
  if (B == 1) return launch<1>(vectors, queries, qn, B, Dp, dims, space, out, s);
  if (B <= 8) return launch<8>(vectors, queries, qn, B, Dp, dims, space, out, s);
  return launch<32>(vectors, queries, qn, B, Dp, dims, space, out, s);
}

// packed: f32 [B, 2k+1] rows of K3 (k scores | k doc ids as int32 bits |
// total); scores: f32 [B, Dp]; out: f32 [B, Dp]; matches: u8 [B, Dp].
extern "C" int knn_topk_mark(const float* packed, const float* scores, int B,
                             int k, int Dp, float* out, uint8_t* matches,
                             void* stream) {
  if (B <= 0 || Dp <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)B * Dp * sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(matches, 0, (size_t)B * Dp, s);
  if (e != cudaSuccess) return (int)e;
  if (k <= 0) return 0;
  mark_kernel<<<(B * k + 255) / 256, 256, 0, s>>>(packed, scores, B, k, Dp,
                                                  out, matches);
  return (int)cudaGetLastError();
}

extern "C" const char* knn_exact_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
