// K8 ivf_probe: the IVF probe of B queries over a list-major packed copy of
// a vector column, in two launches around K3:
// (a) ivf_block_keys: per query and per IVF block, the L2 rank key of the
//     block's centroid c, -(sum_j c_j^2 - 2 * sum_j c_j q_j), f32
//     [B, n_blocks]. K3 (masked_topk) then picks the `budget` best blocks
//     per query with lax.top_k's lowest-index ties (blocks of one centroid
//     tie, and the lowest block id wins);
// (b) ivf_probe: one CTA per (query, chosen block) reads the block's
//     contiguous [256, dims] rows and doc ids, scores every row with K7's
//     arithmetic, and stores the score and a candidate flag at the row's
//     doc: dense f32 [B, Dp] and mask u8 [B, Dp], zero elsewhere.
// Every sum runs in dim order with one rounding per operation, so both
// launches equal the plain PyTorch version (ops/knn.py:
// ivf_knn_scores_plain) bit for bit.
//
// Replaces opensearch_tpu/ops/knn.py:ivf_knn_scores (centroid ranking,
// top-`budget` blocks, block gather, scoring and the scatter-max into a
// zero-filled row).
//
// What bounds it on an H100: bytes. A probe reads budget * 256 * dims * 4
// bytes per query (the chosen blocks, in place: no gathered copy) and
// writes the [B, Dp] score and flag rows; the centroid ranking is tiny.
//
// Design.
// - (a) one thread per (block, query) recomputes its block's centroid
//   norm and dot product (n_blocks * dims operations per query, far below
//   the scoring pass), so no [B, nlist] intermediate is needed.
// - (b) the CTA stages its block's rows through shared memory in chunks of
//   DC dims (row stride DC + 1), one row per thread; the query's |q|^2
//   comes from a one-thread-per-query pass in dim order.
// - The scatter-max of the reference is a plain store: every present doc
//   sits in exactly one block (segment_from_arrays refuses lists that name
//   a doc twice), the chosen blocks of a query are distinct, and every
//   space score is >= 0, the row's fill. Padding slots (id -1) store
//   nothing. No atomics.

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "knn_score.cuh"

namespace {

constexpr int IVF_BLOCK = 256;
constexpr int DC = 32;

__global__ void block_keys_kernel(const float* __restrict__ centroids,
                                  const int* __restrict__ block_centroid,
                                  const float* __restrict__ queries,
                                  int n_blocks, int dims,
                                  float* __restrict__ neg_key) {
  const int blk = blockIdx.x * blockDim.x + threadIdx.x;
  const int q = blockIdx.y;
  if (blk >= n_blocks) return;
  const float* c = centroids + (size_t)block_centroid[blk] * dims;
  const float* x = queries + (size_t)q * dims;
  float cn = 0.0f, dot = 0.0f;
  for (int j = 0; j < dims; ++j) {
    const float v = c[j];
    cn = __fadd_rn(cn, __fmul_rn(v, v));
    dot = __fadd_rn(dot, __fmul_rn(v, x[j]));
  }
  neg_key[(size_t)q * n_blocks + blk] = -__fsub_rn(cn, __fmul_rn(2.0f, dot));
}

__global__ void __launch_bounds__(IVF_BLOCK)
probe_kernel(const float* __restrict__ packed_vecs,
             const int* __restrict__ packed_ids,
             const float* __restrict__ queries,
             const float* __restrict__ qn,
             const float* __restrict__ chosen, int budget, int dims, int Dp,
             int space, float* __restrict__ dense,
             uint8_t* __restrict__ mask) {
  __shared__ float tile[IVF_BLOCK * (DC + 1)];
  __shared__ float qc[DC];
  const int t = threadIdx.x;
  const int s = blockIdx.x, q = blockIdx.y;
  const int blk = __float_as_int(
      chosen[(size_t)q * (2 * budget + 1) + budget + s]);
  const size_t base = (size_t)blk * IVF_BLOCK;
  const float* x = queries + (size_t)q * dims;
  float dot = 0.0f, dn = 0.0f;
  for (int j0 = 0; j0 < dims; j0 += DC) {
    const int dc = min(DC, dims - j0);
    __syncthreads();
    for (int i = t; i < IVF_BLOCK * DC; i += IVF_BLOCK) {
      const int r = i / DC, c = i % DC;
      tile[r * (DC + 1) + c] =
          c < dc ? packed_vecs[(base + r) * dims + j0 + c] : 0.0f;
    }
    if (t < DC) qc[t] = t < dc ? x[j0 + t] : 0.0f;
    __syncthreads();
    const float* row = tile + t * (DC + 1);
    for (int c = 0; c < dc; ++c) {
      const float v = row[c];
      dn = __fadd_rn(dn, __fmul_rn(v, v));
      dot = __fadd_rn(dot, __fmul_rn(v, qc[c]));
    }
  }
  const int id = packed_ids[base + t];
  if (id < 0 || id >= Dp) return;
  const size_t at = (size_t)q * Dp + id;
  dense[at] = space_score(dot, dn, qn[q], space);
  mask[at] = 1;
}

}  // namespace

// centroids: f32 [nlist, dims]; block_centroid: int32 [n_blocks];
// queries: f32 [B, dims]; neg_key: f32 [B, n_blocks].
extern "C" int ivf_block_keys(const float* centroids,
                              const int* block_centroid,
                              const float* queries, int B, int n_blocks,
                              int dims, float* neg_key, void* stream) {
  if (B <= 0 || n_blocks <= 0) return 0;
  if (dims <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((n_blocks + 127) / 128, B);
  block_keys_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      centroids, block_centroid, queries, n_blocks, dims, neg_key);
  return (int)cudaGetLastError();
}

// packed_vecs: f32 [n_blocks * 256, dims]; packed_ids: int32
// [n_blocks * 256]; chosen: K3's f32 [B, 2 * budget + 1] rows over the
// block keys; qn: f32 [B] scratch; dense: f32 [B, Dp]; mask: u8 [B, Dp].
extern "C" int ivf_probe(const float* packed_vecs, const int* packed_ids,
                         const float* queries, const float* chosen, int B,
                         int budget, int dims, int Dp, int space, float* qn,
                         float* dense, uint8_t* mask, void* stream) {
  if (B <= 0 || Dp <= 0) return 0;
  if (dims <= 0 || space < 0 || space > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e =
      cudaMemsetAsync(dense, 0, (size_t)B * Dp * sizeof(float), st);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(mask, 0, (size_t)B * Dp, st);
  if (e != cudaSuccess) return (int)e;
  if (budget <= 0) return 0;
  query_norms<<<(B + 127) / 128, 128, 0, st>>>(queries, B, dims, qn);
  probe_kernel<<<dim3(budget, B), IVF_BLOCK, 0, st>>>(
      packed_vecs, packed_ids, queries, qn, chosen, budget, dims, Dp, space,
      dense, mask);
  return (int)cudaGetLastError();
}

extern "C" const char* ivf_probe_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
