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
// What bounds it on an H100: at B = 32 and 128 dims, operations. The
// bit-equality contract rounds every multiply and every add (no FMA), so
// the scan is 2 B Dp dims separate FP32 instructions, 8.6 G at B = 32 and
// Dp = 2^20: about 0.26 ms at 132 SMs x 128 FP32 lanes and 1.98 GHz, above
// the 0.20 ms of the column's bytes. At B = 1 the column's bytes bound it
// (0.16 ms at 2^20 x 128).
//
// Design.
// - A CTA of 256 threads walks tiles of ROWS = 256 doc rows (a persistent
//   grid: about SMs x resident CTAs a query tile) for a tile of NQ = 32, 8
//   or 1 queries (grid.y). The entry runs B's whole 32-query tiles, then
//   the rest with the smallest tile that holds it.
// - Register micro-tile: a thread owns TR rows x TQ queries of dot
//   products (4 x 8 at NQ = 32, 1 x 8 at NQ = 8, 1 x 1 at NQ = 1). A warp's
//   lanes take consecutive rows (a thread's rows 64 apart at NQ = 32), so
//   their 16-byte shared reads meet no bank conflict and their stores
//   coalesce.
// - The dims run in chunks of DC = 32 (128 bytes of a row) through a
//   2-stage ring in shared memory filled by cp.async: 16-byte copies where
//   dims % 4 == 0 and the column is 16-byte aligned, 4-byte copies
//   otherwise. The next chunk's copy overlaps this chunk's math; one
//   __syncthreads a chunk orders the ring (chunk n has landed, and every
//   thread is done with chunk n - 1, whose stage the next copy takes). A
//   stage holds the rows' chunk (row stride DC + 4: conflict-free 16-byte
//   reads) and the queries' chunk, laid out [dim][query] by a staging
//   launch (stage_queries), so one broadcast 16-byte read feeds four
//   queries. (On the H100, 16-dim chunks, 3- and 4-stage rings, 128- and
//   512-thread CTAs and 8 x 8 or 4 x 4 register tiles were each slower.)
// - |v|^2 once a row: each of a CTA's G = TR query groups sums it for one
//   of its TR rows (its row 0, after a rotation of the rows) and hands it
//   over in shared memory at the tile's end.
// - Every dot and |v|^2 sums in dim order from 0 with __fmul_rn /
//   __fadd_rn, |q|^2 comes from knn_score.cuh's query_norms and the score
//   from its space_score (shared with K8): the output equals
//   exact_knn_scores_plain bit for bit.
// - knn_topk_mark zeroes the outputs, then one thread per (query, slot)
//   with a finite score stores the doc's score and a 1; the winners of a
//   row are distinct docs, so no two stores meet.

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "cp_async.cuh"
#include "knn_score.cuh"

namespace {

constexpr int ROWS = 256;       // doc rows of a tile, and a CTA's threads
constexpr int DC = 32;          // dims of a chunk: 128 bytes of a row
constexpr int STRIDE = DC + 4;  // floats between staged rows
constexpr int STAGES = 2;       // the ring's stages

// a tile's shape: NQ queries, TQ of them a thread, TR rows a thread
template <int NQ_, int TQ_, int TR_>
struct Tile {
  static constexpr int NQ = NQ_, TQ = TQ_, TR = TR_;
  static constexpr int G = NQ / TQ;        // query groups
  static constexpr int RTH = ROWS / TR;    // a group's threads
  static constexpr int STAGE = ROWS * STRIDE + DC * NQ;  // floats a stage
  static constexpr int SMEM = (STAGES * STAGE + ROWS) * (int)sizeof(float);
  static_assert(G * RTH == ROWS && RTH % 32 == 0, "whole warps, a CTA");
  static_assert(G == TR, "each group sums |v|^2 for one of its rows");
  static_assert(TQ == 1 ? NQ == 1 : TQ % 4 == 0, "queries read 4 at a time");
};

// queries [nq, dims] -> qt [ceil(nq / nq_tile)][dims4][nq_tile], zero past
// nq and dims
__global__ void stage_queries(const float* __restrict__ queries, int nq,
                              int dims, int dims4, int nq_tile,
                              float* __restrict__ qt) {
  const int tiles = (nq + nq_tile - 1) / nq_tile;
  const int n = tiles * dims4 * nq_tile;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int q = i % nq_tile, rest = i / nq_tile;
    const int j = rest % dims4, qi = (rest / dims4) * nq_tile + q;
    qt[i] = (qi < nq && j < dims) ? queries[(size_t)qi * dims + j] : 0.0f;
  }
}

// one dim of a thread's rows (v) against its queries (qv); a thread sums
// |v|^2 for its row 0
template <class T>
__device__ __forceinline__ void dim_step(const float (&v)[T::TR],
                                         const float (&qv)[T::TQ],
                                         float (&acc)[T::TR][T::TQ],
                                         float& dn) {
#pragma unroll
  for (int i = 0; i < T::TR; ++i) {
#pragma unroll
    for (int q = 0; q < T::TQ; ++q)
      acc[i][q] = __fadd_rn(acc[i][q], __fmul_rn(v[i], qv[q]));
  }
  dn = __fadd_rn(dn, __fmul_rn(v[0], v[0]));
}

// the queries of dim c: qs + c * NQ holds the thread's TQ of them
template <class T>
__device__ __forceinline__ void load_queries(const float* qs, int c,
                                             float (&qv)[T::TQ]) {
#pragma unroll
  for (int h = 0; h < T::TQ / 4; ++h) {
    const float4 x =
        *reinterpret_cast<const float4*>(qs + c * T::NQ + 4 * h);
    qv[4 * h] = x.x;
    qv[4 * h + 1] = x.y;
    qv[4 * h + 2] = x.z;
    qv[4 * h + 3] = x.w;
  }
}

// dims c .. c + 3 (c a multiple of 4): one 16-byte read a row
template <class T>
__device__ __forceinline__ void quad(const float* st, const int (&voff)[T::TR],
                                     const float* qs, int c,
                                     float (&acc)[T::TR][T::TQ],
                                     float& dn) {
  float4 v4[T::TR];
#pragma unroll
  for (int i = 0; i < T::TR; ++i)
    v4[i] = *reinterpret_cast<const float4*>(st + voff[i] + c);
  float4 q1 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if constexpr (T::TQ == 1) q1 = *reinterpret_cast<const float4*>(qs + c);
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    float v[T::TR], qv[T::TQ];
#pragma unroll
    for (int i = 0; i < T::TR; ++i) v[i] = lane4(v4[i], d);
    if constexpr (T::TQ == 1) {
      qv[0] = lane4(q1, d);
    } else {
      load_queries<T>(qs, c + d, qv);
    }
    dim_step<T>(v, qv, acc, dn);
  }
}

// one dim c, for a chunk's last dims % 4
template <class T>
__device__ __forceinline__ void single(const float* st,
                                       const int (&voff)[T::TR],
                                       const float* qs, int c,
                                       float (&acc)[T::TR][T::TQ],
                                       float& dn) {
  float v[T::TR], qv[T::TQ];
#pragma unroll
  for (int i = 0; i < T::TR; ++i) v[i] = st[voff[i] + c];
  if constexpr (T::TQ == 1) {
    qv[0] = qs[c];
  } else {
    load_queries<T>(qs, c, qv);
  }
  dim_step<T>(v, qv, acc, dn);
}

// grid (CTAs walking the row tiles, query tiles). qt: stage_queries'
// layout; qn, out: this launch's queries' |q|^2 and score rows
template <class T>
__global__ void __launch_bounds__(ROWS, 2)
knn_exact_kernel(const float* __restrict__ vectors,
                 const float* __restrict__ qt, const float* __restrict__ qn,
                 int nq, int Dp, int dims, int dims4, int space, int vec16,
                 float* __restrict__ out) {
  constexpr int TR = T::TR, TQ = T::TQ, NQ = T::NQ;
  extern __shared__ __align__(16) float smem[];
  float* dn_s = smem + STAGES * T::STAGE;
  const int t = threadIdx.x;
  const int g = t / T::RTH, rt = t % T::RTH;
  // the thread's rows, rotated so that the one whose |v|^2 it sums comes
  // first: row i is tile row rt + RTH * ((g + i) % TR)
  int voff[TR], rows[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    rows[i] = rt + T::RTH * ((g + i) % TR);
    voff[i] = rows[i] * STRIDE;
  }
  const int q0 = blockIdx.y * NQ;
  const float* qtile = qt + (size_t)blockIdx.y * dims4 * NQ;
  const int n_tiles = (Dp + ROWS - 1) / ROWS;
  const int nc = (dims + DC - 1) / DC;
  const int first = blockIdx.x, step = gridDim.x;
  const int n_items = (first < n_tiles ? (n_tiles - 1 - first) / step + 1
                                       : 0) * nc;

  // item n: chunk n % nc of the CTA's tile n / nc, into stage n % STAGES
  auto load = [&](int n) {
    if (n < n_items) {
      float* st = smem + (n % STAGES) * T::STAGE;
      const int r0 = (first + (n / nc) * step) * ROWS;
      const int j0 = (n % nc) * DC;
      const int dc = min(DC, dims - j0);
      if (vec16) {
        for (int p = t; p < ROWS * (DC / 4); p += ROWS) {
          const int r = p / (DC / 4), c = (p % (DC / 4)) * 4;
          if (c < dc && r0 + r < Dp)
            cp_async16(st + r * STRIDE + c,
                       vectors + (size_t)(r0 + r) * dims + j0 + c);
        }
      } else {
        for (int p = t; p < ROWS * DC; p += ROWS) {
          const int r = p / DC, c = p % DC;
          if (c < dc && r0 + r < Dp)
            cp_async4(st + r * STRIDE + c,
                      vectors + (size_t)(r0 + r) * dims + j0 + c);
        }
      }
      const int dq = min(DC, dims4 - j0);  // a multiple of 4
      float* qs = st + ROWS * STRIDE;
      for (int p = t; p < dq * NQ / 4; p += ROWS)
        cp_async16(qs + 4 * p, qtile + (size_t)j0 * NQ + 4 * p);
    }
    cp_async_commit();
  };

  float acc[TR][TQ];
  float dn = 0.0f;
  for (int n = 0; n < STAGES - 1; ++n) load(n);
  for (int n = 0; n < n_items; ++n) {
    // chunk n has landed and every thread is done with chunk n - 1, whose
    // stage the next copy overwrites
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    load(n + STAGES - 1);
    const float* st = smem + (n % STAGES) * T::STAGE;
    const float* qs = st + ROWS * STRIDE + g * TQ;
    const int chunk = n % nc;
    if (chunk == 0) {
#pragma unroll
      for (int i = 0; i < TR; ++i) {
#pragma unroll
        for (int q = 0; q < TQ; ++q) acc[i][q] = 0.0f;
      }
      dn = 0.0f;
    }
    const int dc = min(DC, dims - chunk * DC);
    if (dc == DC) {
#pragma unroll
      for (int c = 0; c < DC; c += 4) quad<T>(st, voff, qs, c, acc, dn);
    } else {
      int c = 0;
      for (; c + 4 <= dc; c += 4) quad<T>(st, voff, qs, c, acc, dn);
      for (; c < dc; ++c) single<T>(st, voff, qs, c, acc, dn);
    }
    if (chunk == nc - 1) {  // the tile's end
      const int r0 = (first + (n / nc) * step) * ROWS;
      if constexpr (T::G > 1) {
        dn_s[rows[0]] = dn;
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int d = r0 + rows[i];
        if (d >= Dp) continue;
        const float dv = T::G > 1 ? dn_s[rows[i]] : dn;
#pragma unroll
        for (int q = 0; q < TQ; ++q) {
          const int qi = q0 + g * TQ + q;
          if (qi < nq)
            out[(size_t)qi * Dp + d] =
                space_score(acc[i][q], dv, qn[qi], space);
        }
      }
    }
  }
}

// one launch of stage_queries and the scan for nq queries in tiles of NQ
template <class T>
int launch(const float* vectors, const float* queries, int nq, int Dp,
           int dims, int dims4, int space, int vec16, float* qt,
           const float* qn, float* out, cudaStream_t s) {
  // resident CTAs of the card (set once per tile shape, at its first call)
  static int resident = 0;
  if (resident == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        knn_exact_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::SMEM);
    int per_sm = 0, dev = 0, sms = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, knn_exact_kernel<T>, ROWS, T::SMEM);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    resident = (per_sm > 0 ? per_sm : 1) * sms;
  }
  const int qtiles = (nq + T::NQ - 1) / T::NQ;
  const int n_tiles = (Dp + ROWS - 1) / ROWS;
  int gx = resident / qtiles;
  gx = gx < 1 ? 1 : (gx > n_tiles ? n_tiles : gx);
  const int staged = qtiles * dims4 * T::NQ;
  int sg = (staged + 255) / 256;
  sg = sg > 1024 ? 1024 : sg;
  stage_queries<<<sg, 256, 0, s>>>(queries, nq, dims, dims4, T::NQ, qt);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  knn_exact_kernel<T><<<dim3(gx, qtiles), ROWS, T::SMEM, s>>>(
      vectors, qt, qn, nq, Dp, dims, dims4, space, vec16, out);
  return (int)cudaGetLastError();
}

// the tile shapes: 32 queries (4 rows x 8 queries a thread), 8 queries (a
// row x 8), one query
using Tile32 = Tile<32, 8, 4>;
using Tile8 = Tile<8, 8, 1>;
using Tile1 = Tile<1, 1, 1>;

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

// vectors: f32 [Dp, dims] (rows contiguous, any alignment); queries: f32
// [B, dims]; space: 0 l2, 1 cosinesimil, 2 innerproduct; scratch: f32
// [(B + 32) * dims4 + B], dims4 = dims rounded up to 4 (the staged
// queries, then |q|^2); out: f32 [B, Dp].
extern "C" int knn_exact(const float* vectors, const float* queries, int B,
                         int Dp, int dims, int space, float* scratch,
                         float* out, void* stream) {
  if (B <= 0 || Dp <= 0) return 0;
  if (dims <= 0 || space < 0 || space > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int dims4 = (dims + 3) & ~3;
  float* qt = scratch;
  float* qn = scratch + (size_t)(B + 32) * dims4;
  query_norms<<<(B + 127) / 128, 128, 0, s>>>(queries, B, dims, qn);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int vec16 =
      dims % 4 == 0 && (reinterpret_cast<uintptr_t>(vectors) & 15) == 0;
  // whole 32-query tiles, then the rest in the smallest tile holding it
  const int full = B / 32 * 32;
  if (full > 0) {
    const int code = launch<Tile32>(vectors, queries, full, Dp, dims,
                                      dims4, space, vec16, qt, qn, out, s);
    if (code != 0) return code;
  }
  const int rest = B - full;
  if (rest == 0) return 0;
  const float* rq = queries + (size_t)full * dims;
  float* rqt = qt + (size_t)full * dims4;
  float* rout = out + (size_t)full * Dp;
  if (rest == 1)
    return launch<Tile1>(vectors, rq, rest, Dp, dims, dims4, space, vec16,
                           rqt, qn + full, rout, s);
  if (rest <= 8)
    return launch<Tile8>(vectors, rq, rest, Dp, dims, dims4, space, vec16,
                           rqt, qn + full, rout, s);
  return launch<Tile32>(vectors, rq, rest, Dp, dims, dims4, space, vec16,
                          rqt, qn + full, rout, s);
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
