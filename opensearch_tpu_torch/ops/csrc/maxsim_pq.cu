// K11 maxsim_pq: product-quantized late-interaction MaxSim, two entries.
// - pq_lut: the ADC table of every query token,
//     lut[b, t, m, c] = sum_j codebook[m, c, j] * q[b, t, m * dsub + j]
//   (j order), f32 [B, Tq, M, 256] from codebook f32 [M, 256, dsub] and
//   query f32 [B, Tq, M * dsub].
// - maxsim_pq: per doc d (codes u8 [Dp, T, M], token_count[d] real
//   tokens) and query b:
//     dot(t, s) = sum_m lut[b, t, m, codes[d, s, m]]     (m order)
//   then K10's epilogue: max over the real tokens, a non-finite max to 0,
//   out[b, d] = sum_t best_t * qmask[b, t] (t order). The decoded
//   vectors never exist.
// Every add and multiply rounds once, so both entries equal their plain
// PyTorch versions (ops/maxsim.py: pq_lut_plain,
// pq_maxsim_from_lut_plain) bit for bit.
//
// Replaces opensearch_tpu/ops/maxsim.py:pq_lut and pq_maxsim_scores (the
// `compression: pq` branch of the `maxsim` plan).
//
// What bounds pq_lut on an H100: its table's bytes, B * Tq * M * 1 KiB
// stored once. What bounds maxsim_pq: the table lookups. Each doc token costs
// Tq * M gathers from a query's table and as many adds for its M bytes of
// codes; the codes' bytes alone bound it only at small B * Tq.
//
// Design (simple first).
// - pq_lut: grid (tiles of 32 query rows (b, t), M), one thread per code c
//   with its codebook row in registers (templated on dsub 1, 2, 4, 8, 16;
//   a loop for any other dsub); the tile's query sub-vectors are staged in
//   shared memory and read as broadcasts; a row's 256 entries
//   are one contiguous 1 KiB store. No divide but the staging's by the
//   constant dsub. (Its first version, one thread an entry with 64-bit
//   divides and modulos by the runtime M, took twice torch.einsum's time.)
// - maxsim_pq: one warp per doc, DOCS = 32 docs per CTA, grid (doc tiles,
//   B). A query's table is Tq * M * 1 KiB (1 MiB at Tq 32, M 32), more
//   than an SM's shared memory, so the CTA walks the query tokens in tiles
//   of TT tokens: the tile's [TT, M, 256] tables are staged in shared
//   memory (16-byte loads); a lane scores the doc tokens s = lane, lane +
//   32, ... against them (a token's code row in 16-byte loads, so a warp
//   reads consecutive rows: coalesced), keeps TT running maxima, and a
//   warp-shuffle max per query token gives the doc's best_t, added in
//   ascending t to the doc's total, so the sum order is fixed. TT is as
//   many tokens as fit in the host's budget. (A thread per doc would read
//   codes 4 KiB apart across a warp and chain its gathers.) ptxas keeps
//   32 registers (a few spills) and two CTAs per SM: on an H100 that ran
//   faster than one CTA per SM with 64 registers.

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

namespace {

constexpr int PQ_CODES = 256;
constexpr int DOCS = 32;                 // docs per CTA, one warp each
constexpr int THREADS = DOCS * 32;
constexpr int MAX_TT = 8;
constexpr int SMEM_LIMIT = 232448;
constexpr int LUT_ROWS = 32;             // query rows (b, t) per pq_lut CTA

// pq_lut: grid (row tiles of BT, M), one thread per code c. With DSUB > 0
// the thread keeps codebook[m, c, :] in registers and the CTA stages its
// LUT_ROWS query sub-vectors q[bt, m * dsub : (m + 1) * dsub] in shared
// memory; DSUB == 0 is the loop for any other dsub, reading both rows from
// global memory (the query's as a broadcast: every thread of the CTA reads
// the same address). Each thread writes its column of every row, so the
// 256 threads of a row store 1 KiB contiguously. I is 32-bit while every
// index stays below 2^31.
template <int DSUB, typename I>
__global__ void __launch_bounds__(PQ_CODES)
pq_lut_kernel(const float* __restrict__ codebook,
              const float* __restrict__ query, int BT, int M, int dsub,
              float* __restrict__ lut) {
  constexpr int D = DSUB > 0 ? DSUB : 1;
  __shared__ float qs[LUT_ROWS * D];
  const int c = threadIdx.x;
  const int m = blockIdx.y;
  const int bt0 = blockIdx.x * LUT_ROWS;
  const int rows = min(LUT_ROWS, BT - bt0);
  const int d = DSUB > 0 ? DSUB : dsub;
  const float* cbrow = codebook + ((I)m * PQ_CODES + c) * d;
  float cb[D];
  if constexpr (DSUB > 0) {
#pragma unroll
    for (int j = 0; j < D; ++j) cb[j] = cbrow[j];
    for (int i = threadIdx.x; i < rows * D; i += PQ_CODES) {
      const int r = i / D;
      qs[i] = query[((I)(bt0 + r) * M + m) * D + (i - r * D)];
    }
    __syncthreads();
  }
  float* dst = lut + ((I)bt0 * M + m) * PQ_CODES + c;
  const I row_stride = (I)M * PQ_CODES;
  for (int r = 0; r < rows; ++r) {
    // the plain version's order: 0, then + cb[j] * q[j] in ascending j,
    // each product and sum rounded once
    float acc = 0.0f;
    if constexpr (DSUB > 0) {
      const float* q = qs + r * D;
#pragma unroll
      for (int j = 0; j < D; ++j)
        acc = __fadd_rn(acc, __fmul_rn(cb[j], q[j]));
    } else {
      const float* q = query + ((I)(bt0 + r) * M + m) * d;
      for (int j = 0; j < d; ++j)
        acc = __fadd_rn(acc, __fmul_rn(cbrow[j], q[j]));
    }
    dst[(I)r * row_stride] = acc;
  }
}

template <int DSUB>
cudaError_t launch_lut(const float* codebook, const float* query, int BT,
                       int M, int dsub, float* lut, cudaStream_t stream) {
  const dim3 grid((BT + LUT_ROWS - 1) / LUT_ROWS, M);
  // the table's entries, the query's and the codebook's floats all index
  // below BT * M * max(256, dsub)
  if ((long long)BT * M * (dsub > PQ_CODES ? dsub : PQ_CODES) < (1ll << 31))
    pq_lut_kernel<DSUB, int><<<grid, PQ_CODES, 0, stream>>>(
        codebook, query, BT, M, dsub, lut);
  else
    pq_lut_kernel<DSUB, long long><<<grid, PQ_CODES, 0, stream>>>(
        codebook, query, BT, M, dsub, lut);
  return cudaGetLastError();
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(THREADS)
pq_score_kernel(const uint8_t* __restrict__ codes,
                const float* __restrict__ lut,
                const int* __restrict__ token_count,
                const float* __restrict__ qmask, int B, int Dp, int T,
                int Tq, int M, int TT, float* __restrict__ out) {
  extern __shared__ __align__(16) float tab[];   // [TT, M, 256]
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int d = blockIdx.x * DOCS + (threadIdx.x >> 5);
  const int tc = d < Dp ? min(token_count[d], T) : 0;
  const size_t per_tok = (size_t)M * PQ_CODES;
  const float* lb = lut + (size_t)b * Tq * per_tok;
  const uint8_t* dcodes = codes + (size_t)(d < Dp ? d : 0) * T * M;
  // a token's code row as 16-byte loads where the layout allows them
  const bool rows16 = (M % 16) == 0 &&
                      (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  float total = 0.0f;
  for (int t0 = 0; t0 < Tq; t0 += TT) {
    const int tn = min(TT, Tq - t0);
    __syncthreads();
    // the tile's tables: 16-byte loads where the base allows them
    // (per_tok is a multiple of 256 floats, so every table is then
    // aligned)
    const float* src = lb + (size_t)t0 * per_tok;
    if ((reinterpret_cast<uintptr_t>(lut) & 15) == 0) {
      for (size_t i = threadIdx.x; i < (size_t)tn * per_tok / 4;
           i += THREADS)
        reinterpret_cast<float4*>(tab)[i] =
            reinterpret_cast<const float4*>(src)[i];
    } else {
      for (size_t i = threadIdx.x; i < (size_t)tn * per_tok; i += THREADS)
        tab[i] = src[i];
    }
    __syncthreads();
    float best[MAX_TT];
#pragma unroll
    for (int i = 0; i < MAX_TT; ++i) best[i] = -INFINITY;
    for (int s = lane; s < tc; s += 32) {
      const uint8_t* cs = dcodes + (size_t)s * M;
      float acc[MAX_TT];
#pragma unroll
      for (int i = 0; i < MAX_TT; ++i) acc[i] = 0.0f;
      for (int m0 = 0; m0 < M; m0 += 16) {
        uint32_t w[4];
        if (rows16) {
          const uint4 v = *reinterpret_cast<const uint4*>(cs + m0);
          w[0] = v.x;
          w[1] = v.y;
          w[2] = v.z;
          w[3] = v.w;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            w[q] = 0;
            for (int v = 0; v < 4 && m0 + 4 * q + v < M; ++v)
              w[q] |= (uint32_t)cs[m0 + 4 * q + v] << (8 * v);
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int m = m0 + 4 * q + v;
            if (m < M) {
              const float* e = tab + (size_t)m * PQ_CODES
                               + ((w[q] >> (8 * v)) & 0xffu);
#pragma unroll
              for (int i = 0; i < MAX_TT; ++i)
                if (i < tn) acc[i] = __fadd_rn(acc[i], e[(size_t)i * per_tok]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MAX_TT; ++i)
        if (i < tn) best[i] = fmaxf(best[i], acc[i]);
    }
    // every lane holds the doc's maxima after the shuffles and adds them
    // in ascending t; lane 0 stores
#pragma unroll
    for (int i = 0; i < MAX_TT; ++i) {
      const float m = warp_max(best[i]);
      if (i < tn) {
        const float v = isfinite(m) ? m : 0.0f;
        total = __fadd_rn(total,
                          __fmul_rn(v, qmask[(size_t)b * Tq + t0 + i]));
      }
    }
  }
  if (lane == 0 && d < Dp) out[(size_t)b * Dp + d] = total;
}

}  // namespace

// codebook: f32 [M, 256, dsub]; query: f32 [BT, M * dsub] (BT = B * Tq);
// lut: f32 [BT, M, 256].
extern "C" int pq_lut(const float* codebook, const float* query, int BT,
                      int M, int dsub, float* lut, void* stream) {
  if (BT <= 0) return 0;
  if (M <= 0 || M > 65535 || dsub <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dsub) {
    case 1: return (int)launch_lut<1>(codebook, query, BT, M, dsub, lut, s);
    case 2: return (int)launch_lut<2>(codebook, query, BT, M, dsub, lut, s);
    case 4: return (int)launch_lut<4>(codebook, query, BT, M, dsub, lut, s);
    case 8: return (int)launch_lut<8>(codebook, query, BT, M, dsub, lut, s);
    case 16:
      return (int)launch_lut<16>(codebook, query, BT, M, dsub, lut, s);
    default:
      return (int)launch_lut<0>(codebook, query, BT, M, dsub, lut, s);
  }
}

// codes: u8 [Dp, T, M]; lut: f32 [B, Tq, M, 256]; token_count: i32 [Dp];
// qmask: f32 [B, Tq]; TT: query tokens per shared-memory tile (1-8);
// out: f32 [B, Dp].
extern "C" int maxsim_pq(const uint8_t* codes, const float* lut,
                         const int* token_count, const float* qmask, int B,
                         int Dp, int T, int Tq, int M, int TT, float* out,
                         void* stream) {
  if (B <= 0 || Dp <= 0) return 0;
  const size_t smem = (size_t)TT * M * PQ_CODES * sizeof(float);
  if (T <= 0 || Tq <= 0 || M <= 0 || TT <= 0 || TT > MAX_TT ||
      smem > (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        pq_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const dim3 grid((Dp + DOCS - 1) / DOCS, B);
  pq_score_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      codes, lut, token_count, qmask, B, Dp, T, Tq, M, TT, out);
  return (int)cudaGetLastError();
}

extern "C" const char* maxsim_pq_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
