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
// - maxsim_pq (redesigned): the scorer is bound by its shared-memory
//   table reads, one 4-byte read per (doc token, query token, sub-space):
//   ~8.2e9 at B=1 on the MaxSim cell, against an H100's 32 a cycle a SM
//   (~0.98 ms). The first version (a warp a doc, lane = doc token, tables
//   [TT, M, 256] with TT = 3 at M = 32) lost ~6.5x that: each lookup
//   landed on a bank chosen by a random code byte (3-4 wavefronts for 32
//   reads), and every tile of TT query tokens re-read the doc's codes
//   (11 times a query at Tq = 32).
//   Now a CTA stages one GROUP of G query tokens (G = 8, 4, 2 or 1, the
//   widest whose [M, 256, G] table fits in shared memory: G = 4 at
//   M = 32, 128 KiB) with the query token innermost, so one lookup of a
//   (doc token, sub-space) is one 16-byte read (G / 4 of them at G = 8)
//   that returns all G query tokens' values, added to G running sums in
//   registers: G reads of 4 bytes in one instruction, its address made
//   once. A warp scores one doc at a time (lane = doc token, its code row
//   as 16-byte loads, coalesced), takes G running maxima, reduces them by
//   shuffles and adds best_t * qmask[t] to the doc's total in shared
//   memory, ascending t. The CTA walks the groups in ascending t over its
//   PQ_DOCS docs (a shared counter hands docs to warps), so each doc's
//   codes are read Tq / G times (8 at Tq = 32, M = 32; 11 before), mostly
//   from L2, each lane loading its next token's codes before it scores
//   the current one (without that the table reads waited on them). A CTA
//   has 1,024 threads (a throwaway probe on an H100 timed 512 and 768
//   beside it: 1,024 was the fastest, PERF.md). What is left: the
//   16-byte rows of 8 lanes with random code bytes share bank groups (a
//   128-bit read of 8 random rows takes ~2.3 passes where one would do);
//   with every code byte 0 (a broadcast) the same work takes about half
//   the time (PERF.md, chip_smoke's textpq cell).
//   A thread-block cluster splitting M (the running sums passed
//   CTA to CTA in m order through distributed shared memory) would read
//   the codes once and make every lookup a 32-lane broadcast, but it
//   moves each (doc token, query token) sum through every CTA of the
//   cluster (~7 GB at B=1 over 8 CTAs) behind a cluster barrier a step;
//   it was not built. Every add rounds once in the plain version's order
//   (m from 0; then t from 0), so the output stays bit for bit.

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

namespace {

constexpr int PQ_CODES = 256;
constexpr int PQ_DOCS = 128;             // docs per CTA
constexpr int SMEM_LIMIT = 232448;
// the tile's totals and token counts, and the doc counter
constexpr int TOTALS_BYTES = PQ_DOCS * 8 + 16;
constexpr int PQ_THREADS = 1024;         // the scorer's CTA
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

// G values of one table row: tab[(m * 256 + c) * G + k], k < G
template <int G>
__device__ __forceinline__ void add_row(const float* row, float* acc) {
  if constexpr (G == 1) {
    acc[0] = __fadd_rn(acc[0], row[0]);
  } else if constexpr (G == 2) {
    const float2 v = *reinterpret_cast<const float2*>(row);
    acc[0] = __fadd_rn(acc[0], v.x);
    acc[1] = __fadd_rn(acc[1], v.y);
  } else {
#pragma unroll
    for (int h = 0; h < G / 4; ++h) {
      const float4 v = reinterpret_cast<const float4*>(row)[h];
      acc[4 * h] = __fadd_rn(acc[4 * h], v.x);
      acc[4 * h + 1] = __fadd_rn(acc[4 * h + 1], v.y);
      acc[4 * h + 2] = __fadd_rn(acc[4 * h + 2], v.z);
      acc[4 * h + 3] = __fadd_rn(acc[4 * h + 3], v.w);
    }
  }
}

// grid (doc tiles of PQ_DOCS, B); dynamic shared: the group's table
// [M, 256, G] f32, then the tile's totals and token counts [PQ_DOCS] and
// the doc counter. Where a token's codes are at most two 16-byte loads
// (M = 16 or 32, aligned), a lane loads its next token's codes before it
// scores the current one, so the table reads do not wait on device
// memory.
template <int G>
__global__ void __launch_bounds__(PQ_THREADS, 1)
pq_score_kernel(const uint8_t* __restrict__ codes,
                const float* __restrict__ lut,
                const int* __restrict__ token_count,
                const float* __restrict__ qmask, int Dp, int T, int Tq,
                int M, float* __restrict__ out) {
  extern __shared__ __align__(16) float tab[];
  float* s_tot = tab + (size_t)M * PQ_CODES * G;
  int* s_tc = reinterpret_cast<int*>(s_tot + PQ_DOCS);
  int* s_next = s_tc + PQ_DOCS;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int d_base = blockIdx.x * PQ_DOCS;
  const int n_docs = min(PQ_DOCS, Dp - d_base);
  const size_t per_tok = (size_t)M * PQ_CODES;
  const float* lb = lut + (size_t)b * Tq * per_tok;
  const float* qm = qmask + (size_t)b * Tq;
  // a token's code row as 16-byte loads where the layout allows them
  const bool rows16 = (M % 16) == 0 &&
                      (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  const bool ahead = rows16 && M <= 32;
  for (int i = threadIdx.x; i < n_docs; i += PQ_THREADS)
    s_tc[i] = min(token_count[d_base + i], T);
  for (int t0 = 0; t0 < Tq; t0 += G) {
    const int tn = min(G, Tq - t0);
    __syncthreads();  // the last group's table and counter are consumed
    // stage [m][c][k] = lut[b, t0 + k, m, c] (0 past Tq): coalesced over
    // c, one G-vector store per (m, c)
    for (int i = threadIdx.x; i < M * PQ_CODES; i += PQ_THREADS) {
      float v[G];
#pragma unroll
      for (int k = 0; k < G; ++k)
        v[k] = k < tn ? lb[(size_t)(t0 + k) * per_tok + i] : 0.0f;
      float* dst = tab + (size_t)i * G;
      if constexpr (G == 1) {
        dst[0] = v[0];
      } else if constexpr (G == 2) {
        *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
      } else {
#pragma unroll
        for (int h = 0; h < G / 4; ++h)
          reinterpret_cast<float4*>(dst)[h] = make_float4(
              v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
      }
    }
    if (threadIdx.x == 0) *s_next = 0;
    __syncthreads();
    for (;;) {
      int dl = 0;
      if (lane == 0) dl = atomicAdd(s_next, 1);
      dl = __shfl_sync(0xffffffffu, dl, 0);
      if (dl >= n_docs) break;
      const int tc = s_tc[dl];
      const uint8_t* dcodes = codes + (size_t)(d_base + dl) * T * M;
      float best[G];
#pragma unroll
      for (int k = 0; k < G; ++k) best[k] = -INFINITY;
      uint4 next[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
      if (ahead && lane < tc) {
        const uint4* cs = reinterpret_cast<const uint4*>(
            dcodes + (size_t)lane * M);
        next[0] = cs[0];
        if (M > 16) next[1] = cs[1];
      }
      for (int s = lane; s < tc; s += 32) {
        const uint8_t* cs = dcodes + (size_t)s * M;
        const uint4 here[2] = {next[0], next[1]};
        if (ahead && s + 32 < tc) {
          const uint4* nx = reinterpret_cast<const uint4*>(cs + 32 * M);
          next[0] = nx[0];
          if (M > 16) next[1] = nx[1];
        }
        float acc[G];
#pragma unroll
        for (int k = 0; k < G; ++k) acc[k] = 0.0f;
        for (int m0 = 0; m0 < M; m0 += 16) {
          uint32_t w[4];
          if (ahead) {
            const uint4 v = m0 == 0 ? here[0] : here[1];
            w[0] = v.x;
            w[1] = v.y;
            w[2] = v.z;
            w[3] = v.w;
          } else if (rows16) {
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
          const float* tm = tab + (size_t)m0 * PQ_CODES * G;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const int mm = 4 * q + v;
              if (m0 + mm < M)
                add_row<G>(tm + ((size_t)mm * PQ_CODES
                                 + ((w[q] >> (8 * v)) & 0xffu)) * G, acc);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < G; ++k) best[k] = fmaxf(best[k], acc[k]);
      }
#pragma unroll
      for (int k = 0; k < G; ++k) best[k] = warp_max(best[k]);
      if (lane == 0) {
        // the doc's total, ascending t: 0, then + best_t * qmask[t]
        float total = t0 == 0 ? 0.0f : s_tot[dl];
        for (int k = 0; k < tn; ++k) {
          const float v = isfinite(best[k]) ? best[k] : 0.0f;
          total = __fadd_rn(total, __fmul_rn(v, qm[t0 + k]));
        }
        s_tot[dl] = total;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_docs; i += PQ_THREADS)
    out[(size_t)b * Dp + d_base + i] = Tq > 0 ? s_tot[i] : 0.0f;
}

// the widest G of 8, 4, 2, 1 whose table [M, 256, G] f32 and the tile's
// totals fit in shared memory, and no wider than Tq needs (the wrapper's
// ops/maxsim.py pq_group, checked against this)
int group_for(int M, int Tq) {
  for (int g = 8; g > 1; g >>= 1)
    if (g / 2 < Tq &&
        (size_t)M * PQ_CODES * g * sizeof(float) + TOTALS_BYTES <=
            (size_t)SMEM_LIMIT)
      return g;
  return 1;
}

template <int G>
cudaError_t launch_score(const uint8_t* codes, const float* lut,
                         const int* token_count, const float* qmask, int B,
                         int Dp, int T, int Tq, int M, float* out,
                         cudaStream_t stream) {
  const size_t smem = (size_t)M * PQ_CODES * G * sizeof(float)
                      + TOTALS_BYTES;
  if (smem > (size_t)SMEM_LIMIT) return cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        pq_score_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const dim3 grid((Dp + PQ_DOCS - 1) / PQ_DOCS, B);
  pq_score_kernel<G><<<grid, PQ_THREADS, smem, stream>>>(
      codes, lut, token_count, qmask, Dp, T, Tq, M, out);
  return cudaGetLastError();
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
// qmask: f32 [B, Tq]; G: query tokens a group, the wrapper's pick, which
// must be group_for(M, Tq); out: f32 [B, Dp].
extern "C" int maxsim_pq(const uint8_t* codes, const float* lut,
                         const int* token_count, const float* qmask, int B,
                         int Dp, int T, int Tq, int M, int G, float* out,
                         void* stream) {
  if (B <= 0 || Dp <= 0) return 0;
  if (T <= 0 || Tq < 0 || M <= 0 || B > 65535 || G != group_for(M, Tq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (G) {
    case 1: return (int)launch_score<1>(codes, lut, token_count, qmask, B,
                                        Dp, T, Tq, M, out, s);
    case 2: return (int)launch_score<2>(codes, lut, token_count, qmask, B,
                                        Dp, T, Tq, M, out, s);
    case 4: return (int)launch_score<4>(codes, lut, token_count, qmask, B,
                                        Dp, T, Tq, M, out, s);
    default: return (int)launch_score<8>(codes, lut, token_count, qmask, B,
                                         Dp, T, Tq, M, out, s);
  }
}

extern "C" const char* maxsim_pq_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
