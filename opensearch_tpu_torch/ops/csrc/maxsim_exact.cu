// K10 maxsim_exact: exact late-interaction (ColBERT) MaxSim. Per doc d of a
// padded f32 [Dp, T, dims] token block with token_count[d] real tokens,
// and per query b of an f32 [B, Tq, dims] batch with its qmask [B, Tq]:
//   dot(t, s) = sum_j q[b, t, j] * tok[d, s, j]        (dim order)
//   best_t    = max over s < token_count[d] of dot(t, s)  (-inf if none)
//   best_t    = 0 where best_t is not finite
//   out[b, d] = sum_t best_t * qmask[b, t]              (t order)
// Every multiply and add rounds once (__fmul_rn / __fadd_rn), so the
// kernel equals its plain PyTorch version
// (ops/maxsim.py:exact_maxsim_scores_plain) bit for bit.
//
// Replaces opensearch_tpu/ops/maxsim.py:exact_maxsim_scores and
// _tiled_token_dots (the exact branch of the `maxsim` plan in
// opensearch_tpu/search/plan_eval.py).
//
// What bounds it on an H100: operations. At B = 32, Tq = 32 and 128 dims
// a doc token costs B * Tq * dims multiply-adds (two f32 operations each,
// no FMA) for its dims * 4 bytes, far above the card's operations-to-byte
// ratio; at B = 1 the token bytes and the operations are of one order.
//
// Design (simple first; tensor cores and register tiles are later work).
// - One CTA per doc, one thread per doc token lane (T rounded up to a
//   warp). Padding docs (no tokens) write 0 and leave.
// - The doc's real token rows are staged in shared memory in chunks of DC
//   dims (row stride DC + 1: no bank conflicts when each thread walks its
//   own row) with coalesced 16-byte loads, several in flight per thread
//   (staged one 4-byte load at a time, the doc and every query's chunk
//   would wait out a load latency per element). When dims <= DC the doc
//   is staged once
//   and then serves every query of the batch: its bytes leave device
//   memory once per batch, not once per query token.
// - Per query, TQC = 32 query tokens at a time: their chunk sits
//   transposed in shared memory ([dim][token]), so one 128-bit broadcast
//   load feeds four dot products, and each thread keeps 32 dots in
//   registers.
// - The max over the doc's tokens is a warp-shuffle max, then a max over
//   the warps' partials in shared memory; one thread sums best_t * qmask
//   in t order.

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

namespace {

constexpr int TQC = 32;
constexpr int MAX_THREADS = 1024;
constexpr int SMEM_LIMIT = 232448;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Staging loads are independent of each other: with 16-byte loads where
// the layout allows them (`vec`: a 16-byte aligned base and dims % 4 ==
// 0, which keeps every row and chunk aligned) and unrolled loops, a
// thread keeps several in flight instead of waiting out one load's
// latency at a time. (The query arrives as a view of the packed input
// envelope, whose leaves need not be 16-byte aligned.)

// the doc's real token rows, dims [j0, j0 + dc), into doc [T][DC + 1]
__device__ __forceinline__ void stage_doc(const float* __restrict__ rows,
                                          float* doc, int tc, int dims,
                                          int j0, int dc, int DC, bool vec) {
  const int nthr = blockDim.x;
  if (vec) {
    const int dc4 = dc >> 2;
#pragma unroll 4
    for (int i = threadIdx.x; i < tc * dc4; i += nthr) {
      const int r = i / dc4, c = (i - r * dc4) * 4;
      const float4 v = *reinterpret_cast<const float4*>(
          rows + (size_t)r * dims + j0 + c);
      float* dst = doc + r * (DC + 1) + c;
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < tc * dc; i += nthr) {
      const int r = i / dc, c = i - r * dc;
      doc[r * (DC + 1) + c] = rows[(size_t)r * dims + j0 + c];
    }
  }
}

// the query tokens [t0, t0 + tn) of q (row t0 first), dims [j0, j0 + dc),
// transposed into qt [DC][TQC], zero elsewhere; consecutive threads take
// consecutive tokens, so the transposed stores hit distinct banks
__device__ __forceinline__ void stage_query(const float* __restrict__ q,
                                            float* qt, int tn, int dims,
                                            int j0, int dc, int DC,
                                            bool vec) {
  const int nthr = blockDim.x;
  if (vec) {
#pragma unroll 4
    for (int i = threadIdx.x; i < DC * TQC / 4; i += nthr) {
      const int t = i % TQC, c = (i / TQC) * 4;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (t < tn && c < dc)
        v = *reinterpret_cast<const float4*>(q + (size_t)t * dims + j0 + c);
      qt[c * TQC + t] = v.x;
      qt[(c + 1) * TQC + t] = v.y;
      qt[(c + 2) * TQC + t] = v.z;
      qt[(c + 3) * TQC + t] = v.w;
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < DC * TQC; i += nthr) {
      const int t = i % TQC, c = i / TQC;
      qt[c * TQC + t] =
          (c < dc && t < tn) ? q[(size_t)t * dims + j0 + c] : 0.0f;
    }
  }
}

// shared floats of one CTA: the doc chunk (16-byte aligned end), the
// query chunk, the warps' partial maxima and the Tq best values
size_t smem_floats(int T, int DC, int nwarp, int Tq) {
  const size_t doc = ((size_t)T * (DC + 1) + 3) / 4 * 4;
  return doc + (size_t)DC * TQC + (size_t)nwarp * TQC + Tq;
}

// MAXT: the launch bound (256 keeps the 32 dots in registers; a bucket
// of more than 256 token lanes takes the 1024-thread variant)
template <int MAXT>
__global__ void __launch_bounds__(MAXT)
maxsim_exact_kernel(const float* __restrict__ tokens,
                    const int* __restrict__ token_count,
                    const float* __restrict__ query,
                    const float* __restrict__ qmask, int B, int Dp, int T,
                    int Tq, int dims, int DC, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int nthr = blockDim.x;
  const int nwarp = nthr / 32;
  float* doc = smem;
  float* qt = doc + ((size_t)T * (DC + 1) + 3) / 4 * 4;
  float* red = qt + DC * TQC;
  float* best = red + nwarp * TQC;
  const int d = blockIdx.x;
  const int s = threadIdx.x;
  const int lane = s & 31, warp = s >> 5;
  const int tc = min(token_count[d], T);
  if (tc <= 0) {
    for (int b = s; b < B; b += nthr) out[(size_t)b * Dp + d] = 0.0f;
    return;
  }
  const float* rows = tokens + (size_t)d * T * dims;
  const bool once = dims <= DC;
  const bool vec_t = (dims & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(tokens) & 15) == 0;
  const bool vec_q = (dims & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(query) & 15) == 0;
  for (int b = 0; b < B; ++b) {
    for (int t0 = 0; t0 < Tq; t0 += TQC) {
      const int tn = min(TQC, Tq - t0);
      float acc[TQC];
#pragma unroll
      for (int t = 0; t < TQC; ++t) acc[t] = 0.0f;
      for (int j0 = 0; j0 < dims; j0 += DC) {
        const int dc = min(DC, dims - j0);
        __syncthreads();
        if (!once || (b == 0 && t0 == 0))
          stage_doc(rows, doc, tc, dims, j0, dc, DC, vec_t);
        stage_query(query + ((size_t)b * Tq + t0) * dims, qt, tn, dims, j0,
                    dc, DC, vec_q);
        __syncthreads();
        if (s < tc) {
          const float* row = doc + s * (DC + 1);
          // unrolled: the next dims' shared loads issue before this dim's
          // multiply-adds retire
#pragma unroll 4
          for (int c = 0; c < dc; ++c) {
            const float v = row[c];
            const float4* q4 = reinterpret_cast<const float4*>(qt + c * TQC);
#pragma unroll
            for (int g = 0; g < TQC / 4; ++g) {
              const float4 x = q4[g];
              acc[4 * g] = __fadd_rn(acc[4 * g], __fmul_rn(v, x.x));
              acc[4 * g + 1] = __fadd_rn(acc[4 * g + 1], __fmul_rn(v, x.y));
              acc[4 * g + 2] = __fadd_rn(acc[4 * g + 2], __fmul_rn(v, x.z));
              acc[4 * g + 3] = __fadd_rn(acc[4 * g + 3], __fmul_rn(v, x.w));
            }
          }
        }
      }
      // the max over the doc's real tokens, per query token
#pragma unroll
      for (int t = 0; t < TQC; ++t) {
        const float m = warp_max(s < tc ? acc[t] : -INFINITY);
        if (lane == 0) red[warp * TQC + t] = m;
      }
      __syncthreads();
      if (s < tn) {
        float m = -INFINITY;
        for (int w = 0; w < nwarp; ++w) m = fmaxf(m, red[w * TQC + s]);
        best[t0 + s] = isfinite(m) ? m : 0.0f;
      }
    }
    __syncthreads();
    if (s == 0) {
      float total = 0.0f;
      for (int t = 0; t < Tq; ++t)
        total = __fadd_rn(total, __fmul_rn(best[t], qmask[(size_t)b * Tq + t]));
      out[(size_t)b * Dp + d] = total;
    }
  }
}

}  // namespace

// tokens: f32 [Dp, T, dims]; token_count: i32 [Dp]; query: f32
// [B, Tq, dims]; qmask: f32 [B, Tq]; out: f32 [B, Dp].
extern "C" int maxsim_exact(const float* tokens, const int* token_count,
                            const float* query, const float* qmask, int B,
                            int Dp, int T, int Tq, int dims, float* out,
                            void* stream) {
  if (B <= 0 || Dp <= 0) return 0;
  if (T <= 0 || T > MAX_THREADS || Tq <= 0 || dims <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nthr = (T + 31) / 32 * 32;
  const int nwarp = nthr / 32;
  int DC = 128;
  while (DC > 8 &&
         smem_floats(T, DC, nwarp, Tq) * sizeof(float) > (size_t)SMEM_LIMIT)
    DC >>= 1;
  const size_t smem = smem_floats(T, DC, nwarp, Tq) * sizeof(float);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  // the shared-memory opt-in is per device function: set it once
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        maxsim_exact_kernel<256>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(maxsim_exact_kernel<MAX_THREADS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  if (nthr <= 256)
    maxsim_exact_kernel<256><<<Dp, nthr, smem, st>>>(
        tokens, token_count, query, qmask, B, Dp, T, Tq, dims, DC, out);
  else
    maxsim_exact_kernel<MAX_THREADS><<<Dp, nthr, smem, st>>>(
        tokens, token_count, query, qmask, B, Dp, T, Tq, dims, DC, out);
  return (int)cudaGetLastError();
}

extern "C" const char* maxsim_exact_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
