// K12 hybrid_window: the fused hybrid query phase's per-sub-query window
// bounds and union total. For n_sub sub-queries of B queries it reads K3's
// packed rows (f32 [n_sub, B, 2k+1]: k scores | k doc ids as int32 bits |
// total) and the sub-queries' eligibility masks (u8 [n_sub, B, Dp]), and
// writes one row per query, f32 [B, n_sub * (2k + 4) + 1]:
//   per sub-query [k scores | k ids | count | min | max | sum of squares]
//   over the valid window lanes (score > -inf; count as int32 bits, the
//   sum of squares in lane order), then the union total: the number of
//   docs eligible under any sub-query (int32 bits).
// Every operation rounds once, so the kernel equals its plain PyTorch
// version (ops/hybrid.py:hybrid_window_plain) bit for bit.
//
// Replaces the bounds and the union total of
// opensearch_tpu/search/executor.py:build_hybrid_query_phase (its top-k
// is K3, run per sub-query before this kernel).
//
// What bounds it on an H100: bytes. The union pass reads the n_sub
// eligibility masks once (n_sub * B * Dp bytes); the window pass reads
// n_sub * B * (2k + 1) floats.
//
// Design.
// - window: one thread per (sub-query, query) walks its k lanes in order
//   (the window is small: k = from + size).
// - union: a grid-stride pass per query ORs the n_sub masks of each doc,
//   counts in registers, reduces each CTA by warp shuffles and adds the
//   CTA's count with one integer atomic (exact in any order); a last
//   one-thread-per-query pass stores the counts.

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

namespace {

constexpr int THREADS = 256;

__global__ void window_kernel(const float* __restrict__ rows, int n_sub,
                              int B, int k, int width,
                              float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_sub * B) return;
  const int sub = i / B, b = i % B;
  const float* r = rows + (size_t)i * (2 * k + 1);
  float* o = out + (size_t)b * width + (size_t)sub * (2 * k + 4);
  int cnt = 0;
  float mn = INFINITY, mx = -INFINITY, ssq = 0.0f;
  for (int j = 0; j < k; ++j) {
    const float s = r[j];
    o[j] = s;
    o[k + j] = r[k + j];
    if (s > -INFINITY) {
      ++cnt;
      mn = fminf(mn, s);
      mx = fmaxf(mx, s);
      ssq = __fadd_rn(ssq, __fmul_rn(s, s));
    }
  }
  o[2 * k] = __int_as_float(cnt);
  o[2 * k + 1] = mn;
  o[2 * k + 2] = mx;
  o[2 * k + 3] = ssq;
}

__global__ void __launch_bounds__(THREADS)
union_kernel(const uint8_t* __restrict__ elig, int n_sub, int B, int Dp,
             int* __restrict__ counts) {
  __shared__ int part[THREADS / 32];
  const int b = blockIdx.y;
  int cnt = 0;
  for (int d = blockIdx.x * blockDim.x + threadIdx.x; d < Dp;
       d += gridDim.x * blockDim.x) {
    bool any = false;
    for (int sub = 0; sub < n_sub; ++sub)
      any = any || elig[((size_t)sub * B + b) * Dp + d];
    cnt += any;
  }
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < THREADS / 32; ++w) total += part[w];
    if (total) atomicAdd(&counts[b], total);
  }
}

__global__ void store_union_kernel(const int* __restrict__ counts, int B,
                                   int width, float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) out[(size_t)b * width + width - 1] = __int_as_float(counts[b]);
}

}  // namespace

// rows: f32 [n_sub, B, 2k+1]; elig: u8 [n_sub, B, Dp]; counts: i32 [B]
// scratch; out: f32 [B, n_sub * (2k + 4) + 1].
extern "C" int hybrid_window(const float* rows, const uint8_t* elig,
                             int n_sub, int B, int Dp, int k, int* counts,
                             float* out, void* stream) {
  if (B <= 0) return 0;
  if (n_sub <= 0 || k < 0 || Dp <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int width = n_sub * (2 * k + 4) + 1;
  cudaError_t e = cudaMemsetAsync(counts, 0, (size_t)B * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  window_kernel<<<(n_sub * B + 127) / 128, 128, 0, st>>>(rows, n_sub, B, k,
                                                         width, out);
  int chunks = (Dp + THREADS * 8 - 1) / (THREADS * 8);
  if (chunks > 256) chunks = 256;
  union_kernel<<<dim3(chunks, B), THREADS, 0, st>>>(elig, n_sub, B, Dp,
                                                    counts);
  store_union_kernel<<<(B + 127) / 128, 128, 0, st>>>(counts, B, width, out);
  return (int)cudaGetLastError();
}

extern "C" const char* hybrid_window_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
