// K22 nested_join: the block join of a `nested` query, for B queries over
// a segment's Dp rows.
//
// Replaces opensearch_tpu/search/plan_eval.py:100-129 (the `nested`
// branch of _eval_plan), which scatters the child plan's verdicts up to
// each nested row's root with .at[idx].add / max / min.
//
// Inputs: the child plan's scores f32 / matches bool [B, Dp]; the image's
// live bool [Dp], nested_path int32 [Dp], and the static per-root CSR
// child_start int32 [Dp + 1] / child_rows int32 [NCp] (a root's nested
// rows in row order, built at upload: ops/device_segment.py); per query
// path_ord int32 and boost f32 [B]. A nested row is selected where its
// child plan matches, it is live and it lies on the query's path.
// Output: root scores f32 [B, Dp] (where any row is selected, the
// combined score times the boost, else 0) and root matches bool [B, Dp].
//
// What bounds it on an H100: bytes. It reads each nested row's score and
// match once per query (5 B), writes 5 B a (query, row); the CSR is read
// once per query from L2.
//
// Design: gather instead of scatter. One thread a (query, row): a root
// walks its CSR run in row order and folds `sel ? score : 0` from 0.0f
// (sum; the count beside it for avg), or max / min from -inf / +inf, one
// rounding per operation (--fmad=false). That is the order in which the
// reference's CPU scatter applies its updates, so the kernel, its plain
// version (ops/nested.py) and the reference agree bit for bit. No atomics,
// and nothing assumes a root's rows are contiguous.

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

namespace {

constexpr int THREADS = 256;
// score modes (ops/nested.py SCORE_MODES)
constexpr int MODE_AVG = 0, MODE_SUM = 1, MODE_MAX = 2, MODE_MIN = 3,
              MODE_NONE = 4;

__global__ void __launch_bounds__(THREADS)
nested_join_kernel(const float* __restrict__ child_s,
                   const uint8_t* __restrict__ child_m,
                   const uint8_t* __restrict__ live,
                   const int* __restrict__ nested_path,
                   const int* __restrict__ child_start,
                   const int* __restrict__ child_rows,
                   const int* __restrict__ path_ord, int mode, int Dp,
                   const float* __restrict__ boost,
                   float* __restrict__ out_s, uint8_t* __restrict__ out_m) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= Dp) return;
  const int po = path_ord[b];
  const size_t base = (size_t)b * Dp;
  float acc = mode == MODE_MAX ? -INFINITY
              : (mode == MODE_MIN ? INFINITY : 0.0f);
  float cnt = 0.0f;
  bool any = false;
  const int end = child_start[d + 1];
  for (int j = child_start[d]; j < end; ++j) {
    const int r = child_rows[j];
    const bool sel = po >= 0 && nested_path[r] == po &&
                     child_m[base + r] != 0 && live[r] != 0;
    any = any || sel;
    const float s = child_s[base + r];
    if (mode == MODE_MAX) {
      acc = fmaxf(acc, sel ? s : -INFINITY);
    } else if (mode == MODE_MIN) {
      acc = fminf(acc, sel ? s : INFINITY);
    } else if (mode != MODE_NONE) {
      acc = acc + (sel ? s : 0.0f);
      cnt = cnt + (sel ? 1.0f : 0.0f);
    }
  }
  if (mode == MODE_AVG) acc = acc / fmaxf(cnt, 1.0f);
  out_s[base + d] = (any && mode != MODE_NONE) ? acc * boost[b] : 0.0f;
  out_m[base + d] = any ? 1 : 0;
}

}  // namespace

// child_s f32 / child_m bool [B, Dp]; live bool, nested_path int32 [Dp];
// child_start int32 [Dp + 1], child_rows int32 [NCp]; path_ord int32 [B];
// mode: avg 0, sum 1, max 2, min 3, none 4; boost f32 [B]; out [B, Dp].
extern "C" int nested_join(const float* child_s, const uint8_t* child_m,
                           const uint8_t* live, const int* nested_path,
                           const int* child_start, const int* child_rows,
                           const int* path_ord, int mode, int B, int Dp,
                           const float* boost, float* out_s, uint8_t* out_m,
                           void* stream) {
  if (mode < MODE_AVG || mode > MODE_NONE) return (int)cudaErrorInvalidValue;
  if (B == 0 || Dp == 0) return 0;
  nested_join_kernel<<<dim3((Dp + THREADS - 1) / THREADS, B), THREADS, 0,
                       (cudaStream_t)stream>>>(
      child_s, child_m, live, nested_path, child_start, child_rows, path_ord,
      mode, Dp, boost, out_s, out_m);
  return (int)cudaGetLastError();
}

extern "C" const char* nested_join_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
