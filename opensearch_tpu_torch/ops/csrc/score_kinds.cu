// K19 score_kinds: the remaining elementwise scoring kinds of a plan, one
// C entry (and one kernel) per kind, each for B queries over a segment's
// Dp docs:
//  - terms_set_scores: the per-lane hit count and child-score sum of a
//    terms_set's term clauses in child order, then its match rule (the
//    minimum from a numeric column, where docs without one never match,
//    or from the per-query parameter);
//  - distance_feature_scores: boost * pivot / (pivot + |v - origin|) on a
//    numeric or date column;
//  - boosting_scores: the positive clause's score, times negative_boost
//    where the negative clause matches;
//  - script_score_wrap: where(child matches, script value * boost, 0).
//
// Replaces opensearch_tpu/search/plan_eval.py:392-411 (terms_set),
// :413-418 (distance_feature), :463-467 (boosting) and :246-259 (the
// script_score wrap; the script itself is torch ops, as the reference's
// is jnp ops).
//
// What bounds it on an H100: bytes. Each kind reads its planes once (a
// score is 4 B, a match 1 B a (query, doc)) and writes a score and a
// match; a column is read once and then from L2 for the other queries.
//
// Design. One thread per (query b, doc d), blockIdx.y = b. Each operation
// is the reference's, in its order, one rounding each (--fmad=false), so
// the plain versions in ops/scoring.py hold every kind bit for bit.
// terms_set takes at most TERMS_SET_MAX children a launch, their
// pointers by value; a longer list chains launches that carry the running
// sum and hit count in the outputs, and the last one applies the match
// rule.

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

constexpr int TERMS_SET_MAX = 32;

// terms_set's child planes, by value: outside the unnamed namespace, so
// that the C entry that takes them keeps external linkage
struct TermsSetChildren {
  const float* scores[TERMS_SET_MAX];          // [B, Dp] each
  const unsigned char* matches[TERMS_SET_MAX];
};

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
terms_set_kernel(const TermsSetChildren ch, int n, int first, int last,
                 const float* __restrict__ msm_value,
                 const unsigned char* __restrict__ msm_exists,
                 const int* __restrict__ msm_param,
                 const float* __restrict__ boost, int Dp,
                 float* __restrict__ out_s, int* __restrict__ hits_acc,
                 unsigned char* __restrict__ out_m) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= Dp) return;
  const size_t i = (size_t)b * Dp + d;
  float s = first ? 0.0f : out_s[i];
  int hits = first ? 0 : hits_acc[i];
  for (int j = 0; j < n; ++j) {
    hits += ch.matches[j][i] != 0 ? 1 : 0;
    s = s + ch.scores[j][i];
  }
  if (!last) {
    out_s[i] = s;
    hits_acc[i] = hits;
    return;
  }
  bool match;
  if (msm_value != nullptr) {
    const int msm = (int)msm_value[d];
    match = msm_exists[d] != 0 && hits >= max(msm, 1);
  } else {
    match = hits >= max(msm_param[b], 1);
  }
  out_s[i] = match ? s * boost[b] : 0.0f;
  out_m[i] = match ? 1 : 0;
}

__global__ void __launch_bounds__(THREADS)
distance_feature_kernel(const float* __restrict__ value,
                        const unsigned char* __restrict__ exists,
                        const float* __restrict__ origin,
                        const float* __restrict__ pivot,
                        const float* __restrict__ boost, int Dp,
                        float* __restrict__ out_s,
                        unsigned char* __restrict__ out_m) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= Dp) return;
  const size_t i = (size_t)b * Dp + d;
  const float dist = fabsf(value[d] - origin[b]);
  const float score = boost[b] * pivot[b] / (pivot[b] + dist);
  const bool e = exists[d] != 0;
  out_s[i] = e ? score : 0.0f;
  out_m[i] = e ? 1 : 0;
}

__global__ void __launch_bounds__(THREADS)
boosting_kernel(const float* __restrict__ pos_s,
                const unsigned char* __restrict__ pos_m,
                const unsigned char* __restrict__ neg_m,
                const float* __restrict__ nb,
                const float* __restrict__ boost, int Dp,
                float* __restrict__ out_s, unsigned char* __restrict__ out_m) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= Dp) return;
  const size_t i = (size_t)b * Dp + d;
  const float score = pos_s[i] * (neg_m[i] != 0 ? nb[b] : 1.0f);
  const bool m = pos_m[i] != 0;
  out_s[i] = m ? score * boost[b] : 0.0f;
  out_m[i] = m ? 1 : 0;
}

__global__ void __launch_bounds__(THREADS)
script_wrap_kernel(const unsigned char* __restrict__ child_m,
                   const float* __restrict__ value,
                   const float* __restrict__ boost, int Dp,
                   float* __restrict__ out_s,
                   unsigned char* __restrict__ out_m) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= Dp) return;
  const size_t i = (size_t)b * Dp + d;
  const bool m = child_m[i] != 0;
  out_s[i] = m ? value[i] * boost[b] : 0.0f;
  out_m[i] = m ? 1 : 0;
}

dim3 grid_of(int B, int Dp) {
  return dim3((Dp + THREADS - 1) / THREADS, B);
}

}  // namespace

// children: n <= TERMS_SET_MAX [B, Dp] score / match planes; `first`
// starts the sum at 0, `last` applies the match rule (msm_value / msm_exists [Dp]
// from a column, or msm_param int32 [B] when msm_value is null); boost f32
// [B]; out_s f32, hits_acc int32 (read and written only between chained
// launches) and out_m bool [B, Dp].
extern "C" int terms_set_scores(TermsSetChildren ch, int n, int first,
                                int last,
                                const float* msm_value,
                                const unsigned char* msm_exists,
                                const int* msm_param, const float* boost,
                                int B, int Dp, float* out_s, int* hits_acc,
                                unsigned char* out_m, void* stream) {
  if (n < 0 || n > TERMS_SET_MAX) return (int)cudaErrorInvalidValue;
  if (B == 0 || Dp == 0) return 0;
  terms_set_kernel<<<grid_of(B, Dp), THREADS, 0, (cudaStream_t)stream>>>(
      ch, n, first, last, msm_value, msm_exists, msm_param, boost, Dp,
      out_s, hits_acc, out_m);
  return (int)cudaGetLastError();
}

// value f32 / exists bool [Dp]; origin, pivot, boost f32 [B]; out [B, Dp].
extern "C" int distance_feature_scores(const float* value,
                                       const unsigned char* exists,
                                       const float* origin,
                                       const float* pivot,
                                       const float* boost, int B, int Dp,
                                       float* out_s, unsigned char* out_m,
                                       void* stream) {
  if (B == 0 || Dp == 0) return 0;
  distance_feature_kernel<<<grid_of(B, Dp), THREADS, 0,
                            (cudaStream_t)stream>>>(
      value, exists, origin, pivot, boost, Dp, out_s, out_m);
  return (int)cudaGetLastError();
}

// pos_s f32, pos_m / neg_m bool [B, Dp]; nb, boost f32 [B].
extern "C" int boosting_scores(const float* pos_s,
                               const unsigned char* pos_m,
                               const unsigned char* neg_m, const float* nb,
                               const float* boost, int B, int Dp,
                               float* out_s, unsigned char* out_m,
                               void* stream) {
  if (B == 0 || Dp == 0) return 0;
  boosting_kernel<<<grid_of(B, Dp), THREADS, 0, (cudaStream_t)stream>>>(
      pos_s, pos_m, neg_m, nb, boost, Dp, out_s, out_m);
  return (int)cudaGetLastError();
}

// child_m bool, value f32 [B, Dp] (the script's plane); boost f32 [B].
extern "C" int script_score_wrap(const unsigned char* child_m,
                                 const float* value, const float* boost,
                                 int B, int Dp, float* out_s,
                                 unsigned char* out_m, void* stream) {
  if (B == 0 || Dp == 0) return 0;
  script_wrap_kernel<<<grid_of(B, Dp), THREADS, 0, (cudaStream_t)stream>>>(
      child_m, value, boost, Dp, out_s, out_m);
  return (int)cudaGetLastError();
}

extern "C" const char* score_kinds_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
