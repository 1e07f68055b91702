// K18 function_score: the scores and matches of one function_score node
// for B queries over a segment's Dp docs, from its child's scores and
// matches, each function's filter mask and value source, the score_mode
// combine, max_boost, the boost_mode, min_score and boost.
//
// Replaces opensearch_tpu/search/plan_eval.py:261-390 (the
// `function_score` kind of _eval_plan, with _apply_modifier).
//
// What bounds it on an H100: bytes. Per (query, doc) it reads the child's
// score and match (5 B), a byte per filtered function and four per
// script plane, and writes a score and a match (5 B); each numeric
// column (value and exists, 5 B a doc) is read once from device memory
// and then from L2 for the other queries. A few transcendental functions
// per element stay far below the card's f32 rate.
//
// Design. One thread per (query b, doc d): blockIdx.y is b, the x
// dimension walks d, so neighbouring threads read neighbouring bytes of
// every plane and column. The function list, its kinds, modifiers,
// column and plane pointers and the modes travel by value in one small
// descriptor (kernel parameter space, no upload); per-query parameters
// are an f32 [B, P] table: boost, max_boost, min_score, then seven slots
// per function (weight, factor, missing, origin, scale, offset, decay).
// Every operation is the reference's, in its order, one rounding each
// (the library builds with --fmad=false): log10 is log(x) times the f32
// constant 1/ln 10, as jnp.log10 is; max and min propagate NaN, as XLA's
// and torch's do; the random hash wraps in uint32.

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

constexpr int FUNCTION_SCORE_MAX_FUNCTIONS = 16;

// the descriptor, by value: outside the unnamed namespace, so that the C
// entry that takes it keeps external linkage
struct FunctionScoreFn {
  int kind, modifier, decay, has_weight, has_column;
  unsigned int seed;
  const unsigned char* filter;  // [B, Dp] or null (applies everywhere)
  const float* value;           // [Dp] column (fvf, decay)
  const unsigned char* exists;  // [Dp]
  const float* plane;           // [B, Dp] (script)
};

struct FunctionScoreDesc {
  int n_fn, score_mode, boost_mode, has_min_score;
  FunctionScoreFn fn[FUNCTION_SCORE_MAX_FUNCTIONS];
};

namespace {

constexpr int THREADS = 256;

enum Kind { WEIGHT = 0, FVF = 1, RANDOM = 2, SCRIPT = 3, DECAY = 4 };
enum ScoreMode { S_MULTIPLY = 0, S_SUM = 1, S_AVG = 2, S_MAX = 3, S_MIN = 4,
                 S_FIRST = 5 };
enum BoostMode { B_MULTIPLY = 0, B_REPLACE = 1, B_SUM = 2, B_AVG = 3,
                 B_MAX = 4, B_MIN = 5 };
enum Decay { GAUSS = 0, EXP = 1, LINEAR = 2 };
// modifiers: none, log, log1p, log2p, ln, ln1p, ln2p, square, sqrt,
// reciprocal
constexpr float ONE_OVER_LN10 = 0.4342944819032518f;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000)
                                : (a > b ? a : b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000)
                                : (a < b ? a : b);
}

__device__ __forceinline__ float modify(float v, int modifier) {
  switch (modifier) {
    case 1: return logf(v) * ONE_OVER_LN10;
    case 2: return logf(v + 1.0f) * ONE_OVER_LN10;
    case 3: return logf(v + 2.0f) * ONE_OVER_LN10;
    case 4: return logf(v);
    case 5: return log1pf(v);
    case 6: return logf(v + 2.0f);
    case 7: return v * v;
    case 8: return sqrtf(v);
    case 9: return 1.0f / v;
    default: return v;
  }
}

__global__ void __launch_bounds__(THREADS)
function_score_kernel(const float* __restrict__ child_s,
                      const unsigned char* __restrict__ child_m,
                      const float* __restrict__ params, int P, int Dp,
                      const FunctionScoreDesc desc,
                      float* __restrict__ out_s,
                      unsigned char* __restrict__ out_m) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= Dp) return;
  const size_t i = (size_t)b * Dp + d;
  const float* pr = params + (size_t)b * P;
  const float cs = child_s[i];
  const bool cm = child_m[i] != 0;
  const int mode = desc.score_mode;
  const float ident = mode == S_MULTIPLY ? 1.0f : 0.0f;

  float prod = 1.0f, sum = 0.0f, cnt = 0.0f;
  float mx = -INFINITY, mn = INFINITY, first = __int_as_float(0x7fc00000);
  bool any = false, found = false;
  for (int j = 0; j < desc.n_fn; ++j) {
    const FunctionScoreFn& f = desc.fn[j];
    const float* fp = pr + 3 + 7 * j;
    const float w = fp[0];
    const bool m = f.filter == nullptr || f.filter[i] != 0;
    float value;
    bool weigh = f.kind != WEIGHT && f.has_weight;
    switch (f.kind) {
      case WEIGHT:
        value = w;
        break;
      case FVF: {
        const float x = (f.has_column && f.exists[d]) ? f.value[d] : fp[2];
        value = modify(x * fp[1], f.modifier);
        break;
      }
      case RANDOM: {
        uint32_t h = (uint32_t)d * 2654435761u + f.seed;
        h = h ^ (h >> 16);
        h = h * 2246822519u;
        h = h ^ (h >> 13);
        value = (float)(h % (1u << 24)) / 16777216.0f;
        break;
      }
      case SCRIPT:
        value = f.plane[i];
        break;
      default: {  // DECAY
        if (!f.has_column) {  // no values in this segment: no decay
          value = 1.0f;
          weigh = false;
          break;
        }
        const float origin = fp[3], scale = fp[4], offset = fp[5],
                    decay = fp[6];
        const float dist = nan_max(fabsf(f.value[d] - origin) - offset,
                                   0.0f);
        if (f.decay == GAUSS) {
          const float sigma2 = (-(scale * scale)) / (2.0f * logf(decay));
          value = expf((-(dist * dist)) / (2.0f * sigma2));
        } else if (f.decay == EXP) {
          const float lam = logf(decay) / scale;
          value = expf(lam * dist);
        } else {
          const float s = scale / (1.0f - decay);
          value = nan_max((s - dist) / s, 0.0f);
        }
        if (!f.exists[d]) value = 1.0f;
      }
    }
    if (weigh) value = value * w;
    const float stacked = (m && !isnan(value)) ? value : ident;
    prod = prod * stacked;
    sum = sum + stacked;
    cnt = cnt + (m ? 1.0f : 0.0f);
    mx = nan_max(mx, m ? value : -INFINITY);
    mn = nan_min(mn, m ? value : INFINITY);
    if (m && !found) {
      first = value;
      found = true;
    }
    any = any || m;
  }

  float combined;
  if (desc.n_fn == 0) {
    combined = 1.0f;
  } else {
    switch (mode) {
      case S_MULTIPLY: combined = prod; break;
      case S_SUM: combined = sum; break;
      case S_AVG: combined = sum / fmaxf(cnt, 1.0f); break;
      case S_MAX: combined = any ? mx : 1.0f; break;
      case S_MIN: combined = any ? mn : 1.0f; break;
      default: combined = isnan(first) ? 1.0f : first;
    }
    combined = any ? combined : 1.0f;
    combined = nan_min(combined, pr[1]);
  }

  float score;
  switch (desc.boost_mode) {
    case B_MULTIPLY: score = cs * combined; break;
    case B_REPLACE: score = combined; break;
    case B_SUM: score = cs + combined; break;
    case B_AVG: score = (cs + combined) / 2.0f; break;
    case B_MAX: score = nan_max(cs, combined); break;
    default: score = nan_min(cs, combined);
  }
  const bool match = cm && (!desc.has_min_score || score >= pr[2]);
  out_s[i] = match ? score * pr[0] : 0.0f;
  out_m[i] = match ? 1 : 0;
}

}  // namespace

// child_s f32 [B, Dp], child_m bool [B, Dp], params f32 [B, P]; out_s f32
// [B, Dp], out_m bool [B, Dp]. desc: the function list and the modes.
extern "C" int function_score(const float* child_s,
                              const unsigned char* child_m,
                              const float* params, int B, int P, int Dp,
                              FunctionScoreDesc desc, float* out_s,
                              unsigned char* out_m, void* stream) {
  if (desc.n_fn < 0 || desc.n_fn > FUNCTION_SCORE_MAX_FUNCTIONS)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Dp == 0) return 0;
  dim3 grid((Dp + THREADS - 1) / THREADS, B);
  function_score_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      child_s, child_m, params, P, Dp, desc, out_s, out_m);
  return (int)cudaGetLastError();
}

extern "C" const char* function_score_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
