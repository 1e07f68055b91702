// K25 geo_scores: the elementwise geo_point and rank_feature query kinds,
// one C entry (and one kernel) per kind, each for B queries over a
// segment's Dp docs:
//  - geo_distance_scores: haversine metres from the query's point; a
//    match within the distance scores the boost;
//  - geo_bbox_scores: inside the box (the longitude range wraps across
//    the dateline where left > right); a match scores the boost;
//  - distance_feature_geo_scores: boost * pivot / (pivot + haversine);
//  - rank_feature_scores: saturation v / (v + pivot), log
//    log(scaling_factor + v), sigmoid v^e / (v^e + pivot^e) or linear v,
//    of v = max(feature, 0), times the boost.
//
// Replaces opensearch_tpu/search/plan_eval.py:420-462 (distance_feature_geo
// :420, rank_feature :428, geo_distance :443, geo_bbox :451) and
// _haversine_m :24.
//
// What bounds it on an H100: bytes. Each kind reads its dense columns once
// (lat / lon f32, exists 1 B a doc; L2-resident across the B queries) and
// writes a score and a match (5 B) a (query, doc); the haversine's four
// sines and cosines and its arcsine stay far below the FP32 rate.
//
// Design. One thread a (query, doc), blockIdx.y = b, as K19
// (score_kinds.cu). The reference's f32 constants: rad is pi / 180 rounded
// once to f32, the metres factor f32(6371008.7714 * 2.0); sin(x) ** 2 is
// the sine times itself; min(a, 1) precedes the square root. sinf, cosf,
// asinf, sqrtf, logf and powf are the CUDA math library's (no fast-math),
// the functions torch's CUDA ops call, and --fmad=false rounds each
// operation once, so the plain versions in ops/geo.py hold each kind on
// the card.

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

namespace {

constexpr int THREADS = 256;
// rank_feature functions (ops/geo.py RANK_FUNCTIONS)
constexpr int FN_SATURATION = 0, FN_LOG = 1, FN_SIGMOID = 2, FN_LINEAR = 3;

__device__ __forceinline__ float haversine(float lat, float lon, float qlat,
                                           float qlon) {
  const float rad = static_cast<float>(0.017453292519943295);
  const float earth_2r = static_cast<float>(12742017.5428);
  const float dlat = (qlat - lat) * rad;
  const float dlon = (qlon - lon) * rad;
  const float s_lat = sinf(dlat / 2.0f);
  const float s_lon = sinf(dlon / 2.0f);
  const float a = s_lat * s_lat +
                  cosf(lat * rad) * cosf(qlat * rad) * (s_lon * s_lon);
  return earth_2r * asinf(sqrtf(fminf(a, 1.0f)));
}

__global__ void __launch_bounds__(THREADS)
geo_distance_kernel(const float* __restrict__ lat,
                    const float* __restrict__ lon,
                    const uint8_t* __restrict__ exists,
                    const float* __restrict__ qlat,
                    const float* __restrict__ qlon,
                    const float* __restrict__ dist,
                    const float* __restrict__ boost, int Dp,
                    float* __restrict__ out_s,
                    uint8_t* __restrict__ out_m) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= Dp) return;
  const size_t i = (size_t)b * Dp + d;
  const float h = haversine(lat[d], lon[d], qlat[b], qlon[b]);
  const bool m = exists[d] != 0 && h <= dist[b];
  out_s[i] = m ? boost[b] : 0.0f;
  out_m[i] = m ? 1 : 0;
}

__global__ void __launch_bounds__(THREADS)
geo_bbox_kernel(const float* __restrict__ lat, const float* __restrict__ lon,
                const uint8_t* __restrict__ exists,
                const float* __restrict__ top, const float* __restrict__ left,
                const float* __restrict__ bottom,
                const float* __restrict__ right,
                const float* __restrict__ boost, int Dp,
                float* __restrict__ out_s, uint8_t* __restrict__ out_m) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= Dp) return;
  const size_t i = (size_t)b * Dp + d;
  const float la = lat[d], lo = lon[d];
  const bool in_lat = la <= top[b] && la >= bottom[b];
  const bool ge_left = lo >= left[b], le_right = lo <= right[b];
  const bool in_lon = left[b] <= right[b] ? (ge_left && le_right)
                                          : (ge_left || le_right);
  const bool m = exists[d] != 0 && in_lat && in_lon;
  out_s[i] = m ? boost[b] : 0.0f;
  out_m[i] = m ? 1 : 0;
}

__global__ void __launch_bounds__(THREADS)
distance_feature_geo_kernel(const float* __restrict__ lat,
                            const float* __restrict__ lon,
                            const uint8_t* __restrict__ exists,
                            const float* __restrict__ qlat,
                            const float* __restrict__ qlon,
                            const float* __restrict__ pivot,
                            const float* __restrict__ boost, int Dp,
                            float* __restrict__ out_s,
                            uint8_t* __restrict__ out_m) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= Dp) return;
  const size_t i = (size_t)b * Dp + d;
  const float h = haversine(lat[d], lon[d], qlat[b], qlon[b]);
  const float score = boost[b] * pivot[b] / (pivot[b] + h);
  const bool m = exists[d] != 0;
  out_s[i] = m ? score : 0.0f;
  out_m[i] = m ? 1 : 0;
}

__global__ void __launch_bounds__(THREADS)
rank_feature_kernel(const float* __restrict__ value,
                    const uint8_t* __restrict__ exists,
                    const float* __restrict__ pivot,
                    const float* __restrict__ scaling,
                    const float* __restrict__ exponent,
                    const float* __restrict__ boost, int fn, int Dp,
                    float* __restrict__ out_s, uint8_t* __restrict__ out_m) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= Dp) return;
  const size_t i = (size_t)b * Dp + d;
  const float v = fmaxf(value[d], 0.0f);
  float s;
  if (fn == FN_SATURATION) {
    s = v / (v + pivot[b]);
  } else if (fn == FN_LOG) {
    s = logf(scaling[b] + v);
  } else if (fn == FN_SIGMOID) {
    const float vp = powf(v, exponent[b]);
    s = vp / (vp + powf(pivot[b], exponent[b]));
  } else {
    s = v;
  }
  const bool m = exists[d] != 0;
  out_s[i] = m ? s * boost[b] : 0.0f;
  out_m[i] = m ? 1 : 0;
}

dim3 grid_of(int B, int Dp) {
  return dim3((Dp + THREADS - 1) / THREADS, B);
}

}  // namespace

// lat, lon f32 / exists bool [Dp]; qlat, qlon, dist, boost f32 [B];
// out [B, Dp].
extern "C" int geo_distance_scores(const float* lat, const float* lon,
                                   const uint8_t* exists, const float* qlat,
                                   const float* qlon, const float* dist,
                                   const float* boost, int B, int Dp,
                                   float* out_s, uint8_t* out_m,
                                   void* stream) {
  if (B == 0 || Dp == 0) return 0;
  geo_distance_kernel<<<grid_of(B, Dp), THREADS, 0, (cudaStream_t)stream>>>(
      lat, lon, exists, qlat, qlon, dist, boost, Dp, out_s, out_m);
  return (int)cudaGetLastError();
}

// top, left, bottom, right, boost f32 [B].
extern "C" int geo_bbox_scores(const float* lat, const float* lon,
                               const uint8_t* exists, const float* top,
                               const float* left, const float* bottom,
                               const float* right, const float* boost,
                               int B, int Dp, float* out_s, uint8_t* out_m,
                               void* stream) {
  if (B == 0 || Dp == 0) return 0;
  geo_bbox_kernel<<<grid_of(B, Dp), THREADS, 0, (cudaStream_t)stream>>>(
      lat, lon, exists, top, left, bottom, right, boost, Dp, out_s, out_m);
  return (int)cudaGetLastError();
}

// qlat, qlon, pivot (metres), boost f32 [B].
extern "C" int distance_feature_geo_scores(const float* lat, const float* lon,
                                           const uint8_t* exists,
                                           const float* qlat,
                                           const float* qlon,
                                           const float* pivot,
                                           const float* boost, int B, int Dp,
                                           float* out_s, uint8_t* out_m,
                                           void* stream) {
  if (B == 0 || Dp == 0) return 0;
  distance_feature_geo_kernel<<<grid_of(B, Dp), THREADS, 0,
                                (cudaStream_t)stream>>>(
      lat, lon, exists, qlat, qlon, pivot, boost, Dp, out_s, out_m);
  return (int)cudaGetLastError();
}

// value f32 / exists bool [Dp]; pivot, scaling_factor, exponent, boost
// f32 [B]; fn: saturation 0, log 1, sigmoid 2, linear 3.
extern "C" int rank_feature_scores(const float* value, const uint8_t* exists,
                                   const float* pivot, const float* scaling,
                                   const float* exponent, const float* boost,
                                   int fn, int B, int Dp, float* out_s,
                                   uint8_t* out_m, void* stream) {
  if (fn < FN_SATURATION || fn > FN_LINEAR) return (int)cudaErrorInvalidValue;
  if (B == 0 || Dp == 0) return 0;
  rank_feature_kernel<<<grid_of(B, Dp), THREADS, 0, (cudaStream_t)stream>>>(
      value, exists, pivot, scaling, exponent, boost, fn, Dp, out_s, out_m);
  return (int)cudaGetLastError();
}

extern "C" const char* geo_scores_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
