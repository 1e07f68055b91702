// K13 sort_key: the dense per-doc f32 key of a field sort, out f32 [Dp]
// (higher sorts first; MISSING_KEY = -1e30 where the doc has no value).
//
// Replaces opensearch_tpu/search/executor.py:_build_sort_key:
// - numeric / date / boolean column: -(float)min_rank for asc,
//   (float)max_rank for desc, MISSING_KEY where `exists` is false;
// - ordinal column: the per-doc min (asc) or max (desc) of the ordinals
//   over the (doc_ids, ords) pairs, from 2^30 or -1, pairs whose doc is
//   < 0 dropped; negated for asc, MISSING_KEY where `exists` is false;
// - no column in the segment: MISSING_KEY everywhere.
//
// What bounds it on an H100: bytes. Numeric reads the rank (4 B) and the
// flag (1 B) and writes the key (4 B) per lane; ordinal also reads the
// 8-byte pairs and goes through an int32 scratch lane.
//
// Design. One thread per lane, and for the ordinal column one thread per
// pair with integer atomicMin / atomicMax into the scratch lanes (integer
// min and max give the same result in any order), then one pass that
// turns each lane into its key. Every key is one int -> f32 conversion
// and at most one negation, the plain version's arithmetic, so both are
// bit-equal.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr float MISSING_KEY = -1e30f;

// mode: 0 no column, 1 numeric asc, 2 numeric desc, 3 ordinal asc,
// 4 ordinal desc
__global__ void __launch_bounds__(THREADS)
lane_kernel(int mode, const int* __restrict__ rank,
            const uint8_t* __restrict__ exists, int Dp,
            int* __restrict__ dense, float* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < Dp;
       i += gridDim.x * blockDim.x) {
    if (mode == 0) {
      out[i] = MISSING_KEY;
    } else if (mode <= 2) {
      const float key = mode == 1 ? -(float)rank[i] : (float)rank[i];
      out[i] = exists[i] ? key : MISSING_KEY;
    } else {
      dense[i] = mode == 3 ? (1 << 30) : -1;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
pairs_kernel(int desc, const int* __restrict__ doc_ids,
             const int* __restrict__ ords, int NV, int Dp,
             int* __restrict__ dense) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < NV;
       j += gridDim.x * blockDim.x) {
    const int d = doc_ids[j];
    if (d < 0 || d >= Dp) continue;
    if (desc)
      atomicMax(&dense[d], ords[j]);
    else
      atomicMin(&dense[d], ords[j]);
  }
}

__global__ void __launch_bounds__(THREADS)
ordinal_key_kernel(int desc, const int* __restrict__ dense,
                   const uint8_t* __restrict__ exists, int Dp,
                   float* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < Dp;
       i += gridDim.x * blockDim.x) {
    const float key = desc ? (float)dense[i] : -(float)dense[i];
    out[i] = exists[i] ? key : MISSING_KEY;
  }
}

int grid_for(int n) {
  int g = (n + THREADS * 4 - 1) / (THREADS * 4);
  if (g < 1) g = 1;
  if (g > 4096) g = 4096;
  return g;
}

}  // namespace

// out f32 [Dp]. Numeric modes read `rank` (min_rank for asc, max_rank for
// desc) and `exists`; ordinal modes read the NV pairs and `exists` and use
// `dense` (int32 [Dp] scratch).
extern "C" int sort_key(int mode, const int* rank, const uint8_t* exists,
                        const int* doc_ids, const int* ords, int NV, int Dp,
                        int* dense, float* out, void* stream) {
  if (Dp <= 0) return 0;
  if (mode < 0 || mode > 4 || NV < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  lane_kernel<<<grid_for(Dp), THREADS, 0, st>>>(mode, rank, exists, Dp,
                                                dense, out);
  if (mode >= 3) {
    const int desc = mode == 4;
    if (NV > 0)
      pairs_kernel<<<grid_for(NV), THREADS, 0, st>>>(desc, doc_ids, ords, NV,
                                                     Dp, dense);
    ordinal_key_kernel<<<grid_for(Dp), THREADS, 0, st>>>(desc, dense, exists,
                                                         Dp, out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sort_key_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
