// K9 kmeans_step: one Lloyd step of the seal-time k-means that builds an
// IVF index, on data f32 [n, dims] and centroids f32 [nlist, dims]:
//   assign[i] = argmin_c ((|x_i|^2 - 2 x_i.c) + |c|^2), lowest c on ties;
//   new[c]    = mean of the points assigned to c, or the old centroid
//               when none is.
// Out: new centroids f32 [nlist, dims] and assignments int32 [n].
//
// Replaces opensearch_tpu/ops/knn.py:_kmeans.step (its [n, nlist]
// distance matmul, jnp.argmin, and the one_hot.T @ data segment sums).
//
// What bounds it on an H100: operations. The assignment does n * nlist *
// dims multiply-adds (two f32 operations each, no FMA); the update reads
// the data once more.
//
// Design.
// - Norms: one thread per centroid sums |c|^2 in dim order.
// - Assign: one thread per point, CT = 32 centroids at a time; the CTA's
//   128 points and the centroid tile pass through shared memory in chunks
//   of DC dims (points with row stride DC + 1, centroids transposed so one
//   128-bit broadcast load feeds four centroids). Distances use the same
//   dim-order sums and one rounding per operation as the plain version,
//   so assignments equal it exactly; the scan over centroids keeps the
//   first strict minimum (jnp.argmin's lowest index).
// - Update, deterministic without float atomics, and the plain version
//   follows the same order, so both give the same bits. A stable counting
//   sort builds the CSR of points by centroid once per step: per-tile
//   centroid counts over tiles of TILE points (stored centroid-major), a
//   scan of each centroid's row of tile counts (one CTA per centroid),
//   one scan over the centroids of their counts and of their chunk counts,
//   and a scatter of the point ids that ranks the points of a tile warp by
//   warp in point order. A centroid's members, in point order, are cut
//   into chunks of CHUNK; one CTA per chunk sums its members in order
//   (SUM_ROWS rows in flight, each thread owning some dims), so a large
//   cluster spreads over many SMs; then one CTA per centroid adds its
//   chunks' sums in chunk order and divides. Each dim's sum is thus a
//   fixed two-level sequence of f32 adds, within n * 2^-24 * sum|x| of
//   the exact one, the same bits on every run.

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

namespace {

constexpr int PTS = 128;
constexpr int CT = 32;
constexpr int DC = 32;
constexpr int TILE = 1024;         // points per CSR tile, one per thread
constexpr int SCAN_THREADS = 1024;
constexpr int CHUNK = 256;         // members per partial sum
constexpr int SUM_THREADS = 128;
constexpr int SUM_ROWS = 32;       // member rows a chunk CTA loads at once

__global__ void centroid_norms(const float* __restrict__ cent, int nlist,
                               int dims, float* __restrict__ cn) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nlist) return;
  const float* row = cent + (size_t)c * dims;
  float s = 0.0f;
  for (int j = 0; j < dims; ++j) s = __fadd_rn(s, __fmul_rn(row[j], row[j]));
  cn[c] = s;
}

__global__ void __launch_bounds__(PTS)
assign_kernel(const float* __restrict__ data, const float* __restrict__ cent,
              const float* __restrict__ cn, int n, int nlist, int dims,
              int* __restrict__ assign) {
  __shared__ float xs[PTS * (DC + 1)];
  __shared__ __align__(16) float ct[DC * CT];
  const int t = threadIdx.x;
  const int p0 = blockIdx.x * PTS;
  float dn = 0.0f;
  float best = INFINITY;
  int best_c = 0;
  for (int c0 = 0; c0 < nlist; c0 += CT) {
    const int nc = min(CT, nlist - c0);
    float dots[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) dots[c] = 0.0f;
    for (int j0 = 0; j0 < dims; j0 += DC) {
      const int dc = min(DC, dims - j0);
      __syncthreads();
      for (int i = t; i < PTS * DC; i += PTS) {
        const int r = i / DC, c = i % DC;
        xs[r * (DC + 1) + c] = (c < dc && p0 + r < n)
                                   ? data[(size_t)(p0 + r) * dims + j0 + c]
                                   : 0.0f;
      }
      for (int i = t; i < CT * DC; i += PTS) {
        const int c = i / CT, k = i % CT;
        ct[c * CT + k] = (c < dc && k < nc)
                             ? cent[(size_t)(c0 + k) * dims + j0 + c]
                             : 0.0f;
      }
      __syncthreads();
      const float* row = xs + t * (DC + 1);
      for (int c = 0; c < dc; ++c) {
        const float v = row[c];
        if (c0 == 0) dn = __fadd_rn(dn, __fmul_rn(v, v));
        const float4* c4 = reinterpret_cast<const float4*>(ct + c * CT);
#pragma unroll
        for (int g = 0; g < CT / 4; ++g) {
          const float4 w = c4[g];
          dots[4 * g] = __fadd_rn(dots[4 * g], __fmul_rn(v, w.x));
          dots[4 * g + 1] = __fadd_rn(dots[4 * g + 1], __fmul_rn(v, w.y));
          dots[4 * g + 2] = __fadd_rn(dots[4 * g + 2], __fmul_rn(v, w.z));
          dots[4 * g + 3] = __fadd_rn(dots[4 * g + 3], __fmul_rn(v, w.w));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < CT; ++k) {
      if (k < nc) {
        const float d = __fadd_rn(__fsub_rn(dn, __fmul_rn(2.0f, dots[k])),
                                  cn[c0 + k]);
        if (d < best) {
          best = d;
          best_c = c0 + k;
        }
      }
    }
  }
  if (p0 + t < n) assign[p0 + t] = best_c;
}


// hist[c * n_tiles + tile] = the points of `tile` assigned to c
__global__ void __launch_bounds__(TILE)
tile_hist_kernel(const int* __restrict__ assign, int n, int nlist,
                 int n_tiles, int* __restrict__ hist) {
  extern __shared__ int cnt[];  // [nlist]
  for (int c = threadIdx.x; c < nlist; c += TILE) cnt[c] = 0;
  __syncthreads();
  const int p = blockIdx.x * TILE + threadIdx.x;
  if (p < n) atomicAdd(&cnt[assign[p]], 1);
  __syncthreads();
  for (int c = threadIdx.x; c < nlist; c += TILE)
    hist[(size_t)c * n_tiles + blockIdx.x] = cnt[c];
}

// inclusive scan of one value per thread over the CTA; *total gets the
// CTA's sum
__device__ __forceinline__ int block_scan(int v, int* warp_tot, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    int w = lane < nw ? warp_tot[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) warp_tot[lane] = w;
  }
  __syncthreads();
  const int out = incl + (warp > 0 ? warp_tot[warp - 1] : 0);
  *total = warp_tot[(blockDim.x >> 5) - 1];
  __syncthreads();
  return out;
}

// one CTA per centroid: its row of tile counts becomes the exclusive
// prefix within the centroid's members; count[c] their number
__global__ void __launch_bounds__(SCAN_THREADS)
row_scan_kernel(int* __restrict__ hist, int n_tiles, int* __restrict__ count) {
  __shared__ int warp_tot[32];
  int* row = hist + (size_t)blockIdx.x * n_tiles;
  int carry = 0;
  for (int i0 = 0; i0 < n_tiles; i0 += SCAN_THREADS) {
    const int i = i0 + threadIdx.x;
    const int v = i < n_tiles ? row[i] : 0;
    int total;
    const int incl = block_scan(v, warp_tot, &total);
    if (i < n_tiles) row[i] = carry + incl - v;
    carry += total;
  }
  if (threadIdx.x == 0) count[blockIdx.x] = carry;
}

// one CTA: start[c] = the members of the centroids before c, chunk_start[c]
// = their chunks (ceil(count / CHUNK) each); entry nlist holds the totals
__global__ void __launch_bounds__(SCAN_THREADS)
list_scan_kernel(const int* __restrict__ count, int nlist,
                 int* __restrict__ start, int* __restrict__ chunk_start) {
  __shared__ int warp_tot[32];
  int carry = 0, ccarry = 0;
  for (int c0 = 0; c0 < nlist; c0 += SCAN_THREADS) {
    const int c = c0 + threadIdx.x;
    const int v = c < nlist ? count[c] : 0;
    const int ch = (v + CHUNK - 1) / CHUNK;
    int total, ctotal;
    const int incl = block_scan(v, warp_tot, &total);
    const int cincl = block_scan(ch, warp_tot, &ctotal);
    if (c < nlist) {
      start[c] = carry + incl - v;
      chunk_start[c] = ccarry + cincl - ch;
    }
    carry += total;
    ccarry += ctotal;
  }
  if (threadIdx.x == 0) {
    start[nlist] = carry;
    chunk_start[nlist] = ccarry;
  }
}

// order[start[c] + hist[c][tile] + rank] = p for each point p of the tile,
// its rank among the tile's earlier points of centroid c: the warps of the
// tile take turns, each ranking its lanes by __match_any_sync
__global__ void __launch_bounds__(TILE)
scatter_kernel(const int* __restrict__ assign, int n, int nlist,
               int n_tiles, const int* __restrict__ hist,
               const int* __restrict__ start, int* __restrict__ order) {
  extern __shared__ int next[];  // [nlist]: the tile's next slot per c
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int c = t; c < nlist; c += TILE)
    next[c] = start[c] + hist[(size_t)c * n_tiles + blockIdx.x];
  __syncthreads();
  const int p = blockIdx.x * TILE + t;
  const int a = p < n ? assign[p] : -1;
  for (int w = 0; w < TILE / 32; ++w) {
    if (warp == w) {
      const unsigned valid = __ballot_sync(0xffffffffu, a >= 0);
      if (a >= 0) {
        const unsigned peers = __match_any_sync(valid, a);
        const int base = next[a];
        order[base + __popc(peers & ((1u << lane) - 1u))] = p;
        __syncwarp(valid);
        if (lane == __ffs(peers) - 1) next[a] = base + __popc(peers);
      }
    }
    __syncthreads();
  }
}

// one CTA per chunk g (grid: an upper bound; CTAs past the last chunk
// exit): partial[g] = the sum of the chunk's members in point order
__global__ void __launch_bounds__(SUM_THREADS)
chunk_sum_kernel(const float* __restrict__ data,
                 const int* __restrict__ order,
                 const int* __restrict__ start,
                 const int* __restrict__ chunk_start, int nlist, int dims,
                 float* __restrict__ partial) {
  __shared__ int ids[SUM_ROWS];
  const int g = blockIdx.x, t = threadIdx.x;
  if (g >= chunk_start[nlist]) return;
  int lo = 0, hi = nlist - 1;  // the last c with chunk_start[c] <= g
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (chunk_start[mid] <= g) lo = mid; else hi = mid - 1;
  }
  const int c = lo;
  const int m_lo = start[c] + (g - chunk_start[c]) * CHUNK;
  const int m_hi = min(start[c + 1], m_lo + CHUNK);
  for (int j = t; j < dims; j += SUM_THREADS)
    partial[(size_t)g * dims + j] = 0.0f;
  for (int m0 = m_lo; m0 < m_hi; m0 += SUM_ROWS) {
    const int cnt = min(SUM_ROWS, m_hi - m0);
    __syncthreads();
    if (t < cnt) ids[t] = order[m0 + t];
    __syncthreads();
    for (int j = t; j < dims; j += SUM_THREADS) {
      float v[SUM_ROWS];
#pragma unroll
      for (int u = 0; u < SUM_ROWS; ++u)
        v[u] = u < cnt ? data[(size_t)ids[u] * dims + j] : 0.0f;
      float acc = partial[(size_t)g * dims + j];
#pragma unroll
      for (int u = 0; u < SUM_ROWS; ++u)
        if (u < cnt) acc = __fadd_rn(acc, v[u]);
      partial[(size_t)g * dims + j] = acc;
    }
  }
}

// one CTA per centroid: its chunks' sums in chunk order, over its count;
// an empty centroid keeps its old value
__global__ void __launch_bounds__(SUM_THREADS)
mean_kernel(const float* __restrict__ cent,
            const float* __restrict__ partial,
            const int* __restrict__ start,
            const int* __restrict__ chunk_start, int dims,
            float* __restrict__ out) {
  const int c = blockIdx.x;
  const int total = start[c + 1] - start[c];
  const int g0 = chunk_start[c], g1 = chunk_start[c + 1];
  for (int j = threadIdx.x; j < dims; j += SUM_THREADS) {
    float acc = 0.0f;
    for (int g = g0; g < g1; ++g)
      acc = __fadd_rn(acc, partial[(size_t)g * dims + j]);
    out[(size_t)c * dims + j] = total > 0
                                    ? __fdiv_rn(acc, (float)total)
                                    : cent[(size_t)c * dims + j];
  }
}

// allow `bytes` of dynamic shared memory for `fn` past the 48 KiB default
template <typename F>
cudaError_t allow_smem(F fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// data: f32 [n, dims]; cent: f32 [nlist, dims]; scratch: cn f32 [nlist],
// hist int32 [nlist * ceil(n / TILE)], lists int32 [3 * nlist + 2] (count,
// start, chunk_start), order int32 [n], partial f32 [(ceil(n / CHUNK) +
// nlist) * dims]; out: f32 [nlist, dims]; assign: int32 [n].
extern "C" int kmeans_step(const float* data, const float* cent, int n,
                           int nlist, int dims, float* cn, int* hist,
                           int* lists, int* order, float* partial,
                           float* out, int* assign, void* stream) {
  if (n <= 0 || nlist <= 0) return 0;
  if (dims <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t list_smem = (size_t)nlist * sizeof(int);
  cudaError_t e = allow_smem(tile_hist_kernel, list_smem);
  if (e == cudaSuccess) e = allow_smem(scatter_kernel, list_smem);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (n + TILE - 1) / TILE;
  int* count = lists;
  int* start = lists + nlist;
  int* chunk_start = lists + 2 * nlist + 1;
  centroid_norms<<<(nlist + 127) / 128, 128, 0, s>>>(cent, nlist, dims, cn);
  assign_kernel<<<(n + PTS - 1) / PTS, PTS, 0, s>>>(data, cent, cn, n, nlist,
                                                    dims, assign);
  tile_hist_kernel<<<n_tiles, TILE, list_smem, s>>>(assign, n, nlist,
                                                   n_tiles, hist);
  row_scan_kernel<<<nlist, SCAN_THREADS, 0, s>>>(hist, n_tiles, count);
  list_scan_kernel<<<1, SCAN_THREADS, 0, s>>>(count, nlist, start,
                                              chunk_start);
  scatter_kernel<<<n_tiles, TILE, list_smem, s>>>(assign, n, nlist, n_tiles,
                                                 hist, start, order);
  chunk_sum_kernel<<<(n + CHUNK - 1) / CHUNK + nlist, SUM_THREADS, 0, s>>>(
      data, order, start, chunk_start, nlist, dims, partial);
  mean_kernel<<<nlist, SUM_THREADS, 0, s>>>(cent, partial, start,
                                            chunk_start, dims, out);
  return (int)cudaGetLastError();
}

extern "C" const char* kmeans_step_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
