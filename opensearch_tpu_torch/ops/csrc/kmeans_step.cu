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
// dims multiply-adds; the bit-equality contract rounds each multiply and
// each add on its own (no FMA), so it is 2 n nlist dims FP32 instructions
// (60.6 G at 1,183,514 x 100, nlist 256: 1.81 ms at 132 SMs x 128 lanes
// and 1,980 MHz), above the data's bytes (0.14 ms). The update reads the
// data once more.
//
// Design.
// - prep_centroids: one thread per centroid sums |c|^2 in dim order and
//   writes the centroid transposed into blocks of CB = 256 centroids,
//   ct [ceil(nlist / CB)][dims4][CB] (zero past nlist and dims), so one
//   16-byte shared read feeds four centroids.
// - Assign: persistent CTAs of 384 threads (one an SM: 12 warps) walk
//   tiles of PT = 96 points. A thread holds a register tile of 4 points x
//   16 centroids (its centroids 4 cg + 64 h + e, e < 4, h < 4: a quarter
//   warp's 16-byte reads are consecutive, no bank conflict). Centroids
//   resident: where all of ct and the norms fit in shared memory beside
//   the ring, the CTA copies them once and reads every block of CB
//   centroids from there; otherwise each block's dims chunk rides the ring
//   with the points' (a tiled path over centroid groups of CB; on the
//   H100 at 1,183,514 x 100, nlist 256, where both run, it took 2.75 ms
//   to the resident path's 2.62). Points read once per block of CB
//   centroids (once per step at nlist <= 256): each tile's dims, in
//   chunks of DC = 64, come through a 2-stage
//   cp.async ring (16-byte copies where dims % 4 == 0 and the data is
//   16-byte aligned, 4-byte copies otherwise), the next chunk in flight
//   while this one computes; one __syncthreads a chunk orders the ring.
//   (On the H100 at 1,183,514 x 100, nlist 256: 256 threads and 32-dim
//   chunks took 2.96 ms, 256 and 64 2.84, 384 and 32 2.74, 384 and 64
//   2.63.)
// - |x|^2 once a point: each thread's point slots are rotated so that its
//   slot 0 is point (cg & 3) of its group, which it sums; the others read
//   it by a shuffle at the block's end.
// - Distances exactly as the plain version rounds them:
//   (dn - 2 dot) + cn[c], every dot and norm summed in dim order from 0 by
//   __fmul_rn / __fadd_rn. A thread scans its centroids in ascending
//   order with a strict <, from "none" (d = +inf, c = INT_MAX): a NaN or
//   +inf distance is never taken. Threads combine by shuffles as the
//   lexicographic minimum of (d, c), "none" losing to every candidate, so
//   the result is the ascending scan's over all centroids; a point with
//   no finite distance gets centroid 0.
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
#include <climits>
#include <cstdint>
#include <math.h>

#include "cp_async.cuh"

namespace {

constexpr int NT = 384;            // threads of an assignment CTA
constexpr int RP = 4;              // points a thread
constexpr int RC = 16;             // centroids a thread
constexpr int CG = 16;             // centroid groups: the half-warp's lanes
constexpr int PG = NT / CG;        // point groups
constexpr int PT = PG * RP;        // points a tile
constexpr int CB = CG * RC;        // centroids a block
constexpr int DC = 64;             // dims a chunk
constexpr int XS = DC + 4;         // floats between staged point rows
constexpr int STAGES = 2;
constexpr int SMEM_LIMIT = 232448;
constexpr int TILE = 1024;         // points per CSR tile, one per thread
constexpr int SCAN_THREADS = 1024;
constexpr int CHUNK = 256;         // members per partial sum
constexpr int SUM_THREADS = 128;
constexpr int SUM_ROWS = 32;       // member rows a chunk CTA loads at once
static_assert(PG * CG == NT && CG == 16 && RP == 4 && RC == 16,
              "a half-warp holds one point group's 16 centroid groups");

// |c|^2 in dim order into cn [nblk * CB] (0 past nlist), and the centroids
// transposed into ct [nblk][dims4][CB] (0 past nlist and dims)
__global__ void prep_centroids(const float* __restrict__ cent, int nlist,
                               int dims, int dims4, int nblk,
                               float* __restrict__ ct,
                               float* __restrict__ cn) {
  const int total = nblk * CB;
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < total;
       c += gridDim.x * blockDim.x) {
    float* col = ct + (size_t)(c / CB) * dims4 * CB + c % CB;
    float s = 0.0f;
    int j = 0;
    if (c < nlist) {
      const float* row = cent + (size_t)c * dims;
      for (; j < dims; ++j) {
        const float v = row[j];
        s = __fadd_rn(s, __fmul_rn(v, v));
        col[(size_t)j * CB] = v;
      }
    }
    for (; j < dims4; ++j) col[(size_t)j * CB] = 0.0f;
    cn[c] = s;
  }
}

// (d, c) beats (bd, bc): the lexicographic order, "none" = (+inf, INT_MAX)
__device__ __forceinline__ void take_min(float& bd, int& bc, float d, int c) {
  if (d < bd || (d == bd && c < bc)) {
    bd = d;
    bc = c;
  }
}

// the per-point best over the 16 lanes of a half-warp; slot i of lane cg
// holds point (cg + i) & 3 of the group. Returns point (cg & 3)'s centroid.
__device__ __forceinline__ int combine_lanes(float (&bd)[RP], int (&bc)[RP],
                                             int cg) {
  // lanes cg, cg ^ 4, cg ^ 8, cg ^ 12 share their rotation
#pragma unroll
  for (int i = 0; i < RP; ++i) {
#pragma unroll
    for (int o = 4; o <= 8; o <<= 1)
      take_min(bd[i], bc[i], __shfl_xor_sync(0xffffffffu, bd[i], o),
               __shfl_xor_sync(0xffffffffu, bc[i], o));
  }
  // un-rotate: ud[p] is point p's, from slot (p - cg) & 3
  float ud[RP];
  int uc[RP];
#pragma unroll
  for (int p = 0; p < RP; ++p) {
    const int s = (p - cg) & 3;
    ud[p] = s == 0 ? bd[0] : s == 1 ? bd[1] : s == 2 ? bd[2] : bd[3];
    uc[p] = s == 0 ? bc[0] : s == 1 ? bc[1] : s == 2 ? bc[2] : bc[3];
  }
#pragma unroll
  for (int p = 0; p < RP; ++p) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1)
      take_min(ud[p], uc[p], __shfl_xor_sync(0xffffffffu, ud[p], o),
               __shfl_xor_sync(0xffffffffu, uc[p], o));
  }
  const int p = cg & 3;
  const int c = p == 0 ? uc[0] : p == 1 ? uc[1] : p == 2 ? uc[2] : uc[3];
  return c == INT_MAX ? 0 : c;
}

// the dims [c, c + 4) of a thread's points (x4) against its centroids:
// crow is the centroid row of dim c (stride CB), at the thread's 4 cg
template <bool FIRST>
__device__ __forceinline__ void quad_step(const float4 (&x4)[RP],
                                          const float* crow,
                                          float (&acc)[RP][RC], float& dn) {
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    float4 w[RC / 4];
#pragma unroll
    for (int h = 0; h < RC / 4; ++h)
      w[h] = *reinterpret_cast<const float4*>(crow + d * CB + 64 * h);
#pragma unroll
    for (int i = 0; i < RP; ++i) {
      const float x = lane4(x4[i], d);
#pragma unroll
      for (int h = 0; h < RC / 4; ++h) {
        acc[i][4 * h] = __fadd_rn(acc[i][4 * h], __fmul_rn(x, w[h].x));
        acc[i][4 * h + 1] = __fadd_rn(acc[i][4 * h + 1], __fmul_rn(x, w[h].y));
        acc[i][4 * h + 2] = __fadd_rn(acc[i][4 * h + 2], __fmul_rn(x, w[h].z));
        acc[i][4 * h + 3] = __fadd_rn(acc[i][4 * h + 3], __fmul_rn(x, w[h].w));
      }
    }
    if (FIRST) {
      const float x = lane4(x4[0], d);
      dn = __fadd_rn(dn, __fmul_rn(x, x));
    }
  }
}

// one dim (a chunk's last dims % 4)
template <bool FIRST>
__device__ __forceinline__ void single_step(const float (&x)[RP],
                                            const float* crow,
                                            float (&acc)[RP][RC], float& dn) {
  float4 w[RC / 4];
#pragma unroll
  for (int h = 0; h < RC / 4; ++h)
    w[h] = *reinterpret_cast<const float4*>(crow + 64 * h);
#pragma unroll
  for (int i = 0; i < RP; ++i) {
#pragma unroll
    for (int h = 0; h < RC / 4; ++h) {
      const float xi = x[i];
      acc[i][4 * h] = __fadd_rn(acc[i][4 * h], __fmul_rn(xi, w[h].x));
      acc[i][4 * h + 1] = __fadd_rn(acc[i][4 * h + 1], __fmul_rn(xi, w[h].y));
      acc[i][4 * h + 2] = __fadd_rn(acc[i][4 * h + 2], __fmul_rn(xi, w[h].z));
      acc[i][4 * h + 3] = __fadd_rn(acc[i][4 * h + 3], __fmul_rn(xi, w[h].w));
    }
  }
  if (FIRST) dn = __fadd_rn(dn, __fmul_rn(x[0], x[0]));
}

// the chunk's dc dims of the thread's points (rows xoff of st) against the
// block's centroids (cs: dim rows of CB floats, at the chunk's first dim)
template <bool FIRST>
__device__ __forceinline__ void chunk_dots(const float* st,
                                           const int (&xoff)[RP],
                                           const float* cs, int dc,
                                           float (&acc)[RP][RC], float& dn) {
  if (dc == DC) {
#pragma unroll 2
    for (int c = 0; c < DC; c += 4) {
      float4 x4[RP];
#pragma unroll
      for (int i = 0; i < RP; ++i)
        x4[i] = *reinterpret_cast<const float4*>(st + xoff[i] + c);
      quad_step<FIRST>(x4, cs + c * CB, acc, dn);
    }
    return;
  }
  int c = 0;
  for (; c + 4 <= dc; c += 4) {
    float4 x4[RP];
#pragma unroll
    for (int i = 0; i < RP; ++i)
      x4[i] = *reinterpret_cast<const float4*>(st + xoff[i] + c);
    quad_step<FIRST>(x4, cs + c * CB, acc, dn);
  }
  for (; c < dc; ++c) {
    float x[RP];
#pragma unroll
    for (int i = 0; i < RP; ++i) x[i] = st[xoff[i] + c];
    single_step<FIRST>(x, cs + c * CB, acc, dn);
  }
}

// shared floats of the assignment: the ring (points, and in the streamed
// path each block's centroid chunk), then the resident centroids and norms
size_t assign_smem(bool resident, int nblk, int dims4) {
  const size_t stage = (size_t)PT * XS + (resident ? 0 : (size_t)DC * CB);
  const size_t res = resident ? (size_t)nblk * CB * ((size_t)dims4 + 1) : 0;
  return (STAGES * stage + res) * sizeof(float);
}

// grid: persistent CTAs over the point tiles. ct, cn: prep_centroids'.
template <bool RES>
__global__ void __launch_bounds__(NT, 1)
assign_kernel(const float* __restrict__ data, const float* __restrict__ ct,
              const float* __restrict__ cn, int n, int nlist, int dims,
              int dims4, int nblk, int vec16, int* __restrict__ assign) {
  extern __shared__ __align__(16) float smem[];
  constexpr int STAGE = PT * XS + (RES ? 0 : DC * CB);
  float* ct_s = smem + STAGES * STAGE;           // RES: [nblk][dims4][CB]
  float* cn_s = ct_s + (size_t)nblk * dims4 * CB;  // RES: [nblk * CB]
  const float* cnp = RES ? cn_s : cn;
  const int t = threadIdx.x, lane = t & 31;
  const int cg = lane & 15;
  const int pg = (t >> 5) * 2 + (lane >> 4);
  // slot i holds point pg * RP + ((cg + i) & 3): slot 0 is the point whose
  // |x|^2 this thread sums
  int xoff[RP];
#pragma unroll
  for (int i = 0; i < RP; ++i) xoff[i] = (pg * RP + ((cg + i) & 3)) * XS;
  const int n_tiles = (n + PT - 1) / PT;
  const int nc = (dims + DC - 1) / DC;
  const int per_tile = nblk * nc;
  const int first = blockIdx.x, step = gridDim.x;
  const int n_items =
      (first < n_tiles ? (n_tiles - 1 - first) / step + 1 : 0) * per_tile;

  if (RES) {  // the centroids and norms, once (they land with item 0)
    const int n4 = nblk * dims4 * CB / 4;
    for (int p = t; p < n4; p += NT) cp_async16(ct_s + 4 * p, ct + 4 * p);
    for (int p = t; p < nblk * CB / 4; p += NT)
      cp_async16(cn_s + 4 * p, cn + 4 * p);
  }

  // item m: chunk m % nc of block (m / nc) % nblk of the CTA's tile
  // m / per_tile, into stage m % STAGES
  auto load = [&](int m) {
    if (m < n_items) {
      float* st = smem + (m % STAGES) * STAGE;
      const int r0 = (first + (m / per_tile) * step) * PT;
      const int j0 = (m % nc) * DC;
      const int dc = min(DC, dims - j0);
      if (vec16) {
        for (int p = t; p < PT * (DC / 4); p += NT) {
          const int r = p / (DC / 4), c = (p % (DC / 4)) * 4;
          if (c < dc && r0 + r < n)
            cp_async16(st + r * XS + c,
                       data + (size_t)(r0 + r) * dims + j0 + c);
        }
      } else {
        for (int p = t; p < PT * DC; p += NT) {
          const int r = p / DC, c = p % DC;
          if (c < dc && r0 + r < n)
            cp_async4(st + r * XS + c,
                      data + (size_t)(r0 + r) * dims + j0 + c);
        }
      }
      if (!RES) {
        const int blk = (m / nc) % nblk;
        const int dq = min(DC, dims4 - j0);  // a multiple of 4
        const float* src = ct + ((size_t)blk * dims4 + j0) * CB;
        float* cs = st + PT * XS;
        for (int p = t; p < dq * CB / 4; p += NT)
          cp_async16(cs + 4 * p, src + 4 * p);
      }
    }
    cp_async_commit();
  };

  float acc[RP][RC];
  float dn = 0.0f;
  float dns[RP];
  float bd[RP];
  int bc[RP];
  load(0);
  for (int m = 0; m < n_items; ++m) {
    // item m has landed and every thread is done with item m - 1, whose
    // stage the next copy overwrites
    cp_async_wait<0>();
    __syncthreads();
    load(m + 1);
    const float* st = smem + (m % STAGES) * STAGE;
    const int chunk = m % nc, blk = (m / nc) % nblk;
    if (chunk == 0) {
#pragma unroll
      for (int i = 0; i < RP; ++i) {
#pragma unroll
        for (int k = 0; k < RC; ++k) acc[i][k] = 0.0f;
      }
      if (blk == 0) {
        dn = 0.0f;
#pragma unroll
        for (int i = 0; i < RP; ++i) {
          bd[i] = INFINITY;
          bc[i] = INT_MAX;
        }
      }
    }
    const int dc = min(DC, dims - chunk * DC);
    const float* cs = (RES ? ct_s + ((size_t)blk * dims4 + chunk * DC) * CB
                           : st + PT * XS) + 4 * cg;
    if (blk == 0)
      chunk_dots<true>(st, xoff, cs, dc, acc, dn);
    else
      chunk_dots<false>(st, xoff, cs, dc, acc, dn);
    if (chunk != nc - 1) continue;
    // the block's end: each slot's |x|^2 from the lane that summed it
    if (blk == 0) {
#pragma unroll
      for (int i = 0; i < RP; ++i)
        dns[i] = __shfl_sync(0xffffffffu, dn, (lane & 16) | ((cg + i) & 3));
    }
#pragma unroll
    for (int i = 0; i < RP; ++i) {
#pragma unroll
      for (int h = 0; h < RC / 4; ++h) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = blk * CB + 4 * cg + 64 * h + e;
          if (c < nlist) {
            const float d = __fadd_rn(
                __fsub_rn(dns[i], __fmul_rn(2.0f, acc[i][4 * h + e])),
                cnp[c]);
            if (d < bd[i]) {
              bd[i] = d;
              bc[i] = c;
            }
          }
        }
      }
    }
    if (blk != nblk - 1) continue;
    const int best = combine_lanes(bd, bc, cg);
    const int p = (first + (m / per_tile) * step) * PT + pg * RP + cg;
    if (cg < RP && p < n) assign[p] = best;
  }
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

// one launch of the assignment (resident or streamed centroids): a
// persistent grid of the card's resident CTAs, at most one a tile
template <bool RES>
int launch_assign(const float* data, const float* ct, const float* cn,
                  int n, int nlist, int dims, int dims4, int nblk, int vec16,
                  int* assign, cudaStream_t s) {
  static bool smem_set = false;
  cudaError_t e = cudaSuccess;
  if (!smem_set) {
    e = cudaFuncSetAttribute(assign_kernel<RES>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const size_t smem = assign_smem(RES, nblk, dims4);
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                    assign_kernel<RES>, NT,
                                                    smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (n + PT - 1) / PT;
  int grid = (per_sm > 0 ? per_sm : 1) * sms;
  grid = grid > n_tiles ? n_tiles : grid;
  assign_kernel<RES><<<grid, NT, smem, s>>>(data, ct, cn, n, nlist, dims,
                                            dims4, nblk, vec16, assign);
  return (int)cudaGetLastError();
}

}  // namespace

// data: f32 [n, dims]; cent: f32 [nlist, dims]; scratch: cn f32
// [nblk * 256] and ct f32 [nblk * dims4 * 256] (nblk = ceil(nlist / 256),
// dims4 = dims rounded up to 4: the norms and the transposed centroids),
// hist int32 [nlist * ceil(n / TILE)], lists int32 [3 * nlist + 2] (count,
// start, chunk_start), order int32 [n], partial f32 [(ceil(n / CHUNK) +
// nlist) * dims]; out: f32 [nlist, dims]; assign: int32 [n].
extern "C" int kmeans_step(const float* data, const float* cent, int n,
                           int nlist, int dims, float* cn, float* ct,
                           int* hist, int* lists, int* order, float* partial,
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
  const int nblk = (nlist + CB - 1) / CB;
  const int dims4 = (dims + 3) & ~3;
  const int vec16 =
      dims % 4 == 0 && (reinterpret_cast<uintptr_t>(data) & 15) == 0;
  const int prep = (nblk * CB + 127) / 128;
  prep_centroids<<<prep, 128, 0, s>>>(cent, nlist, dims, dims4, nblk, ct,
                                      cn);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int code =
      assign_smem(true, nblk, dims4) <= (size_t)SMEM_LIMIT
          ? launch_assign<true>(data, ct, cn, n, nlist, dims, dims4, nblk,
                                vec16, assign, s)
          : launch_assign<false>(data, ct, cn, n, nlist, dims, dims4, nblk,
                                 vec16, assign, s);
  if (code != 0) return code;
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
