// K24 binned_scatter: the dynamic-bin route of the aggregation engine,
// per-query binned count / sum / sumsq / min / max.
//
// Replaces the scatter route of opensearch_tpu/search/aggs/engine.py:
// _binned_sums (:1157-1167) as every kind takes it under a dynamic
// context (the per-query buckets that `nested` and `reverse_nested` hand
// their sub-aggregations), the bucket kinds' child-bin scatter-max there,
// and the geo_metric scatters (:1675-1700).
//
// Inputs: lanes int32 [B, n], each query's bin per lane (outside
// [0, total): dropped; the caller folds the eligibility into it); values
// f32 [n] (shared by the queries) or [B, n] (per query), or none (every
// lane contributes cval). Outputs [B, total]: int32 counts, f32 sums of v
// and of v * v, min (+inf where empty) and max (-inf where empty).
//
// What bounds it on an H100: bytes. Counts, min and max read the lanes
// (and values) once. A sum reads the lanes twice, writes each kept lane's
// value once into its bin's run and reads the runs once.
//
// Design. Counts, min and max are order-free and exact: integer counts
// and the order-preserving int images of the floats (f2o). Where `total`
// fits one partition pass's buckets (ops/binned.py SCATTER_MAX_BINS) each
// CTA keeps them in shared memory (shared atomics) and flushes one global
// atomic per touched (query, bin); above that, each warp makes one global
// atomic per distinct bin of its lanes.
//
// A sum needs a fixed order: a bin's kept lanes in lane order, cut into
// chunks of CHUNK by rank within the bin, each chunk summed from 0.0f in
// order, then the bin's chunks summed from 0.0f in order (K6's two levels,
// binned_reduce.cu). A lane's place in its bin's run is its rank: the
// number of earlier lanes of the query with the same bin. So the lanes
// are partitioned by bin, stably, in two reads and no sort:
//   sweep   each warp counts the buckets of its tile of consecutive lanes
//           (the warp's own counters in shared memory);
//   scans   per (query, bucket) an exclusive scan over the tiles, then
//           per query over the buckets: each tile's base per bucket;
//   scatter each warp walks its tile again in lane order, compacting the
//           kept lanes into a ring in shared memory, and ranks them 32 at
//           a time: a lane's peers of its bucket come from one ballot per
//           bucket bit, its rank from the popcount of the lower peers;
//           only kept lanes write their value, to their slot.
// Both walks load 16 bytes a thread, the next step's loads in flight.
// Above SCATTER_MAX_BINS bins the same partition runs as a stable LSD
// radix over the bin's digits (at most 11 bits each), the first pass
// dropping the dropped lanes; each pass also writes the bins, and the
// full bins' runs (start and count) come from where the last pass's bins
// change, with no atomics however skewed the bins. Then one warp takes 32
// chunks, staging 32 values of each in shared memory so that its loads
// are coalesced while each thread adds its own chunk's values one by
// one; one thread a (query, bin) adds its chunks. With --fmad=false each
// addition rounds once, so the plain version
// (ops/binned.py:dynamic_sum_plain) agrees bit for bit, and no float
// atomic makes the result depend on thread order.

#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>
#include <math.h>

namespace {

constexpr int PWARPS = 4;                 // warps a CTA of the passes
constexpr int PTHREADS = PWARPS * 32;
constexpr int THREADS = 256;              // the scans and the small kernels
constexpr int CHUNK = 256;                // ops/binned.py CSR_CHUNK
constexpr int SCAN_BLOCK = THREADS * 8;   // elements a CTA of the scans
constexpr int RING = 256;                 // the scatter's kept items a warp
constexpr int MAX_SMEM = 96 * 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NEED_CNT = 1, NEED_SUM = 2, NEED_SUMSQ = 4, NEED_MIN = 8,
              NEED_MAX = 16;

__device__ __forceinline__ int f2o(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float o2f(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// Walks items [t0, t1) of a row (t0 a multiple of 128) 128 at a time in
// lane order, calling step(x, v) with x[i], v[i] the bin and the value of
// item base + 32 i + lane (bin -1 past t1; v cval where vrow is null).
// With `vec`, 16-byte loads of whole steps, the next step's in flight
// while this one is processed; the warp's staging buffers (128 words
// each) restore the lane order. The ragged end is read word by word.
template <typename F>
__device__ __forceinline__ void walk(const int* __restrict__ brow,
                                     const float* __restrict__ vrow,
                                     long long t0, long long t1, bool vec,
                                     float cval, int* stage_b,
                                     float* stage_v, F&& step) {
  const int lane = threadIdx.x & 31;
  int x[4];
  float v[4];
  long long base = t0;
  if (vec) {
    const long long full = t0 + (t1 - t0) / 128 * 128;
    uint4 qb = make_uint4(0, 0, 0, 0), qv = qb;
    if (base < full) {
      qb = reinterpret_cast<const uint4*>(brow + base)[lane];
      if (vrow) qv = reinterpret_cast<const uint4*>(vrow + base)[lane];
    }
    for (; base < full; base += 128) {
      reinterpret_cast<uint4*>(stage_b)[lane] = qb;
      if (vrow) reinterpret_cast<uint4*>(stage_v)[lane] = qv;
      if (base + 128 < full) {
        qb = reinterpret_cast<const uint4*>(brow + base + 128)[lane];
        if (vrow)
          qv = reinterpret_cast<const uint4*>(vrow + base + 128)[lane];
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = stage_b[32 * i + lane];
        v[i] = vrow ? stage_v[32 * i + lane] : cval;
      }
      __syncwarp();
      step(x, v);
    }
  }
  for (; base < t1; base += 128) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long idx = base + 32 * i + lane;
      x[i] = idx < t1 ? brow[idx] : -1;
      v[i] = vrow && idx < t1 ? vrow[idx] : cval;
    }
    step(x, v);
  }
}

// the lanes of the warp whose bucket equals this lane's: one ballot per
// bucket bit (buckets below 2^nbits); 0 for an invalid lane
__device__ __forceinline__ unsigned peers_of(int bucket, bool valid,
                                             int nbits) {
  unsigned m = __ballot_sync(FULL, valid);
  for (int k = 0; k < nbits; ++k) {
    const bool bit = (bucket >> k) & 1;
    const unsigned bk = __ballot_sync(FULL, bit);
    m &= bit ? bk : ~bk;
  }
  return valid ? m : 0u;
}

// where a pass reads its items: pass 0 reads the lanes (bins outside
// [0, total) dropped) and the values' source; later passes the previous
// pass's bins and values
struct Source {
  const int* bins;
  long long bin_stride;    // a query's row
  const float* vals;       // null: cval
  long long val_stride;    // 0: shared by the queries
  float cval;
  const int* row_len;      // null: n
  int n;
  int vec;
};

__device__ __forceinline__ long long row_len_of(const Source& s, int b) {
  return s.row_len != nullptr ? s.row_len[b] : s.n;
}

// A pass's CTAs: ceil(tiles / PWARPS) for each query. With `interleave`
// CTA x takes query x % B (the queries of a tile side by side, so that
// values they share are read once), else query x / (its CTAs) (one
// query's runs written at a time); warp w then takes its CTA's w-th tile.
__device__ __forceinline__ int query_of(int B, int tiles, int interleave) {
  const int per = (tiles + PWARPS - 1) / PWARPS;
  return interleave ? blockIdx.x % B : blockIdx.x / per;
}

__device__ __forceinline__ int tile_of(int B, int tiles, int interleave) {
  const int per = (tiles + PWARPS - 1) / PWARPS;
  const int cta = interleave ? blockIdx.x / B : blockIdx.x % per;
  return cta * PWARPS + (threadIdx.x >> 5);
}

// grid-stride init of the atomics' targets: counts 0, min / max images
__global__ void __launch_bounds__(THREADS)
init_kernel(size_t n, int* cnt, int* mn, int* mx) {
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * THREADS) {
    if (cnt) cnt[i] = 0;
    if (mn) mn[i] = f2o(INFINITY);
    if (mx) mx[i] = f2o(-INFINITY);
  }
}

// The sweep: grid ceil(tiles / PWARPS) * B; CTA x takes query x % B
// and warp w tile (x / B) * PWARPS + w, items [tile * wt, (tile + 1) *
// wt) of its row.
// tile_counts (nullable): the warp's count of each bucket (x >> shift) &
// (2^nbits - 1) below nb, written to [b][bucket][tile]. cnt / mn / mx
// (nullable, int images for mn / mx): the full bins' statistics, in the
// CTA's shared counters flushed by one atomic a touched bin (PRIVATE,
// total bins of nbits bits) or by warp-aggregated global atomics.
template <bool PRIVATE>
__global__ void __launch_bounds__(PTHREADS)
sweep_kernel(Source src, int B, int interleave, int total, int shift,
             int nbits, int nb, int wt, int tiles,
             int* __restrict__ tile_counts, int* cnt, int* mn, int* mx) {
  extern __shared__ __align__(16) int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = query_of(B, tiles, interleave);
  const int tile = tile_of(B, tiles, interleave);
  const bool stats = cnt != nullptr || mn != nullptr || mx != nullptr;
  const bool want_v = mn != nullptr || mx != nullptr;
  int* hist = smem + warp * nb;                          // tile_counts
  int* stage_b = smem + (tile_counts ? PWARPS * nb : 0) + warp * 128;
  float* stage_v = reinterpret_cast<float*>(
      smem + (tile_counts ? PWARPS * nb : 0) + PWARPS * 128) + warp * 128;
  int* s_cnt = smem + (tile_counts ? PWARPS * nb : 0) + PWARPS * 256;
  int* s_mn = s_cnt + total;
  int* s_mx = s_mn + total;
  if (tile_counts) {
    for (int x = lane; x < nb; x += 32) hist[x] = 0;
  }
  if (PRIVATE && stats) {
    for (int x = threadIdx.x; x < total; x += PTHREADS) {
      s_cnt[x] = 0;
      s_mn[x] = f2o(INFINITY);
      s_mx[x] = f2o(-INFINITY);
    }
  }
  __syncthreads();
  const long long len = row_len_of(src, b);
  const int* brow = src.bins + (long long)b * src.bin_stride;
  const float* vrow = src.vals != nullptr
      ? src.vals + (long long)b * src.val_stride : nullptr;
  const long long t0 = (long long)tile * wt;
  const long long t1 = tile < tiles ? min(t0 + wt, len) : t0;
  const int mask = (1 << nbits) - 1;
  walk(brow, want_v ? vrow : nullptr, t0, t1, src.vec != 0, src.cval,
       stage_b, stage_v, [&](const int* x, const float* v) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool valid = x[i] >= 0 && x[i] < total;
      // the warp's own counters: shared atomics, no other warp's
      if (tile_counts && valid) atomicAdd(&hist[(x[i] >> shift) & mask], 1);
      if (!stats) continue;
      const int o = f2o(v[i]);
      if (PRIVATE) {
        if (!valid) continue;
        if (cnt) atomicAdd(&s_cnt[x[i]], 1);
        if (mn) atomicMin(&s_mn[x[i]], o);
        if (mx) atomicMax(&s_mx[x[i]], o);
      } else {
        const unsigned peers = __match_any_sync(FULL, valid ? x[i] : -1);
        if (!valid) continue;
        const long long g = (long long)b * total + x[i];
        const bool leader = lane == __ffs(peers) - 1;
        if (cnt && leader) atomicAdd(&cnt[g], __popc(peers));
        if (mn) {
          const int m = __reduce_min_sync(peers, o);
          if (leader) atomicMin(&mn[g], m);
        }
        if (mx) {
          const int m = __reduce_max_sync(peers, o);
          if (leader) atomicMax(&mx[g], m);
        }
      }
    }
  });
  __syncwarp();
  if (tile_counts && tile < tiles) {
    for (int x = lane; x < nb; x += 32)
      tile_counts[((long long)b * nb + x) * tiles + tile] = hist[x];
  }
  if (PRIVATE && stats) {
    __syncthreads();
    for (int x = threadIdx.x; x < total; x += PTHREADS) {
      const long long g = (long long)b * total + x;
      if (cnt && s_cnt[x] != 0) atomicAdd(&cnt[g], s_cnt[x]);
      if (mn && s_mn[x] != f2o(INFINITY)) atomicMin(&mn[g], s_mn[x]);
      if (mx && s_mx[x] != f2o(-INFINITY)) atomicMax(&mx[g], s_mx[x]);
    }
  }
}

// The scatter: the sweep's tiles again; each kept item goes to slot
// bucket_start[b][bucket] + tile prefix [b][bucket][tile] + its rank among
// the tile's earlier items of its bucket. out_bins (nullable) takes the
// item's bin for the next radix pass.
__global__ void __launch_bounds__(PTHREADS)
scatter_kernel(Source src, int B, int interleave, int total, int shift,
               int nbits, int nb, int wt, int tiles,
               const int* __restrict__ tile_prefix,
               const int* __restrict__ bucket_start, long long out_stride,
               int* __restrict__ out_bins, float* __restrict__ out_vals) {
  extern __shared__ __align__(16) int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = query_of(B, tiles, interleave);
  const int tile = tile_of(B, tiles, interleave);
  if (tile >= tiles) return;          // warp-uniform; no CTA barrier below
  int* base_of = smem + warp * nb;
  int* stage_b = smem + PWARPS * nb + warp * 128;
  float* stage_v = reinterpret_cast<float*>(smem + PWARPS * nb
                                            + PWARPS * 128) + warp * 128;
  for (int x = lane; x < nb; x += 32) {
    base_of[x] = bucket_start[(long long)b * nb + x]
        + tile_prefix[((long long)b * nb + x) * tiles + tile];
  }
  __syncwarp();
  const long long len = row_len_of(src, b);
  const int* brow = src.bins + (long long)b * src.bin_stride;
  const float* vrow = src.vals != nullptr
      ? src.vals + (long long)b * src.val_stride : nullptr;
  int* obins = out_bins != nullptr ? out_bins + (long long)b * out_stride
                                   : nullptr;
  float* ovals = out_vals + (long long)b * out_stride;
  const long long t0 = (long long)tile * wt;
  const long long t1 = min(t0 + wt, len);
  const int mask = (1 << nbits) - 1;
  const unsigned lower = (1u << lane) - 1u;
  // the kept items, compacted in order into the warp's ring, are ranked
  // 32 at a time: dropped lanes cost their read and a ballot
  int* ring_x = smem + PWARPS * (nb + 256) + warp * RING;
  float* ring_v = reinterpret_cast<float*>(smem + PWARPS * (nb + 256 + RING))
      + warp * RING;
  unsigned head = 0, tail = 0;            // warp-uniform ring positions
  auto place = [&](int k) {               // the ring's next k <= 32 items
    const bool valid = lane < k;
    const int at = (head + lane) & (RING - 1);
    const int x = valid ? ring_x[at] : 0;
    const float v = valid ? ring_v[at] : 0.0f;
    const int bucket = (x >> shift) & mask;
    const unsigned peers = peers_of(bucket, valid, nbits);
    int slot = 0;
    if (valid) slot = base_of[bucket] + __popc(peers & lower);
    __syncwarp();
    if (valid) {
      ovals[slot] = v;
      if (obins) obins[slot] = x;
      if (lane == __ffs(peers) - 1) base_of[bucket] += __popc(peers);
    }
    __syncwarp();
    head += k;
  };
  walk(brow, vrow, t0, t1, src.vec != 0, src.cval, stage_b, stage_v,
       [&](const int* x, const float* v) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool valid = x[i] >= 0 && x[i] < total;
      const unsigned m = __ballot_sync(FULL, valid);
      if (valid) {
        const int at = (tail + __popc(m & lower)) & (RING - 1);
        ring_x[at] = x[i];
        ring_v[at] = v[i];
      }
      tail += __popc(m);
    }
    __syncwarp();
    while (tail - head >= 32) place(32);
  });
  if (tail != head) place(tail - head);
}

// ---- the scans: per row, an exclusive prefix of len elements (each
// transformed to ceil(x / div) when div > 1), the row's total to
// totals[row * totals_stride] (nullable). Three launches: block sums, a
// scan of each row's block sums, then each block's scan.

__device__ __forceinline__ int xform(int x, int div) {
  return div > 1 ? (x + div - 1) / div : x;
}

// exclusive scan of the CTA's values (one a thread); returns the
// thread's prefix, *block_total the CTA's sum
__device__ __forceinline__ int block_exclusive(int x, int* block_total) {
  __shared__ int warp_sums[THREADS / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < THREADS / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, w, off);
      if (lane >= off) w += y;
    }
    if (lane < THREADS / 32) warp_sums[lane] = w;   // inclusive
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  *block_total = warp_sums[THREADS / 32 - 1];
  __syncthreads();
  return before + inc - x;
}

__global__ void __launch_bounds__(THREADS)
scan_sums_kernel(const int* __restrict__ in, long long in_stride, int len,
                 int div, int nblk, int* __restrict__ blk) {
  const int row = blockIdx.x;
  const long long s = (long long)blockIdx.y * SCAN_BLOCK;
  const int* r = in + row * in_stride;
  int acc = 0;
  for (int k = 0; k < 8; ++k) {
    const long long i = s + (long long)k * THREADS + threadIdx.x;
    if (i < len) acc += xform(r[i], div);
  }
  int tot;
  block_exclusive(acc, &tot);
  if (threadIdx.x == 0) blk[(long long)row * nblk + blockIdx.y] = tot;
}

__global__ void __launch_bounds__(THREADS)
scan_blocks_kernel(int nblk, int* __restrict__ blk, int* totals,
                   long long totals_stride) {
  int* r = blk + (long long)blockIdx.x * nblk;
  int carry = 0;
  for (int s = 0; s < nblk; s += THREADS) {
    const int i = s + threadIdx.x;
    const int x = i < nblk ? r[i] : 0;
    int tot;
    const int ex = block_exclusive(x, &tot);
    if (i < nblk) r[i] = carry + ex;
    carry += tot;
  }
  if (totals != nullptr && threadIdx.x == 0)
    totals[blockIdx.x * totals_stride] = carry;
}

__global__ void __launch_bounds__(THREADS)
scan_apply_kernel(const int* in, long long in_stride, int* out,
                  long long out_stride, int len, int div, int nblk,
                  const int* __restrict__ blk) {
  const int row = blockIdx.x;
  const long long s = (long long)blockIdx.y * SCAN_BLOCK
      + (long long)threadIdx.x * 8;
  const int* r = in + row * in_stride;
  int x[8];
  int acc = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    x[k] = s + k < len ? xform(r[s + k], div) : 0;
    acc += x[k];
  }
  int tot;
  int run = block_exclusive(acc, &tot) + blk[(long long)row * nblk
                                             + blockIdx.y];
  int* o = out + row * out_stride;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (s + k < len) o[s + k] = run;
    run += x[k];
  }
}

int row_scan(const int* in, long long in_stride, int* out,
             long long out_stride, int rows, int len, int div, int* totals,
             long long totals_stride, int* blk, cudaStream_t st) {
  const int nblk = (len + SCAN_BLOCK - 1) / SCAN_BLOCK;
  if (nblk > 65535) return (int)cudaErrorInvalidConfiguration;
  scan_sums_kernel<<<dim3(rows, nblk), THREADS, 0, st>>>(in, in_stride, len,
                                                         div, nblk, blk);
  scan_blocks_kernel<<<rows, THREADS, 0, st>>>(nblk, blk, totals,
                                               totals_stride);
  scan_apply_kernel<<<dim3(rows, nblk), THREADS, 0, st>>>(
      in, in_stride, out, out_stride, len, div, nblk, blk);
  return (int)cudaGetLastError();
}

// ---- the sums

// The radix route's runs: over each query's kept items, now sorted by
// bin, a run starts where the bin changes. Launched twice: `ends` 0
// writes each run's start to run_start [B][total], `ends` 1 each run's
// length (from its start) to run_cnt (zeroed first: empty bins stay 0).
// No atomics, whatever the skew.
__global__ void __launch_bounds__(THREADS)
runs_kernel(const int* __restrict__ bins, long long stride,
            const int* __restrict__ row_len, int total, int per_row,
            int ends, int* __restrict__ run_start, int* __restrict__ run_cnt) {
  const int b = blockIdx.x / per_row;
  const long long len = row_len[b];
  const int* row = bins + (long long)b * stride;
  for (long long j = (long long)(blockIdx.x % per_row) * THREADS
           + threadIdx.x; j < len; j += (long long)per_row * THREADS) {
    const int x = row[j];
    const long long o = (long long)b * total + x;
    if (!ends && (j == 0 || row[j - 1] != x)) run_start[o] = (int)j;
    if (ends && (j + 1 == len || row[j + 1] != x))
      run_cnt[o] = (int)(j + 1) - run_start[o];
  }
}

// one warp: 32 consecutive chunks of query b (thread t chunk c0 + t); 32
// values of each chunk staged at a time, so that loads are coalesced and
// each thread adds its chunk's values in order from 0.0f
__global__ void __launch_bounds__(PTHREADS)
chunk_kernel(const float* __restrict__ vals, long long stride, int total,
             const int* __restrict__ chunk_base,
             const int* __restrict__ run_start,
             const int* __restrict__ run_cnt, int max_chunks,
             float* __restrict__ part_sum, float* __restrict__ part_sq) {
  __shared__ float stage[PWARPS][32][33];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int c = (blockIdx.x * PWARPS + warp) * 32 + lane;
  const int* cb = chunk_base + (long long)b * (total + 1);
  const int nch = cb[total];
  long long start = 0;
  int len = 0;
  if (c < nch) {
    int lo = 0, hi = total;        // the last bin whose first chunk <= c
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (cb[mid] <= c) lo = mid; else hi = mid - 1;
    }
    const int j = c - cb[lo];
    const long long o = (long long)b * total + lo;
    start = run_start[o] + (long long)j * CHUNK;
    len = min(CHUNK, run_cnt[o] - j * CHUNK);
  }
  if (!__any_sync(FULL, len > 0)) return;   // warp-uniform
  const int most = __reduce_max_sync(FULL, len);
  const float* row = vals + (long long)b * stride;
  float s = 0.0f, s2 = 0.0f;
  for (int k = 0; k < most; k += 32) {
    for (int j = 0; j < 32; ++j) {
      const long long sj = __shfl_sync(FULL, start, j);
      const int lj = __shfl_sync(FULL, len, j);
      if (k + lane < lj) stage[warp][j][lane] = row[sj + k + lane];
    }
    __syncwarp();
    const int m = min(32, len - k);
    for (int i = 0; i < m; ++i) {
      const float v = stage[warp][lane][i];
      s = s + v;
      s2 = s2 + v * v;
    }
    __syncwarp();
  }
  if (c < nch) {
    const long long o = (long long)b * max_chunks + c;
    if (part_sum) part_sum[o] = s;
    if (part_sq) part_sq[o] = s2;
  }
}

// one thread a (query, bin): its chunks' partials summed from 0 in order
// (sums only); min / max decoded from their ordered images
__global__ void __launch_bounds__(THREADS)
finish_kernel(int total, const int* __restrict__ chunk_base, int max_chunks,
              const float* __restrict__ part_sum,
              const float* __restrict__ part_sq, float* sum, float* sumsq,
              int* mn, int* mx) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (t >= total) return;
  const long long o = (long long)b * total + t;
  if (mn) reinterpret_cast<float*>(mn)[o] = o2f(mn[o]);
  if (mx) reinterpret_cast<float*>(mx)[o] = o2f(mx[o]);
  if (sum == nullptr && sumsq == nullptr) return;
  const int* cb = chunk_base + (long long)b * (total + 1);
  const long long row = (long long)b * max_chunks;
  float s = 0.0f, s2 = 0.0f;
  for (int c = cb[t]; c < cb[t + 1]; ++c) {
    if (sum) s = s + part_sum[row + c];
    if (sumsq) s2 = s2 + part_sq[row + c];
  }
  if (sum) sum[o] = s;
  if (sumsq) sumsq[o] = s2;
}

unsigned blocks_of(size_t n, int per) {
  return (unsigned)((n + per - 1) / per);
}

template <typename K>
int allow_smem(K kernel, bool* done) {
  if (*done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (e != cudaSuccess) return (int)e;
  *done = true;
  return 0;
}

bool smem_sweep_private = false, smem_sweep_global = false,
     smem_scatter = false;

}  // namespace

// lanes int32 [B, n]; values f32 [n] or [B, n] (per_query) or null
// (cval); needs: cnt 1 | sum 2 | sumsq 4 | min 8 | max 16. The plan
// (ops/binned.py scatter_plan): passes (0: counts, min and max only; 1:
// one partition pass, total <= SCATTER_MAX_BINS; 2 or more: radix passes
// of `digit` bits), the warp tile wt (a multiple of 128) and its count a
// row, the buffers' row stride S (n rounded up to 4), max_chunks a row;
// vec: 16-byte loads of lanes and values allowed. Scratch slots, laid
// out by the wrapper (ops/binned.py _scatter_layout), null where the plan
// has none: tile int [B][nb][tiles] (tile counts, then their prefixes),
// bcnt / bstart int [B][nb] (bucket counts and starts), rowlen int [B]
// (kept lanes a query), bins_a / bins_b int [B][S] (the radix passes'
// bins), vals_a / vals_b f32 [B][S] (partitioned values), rcnt / rstart
// int [B][total] (the full bins' counts, without cnt, and run starts:
// radix), cbase int [B][total + 1] (first chunk of each bin), psum / psq
// f32 [B][max_chunks] (chunk partials), scan int (the scans' block sums).
// Outputs [B, total], null where not asked (min / max f32 written
// through their int images).
extern "C" int binned_scatter(const int* lanes, int B, int n, int total,
                              const float* values, int per_query, float cval,
                              int needs, int passes, int digit, int wt,
                              int tiles, int S, int max_chunks, int vec,
                              int* tile, int* bcnt, int* bstart,
                              int* rowlen, int* bins_a, int* bins_b,
                              float* vals_a, float* vals_b, int* rcnt,
                              int* rstart, int* cbase, float* psum,
                              float* psq, int* scan, int* cnt, float* sum,
                              float* sumsq, float* mn, float* mx,
                              void* stream) {
  if (B <= 0 || n <= 0 || total <= 0 || B > 65535 || passes < 0
      || passes > 24 || wt <= 0 || wt % 128 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int e = 0;
  if ((e = allow_smem(sweep_kernel<true>, &smem_sweep_private)) ||
      (e = allow_smem(sweep_kernel<false>, &smem_sweep_global)) ||
      (e = allow_smem(scatter_kernel, &smem_scatter)))
    return e;
  const bool sums = (needs & (NEED_SUM | NEED_SUMSQ)) != 0;
  if (sums != (passes > 0)) return (int)cudaErrorInvalidValue;
  int* icnt = (needs & NEED_CNT) ? cnt : nullptr;
  int* imn = (needs & NEED_MIN) ? reinterpret_cast<int*>(mn) : nullptr;
  int* imx = (needs & NEED_MAX) ? reinterpret_cast<int*>(mx) : nullptr;
  float* s = (needs & NEED_SUM) ? sum : nullptr;
  float* s2 = (needs & NEED_SUMSQ) ? sumsq : nullptr;
  const size_t outs = (size_t)B * total;
  if ((long long)blocks_of(tiles, PWARPS) * B > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  const unsigned tgrid = blocks_of(tiles, PWARPS) * B;
  Source src{lanes, n, values, per_query ? (long long)n : 0, cval, nullptr,
             n, vec};
  int bits = 0;
  while ((1 << bits) < total) ++bits;
  const bool private_bins = passes <= 1 && bits <= 11;
  // counts by atomics only without sums: a partition's scans give them
  // (one pass), or its runs (radix: rcnt zeroed here)
  int* acnt = passes == 0 ? icnt : nullptr;
  if (passes >= 2) rcnt = icnt ? icnt : rcnt;
  else rcnt = nullptr;
  // the CTA's own counters: where a sweep takes statistics of few bins
  const bool sweep_stats = acnt || imn || imx;
  const size_t stat_smem = private_bins && sweep_stats
      ? (size_t)3 * total * sizeof(int) : 0;
  if (acnt || rcnt || imn || imx) {
    unsigned g = blocks_of(outs, THREADS);
    init_kernel<<<g > 65535u ? 65535u : g, THREADS, 0, st>>>(
        outs, acnt ? acnt : rcnt, imn, imx);
  }
  // the first pass interleaves the queries where they share the values
  // and the buckets are few (more runs written at once cost more than
  // the values' reads save: H100 80GB HBM3, 256 buckets)
  const int shared_values = values != nullptr && !per_query;
  if (passes == 0) {
    const int inter = shared_values;
    const size_t sm = (size_t)PWARPS * 256 * sizeof(int) + stat_smem;
    if (private_bins)
      sweep_kernel<true><<<tgrid, PTHREADS, sm, st>>>(
          src, B, inter, total, 0, bits, 0, wt, tiles, nullptr, acnt, imn,
          imx);
    else
      sweep_kernel<false><<<tgrid, PTHREADS, sm, st>>>(
          src, B, inter, total, 0, bits, 0, wt, tiles, nullptr, acnt, imn,
          imx);
  } else {
    const int nb = passes == 1 ? total : 1 << digit;
    const int nbits = passes == 1 ? bits : digit;
    if (passes == 1 && icnt) bcnt = icnt;
    int* bins_buf[2] = {bins_a, bins_b};
    float* vals_buf[2] = {vals_a, vals_b};
    const size_t pass_smem = (size_t)PWARPS * (nb + 256) * sizeof(int);
    const size_t scatter_smem = pass_smem + (size_t)PWARPS * 2 * RING
        * sizeof(int);
    float* vals = nullptr;
    for (int p = 0; p < passes; ++p) {
      const int inter = p == 0 && shared_values && nb <= 64;
      const int shift = passes == 1 ? 0 : p * digit;
      int* ob = passes >= 2 ? bins_buf[p & 1] : nullptr;
      float* ov = vals_buf[p & 1];
      // the first pass's sweep also takes the full bins' min and max
      int* n0 = p == 0 ? imn : nullptr;
      int* x0 = p == 0 ? imx : nullptr;
      if (p == 0 && private_bins)
        sweep_kernel<true><<<tgrid, PTHREADS, pass_smem + stat_smem, st>>>(
            src, B, inter, total, shift, nbits, nb, wt, tiles, tile,
            nullptr, n0, x0);
      else
        sweep_kernel<false><<<tgrid, PTHREADS, pass_smem, st>>>(
            src, B, inter, total, shift, nbits, nb, wt, tiles, tile,
            nullptr, n0, x0);
      if ((e = row_scan(tile, tiles, tile, tiles, B * nb, tiles, 1, bcnt, 1,
                        scan, st)))
        return e;
      if ((e = row_scan(bcnt, nb, bstart, nb, B, nb, 1,
                        p == 0 ? rowlen : nullptr, 1, scan, st)))
        return e;
      scatter_kernel<<<tgrid, PTHREADS, scatter_smem, st>>>(
          src, B, inter, total, shift, nbits, nb, wt, tiles, tile, bstart,
          S, ob, ov);
      src = Source{ob, S, ov, S, 0.0f, rowlen, n, 1};
      vals = ov;
    }
    const int* run_cnt = bcnt;
    const int* run_start = bstart;
    if (passes >= 2) {
      // a grid-stride walk: the kept items are known on the card only
      const int per_row = (int)std::min(blocks_of(n, THREADS), 128u);
      for (int ends = 0; ends < 2; ++ends)
        runs_kernel<<<(unsigned)((long long)per_row * B), THREADS, 0, st>>>(
            bins_buf[(passes - 1) & 1], S, rowlen, total, per_row, ends,
            rstart, rcnt);
      run_cnt = rcnt;
      run_start = rstart;
    }
    if ((e = row_scan(run_cnt, total, cbase, total + 1, B, total, CHUNK,
                      cbase + total, total + 1, scan, st)))
      return e;
    chunk_kernel<<<dim3(blocks_of(max_chunks, PTHREADS), B), PTHREADS, 0,
                   st>>>(vals, S, total, cbase, run_start, run_cnt,
                         max_chunks, s ? psum : nullptr, s2 ? psq : nullptr);
  }
  finish_kernel<<<dim3(blocks_of(total, THREADS), B), THREADS, 0, st>>>(
      total, cbase, max_chunks, psum, psq, s, s2, imn, imx);
  return (int)cudaGetLastError();
}

extern "C" const char* binned_scatter_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
