// K23 nested_aggs: the `nested` and `reverse_nested` aggregations for B
// queries over a segment's Dp rows, one C entry each.
//
// Replaces opensearch_tpu/search/aggs/engine.py:1559-1577 (nested) and
// :1579-1609 (reverse_nested), the reference's scatter-path kinds.
//
// nested_agg: from the eligible rows mask bool [B, Dp] and their bucket
// parent_eff int32 [B, Dp] (-1: none; the context collapsed per query),
// each live nested row on the query's path (nested_path == path_ord[b])
// whose root is eligible and in a bucket is `own` and takes the root's
// bucket (child_eff; -1 elsewhere); counts int32 [B, card] counts them.
//
// reverse_nested_agg: over the selected nested rows (eligible, in a
// bucket: parent_eff in [0, card)), the distinct roots per bucket, counts
// int32 [B, card], and each root's bucket root_eff int32 [B, Dp] (the
// largest of its rows' buckets, -1 for none; own = root_eff >= 0).
//
// What bounds it on an H100: bytes. nested: each (query, row) reads the
// mask and bucket of its root and writes own and child_eff (5 B in, 5 B
// out), and the static doc blocks (parent_ptr, nested_path, live: 9 B a
// row) are read once. reverse_nested: each (query, row) writes root_eff
// and own (5 B); each nested row's mask byte is read, its bucket only
// where the mask is set; the static CSR (child_start, child_rows: 8 B a
// row) is shared by the B queries in L2.
//
// Design of nested_agg. A CTA takes a tile of AGG_TILE_ROWS rows, two
// quads of 4 rows a thread, for a group of up to AGG_QUERY_GROUP queries,
// and reads the tile's parent_ptr, live and nested_path once, into
// registers, for every query of the group. The tile's parent window (the
// roots of its live nested rows: in the blocked layout the tile itself
// and the root of a block that crosses its end) is the same for every
// query; where it spans at most AGG_STAGE_ROWS rows, each query's window
// of mask and parent_eff is copied into shared memory with 16-byte
// cp.async copies, the next query's ahead of the current one's walk (a
// ring of two), and each row reads its root's byte and bucket from there.
// A tile whose window is wider (roots far from their rows) gathers each
// row's root directly. own and child_eff are written for every row of the
// tile, 4 rows a store. Counts: a warp whose rows all took one bucket
// (the root context's single bucket, a skewed context) adds its count
// with one warp reduction; otherwise each thread adds its runs of equal
// buckets. Up to CNT_CAP buckets the adds go to the CTA's counters in
// shared memory and the CTA makes one global atomic per (query, nonzero
// bucket); past it they are global atomics. A query with path_ord < 0
// reads nothing. A misaligned view or a Dp off 16 takes the same walk
// with element loads and stores (block_reduce.cuh's load4 / store4): the
// aggregation path never does (Dp is a power of two from 128, the tensors
// whole), the card tests' Dp 30,001 does.
//
// Design of reverse_nested_agg. Counts are integer atomics (exact,
// order-free). It walks K22's static root CSR
// (child_start [Dp + 1], child_rows: a root's nested rows in row order),
// which groups each root's rows, so no sort is needed. A CTA takes a
// range of rows for one query and copies the range's child_start to
// shared memory. Then, window by window, a run of light rows (at most
// HEAVY_ROWS nested rows each) whose CSR positions number at most CAP has
// those positions' buckets staged in shared memory: the row ids, then
// their mask bytes, then the buckets where the mask is set, STAGE loads of
// each kind a thread issued together, so that a window costs three
// dependent loads rather than three a nested row. A block scan lists the
// window's roots; one thread a root walks its staged positions, takes the
// largest bucket, and finds the root's distinct buckets: in a 64-bit
// register set where card <= 64, else by testing each selected row's
// bucket against the root's earlier ones (at most HEAVY_ROWS - 1). Each
// distinct (bucket, root) adds 1 to the CTA's shared counter of its
// bucket; the CTA makes one global atomic per (query, bucket). A root of
// more rows is the whole CTA's: its rows strided over the threads, a block
// max, and a bitmap of the card's buckets in shared memory (atomicOr: the
// thread that sets a bit counts the bucket), in windows of BITMAP_WORDS *
// 32 buckets; it reads its own rows once per window and costs no more.
// Each row's root_eff and own are written directly: no keys, no scratch,
// no fill pass. Grid: row ranges x queries, the query the fastest index
// (the B CTAs of a range share its CSR in L2); a range is RANGE_ROWS rows,
// fewer where B and Dp are small.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "block_reduce.cuh"
#include "cp_async.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int HEAVY_ROWS = 32;      // a root with more rows: the CTA's walk
constexpr int BITSET_CARD = 64;     // distinct buckets in a 64-bit set
constexpr int STAGE = 8;            // positions a thread loads a batch
constexpr int CAP = STAGE * THREADS;  // positions staged a window (2,048)
constexpr int RANGE_ROWS = 8 * THREADS;  // rows a CTA, at most (2,048)
constexpr int CNT_CAP = 4096;       // CTA-private bucket counters up to it
constexpr int BITMAP_WORDS = 1024;  // a heavy root's window: 32,768 buckets
// nested_agg's tile
constexpr int AGG_TILE_ROWS = 2048;    // rows a CTA: two quads of 4 a thread
constexpr int AGG_STAGE_ROWS = 2304;   // a query's parent window, staged
constexpr int AGG_QUERY_GROUP = 32;    // queries a CTA
constexpr int QUAD_ROWS = 4 * THREADS;  // rows of one quad across the CTA
static_assert(AGG_TILE_ROWS == 2 * QUAD_ROWS, "two quads a thread");
static_assert(AGG_STAGE_ROWS % 16 == 0, "16-byte copies");

// one bucket's count: to the CTA's counter (s_cnt) or, past CNT_CAP, to
// the query's row of counts
__device__ __forceinline__ void add_count(int e, int n, int* s_cnt,
                                          int* gcnt) {
  if (s_cnt != nullptr) atomicAdd(&s_cnt[e], n);
  else atomicAdd(&gcnt[e], n);
}

// the buckets of CSR positions p0 + tid + k * THREADS (k < STAGE) below
// p1: a row's bucket where its mask is set, else -1; the row ids, then
// their mask bytes, then the buckets, each batch's loads issued together
__device__ __forceinline__ void gather_buckets(
    int p0, int p1, const int* __restrict__ child_rows,
    const uint8_t* __restrict__ mrow, const int* __restrict__ erow,
    int (&e)[STAGE]) {
  int r[STAGE];
#pragma unroll
  for (int k = 0; k < STAGE; ++k) {
    const int p = p0 + (int)threadIdx.x + k * THREADS;
    r[k] = p < p1 ? __ldg(child_rows + p) : -1;
  }
  bool m[STAGE];
#pragma unroll
  for (int k = 0; k < STAGE; ++k) m[k] = r[k] >= 0 && __ldg(mrow + r[k]) != 0;
#pragma unroll
  for (int k = 0; k < STAGE; ++k) e[k] = m[k] ? __ldg(erow + r[k]) : -1;
}

// the exclusive prefix sum of v over the CTA's threads, in thread order;
// *total gets the sum. s_red [THREADS / 32]
__device__ __forceinline__ int block_scan(int v, int* s_red, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += up;
  }
  if (lane == 31) s_red[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < THREADS / 32; ++w) {
    if (w < warp) before += s_red[w];
    all += s_red[w];
  }
  __syncthreads();
  *total = all;
  return before + inc - v;
}

// nested_agg: block (tile of AGG_TILE_ROWS rows, group of queries). Thread
// t's rows are d0 + g * QUAD_ROWS + 4 t + c (quad g < 2, c < 4). VEC: Dp
// a multiple of 16 and every pointer 16-byte aligned (vector loads,
// stores and copies); else element by element.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
nested_kernel(const uint8_t* __restrict__ mask,
              const int* __restrict__ parent_eff,
              const uint8_t* __restrict__ live,
              const int* __restrict__ nested_path,
              const int* __restrict__ parent_ptr,
              const int* __restrict__ path_ord, int B, int Dp, int card,
              uint8_t* __restrict__ own, int* __restrict__ child_eff,
              int* __restrict__ counts) {
  extern __shared__ int s_cnt_dyn[];      // [card] where card <= CNT_CAP
  __shared__ __align__(16) uint8_t s_m[2][AGG_STAGE_ROWS];
  __shared__ __align__(16) int s_e[2][AGG_STAGE_ROWS];
  __shared__ int s_red[THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31;
  const int d0 = blockIdx.x * AGG_TILE_ROWS;
  const int q0 = blockIdx.y * AGG_QUERY_GROUP;
  const int nq = min(AGG_QUERY_GROUP, B - q0);
  int* s_cnt = card <= CNT_CAP ? s_cnt_dyn : nullptr;
  // the tile's static rows, once for all the group's queries: the root
  // (-1: none, not live or past Dp) and the path of each row
  int p[8], path[8];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int r = d0 + g * QUAD_ROWS + 4 * tid;
    int pp[4], pa[4];
    bool lv[4];
    load4<VEC>(parent_ptr, r, Dp, -1, pp);
    load4<VEC>(nested_path, r, Dp, -1, pa);
    load4<VEC>(live, r, Dp, lv);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      p[4 * g + c] = lv[c] ? pp[c] : -1;
      path[4 * g + c] = pa[c];
    }
  }
  // the parent window, the same for every query
  int lo = INT_MAX, hi = -1;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (p[k] >= 0) {
      lo = min(lo, p[k]);
      hi = max(hi, p[k]);
    }
  lo = block_reduce<THREADS, false>(lo, s_red);
  hi = block_reduce<THREADS, true>(hi, s_red);
  const int a0 = VEC ? (lo & ~15) : lo;
  const int span = hi < 0 ? 0 : (VEC ? ((hi + 16) & ~15) : hi + 1) - a0;
  const bool staged = hi >= 0 && span <= AGG_STAGE_ROWS;
  if (s_cnt != nullptr)
    for (int i = tid; i < card; i += THREADS) s_cnt[i] = 0;

  // query q's window of mask and parent_eff into ring slot q & 1 (nothing
  // for a query off every path)
  auto stage = [&](int q) {
    const int b = q0 + q;
    if (__ldg(path_ord + b) < 0) return;
    const size_t at = (size_t)b * Dp + a0;
    uint8_t* sm = s_m[q & 1];
    int* se = s_e[q & 1];
    if (VEC) {
      const int nm = span >> 4, ne = span >> 2;
      for (int i = tid; i < nm + ne; i += THREADS) {
        if (i < nm) cp_async16(sm + 16 * i, mask + at + 16 * i);
        else cp_async16(se + 4 * (i - nm), parent_eff + at + 4 * (i - nm));
      }
    } else {
      for (int i = tid; i < span; i += THREADS) {
        sm[i] = __ldg(mask + at + i);
        se[i] = __ldg(parent_eff + at + i);
      }
    }
  };
  if (staged) stage(0);
  cp_async_commit();
  for (int q = 0; q < nq; ++q) {
    const int b = q0 + q;
    const int po = __ldg(path_ord + b);
    const size_t base = (size_t)b * Dp;
    if (staged && q + 1 < nq) stage(q + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();          // query q's window is in slot q & 1
    const uint8_t* sm = s_m[q & 1];
    const int* se = s_e[q & 1];
    int ce[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      ce[k] = -1;
      if (po >= 0 && p[k] >= 0 && path[k] == po) {
        int pe = -1;
        if (staged) {
          if (sm[p[k] - a0] != 0) pe = se[p[k] - a0];
        } else if (__ldg(mask + base + p[k]) != 0) {
          pe = __ldg(parent_eff + base + p[k]);
        }
        if (pe >= 0 && pe < card) ce[k] = pe;
      }
    }
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int r = d0 + g * QUAD_ROWS + 4 * tid;
      const int e[4] = {ce[4 * g], ce[4 * g + 1], ce[4 * g + 2],
                        ce[4 * g + 3]};
      const bool o[4] = {e[0] >= 0, e[1] >= 0, e[2] >= 0, e[3] >= 0};
      store4<VEC>(own + base, r, Dp, o);
      store4<VEC>(child_eff + base, r, Dp, e);
    }
    // counts: one reduction where the warp's rows took one bucket, else
    // each thread's runs of equal buckets
    int emin = INT_MAX, emax = -1, n = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (ce[k] >= 0) {
        emin = min(emin, ce[k]);
        emax = max(emax, ce[k]);
        ++n;
      }
    int* gcnt = counts + (size_t)b * card;
    const int wmin = __reduce_min_sync(FULL, emin);
    const int wmax = __reduce_max_sync(FULL, emax);
    if (wmax >= 0 && wmin == wmax) {
      const int tot = __reduce_add_sync(FULL, n);
      if (lane == 0) add_count(wmax, tot, s_cnt, gcnt);
    } else if (n > 0) {
      int cur = -1, run = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (ce[k] != cur) {
          if (cur >= 0) add_count(cur, run, s_cnt, gcnt);
          cur = ce[k];
          run = 0;
        }
        ++run;
      }
      if (cur >= 0) add_count(cur, run, s_cnt, gcnt);
    }
    __syncthreads();          // counters complete; slot q & 1 free
    if (s_cnt != nullptr)
      for (int i = tid; i < card; i += THREADS) {
        const int v = s_cnt[i];
        if (v != 0) {
          atomicAdd(&gcnt[i], v);
          s_cnt[i] = 0;
        }
      }
  }
}

// a root of more than HEAVY_ROWS rows (positions lo .. hi of the CSR), by
// the whole CTA: its rows strided over the threads, STAGE of them a batch
// per thread, the distinct buckets in a shared bitmap a window of
// BITMAP_WORDS * 32 buckets at a time (the thread that sets a bit counts
// the bucket), the largest bucket a block max
__device__ __forceinline__ void heavy_root(
    int d, int lo, int hi, const int* __restrict__ child_rows,
    const uint8_t* __restrict__ mrow, const int* __restrict__ erow, int card,
    int* s_cnt, int* gcnt, unsigned* s_bm, int* s_red, uint8_t* orow,
    int* rrow) {
  int best = -1;
  for (int w0 = 0; w0 < card; w0 += BITMAP_WORDS * 32) {
    const int span = min(card - w0, BITMAP_WORDS * 32);
    for (int i = threadIdx.x; i < (span + 31) / 32; i += THREADS)
      s_bm[i] = 0u;
    __syncthreads();
    for (int p0 = lo; p0 < hi; p0 += THREADS * STAGE) {
      int e[STAGE];
      gather_buckets(p0, hi, child_rows, mrow, erow, e);
#pragma unroll
      for (int k = 0; k < STAGE; ++k) {
        if (e[k] < 0) continue;
        best = max(best, e[k]);
        const int o = e[k] - w0;
        if (o < 0 || o >= span) continue;
        const unsigned bit = 1u << (o & 31);
        if ((atomicOr(&s_bm[o >> 5], bit) & bit) == 0u)
          add_count(e[k], 1, s_cnt, gcnt);
      }
    }
    __syncthreads();
  }
  best = block_reduce<THREADS, true>(best, s_red);
  if (threadIdx.x == 0) {
    rrow[d] = best;
    orow[d] = best >= 0 ? 1 : 0;
  }
}

// block (row range, query), the query the fastest index. The range's
// child_start goes to shared memory; then, window by window, the buckets
// of a run of light rows' CSR positions (at most CAP of them) are staged
// in shared memory with batched loads, and one thread a row walks its
// positions there; a heavy row takes the CTA's walk on its own.
__global__ void __launch_bounds__(THREADS, 8)   // 32 registers: 64 warps
reverse_walk_kernel(const uint8_t* __restrict__ mask,
                    const int* __restrict__ parent_eff,
                    const int* __restrict__ child_start,
                    const int* __restrict__ child_rows, int B, int Dp,
                    int card, int range_rows, uint8_t* __restrict__ own,
                    int* __restrict__ root_eff, int* __restrict__ counts) {
  extern __shared__ int rsmem[];
  __shared__ int s_cs[RANGE_ROWS + 1];
  __shared__ int s_e[CAP];
  __shared__ int s_root[RANGE_ROWS];
  __shared__ int s_red[THREADS / 32];
  const bool priv = card <= CNT_CAP;
  int* s_cnt = priv ? rsmem : nullptr;
  unsigned* s_bm = reinterpret_cast<unsigned*>(rsmem + (priv ? card : 0));
  const int b = blockIdx.x % B;
  const int d0 = (blockIdx.x / B) * range_rows;
  const int nrows = min(range_rows, Dp - d0);
  const int tid = threadIdx.x;
  const size_t base = (size_t)b * Dp;
  const uint8_t* mrow = mask + base;
  const int* erow = parent_eff + base;
  uint8_t* orow = own + base;
  int* rrow = root_eff + base;
  int* gcnt = counts + (size_t)b * card;
  if (priv)
    for (int i = tid; i < card; i += THREADS) s_cnt[i] = 0;
  for (int i = tid; i <= nrows; i += THREADS)
    s_cs[i] = __ldg(child_start + d0 + i);
  __syncthreads();
  int a = 0;
  while (a < nrows) {
    // the window ends at the first row from a on that is heavy or whose
    // positions end past CAP from a's first
    int stop = nrows;
    for (int i = a + tid; i < nrows; i += THREADS) {
      if (s_cs[i + 1] - s_cs[i] > HEAVY_ROWS ||
          s_cs[i + 1] - s_cs[a] > CAP) {
        stop = i;
        break;
      }
    }
    stop = block_reduce<THREADS, false>(stop, s_red);
    if (stop == a) {           // row a is heavy: the CTA walks it
      heavy_root(d0 + a, s_cs[a], s_cs[a + 1], child_rows, mrow, erow, card,
                 s_cnt, gcnt, s_bm, s_red, orow, rrow);
      ++a;
      continue;
    }
    const int p0 = s_cs[a], p1 = s_cs[stop];
    {
      int e[STAGE];
      gather_buckets(p0, p1, child_rows, mrow, erow, e);
#pragma unroll
      for (int k = 0; k < STAGE; ++k) {
        const int slot = tid + k * THREADS;
        if (p0 + slot < p1) s_e[slot] = e[k];
      }
    }
    // the window's roots (rows with nested rows) listed in row order
    const int span = stop - a;
    const int per = (span + THREADS - 1) / THREADS;
    const int r0 = a + tid * per;
    unsigned has = 0u;                     // bit c: row r0 + c is a root
    for (int c = 0; c < per && r0 + c < stop; ++c)
      if (s_cs[r0 + c + 1] > s_cs[r0 + c]) has |= 1u << c;
    int n_roots;
    int at = block_scan(__popc(has), s_red, &n_roots);
    for (; has != 0u; has &= has - 1u) s_root[at++] = r0 + __ffs(has) - 1;
    __syncthreads();
    // rows without nested rows: -1 and 0, coalesced
    for (int i = a + tid; i < stop; i += THREADS) {
      if (s_cs[i + 1] == s_cs[i]) {
        rrow[d0 + i] = -1;
        orow[d0 + i] = 0;
      }
    }
    // one thread a root walks its staged positions
    for (int k = tid; k < n_roots; k += THREADS) {
      const int i = s_root[k];
      const int lo = s_cs[i] - p0, n = s_cs[i + 1] - s_cs[i];
      int best = -1;
      unsigned long long seen = 0ull;
      for (int j = 0; j < n; ++j) {
        const int e = s_e[lo + j];
        if (e < 0) continue;
        best = max(best, e);
        if (e >= card) continue;
        if (card <= BITSET_CARD) {
          const unsigned long long bit = 1ull << e;
          if ((seen & bit) != 0ull) continue;
          seen |= bit;
        } else {
          // against the root's earlier rows (at most HEAVY_ROWS - 1)
          bool dup = false;
          for (int q = 0; q < j && !dup; ++q) dup = s_e[lo + q] == e;
          if (dup) continue;
        }
        add_count(e, 1, s_cnt, gcnt);
      }
      rrow[d0 + i] = best;
      orow[d0 + i] = best >= 0 ? 1 : 0;
    }
    __syncthreads();           // s_e is staged again next window
    a = stop;
  }
  if (priv) {
    __syncthreads();
    for (int i = tid; i < card; i += THREADS)
      if (s_cnt[i] != 0) atomicAdd(&gcnt[i], s_cnt[i]);
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    sms = n;
  }
  return sms;
}

}  // namespace

// mask bool, parent_eff int32 [B, Dp]; live bool, nested_path, parent_ptr
// int32 [Dp]; path_ord int32 [B]; own bool, child_eff int32 [B, Dp];
// counts int32 [B, card], zeroed by the caller.
extern "C" int nested_agg(const uint8_t* mask, const int* parent_eff,
                          const uint8_t* live, const int* nested_path,
                          const int* parent_ptr, const int* path_ord, int B,
                          int Dp, int card, uint8_t* own, int* child_eff,
                          int* counts, void* stream) {
  if (card <= 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || Dp == 0) return 0;
  const long long tiles = ((long long)Dp + AGG_TILE_ROWS - 1) / AGG_TILE_ROWS;
  const int groups = (B + AGG_QUERY_GROUP - 1) / AGG_QUERY_GROUP;
  if (tiles > 0x7fffffffLL || groups > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const bool vec = Dp % 16 == 0 &&
                   aligned16(mask, parent_eff, live, nested_path, parent_ptr,
                             own, child_eff);
  const dim3 grid((unsigned)tiles, (unsigned)groups);
  const size_t smem = card <= CNT_CAP ? (size_t)card * 4 : 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    nested_kernel<true><<<grid, THREADS, smem, st>>>(
        mask, parent_eff, live, nested_path, parent_ptr, path_ord, B, Dp,
        card, own, child_eff, counts);
  else
    nested_kernel<false><<<grid, THREADS, smem, st>>>(
        mask, parent_eff, live, nested_path, parent_ptr, path_ord, B, Dp,
        card, own, child_eff, counts);
  return (int)cudaGetLastError();
}

// mask bool, parent_eff int32 [B, Dp] (in [-1, card)); child_start int32
// [Dp + 1] and child_rows int32 [NCp]: K22's static root CSR of the
// segment's parent_ptr; own bool, root_eff int32 [B, Dp]; counts int32
// [B, card], zeroed by the caller.
extern "C" int reverse_nested_agg(const uint8_t* mask, const int* parent_eff,
                                  const int* child_start,
                                  const int* child_rows, int B, int Dp,
                                  int card, uint8_t* own, int* root_eff,
                                  int* counts, void* stream) {
  if (card <= 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || Dp == 0) return 0;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  // rows a CTA: RANGE_ROWS, halved (to one row a thread) until the grid
  // has four CTAs per SM
  auto ranges = [&](int rows) { return ((long long)Dp + rows - 1) / rows; };
  int rows = RANGE_ROWS;
  while (rows > THREADS && ranges(rows) * B < 4LL * sms) rows /= 2;
  const long long grid = ranges(rows) * B;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int bm = (card + 31) / 32 < BITMAP_WORDS ? (card + 31) / 32
                                                 : BITMAP_WORDS;
  const size_t smem = ((card <= CNT_CAP ? (size_t)card : 0) + bm) * 4;
  reverse_walk_kernel<<<(unsigned)grid, THREADS, smem,
                        (cudaStream_t)stream>>>(mask, parent_eff, child_start,
                                                child_rows, B, Dp, card, rows,
                                                own, root_eff, counts);
  return (int)cudaGetLastError();
}

extern "C" const char* nested_aggs_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
