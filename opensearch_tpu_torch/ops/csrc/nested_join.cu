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
// What bounds it on an H100: bytes. Each (query, row) reads the row's
// child score and match once (5 B) and writes the root outputs (5 B); the
// CSR and each position's path and live flag (13 B a row) are read once.
//
// Design: gather instead of scatter, one rounding per operation in CSR
// order (--fmad=false): a root folds its selected rows' scores from 0.0f
// (sum, with the count beside it for avg) or takes fmaxf / fminf from
// -inf / +inf, in the order in which the reference's CPU scatter applies
// its updates, so the kernel, its plain version (ops/nested.py) and the
// reference agree bit for bit. No atomics, and nothing assumes a root's
// rows are contiguous.
//
// A CTA takes a tile of JOIN_TILE_ROWS root rows, two quads of 4 rows a
// thread, for a group of up to JOIN_QUERY_GROUP queries. It stages the
// tile's CSR positions once for all its queries: each position's row and
// a key, its nested_path where the row is live (else -2, never a path).
// In the blocked layout (a document's nested rows just before its root)
// the positions' rows lie in the tile and the few rows before it; where
// they span at most JOIN_STAGE_ROWS rows, each query's window of child_s
// and child_m is copied into shared memory with 16-byte cp.async copies,
// the next query's ahead of the current one's fold (a ring of two), and
// one thread a root folds its positions from shared memory. A tile whose
// rows spread wider gathers each selected row's score from device memory
// instead. out_s and out_m are written for every row, 4 rows a store. A
// tile with more than JOIN_POS_CAP positions or a root of more than
// JOIN_HEAVY_ROWS is heavy: its light roots fold by gathers, and each
// heavy root is walked by the whole CTA in chunks of JOIN_CHUNK positions
// staged for every query of the group, thread q folding query q's chunk
// in order and carrying its sums to the next chunk. A query with path_ord
// < 0 reads nothing and writes zeros. A misaligned view or a Dp off 16
// takes the same walk with element loads and stores (block_reduce.cuh's
// load4 / store4): the search path never does (Dp is a power of two from
// 128, the tensors whole), the card tests' Dp 9,000 and offset views do.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <math.h>

#include "block_reduce.cuh"
#include "cp_async.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int JOIN_TILE_ROWS = 2048;    // root rows a CTA: 2 quads a thread
constexpr int JOIN_STAGE_ROWS = 2304;   // a query's window of child rows
constexpr int JOIN_POS_CAP = 2304;      // CSR positions a tile stages
constexpr int JOIN_HEAVY_ROWS = 64;     // a root with more: the CTA's walk
constexpr int JOIN_CHUNK = 128;         // a heavy root's positions a step
constexpr int JOIN_QUERY_GROUP = 32;    // queries a CTA
constexpr int QUAD_ROWS = 4 * THREADS;
static_assert(JOIN_TILE_ROWS == 2 * QUAD_ROWS, "two quads a thread");
static_assert(JOIN_STAGE_ROWS % 16 == 0, "16-byte copies");
static_assert(JOIN_QUERY_GROUP <= THREADS, "a thread a query's fold");
// score modes (ops/nested.py SCORE_MODES)
constexpr int MODE_AVG = 0, MODE_SUM = 1, MODE_MAX = 2, MODE_MIN = 3,
              MODE_NONE = 4;
constexpr int NOT_LIVE = -2;            // a key that is never a path

// the shared memory of a tile: light (positions and the ring) or heavy
// (the heavy roots' list and a chunk for every query)
struct LightTile {
  int row[JOIN_POS_CAP];
  int key[JOIN_POS_CAP];
  float s[2][JOIN_STAGE_ROWS];
  uint8_t m[2][JOIN_STAGE_ROWS];
};
struct HeavyTile {
  int roots[JOIN_TILE_ROWS];
  int row[JOIN_CHUNK];
  int key[JOIN_CHUNK];
  // a query's row padded by a word: thread q's fold reads row q, and the
  // rows of a warp's queries fall in 32 different banks
  float s[JOIN_QUERY_GROUP][JOIN_CHUNK + 1];
  uint8_t m[JOIN_QUERY_GROUP][JOIN_CHUNK + 4];
};
union TileSmem {
  LightTile light;
  HeavyTile heavy;
};

// a root's fold: one rounding per operation, in CSR order
struct Fold {
  float acc, cnt;
  bool any;
  __device__ __forceinline__ explicit Fold(int mode)
      : acc(mode == MODE_MAX ? -INFINITY
            : (mode == MODE_MIN ? INFINITY : 0.0f)),
        cnt(0.0f), any(false) {}
  __device__ __forceinline__ void add(int mode, bool sel, float s) {
    any = any || sel;
    if (mode == MODE_MAX) {
      acc = fmaxf(acc, sel ? s : -INFINITY);
    } else if (mode == MODE_MIN) {
      acc = fminf(acc, sel ? s : INFINITY);
    } else if (mode != MODE_NONE) {
      acc = acc + (sel ? s : 0.0f);
      cnt = cnt + (sel ? 1.0f : 0.0f);
    }
  }
  __device__ __forceinline__ float score(int mode, float boost) const {
    const float a = mode == MODE_AVG ? acc / fmaxf(cnt, 1.0f) : acc;
    return (any && mode != MODE_NONE) ? a * boost : 0.0f;
  }
};

// a nested row's key: its path where it is live, else NOT_LIVE
__device__ __forceinline__ int pos_key(const uint8_t* __restrict__ live,
                                       const int* __restrict__ nested_path,
                                       int r) {
  return __ldg(live + r) != 0 ? __ldg(nested_path + r) : NOT_LIVE;
}

// a query's child rows in device memory: a row's match, and its score
// where it matched
struct Gathered {
  const uint8_t* __restrict__ m;
  const float* __restrict__ s;
  __device__ __forceinline__ bool operator()(int r, float& v) const {
    if (__ldg(m + r) == 0) return false;
    v = __ldg(s + r);
    return true;
  }
};

// one root's fold for one query over CSR positions lo .. hi: pos(j, row,
// key) gives a position's row and key, child(row, s) its child's match
// (and score s where it matched); a row is selected where its key is the
// query's path and its child matched
template <typename Pos, typename Child>
__device__ __forceinline__ Fold fold_root(int mode, int po, int lo, int hi,
                                          Pos pos, Child child) {
  Fold f(mode);
  if (po >= 0)
    for (int j = lo; j < hi; ++j) {
      int r, key;
      pos(j, r, key);
      float s = 0.0f;
      const bool sel = key == po && child(r, s);
      f.add(mode, sel, s);
    }
  return f;
}

// block (tile of JOIN_TILE_ROWS rows, group of queries). Thread t's rows
// are d0 + g * QUAD_ROWS + 4 t + c (quad g < 2, c < 4). VEC: Dp a
// multiple of 16 and every pointer 16-byte aligned.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
nested_join_kernel(const float* __restrict__ child_s,
                   const uint8_t* __restrict__ child_m,
                   const uint8_t* __restrict__ live,
                   const int* __restrict__ nested_path,
                   const int* __restrict__ child_start,
                   const int* __restrict__ child_rows,
                   const int* __restrict__ path_ord, int mode, int B, int Dp,
                   const float* __restrict__ boost,
                   float* __restrict__ out_s, uint8_t* __restrict__ out_m) {
  __shared__ __align__(16) TileSmem sm;
  __shared__ int s_red[THREADS / 32];
  __shared__ int s_nheavy;
  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * JOIN_TILE_ROWS;
  const int q0 = blockIdx.y * JOIN_QUERY_GROUP;
  const int nq = min(JOIN_QUERY_GROUP, B - q0);
  // the CSR bounds of the thread's rows: cs[g][c] .. cs[g][c + 1]
  const int end = __ldg(child_start + Dp);
  int cs[2][5];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int r = d0 + g * QUAD_ROWS + 4 * tid;
    int v[4];
    load4<VEC>(child_start, r, Dp, end, v);
#pragma unroll
    for (int c = 0; c < 4; ++c) cs[g][c] = v[c];
    cs[g][4] = __ldg(child_start + min(r + 4, Dp));
  }
  const int p0 = __ldg(child_start + d0);
  const int npos = __ldg(child_start + min(d0 + JOIN_TILE_ROWS, Dp)) - p0;
  int most = 0;
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int c = 0; c < 4; ++c) most = max(most, cs[g][c + 1] - cs[g][c]);
  most = block_reduce<THREADS, true>(most, s_red);
  const bool heavy = npos > JOIN_POS_CAP || most > JOIN_HEAVY_ROWS;

  if (!heavy) {
    // ---- light tile: the positions once, then each query's window
    LightTile& t = sm.light;
    int lo = INT_MAX, hi = -1;
    for (int j = tid; j < npos; j += THREADS) {
      const int r = __ldg(child_rows + p0 + j);
      const int key = pos_key(live, nested_path, r);
      t.row[j] = r;
      t.key[j] = key;
      if (key >= 0) {
        lo = min(lo, r);
        hi = max(hi, r);
      }
    }
    // the reductions' barriers also publish t.row and t.key
    lo = block_reduce<THREADS, false>(lo, s_red);
    hi = block_reduce<THREADS, true>(hi, s_red);
    const int a0 = VEC ? (lo & ~15) : lo;
    const int span = hi < 0 ? 0 : (VEC ? ((hi + 16) & ~15) : hi + 1) - a0;
    const bool staged = hi >= 0 && span <= JOIN_STAGE_ROWS;
    auto stage = [&](int q) {
      const int b = q0 + q;
      if (__ldg(path_ord + b) < 0) return;
      const size_t at = (size_t)b * Dp + a0;
      float* ss = t.s[q & 1];
      uint8_t* mm = t.m[q & 1];
      if (VEC) {
        const int nm = span >> 4, ns = span >> 2;
        for (int i = tid; i < nm + ns; i += THREADS) {
          if (i < nm) cp_async16(mm + 16 * i, child_m + at + 16 * i);
          else cp_async16(ss + 4 * (i - nm), child_s + at + 4 * (i - nm));
        }
      } else {
        for (int i = tid; i < span; i += THREADS) {
          mm[i] = __ldg(child_m + at + i);
          ss[i] = __ldg(child_s + at + i);
        }
      }
    };
    if (staged) stage(0);
    cp_async_commit();
    for (int q = 0; q < nq; ++q) {
      const int b = q0 + q;
      const int po = __ldg(path_ord + b);
      const float bst = __ldg(boost + b);
      const size_t base = (size_t)b * Dp;
      if (staged && q + 1 < nq) stage(q + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();        // query q's window is in slot q & 1
      const float* ss = t.s[q & 1];
      const uint8_t* mm = t.m[q & 1];
      auto pos = [&](int j, int& r, int& key) {
        r = t.row[j];
        key = t.key[j];
      };
      auto from_stage = [&](int r, float& s) {
        if (mm[r - a0] == 0) return false;
        s = ss[r - a0];
        return true;
      };
      const Gathered from_rows{child_m + base, child_s + base};
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        float o[4];
        bool om[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int lo = cs[g][c] - p0, hi = cs[g][c + 1] - p0;
          const Fold f = staged ? fold_root(mode, po, lo, hi, pos, from_stage)
                                : fold_root(mode, po, lo, hi, pos, from_rows);
          o[c] = f.score(mode, bst);
          om[c] = f.any;
        }
        const int r = d0 + g * QUAD_ROWS + 4 * tid;
        store4<VEC>(out_s + base, r, Dp, o);
        store4<VEC>(out_m + base, r, Dp, om);
      }
      __syncthreads();        // slot q & 1 free for query q + 2
    }
    return;
  }

  // ---- heavy tile: light roots by gathers, heavy roots by the CTA
  HeavyTile& h = sm.heavy;
  if (tid == 0) s_nheavy = 0;
  __syncthreads();
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (cs[g][c + 1] - cs[g][c] > JOIN_HEAVY_ROWS)
        h.roots[atomicAdd(&s_nheavy, 1)] = d0 + g * QUAD_ROWS + 4 * tid + c;
  for (int q = 0; q < nq; ++q) {
    const int b = q0 + q;
    const int po = __ldg(path_ord + b);
    const float bst = __ldg(boost + b);
    const size_t base = (size_t)b * Dp;
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = d0 + g * QUAD_ROWS + 4 * tid + c;
        if (r >= Dp || cs[g][c + 1] - cs[g][c] > JOIN_HEAVY_ROWS) continue;
        const Fold f = fold_root(
            mode, po, cs[g][c], cs[g][c + 1],
            [&](int j, int& row, int& key) {
              row = __ldg(child_rows + j);
              key = pos_key(live, nested_path, row);
            },
            Gathered{child_m + base, child_s + base});
        out_s[base + r] = f.score(mode, bst);
        out_m[base + r] = f.any ? 1 : 0;
      }
  }
  __syncthreads();            // the heavy roots' list is complete
  const int nheavy = s_nheavy;
  for (int k = 0; k < nheavy; ++k) {
    const int d = h.roots[k];
    const int lo = __ldg(child_start + d), hi = __ldg(child_start + d + 1);
    Fold f(mode);             // thread q < nq: query q0 + q's fold
    const int po = tid < nq ? __ldg(path_ord + q0 + tid) : -1;
    for (int c0 = lo; c0 < hi; c0 += JOIN_CHUNK) {
      const int len = min(JOIN_CHUNK, hi - c0);
      for (int j = tid; j < len; j += THREADS) {
        const int row = __ldg(child_rows + c0 + j);
        h.row[j] = row;
        h.key[j] = pos_key(live, nested_path, row);
      }
      __syncthreads();
      for (int i = tid; i < nq * len; i += THREADS) {
        const int q = i / len, j = i - q * len;
        const int b = q0 + q;
        const int qpo = __ldg(path_ord + b);
        const size_t base = (size_t)b * Dp;
        float s = 0.0f;
        const bool sel = qpo >= 0 && h.key[j] == qpo &&
                         Gathered{child_m + base, child_s + base}(h.row[j], s);
        h.m[q][j] = sel ? 1 : 0;
        h.s[q][j] = s;
      }
      __syncthreads();
      if (tid < nq && po >= 0)
        for (int j = 0; j < len; ++j)
          f.add(mode, h.m[tid][j] != 0, h.s[tid][j]);
      __syncthreads();        // the chunk's slots are staged again
    }
    if (tid < nq) {
      const size_t at = (size_t)(q0 + tid) * Dp + d;
      out_s[at] = f.score(mode, __ldg(boost + q0 + tid));
      out_m[at] = f.any ? 1 : 0;
    }
  }
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
  const long long tiles =
      ((long long)Dp + JOIN_TILE_ROWS - 1) / JOIN_TILE_ROWS;
  const int groups = (B + JOIN_QUERY_GROUP - 1) / JOIN_QUERY_GROUP;
  if (tiles > 0x7fffffffLL || groups > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const bool vec = Dp % 16 == 0 &&
                   aligned16(child_s, child_m, out_s, out_m, child_start);
  const dim3 grid((unsigned)tiles, (unsigned)groups);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    nested_join_kernel<true><<<grid, THREADS, 0, st>>>(
        child_s, child_m, live, nested_path, child_start, child_rows,
        path_ord, mode, B, Dp, boost, out_s, out_m);
  else
    nested_join_kernel<false><<<grid, THREADS, 0, st>>>(
        child_s, child_m, live, nested_path, child_start, child_rows,
        path_ord, mode, B, Dp, boost, out_s, out_m);
  return (int)cudaGetLastError();
}

extern "C" const char* nested_join_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
