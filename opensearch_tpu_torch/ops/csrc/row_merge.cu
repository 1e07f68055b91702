// K21 row_merge: the merge of the multi-shard query phase on one card, and
// its key entry row_value_key.
//
// Replaces opensearch_tpu/parallel/distributed.py's runner merge
// (local_query_phase: the intra-device top-k over the packed rows, the
// all_gather, the replicated top-k and the psum of totals) with
// opensearch_tpu/ops/topk.py:value_merge_key for numeric sorts.
//
// row_value_key: out f32 [Dp], a row's merge key of a numeric sort:
// unique_f32[clip(max_rank)] (desc) or -unique_f32[clip(min_rank)] (asc),
// MISSING_VALUE_KEY (-1e30) where the doc has no value. One thread a doc.
//
// row_merge: R <= 8 rows of K3's keyed output (keys | scores | indices |
// total, 3 k_r + 1 words at the start of row r of an [R, W] buffer) merged
// into the k best, out f32 [4k + 1 + R]: keys | scores | rows | ords (the
// last two as int32 bits) | the total | the R pruned counts. The order is
// lax.top_k's over the row-major concatenation: key descending (-0.0 below
// +0.0, a total order on the bits), then the lowest position, i.e. row
// ascending, then rank in row.
//
// Precondition: every row arrives sorted, its k_r keys non-increasing in
// ord_key (below) with equal keys in lane order. K3-keyed writes its rows
// so (masked_topk.cu keyed_out_kernel: the keys of its sorted 64-bit lane
// words, whatever the bits: -inf padding, +-0.0, NaN of either sign), and
// parallel/distributed.py's run_rows, the only caller, hands them over as
// they are.
//
// What bounds it on an H100: latency. At k = 10 the rows hold 50-80 lanes;
// at k = 65,536 and 8 rows 524,288 lanes (4 MB of keys, scores and ords)
// of which k are written.
//
// Design: one launch, no scratch, no sort. Lane j of row r with u =
// ord_key(key) has the merged rank
//   j + sum over r' < r of #{lanes of r' with ord_key >= u}
//     + sum over r' > r of #{lanes of r' with ord_key >  u},
// each count a binary search in the sorted row r'. A lane whose rank is
// below k writes its four words into slot `rank`; the ranks are a
// permutation, so no two lanes meet. Only a row's first min(k_r, k) lanes
// can place, and only they are searched and searched in. A CTA takes 256
// consecutive lanes of one row: two searches per partner row (its first
// and its last key) bound the window all its lanes land in; a CTA whose
// every lane ranks at or past k stops there, windows of at most WIN keys
// are staged in shared memory, and each lane searches only its window.
// CTAs past the lane tiles write the padding slots (-inf, 0, 0, 0) past
// the rows' lanes; block 0 also adds the row totals in row order
// (integers: exact) and copies the pruned counts.

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_ROWS = 8;
constexpr int WIN = 512;  // keys of a partner's window staged in shared memory
constexpr float MISSING_VALUE_KEY = -1e30f;

// per row: k_r (the width of its layout), n_r = min(k_r, k) (the lanes
// that can place), and the first CTA of its lane tiles; tile[R] is the
// first padding CTA
struct RowTable {
  int k[MAX_ROWS];
  int n[MAX_ROWS];
  int tile[MAX_ROWS + 1];
};

__device__ __forceinline__ unsigned ord_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void __launch_bounds__(THREADS)
value_key_kernel(const float* __restrict__ uniq, const int* __restrict__ rank,
                 const uint8_t* __restrict__ exists, int n_uniq, int Dp,
                 int desc, float* __restrict__ out) {
  const int hi = n_uniq - 1;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < Dp;
       i += gridDim.x * blockDim.x) {
    int r = rank[i];
    r = r < 0 ? 0 : (r > hi ? hi : r);
    const float v = uniq[r];
    out[i] = exists[i] ? (desc ? v : -v) : MISSING_VALUE_KEY;
  }
}

// lanes of a[0, n) (sorted by ord_key, non-increasing) that come before
// a key u from another row: ord_key >= u for an earlier row (ge), > u for
// a later one
__device__ __forceinline__ int count_ahead(const float* a, int n, unsigned u,
                                           bool ge) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const unsigned v = ord_key(a[mid]);
    if (ge ? v >= u : v > u) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// grid: tab.tile[R] lane tiles (THREADS lanes of one row each), then the
// padding CTAs
__global__ void __launch_bounds__(THREADS)
merge_kernel(const float* __restrict__ buf, int W, int R, RowTable tab,
             int k, int L, const int* __restrict__ pruned,
             int* __restrict__ out) {
  __shared__ int lo_s[MAX_ROWS], hi_s[MAX_ROWS];
  __shared__ float win[MAX_ROWS][WIN];
  const int b = blockIdx.x, t = threadIdx.x;
  if (b == 0 && t == 0) {
    int total = 0;
    for (int r = 0; r < R; ++r)
      total += __float_as_int(buf[(size_t)r * W + 3 * tab.k[r]]);
    out[4 * k] = total;
    for (int r = 0; r < R; ++r) out[4 * k + 1 + r] = pruned[r];
  }
  if (b >= tab.tile[R]) {
    // slots past the rows' lanes
    const int pad_ctas = gridDim.x - tab.tile[R];
    for (int s = (L < k ? L : k) + (b - tab.tile[R]) * THREADS + t; s < k;
         s += pad_ctas * THREADS) {
      out[s] = __float_as_int(-INFINITY);
      out[k + s] = 0;
      out[2 * k + s] = 0;
      out[3 * k + s] = 0;
    }
    return;
  }
  int r = 0;
  while (b >= tab.tile[r + 1]) ++r;
  const int j0 = (b - tab.tile[r]) * THREADS;
  const int j1 = min(j0 + THREADS, tab.n[r]);
  const float* row = buf + (size_t)r * W;
  // the window of each partner row: thread p counts ahead of the tile's
  // first key, thread MAX_ROWS + p ahead of its last
  if (t < 2 * MAX_ROWS) {
    const int p = t % MAX_ROWS;
    int c = 0;
    if (p < R && p != r)
      c = count_ahead(buf + (size_t)p * W, tab.n[p],
                      ord_key(row[t < MAX_ROWS ? j0 : j1 - 1]), p < r);
    (t < MAX_ROWS ? lo_s : hi_s)[p] = c;
  }
  __syncthreads();
  int first = j0;
  for (int p = 0; p < R; ++p) first += lo_s[p];
  if (first >= k) return;  // every lane of the tile ranks at or past k
  for (int p = 0; p < R; ++p) {
    const int w = hi_s[p] - lo_s[p];
    if (w <= WIN) {
      const float* src = buf + (size_t)p * W + lo_s[p];
      for (int i = t; i < w; i += THREADS) win[p][i] = src[i];
    }
  }
  __syncthreads();
  const int j = j0 + t;
  if (j >= j1) return;
  const float key = row[j];
  const unsigned u = ord_key(key);
  int rank = j;
  for (int p = 0; p < R; ++p) {
    if (p == r) continue;
    const int lo = lo_s[p], w = hi_s[p] - lo;
    const float* a = w <= WIN ? win[p] : buf + (size_t)p * W + lo;
    rank += lo + count_ahead(a, w, u, p < r);
  }
  if (rank >= k) return;
  const int kr = tab.k[r];
  out[rank] = __float_as_int(key);
  out[k + rank] = __float_as_int(row[kr + j]);
  out[2 * k + rank] = r;
  out[3 * k + rank] = __float_as_int(row[2 * kr + j]);
}

int chunks_for(int n) {
  int g = (n + THREADS - 1) / THREADS;
  if (g < 1) g = 1;
  if (g > 1024) g = 1024;
  return g;
}

}  // namespace

// uniq f32 [n_uniq], rank / exists [Dp] (rank: max_rank for desc, min_rank
// for asc); out f32 [Dp].
extern "C" int row_value_key(const float* uniq, const int* rank,
                             const uint8_t* exists, int n_uniq, int Dp,
                             int desc, float* out, void* stream) {
  if (Dp <= 0) return 0;
  if (n_uniq <= 0) return (int)cudaErrorInvalidValue;
  value_key_kernel<<<chunks_for(Dp), THREADS, 0, (cudaStream_t)stream>>>(
      uniq, rank, exists, n_uniq, Dp, desc, out);
  return (int)cudaGetLastError();
}

// buf f32 [R, W] on the card, each row sorted (the precondition above);
// ks: R host ints (3 k_r + 1 <= W); pruned i32 [R] on the card; 0 < k;
// out int32 [4k + 1 + R].
extern "C" int row_merge(const float* buf, int R, int W, const int* ks,
                         const int* pruned, int k, int* out, void* stream) {
  if (R <= 0 || R > MAX_ROWS || k <= 0) return (int)cudaErrorInvalidValue;
  RowTable tab;
  int L = 0, tiles = 0;
  for (int r = 0; r < MAX_ROWS; ++r) {
    const int kr = r < R ? ks[r] : 0;
    if (kr < 0 || 3 * kr + 1 > W) return (int)cudaErrorInvalidValue;
    tab.k[r] = kr;
    tab.n[r] = kr < k ? kr : k;
    tab.tile[r] = tiles;
    tiles += (tab.n[r] + THREADS - 1) / THREADS;
    L += kr;
  }
  tab.tile[MAX_ROWS] = tiles;
  const int pad = k - (L < k ? L : k);
  int pad_ctas = (pad + THREADS - 1) / THREADS;
  if (pad_ctas > 64) pad_ctas = 64;
  const int grid = tiles + pad_ctas;  // k > 0: L >= k or pad > 0
  merge_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      buf, W, R, tab, k, L, pruned, out);
  return (int)cudaGetLastError();
}

extern "C" const char* row_merge_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
