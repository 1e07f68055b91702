// K3 masked_topk: the dense query phase's eligibility, total and exact
// masked top-k over per-doc scores of B queries, out f32 [B, 2k+1] packed
// rows (k scores | k doc indices as int32 bits | total as int32 bits).
//
// Replaces opensearch_tpu/search/executor.py:build_batched_query_phase
// (`one`: eligible = matches & live & root & in_seg & score >= min_score,
// total = sum(eligible), lax.top_k over the masked scores via
// _topk_or_empty, packed by _pack_row).
//
// A second entry, masked_topk_threshold, serves selections past MAX_K (a
// `knn` node's k, an IVF probe's block budget), whose callers need the SET
// of the k winners, not their order: mark u8 [B, Dp] is 1 at every
// eligible finite lane among the row's k best keys. The keys are unique,
// so exactly the k winners of masked_topk are marked; no sort, so any k.
//
// A third entry, masked_topk_keyed, is the general path's query phase
// (opensearch_tpu/search/executor.py:build_query_phase): the same
// eligibility and total, but the top-k is taken over a per-doc sort key
// shared by the batch (K13's output; the scores themselves when no key is
// given), and the output carries the keys, the scores at the winners and
// the winners: f32 [B, 3k+1]. Its k reaches 65,536 (search_after's
// k-growth), past one CTA's shared memory: the k winners sort in global
// memory (key_sort.cuh: runs of 16,384 bitonic-sorted in shared memory,
// then merge passes).
//
// The order. Every lane gets one unique, order-preserving 64-bit key:
// (order-preserving u32 of the masked f32 value) << 32 | (~index), so key
// descending is value descending with ties to the lowest index, -0.0
// below +0.0, NaN by its bits, and -inf (ineligible) lanes still order by
// index after every eligible one: lax.top_k's total order, which
// torch.topk does not promise. The k winners are the k largest keys.
//
// What bounds it on an H100: bytes. The least work reads each lane's
// value and match flag once per query, the shared live / root masks (and
// the keyed entry's key) once, and writes the winners (the threshold
// entry: a byte a lane); the selection itself is a few integer ops a lane.
//
// Design: an exact radix select per row in the manner of AIR top-k (Zhang
// et al., SC '23), over six digits of the 64-bit key (five of 11 bits, the
// last of 9). The select reads the full input twice, then only the keys
// that can still hold the k-th one:
// - Pass 0 reads every lane once: its eligibility (the row's total) and
//   the histogram of its key's first digit in shared memory, added to the
//   row's global histogram. The CTA that finishes last (a counter) scans
//   the 2,048 bins from the top and fixes the bin that holds the k-th key,
//   the rank still needed inside it (krem) and whether the bin's keys fit
//   the row's candidate buffer.
// - Pass p = 1..6 reads the keys of the bin fixed last: pass 1 every lane
//   again, later passes the candidate buffer pass p - 1 filled. A key
//   above the bin wins: it is appended to the row's winners (masked_topk,
//   masked_topk_keyed) or marked (the threshold entry, whose pass 1 writes
//   every lane's mark). A key in the bin is appended to the other
//   candidate buffer (the two ping-pong) and counted in the next digit's
//   histogram; the last CTA fixes the next digit. When the bin's count
//   equals krem, every key in it wins and the next pass ends the row. The
//   keys are unique, so the last digit's bin holds one key: a row ends by
//   pass 6. Pass 1's two digits lie in the key's high word, so it works
//   on that word alone and builds a whole key only to store it.
// - Appends: a warp reserves a chunk of up to 64 candidate slots with one
//   atomic and fills it over its tiles (no barrier); the unused tail of
//   its last chunk is zeroed, and the reader skips key 0 (no lane's key:
//   its low word is ~index >= 2^31). Winners take one atomic per warp and
//   tile that has any (a row has at most k).
// - The buffer holds cap = max(Dp / 8, min(Dp, 4,096)) keys a row; a bin
//   is buffered when its keys and the chunk tails the grid's warps may
//   leave (at most a quarter of cap) fit. The overflow rule: a bin that
//   does not fit is not buffered, and the pass after reads the input
//   again, keeping the lanes whose key matches the digits fixed so far.
//   That happens on keys that share their high bits (all values equal;
//   more lanes at -inf than fit when fewer lanes than k are eligible); the
//   row's full_reads counter (RowState) says how many passes read the
//   input. The threshold entry ends at pass 1 when the first digit's bin
//   is the -inf bin (its keys are never marked).
// - Every decision is made on the card: each entry launches a fixed
//   sequence (one or two memsets, pass 0, passes 1-6, the output), a pass
//   whose row has ended returns at once, and the host reads nothing back,
//   so one call is one CUDA-graph-capturable launch sequence.
// - Loads: 16-byte score / key loads and 4-byte flag loads where Dp % 4 ==
//   0 and the pointers are aligned (the threshold's mark stores too), one
//   lane at a time otherwise. A CTA of 256 threads walks tiles of 1,024
//   lanes (or buffered keys), 4 a thread; a row gets at least 4 tiles a
//   CTA and 2,048 / B CTAs (8 to 1,024), so one row still fills the card.
//   Passes 1-6 that read the input ask for the CTA's next tile with
//   Hopper's bulk L2 prefetch (cp.async.bulk.prefetch.L2) where Dp % 16 ==
//   0 and every prefetched array starts 16-byte aligned, as PTX requires.
// - After the select: masked_topk bitonic-sorts its k <= 16,384 winners
//   per row in shared memory; masked_topk_keyed sorts its winners with
//   key_sort.cuh and gathers the scores at them.
// The version this replaces ran up to 8 histogram passes of 8-bit digits,
// each re-reading the whole input, and a collect pass (up to 9 full reads,
// 17-19 launches).
//
// Tried on the H100 and not kept, each slower than what the file keeps
// (graph replays of K3 at B=32 Dp=2^20, the threshold entry and the keyed
// entry's 2^24-lane row): a warp match vote before each shared-memory bin
// add; 8 or 16 lanes a thread a tile; one append atomic per warp and tile
// (on the keyed row: one counter for 1.3M keys); a block scan and one
// atomic per CTA and tile; registers holding the next tile's loads (64-80
// registers a thread); __launch_bounds__(256, 6) (faster at B=32, slower
// on the keyed row); the L2 prefetch in pass 0 too. chip_smoke.py's
// `--cells topk` prints each launch's device time.
//
// Scratch (int64 slots), per row: a RowState (8) | two u32 histograms of
// 2,048 bins (2,048) | two candidate buffers of cap keys (2 cap); then,
// for the whole batch, masked_topk's winners (k a row) or
// masked_topk_keyed's winners and its sort's second buffer (p2 a row
// each, p2 the power of two >= k). ops/topk.py:select_scratch_slots
// computes the same sizes.

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "key_sort.cuh"

namespace {

constexpr int THREADS = 256;           // a select CTA
constexpr int NWARPS = THREADS / 32;
constexpr int GROUP = 4;               // lanes (or keys) a thread takes a tile
constexpr int TILE = THREADS * GROUP;  // 1,024
constexpr int MAX_CHUNK = 64;          // candidate slots a warp reserves
constexpr int DIGITS = 6;              // 5 x 11 bits, then 9
constexpr int BINS = 2048;
constexpr int MIN_CAP = 4096;          // candidate keys a row at least
constexpr int STATE_SLOTS = 8;         // int64 slots of a RowState
constexpr int HIST_SLOTS = BINS;       // int64 slots of two u32 histograms
constexpr int SORT_THREADS = 1024;
constexpr int MAX_K = 16384;

enum Entry { TOPK, THRESH, KEYED };

// digit p of a key: its bits [shift, shift + width)
__host__ __device__ __forceinline__ int digit_shift(int p) {
  return p < 5 ? 53 - 11 * p : 0;
}
__host__ __device__ __forceinline__ unsigned digit_bins(int p) {
  return p < 5 ? 2048u : 512u;
}
__device__ __forceinline__ unsigned digit_of(unsigned long long key, int p) {
  return (unsigned)(key >> digit_shift(p)) & (digit_bins(p) - 1u);
}
// the bits of digits 0..p-1
__device__ __forceinline__ unsigned long long high_mask(int p) {
  return p == 0 ? 0ull : ~0ull << digit_shift(p - 1);
}

// a row's select state, zeroed before pass 0
struct RowState {
  unsigned long long prefix;  // the digits fixed so far, in place
  unsigned krem;       // rank of the k-th key among the keys of the bin
  unsigned last;       // 0, or the pass that ends the row
  unsigned take;       // every key of the bin fixed last wins
  unsigned src_buf;    // the next pass reads the bin's keys from a buffer
  unsigned dst_buf;    // the next pass buffers the keys of its bin
  unsigned ncand[2];   // keys in each candidate buffer
  unsigned nwin;       // winners written
  unsigned ctas;       // CTAs of the running pass that have finished
  int total;           // eligible lanes
  unsigned full_reads; // passes that read the input
  unsigned pad[3];
};
static_assert(sizeof(RowState) == STATE_SLOTS * 8, "RowState layout");

__device__ __forceinline__ unsigned ord_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float ord_val(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

struct Rows {
  const float* scores;
  const uint8_t* matches;
  const uint8_t* live;
  const uint8_t* root;
  const float* min_score;
  int Dp;
  int num_docs;
  const float* key;  // masked_topk_keyed: the shared [Dp] sort key or null
};

// a lane's key from the high word ord_key(eligible ? value : -inf)
__device__ __forceinline__ unsigned long long lane_key(unsigned hi, int i) {
  return ((unsigned long long)hi << 32) | (0xffffffffu - (unsigned)i);
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return (int)(0xffffffffu - (unsigned)key);
}

// the threshold entry marks a winner whose masked value is finite
// (eligible, not -inf, not NaN)
__device__ __forceinline__ bool markable(unsigned long long key) {
  return ord_val((unsigned)(key >> 32)) > -INFINITY;
}

struct Select {
  Rows r;
  RowState* st;              // [B]
  unsigned* hist;            // [B][2][BINS]
  unsigned long long* buf;   // [B][2][cap]
  unsigned long long* win;   // [B][wstride] winners (TOPK, KEYED)
  uint8_t* mark;             // [B][Dp] (THRESH)
  int k;
  int wstride;
  unsigned cap;
  bool prefetch;  // every prefetched array 16-byte aligned, Dp % 16 == 0
};

// a thread's 4 adjacent lanes of a tile's 1,024, as loaded
struct InputRaw {
  float s[GROUP], kv[GROUP];
  uint8_t m[GROUP], l[GROUP], t[GROUP];
};

// the loads of this thread's lanes base + 4 tid .. + 3 of row q. VEC: Dp %
// 4 == 0 and the pointers are aligned, so the 4 lanes are whole or wholly
// past Dp
template <Entry E, bool VEC>
__device__ __forceinline__ void load_input(const Rows& r, int q, int base,
                                           InputRaw& x) {
  const size_t row = (size_t)q * r.Dp;
  const int i0 = base + (int)threadIdx.x * GROUP;
  if (VEC) {
    if (i0 < r.Dp) {
      const float4 s4 =
          __ldg(reinterpret_cast<const float4*>(r.scores + row + i0));
      const uchar4 m4 =
          __ldg(reinterpret_cast<const uchar4*>(r.matches + row + i0));
      const uchar4 l4 = __ldg(reinterpret_cast<const uchar4*>(r.live + i0));
      const uchar4 t4 = __ldg(reinterpret_cast<const uchar4*>(r.root + i0));
      x.s[0] = s4.x; x.s[1] = s4.y; x.s[2] = s4.z; x.s[3] = s4.w;
      x.m[0] = m4.x; x.m[1] = m4.y; x.m[2] = m4.z; x.m[3] = m4.w;
      x.l[0] = l4.x; x.l[1] = l4.y; x.l[2] = l4.z; x.l[3] = l4.w;
      x.t[0] = t4.x; x.t[1] = t4.y; x.t[2] = t4.z; x.t[3] = t4.w;
      if (E == KEYED && r.key != nullptr) {
        const float4 k4 = __ldg(reinterpret_cast<const float4*>(r.key + i0));
        x.kv[0] = k4.x; x.kv[1] = k4.y; x.kv[2] = k4.z; x.kv[3] = k4.w;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      const int i = i0 + j;
      if (i < r.Dp) {
        x.s[j] = __ldg(r.scores + row + i);
        x.m[j] = __ldg(r.matches + row + i);
        x.l[j] = __ldg(r.live + i);
        x.t[j] = __ldg(r.root + i);
        if (E == KEYED && r.key != nullptr) x.kv[j] = __ldg(r.key + i);
      }
    }
  }
}

// Hopper's bulk L2 prefetch of the tile a CTA reads next (one thread
// issues it; no registers, no wait): that tile's loads then hit L2. Only
// where every array's tile is 16-byte aligned (s.prefetch) and whole.
template <Entry E>
__device__ __forceinline__ void prefetch_tile(const Select& s, int q,
                                              int tile, int ntiles) {
  const Rows& r = s.r;
  if (!s.prefetch || threadIdx.x != 0 || tile >= ntiles ||
      (tile + 1) * TILE > r.Dp)
    return;
  const size_t row = (size_t)q * r.Dp;
  const size_t i0 = (size_t)tile * TILE;
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
               :: "l"(r.scores + row + i0), "r"(TILE * 4) : "memory");
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
               :: "l"(r.matches + row + i0), "r"(TILE) : "memory");
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
               :: "l"(r.live + i0), "r"(TILE) : "memory");
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
               :: "l"(r.root + i0), "r"(TILE) : "memory");
  if (E == KEYED && r.key != nullptr)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
                 :: "l"(r.key + i0), "r"(TILE * 4) : "memory");
}

// the high words of the keys of the lanes load_input loaded (valid: lane
// < Dp): ord_key of the masked value; elig counts the eligible lanes
template <Entry E>
__device__ __forceinline__ void input_his(const Rows& r, float ms, int base,
                                          const InputRaw& x,
                                          unsigned hi[GROUP],
                                          bool valid[GROUP], int& elig) {
  const int i0 = base + (int)threadIdx.x * GROUP;
#pragma unroll
  for (int j = 0; j < GROUP; ++j) {
    const int i = i0 + j;
    valid[j] = i < r.Dp;
    const bool e = valid[j] && x.m[j] && x.l[j] && x.t[j] &&
                   i < r.num_docs && x.s[j] >= ms;
    elig += e;
    const float v = (E == KEYED && r.key != nullptr) ? x.kv[j] : x.s[j];
    hi[j] = ord_key(e ? v : -INFINITY);
  }
}

// A warp's places in a row's winners (exact: one atomic per warp and tile
// with winners) and in a candidate buffer (in chunks: one atomic per
// `chunk` keys, no barrier). A warp fills a chunk, then reserves the next;
// its last chunk's unused tail is zeroed at the end of the pass, and key 0
// (no lane's key: its low word is ~index >= 2^31) is skipped by the reader.
struct WarpChunk {
  unsigned base;  // the warp's current chunk
  unsigned used;  // of its slots
  unsigned len;
};

// a lane's candidate slots: its m-th candidate goes to slot(m)
struct Slots {
  unsigned base, rel0, len, next;
  __device__ __forceinline__ unsigned slot(unsigned m) const {
    const unsigned rel = rel0 + m;
    return rel < len ? base + rel : next + (rel - len);
  }
};

// this lane's first place for its nw winners and the slots of its nc
// candidates (at most 4 each); every lane of the warp calls it
__device__ __forceinline__ void warp_append(unsigned nw, unsigned nc,
                                            unsigned* wctr, unsigned* cctr,
                                            unsigned chunk, WarpChunk& a,
                                            unsigned& wpos, Slots& sl) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned x = (nw << 16) | nc;
  unsigned incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= (unsigned)o) incl += y;
  }
  const unsigned tot = __shfl_sync(0xffffffffu, incl, 31);
  const unsigned excl = incl - x;
  const unsigned tw = tot >> 16, tc = tot & 0xffffu;
  const unsigned room = a.len - a.used;
  const unsigned need =
      tc > room ? (tc - room + chunk - 1) / chunk * chunk : 0u;
  unsigned wb = 0, nb = 0;
  if (lane == 31) {
    if (tw) wb = atomicAdd(wctr, tw);
    if (need) nb = atomicAdd(cctr, need);
  }
  wpos = __shfl_sync(0xffffffffu, wb, 31) + (excl >> 16);
  nb = __shfl_sync(0xffffffffu, nb, 31);
  sl = Slots{a.base, a.used + (excl & 0xffffu), a.len, nb};
  if (need) {
    a.used = a.used + tc - a.len;
    a.base = nb;
    a.len = need;
  } else {
    a.used += tc;
  }
}

// candidate slots a warp reserves at once, and the keys a bin may hold to
// be buffered: each warp of the grid may leave chunk - 1 slots unused, so
// that slack comes off the buffer's cap (at most a quarter of it)
__device__ __forceinline__ unsigned append_chunk(unsigned cap) {
  const unsigned warps = gridDim.x * NWARPS;
  unsigned c = cap / (4u * warps);
  if (c > (unsigned)MAX_CHUNK) c = MAX_CHUNK;
  return c < 1u ? 1u : c;
}
__device__ __forceinline__ unsigned buffer_room(unsigned cap) {
  return cap - gridDim.x * NWARPS * (append_chunk(cap) - 1u);
}

// Run by every thread of the CTA that finished a pass last: scans row q's
// histogram of digit p (over the keys of the bin fixed before, krem of
// which are still needed) from the top, fixes digit p's bin, decides what
// the next pass does, and clears the histogram for pass p + 2.
template <Entry E>
__device__ __forceinline__ void scan_digit(RowState* st, unsigned* gh,
                                           int p, unsigned krem,
                                           bool buffered, unsigned cap,
                                           unsigned* s_scan) {
  const int nb = (int)digit_bins(p);
  const int per = nb / THREADS;  // 8 or 2 bins a thread
  const int top = nb - 1 - (int)threadIdx.x * per;
  unsigned c[BINS / THREADS];
  unsigned sum = 0;
  for (int j = 0; j < per; ++j) {
    c[j] = __ldcg(gh + top - j);
    sum += c[j];
  }
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= (unsigned)o) incl += y;
  }
  if (lane == 31) s_scan[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned tot = 0;
    for (int w = 0; w < NWARPS; ++w) {
      const unsigned t = s_scan[w];
      s_scan[w] = tot;
      tot += t;
    }
  }
  __syncthreads();
  const unsigned excl = s_scan[warp] + incl - sum;
  // the one thread whose bins hold the krem-th key from the top
  if (excl < krem && krem <= excl + sum) {
    unsigned cum = excl;
    for (int j = 0; j < per; ++j) {
      if (cum + c[j] >= krem) {
        const unsigned bin = (unsigned)(top - j), cnt = c[j];
        const unsigned kr = krem - cum;
        // the threshold entry never marks the -inf bin's keys (bins 0-3 of
        // the first digit: -inf and negative NaNs)
        const bool take = cnt == kr || (E == THRESH && p == 0 && bin <= 3u);
        st->prefix |= (unsigned long long)bin << digit_shift(p);
        st->krem = kr;
        st->take = take;
        if (take) st->last = (unsigned)p + 1u;
        st->src_buf = buffered;
        st->dst_buf = !take && cnt <= buffer_room(cap);
        st->ncand[(p + 1) & 1] = 0u;
        break;
      }
      cum += c[j];
    }
  }
  for (int j = 0; j < per; ++j) gh[top - j] = 0u;
}

// the end of a pass in every CTA: the CTA's histogram into the row's, then
// the CTA that finishes last scans it (hist_on) and counts the pass's read
template <Entry E>
__device__ __forceinline__ void end_pass(unsigned* hist, unsigned cap,
                                         RowState* st, int q, int p,
                                         bool hist_on, bool worked,
                                         bool read_input, unsigned krem,
                                         bool buffered, unsigned* s_hist,
                                         unsigned* s_scan, int* s_last) {
  unsigned* gh = hist + ((size_t)q * 2 + (p & 1)) * BINS;
  if (hist_on && worked) {
    __syncthreads();
    for (int d = threadIdx.x; d < (int)digit_bins(p); d += THREADS)
      if (s_hist[d]) atomicAdd(&gh[d], s_hist[d]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *s_last = atomicAdd(&st->ctas, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  if (hist_on) scan_digit<E>(st, gh, p, krem, buffered, cap, s_scan);
  if (threadIdx.x == 0) {
    st->ctas = 0u;
    st->full_reads += read_input;
  }
}

// pass 0: every lane's eligibility (the total) and the first digit's
// histogram. grid (CTAs a row, B)
template <Entry E, bool VEC>
__global__ void __launch_bounds__(THREADS) first_pass_kernel(Select s) {
  __shared__ unsigned s_hist[BINS];
  __shared__ unsigned s_scan[NWARPS];
  __shared__ int s_total, s_last;
  const int q = blockIdx.y;
  RowState* st = s.st + q;
  const bool hist_on = s.k > 0;
  const int ntiles = (s.r.Dp + TILE - 1) / TILE;
  const bool worked = (int)blockIdx.x < ntiles;
  if (hist_on && worked)
    for (int d = threadIdx.x; d < BINS; d += THREADS) s_hist[d] = 0u;
  if (threadIdx.x == 0) s_total = 0;
  __syncthreads();
  const float ms = s.r.min_score[q];
  int elig = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    InputRaw x;
    load_input<E, VEC>(s.r, q, t * TILE, x);
    unsigned hi[GROUP];
    bool valid[GROUP];
    input_his<E>(s.r, ms, t * TILE, x, hi, valid, elig);
    if (hist_on) {
#pragma unroll
      for (int j = 0; j < GROUP; ++j)
        if (valid[j]) atomicAdd(&s_hist[hi[j] >> 21], 1u);  // digit 0
    }
  }
  elig = __reduce_add_sync(0xffffffffu, elig);
  if ((threadIdx.x & 31) == 0 && elig) atomicAdd(&s_total, elig);
  __syncthreads();
  if (threadIdx.x == 0 && s_total) atomicAdd(&st->total, s_total);
  if (!hist_on) {
    if (blockIdx.x == 0 && threadIdx.x == 0) st->full_reads = 1u;
    return;
  }
  end_pass<E>(s.hist, s.cap, st, q, 0, true, worked, true, (unsigned)s.k,
              false, s_hist, s_scan, &s_last);
}

// what a pass p >= 1 does with one row
struct PassPlan {
  int p;
  bool take;                 // every key of the bin fixed last wins
  bool to_buf;               // the bin's keys go to the other buffer
  unsigned b;                // the bin fixed last (digit p - 1)
  unsigned chunk;            // candidate slots a warp reserves at once
  unsigned long long* win;   // the row's winners (TOPK, KEYED)
  unsigned long long* dst;   // the other candidate buffer
  uint8_t* mark;             // the row's marks (THRESH)
};

// one tile's keys (in: a key of the bin fixed before the last one) in a
// pass p >= 1: winners out, the last bin's keys to the next digit's
// histogram and the other buffer. Every lane of the warp calls it
template <Entry E, bool VEC>
__device__ __forceinline__ void pass_tile(const Select& s, RowState* st,
                                          const PassPlan& pl, int base,
                                          const unsigned long long key[GROUP],
                                          const bool in[GROUP],
                                          const unsigned d[GROUP],
                                          const unsigned nd[GROUP],
                                          unsigned* s_hist, WarpChunk& app) {
  // d: the key's digit p - 1, nd: its digit p
  bool w[GROUP], c[GROUP];
  unsigned nw = 0, nc = 0;
#pragma unroll
  for (int j = 0; j < GROUP; ++j) {
    w[j] = in[j] && (d[j] > pl.b || (pl.take && d[j] == pl.b));
    c[j] = in[j] && !pl.take && d[j] == pl.b;
    nw += w[j];
    nc += c[j] && pl.to_buf;
  }
  if (E == THRESH) {
    if (pl.p == 1) {
      // pass 1 reads every lane and writes every lane's mark
      const int i0 = base + (int)threadIdx.x * GROUP;
      if (VEC) {
        if (i0 < s.r.Dp) {
          uchar4 m4;
          m4.x = w[0] && markable(key[0]);
          m4.y = w[1] && markable(key[1]);
          m4.z = w[2] && markable(key[2]);
          m4.w = w[3] && markable(key[3]);
          *reinterpret_cast<uchar4*>(pl.mark + i0) = m4;
        }
      } else {
#pragma unroll
        for (int j = 0; j < GROUP; ++j)
          if (i0 + j < s.r.Dp) pl.mark[i0 + j] = w[j] && markable(key[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < GROUP; ++j)
        if (w[j] && markable(key[j])) pl.mark[key_index(key[j])] = 1;
    }
    nw = 0;
  }
  if (!pl.take) {
#pragma unroll
    for (int j = 0; j < GROUP; ++j)
      if (c[j]) atomicAdd(&s_hist[nd[j]], 1u);
  }
  if (__any_sync(0xffffffffu, (nw | nc) != 0u)) {
    unsigned wpos;
    Slots sl;
    warp_append(nw, nc, &st->nwin, &st->ncand[pl.p & 1], pl.chunk, app,
                wpos, sl);
    unsigned m = 0;
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      if (E != THRESH && w[j]) {
        if (wpos < (unsigned)s.wstride) pl.win[wpos] = key[j];
        ++wpos;
      }
      if (pl.to_buf && c[j]) {
        const unsigned at = sl.slot(m++);
        if (at < s.cap) pl.dst[at] = key[j];
      }
    }
  }
}

// pass p = 1..6: the keys of the bin fixed last (pass 1: every lane; later
// the candidate buffer, or the input filtered by the digits fixed before
// the last one). Winners out, the bin's keys to the other buffer and to the
// next digit's histogram. grid (CTAs a row, B)
template <Entry E, bool VEC, bool FIRST>
__global__ void __launch_bounds__(THREADS) pass_kernel(Select s, int p) {
  __shared__ unsigned s_hist[BINS];
  __shared__ unsigned s_scan[NWARPS];
  __shared__ int s_last;
  const int q = blockIdx.y;
  RowState* st = s.st + q;
  const unsigned last = st->last;
  if (last != 0u && (unsigned)p > last) return;  // the row has ended
  PassPlan pl;
  pl.p = p;
  pl.take = st->take != 0u || p == DIGITS;
  pl.to_buf = st->dst_buf != 0u;
  pl.chunk = append_chunk(s.cap);
  const bool from_buf = st->src_buf != 0u;
  const unsigned krem = st->krem;
  const unsigned long long prefix = st->prefix;
  pl.b = digit_of(prefix, p - 1);
  const unsigned long long hmask = high_mask(p - 1);
  const unsigned long long hpfx = prefix & hmask;
  const unsigned nbuf = st->ncand[(p - 1) & 1];
  const int n = from_buf ? (int)(nbuf < s.cap ? nbuf : s.cap) : s.r.Dp;
  const int ntiles = (n + TILE - 1) / TILE;
  const bool worked = (int)blockIdx.x < ntiles;
  const unsigned long long* src =
      s.buf + ((size_t)q * 2 + ((p - 1) & 1)) * s.cap;
  pl.dst = s.buf + ((size_t)q * 2 + (p & 1)) * s.cap;
  pl.win = s.win + (size_t)q * s.wstride;
  pl.mark = s.mark == nullptr ? nullptr : s.mark + (size_t)q * s.r.Dp;
  if (!pl.take && worked)
    for (int d = threadIdx.x; d < (int)digit_bins(p); d += THREADS)
      s_hist[d] = 0u;
  __syncthreads();
  const float ms = s.r.min_score[q];
  WarpChunk app{0u, 0u, 0u};
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    unsigned long long key[GROUP];
    unsigned d[GROUP], nd[GROUP];
    bool in[GROUP];
    if (!from_buf) prefetch_tile<E>(s, q, t + (int)gridDim.x, ntiles);
    if (FIRST) {
      // pass 1 reads every lane; digits 0 and 1 lie in the key's high word
      InputRaw x;
      load_input<E, VEC>(s.r, q, t * TILE, x);
      unsigned hi[GROUP];
      int unused = 0;
      input_his<E>(s.r, ms, t * TILE, x, hi, in, unused);
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        d[j] = hi[j] >> 21;
        nd[j] = (hi[j] >> 10) & (BINS - 1);
        key[j] = lane_key(hi[j], t * TILE + (int)threadIdx.x * GROUP + j);
      }
    } else {
      if (from_buf) {
#pragma unroll
        for (int j = 0; j < GROUP; ++j) {
          const int c = t * TILE + j * THREADS + (int)threadIdx.x;
          key[j] = c < n ? __ldcg(src + c) : 0ull;
          in[j] = key[j] != 0ull;  // 0: a chunk's unused slot
        }
      } else {
        InputRaw x;
        load_input<E, VEC>(s.r, q, t * TILE, x);
        unsigned hi[GROUP];
        int unused = 0;
        input_his<E>(s.r, ms, t * TILE, x, hi, in, unused);
#pragma unroll
        for (int j = 0; j < GROUP; ++j) {
          key[j] = lane_key(hi[j], t * TILE + (int)threadIdx.x * GROUP + j);
          in[j] = in[j] && (key[j] & hmask) == hpfx;
        }
      }
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        d[j] = digit_of(key[j], p - 1);
        nd[j] = pl.take ? 0u : digit_of(key[j], p);
      }
    }
    pass_tile<E, VEC>(s, st, pl, t * TILE, key, in, d, nd, s_hist, app);
  }
  // the unused tail of the warp's last chunk
  for (unsigned u = app.used + (threadIdx.x & 31); u < app.len; u += 32)
    if (app.base + u < s.cap) pl.dst[app.base + u] = 0ull;
  end_pass<E>(s.hist, s.cap, st, q, p, !pl.take, worked, !from_buf, krem,
              pl.to_buf, s_hist, s_scan, &s_last);
}

// a row's lanes in CTAs of at least 4 tiles, 2,048 / B CTAs a row (8 to
// 1,024), so one row still fills the card
dim3 select_grid(int Dp, int B) {
  const int tiles = (Dp + TILE - 1) / TILE;
  int per_row = (tiles + 3) / 4;
  int cap = 2048 / B;
  if (cap < 8) cap = 8;
  if (cap > 1024) cap = 1024;
  if (per_row > cap) per_row = cap;
  if (per_row < 1) per_row = 1;
  return dim3(per_row, B);
}

unsigned select_cap(int Dp) {
  const int lo = Dp < MIN_CAP ? Dp : MIN_CAP;
  return (unsigned)(Dp / 8 > lo ? Dp / 8 : lo);
}

bool aligned(const void* p, size_t n) {
  return (reinterpret_cast<uintptr_t>(p) % n) == 0;
}

// the select's scratch carved (see the header), zeroed state and
// histograms, then pass 0 and passes 1-6 (none when k == 0)
template <Entry E>
int run_select(Select& s, long long* scratch, int B, cudaStream_t st) {
  const int Dp = s.r.Dp;
  s.cap = select_cap(Dp);
  s.st = reinterpret_cast<RowState*>(scratch);
  s.hist = reinterpret_cast<unsigned*>(scratch + (size_t)B * STATE_SLOTS);
  s.buf = reinterpret_cast<unsigned long long*>(
      scratch + (size_t)B * (STATE_SLOTS + HIST_SLOTS));
  cudaError_t e = cudaMemsetAsync(
      scratch, 0, (size_t)B * (STATE_SLOTS + HIST_SLOTS) * sizeof(long long),
      st);
  if (e != cudaSuccess) return (int)e;
  const bool vec = Dp % 4 == 0 && aligned(s.r.scores, 16) &&
                   aligned(s.r.matches, 4) && aligned(s.r.live, 4) &&
                   aligned(s.r.root, 4) &&
                   (s.r.key == nullptr || aligned(s.r.key, 16)) &&
                   (s.mark == nullptr || aligned(s.mark, 4));
  s.prefetch = Dp % 16 == 0 && aligned(s.r.scores, 16) &&
               aligned(s.r.matches, 16) && aligned(s.r.live, 16) &&
               aligned(s.r.root, 16) &&
               (s.r.key == nullptr || aligned(s.r.key, 16));
  const dim3 grid = select_grid(Dp, B);
  if (vec)
    first_pass_kernel<E, true><<<grid, THREADS, 0, st>>>(s);
  else
    first_pass_kernel<E, false><<<grid, THREADS, 0, st>>>(s);
  if (s.k > 0) {
    if (vec)
      pass_kernel<E, true, true><<<grid, THREADS, 0, st>>>(s, 1);
    else
      pass_kernel<E, false, true><<<grid, THREADS, 0, st>>>(s, 1);
    for (int p = 2; p <= DIGITS; ++p) {
      if (vec)
        pass_kernel<E, true, false><<<grid, THREADS, 0, st>>>(s, p);
      else
        pass_kernel<E, false, false><<<grid, THREADS, 0, st>>>(s, p);
    }
  }
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(SORT_THREADS)
sort_out_kernel(const unsigned long long* __restrict__ cand,
                const RowState* __restrict__ st, int k, int p2,
                float* __restrict__ out) {
  extern __shared__ unsigned long long a[];
  const int q = blockIdx.x;
  for (int i = threadIdx.x; i < p2; i += blockDim.x)
    a[i] = i < k ? cand[(size_t)q * k + i] : 0ull;
  __syncthreads();
  for (int kk = 2; kk <= p2; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p2; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const bool up = ((i & kk) != 0);  // descending overall
          const unsigned long long x = a[i], y = a[ixj];
          if ((x > y) == up) {
            a[i] = y;
            a[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  float* o = out + (size_t)q * (2 * k + 1);
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const unsigned long long key = a[i];
    o[i] = ord_val((unsigned)(key >> 32));
    o[k + i] = __int_as_float(key_index(key));
  }
  if (threadIdx.x == 0) o[2 * k] = __int_as_float(st[q].total);
}

// the keyed entry's rows: [k keys | k scores at the winners | k indices
// as int32 bits | the total as int32 bits]. grid (chunks, B)
__global__ void keyed_out_kernel(const unsigned long long* __restrict__ sorted,
                                 int p2, Rows r,
                                 const RowState* __restrict__ st, int k,
                                 float* __restrict__ out) {
  const int q = blockIdx.y;
  float* o = out + (size_t)q * (3 * (size_t)k + 1);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < k;
       i += gridDim.x * blockDim.x) {
    const unsigned long long key = sorted[(size_t)q * p2 + i];
    const int idx = key_index(key);
    o[i] = ord_val((unsigned)(key >> 32));
    o[k + i] = r.scores[(size_t)q * r.Dp + idx];
    o[2 * k + i] = __int_as_float(idx);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    o[3 * k] = __int_as_float(st[q].total);
}

int pow2_at_least(int k) {
  int p2 = 1;
  while (p2 < k) p2 <<= 1;
  return p2;
}

// int64 slots of the select's per-row scratch (state, histograms, the two
// candidate buffers)
size_t select_slots(int B, int Dp) {
  return (size_t)B * (STATE_SLOTS + HIST_SLOTS + 2 * (size_t)select_cap(Dp));
}

}  // namespace

// scratch: int64 [select_slots + B * k]: the select's, then the winners
extern "C" int masked_topk(const float* scores, const uint8_t* matches,
                           const uint8_t* live, const uint8_t* root,
                           const float* min_score, int B, int Dp,
                           int num_docs, int k, float* out,
                           long long* scratch, void* stream) {
  if (B <= 0) return 0;
  if (k < 0 || k > MAX_K || k > Dp) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* cand =
      reinterpret_cast<unsigned long long*>(scratch + select_slots(B, Dp));
  Select s{};
  s.r = Rows{scores, matches, live, root, min_score, Dp, num_docs, nullptr};
  s.win = cand;
  s.k = k;
  s.wstride = k;
  int code = run_select<TOPK>(s, scratch, B, st);
  if (code != 0) return code;
  const int p2 = pow2_at_least(k);
  const size_t smem = (size_t)p2 * sizeof(unsigned long long);
  // the shared-memory opt-in is per device function: set it once
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        sort_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(MAX_K * sizeof(unsigned long long)));
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  sort_out_kernel<<<B, SORT_THREADS, smem, st>>>(cand, s.st, k, p2, out);
  return (int)cudaGetLastError();
}

// The winners' mark for any 0 <= k <= Dp: mark u8 [B, Dp] is 1 at every
// eligible finite lane among the row's k best keys. scratch: int64
// [select_slots] (no winners: they are marked where found).
extern "C" int masked_topk_threshold(const float* scores,
                                     const uint8_t* matches,
                                     const uint8_t* live,
                                     const uint8_t* root,
                                     const float* min_score, int B, int Dp,
                                     int num_docs, int k, uint8_t* mark,
                                     long long* scratch, void* stream) {
  if (B <= 0 || Dp <= 0) return 0;
  if (k < 0 || k > Dp) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (k == 0)
    return (int)cudaMemsetAsync(mark, 0, (size_t)B * Dp, st);
  Select s{};
  s.r = Rows{scores, matches, live, root, min_score, Dp, num_docs, nullptr};
  s.mark = mark;
  s.k = k;
  return run_select<THRESH>(s, scratch, B, st);
}

// The general path's query phase: out f32 [B, 3k+1] for any 0 <= k <=
// Dp; `key` is the shared [Dp] sort key, or null to select by score.
// scratch: int64 [select_slots + 2 * B * p2], p2 the power of two >= k:
// the select's, then the winners (zero-padded: padding sorts last, every
// lane key is > 0) and the sort's second buffer.
extern "C" int masked_topk_keyed(const float* scores, const uint8_t* matches,
                                 const uint8_t* live, const uint8_t* root,
                                 const float* min_score, const float* key,
                                 int B, int Dp, int num_docs, int k,
                                 float* out, long long* scratch,
                                 void* stream) {
  if (B <= 0) return 0;
  if (k < 0 || k > Dp) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int p2 = pow2_at_least(k);
  unsigned long long* cand =
      reinterpret_cast<unsigned long long*>(scratch + select_slots(B, Dp));
  unsigned long long* tmp = cand + (size_t)B * p2;
  Select s{};
  s.r = Rows{scores, matches, live, root, min_score, Dp, num_docs, key};
  s.win = cand;
  s.k = k;
  s.wstride = p2;
  unsigned long long* sorted = cand;
  if (k > 0) {
    const cudaError_t e = cudaMemsetAsync(
        cand, 0, (size_t)B * p2 * sizeof(unsigned long long), st);
    if (e != cudaSuccess) return (int)e;
  }
  int code = run_select<KEYED>(s, scratch, B, st);
  if (code != 0) return code;
  if (k > 0) {
    code = keysort::sort_rows(cand, tmp, B, p2, &sorted, st);
    if (code != 0) return code;
  }
  int chunks = (k + 255) / 256;
  if (chunks < 1) chunks = 1;
  if (chunks > 256) chunks = 256;
  keyed_out_kernel<<<dim3(chunks, B), 256, 0, st>>>(sorted, p2, s.r, s.st, k,
                                                    out);
  return (int)cudaGetLastError();
}

extern "C" const char* masked_topk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
