// K10 maxsim_exact: exact late-interaction (ColBERT) MaxSim. Per doc d of a
// padded f32 [Dp, T, dims] token block with token_count[d] real tokens,
// and per query b of an f32 [B, Tq, dims] batch with its qmask [B, Tq]:
//   dot(t, s) = sum_j q[b, t, j] * tok[d, s, j]        (dim order)
//   best_t    = max over s < token_count[d] of dot(t, s)  (-inf if none)
//   best_t    = 0 where best_t is not finite
//   out[b, d] = sum_t best_t * qmask[b, t]              (t order)
// Every multiply and add rounds once (__fmul_rn / __fadd_rn), so the
// kernel equals its plain PyTorch version
// (ops/maxsim.py:exact_maxsim_scores_plain) bit for bit.
//
// Replaces opensearch_tpu/ops/maxsim.py:exact_maxsim_scores and
// _tiled_token_dots (the exact branch of the `maxsim` plan in
// opensearch_tpu/search/plan_eval.py).
//
// What bounds it on an H100: operations. The bit-equality contract rounds
// each multiply and each add on its own (no FMA): 2 B Tq dims FP32
// instructions a real doc token, 65.5 G at B = 1, Tq = 32, 128 dims and
// 8,000,680 real tokens (1.96 ms at 132 SMs x 128 lanes and 1,980 MHz),
// above the real tokens' 4.1 GB (1.22 ms); padding lanes cost nothing.
//
// Design.
// - Real tokens only. The docs are cut into windows of DW = 32
//   consecutive docs. A CTA opening a window scans its token counts
//   (clamped to [0, T], each rounded up to RS = 4) into slot offsets:
//   the window's real tokens laid end to end, each doc starting on a
//   multiple of RS, cut into subtiles of ROWS = 256 slots. A doc may run
//   on from one subtile into the next. Docs with no tokens take no slot
//   and get 0; a window with no tokens costs its CTA one scan. The table
//   is built on the card, in the call, from token_count alone. Two tables
//   alternate (a window's last subtile is finished while the next one
//   loads); a barrier before each scan keeps a table from being rewritten
//   while any warp still finishes the window that held it.
// - Persistent CTAs (two an SM) take windows in turn and walk items
//   (subtile, query tile, dims chunk) through a 2-stage cp.async ring:
//   each stage holds the subtile's DC = 32 dims of its 256 slots (16-byte
//   copies where dims % 4 == 0 and the block is 16-byte aligned, 4-byte
//   copies otherwise; a slot's 16-byte column XOR-swizzled by its row so
//   that a quarter warp's reads meet no bank conflict) and the query
//   tile's chunk, the next item's copies in flight while this one
//   computes. A real token's bytes leave device memory once a call; at
//   B > 1 the subtile is read again from L2 for each query tile.
// - Queries: a staging launch lays the batch out as query tiles of NQ =
//   32 tokens, [B * ceil(Tq / 32)][dims4][32] (zero past Tq and dims), so
//   one 16-byte broadcast read feeds four query tokens, and each staged
//   query chunk serves the subtile's 256 slots (every doc in it).
// - Register tile: a thread holds RS = 4 consecutive slots (one doc's)
//   x RT = 8 query tokens; 64 row threads x 4 query groups, a warp's
//   lanes 8 row threads x the 4 groups, so that one 16-byte read of the
//   tokens (8 rows) and one of the queries (4 groups) each take one
//   shared-memory wavefront. (On the H100 this and the fully unrolled
//   32-dim chunk took B=1 from 3.98 to 3.92 ms and B=32 from 125.2 to
//   123.1.)
// - Reduction: at a subtile's end a thread takes the max over its real
//   slots in registers and stores it (no barrier). After the next item's
//   barrier, one warp per doc, lane q for query token q, takes the max
//   over the doc's row threads (and the doc's running max from the
//   subtile before, kept per query tile in `scratch`); non-finite maxima
//   become 0, and the warp adds best_t * qmask in t order through
//   shuffles, across query tiles of one query, then stores the score.
//   (A thread per (doc, token) and one thread summing a doc's tokens,
//   behind three barriers, took B=1 to 3.92 ms and B=32 to 123.1.)
// - The max is fmaxf, as before: a max over any order gives the same
//   value, and the sign of a zero maximum never reaches a score (the sum
//   starts at +0).

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "cp_async.cuh"

namespace {

constexpr int NT = 256;          // threads a CTA
constexpr int ROWS = 256;        // token slots a subtile
constexpr int RS = 4;            // slots a thread; docs start on multiples
constexpr int RT = 8;            // query tokens a thread
constexpr int NQ = 32;           // query tokens a tile
constexpr int RTH = ROWS / RS;   // row threads
constexpr int DW = 32;           // docs a window
constexpr int DC = 32;           // dims a chunk
constexpr int STAGES = 2;
constexpr int STAGE = ROWS * DC + DC * NQ;  // floats a stage
constexpr int SMEM = STAGES * STAGE * (int)sizeof(float);
constexpr int MAX_T = 1024;
static_assert((NQ / RT) * RTH == NT && ROWS == NT, "one slot a thread");
static_assert(DW == 32 && DC == 32, "a warp scans a window; 8 quads a row");

// the window's doc holding slot `slot`: the last d with off[d] <= slot
__device__ __forceinline__ int doc_of(const int* off, int slot) {
  int lo = 0, hi = DW - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= slot) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// the staged float of slot row r, dim c of the chunk: 16-byte columns
// XOR-swizzled by the row's thread
__device__ __forceinline__ int swz(int r, int c) {
  return r * DC + ((((c >> 2) ^ (r >> 2)) & 7) << 2) + (c & 3);
}

// query [B, Tq, dims] -> qt [B * ntt][dims4][NQ], zero past Tq and dims
__global__ void stage_queries(const float* __restrict__ query, int B, int Tq,
                              int ntt, int dims, int dims4,
                              float* __restrict__ qt) {
  const size_t n = (size_t)B * ntt * dims4 * NQ;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int q = (int)(i % NQ);
    const size_t rest = i / NQ;
    const int j = (int)(rest % dims4);
    const int qi = (int)(rest / dims4);
    const int b = qi / ntt, tok = (qi % ntt) * NQ + q;
    qt[i] = (tok < Tq && j < dims)
                ? query[((size_t)b * Tq + tok) * dims + j]
                : 0.0f;
  }
}

// one dim of the thread's slots (v) against its query tokens (qv)
__device__ __forceinline__ void dim_step(const float (&v)[RS],
                                         const float (&qv)[RT],
                                         float (&acc)[RS][RT]) {
#pragma unroll
  for (int i = 0; i < RS; ++i) {
#pragma unroll
    for (int q = 0; q < RT; ++q)
      acc[i][q] = __fadd_rn(acc[i][q], __fmul_rn(v[i], qv[q]));
  }
}

__device__ __forceinline__ void load_queries(const float* qs, int c,
                                             float (&qv)[RT]) {
#pragma unroll
  for (int h = 0; h < RT / 4; ++h) {
    const float4 x = *reinterpret_cast<const float4*>(qs + c * NQ + 4 * h);
    qv[4 * h] = x.x;
    qv[4 * h + 1] = x.y;
    qv[4 * h + 2] = x.z;
    qv[4 * h + 3] = x.w;
  }
}

// grid: persistent CTAs over the windows. qt: stage_queries' layout;
// carry: f32 [gridDim.x][2][B * ntt][NQ], each CTA's running maxima of a
// doc that runs on into the next subtile (by subtile parity, query tile)
__global__ void __launch_bounds__(NT, 2)
maxsim_exact_kernel(const float* __restrict__ tokens,
                    const int* __restrict__ token_count,
                    const float* __restrict__ qt,
                    const float* __restrict__ qmask,
                    float* __restrict__ carry_all, int B, int Dp, int T,
                    int Tq, int ntt, int dims, int dims4, int vec16,
                    float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  // [2][row thread][query token]: a subtile's maxima, by epilogue parity
  __shared__ __align__(16) float part[2][RTH * NQ];
  __shared__ float tot_s[DW];        // running t-order sums
  __shared__ int off_s[2][DW + 1];   // windows' slot offsets, by table
  __shared__ int cnt_s[2][DW];       // windows' clamped token counts
  __shared__ int d0_s[2];            // windows' first docs
  __shared__ int slot_src[ROWS];     // the load's subtile: doc * T + token
  __shared__ int desc[STAGES][8];    // each stage's item
  const int t = threadIdx.x, lane = t & 31;
  const int g = lane & 3, rt = (t >> 5) * 8 + (lane >> 2);
  const int n_windows = (Dp + DW - 1) / DW;
  const int nqt = B * ntt;
  const int nc = (dims + DC - 1) / DC;
  float* carry = carry_all + (size_t)blockIdx.x * 2 * nqt * NQ;

  // the load cursor, the same in every thread: windows opened, non-empty
  // ones (their table alternates), and the next item
  int lk = 0, ne = 0, ls = 0, lq = 0, lc = 0, lnsub = 0, lslot = 0;
  bool open = true, ldone = false;

  auto load = [&](int m) {
    int* dsc = desc[m % STAGES];
    while (open && !ldone) {
      const int w = blockIdx.x + lk * gridDim.x;
      if (w >= n_windows) {
        ldone = true;
        break;
      }
      ++lk;
      const int slot = ne & 1;
      int* off = off_s[slot];
      int* cnt = cnt_s[slot];
      const int d0 = w * DW;
      // every warp is done with this table: finish() of the window two
      // back (when the one between took a single item), or an empty
      // window's reads
      __syncthreads();
      if (t < 32) {
        const int d = d0 + t;
        int c = d < Dp ? token_count[d] : 0;
        c = c < 0 ? 0 : (c > T ? T : c);
        int incl = (c + RS - 1) / RS * RS;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += y;
        }
        off[t + 1] = incl;
        cnt[t] = c;
        if (t == 0) {
          off[0] = 0;
          d0_s[slot] = d0;
        }
      }
      __syncthreads();
      // docs with no tokens score 0 for every query
      for (int i = t; i < DW * B; i += NT) {
        const int j = i % DW, b = i / DW;
        if (d0 + j < Dp && cnt[j] == 0) out[(size_t)b * Dp + d0 + j] = 0.0f;
      }
      const int n_slots = off[DW];
      if (n_slots == 0) continue;  // the next window rebuilds this table
      lslot = slot;
      ++ne;
      lnsub = (n_slots + ROWS - 1) / ROWS;
      ls = lq = lc = 0;
      open = false;
    }
    if (ldone) {
      if (t == 0) dsc[0] = 0;
      cp_async_commit();
      return;
    }
    const int* off = off_s[lslot];
    const int* cnt = cnt_s[lslot];
    if (lq == 0 && lc == 0) {  // a new subtile: each slot's token row
      const int slot = ls * ROWS + t;
      int src = -1;
      if (slot < off[DW]) {
        const int d = doc_of(off, slot), tok = slot - off[d];
        if (tok < cnt[d]) src = d * T + tok;
      }
      slot_src[t] = src;
      __syncthreads();
    }
    float* st = smem + (m % STAGES) * STAGE;
    const int j0 = lc * DC, dc = min(DC, dims - j0);
    const float* base = tokens + (size_t)d0_s[lslot] * T * dims + j0;
    if (vec16) {
      for (int p = t; p < ROWS * (DC / 4); p += NT) {
        const int r = p >> 3, c = (p & 7) * 4;
        const int src = slot_src[r];
        if (src >= 0 && c < dc)
          cp_async16(st + swz(r, c), base + (size_t)src * dims + c);
      }
    } else {
      for (int p = t; p < ROWS * DC; p += NT) {
        const int r = p / DC, c = p % DC;
        const int src = slot_src[r];
        if (src >= 0 && c < dc)
          cp_async4(st + swz(r, c), base + (size_t)src * dims + c);
      }
    }
    const int dq = min(DC, dims4 - j0);  // a multiple of 4
    const float* qsrc = qt + ((size_t)lq * dims4 + j0) * NQ;
    float* qs = st + ROWS * DC;
    for (int p = t; p < dq * NQ / 4; p += NT)
      cp_async16(qs + 4 * p, qsrc + 4 * p);
    if (t == 0) {
      dsc[0] = 1;
      dsc[1] = lslot;
      dsc[2] = ls;
      dsc[3] = lq;
      dsc[4] = lc;
    }
    cp_async_commit();
    if (++lc == nc) {
      lc = 0;
      if (++lq == nqt) {
        lq = 0;
        if (++ls == lnsub) open = true;
      }
    }
  };

  int rows[RS];  // the thread's slot rows of a stage
#pragma unroll
  for (int i = 0; i < RS; ++i) rows[i] = rt * RS + i;
  float acc[RS][RT];
  // a subtile's end waits for the next item's barrier (pend): then one
  // warp per doc that has slots in it takes, lane q for query token q, the
  // max over the doc's row threads (and the running max carried from the
  // subtile before); a doc that runs on carries it into the next
  // subtile, any other adds best_t * qmask in t order through shuffles
  // and stores its score when the query's last tile is done
  int pend = 0, pend_slot = 0, pend_sub = 0, pend_qtile = 0, pend_buf = 0;
  int ebuf = 0;
  auto finish = [&]() {
    const int* off = off_s[pend_slot];
    const int* cnt = cnt_s[pend_slot];
    const int s0 = pend_sub * ROWS, s1 = min(off[DW], s0 + ROWS);
    const int b = pend_qtile / ntt, tt = pend_qtile % ntt;
    const int da = doc_of(off, s0), nd = doc_of(off, s1 - 1) - da + 1;
    const int nv = min(NQ, Tq - tt * NQ);
    const float qm =
        lane < nv ? qmask[(size_t)b * Tq + tt * NQ + lane] : 0.0f;
    const float* pt = part[pend_buf];
    const float* cprev =
        carry + ((size_t)((pend_sub + 1) & 1) * nqt + pend_qtile) * NQ;
    float* ccur = carry + ((size_t)(pend_sub & 1) * nqt + pend_qtile) * NQ;
    for (int k = t >> 5; k < nd; k += NT / 32) {
      const int d = da + k;
      if (cnt[d] == 0) continue;  // no slots; scored 0 at the window's open
      const int lo = max(off[d], s0), hi = min(off[d + 1], s1);
      float m2 = off[d] < s0 ? cprev[lane] : -INFINITY;
      for (int r = (lo - s0) / RS; r < (hi - s0) / RS; ++r)
        m2 = fmaxf(m2, pt[r * NQ + lane]);
      if (off[d + 1] > s1) {  // the doc runs on into the next subtile
        ccur[lane] = m2;
        continue;
      }
      const float prod = __fmul_rn(isfinite(m2) ? m2 : 0.0f, qm);
      float tot = tt == 0 ? 0.0f : tot_s[d];
      for (int q = 0; q < nv; ++q)
        tot = __fadd_rn(tot, __shfl_sync(0xffffffffu, prod, q));
      if (lane == 0) {
        if (tt == ntt - 1)
          out[(size_t)b * Dp + d0_s[pend_slot] + d] = tot;
        else
          tot_s[d] = tot;
      }
    }
  };

  load(0);
  for (int m = 0;; ++m) {
    // item m has landed and every thread is done with item m - 1, whose
    // stage the next copy overwrites
    cp_async_wait<0>();
    __syncthreads();
    if (pend) {  // before load: a window it opens may take this table
      finish();
      pend = 0;
    }
    load(m + 1);
    const int* dsc = desc[m % STAGES];
    if (!dsc[0]) break;
    const int tslot = dsc[1], sub = dsc[2], qtile = dsc[3], chunk = dsc[4];
    const float* st = smem + (m % STAGES) * STAGE;
    const float* qs = st + ROWS * DC + g * RT;
    if (chunk == 0) {
#pragma unroll
      for (int i = 0; i < RS; ++i) {
#pragma unroll
        for (int q = 0; q < RT; ++q) acc[i][q] = 0.0f;
      }
    }
    const int dc = min(DC, dims - chunk * DC);
    const int full = dc == DC ? DC : dc & ~3;
#pragma unroll
    for (int c = 0; c < full; c += 4) {
      float4 v4[RS];
#pragma unroll
      for (int i = 0; i < RS; ++i)
        v4[i] = *reinterpret_cast<const float4*>(st + swz(rows[i], c));
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        float v[RS], qv[RT];
#pragma unroll
        for (int i = 0; i < RS; ++i) v[i] = lane4(v4[i], d);
        load_queries(qs, c + d, qv);
        dim_step(v, qv, acc);
      }
    }
    for (int c = full; c < dc; ++c) {
      float v[RS], qv[RT];
#pragma unroll
      for (int i = 0; i < RS; ++i) v[i] = st[swz(rows[i], c)];
      load_queries(qs, c, qv);
      dim_step(v, qv, acc);
    }
    if (chunk != nc - 1) continue;

    // the subtile's end for this query tile: the maxima over each
    // thread's real slots (one doc's) into part; the next item finishes
    const int* off = off_s[tslot];
    const int* cnt = cnt_s[tslot];
    float mx[RT];
#pragma unroll
    for (int q = 0; q < RT; ++q) mx[q] = -INFINITY;
    const int slot = sub * ROWS + rt * RS;
    if (slot < off[DW]) {
      const int d = doc_of(off, slot);
      const int nreal = cnt[d] - (slot - off[d]);
#pragma unroll
      for (int i = 0; i < RS; ++i) {
        if (i < nreal) {
#pragma unroll
          for (int q = 0; q < RT; ++q) mx[q] = fmaxf(mx[q], acc[i][q]);
        }
      }
    }
    float4* pt = reinterpret_cast<float4*>(part[ebuf] + rt * NQ + g * RT);
#pragma unroll
    for (int h = 0; h < RT / 4; ++h)
      pt[h] = make_float4(mx[4 * h], mx[4 * h + 1], mx[4 * h + 2],
                          mx[4 * h + 3]);
    pend = 1;
    pend_slot = tslot;
    pend_sub = sub;
    pend_qtile = qtile;
    pend_buf = ebuf;
    ebuf ^= 1;
  }
}

// the card's resident CTAs of the kernel (found once, at the first call)
cudaError_t resident_ctas(int* ctas) {
  static int resident = 0;
  if (resident == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        maxsim_exact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    int per_sm = 0, dev = 0, sms = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, maxsim_exact_kernel, NT, SMEM);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    resident = (per_sm > 0 ? per_sm : 1) * sms;
  }
  *ctas = resident;
  return cudaSuccess;
}

}  // namespace

// *ctas = the CTAs that maxsim_exact runs at most: the carry scratch holds
// that many CTAs' maxima
extern "C" int maxsim_exact_ctas(int* ctas) {
  return (int)resident_ctas(ctas);
}

// tokens: f32 [Dp, T, dims]; token_count: i32 [Dp]; query: f32
// [B, Tq, dims] (any alignment); qmask: f32 [B, Tq]; scratch: f32
// [B * ntt * dims4 * 32 + ctas * 2 * B * ntt * 32] (ntt = ceil(Tq / 32),
// dims4 = dims rounded up to 4: the staged queries, then the CTAs'
// carried maxima), where ctas must be maxsim_exact_ctas'; out: f32 [B, Dp].
extern "C" int maxsim_exact(const float* tokens, const int* token_count,
                            const float* query, const float* qmask, int B,
                            int Dp, int T, int Tq, int dims, float* scratch,
                            int ctas, float* out, void* stream) {
  if (B <= 0 || Dp <= 0) return 0;
  if (T <= 0 || T > MAX_T || Tq <= 0 || dims <= 0)
    return (int)cudaErrorInvalidValue;
  int resident = 0;
  cudaError_t e = resident_ctas(&resident);
  if (e != cudaSuccess) return (int)e;
  if (ctas != resident) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int ntt = (Tq + NQ - 1) / NQ;
  const int dims4 = (dims + 3) & ~3;
  const int n_windows = (Dp + DW - 1) / DW;
  const int grid = resident < n_windows ? resident : n_windows;
  float* qt = scratch;
  float* carry = scratch + (size_t)B * ntt * dims4 * NQ;
  const size_t staged = (size_t)B * ntt * dims4 * NQ;
  size_t sg = (staged + 255) / 256;
  sg = sg > 1024 ? 1024 : sg;
  stage_queries<<<(int)sg, 256, 0, st>>>(query, B, Tq, ntt, dims, dims4, qt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int vec16 =
      dims % 4 == 0 && (reinterpret_cast<uintptr_t>(tokens) & 15) == 0;
  maxsim_exact_kernel<<<grid, NT, SMEM, st>>>(tokens, token_count, qt, qmask,
                                              carry, B, Dp, T, Tq, ntt, dims,
                                              dims4, vec16, out);
  return (int)cudaGetLastError();
}

extern "C" const char* maxsim_exact_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
