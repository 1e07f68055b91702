// K5 binned_popcount: per-bin counts of a query's eligible (doc, value)
// lanes against static per-bin lane bitmasks, for B queries at once:
// out i32 [B, card].
//
// Replaces opensearch_tpu/search/aggs/engine.py:_pack_bits, the fused
// bucket_bits / presence_bits kinds of _eval_agg, and the popcount route
// of _binned_sums (bucket counts, doc counts, cardinality presence).
//
// What bounds it on an H100: bytes. Per query it reads one mask byte (two
// with pmask) per lane; the card bin words of the lanes (4 B a bin per 32
// lanes) are static and shared by the B queries; it writes card ints.
//
// Design. A CTA takes a range of W words (32 W lanes) and a group of G
// queries. It first copies the range's bin words into shared memory (and,
// on a gathered layout, the range's doc ids), so that they are read from
// memory once per range and query group, then walks its queries one after
// the other over the range.
// - The mask read. A warp packs 16 words a step: on the identity layout
//   each thread takes 16 mask bytes as one 16-byte vector (512 B a warp),
//   turns them into 16 bits in registers (a byte compare, __vcmpne4, and
//   a multiply that gathers the four low bits), and two neighbouring
//   threads join their halves into one word with one __shfl_xor_sync: both
//   lanes of a pair then hold word w, bit j of it lane 32w + j, the
//   reference's _pack_bits order. pmask is read the same way and ANDed in.
//   With bins in registers, a thread's 16-byte chunks of the next query
//   stream by cp.async into its own slots of a RING-query ring in shared
//   memory while it counts this one (it reads back only what it copied:
//   no barrier); the per-bin loop loads its steps' vectors directly. A
//   row that is not 16-byte aligned (Dp % 16 != 0, or an offset pointer)
//   takes the byte route inside the same kernel: the same 16 bits from 16
//   byte loads, UNROLL steps' loads issued before the first is used
//   (chosen by shape on the host). On a gathered layout the 16 doc ids of
//   each ballot come from shared memory, the 16 gathers (mask and pmask
//   bytes both) are issued before the first __ballot_sync, and a pair of
//   lanes keeps each of the 16 words, the same pair layout.
// - The bin side, card <= REG_CARD. The two lanes of a pair split the bins
//   by parity, each keeping its bins' counts in registers over all the
//   words it packs for one query (popcount of the word AND the bin word
//   from shared memory; the rows past card up to the instance's 2 NB are
//   zeros, so the loop tests nothing). Then one __reduce_add_sync per
//   (query, pair of bins): the even lanes' counts in the low half of the
//   sum, the odd lanes' in the high half; lanes 0 and 1 add them to the
//   CTA's shared counters, and the CTA makes one global integer atomic
//   per (query, bin).
// - Above REG_CARD bins (and the register and shared-memory cap), the per-
//   bin loop of the first version stays, fed by the new mask read: two
//   steps give each lane its own word of 32; per bin a coalesced read of
//   the bin words from memory, a warp reduction and a shared atomic.
// Integer sums are exact in any order, so the result is deterministic.
//
// The grid: ranges x query groups, the group the fastest index, so the
// CTAs of one range meet in L2. G starts at min(B, 32) and W at 512 words
// (what SMEM_BUDGET allows: three CTAs an SM); both are halved (G first,
// W to 128) until the grid has two CTAs per SM, so B=1 and a few thousand
// lanes still spread over the card.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int STEP = 16;                   // words a warp packs a step
constexpr int UNROLL = 4;                  // steps a batch (identity)
constexpr int REG_CARD = 64;               // bins kept in registers
constexpr int MAX_G = 32;                  // queries a CTA walks
constexpr int MAX_W = 512;                 // words a range
constexpr int RING = 2;                    // queries in the VEC ring
constexpr int SMEM_BUDGET = 96 * 1024;     // shared bytes a CTA, at most
constexpr int PAD = 16;                    // bin row stride W + 16: the two
                                           // lanes of a pair hit two banks
enum Layout { VEC = 0, BYTES = 1, GATHER = 2 };
// a lane's count of one bin for one query fits 16 bits, 16 lanes' too
static_assert(16 * 32 * (MAX_W / (WARPS * STEP)) < (1 << 16),
              "the pair reduction packs two 16-bit sums");
static_assert(MAX_W / (WARPS * STEP) <= UNROLL,
              "a query's steps are one batch of the VEC ring");

// 16-byte slots of the VEC path's ring: [RING][steps][np][THREADS]
__host__ __device__ constexpr int stage_slots(int layout, bool regs,
                                              bool has_pmask, int W) {
  return layout == VEC && regs
             ? RING * (W / (WARPS * STEP)) * (has_pmask ? 2 : 1) * THREADS
             : 0;
}

__device__ __forceinline__ void cp_async16(uint4* dst, const uint8_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four bytes -> four bits (byte k nonzero -> bit k)
__device__ __forceinline__ unsigned nib4(unsigned x) {
  const unsigned f = __vcmpne4(x, 0u) & 0x01010101u;
  return (f * 0x01020408u) >> 24;
}

__device__ __forceinline__ unsigned bits16(uint4 q) {
  return nib4(q.x) | nib4(q.y) << 4 | nib4(q.z) << 8 | nib4(q.w) << 12;
}

__device__ __forceinline__ unsigned bytes16(const uint8_t* p) {
  unsigned h = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) h |= (unsigned)(__ldg(p + i) != 0) << i;
  return h;
}

// the two halves of a pair -> word (lane 2k: bits 0-15, lane 2k+1: 16-31)
__device__ __forceinline__ unsigned join(unsigned h, int half) {
  const unsigned o = __shfl_xor_sync(FULL, h, 1);
  return half ? (o | h << 16) : (h | o << 16);
}

// U steps of the identity layout: step u packs words wb[u] .. wb[u] + 15
// (wb[u] < 0: none); a pair's lanes both get word wb[u] + lane / 2, 0 past
// wend
template <int L, int U>
__device__ __forceinline__ void pack_identity(const uint8_t* mrow,
                                              const uint8_t* prow,
                                              const int (&wb)[U], int wend,
                                              unsigned (&words)[U]) {
  const int lane = threadIdx.x & 31;
  const int k = lane >> 1, half = lane & 1;
  unsigned h[U];
  if (L == VEC) {
    uint4 m[U], p[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = wb[u] + k;
      const bool ok = wb[u] >= 0 && w < wend;
      const size_t off = (size_t)w * 32 + half * 16;
      m[u] = ok ? __ldg(reinterpret_cast<const uint4*>(mrow + off))
                : make_uint4(0u, 0u, 0u, 0u);
      if (prow != nullptr)
        p[u] = ok ? __ldg(reinterpret_cast<const uint4*>(prow + off))
                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h[u] = bits16(m[u]);
      if (prow != nullptr) h[u] &= bits16(p[u]);
    }
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = wb[u] + k;
      h[u] = 0;
      if (wb[u] >= 0 && w < wend) {
        const size_t off = (size_t)w * 32 + half * 16;
        h[u] = bytes16(mrow + off);
        if (prow != nullptr) h[u] &= bytes16(prow + off);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) words[u] = join(h[u], half);
}

// one step of the gathered layout: 16 ballots, the 16 gathers issued
// first; s_doc holds the range's doc ids (-1 past wend)
__device__ __forceinline__ unsigned pack_gather(const uint8_t* mrow,
                                                const uint8_t* prow, int Dp,
                                                const int* s_doc, int wl) {
  const int lane = threadIdx.x & 31;
  bool ok[STEP];
#pragma unroll
  for (int i = 0; i < STEP; ++i) {
    const int doc = wl >= 0 ? s_doc[(wl + i) * 32 + lane] : -1;
    ok[i] = false;
    if (doc >= 0 && doc < Dp) {     // both bytes loaded before the test
      const bool m = __ldg(mrow + doc) != 0;
      const bool p = prow == nullptr || __ldg(prow + doc) != 0;
      ok[i] = m && p;
    }
  }
  unsigned mine = 0;
#pragma unroll
  for (int i = 0; i < STEP; ++i) {
    const unsigned word = __ballot_sync(FULL, ok[i]);
    if ((lane >> 1) == i) mine = word;
  }
  return mine;
}

// NB > 0: card <= 2 NB, each lane of a pair counts NB bins in registers;
// NB == 0: the per-bin loop. Block (range, group), group fastest.
template <int L, int NB>
__global__ void __launch_bounds__(THREADS, 3)
binned_popcount_kernel(const uint8_t* __restrict__ mask,
                       const uint8_t* __restrict__ pmask, int Dp,
                       const int* __restrict__ doc_ids, int nw,
                       const unsigned* __restrict__ binbits, int card, int B,
                       int W, int G, int groups, int* __restrict__ out) {
  extern __shared__ uint4 smem[];
  // [RING][steps][1 or 2][THREADS] 16-byte slots (VEC, bins in registers)
  uint4* s_stage = smem;
  const int n_stage = stage_slots(L, NB > 0, pmask != nullptr, W);
  const int stride = W + PAD;
  int* s_cnt = reinterpret_cast<int*>(smem + n_stage);  // [G][card] / [card]
  const int n_cnt = NB > 0 ? G * card : card;
  unsigned* s_bin = reinterpret_cast<unsigned*>(s_cnt + n_cnt);  // [2 NB][stride]
  int* s_doc = reinterpret_cast<int*>(s_bin + 2 * NB * stride);
  const int group = blockIdx.x % groups;
  const int range = blockIdx.x / groups;
  const int q0 = group * G;
  const int gn = min(G, B - q0);
  const int r0 = range * W;
  const int wend = min(nw, r0 + W);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int k = lane >> 1, par = lane & 1;

  for (int i = tid; i < n_cnt; i += THREADS) s_cnt[i] = 0;
  if (NB > 0) {
    // rows card .. 2 NB - 1 are zeros: the count loop needs no test
    const int wshift = __ffs(W) - 1;   // W is a power of two
#pragma unroll 8
    for (int i = tid; i < 2 * NB * W; i += THREADS) {
      const int bin = i >> wshift, wl = i & (W - 1);
      s_bin[bin * stride + wl] =
          bin < card && r0 + wl < wend
              ? __ldg(binbits + (size_t)bin * nw + r0 + wl)
              : 0u;
    }
  }
  if (L == GATHER) {
    const int lanes = (wend - r0) * 32;
    const int* src = doc_ids + (size_t)r0 * 32;
#pragma unroll 4
    for (int i = tid; i < W * 32; i += THREADS)
      s_doc[i] = i < lanes ? __ldg(src + i) : -1;
  }
  __syncthreads();

  if (NB > 0) {
    const int steps = W / (WARPS * STEP);
    constexpr int U = L == GATHER ? 1 : UNROLL;   // 16 gathers in flight
    // VEC: each thread's 16-byte chunks of the next RING - 1 queries
    // stream into its own slots of a ring by cp.async while it counts
    // this one (a thread reads back only what it copied: no barrier)
    const int np = pmask != nullptr ? 2 : 1;
    auto slot = [&](int buf, int u, int j) {
      return s_stage + ((buf * steps + u) * np + j) * THREADS + tid;
    };
    auto stage = [&](int g) {
      const size_t row = (size_t)(q0 + g) * Dp;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int w = r0 + (u * WARPS + warp) * STEP + k;
        if (u < steps && w < wend) {
          const size_t off = row + (size_t)w * 32 + par * 16;
          cp_async16(slot(g % RING, u, 0), mask + off);
          if (pmask != nullptr)
            cp_async16(slot(g % RING, u, 1), pmask + off);
        }
      }
      cp_async_commit();
    };
    if (L == VEC) {
      for (int g = 0; g < RING - 1; ++g) {
        if (g < gn) stage(g);
        else cp_async_commit();
      }
    }
    for (int g = 0; g < gn; ++g) {
      const size_t row = (size_t)(q0 + g) * Dp;
      const uint8_t* mrow = mask + row;
      const uint8_t* prow = pmask != nullptr ? pmask + row : nullptr;
      unsigned cnt[NB > 0 ? NB : 1];
#pragma unroll
      for (int j = 0; j < NB; ++j) cnt[j] = 0;
      auto count = [&](const int (&wb)[U], const unsigned (&words)[U]) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (words[u] == 0u) continue;   // 0 past wend: no bin read
          const unsigned* sb = s_bin + par * stride + (wb[u] - r0) + k;
#pragma unroll
          for (int j = 0; j < NB; ++j)
            cnt[j] += __popc(words[u] & sb[2 * j * stride]);
        }
      };
      if (L == VEC) {   // steps <= U: the query is one batch
        if (g + RING - 1 < gn) stage(g + RING - 1);
        else cp_async_commit();
        cp_async_wait<RING - 1>();
        int wb[U];
        unsigned words[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          wb[u] = u < steps ? r0 + (u * WARPS + warp) * STEP : -1;
          unsigned h = 0u;
          if (u < steps && wb[u] + k < wend) {
            h = bits16(*slot(g % RING, u, 0));
            if (pmask != nullptr) h &= bits16(*slot(g % RING, u, 1));
          }
          words[u] = join(h, par);
        }
        count(wb, words);
      } else {
        for (int s0 = 0; s0 < steps; s0 += U) {
          int wb[U];
          unsigned words[U];
#pragma unroll
          for (int u = 0; u < U; ++u)
            wb[u] = s0 + u < steps ? r0 + ((s0 + u) * WARPS + warp) * STEP
                                   : -1;
          if (L == GATHER) {
#pragma unroll
            for (int u = 0; u < U; ++u)
              words[u] = pack_gather(mrow, prow, Dp, s_doc,
                                     wb[u] >= 0 ? wb[u] - r0 : -1);
          } else {
            pack_identity<L, U>(mrow, prow, wb, wend, words);
          }
          count(wb, words);
        }
      }
      // one reduction per bin pair: a lane counts at most 32 x steps <=
      // 128 bits of a bin, so the 16 even lanes' sum fits the low half
      // and the odd lanes' (shifted) the high half
      int* sc = s_cnt + g * card;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (2 * j >= card) break;         // warp-uniform
        const unsigned v = __reduce_add_sync(FULL, cnt[j] << (16 * par));
        const unsigned mine = lane == 0 ? v & 0xffffu : v >> 16;
        if (lane < 2 && 2 * j + lane < card && mine != 0u)
          atomicAdd(&sc[2 * j + lane], (int)mine);
      }
    }
    __syncthreads();
    for (int i = tid; i < gn * card; i += THREADS) {
      if (s_cnt[i] != 0) atomicAdd(&out[(size_t)q0 * card + i], s_cnt[i]);
    }
    return;
  }

  // the per-bin loop: each warp tile of 32 words gives lane L its word
  // t0 + L / 2 + (L & 1) * 16 from two steps
  const int tiles = W / (WARPS * 2 * STEP);
  for (int g = 0; g < gn; ++g) {
    const size_t row = (size_t)(q0 + g) * Dp;
    const uint8_t* mrow = mask + row;
    const uint8_t* prow = pmask != nullptr ? pmask + row : nullptr;
    for (int t = 0; t < tiles; ++t) {
      const int t0 = r0 + (t * WARPS + warp) * 2 * STEP;
      int wb[2] = {t0, t0 + STEP};
      unsigned words[2];
      if (L == GATHER) {
        words[0] = pack_gather(mrow, prow, Dp, s_doc, t0 - r0);
        words[1] = pack_gather(mrow, prow, Dp, s_doc, t0 + STEP - r0);
      } else {
        pack_identity<L, 2>(mrow, prow, wb, wend, words);
      }
      const unsigned mine = par ? words[1] : words[0];
      if (!__any_sync(FULL, mine != 0u)) continue;
      // mine != 0 only on words below wend, so the read stays in the row
      const unsigned* col = binbits + t0 + k + par * STEP;
      for (int bin = 0; bin < card; ++bin) {
        const unsigned bits =
            mine != 0u ? (__ldg(col + (size_t)bin * nw) & mine) : 0u;
        const unsigned c = __reduce_add_sync(FULL, (unsigned)__popc(bits));
        if (lane == 0 && c != 0u) atomicAdd(&s_cnt[bin], (int)c);
      }
    }
    __syncthreads();
    for (int i = tid; i < card; i += THREADS) {
      if (s_cnt[i] != 0) {
        atomicAdd(&out[(size_t)(q0 + g) * card + i], s_cnt[i]);
        s_cnt[i] = 0;
      }
    }
    __syncthreads();
  }
}

// the bin rows a CTA keeps in shared memory: 2 NB of the instance, NB of
// dispatch's choice (0: the per-bin loop keeps none)
int bin_rows(int card) {
  return card <= 2 ? 2 : card <= 8 ? 8 : card <= 16 ? 16
         : card <= REG_CARD ? 2 * 32 : 0;
}

size_t smem_bytes(int layout, bool regs, bool has_pmask, int card, int W,
                  int G) {
  size_t words = regs ? (size_t)G * card + (size_t)bin_rows(card) * (W + PAD)
                      : (size_t)card;
  if (layout == GATHER) words += (size_t)W * 32;
  return (size_t)stage_slots(layout, regs, has_pmask, W) * 16 + words * 4;
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

template <int L, int NB>
int launch(const uint8_t* mask, const uint8_t* pmask, int Dp,
           const int* doc_ids, int nw, const unsigned* binbits, int card,
           int B, int W, int G, int groups, unsigned grid, size_t smem,
           int* out, cudaStream_t s) {
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        binned_popcount_kernel<L, NB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BUDGET);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  binned_popcount_kernel<L, NB><<<grid, THREADS, smem, s>>>(
      mask, pmask, Dp, doc_ids, nw, binbits, card, B, W, G, groups, out);
  return (int)cudaGetLastError();
}

template <int L>
int dispatch(const uint8_t* mask, const uint8_t* pmask, int Dp,
             const int* doc_ids, int nw, const unsigned* binbits, int card,
             int B, int W, int G, int groups, unsigned grid, size_t smem,
             int* out, cudaStream_t s) {
#define K5_LAUNCH(NB)                                                       \
  return launch<L, NB>(mask, pmask, Dp, doc_ids, nw, binbits, card, B, W, \
                       G, groups, grid, smem, out, s)
  if (card <= 2) K5_LAUNCH(1);
  if (card <= 8) K5_LAUNCH(4);
  if (card <= 16) K5_LAUNCH(8);
  if (card <= REG_CARD) K5_LAUNCH(32);
  K5_LAUNCH(0);
#undef K5_LAUNCH
}

}  // namespace

// mask / pmask: u8 [B, Dp] (pmask may be null); doc_ids: int32 [n] or null
// (lane k is doc k, n <= Dp); n % 32 == 0; binbits: u32 [card, n / 32].
// out: i32 [B, card], zeroed here first.
extern "C" int binned_popcount(const uint8_t* mask, const uint8_t* pmask,
                               int Dp, const int* doc_ids, int n,
                               const unsigned* binbits, int card, int B,
                               int* out, void* stream) {
  if (B <= 0 || card <= 0) return 0;
  if (n % 32 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)B * card * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  const int nw = n / 32;
  if (nw == 0) return 0;
  const bool regs = card <= REG_CARD;
  const bool has_p = pmask != nullptr;
  const bool aligned = (reinterpret_cast<uintptr_t>(mask) & 15) == 0 &&
                       (pmask == nullptr ||
                        (reinterpret_cast<uintptr_t>(pmask) & 15) == 0) &&
                       Dp % 16 == 0;
  const int layout = doc_ids != nullptr ? GATHER : aligned ? VEC : BYTES;
  const int w_min = regs ? WARPS * STEP : WARPS * 2 * STEP;
  int G = B < MAX_G ? B : MAX_G;
  int W = MAX_W;
  auto smem_of = [&](int w, int g) {
    return smem_bytes(layout, regs, has_p, card, w, g);
  };
  while (W > w_min && smem_of(W, G) > SMEM_BUDGET) W /= 2;
  if (smem_of(W, G) > SMEM_BUDGET) return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  const long long target = 2LL * sms;
  auto ctas = [&](int w, int g) {
    return (long long)((nw + w - 1) / w) * ((B + g - 1) / g);
  };
  while (ctas(W, G) < target && (G > 1 || W > w_min)) {
    if (G > 1) G = (G + 1) / 2;
    else W /= 2;
  }
  const int groups = (B + G - 1) / G;
  const long long grid = ctas(W, G);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = smem_of(W, G);
  if (layout == GATHER)
    return dispatch<GATHER>(mask, pmask, Dp, doc_ids, nw, binbits, card, B,
                            W, G, groups, (unsigned)grid, smem, out, s);
  if (layout == VEC)
    return dispatch<VEC>(mask, pmask, Dp, doc_ids, nw, binbits, card, B, W,
                         G, groups, (unsigned)grid, smem, out, s);
  return dispatch<BYTES>(mask, pmask, Dp, doc_ids, nw, binbits, card, B, W,
                         G, groups, (unsigned)grid, smem, out, s);
}

extern "C" const char* binned_popcount_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
