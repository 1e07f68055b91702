// Row 16 expand_pad: fill-pad a compact prefix out to its padded shape,
// out = full(f0 x f1 x f2, fill); out[:c0, :c1, :c2] = x.
//
// Replaces opensearch_tpu/ops/device_segment.py:_expand_fn, the on-device
// half of the delta segment publish: a refresh or a merge sends only the
// populated prefix of every padded leaf of a segment's image, and this
// kernel rebuilds the padded leaf on the card. Leaves of 1-3 dims come in
// as 3 (leading extents 1), after the wrapper has folded every inner axis
// whose compact extent equals its padded one into the axis outside it
// (ops/device_segment.py: fold_axes), so a leaf whose rows are whole
// arrives as one axis. The leaves are int32, float32, bool and uint8 (PQ
// codes), so the kernel moves elements of 4 or 1 bytes as raw bits and
// takes the fill as bits of that width.
//
// What bounds it on an H100: bytes. It reads the compact prefix once and
// writes the padded leaf once, (c0 c1 c2 + f0 f1 f2) x width bytes over
// 3.35 TB/s, and does no arithmetic beyond its index math.
//
// Design.
// - Vector path: where the leaf has at most two axes after the fold
//   (c0 = f0 = 1), the copied and the padded row lengths in bytes are
//   both multiples of 16 and both pointers are 16-byte aligned, a thread
//   moves 16-byte chunks (uint4): a chunk of the prefix row, or the fill
//   replicated into 16 bytes. A chunk costs one divide, by the chunks per
//   padded row, and none when the leaf is one axis. Each thread loads
//   UNROLL chunks before it stores them, so several loads are in flight.
// - Element path: every other leaf (the small ragged leaves of a one-doc
//   segment, a view that is not aligned) takes one grid-stride pass over
//   the output, one element a thread a step, with two divides and two
//   modulos an element.
// Both paths keep 32-bit index math while the count they walk plus one
// grid stride (UNROLL strides on the vector path) stays below 2^32, so the
// loop's last step cannot wrap, and 64-bit beyond. Every call is one
// launch.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;
constexpr int UNROLL = 4;

template <typename T, typename I>
__global__ void __launch_bounds__(THREADS)
expand_pad_kernel(const T* __restrict__ x, T* __restrict__ out, I c0, I c1,
                  I c2, I f1, I f2, I total, T fill) {
  const I stride = (I)gridDim.x * THREADS;
  for (I i = (I)blockIdx.x * THREADS + threadIdx.x; i < total; i += stride) {
    const I i2 = i % f2;
    const I r = i / f2;
    const I i1 = r % f1;
    const I i0 = r / f1;
    T v = fill;
    if (i0 < c0 && i1 < c1 && i2 < c2) v = x[(i0 * c1 + i1) * c2 + i2];
    out[i] = v;
  }
}

// rows x cpr chunks out (cpr: chunks a padded row), the first cc chunks of
// each of the first c_rows rows copied from x (cc chunks a compact row);
// rows == 1 is the folded one-axis leaf: no divide.
template <typename I>
__global__ void __launch_bounds__(THREADS)
expand_pad_vec_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                      I c_rows, I cc, I cpr, I total, uint4 fill) {
  const I stride = (I)gridDim.x * THREADS;
  for (I base = (I)blockIdx.x * THREADS + threadIdx.x; base < total;
       base += stride * UNROLL) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const I j = base + (I)u * stride;
      v[u] = fill;
      if (j < total) {
        I r = 0, q = j;
        if (cpr != total) {
          r = j / cpr;
          q = j - r * cpr;
        }
        if (r < c_rows && q < cc) v[u] = x[r * cc + q];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const I j = base + (I)u * stride;
      if (j < total) out[j] = v[u];
    }
  }
}

long long grid_for(long long n) {
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  return blocks < 1 ? 1 : blocks;
}

template <typename T>
cudaError_t launch(const void* x, void* out, long long c0, long long c1,
                   long long c2, long long f0, long long f1, long long f2,
                   unsigned fill_bits, cudaStream_t stream) {
  const long long total = f0 * f1 * f2;
  const long long blocks = grid_for(total);
  const T fill = (T)fill_bits;
  if (total + blocks * THREADS < (1ll << 32)) {
    expand_pad_kernel<T, uint32_t><<<(int)blocks, THREADS, 0, stream>>>(
        (const T*)x, (T*)out, (uint32_t)c0, (uint32_t)c1, (uint32_t)c2,
        (uint32_t)f1, (uint32_t)f2, (uint32_t)total, fill);
  } else {
    expand_pad_kernel<T, unsigned long long>
        <<<(int)blocks, THREADS, 0, stream>>>(
            (const T*)x, (T*)out, (unsigned long long)c0,
            (unsigned long long)c1, (unsigned long long)c2,
            (unsigned long long)f1, (unsigned long long)f2,
            (unsigned long long)total, fill);
  }
  return cudaGetLastError();
}

cudaError_t launch_vec(const void* x, void* out, long long c1, long long c2,
                       long long f1, long long f2, int width,
                       unsigned fill_bits, cudaStream_t stream) {
  const long long cc = c2 * width / 16;
  const long long cpr = f2 * width / 16;
  const long long total = f1 * cpr;
  const long long blocks = grid_for((total + UNROLL - 1) / UNROLL);
  // the fill replicated into 16 bytes
  const unsigned word = width == 4 ? fill_bits : (fill_bits & 0xFFu) *
                                                     0x01010101u;
  const uint4 fill = make_uint4(word, word, word, word);
  if (total + blocks * THREADS * UNROLL < (1ll << 32)) {
    expand_pad_vec_kernel<uint32_t><<<(int)blocks, THREADS, 0, stream>>>(
        (const uint4*)x, (uint4*)out, (uint32_t)c1, (uint32_t)cc,
        (uint32_t)cpr, (uint32_t)total, fill);
  } else {
    expand_pad_vec_kernel<unsigned long long>
        <<<(int)blocks, THREADS, 0, stream>>>(
            (const uint4*)x, (uint4*)out, (unsigned long long)c1,
            (unsigned long long)cc, (unsigned long long)cpr,
            (unsigned long long)total, fill);
  }
  return cudaGetLastError();
}

}  // namespace

// x: the compact prefix [c0, c1, c2], contiguous; out: [f0, f1, f2], each
// f >= its c >= 1; width: 4 or 1 bytes an element; fill_bits: the fill's
// raw bits in that width.
extern "C" int expand_pad(const void* x, void* out, int width, long long c0,
                          long long c1, long long c2, long long f0,
                          long long f1, long long f2, unsigned fill_bits,
                          void* stream) {
  if (c0 < 1 || c1 < 1 || c2 < 1 || c0 > f0 || c1 > f1 || c2 > f2)
    return (int)cudaErrorInvalidValue;
  if (width != 4 && width != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  if (aligned && c0 == 1 && f0 == 1 && (c2 * width) % 16 == 0 &&
      (f2 * width) % 16 == 0)
    return (int)launch_vec(x, out, c1, c2, f1, f2, width, fill_bits, s);
  if (width == 4)
    return (int)launch<uint32_t>(x, out, c0, c1, c2, f0, f1, f2, fill_bits,
                                 s);
  return (int)launch<uint8_t>(x, out, c0, c1, c2, f0, f1, f2, fill_bits, s);
}

extern "C" const char* expand_pad_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
