// Row 16 expand_pad: fill-pad a compact prefix out to its padded shape,
// out = full(f0 x f1 x f2, fill); out[:c0, :c1, :c2] = x.
//
// Replaces opensearch_tpu/ops/device_segment.py:_expand_fn, the on-device
// half of the delta segment publish: a refresh or a merge sends only the
// populated prefix of every padded leaf of a segment's image, and this
// kernel rebuilds the padded leaf on the card. Leaves of 1-3 dims come in
// as 3 (leading extents 1). The leaves are int32, float32, bool and uint8
// (PQ codes), so the kernel moves elements of 4 or 1 bytes as raw bits and
// takes the fill as bits of that width.
//
// What bounds it on an H100: bytes. It reads the compact prefix once and
// writes the padded leaf once, (c0 c1 c2 + f0 f1 f2) x width bytes over
// 3.35 TB/s, and does no arithmetic beyond its index math.
//
// Design. One grid-stride pass over the output, one element a thread a
// step: neighbouring threads write neighbouring addresses, and read
// neighbouring addresses inside a prefix row. Each output element copies
// its source element or writes the fill. The index math is 32-bit where the
// output's element count plus one grid stride stays below 2^32 (so the
// loop's last `i += stride` cannot wrap), 64-bit beyond. A 16-byte-a-thread
// copy of the prefix rows is later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;

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

template <typename T>
cudaError_t launch(const void* x, void* out, long long c0, long long c1,
                   long long c2, long long f0, long long f1, long long f2,
                   unsigned fill_bits, cudaStream_t stream) {
  const long long total = f0 * f1 * f2;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
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
  cudaStream_t s = (cudaStream_t)stream;
  if (width == 4)
    return (int)launch<uint32_t>(x, out, c0, c1, c2, f0, f1, f2, fill_bits,
                                 s);
  if (width == 1)
    return (int)launch<uint8_t>(x, out, c0, c1, c2, f0, f1, f2, fill_bits,
                                s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* expand_pad_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
