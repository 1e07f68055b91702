// Helpers of the kernels that walk row tiles (nested_join.cu,
// nested_aggs.cu): a CTA-wide min / max of an int, the 16-byte alignment
// test that picks a kernel's vector path, and the loads and stores of a
// thread's four consecutive rows on either path.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace {

// v's min (MAX: max) over a CTA of NT threads; s_red [NT / 32]
template <int NT, bool MAX>
__device__ __forceinline__ int block_reduce(int v, int* s_red) {
  v = MAX ? __reduce_max_sync(0xffffffffu, v)
          : __reduce_min_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  int out = s_red[0];
  for (int w = 1; w < NT / 32; ++w)
    out = MAX ? max(out, s_red[w]) : min(out, s_red[w]);
  __syncthreads();
  return out;
}

// every pointer on a 16-byte boundary
template <typename... P>
bool aligned16(const P*... ptrs) {
  return ((reinterpret_cast<uintptr_t>(ptrs) % 16 == 0) && ...);
}

// Rows r .. r + 3 of a row of n values (r a multiple of 4). VEC (n a
// multiple of 16, the row 16-byte aligned): one vector access where r < n;
// else element by element, each row below n. Loads give `fill` past n.
template <bool VEC>
__device__ __forceinline__ void load4(const int* __restrict__ p, int r,
                                      int n, int fill, int (&v)[4]) {
  if (VEC) {
    const int4 x = r < n ? __ldg(reinterpret_cast<const int4*>(p + r))
                         : make_int4(fill, fill, fill, fill);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = r + c < n ? __ldg(p + r + c) : fill;
  }
}

// bytes as flags, false past n
template <bool VEC>
__device__ __forceinline__ void load4(const uint8_t* __restrict__ p, int r,
                                      int n, bool (&v)[4]) {
  if (VEC) {
    const unsigned x =
        r < n ? __ldg(reinterpret_cast<const unsigned*>(p + r)) : 0u;
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = ((x >> (8 * c)) & 0xffu) != 0u;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = r + c < n && __ldg(p + r + c) != 0;
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(float* p, int r, int n,
                                       const float (&v)[4]) {
  if (VEC) {
    if (r < n)
      *reinterpret_cast<float4*>(p + r) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (r + c < n) p[r + c] = v[c];
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(int* p, int r, int n,
                                       const int (&v)[4]) {
  if (VEC) {
    if (r < n)
      *reinterpret_cast<int4*>(p + r) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (r + c < n) p[r + c] = v[c];
  }
}

// flags as bytes 0 / 1
template <bool VEC>
__device__ __forceinline__ void store4(uint8_t* p, int r, int n,
                                       const bool (&v)[4]) {
  if (VEC) {
    if (r < n)
      *reinterpret_cast<unsigned*>(p + r) =
          (v[0] ? 1u : 0u) | (v[1] ? 1u << 8 : 0u) | (v[2] ? 1u << 16 : 0u) |
          (v[3] ? 1u << 24 : 0u);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (r + c < n) p[r + c] = v[c] ? 1 : 0;
  }
}

}  // namespace
