// The k-NN score arithmetic shared by K7 (knn_exact.cu) and K8
// (ivf_probe.cu): one copy, so an exact page and an IVF page score a doc
// with the same bits. Every sum runs in dim order, one rounding per
// multiply and per add, as the plain versions in ops/knn.py do.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

// The k-NN plugin score of a doc from v.q, |v|^2 and |q|^2 in the field's
// space (0 l2, 1 cosinesimil, 2 innerproduct).
__device__ __forceinline__ float space_score(float dot, float dn, float qn,
                                             int space) {
  if (space == 0) {  // l2
    const float raw = -__fadd_rn(__fsub_rn(dn, __fmul_rn(2.0f, dot)), qn);
    return __fdiv_rn(1.0f, __fadd_rn(1.0f, fmaxf(-raw, 0.0f)));
  }
  if (space == 1) {  // cosinesimil
    const float den =
        fmaxf(__fmul_rn(__fsqrt_rn(dn), __fsqrt_rn(qn)), 1e-30f);
    const float c = fminf(fmaxf(__fdiv_rn(dot, den), -1.0f), 1.0f);
    return __fdiv_rn(__fadd_rn(1.0f, c), 2.0f);
  }
  return dot >= 0.0f ? __fadd_rn(dot, 1.0f)  // innerproduct
                     : __fdiv_rn(1.0f, __fsub_rn(1.0f, dot));
}

// |q|^2 of each of B query rows [B, dims], one thread per query.
__global__ void query_norms(const float* __restrict__ queries, int B,
                            int dims, float* __restrict__ qn) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= B) return;
  const float* row = queries + (size_t)q * dims;
  float s = 0.0f;
  for (int j = 0; j < dims; ++j) s = __fadd_rn(s, __fmul_rn(row[j], row[j]));
  qn[q] = s;
}

}  // namespace
