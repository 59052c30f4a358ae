// Helpers shared by the DenseNet kernels: storage-type conversions and
// the 8x8-per-thread f32 register tile both GEMM phases use.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace wsi {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to the storage type and back: the TPU kernels cast each GEMM
// operand to the storage dtype before the product; so do these.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// acc[8][8] += A[kk][row0..row0+8] (x) B[kk][col0..col0+8] over kc steps.
// A and B are k-major f32 tiles in shared memory with row strides lda and
// ldb (multiples of 4, so the float4 reads stay aligned).
__device__ __forceinline__ void mma_8x8(float (&acc)[8][8], const float* a,
                                        int lda, const float* b, int ldb,
                                        int row0, int col0, int kc) {
#pragma unroll 4
  for (int kk = 0; kk < kc; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + kk * lda + row0);
    const float4 a1 = *reinterpret_cast<const float4*>(a + kk * lda + row0 + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(b + kk * ldb + col0);
    const float4 b1 = *reinterpret_cast<const float4*>(b + kk * ldb + col0 + 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

}  // namespace wsi
