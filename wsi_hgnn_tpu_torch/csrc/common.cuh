// Helpers shared by the DenseNet kernels.
//
// bf16 path (the main path): Ampere-style tensor-core building blocks that
// Hopper still runs at full width of one warp, namely 16-byte `cp.async`
// copies (global -> shared, zero-filled where masked), `ldmatrix` fragment
// loads and `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`, plus the
// folded-BatchNorm + ReLU of eight bf16 channels with the plain version's
// exact f32 arithmetic. `wgmma`/TMA would need 64-row warpgroup tiles and
// swizzled operand layouts; mma.sync keeps the irregular halo rows of the
// dense layer addressable per lane, which is why it is this design's first
// tensor-core instruction.
//
// f32 path (exact-semantics checks only): the 8x8-per-thread f32 register
// tile on the CUDA cores, `mma_8x8`.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wsi {

// ---------------------------------------------------------------------------
// bf16 tensor-core path
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (src
// must still be a valid address, it is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l/8, row l%8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d[4] += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A operand, row-major [rows][ld] bf16 in shared memory: the 16x16 tile at
// (row0, k0). B operand, k-major [k][ld]: the 16(k) x 16(n) tile at
// (k0, n0) as two n8 fragments, {b[0], b[1]} for n0 and {b[2], b[3]} for
// n0 + 8.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* s,
                                       int ld, int row0, int k0, int lane) {
  ldsm_x4(a, s + (row0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const __nv_bfloat16* s,
                                       int ld, int k0, int n0, int lane) {
  ldsm_x4_trans(b, s + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// u = bf16(relu(x*a + b)) for eight bf16 channels, mul then add unrounded
// as separate f32 operations, exactly as the plain version computes it.
__device__ __forceinline__ uint4 bn_relu8(uint4 raw, const float* a,
                                          const float* b) {
  uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    const float2 f = __bfloat1622float2(v);
    w[i] = pack_bf16(
        fmaxf(__fadd_rn(__fmul_rn(f.x, a[2 * i]), b[2 * i]), 0.f),
        fmaxf(__fadd_rn(__fmul_rn(f.y, a[2 * i + 1]), b[2 * i + 1]), 0.f));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// ---------------------------------------------------------------------------
// f32 CUDA-core path
// ---------------------------------------------------------------------------
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
