// Helpers shared by the DenseNet kernels.
//
// Ampere-style tensor-core building blocks that Hopper still runs at the
// full width of one warp: 16-byte (and, for rows that are not 16-byte
// aligned, 4-byte) `cp.async` copies (global -> shared, zero-filled where
// masked), `ldmatrix` fragment loads and `mma.sync`. `wgmma`/TMA would
// need 64-row warpgroup tiles and swizzled operand layouts; mma.sync keeps
// the irregular halo rows of the dense layer addressable per lane, which
// is why it is these designs' first tensor-core instruction.
//
// bf16 storage: `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`,
// plus the folded-BatchNorm + ReLU of eight bf16 channels with the plain
// version's exact f32 arithmetic.
//
// f32 storage: 3xTF32 on `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`.
// Each f32 operand x is split into a TF32 high part hi = rna(x) and a TF32
// residual lo = rna(x - hi) (`cvt.rna.tf32.f32`: the tensor core itself
// would truncate the low 13 bits, which leaves the split wrong), and a
// product is lo*hi + hi*lo + hi*hi into f32 accumulators, small terms
// first; lo*lo (about 2^-22 of the product) is dropped. Each operand then
// carries about 22 bits, so the result matches a full f32 product to a
// few f32 ulps of its terms, at tensor-core rates. `ldmatrix` moves 16-bit
// elements, but its non-transposed .x4 form delivers the m16n8k8 TF32 A
// fragment from a row-major f32 tile (lane l gets row l/4, 32-bit column
// l%4 of each 8x4 quarter); B fragments are read with 32-bit shared loads.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wsi {

// ---------------------------------------------------------------------------
// copies and fragment loads (both storage types)
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
// 4 bytes global -> shared (rows whose stride is not a multiple of 16 B).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}
// VEC f32 values (4 or 1) global -> shared.
template <int VEC>
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool valid) {
  static_assert(VEC == 4 || VEC == 1, "16-byte or 4-byte copies");
  if constexpr (VEC == 4)
    cp_async16(dst, src, valid);
  else
    cp_async4(dst, src, valid);
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

// ---------------------------------------------------------------------------
// bf16 path
// ---------------------------------------------------------------------------
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
// f32 path: 3xTF32
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo with hi and lo both TF32, rounded to nearest (ties away).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// d[4] += a (16x8 tf32, row) * b (8x8 tf32, col), f32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in 3xTF32: lo*hi and hi*lo before hi*hi (CUTLASS's
// OpMultiplyAddFastF32 order), lo*lo dropped. b is {b0, b1} per part.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi[0], b_hi[1]);
  mma_tf32(d, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(d, a_hi, b_hi[0], b_hi[1]);
}

// The m16n8k8 A fragment of the row-major f32 tile at (row0, k0) of s
// (row stride ld floats, a multiple of 4), split into hi and lo.
__device__ __forceinline__ void load_a_tf32(uint32_t (&hi)[4],
                                            uint32_t (&lo)[4], const float* s,
                                            int ld, int row0, int k0,
                                            int lane) {
  uint32_t r[4];
  ldsm_x4(r, s + (row0 + (lane & 15)) * ld + k0 + (lane >> 4) * 4);
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(r[e]), hi[e], lo[e]);
}

// The m16n8k8 B fragment {b0, b1} of the k-major f32 tile s[k][ld] at
// (k0, n0), split: b0 = s[k0 + l%4][n0 + l/4], b1 four rows below.
__device__ __forceinline__ void load_b_tf32(uint32_t (&hi)[2],
                                            uint32_t (&lo)[2], const float* s,
                                            int ld, int k0, int n0, int lane) {
  const float* p = s + (k0 + (lane & 3)) * ld + n0 + (lane >> 2);
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[4 * ld], hi[1], lo[1]);
}

// The same fragments from operands split in shared memory beforehand: hi
// and lo planes of the same layout and stride.
__device__ __forceinline__ void load_a_split(uint32_t (&hi)[4],
                                             uint32_t (&lo)[4],
                                             const float* s_hi,
                                             const float* s_lo, int ld,
                                             int row0, int k0, int lane) {
  const int o = (row0 + (lane & 15)) * ld + k0 + (lane >> 4) * 4;
  ldsm_x4(hi, s_hi + o);
  ldsm_x4(lo, s_lo + o);
}
__device__ __forceinline__ void load_b_split(uint32_t (&hi)[2],
                                             uint32_t (&lo)[2],
                                             const uint32_t* s_hi,
                                             const uint32_t* s_lo, int ld,
                                             int k0, int n0, int lane) {
  const int o = (k0 + (lane & 3)) * ld + n0 + (lane >> 2);
  hi[0] = s_hi[o];
  hi[1] = s_hi[o + 4 * ld];
  lo[0] = s_lo[o];
  lo[1] = s_lo[o + 4 * ld];
}

// Four f32 values split into TF32 hi and lo.
__device__ __forceinline__ void split4_tf32(float4 v, uint4& hi, uint4& lo) {
  split_tf32(v.x, hi.x, lo.x);
  split_tf32(v.y, hi.y, lo.y);
  split_tf32(v.z, hi.z, lo.z);
  split_tf32(v.w, hi.w, lo.w);
}

}  // namespace wsi
