// Peak issue rate of mma.sync on the card (measurement only, for
// chip_smoke.py --f32-timing: no model path launches it). Each warp issues chains of independent MMAs into eight
// accumulators from registers, with no loads: m16n8k8 TF32 (the f32 DenseNet
// kernels' 3xTF32 products, csrc/common.cuh) or m16n8k16 bf16 (the bf16
// ones). The TF32 rate bounds what those products reach through mma.sync;
// the data-sheet TF32 peak is wgmma's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <bool TF32>
__global__ void mma_rate_kernel(float* out, int iters) {
  float acc[8][4] = {};
  uint32_t a[4], b[2];
  const int t = threadIdx.x;
  for (int e = 0; e < 4; ++e) a[e] = 0x3f800000u + t * 0x2000u + e;
  for (int e = 0; e < 2; ++e) b[e] = 0x3f800000u + t * 0x4000u + e;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if constexpr (TF32)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[k][0]), "+f"(acc[k][1]), "+f"(acc[k][2]),
              "+f"(acc[k][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[k][0]), "+f"(acc[k][1]), "+f"(acc[k][2]),
              "+f"(acc[k][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int k = 0; k < 8; ++k)
    for (int e = 0; e < 4; ++e) s += acc[k][e];
  out[blockIdx.x * blockDim.x + t] = s;             // keeps the MMAs live
}

}  // namespace

// out holds blocks * threads floats; 8 * iters MMAs per warp.
extern "C" int mma_rate(float* out, int tf32, int blocks, int threads,
                        int iters, cudaStream_t stream) {
  if (tf32)
    mma_rate_kernel<true><<<blocks, threads, 0, stream>>>(out, iters);
  else
    mma_rate_kernel<false><<<blocks, threads, 0, stream>>>(out, iters);
  return (int)cudaGetLastError();
}
