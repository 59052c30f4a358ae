// One DenseNet-121 dense layer, written in place into its 32-channel slot.
//
// Replaces wsi_hgnn_tpu/ops/pallas_densenet.py::dense_layer_fused (Pallas
// body `_kernel`). Same function, on one NHWC block buffer x [B,H,W,C_end]
// whose first k_in = slot*32 channels are written:
//     u = relu(a1*x + b1)          (norm1 folded; u rounded to the storage type)
//     v = relu(u @ W1f + b2)       (conv1 1x1 with norm2 folded; v rounded too)
//     y = conv3x3_same(v, W2cat)   (W2cat [128, 9*32], tap = 3*di + dj)
//     x[..., slot*32 : slot*32+32] = y
// Storage is bf16 on the main path (f32 also builds, for exact-semantics
// checks); every product accumulates in f32.
//
// Bound on the H100: about 2*B*H*W*(128*k_in + 9*128*32) operations
// against bytes that are only the active prefix read once and one slot
// written. At bf16 that is 40-300 operations per byte, near the tensor
// cores' balance point; this first kernel runs on the f32 CUDA cores
// (67 TFLOP/s), where it is compute-bound. wgmma and TMA are later work.
//
// Design: one block of 256 threads per 8x8 output tile of one image, the
// whole layer in one launch. The 3x3 conv needs v on a one-pixel halo, so
// the block recomputes the bottleneck on the 10x10 halo (1.56x the
// bottleneck work of the tile) instead of running two launches through a
// [B,H,W,128] scratch: v never leaves shared memory, the layer stays one
// launch, and the halo's zero padding is applied to v exactly where SAME
// padding puts it (pixels outside the image are 0, not relu(b2)).
// Phase 1 stages 32-channel chunks of u and W1f in shared memory and each
// thread keeps an 8x8 register tile of the [128 (100 halo pixels), 128]
// product. Phase 2 walks the 9 taps, staging each tap's [128, 32] slice of
// W2cat, and each thread sums 8 output channels of one pixel. Blocks read
// channels [0, k_in) and write [k_in, k_in+32), so the in-place write
// never races a read. The Pallas kernel's 128-lane group splicing is a TPU
// layout rule and has no counterpart here.
#include "common.cuh"

namespace {
using namespace wsi;

constexpr int GROWTH = 32;
constexpr int MID = 128;                 // bottleneck width (bn_size * growth)
constexpr int TILE = 8;                  // output tile side
constexpr int HALO = TILE + 2;
constexpr int HPIX = HALO * HALO;        // 100 halo pixels
constexpr int ROWS = 128;                // HPIX padded to the thread grid
constexpr int KC = 32;                   // input channels per staged chunk
constexpr int LDU = ROWS + 4;
constexpr int LDV = MID + 1;
constexpr int THREADS = 256;
constexpr int GEMM_FLOATS = KC * LDU + KC * MID;
constexpr int SMEM_FLOATS = GEMM_FLOATS + HPIX * LDV;
static_assert(MID * GROWTH <= GEMM_FLOATS, "a W2 tap must fit the GEMM region");

template <typename T>
__global__ void __launch_bounds__(THREADS)
dense_layer_kernel(T* __restrict__ x, const float* __restrict__ a1,
                   const float* __restrict__ b1, const T* __restrict__ w1f,
                   const float* __restrict__ b2, const T* __restrict__ w2cat,
                   int h, int w, int c_end, int k_in, int slot) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* u_s = smem;                     // [KC][LDU]   phase 1
  float* w_s = smem + KC * LDU;          // [KC][MID]   phase 1
  float* w2_s = smem;                    // [MID][GROWTH] phase 2
  float* v_s = smem + GEMM_FLOATS;       // [HPIX][LDV]

  const int tid = threadIdx.x;
  const int tiles_w = (w + TILE - 1) / TILE;
  const int oy = (blockIdx.x / tiles_w) * TILE;
  const int ox = (blockIdx.x % tiles_w) * TILE;
  const size_t img = (size_t)blockIdx.y * h * w;

  // ---- phase 1: v on the halo ------------------------------------------
  const int ty = tid / 16, tx = tid % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k_in; k0 += KC) {
    for (int e = tid; e < ROWS * KC; e += THREADS) {
      const int p = e / KC, kk = e % KC;
      float u = 0.f;
      if (p < HPIX) {
        const int hy = oy - 1 + p / HALO, hx = ox - 1 + p % HALO;
        if (hy >= 0 && hy < h && hx >= 0 && hx < w) {
          const int c = k0 + kk;
          const float xv = to_f(x[(img + (size_t)hy * w + hx) * c_end + c]);
          // mul then add, unfused, as the plain version computes it
          u = round_to<T>(fmaxf(__fadd_rn(__fmul_rn(xv, a1[c]), b1[c]), 0.f));
        }
      }
      u_s[kk * LDU + p] = u;
    }
    for (int e = tid; e < KC * MID; e += THREADS)
      w_s[e] = to_f(w1f[(size_t)k0 * MID + e]);
    __syncthreads();
    mma_8x8(acc, u_s, LDU, w_s, MID, ty * 8, tx * 8, KC);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = ty * 8 + i;
    if (p < HPIX) {
      const int hy = oy - 1 + p / HALO, hx = ox - 1 + p % HALO;
      const bool inside = hy >= 0 && hy < h && hx >= 0 && hx < w;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tx * 8 + j;
        v_s[p * LDV + col] =
            inside ? round_to<T>(fmaxf(acc[i][j] + b2[col], 0.f)) : 0.f;
      }
    }
  }
  __syncthreads();

  // ---- phase 2: 3x3 SAME conv of v, one pixel x 8 channels per thread ----
  const int p = tid / 4;                 // output pixel of the tile, 0..63
  const int og = (tid % 4) * 8;          // first of 8 output channels
  const int py = p / TILE, px = p % TILE;
  float y[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) y[j] = 0.f;

  for (int t = 0; t < 9; ++t) {
    for (int e = tid; e < MID * GROWTH; e += THREADS) {
      const int ci = e / GROWTH, o = e % GROWTH;
      w2_s[e] = to_f(w2cat[ci * (9 * GROWTH) + t * GROWTH + o]);
    }
    __syncthreads();
    const float* vrow = v_s + ((py + t / 3) * HALO + px + t % 3) * LDV;
#pragma unroll 4
    for (int ci = 0; ci < MID; ++ci) {
      const float vv = vrow[ci];
      const float4 w0 = *reinterpret_cast<const float4*>(w2_s + ci * GROWTH + og);
      const float4 w1 = *reinterpret_cast<const float4*>(w2_s + ci * GROWTH + og + 4);
      y[0] = fmaf(vv, w0.x, y[0]); y[1] = fmaf(vv, w0.y, y[1]);
      y[2] = fmaf(vv, w0.z, y[2]); y[3] = fmaf(vv, w0.w, y[3]);
      y[4] = fmaf(vv, w1.x, y[4]); y[5] = fmaf(vv, w1.y, y[5]);
      y[6] = fmaf(vv, w1.z, y[6]); y[7] = fmaf(vv, w1.w, y[7]);
    }
    __syncthreads();
  }

  const int gy = oy + py, gx = ox + px;
  if (gy < h && gx < w) {
    T* out = x + (img + (size_t)gy * w + gx) * c_end + slot * GROWTH + og;
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = from_f<T>(y[j]);
  }
}

template <typename T>
int launch(T* x, const float* a1, const float* b1, const T* w1f,
           const float* b2, const T* w2cat, int bsz, int h, int w, int c_end,
           int k_in, int slot, cudaStream_t stream) {
  if (k_in % KC != 0 || k_in <= 0 || slot * GROWTH != k_in ||
      k_in + GROWTH > c_end)
    return (int)cudaErrorInvalidValue;
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dense_layer_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((h + TILE - 1) / TILE) * ((w + TILE - 1) / TILE), bsz);
  dense_layer_kernel<T><<<grid, THREADS, smem, stream>>>(
      x, a1, b1, w1f, b2, w2cat, h, w, c_end, k_in, slot);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dense_layer_f32(float* x, const float* a1, const float* b1,
                               const float* w1f, const float* b2,
                               const float* w2cat, int bsz, int h, int w,
                               int c_end, int k_in, int slot,
                               cudaStream_t stream) {
  return launch<float>(x, a1, b1, w1f, b2, w2cat, bsz, h, w, c_end, k_in,
                       slot, stream);
}

extern "C" int dense_layer_bf16(void* x, const float* a1, const float* b1,
                                const void* w1f, const float* b2,
                                const void* w2cat, int bsz, int h, int w,
                                int c_end, int k_in, int slot,
                                cudaStream_t stream) {
  return launch<__nv_bfloat16>(
      static_cast<__nv_bfloat16*>(x), a1, b1,
      static_cast<const __nv_bfloat16*>(w1f), b2,
      static_cast<const __nv_bfloat16*>(w2cat), bsz, h, w, c_end, k_in, slot,
      stream);
}
