// DenseNet-121 transition: relu(a*x + b) @ W[C, C/2], then 2x2 average pool.
//
// Replaces wsi_hgnn_tpu/ops/pallas_densenet.py::transition_fused (Pallas
// body `_transition_kernel`). x [B,H,W,C] NHWC in the storage type (bf16
// on the main path, f32 for exact checks), a/b [C] f32, W [C, C/2];
// writes out[B, H/2, W/2, :C/2] with a row stride of `ldo` channels.
//
// Bound on the H100: the pooled product is 2*B*(H/2)*(W/2)*C*(C/2)
// operations over B*H*W*C input and a quarter of that output, 32-128
// operations per byte at bf16, so it sits below the tensor cores'
// balance point and near the f32 CUDA cores' one; this first kernel runs
// on the f32 CUDA cores.
//
// Design: the pool is linear, so it is taken BEFORE the product (the
// Pallas kernel pools after): each GEMM row is one output pixel whose
// A operand is 0.25 * (sum of its four rounded u), which cuts the
// multiply-adds by 4. A 256-thread block computes a 128x128 output tile
// with an 8x8 register tile per thread, staging 32-channel chunks of the
// pooled u and of W in shared memory; all sums are f32. `ldo` lets the
// caller point `out` at the next dense block's zero-padded buffer, so the
// transition writes its channels there directly and no concat copy
// follows.
#include "common.cuh"

namespace {
using namespace wsi;

constexpr int BM = 128, BN = 128, KC = 32, LDA = BM + 4, THREADS = 256;

template <typename T>
__device__ __forceinline__ float act(const T* p, float a, float b) {
  return round_to<T>(fmaxf(__fadd_rn(__fmul_rn(to_f(*p), a), b), 0.f));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
transition_kernel(const T* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ bsh, const T* __restrict__ wt,
                  T* __restrict__ out, int bsz, int h, int w, int c, int ldo) {
  __shared__ __align__(16) float a_s[KC * LDA];
  __shared__ __align__(16) float w_s[KC * BN];

  const int ho = h / 2, wo = w / 2, n_out = c / 2;
  const int m_total = bsz * ho * wo;
  const int mbase = blockIdx.y * BM, nbase = blockIdx.x * BN;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < c; k0 += KC) {
    for (int e = tid; e < BM * KC; e += THREADS) {
      const int r = e / KC, kk = e % KC;
      const int m = mbase + r, ch = k0 + kk;
      float s = 0.f;
      if (m < m_total && ch < c) {
        const int bi = m / (ho * wo), rem = m % (ho * wo);
        const int i = rem / wo, j = rem % wo;
        const T* p = x + (((size_t)bi * h + 2 * i) * w + 2 * j) * c + ch;
        const float av = a[ch], bv = bsh[ch];
        s = act(p, av, bv) + act(p + c, av, bv);
        s = s + act(p + (size_t)w * c, av, bv);
        s = s + act(p + (size_t)w * c + c, av, bv);
        s = 0.25f * s;
      }
      a_s[kk * LDA + r] = s;
    }
    for (int e = tid; e < KC * BN; e += THREADS) {
      const int kk = e / BN, col = e % BN;
      const int ch = k0 + kk, n = nbase + col;
      w_s[e] = (ch < c && n < n_out) ? to_f(wt[(size_t)ch * n_out + n]) : 0.f;
    }
    __syncthreads();
    mma_8x8(acc, a_s, LDA, w_s, BN, ty * 8, tx * 8, KC);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = mbase + ty * 8 + i;
    if (m >= m_total) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = nbase + tx * 8 + j;
      if (n < n_out) out[(size_t)m * ldo + n] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const T* x, const float* a, const float* b, const T* wt, T* out,
           int bsz, int h, int w, int c, int ldo, cudaStream_t stream) {
  if (c % 2 != 0 || ldo < c / 2) return (int)cudaErrorInvalidValue;
  const int m_total = bsz * (h / 2) * (w / 2);
  const dim3 grid((c / 2 + BN - 1) / BN, (m_total + BM - 1) / BM);
  transition_kernel<T><<<grid, THREADS, 0, stream>>>(x, a, b, wt, out, bsz, h,
                                                     w, c, ldo);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int transition_f32(const float* x, const float* a, const float* b,
                              const float* wt, float* out, int bsz, int h,
                              int w, int c, int ldo, cudaStream_t stream) {
  return launch<float>(x, a, b, wt, out, bsz, h, w, c, ldo, stream);
}

extern "C" int transition_bf16(const void* x, const float* a, const float* b,
                               const void* wt, void* out, int bsz, int h,
                               int w, int c, int ldo, cudaStream_t stream) {
  return launch<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(x), a, b,
      static_cast<const __nv_bfloat16*>(wt), static_cast<__nv_bfloat16*>(out),
      bsz, h, w, c, ldo, stream);
}
