// UNI2-h's elementwise passes between its GEMMs (models/featurizers/vit.py),
// one pass each over a token row's data:
//   swiglu:          [a | b] = fc1's output  ->  silu(a) * b
//   add_layer_norm:  x += gamma * branch (the f32 residual stream, in place)
//                    y = layer_norm(bf16(x)) with the next norm's weight
//                    and bias; or the update alone, or the LayerNorm alone
// The update writes the stream in place, which the ViT allows: it runs
// frozen, under torch.inference_mode(), so no autograd graph keeps the old
// stream and no other op reads it after the update.
//
// No TPU kernel stands behind these: the JAX package has no ViT. Torch on
// the card runs each as three to five kernels, several of them reading a
// half of fc1's output strided, or bf16 operands into an f32 result
// element by element: SiLU, the gate's product, a mixed-dtype `addcmul`,
// the bf16 cast and the LayerNorm. Bytes bound every one of them (a few
// operations a byte against the 295 the tensor cores need), and a chunk's
// f32 stream (256 x 265 x 1536 x 4 B = 417 MB) is 8x the 50 MB L2, so each
// pass goes to HBM. The design therefore moves each byte once, in wide
// vectors: per token and block, swiglu reads 16 KB and writes 8 KB (41 KB
// for torch's SiLU and product), add_layer_norm reads 9.2 KB and writes
// 9.2 KB (30.7 KB for addcmul, cast and LayerNorm).
//
// Arithmetic, exactly the unfused card path's where torch's is fixed:
// * SiLU as torch's `silu_kernel`: f32 x / (1 + expf(-x)) with an IEEE
//   division (no fast-math flags here, as in torch's build), rounded to
//   bf16; the gate's product as torch's bf16 `mul`: f32 product, rounded
//   to bf16. So swiglu equals F.silu(a) * b bit for bit.
// * The update as `torch.addcmul(x, gamma, branch)` on an f32 x and bf16
//   gamma and branch: __fadd_rn(x, __fmul_rn(gamma, branch)). The product
//   of two bf16 values has at most 16 significant bits, so it is exact in
//   f32 (short of subnormals), and the one rounding of the add is all
//   there is whether torch's build contracts its expression into an fma
//   or not: the stream equals addcmul's bit for bit.
// * The LayerNorm as torch's `vectorized_layer_norm_kernel` on the bf16
//   cast, step for step (aten/src/ATen/native/cuda/layer_norm_kernel.cu
//   as of torch 2.11.0; a torch that reorders those sums no longer
//   matches bit for bit, and the card test then prints by how many bf16
//   ulps): 128 threads a row, thread t taking the 4-wide vectors t,
//   t + 128, ...; Welford's online sums over its elements in
//   order, combined down each warp by shuffles and then over the 4 warps
//   in a tree (`cuWelfordOnlineSum`, `cuWelfordCombine`, their `a + b * c`
//   written as the fma nvcc contracts them to); var = m2 / d, rstd =
//   rsqrtf(var + eps), y = fma(w, rstd * (v - mean), b), rounded to bf16.
//   The statistics decide y near zero, where w * (...) and b cancel: a
//   mean one f32 ulp off moves such a y by many bf16 ulps. Where nvcc
//   contracts the combine's two products the other way round, the result
//   still agrees at UNI2-h's width: every count combined there is equal
//   (3 * 2^n), so both products are halves, exact.
//
// Design: swiglu takes a block of (half-row vectors, up to 256 threads) x
// rows, UNROLL rows in flight a thread: all 16-byte loads of both halves,
// then the 16-byte stores. add_layer_norm takes one block of 128 threads
// a row, the row held in registers (K vectors a thread) from its load
// through the update's write-back, the statistics and the output: the
// stream's 16-byte loads and stores, the bf16 branch, parameters (8-byte
// loads that hit L1 after a block's first row on the SM) and output in
// 8-byte vectors, every access coalesced. Both take the width as an
// argument and need only 16-byte rows of bf16 (width % 8).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
using bf16 = __nv_bfloat16;
constexpr int SWIGLU_THREADS = 256;
constexpr int SWIGLU_UNROLL = 4;
constexpr int LN_THREADS = 128;   // torch's vectorized LayerNorm: 4 warps

struct Bf16x8 {
  union {
    uint4 raw;
    bf16 v[8];
  };
};

struct Bf16x4 {
  union {
    uint2 raw;
    bf16 v[4];
  };
};

__device__ __forceinline__ Bf16x8 load8(const bf16* p) {
  Bf16x8 r;
  r.raw = __ldg(reinterpret_cast<const uint4*>(p));
  return r;
}

__device__ __forceinline__ Bf16x4 load4(const bf16* p) {
  Bf16x4 r;
  r.raw = __ldg(reinterpret_cast<const uint2*>(p));
  return r;
}

// torch's silu in f32, rounded to bf16
__device__ __forceinline__ float silu_bf16(float x) {
  return __bfloat162float(
      __float2bfloat16_rn(__fdiv_rn(x, __fadd_rn(1.f, expf(-x)))));
}

// h: [rows, 2 * fv * 8], out: [rows, fv * 8]
__global__ void __launch_bounds__(SWIGLU_THREADS)
swiglu_kernel(const bf16* __restrict__ h, bf16* __restrict__ out,
              int64_t rows, int fv) {
  const int64_t half = (int64_t)fv * 8;
  const int64_t r0 = (int64_t)blockIdx.x * blockDim.y * SWIGLU_UNROLL +
                     threadIdx.y;
  for (int c = threadIdx.x; c < fv; c += blockDim.x) {
    Bf16x8 a[SWIGLU_UNROLL], b[SWIGLU_UNROLL];
#pragma unroll
    for (int u = 0; u < SWIGLU_UNROLL; ++u) {
      const int64_t row = r0 + (int64_t)u * blockDim.y;
      if (row < rows) {
        const bf16* src = h + row * 2 * half + (int64_t)c * 8;
        a[u] = load8(src);
        b[u] = load8(src + half);
      }
    }
#pragma unroll
    for (int u = 0; u < SWIGLU_UNROLL; ++u) {
      const int64_t row = r0 + (int64_t)u * blockDim.y;
      if (row >= rows) continue;
      Bf16x8 y;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        y.v[i] = __float2bfloat16_rn(__fmul_rn(
            silu_bf16(__bfloat162float(a[u].v[i])),
            __bfloat162float(b[u].v[i])));
      *reinterpret_cast<uint4*>(out + row * half + (int64_t)c * 8) = y.raw;
    }
  }
}

// torch's Welford state (WelfordDataLN in layer_norm_kernel.cu)
struct Welford {
  float mean, m2, count;
};

// cuWelfordOnlineSum, its expressions contracted as nvcc contracts them
__device__ __forceinline__ Welford welford_add(Welford w, float v) {
  const float delta = __fsub_rn(v, w.mean);
  const float count = __fadd_rn(w.count, 1.f);
  const float mean = __fmaf_rn(delta, __frcp_rn(count), w.mean);
  return {mean, __fmaf_rn(delta, __fsub_rn(v, mean), w.m2), count};
}

// cuWelfordCombine(b, a), likewise
__device__ __forceinline__ Welford welford_combine(Welford b, Welford a) {
  const float delta = __fsub_rn(b.mean, a.mean);
  const float count = __fadd_rn(a.count, b.count);
  if (!(count > 0.f)) return {0.f, 0.f, count};
  const float coef = __frcp_rn(count);
  const float na = __fmul_rn(a.count, coef), nb = __fmul_rn(b.count, coef);
  const float mean = __fmaf_rn(nb, a.mean, __fmul_rn(na, b.mean));
  const float m2 = __fmaf_rn(__fmul_rn(__fmul_rn(delta, delta), a.count), nb,
                             __fadd_rn(a.m2, b.m2));
  return {mean, m2, count};
}

// MODE 0: x += gamma * branch, y = LN(bf16(x)); 1: y = LN(bf16(x)), x read
// only; 2: x += gamma * branch alone. x, branch, y: [rows, nv * 4]; thread
// t holds the 4-wide vectors t, t + LN_THREADS, ... (K of them at most).
template <int K, int MODE>
__global__ void __launch_bounds__(LN_THREADS)
add_layer_norm_kernel(float* __restrict__ x, const bf16* __restrict__ gamma,
                      const bf16* __restrict__ branch,
                      const bf16* __restrict__ w, const bf16* __restrict__ b,
                      bf16* __restrict__ y, float eps, int nv) {
  __shared__ float red[3 * LN_THREADS / 32 + 2];
  const int t = threadIdx.x;
  const int64_t d = (int64_t)nv * 4;
  float* xr = x + blockIdx.x * d;
  float v[K][4];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = t + k * LN_THREADS;
    if (c >= nv) continue;
    float4 s = *reinterpret_cast<const float4*>(xr + c * 4);
    if constexpr (MODE != 1) {
      const Bf16x4 g = load4(gamma + c * 4);
      const Bf16x4 r = load4(branch + blockIdx.x * d + c * 4);
      s.x = __fadd_rn(s.x, __fmul_rn(__bfloat162float(g.v[0]),
                                     __bfloat162float(r.v[0])));
      s.y = __fadd_rn(s.y, __fmul_rn(__bfloat162float(g.v[1]),
                                     __bfloat162float(r.v[1])));
      s.z = __fadd_rn(s.z, __fmul_rn(__bfloat162float(g.v[2]),
                                     __bfloat162float(r.v[2])));
      s.w = __fadd_rn(s.w, __fmul_rn(__bfloat162float(g.v[3]),
                                     __bfloat162float(r.v[3])));
      *reinterpret_cast<float4*>(xr + c * 4) = s;
    }
    v[k][0] = s.x;
    v[k][1] = s.y;
    v[k][2] = s.z;
    v[k][3] = s.w;
  }
  if constexpr (MODE == 2) return;
  // the LayerNorm reads the stream rounded to bf16; statistics as torch's
  // compute_stats: each thread's elements in order, then down the warp,
  // then a tree over the warps
  Welford st{0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (t + k * LN_THREADS >= nv) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[k][i] = __bfloat162float(__float2bfloat16_rn(v[k][i]));
      st = welford_add(st, v[k][i]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Welford other{__shfl_down_sync(0xffffffffu, st.mean, o),
                        __shfl_down_sync(0xffffffffu, st.m2, o),
                        __shfl_down_sync(0xffffffffu, st.count, o)};
    st = welford_combine(st, other);
  }
  const int warp = t >> 5, lane = t & 31;
#pragma unroll
  for (int o = LN_THREADS / 64; o > 0; o >>= 1) {
    if (lane == 0 && warp >= o && warp < 2 * o) {
      red[3 * (warp - o)] = st.mean;
      red[3 * (warp - o) + 1] = st.m2;
      red[3 * (warp - o) + 2] = st.count;
    }
    __syncthreads();
    if (lane == 0 && warp < o)
      st = welford_combine(
          st, Welford{red[3 * warp], red[3 * warp + 1], red[3 * warp + 2]});
    __syncthreads();
  }
  if (t == 0) {
    red[0] = st.mean;
    red[1] = __fdiv_rn(st.m2, (float)d);
  }
  __syncthreads();
  const float mean = red[0];
  const float rstd = rsqrtf(__fadd_rn(red[1], eps));
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = t + k * LN_THREADS;
    if (c >= nv) continue;
    const Bf16x4 wv = load4(w + c * 4), bv = load4(b + c * 4);
    Bf16x4 out;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      out.v[i] = __float2bfloat16_rn(__fmaf_rn(
          __bfloat162float(wv.v[i]),
          __fmul_rn(rstd, __fsub_rn(v[k][i], mean)),
          __bfloat162float(bv.v[i])));
    *reinterpret_cast<uint2*>(y + blockIdx.x * d + c * 4) = out.raw;
  }
}

template <int K>
int launch_ln(float* x, const bf16* gamma, const bf16* branch, const bf16* w,
              const bf16* b, bf16* y, float eps, int64_t rows, int nv,
              cudaStream_t stream) {
  const dim3 grid((unsigned)rows), block(LN_THREADS);
  if (branch == nullptr)
    add_layer_norm_kernel<K, 1><<<grid, block, 0, stream>>>(
        x, gamma, branch, w, b, y, eps, nv);
  else if (w == nullptr)
    add_layer_norm_kernel<K, 2><<<grid, block, 0, stream>>>(
        x, gamma, branch, w, b, y, eps, nv);
  else
    add_layer_norm_kernel<K, 0><<<grid, block, 0, stream>>>(
        x, gamma, branch, w, b, y, eps, nv);
  return (int)cudaGetLastError();
}
}  // namespace

// h: [rows, 2f] bf16 (fc1's output, a the first half), out: [rows, f] bf16;
// f % 8 == 0, both 16-byte aligned.
extern "C" int vit_swiglu_bf16(const void* h, void* out, int64_t rows, int f,
                               cudaStream_t stream) {
  if (f <= 0 || f % 8 != 0 || rows <= 0) return (int)cudaErrorInvalidValue;
  const int fv = f / 8;
  const int tx = fv < SWIGLU_THREADS ? fv : SWIGLU_THREADS;
  const dim3 block(tx, SWIGLU_THREADS / tx);
  const int64_t per_block = (int64_t)block.y * SWIGLU_UNROLL;
  const int64_t grid = (rows + per_block - 1) / per_block;
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  swiglu_kernel<<<(unsigned)grid, block, 0, stream>>>(
      static_cast<const bf16*>(h), static_cast<bf16*>(out), rows, fv);
  return (int)cudaGetLastError();
}

// x: [rows, d] f32, updated in place when branch is set; gamma: [d] bf16;
// branch: [rows, d] bf16 or null (the LayerNorm alone); w, b: [d] bf16 or
// both null (the update alone); y: [rows, d] bf16 or null with them. d % 8
// == 0 and d <= 4096; every pointer 16-byte aligned.
extern "C" int vit_add_layer_norm(void* x, const void* gamma,
                                  const void* branch, const void* w,
                                  const void* b, void* y, float eps,
                                  int64_t rows, int d, cudaStream_t stream) {
  if (d <= 0 || d % 8 != 0 || d > 4096 || rows <= 0 || rows > 0x7fffffff ||
      (branch == nullptr && w == nullptr) ||
      ((w == nullptr) != (y == nullptr)) || (b == nullptr) != (w == nullptr))
    return (int)cudaErrorInvalidValue;
  auto X = static_cast<float*>(x);
  auto G = static_cast<const bf16*>(gamma);
  auto R = static_cast<const bf16*>(branch);
  auto W = static_cast<const bf16*>(w);
  auto B = static_cast<const bf16*>(b);
  auto Y = static_cast<bf16*>(y);
  const int nv = d / 4;
  const int k = (nv + LN_THREADS - 1) / LN_THREADS;   // 1 .. 8
  if (k <= 1) return launch_ln<1>(X, G, R, W, B, Y, eps, rows, nv, stream);
  if (k <= 2) return launch_ln<2>(X, G, R, W, B, Y, eps, rows, nv, stream);
  if (k <= 3) return launch_ln<3>(X, G, R, W, B, Y, eps, rows, nv, stream);
  if (k <= 4) return launch_ln<4>(X, G, R, W, B, Y, eps, rows, nv, stream);
  return launch_ln<8>(X, G, R, W, B, Y, eps, rows, nv, stream);
}
