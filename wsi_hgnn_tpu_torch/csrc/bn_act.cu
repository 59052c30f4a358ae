// HoVer-Net's BatchNorm (inference) and ReLU in one pass over a
// channels-last map, alone or after the residual add that feeds it.
//
// No TPU kernel stands behind this one: the JAX package leaves these passes
// to XLA, which fuses them into its convolutions' neighbours. Torch on the
// card runs them as separate kernels (BatchNorm, then ReLU, and before a
// pre-activation the residual `h + shortcut`), each reading and writing the
// whole map. Three forms, one launch each:
//   y = relu(bn(x))                      read x, write y       (2 passes)
//   s = h + r; y = relu(bn(s)), keep s   read h, r; write s, y (4 passes)
//   s = h + r; y = relu(bn(s))           read h, r; write y    (3 passes)
// against 4, 7 and 7 map passes for the unfused ops. The pass is bound by
// bytes: at 3.35 TB/s a d0 map of a 128-patch chunk (128 x 256 x 256 x 256
// bf16, 4.3 GB) takes 2.6 ms to read and write once. Measured (chip_smoke.py,
// NVIDIA H100 80GB HBM3, 700 W, the three forms at a chunk's d0-d3 maps):
// 0.86-0.87 of that bound, 2.1-5.1x the unfused ops.
//
// Arithmetic, exactly the unfused path's on the card (torch's eval
// `batch_norm_transform_input_channels_last_kernel`, then `relu`, and
// `add` before them): the sum is rounded to the storage type before the
// affine; per channel, mean, weight and bias are the module's own values
// widened to f32 and inv_std = rsqrtf(f32(var) + eps), the approximate
// reciprocal square root torch's eval BatchNorm takes (on an H100 all of
// 8192 channels equal torch.rsqrt's, 63-67% the correctly rounded
// 1 / sqrt); per element t = (w * (x - mean)) * inv_std + bias with the
// last product and the add in one fma (nvcc's contraction of torch's
// expression); y = t <= 0 ? 0 : t, rounded to the storage type (rounding
// is monotone and keeps 0, so relu after the rounding is the same value).
// So the output equals torch's native path bit for bit, f32 included;
// torch hands f32 maps to cuDNN's BatchNorm when cuDNN is on, which rounds
// the same formula otherwise (within 2.4e-7 on HoVer-Net's maps).
//
// Design: x is [P, C] with P = N*H*W pixel rows. A block is (C/V
// channel vectors, up to 256 threads) x (rows), V = 16 bytes of the
// storage type (8 bf16 or 4 f32), so a thread keeps one channel vector's
// four per-channel terms in registers for all its rows, and a block's
// row of threads reads whole pixel rows: every access is a coalesced
// 16-byte vector. Each thread has UNROLL rows in flight (all loads, then
// all stores); the grid holds one wave of resident blocks and strides over
// the rows, so the per-channel terms are made once per thread. Offsets are
// 64-bit: a chunk's d0 map has 2^31 elements.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
using bf16 = __nv_bfloat16;
constexpr int THREADS = 256;
constexpr int UNROLL = 4;

template <typename T> struct Pack {
  static constexpr int N = 16 / sizeof(T);
  union {
    uint4 raw;
    T v[N];
  };
};

__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(float v) { return v; }
template <typename T> __device__ __forceinline__ T narrow(float v);
template <> __device__ __forceinline__ bf16 narrow<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ float narrow<float>(float v) {
  return v;
}

// MODE 0: y = relu(bn(x)); 1: s = x + r, y = relu(bn(s)), s written; 2: the
// same, s not written. `cv` channel vectors per pixel row, `rows` rows.
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
bn_act_kernel(const T* __restrict__ x, const T* __restrict__ r,
              T* __restrict__ s, T* __restrict__ y,
              const T* __restrict__ weight, const T* __restrict__ bias,
              const T* __restrict__ mean, const T* __restrict__ var,
              float eps, int64_t rows, int cv) {
  using P = Pack<T>;
  constexpr int N = P::N;
  const int64_t ld = (int64_t)cv * N;
  const int64_t step = (int64_t)gridDim.x * blockDim.y * UNROLL;
  for (int c = threadIdx.x; c < cv; c += blockDim.x) {
    float w[N], m[N], inv[N], b[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int ch = c * N + i;
      w[i] = widen(weight[ch]);
      b[i] = widen(bias[ch]);
      m[i] = widen(mean[ch]);
      inv[i] = rsqrtf(__fadd_rn(widen(var[ch]), eps));
    }
    for (int64_t r0 = (int64_t)blockIdx.x * blockDim.y * UNROLL + threadIdx.y;
         r0 < rows; r0 += step) {
      P in[UNROLL], res[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t row = r0 + (int64_t)u * blockDim.y;
        if (row < rows) {
          const int64_t o = row * ld + (int64_t)c * N;
          in[u].raw = __ldg(reinterpret_cast<const uint4*>(x + o));
          if constexpr (MODE != 0)
            res[u].raw = __ldg(reinterpret_cast<const uint4*>(r + o));
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t row = r0 + (int64_t)u * blockDim.y;
        if (row >= rows) continue;
        const int64_t o = row * ld + (int64_t)c * N;
        P out;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          float v = widen(in[u].v[i]);
          if constexpr (MODE != 0) {
            in[u].v[i] = narrow<T>(__fadd_rn(v, widen(res[u].v[i])));
            v = widen(in[u].v[i]);
          }
          const float t =
              __fmaf_rn(__fmul_rn(w[i], __fsub_rn(v, m[i])), inv[i], b[i]);
          out.v[i] = narrow<T>(t <= 0.f ? 0.f : t);
        }
        if constexpr (MODE == 1)
          *reinterpret_cast<uint4*>(s + o) = in[u].raw;
        *reinterpret_cast<uint4*>(y + o) = out.raw;
      }
    }
  }
}

template <typename T, int MODE>
int launch(const T* x, const T* r, T* s, T* y, const T* weight,
           const T* bias, const T* mean, const T* var, float eps,
           int64_t rows, int c, cudaStream_t stream) {
  constexpr int N = Pack<T>::N;
  if (c % N != 0 || rows <= 0) return (int)cudaErrorInvalidValue;
  const int cv = c / N;
  const int tx = cv < THREADS ? cv : THREADS;
  const dim3 block(tx, THREADS / tx);
  // one wave of resident blocks (occupancy per block size, asked once)
  static int resident[THREADS + 1];
  const int threads = block.x * block.y;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && resident[threads] == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident[threads], bn_act_kernel<T, MODE>, threads, 0);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (rows + (int64_t)block.y * UNROLL - 1) /
                        ((int64_t)block.y * UNROLL);
  const int64_t wave = (int64_t)sms * resident[threads];
  const int grid = (int)(tiles < wave ? tiles : wave);
  bn_act_kernel<T, MODE><<<grid, block, 0, stream>>>(
      x, r, s, y, weight, bias, mean, var, eps, rows, cv);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* r, void* s, void* y,
             const void* weight, const void* bias, const void* mean,
             const void* var, float eps, int64_t rows, int c,
             cudaStream_t stream) {
  auto X = static_cast<const T*>(x);
  auto R = static_cast<const T*>(r);
  auto W = static_cast<const T*>(weight);
  auto B = static_cast<const T*>(bias);
  auto M = static_cast<const T*>(mean);
  auto V = static_cast<const T*>(var);
  auto Y = static_cast<T*>(y);
  if (r == nullptr)
    return launch<T, 0>(X, R, nullptr, Y, W, B, M, V, eps, rows, c, stream);
  if (s != nullptr)
    return launch<T, 1>(X, R, static_cast<T*>(s), Y, W, B, M, V, eps, rows, c,
                        stream);
  return launch<T, 2>(X, R, nullptr, Y, W, B, M, V, eps, rows, c, stream);
}
}  // namespace

// x, r, s, y: [rows, c] channels-last maps in the storage type; weight,
// bias, mean, var: [c] in the storage type. r null: y = relu(bn(x)); r
// set: s = x + r and y = relu(bn(s)), with s written when s is not null.
extern "C" int bn_act_bf16(const void* x, const void* r, void* s, void* y,
                           const void* weight, const void* bias,
                           const void* mean, const void* var, float eps,
                           int64_t rows, int c, cudaStream_t stream) {
  return dispatch<bf16>(x, r, s, y, weight, bias, mean, var, eps, rows, c,
                        stream);
}

extern "C" int bn_act_f32(const void* x, const void* r, void* s, void* y,
                          const void* weight, const void* bias,
                          const void* mean, const void* var, float eps,
                          int64_t rows, int c, cudaStream_t stream) {
  return dispatch<float>(x, r, s, y, weight, bias, mean, var, eps, rows, c,
                         stream);
}
