// DenseNet-121 transition: relu(a*x + b) @ W[C, C/2], then 2x2 average pool.
//
// Replaces wsi_hgnn_tpu/ops/pallas_densenet.py::transition_fused (Pallas
// body `_transition_kernel`). x [B,H,W,C] NHWC in the storage type (bf16
// on the main path, f32 for exact checks), a/b [C] f32, W [C, C/2];
// writes out[B, H/2, W/2, :C/2] with a row stride of `ldo` channels, so
// the caller can point `out` at the next dense block's zero-padded buffer
// and no concat copy follows.
//
// Bound on the H100 (bf16, per 128-patch chunk): x read once and a quarter
// of its pixels written at half the channels. The three main-path shapes
// [128,64,64,256], [128,32,32,512], [128,16,16,1024] are bound by bytes
// (0.090 / 0.045 / 0.023 ms); the product on the unpooled pixels is 34.4
// GFLOP at each, 0.035 ms at the bf16 peak, under the bytes except at the
// last shape.
//
// bf16 design (the main path), `transition_tc`: the TPU kernel's own order,
// the product on the unpooled pixels and the pool after it. Pooling first
// would need the pooled f32 mean of u rounded to bf16 to reach the tensor
// cores, a rounding neither the plain version nor the JAX kernel has;
// pooling after costs 4x the MMAs, which stay under the byte bound. A
// block of 8 warps computes 32 pooled pixels x 128 output channels with
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 fed by ldmatrix.
// Its 128 A rows are the 4 window pixels of each pooled pixel, ordered so
// that each warp's four m16 tiles are the four window positions of the
// same 16 pooled pixels: the pool is a sum of four accumulator fragments
// in registers (x 0.25), stored as bf16 pairs. x and W stream in
// 32-channel chunks through a 4-stage ring of 16-byte cp.async copies;
// u = bf16(relu(a*x + b)) is made in shared memory once a chunk lands,
// with the plain version's f32 mul-then-add, and, as in the dense layer,
// one barrier per chunk lets chunk k+1's u be made while chunk k is
// multiplied. Blocks walk the output channels fastest, so the C/2 / 128
// blocks that share a tile's x find it in L2. Grids: 4096, 2x1024 and
// 4x256 blocks; 76,800 bytes of shared memory and 127 registers a thread,
// two blocks of 8 warps per SM. The suspect for its pace (not measured:
// the SM's pipes were not profiled) is shared memory: each
// chunk is written by the copy, read and written by the activation and
// read again by ldmatrix for 4x the pooled MMAs, which is why the share of
// the bound falls as C grows (the bytes shrink, the MMAs do not).
//
// f32 design (exact-semantics checks only, not on the main path),
// `transition_f32_kernel`: the CUDA cores, the pool taken before the
// product (it is linear, and f32 storage needs no rounding of the mean),
// a 128x128 output tile per 256-thread block with an 8x8 register tile
// per thread.
#include "common.cuh"

namespace {
using namespace wsi;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
namespace tc {
using bf16 = __nv_bfloat16;
constexpr int THREADS = 256;
constexpr int PO = 32;                   // pooled pixels per block
constexpr int BM = 4 * PO;               // A rows: 4 window pixels each
constexpr int BN = 128;                  // output channels per block
constexpr int KC = 32, LDA = KC + 8, LDB = BN + 8;
constexpr int RPT = BM * (KC / 8) / THREADS;  // x rows each thread copies
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * LDA * 2;
constexpr int B_BYTES = KC * LDB * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES + 2 * KC * 4;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
static_assert(STAGE_BYTES % 16 == 0, "16 B alignment");
static_assert(STAGES >= 3, "one chunk multiplied, one transformed, one landing");

__global__ void __launch_bounds__(THREADS, 2)
transition_tc(const bf16* __restrict__ x, const float* __restrict__ a,
              const float* __restrict__ bsh, const bf16* __restrict__ wt,
              bf16* __restrict__ out, int bsz, int h, int w, int c, int ldo) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int ho = h / 2, wo = w / 2, n_out = c / 2;
  const int m_out = bsz * ho * wo;
  const int pbase = blockIdx.y * PO, nbase = blockIdx.x * BN;
  const int wm = warp >> 2, wn = warp & 3;         // 2 x 4 warps
  const int lv = tid & 3;                          // this thread's x vector

  // A row r: pooled pixel (r / 64) * 16 + r % 16, window position
  // (r / 16) % 4 = 2 dy + dx. This thread copies rows (tid >> 2) + 64 i.
  long long src[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = (tid >> 2) + 64 * i;
    const int p = pbase + (r >> 6) * 16 + (r & 15), q = (r >> 4) & 3;
    src[i] = -1;
    if (p < m_out) {
      const int bi = p / (ho * wo), rem = p % (ho * wo);
      const int y = 2 * (rem / wo) + (q >> 1), xx = 2 * (rem % wo) + (q & 1);
      src[i] = (((long long)bi * h + y) * w + xx) * c;
    }
  }
  const int nk = c / KC;
  auto load = [&](int kc) {
    unsigned char* st = smem + (kc % STAGES) * STAGE_BYTES;
    bf16* a_s = reinterpret_cast<bf16*>(st);
    bf16* b_s = reinterpret_cast<bf16*>(st + A_BYTES);
    float* f_s = reinterpret_cast<float*>(st + A_BYTES + B_BYTES);
    const int k0 = kc * KC;
#pragma unroll
    for (int i = 0; i < RPT; ++i)                  // zero rows past m_out
      cp_async16(a_s + ((tid >> 2) + 64 * i) * LDA + lv * 8,
                 src[i] >= 0 ? x + src[i] + k0 + lv * 8 : x, src[i] >= 0);
#pragma unroll
    for (int i = 0; i < KC * (BN / 8) / THREADS; ++i) {
      const int e = tid + i * THREADS, kk = e >> 4, n = nbase + (e & 15) * 8;
      cp_async16(b_s + kk * LDB + (e & 15) * 8,
                 n < n_out ? wt + (size_t)(k0 + kk) * n_out + n : wt,
                 n < n_out);
    }
    if (tid < KC / 2)                              // a, b of the chunk
      cp_async16(f_s + tid * 4,
                 tid < KC / 4 ? a + k0 + tid * 4 : bsh + k0 + tid * 4 - KC,
                 true);
  };
  // u = relu(a*x + b) in place on chunk kc's landed stage
  auto transform = [&](int kc) {
    unsigned char* st = smem + (kc % STAGES) * STAGE_BYTES;
    bf16* a_s = reinterpret_cast<bf16*>(st);
    const float* f_s = reinterpret_cast<const float*>(st + A_BYTES + B_BYTES);
    float av[8], bv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      av[e] = f_s[lv * 8 + e];
      bv[e] = f_s[KC + lv * 8 + e];
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      if (src[i] < 0) continue;
      uint4* p =
          reinterpret_cast<uint4*>(a_s + ((tid >> 2) + 64 * i) * LDA + lv * 8);
      *p = bn_relu8(*p, av, bv);
    }
  };

  float acc[4][4][4];                              // [window q][n8][frag]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const bool active = nbase + wn * 32 < n_out;     // warp-uniform

  // One barrier per chunk (the dense layer's pipeline): chunk kc+1's
  // transform overlaps chunk kc's MMAs.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  transform(0);
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 3>();
    __syncthreads();
    if (kc + STAGES - 1 < nk) load(kc + STAGES - 1);
    cp_async_commit();
    if (kc + 1 < nk) transform(kc + 1);
    if (!active) continue;

    unsigned char* st = smem + (kc % STAGES) * STAGE_BYTES;
    const bf16* a_s = reinterpret_cast<const bf16*>(st);
    const bf16* b_s = reinterpret_cast<const bf16*>(st + A_BYTES);
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t bf[2][4];
      load_b(bf[0], b_s, LDB, ks * 16, wn * 32, lane);
      load_b(bf[1], b_s, LDB, ks * 16, wn * 32 + 16, lane);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t af[4];
        load_a(af, a_s, LDA, wm * 64 + q * 16, ks * 16, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[q][j], af, bf[j >> 1][(j & 1) * 2],
                   bf[j >> 1][(j & 1) * 2 + 1]);
      }
    }
  }
  if (!active) return;

  // pool: the four window positions are the four m-tiles, same fragment
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = pbase + wm * 16 + g + half * 8;
    if (p >= m_out) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = nbase + wn * 32 + j * 8 + c2;
      if (n >= n_out) continue;
      float s[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int f = half * 2 + e;
        s[e] = 0.25f * (((acc[0][j][f] + acc[1][j][f]) + acc[2][j][f]) +
                        acc[3][j][f]);
      }
      *reinterpret_cast<uint32_t*>(out + (size_t)p * ldo + n) =
          pack_bf16(s[0], s[1]);
    }
  }
}

int launch(const bf16* x, const float* a, const float* b, const bf16* wt,
           bf16* out, int bsz, int h, int w, int c, int ldo,
           cudaStream_t stream) {
  if (c % KC != 0 || ldo % 2 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      transition_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int m_out = bsz * (h / 2) * (w / 2);
  const dim3 grid((c / 2 + BN - 1) / BN, (m_out + PO - 1) / PO);
  transition_tc<<<grid, THREADS, SMEM_BYTES, stream>>>(x, a, b, wt, out, bsz,
                                                       h, w, c, ldo);
  return (int)cudaGetLastError();
}
}  // namespace tc

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------
namespace cc {
constexpr int BM = 128, BN = 128, KC = 32, LDA = BM + 4, THREADS = 256;

__device__ __forceinline__ float act(const float* p, float a, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(*p, a), b), 0.f);
}

__global__ void __launch_bounds__(THREADS)
transition_f32_kernel(const float* __restrict__ x, const float* __restrict__ a,
                      const float* __restrict__ bsh,
                      const float* __restrict__ wt, float* __restrict__ out,
                      int bsz, int h, int w, int c, int ldo) {
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
        const float* p = x + (((size_t)bi * h + 2 * i) * w + 2 * j) * c + ch;
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
      w_s[e] = (ch < c && n < n_out) ? wt[(size_t)ch * n_out + n] : 0.f;
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
      if (n < n_out) out[(size_t)m * ldo + n] = acc[i][j];
    }
  }
}

int launch(const float* x, const float* a, const float* b, const float* wt,
           float* out, int bsz, int h, int w, int c, int ldo,
           cudaStream_t stream) {
  const int m_total = bsz * (h / 2) * (w / 2);
  const dim3 grid((c / 2 + BN - 1) / BN, (m_total + BM - 1) / BM);
  transition_f32_kernel<<<grid, THREADS, 0, stream>>>(x, a, b, wt, out, bsz, h,
                                                      w, c, ldo);
  return (int)cudaGetLastError();
}
}  // namespace cc

}  // namespace

// Blocks of the bf16 kernel that fit one SM, and its shared memory bytes.
extern "C" int transition_bf16_occupancy(int* blocks, int* smem_bytes) {
  *smem_bytes = tc::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      tc::transition_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, tc::transition_tc, tc::THREADS, tc::SMEM_BYTES);
}

extern "C" int transition_f32(const float* x, const float* a, const float* b,
                              const float* wt, float* out, int bsz, int h,
                              int w, int c, int ldo, cudaStream_t stream) {
  if (c % 2 != 0 || ldo < c / 2) return (int)cudaErrorInvalidValue;
  return cc::launch(x, a, b, wt, out, bsz, h, w, c, ldo, stream);
}

extern "C" int transition_bf16(const void* x, const float* a, const float* b,
                               const void* wt, void* out, int bsz, int h,
                               int w, int c, int ldo, cudaStream_t stream) {
  if (c % 2 != 0 || ldo < c / 2) return (int)cudaErrorInvalidValue;
  return tc::launch(static_cast<const __nv_bfloat16*>(x), a, b,
                    static_cast<const __nv_bfloat16*>(wt),
                    static_cast<__nv_bfloat16*>(out), bsz, h, w, c, ldo,
                    stream);
}
