// DenseNet-121 transition: relu(a*x + b) @ W[C, C/2], then 2x2 average pool.
//
// Replaces wsi_hgnn_tpu/ops/pallas_densenet.py::transition_fused (Pallas
// body `_transition_kernel`). x [B,H,W,C] NHWC in the storage type (bf16
// on the serving path, f32 on SimCLR's backbone), a/b [C] f32, W [C, C/2];
// writes out[B, H/2, W/2, :C/2] with a row stride of `ldo` channels, so
// the caller can point `out` at the next dense block's zero-padded buffer
// and no concat copy follows.
//
// Bound on the H100 (per 128-patch chunk): x read once and a quarter of
// its pixels written at half the channels. bf16: the three main-path shapes
// [128,64,64,256], [128,32,32,512], [128,16,16,1024] are bound by bytes
// (0.090 / 0.045 / 0.023 ms); the product on the unpooled pixels is 34.4
// GFLOP at each, 0.035 ms at the bf16 peak, under the bytes except at the
// last shape. f32 (pooled first, 8.6 GFLOP a shape): at 3xTF32 (495/3
// TF/s) the bytes bound the first two shapes (0.180 / 0.090 ms), the
// operations the last (0.053 ms).
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
// f32 design (SimCLR's frozen KimiaNet and `--extract`, B = 128),
// `transition_tf32`: the pool is taken first (it is linear, and f32
// storage needs no rounding of the mean), so the product is 4x smaller,
// then the tensor cores in 3xTF32 (common.cuh). A block of 8 warps (2 x 4,
// 64 x 32 each) computes 128 pooled pixels x 128 output channels. The
// window pixels' x and W stream in 16-channel chunks through a 3-stage
// ring of 16-byte cp.async copies (4-byte copies where C % 8 != 0, ragged
// chunks zero-filled); once a chunk lands, the pooled u = 0.25 * the sum
// of relu(a*x + b) over the window (the plain version's order) and W are
// split once into TF32 hi and lo planes, double-buffered, so the MMA loop
// loads fragments and splits nothing. One barrier per chunk; each warp
// multiplies chunk k and then makes chunk k+1's operands. Grids: 1024,
// 2x256 and 4x64 blocks; 199,040 bytes of shared memory, one block per
// SM. Measured (chip_smoke.py --f32-timing, NVIDIA H100 80GB HBM3, 700.00
// W): 0.32 / 0.27 / 0.25 ms, 0.56 / 0.34 / 0.21 of the bound (2.3x the
// CUDA-core design it replaces, 4.4x the plain f32 version). Suspects
// (the SM's pipes were not profiled): with one block per SM, two chunks in
// flight leave the first shape short of the memory rate; the last reaches
// a third of mma.sync's TF32 rate (290-325 TF/s on this card, measured
// by chip_smoke.py --f32-timing), its transform and barrier not hidden
// behind the MMAs.
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
// f32: tensor cores in 3xTF32
// ---------------------------------------------------------------------------
namespace tf {
constexpr int THREADS = 256;
constexpr int BM = 128;                  // pooled pixels per block
constexpr int BN = 128;                  // output channels per block
constexpr int KC = 16;                   // input channels per stage
constexpr int STAGES = 3;
constexpr int RAW_A = 4 * BM * KC * 4;   // [window q][pooled p][KC] raw x
constexpr int RAW_B = KC * BN * 4;       // [KC][BN] raw W
constexpr int STAGE_BYTES = RAW_A + RAW_B + 2 * KC * 4;
constexpr int LDA = KC + 4;              // pooled-u plane row stride (80 B)
constexpr int LDB = BN + 8;              // W plane row stride (544 B)
constexpr int PA_BYTES = BM * LDA * 4;
constexpr int PB_BYTES = KC * LDB * 4;
constexpr int OP_BYTES = 2 * (PA_BYTES + PB_BYTES);   // hi and lo planes
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * OP_BYTES;
static_assert(SMEM_BYTES <= 232448, "over the H100's 227 KB per block");
static_assert(STAGE_BYTES % 16 == 0 && PA_BYTES % 16 == 0 &&
                  PB_BYTES % 16 == 0, "16 B alignment");
static_assert(STAGES >= 2, "one chunk transformed, one landing");

// VEC: x and W are copied VEC floats at a time, 4 where C % 8 == 0 (x and
// W rows both 16-byte multiples), else 1.
template <int VEC>
__global__ void __launch_bounds__(THREADS, 1)
transition_tf32(const float* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ bsh, const float* __restrict__ wt,
                float* __restrict__ out, int bsz, int h, int w, int c,
                int ldo) {
  constexpr int VPR = KC / VEC;                    // copies per x row
  constexpr int RSTEP = THREADS / VPR;             // rows between a thread's
  constexpr int NP = BM / RSTEP;                   // its pooled pixels
  constexpr int BPR = BN / VEC;                    // copies per W row
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ops = smem + STAGES * STAGE_BYTES;  // [buf][hi, lo] planes

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int ho = h / 2, wo = w / 2, n_out = c / 2;
  const int m_out = bsz * ho * wo;
  const int pbase = blockIdx.y * BM, nbase = blockIdx.x * BN;
  const int wm = warp >> 2, wn = warp & 3;         // 2 x 4 warps, 64 x 32 each
  const int nk = (c + KC - 1) / KC;

  // raw row q * BM + p holds window position q = 2 dy + dx of pooled pixel
  // p; this thread copies rows tid / VPR + RSTEP * i, i.e. pooled pixels
  // tid / VPR + RSTEP * j (j < NP) at every q
  const int lv = tid % VPR;
  long long src[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int pp = pbase + tid / VPR + RSTEP * j;
    src[j] = -1;
    if (pp < m_out) {
      const int bi = pp / (ho * wo), rem = pp % (ho * wo);
      src[j] = (((long long)bi * h + 2 * (rem / wo)) * w + 2 * (rem % wo)) * c;
    }
  }
  auto load = [&](int kc) {
    unsigned char* st = smem + (kc % STAGES) * STAGE_BYTES;
    float* ra = reinterpret_cast<float*>(st);
    float* rb = reinterpret_cast<float*>(st + RAW_A);
    float* f_s = reinterpret_cast<float*>(st + RAW_A + RAW_B);
    const int k0 = kc * KC, ch = k0 + lv * VEC;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long wq = ((long long)(q >> 1) * w + (q & 1)) * c;
#pragma unroll
      for (int j = 0; j < NP; ++j) {               // zero past m_out and C
        const bool ok = src[j] >= 0 && ch < c;
        cp_async_f32<VEC>(ra + (q * BM + tid / VPR + RSTEP * j) * KC + lv * VEC,
                          ok ? x + src[j] + wq + ch : x, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < KC * BPR / THREADS; ++i) {
      const int e = tid + i * THREADS, kk = e / BPR, n = nbase + (e % BPR) * VEC;
      const bool ok = k0 + kk < c && n < n_out;
      cp_async_f32<VEC>(rb + kk * BN + (e % BPR) * VEC,
                        ok ? wt + (size_t)(k0 + kk) * n_out + n : wt, ok);
    }
    if (tid < 2 * KC / VEC) {                      // a, b of the chunk
      const int k = (tid % (KC / VEC)) * VEC;
      const float* base = tid < KC / VEC ? a : bsh;
      cp_async_f32<VEC>(f_s + tid * VEC, k0 + k < c ? base + k0 + k : a,
                        k0 + k < c);
    }
  };

  // chunk kc's landed stage -> operand buffer kc & 1: s = 0.25 * the sum of
  // u = relu(a*x + b) over the window, in the plain version's order (each
  // u a separate f32 mul then add), and W, each split into TF32 hi and lo
  auto transform = [&](int kc) {
    const unsigned char* st = smem + (kc % STAGES) * STAGE_BYTES;
    const float* ra = reinterpret_cast<const float*>(st);
    const float* rb = reinterpret_cast<const float*>(st + RAW_A);
    const float* f_s = reinterpret_cast<const float*>(st + RAW_A + RAW_B);
    unsigned char* op = ops + (kc & 1) * OP_BYTES;
    uint32_t* pa_hi = reinterpret_cast<uint32_t*>(op);
    uint32_t* pa_lo = reinterpret_cast<uint32_t*>(op + PA_BYTES);
    uint32_t* pb_hi = reinterpret_cast<uint32_t*>(op + 2 * PA_BYTES);
    uint32_t* pb_lo = reinterpret_cast<uint32_t*>(op + 2 * PA_BYTES + PB_BYTES);
#pragma unroll
    for (int i = 0; i < BM * (KC / 4) / THREADS; ++i) {
      const int e = tid + i * THREADS, p = e / (KC / 4), v = (e % (KC / 4)) * 4;
      const float4 av = *reinterpret_cast<const float4*>(f_s + v);
      const float4 bv = *reinterpret_cast<const float4*>(f_s + KC + v);
      float4 u[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 r =
            *reinterpret_cast<const float4*>(ra + (q * BM + p) * KC + v);
        u[q].x = fmaxf(__fadd_rn(__fmul_rn(r.x, av.x), bv.x), 0.f);
        u[q].y = fmaxf(__fadd_rn(__fmul_rn(r.y, av.y), bv.y), 0.f);
        u[q].z = fmaxf(__fadd_rn(__fmul_rn(r.z, av.z), bv.z), 0.f);
        u[q].w = fmaxf(__fadd_rn(__fmul_rn(r.w, av.w), bv.w), 0.f);
      }
      const float4 s = make_float4(
          0.25f * (((u[0].x + u[1].x) + u[2].x) + u[3].x),
          0.25f * (((u[0].y + u[1].y) + u[2].y) + u[3].y),
          0.25f * (((u[0].z + u[1].z) + u[2].z) + u[3].z),
          0.25f * (((u[0].w + u[1].w) + u[2].w) + u[3].w));
      uint4 hi, lo;
      split4_tf32(s, hi, lo);
      *reinterpret_cast<uint4*>(pa_hi + p * LDA + v) = hi;
      *reinterpret_cast<uint4*>(pa_lo + p * LDA + v) = lo;
    }
#pragma unroll
    for (int i = 0; i < KC * (BN / 4) / THREADS; ++i) {
      const int e = tid + i * THREADS, kk = e / (BN / 4), n = (e % (BN / 4)) * 4;
      uint4 hi, lo;
      split4_tf32(*reinterpret_cast<const float4*>(rb + kk * BN + n), hi, lo);
      *reinterpret_cast<uint4*>(pb_hi + kk * LDB + n) = hi;
      *reinterpret_cast<uint4*>(pb_lo + kk * LDB + n) = lo;
    }
  };

  float acc[4][4][4];                              // [m16][n8][frag]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const bool active = nbase + wn * 32 < n_out;     // warp-uniform

  // One barrier per chunk: after it, chunk kc's operands are split into
  // buffer kc & 1, chunk kc+1 has landed, and chunk kc's raw stage takes
  // the copy of chunk kc+STAGES. Each warp then multiplies chunk kc and
  // makes chunk kc+1's operands (into the other buffer), so one warp's
  // transform overlaps another's MMAs.
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();
  __syncthreads();
  transform(0);
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kc + STAGES < nk) load(kc + STAGES);
    cp_async_commit();
    if (active) {
      const unsigned char* op = ops + (kc & 1) * OP_BYTES;
      const float* pa_hi = reinterpret_cast<const float*>(op);
      const float* pa_lo = reinterpret_cast<const float*>(op + PA_BYTES);
      const uint32_t* pb_hi =
          reinterpret_cast<const uint32_t*>(op + 2 * PA_BYTES);
      const uint32_t* pb_lo =
          reinterpret_cast<const uint32_t*>(op + 2 * PA_BYTES + PB_BYTES);
#pragma unroll
      for (int ks = 0; ks < KC / 8; ++ks) {
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          load_b_split(bh[j], bl[j], pb_hi, pb_lo, LDB, ks * 8,
                       wn * 32 + j * 8, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t ah[4], al[4];
          load_a_split(ah, al, pa_hi, pa_lo, LDA, wm * 64 + i * 16, ks * 8,
                       lane);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_3xtf32(acc[i][j], ah, al, bh[j], bl[j]);
        }
      }
    }
    if (kc + 1 < nk) transform(kc + 1);
  }
  if (!active) return;

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = pbase + wm * 64 + i * 16 + g + half * 8;
      if (p >= m_out) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = nbase + wn * 32 + j * 8 + c2;
        if (n < n_out) out[(size_t)p * ldo + n] = acc[i][j][half * 2];
        if (n + 1 < n_out) out[(size_t)p * ldo + n + 1] = acc[i][j][half * 2 + 1];
      }
    }
  }
}

template <int VEC>
int launch_vec(const float* x, const float* a, const float* b, const float* wt,
               float* out, int bsz, int h, int w, int c, int ldo,
               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      transition_tf32<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int m_out = bsz * (h / 2) * (w / 2);
  const dim3 grid((c / 2 + BN - 1) / BN, (m_out + BM - 1) / BM);
  transition_tf32<VEC><<<grid, THREADS, SMEM_BYTES, stream>>>(
      x, a, b, wt, out, bsz, h, w, c, ldo);
  return (int)cudaGetLastError();
}

int launch(const float* x, const float* a, const float* b, const float* wt,
           float* out, int bsz, int h, int w, int c, int ldo,
           cudaStream_t stream) {
  return c % 8 == 0
             ? launch_vec<4>(x, a, b, wt, out, bsz, h, w, c, ldo, stream)
             : launch_vec<1>(x, a, b, wt, out, bsz, h, w, c, ldo, stream);
}
}  // namespace tf

// Blocks of a kernel that fit one SM, and its shared memory bytes.
template <typename Kernel>
int occupancy(Kernel kernel, int threads, int smem, int* blocks,
              int* smem_bytes) {
  *smem_bytes = smem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                            threads, smem);
}

}  // namespace

extern "C" int transition_bf16_occupancy(int* blocks, int* smem_bytes) {
  return occupancy(tc::transition_tc, tc::THREADS, tc::SMEM_BYTES, blocks,
                   smem_bytes);
}

// the main path's instantiation (C % 8 == 0)
extern "C" int transition_f32_occupancy(int* blocks, int* smem_bytes) {
  return occupancy(tf::transition_tf32<4>, tf::THREADS, tf::SMEM_BYTES, blocks,
                   smem_bytes);
}

extern "C" int transition_f32(const float* x, const float* a, const float* b,
                              const float* wt, float* out, int bsz, int h,
                              int w, int c, int ldo, cudaStream_t stream) {
  if (c % 2 != 0 || ldo < c / 2) return (int)cudaErrorInvalidValue;
  return tf::launch(x, a, b, wt, out, bsz, h, w, c, ldo, stream);
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
