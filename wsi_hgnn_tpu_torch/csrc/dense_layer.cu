// One DenseNet-121 dense layer, written in place into its 32-channel slot.
//
// Replaces wsi_hgnn_tpu/ops/pallas_densenet.py::dense_layer_fused (Pallas
// body `_kernel`). Same function, on one NHWC block buffer x [B,H,W,C_end]
// whose first k_in = slot*32 channels are written:
//     u = relu(a1*x + b1)          (norm1 folded; u rounded to the storage type)
//     v = relu(u @ W1f + b2)       (conv1 1x1 with norm2 folded; v rounded too)
//     y = conv3x3_same(v, W2cat)   (W2cat [128, 9*32], tap = 3*di + dj)
//     x[..., slot*32 : slot*32+32] = y
// Every product accumulates in f32. Blocks read channels [0, k_in) and
// write [k_in, k_in+32), so the in-place write never races a read. The
// Pallas kernel's 128-lane group splicing is a TPU layout rule and has no
// counterpart here.
//
// Bound on the H100 (bf16, per 128-patch chunk): 2*B*H*W*(128*k_in +
// 9*128*32) operations against the active prefix read once and one slot
// written. At H=64 the operations bound it (989 TF/s), at H=32 both are
// about even, at H=16 and H=8 the bytes bound it (3.35 TB/s).
//
// bf16 design (the main path), `dense_layer_tc`: one block of 8 warps per
// output tile, on the tensor cores through
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 fed by ldmatrix
// (common.cuh says why mma.sync rather than wgmma). The tile is the whole
// image at H <= 16 and 16x16 above. The bottleneck is computed once per
// halo pixel that lies inside the image (SAME padding makes v = 0 outside,
// so those rows are never computed), padded to the MMA's 16 rows:
//     H=8   whole image, 64 rows for 64 outputs       1.00 rows/output
//     H=16  whole image, 256 rows for 256 outputs     1.00
//     H=32  16x16 tiles, 17x17 halo = 289 -> 304 rows 1.19
//     H=64  16x16 tiles, 304 / 320 / 336 rows at corner / edge / interior
//           tiles, 1.25 on average (at most 1.31)
// against 2.0 (128 rows for 64 outputs) in the f32 design below. Grid:
// H=64 16x128 = 2048 blocks, H=32 4x128 = 512, H=16 and H=8 128 (under one
// wave of 132 SMs); 205,888 bytes of shared memory and 216 registers a
// thread, so one block of 8 warps per SM.
//   GEMM 1 (1x1 conv, K = k_in, N = 128): passes of up to 256 halo rows
//   (one pass at H <= 16, two at H=32 and 64), 4x2 warps, each with four
//   interleaved m16 tiles and 64 columns, so a short pass still spreads
//   over every warp. The x prefix and W1f stream in 32-channel chunks
//   (k_in is a multiple of 32, so no chunk is ragged) through a 4-stage
//   ring of 16-byte cp.async copies. u is made in shared memory once a
//   chunk lands, with the plain version's f32 mul-then-add, so it is
//   bit-equal to it. One barrier per chunk: chunk k+1's u is made while
//   chunk k is multiplied, and chunk k+3 is in flight.
//   Epilogue 1: v = bf16(relu(acc + b2)) into a [18x18 halo][136] buffer
//   whose ring outside the image stays 0. Row strides of 272 bytes keep
//   ldmatrix free of bank conflicts.
//   GEMM 2 (3x3 conv as an implicit GEMM, K = 9 x 128, N = 32): W2cat is
//   staged once per block (its copy overlaps epilogue 1); each warp owns
//   one or two 16-pixel m-tiles and walks the 9 taps, the per-lane
//   ldmatrix row addresses doing the (di, dj) shift into the halo.
//   y goes through shared memory and out in 16-byte stores.
// Suspects for what holds it back (chip_smoke.py's per-shape lines give
// the shares; the SM's pipes were not profiled): one block per
// SM serialises the phases (zeroing, GEMM 1, W2cat copy, GEMM 2); with
// N = 32 each A fragment of GEMM 2 feeds only four MMAs, so ldmatrix
// traffic rather than the tensor cores may set its pace; at H <= 16 every
// block streams all of W1f from L2 for few rows. wgmma with B read from
// shared memory by the tensor cores, and a persistent block that keeps
// W2cat resident, are the next steps.
//
// f32 design (exact-semantics checks only, not on the main path),
// `dense_layer_f32_kernel`: the CUDA cores. One block of 256 threads per
// 8x8 output tile recomputes the bottleneck on the 10x10 halo (128 padded
// rows) with an 8x8 register tile per thread, staging 32-channel chunks
// of u and W1f in shared memory, then walks the 9 taps of W2cat, each
// thread summing 8 output channels of one pixel.
#include "common.cuh"

namespace {
using namespace wsi;

constexpr int GROWTH = 32;
constexpr int MID = 128;                 // bottleneck width (bn_size * growth)

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
namespace tc {
using bf16 = __nv_bfloat16;
constexpr int THREADS = 256;
constexpr int TMAX = 16;                 // largest output tile side
constexpr int HMAX = TMAX + 2;           // its halo side
constexpr int LDV = MID + 8;             // v row stride (272 B)
constexpr int KC = 32;                   // input channels per stage
constexpr int LDA = KC + 8;              // u row stride (80 B)
constexpr int LDB = MID + 8;             // W1f row stride (272 B)
constexpr int WM = 4, WN = 2;            // GEMM-1 warp grid
constexpr int MT = 4;                    // m16 tiles per warp per pass
constexpr int NT = MID / WN / 8;         // n8 tiles per warp (8)
constexpr int PM = WM * MT * 16;         // halo rows per GEMM-1 pass (256)
constexpr int RPT = PM * (KC / 8) / THREADS;  // x rows each thread copies
constexpr int STAGES = 4;
constexpr int LDW2 = 9 * GROWTH + 8;     // W2cat row stride (592 B)
constexpr int LDY = GROWTH + 8;          // y row stride (80 B)
constexpr int V_BYTES = HMAX * HMAX * LDV * 2;
constexpr int A_BYTES = PM * LDA * 2;
constexpr int B_BYTES = KC * LDB * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES + 2 * KC * 4;
constexpr int W2_BYTES = MID * LDW2 * 2;
constexpr int PIPE_BYTES =
    STAGES * STAGE_BYTES > W2_BYTES ? STAGES * STAGE_BYTES : W2_BYTES;
constexpr int SMEM_BYTES = V_BYTES + PIPE_BYTES;
static_assert(TMAX * TMAX * LDY * 2 <= V_BYTES, "y must fit the v buffer");
static_assert(SMEM_BYTES <= 232448, "over the H100's 227 KB per block");
static_assert(V_BYTES % 16 == 0 && STAGE_BYTES % 16 == 0, "16 B alignment");
static_assert(STAGES >= 3, "one chunk multiplied, one transformed, one landing");
static_assert(WM * WN * 32 == THREADS && RPT * THREADS == PM * KC / 8, "");

__global__ void __launch_bounds__(THREADS, 1)
dense_layer_tc(bf16* __restrict__ x, const float* __restrict__ a1,
               const float* __restrict__ b1, const bf16* __restrict__ w1f,
               const float* __restrict__ b2, const bf16* __restrict__ w2cat,
               int h, int w, int c_end, int k_in, int th, int tw) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* v_s = reinterpret_cast<bf16*>(smem);       // [(th+2)*(tw+2)][LDV]
  unsigned char* pipe = smem + V_BYTES;            // stages, then W2cat

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c2 = (lane & 3) * 2;    // mma fragment row, col
  const int tiles_w = (w + tw - 1) / tw;
  const int oy = (blockIdx.x / tiles_w) * th, ox = (blockIdx.x % tiles_w) * tw;
  const size_t img = (size_t)blockIdx.y * h * w;
  const int hw = tw + 2;                           // halo row length
  // the halo clipped to the image: GEMM 1's rows, row r = pixel
  // (hy0 + r / cw, hx0 + r % cw)
  const int hy0 = max(oy - 1, 0), hx0 = max(ox - 1, 0);
  const int cw = min(ox + tw + 1, w) - hx0;
  const int m1 = (min(oy + th + 1, h) - hy0) * cw;

  // v outside the image is 0 (SAME padding), not relu(b2)
  for (int e = tid; e < (th + 2) * hw * LDV / 8; e += THREADS)
    reinterpret_cast<uint4*>(v_s)[e] = make_uint4(0, 0, 0, 0);

  // ---- GEMM 1: v = relu(u @ W1f + b2) on the clipped halo ----------------
  // warp (wm, wn) owns m-tiles wm, wm + 4, ... of a pass (interleaved, so a
  // short pass still spreads over all warps) and 64 of the 128 columns
  const int wm = warp % WM, wn = warp / WM;
  const int nk = k_in / KC;
  float b2r[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    b2r[j][0] = b2[wn * 64 + j * 8 + c2];
    b2r[j][1] = b2[wn * 64 + j * 8 + c2 + 1];
  }
  const int lv = tid & 3;                          // this thread's x vector

  for (int r0 = 0; r0 < m1; r0 += PM) {
    // this thread copies rows (tid >> 2) + 64 i of the pass: their offsets
    long long src[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = r0 + (tid >> 2) + 64 * i;
      src[i] = -1;
      if (r < m1)
        src[i] = (long long)(img + (size_t)(hy0 + r / cw) * w + hx0 + r % cw) *
                 c_end;
    }
    auto load = [&](int kc) {
      unsigned char* st = pipe + (kc % STAGES) * STAGE_BYTES;
      bf16* a_s = reinterpret_cast<bf16*>(st);
      bf16* b_s = reinterpret_cast<bf16*>(st + A_BYTES);
      float* f_s = reinterpret_cast<float*>(st + A_BYTES + B_BYTES);
      const int k0 = kc * KC;
#pragma unroll
      for (int i = 0; i < RPT; ++i)                // zero rows past m1
        cp_async16(a_s + ((tid >> 2) + 64 * i) * LDA + lv * 8,
                   src[i] >= 0 ? x + src[i] + k0 + lv * 8 : x, src[i] >= 0);
#pragma unroll
      for (int i = 0; i < KC * (MID / 8) / THREADS; ++i) {
        const int e = tid + i * THREADS, kk = e >> 4, vv = e & 15;
        cp_async16(b_s + kk * LDB + vv * 8, w1f + (size_t)(k0 + kk) * MID + vv * 8,
                   true);
      }
      if (tid < KC / 2)                            // a1, b1 of the chunk
        cp_async16(f_s + tid * 4,
                   (tid < KC / 4 ? a1 + k0 + tid * 4 : b1 + k0 + tid * 4 - KC),
                   true);
    };

    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    // u = relu(a1*x + b1) in place on chunk kc's landed stage
    auto transform = [&](int kc) {
      unsigned char* st = pipe + (kc % STAGES) * STAGE_BYTES;
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

    // One barrier per chunk: after it, chunk kc is transformed, chunk kc+1
    // has landed and chunk kc-1's stage is free. Chunk kc+1's transform then
    // overlaps chunk kc's MMAs (other stages), and the copy of chunk
    // kc+STAGES-1 goes into kc-1's stage.
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

      unsigned char* st = pipe + (kc % STAGES) * STAGE_BYTES;
      const bf16* a_s = reinterpret_cast<const bf16*>(st);
      const bf16* b_s = reinterpret_cast<const bf16*>(st + A_BYTES);
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        uint32_t bf[NT / 2][4];
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj)
          load_b(bf[jj], b_s, LDB, ks * 16, wn * 64 + jj * 16, lane);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int row = (i * WM + wm) * 16;
          if (r0 + row < m1) {                     // warp-uniform
            uint32_t a[4];
            load_a(a, a_s, LDA, row, ks * 16, lane);
#pragma unroll
            for (int j = 0; j < NT; ++j)
              mma_bf16(acc[i][j], a, bf[j >> 1][(j & 1) * 2],
                       bf[j >> 1][(j & 1) * 2 + 1]);
          }
        }
      }
    }
    __syncthreads();                               // the stages are free

    if (r0 + PM >= m1) {                           // last pass: stage W2cat
      bf16* w2_s = reinterpret_cast<bf16*>(pipe);
      for (int e = tid; e < MID * (9 * GROWTH / 8); e += THREADS) {
        const int k = e / (9 * GROWTH / 8), vv = e % (9 * GROWTH / 8);
        cp_async16(w2_s + k * LDW2 + vv * 8, w2cat + k * 9 * GROWTH + vv * 8,
                   true);
      }
      cp_async_commit();
    }

    // epilogue 1: v = bf16(relu(acc + b2)) at the row's halo position
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + (i * WM + wm) * 16 + g + half * 8;
        if (r >= m1) continue;
        const int hp = (hy0 + r / cw - oy + 1) * hw + hx0 + r % cw - ox + 1;
        bf16* dst = v_s + hp * LDV + wn * 64 + c2;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          *reinterpret_cast<uint32_t*>(dst + j * 8) =
              pack_bf16(fmaxf(acc[i][j][half * 2] + b2r[j][0], 0.f),
                        fmaxf(acc[i][j][half * 2 + 1] + b2r[j][1], 0.f));
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                                 // v and W2cat are ready

  // ---- GEMM 2: y = conv3x3(v), 9 taps x K 128, N 32 ----------------------
  const bf16* w2_s = reinterpret_cast<const bf16*>(pipe);
  const int m2 = th * tw, m2_tiles = (m2 + 15) / 16;
  float acc2[2][4][4];
  int hrow[2];                                     // this lane's halo row
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    int m = (warp + 8 * t) * 16 + (lane & 15);
    if (m >= m2) m = 0;                            // padding row, discarded
    hrow[t] = (m / tw) * hw + m % tw;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[t][j][e] = 0.f;
  }
  const bool has1 = warp + 8 < m2_tiles;
  if (warp < m2_tiles) {
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * hw + tap % 3;
#pragma unroll
      for (int ks = 0; ks < MID / 16; ++ks) {
        uint32_t bf[2][4];
        load_b(bf[0], w2_s, LDW2, ks * 16, tap * GROWTH, lane);
        load_b(bf[1], w2_s, LDW2, ks * 16, tap * GROWTH + 16, lane);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          if (t == 1 && !has1) break;
          uint32_t a[4];
          ldsm_x4(a, v_s + (hrow[t] + shift) * LDV + ks * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(acc2[t][j], a, bf[j >> 1][(j & 1) * 2],
                     bf[j >> 1][(j & 1) * 2 + 1]);
        }
      }
    }
  }
  __syncthreads();                                 // y reuses v's buffer

  bf16* y_s = v_s;                                 // [m2][LDY]
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    if (warp + 8 * t >= m2_tiles) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = (warp + 8 * t) * 16 + g + half * 8;
      if (m >= m2) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(y_s + m * LDY + j * 8 + c2) =
            pack_bf16(acc2[t][j][half * 2], acc2[t][j][half * 2 + 1]);
    }
  }
  __syncthreads();
  for (int e = tid; e < m2 * (GROWTH / 8); e += THREADS) {
    const int m = e >> 2, vv = e & 3;
    const int gy = oy + m / tw, gx = ox + m % tw;
    if (gy < h && gx < w)
      *reinterpret_cast<uint4*>(x + (img + (size_t)gy * w + gx) * c_end + k_in +
                                vv * 8) =
          *reinterpret_cast<const uint4*>(y_s + m * LDY + vv * 8);
  }
}

int launch(bf16* x, const float* a1, const float* b1, const bf16* w1f,
           const float* b2, const bf16* w2cat, int bsz, int h, int w,
           int c_end, int k_in, cudaStream_t stream) {
  if (c_end % 8 != 0) return (int)cudaErrorInvalidValue;
  const int th = h <= TMAX ? h : TMAX, tw = w <= TMAX ? w : TMAX;
  cudaError_t err = cudaFuncSetAttribute(
      dense_layer_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((h + th - 1) / th) * ((w + tw - 1) / tw), bsz);
  dense_layer_tc<<<grid, THREADS, SMEM_BYTES, stream>>>(
      x, a1, b1, w1f, b2, w2cat, h, w, c_end, k_in, th, tw);
  return (int)cudaGetLastError();
}
}  // namespace tc

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------
namespace cc {
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

__global__ void __launch_bounds__(THREADS)
dense_layer_f32_kernel(float* __restrict__ x, const float* __restrict__ a1,
                       const float* __restrict__ b1,
                       const float* __restrict__ w1f,
                       const float* __restrict__ b2,
                       const float* __restrict__ w2cat, int h, int w,
                       int c_end, int k_in, int slot) {
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
          const float xv = x[(img + (size_t)hy * w + hx) * c_end + c];
          // mul then add, unfused, as the plain version computes it
          u = fmaxf(__fadd_rn(__fmul_rn(xv, a1[c]), b1[c]), 0.f);
        }
      }
      u_s[kk * LDU + p] = u;
    }
    for (int e = tid; e < KC * MID; e += THREADS)
      w_s[e] = w1f[(size_t)k0 * MID + e];
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
            inside ? fmaxf(acc[i][j] + b2[col], 0.f) : 0.f;
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
      w2_s[e] = w2cat[ci * (9 * GROWTH) + t * GROWTH + o];
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
    float* out = x + (img + (size_t)gy * w + gx) * c_end + slot * GROWTH + og;
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = y[j];
  }
}

int launch(float* x, const float* a1, const float* b1, const float* w1f,
           const float* b2, const float* w2cat, int bsz, int h, int w,
           int c_end, int k_in, int slot, cudaStream_t stream) {
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dense_layer_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((h + TILE - 1) / TILE) * ((w + TILE - 1) / TILE), bsz);
  dense_layer_f32_kernel<<<grid, THREADS, smem, stream>>>(
      x, a1, b1, w1f, b2, w2cat, h, w, c_end, k_in, slot);
  return (int)cudaGetLastError();
}
}  // namespace cc

bool bad_slot(int c_end, int k_in, int slot) {
  return k_in % 32 != 0 || k_in <= 0 || slot * GROWTH != k_in ||
         k_in + GROWTH > c_end;
}

}  // namespace

// Blocks of the bf16 kernel that fit one SM, and its shared memory bytes.
extern "C" int dense_layer_bf16_occupancy(int* blocks, int* smem_bytes) {
  *smem_bytes = tc::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      tc::dense_layer_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, tc::dense_layer_tc, tc::THREADS, tc::SMEM_BYTES);
}

extern "C" int dense_layer_f32(float* x, const float* a1, const float* b1,
                               const float* w1f, const float* b2,
                               const float* w2cat, int bsz, int h, int w,
                               int c_end, int k_in, int slot,
                               cudaStream_t stream) {
  if (bad_slot(c_end, k_in, slot)) return (int)cudaErrorInvalidValue;
  return cc::launch(x, a1, b1, w1f, b2, w2cat, bsz, h, w, c_end, k_in, slot,
                    stream);
}

extern "C" int dense_layer_bf16(void* x, const float* a1, const float* b1,
                                const void* w1f, const float* b2,
                                const void* w2cat, int bsz, int h, int w,
                                int c_end, int k_in, int slot,
                                cudaStream_t stream) {
  if (bad_slot(c_end, k_in, slot)) return (int)cudaErrorInvalidValue;
  return tc::launch(static_cast<__nv_bfloat16*>(x), a1, b1,
                    static_cast<const __nv_bfloat16*>(w1f), b2,
                    static_cast<const __nv_bfloat16*>(w2cat), bsz, h, w,
                    c_end, k_in, stream);
}
