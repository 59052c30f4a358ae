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
// Bound on the H100 (per 128-patch chunk): 2*B*H*W*(128*k_in + 9*128*32)
// operations against the active prefix read once and one slot written.
// bf16: at H=64 the operations bound it (989 TF/s), at H=32 both are about
// even, at H=16 and H=8 the bytes bound it (3.35 TB/s). f32 (SimCLR's
// frozen backbone at B = 128): the operations at every H, at 3xTF32
// (495/3 TF/s: three TF32 products make one f32-accurate one).
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
// against 2.0 (128 rows for 64 outputs) in the first, CUDA-core design.
// Grid: H=64 16x128 = 2048 blocks, H=32 4x128 = 512, H=16 and H=8 128
// (under one wave of 132 SMs); 205,888 bytes of shared memory and 216
// registers a thread, so one block of 8 warps per SM.
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
// f32 design (SimCLR's frozen KimiaNet and `--extract`, B = 128),
// `dense_layer_tf32`: the tensor cores in 3xTF32 (common.cuh), each product
// lo*hi + hi*lo + hi*hi of TF32 parts rounded to nearest, so full-f32
// products at tensor-core rates. One block of 8 warps per 16x8 output tile
// (the whole image at H <= 8), 231,040 bytes of shared memory, one block
// per SM. The bf16 design's 18x18 halo of v would take 166 KB a plane in
// f32, so the tile is 16x8: the bottleneck on the in-image halo pixels is
//     H=8   whole image, 64 rows for 64 outputs        1.00 rows/output
//     H=16  16x8 tiles, 16x9 = 144 rows for 128         1.125
//     H=32  17 x 9.5 rows on average                    1.26
//     H=64  17.5 x 9.75 rows on average                 1.33
// against 2.0 in the CUDA-core design it replaces. Grid: H=64 32x128 =
// 4096 blocks, H=32 1024, H=16 256, H=8 128 (under one wave of 132 SMs).
//   GEMM 1 (K = k_in, N = 128): one pass of up to 192 rows, 4x2 warps,
//   each with three interleaved m16 tiles and 64 columns. x and W1f stream
//   in 16-channel chunks through a 4-stage ring of 16-byte cp.async copies
//   (4-byte copies where C_end % 4 != 0); once a chunk lands it is made
//   into u = relu(a1*x + b1) in place (the plain version's mul then add)
//   and its W1f into TF32 hi and lo planes; u is split as its fragments
//   load. One barrier per chunk; each warp multiplies chunk k and then
//   transforms chunk k+1.
//   Epilogue 1: v = relu(acc + b2), split once into hi and lo planes
//   [18x10 halo][132] (v_hi where v sat, v_lo where the stages were), 0
//   outside the image; so the 3x3 conv re-splits nothing of v.
//   GEMM 2 (K = 9 x 128, N = 32): W2cat streams by tap ([128][32] slices,
//   two slots after v_lo); two 64-row m-groups (one at <= 64 outputs) and
//   the warps of a group split each tap's channels four (or eight) ways;
//   each warp's B fragments are split as they load, and the partial sums
//   meet in shared memory before 16-byte stores.
// Measured (chip_smoke.py --f32-timing, NVIDIA H100 80GB HBM3, 700.00 W):
// 1.46 / 0.55 / 0.231 / 0.079 ms at H = 64 / 32 / 16 / 8, 0.38 ms over the
// 58 layers, 0.22 of the 3xTF32 bound (2.9x the CUDA-core design, 2.2x
// the plain cuBLAS/cuDNN f32 version). What holds it back: mma.sync's TF32
// rate on this card is 290-325 TF/s (chip_smoke.py --f32-timing), so
// 3xTF32 through it tops out near 0.63 of that bound; and with one block
// per SM the per-chunk barrier, the fragment loads and the splits do not
// all hide behind the MMAs (neither more GEMM-1 stages nor loading every
// fragment of a k step before its MMAs made it faster). Two blocks per SM
// or wgmma (about 1.6x mma.sync's TF32 rate, both operands from shared
// memory) are the next steps.
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
// f32: tensor cores in 3xTF32
// ---------------------------------------------------------------------------
namespace tf {
constexpr int THREADS = 256;
constexpr int TH = 16, TW = 8;           // largest output tile (rows x cols)
constexpr int HPIX = (TH + 2) * (TW + 2);  // its halo, 180 pixels
constexpr int LDV = MID + 4;             // v row stride (528 B: ldmatrix rows
                                         // 4 banks apart)
constexpr int KC = 16;                   // input channels per stage
constexpr int LDA = KC + 4;              // u row stride (80 B)
constexpr int LDB = MID + 8;             // W1f row stride (544 B)
constexpr int WM = 4, WN = 2;            // GEMM-1 warp grid
constexpr int MT = 3;                    // m16 tiles per warp
constexpr int NT = MID / WN / 8;         // n8 tiles per warp (8)
constexpr int PM = WM * MT * 16;         // GEMM-1 rows (192)
constexpr int STAGES = 4;
constexpr int LDW = GROWTH + 8;          // W2cat tap-slice row stride (160 B)
constexpr int RING = 2;                  // W2cat tap slices: one used, one landing
constexpr int LDY = GROWTH + 8;          // partial-sum row stride
constexpr int V_BYTES = HPIX * LDV * 4;  // one plane of v
constexpr int A_BYTES = PM * LDA * 4;
constexpr int B_BYTES = KC * LDB * 4;    // one plane of a W1f chunk
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES + 2 * KC * 4;
constexpr int TAP_BYTES = MID * LDW * 4;
// after v's hi plane: the GEMM-1 stages, then v's lo plane and the taps
constexpr int R_BYTES = STAGES * STAGE_BYTES > V_BYTES + RING * TAP_BYTES
                            ? STAGES * STAGE_BYTES
                            : V_BYTES + RING * TAP_BYTES;
constexpr int SMEM_BYTES = V_BYTES + R_BYTES;
static_assert(PM >= HPIX, "one GEMM-1 pass covers any clipped halo");
static_assert(4 * TH * TW * LDY * 4 <= V_BYTES, "partials must fit v's buffer");
static_assert(SMEM_BYTES <= 232448, "over the H100's 227 KB per block");
static_assert(V_BYTES % 16 == 0 && A_BYTES % 16 == 0 && B_BYTES % 16 == 0 &&
                  STAGE_BYTES % 16 == 0 && TAP_BYTES % 16 == 0,
              "16 B alignment");
static_assert(STAGES >= 3, "one chunk multiplied, one transformed, one landing");
static_assert(WM * WN * 32 == THREADS && MID % 32 == 0, "");

// VEC: x is copied and y stored VEC floats at a time, 4 where C_end % 4 == 0
// (16-byte rows), else 1.
template <int VEC>
__global__ void __launch_bounds__(THREADS, 1)
dense_layer_tf32(float* __restrict__ x, const float* __restrict__ a1,
                 const float* __restrict__ b1, const float* __restrict__ w1f,
                 const float* __restrict__ b2, const float* __restrict__ w2cat,
                 int h, int w, int c_end, int k_in, int th, int tw) {
  constexpr int VPR = KC / VEC;                    // copies per x row
  constexpr int RSTEP = THREADS / VPR;             // rows between a thread's
  constexpr int RPT = PM / RSTEP;                  // x copies per thread
  extern __shared__ __align__(128) unsigned char smem[];
  float* v_hi = reinterpret_cast<float*>(smem);    // [(th+2)*(tw+2)][LDV]
  unsigned char* pipe = smem + V_BYTES;            // stages; then v_lo, taps
  float* v_lo = reinterpret_cast<float*>(pipe);
  unsigned char* taps = pipe + V_BYTES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c2 = (lane & 3) * 2;    // mma fragment row, col
  const int tiles_w = (w + tw - 1) / tw;
  const int oy = (blockIdx.x / tiles_w) * th, ox = (blockIdx.x % tiles_w) * tw;
  const size_t img = (size_t)blockIdx.y * h * w;
  const int hw = tw + 2;                           // halo row length
  const int hpix = (th + 2) * hw;
  // the halo clipped to the image: GEMM 1's rows, row r = pixel
  // (hy0 + r / cw, hx0 + r % cw)
  const int hy0 = max(oy - 1, 0), hx0 = max(ox - 1, 0);
  const int cw = min(ox + tw + 1, w) - hx0;
  const int m1 = (min(oy + th + 1, h) - hy0) * cw;

  // v outside the image is 0 (SAME padding), not relu(b2)
  for (int e = tid; e < hpix * LDV / 4; e += THREADS)
    reinterpret_cast<float4*>(v_hi)[e] = make_float4(0.f, 0.f, 0.f, 0.f);

  // ---- GEMM 1: v = relu(u @ W1f + b2) on the clipped halo ----------------
  // warp (wm, wn) owns m-tiles wm, wm + 4, wm + 8 (interleaved, so a short
  // halo still spreads over all warps) and 64 of the 128 columns
  const int wm = warp % WM, wn = warp / WM;
  const int nk = k_in / KC;
  float b2r[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    b2r[j][0] = b2[wn * 64 + j * 8 + c2];
    b2r[j][1] = b2[wn * 64 + j * 8 + c2 + 1];
  }
  const int lv = tid % VPR;                        // this thread's x vector
  long long src[RPT];                              // its rows' offsets
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = tid / VPR + RSTEP * i;
    src[i] = -1;
    if (r < m1)
      src[i] = (long long)(img + (size_t)(hy0 + r / cw) * w + hx0 + r % cw) *
               c_end;
  }
  // stage: u [PM][LDA], W1f hi [KC][LDB] (landing raw), W1f lo, a1, b1
  auto load = [&](int kc) {
    unsigned char* st = pipe + (kc % STAGES) * STAGE_BYTES;
    float* a_s = reinterpret_cast<float*>(st);
    float* b_s = reinterpret_cast<float*>(st + A_BYTES);
    float* f_s = reinterpret_cast<float*>(st + A_BYTES + 2 * B_BYTES);
    const int k0 = kc * KC;
#pragma unroll
    for (int i = 0; i < RPT; ++i)                  // zero rows past m1
      cp_async_f32<VEC>(a_s + (tid / VPR + RSTEP * i) * LDA + lv * VEC,
                        src[i] >= 0 ? x + src[i] + k0 + lv * VEC : x,
                        src[i] >= 0);
#pragma unroll
    for (int i = 0; i < KC * (MID / 4) / THREADS; ++i) {
      const int e = tid + i * THREADS, kk = e / (MID / 4), vv = e % (MID / 4);
      cp_async16(b_s + kk * LDB + vv * 4, w1f + (size_t)(k0 + kk) * MID + vv * 4,
                 true);
    }
    if (tid < KC / 2)                              // a1, b1 of the chunk
      cp_async16(f_s + tid * 4,
                 tid < KC / 4 ? a1 + k0 + tid * 4 : b1 + k0 + tid * 4 - KC,
                 true);
  };

  // On chunk kc's landed stage: u = relu(a1*x + b1) in place, mul then add
  // as separate f32 operations, as the plain version computes it; the W1f
  // chunk split into TF32 hi (in place) and lo
  auto transform = [&](int kc) {
    unsigned char* st = pipe + (kc % STAGES) * STAGE_BYTES;
    float* a_s = reinterpret_cast<float*>(st);
    uint32_t* b_hi = reinterpret_cast<uint32_t*>(st + A_BYTES);
    uint32_t* b_lo = reinterpret_cast<uint32_t*>(st + A_BYTES + B_BYTES);
    const float* f_s =
        reinterpret_cast<const float*>(st + A_BYTES + 2 * B_BYTES);
    float av[VEC], bv[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      av[e] = f_s[lv * VEC + e];
      bv[e] = f_s[KC + lv * VEC + e];
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      if (src[i] < 0) continue;
      float* p = a_s + (tid / VPR + RSTEP * i) * LDA + lv * VEC;
      if constexpr (VEC == 4) {
        float4 u = *reinterpret_cast<float4*>(p);
        u.x = fmaxf(__fadd_rn(__fmul_rn(u.x, av[0]), bv[0]), 0.f);
        u.y = fmaxf(__fadd_rn(__fmul_rn(u.y, av[1]), bv[1]), 0.f);
        u.z = fmaxf(__fadd_rn(__fmul_rn(u.z, av[2]), bv[2]), 0.f);
        u.w = fmaxf(__fadd_rn(__fmul_rn(u.w, av[3]), bv[3]), 0.f);
        *reinterpret_cast<float4*>(p) = u;
      } else {
        *p = fmaxf(__fadd_rn(__fmul_rn(*p, av[0]), bv[0]), 0.f);
      }
    }
#pragma unroll
    for (int i = 0; i < KC * (MID / 4) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int o = (e / (MID / 4)) * LDB + (e % (MID / 4)) * 4;
      uint4 hi, lo;
      split4_tf32(*reinterpret_cast<const float4*>(b_hi + o), hi, lo);
      *reinterpret_cast<uint4*>(b_hi + o) = hi;
      *reinterpret_cast<uint4*>(b_lo + o) = lo;
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // One barrier per chunk: after it, chunk kc is transformed, chunk kc+1
  // has landed and chunk kc-1's stage is free. Each warp then multiplies
  // chunk kc and transforms chunk kc+1 (another stage), so one warp's
  // transform overlaps another's MMAs; chunks kc+2 .. kc+STAGES-1 are in
  // flight.
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

    unsigned char* st = pipe + (kc % STAGES) * STAGE_BYTES;
    const float* a_s = reinterpret_cast<const float*>(st);
    const uint32_t* b_hi = reinterpret_cast<const uint32_t*>(st + A_BYTES);
    const uint32_t* b_lo =
        reinterpret_cast<const uint32_t*>(st + A_BYTES + B_BYTES);
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        load_b_split(bh[j], bl[j], b_hi, b_lo, LDB, ks * 8, wn * 64 + j * 8,
                     lane);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int row = (i * WM + wm) * 16;
        if (row < m1) {                            // warp-uniform
          uint32_t ah[4], al[4];
          load_a_tf32(ah, al, a_s, LDA, row, ks * 8, lane);
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mma_3xtf32(acc[i][j], ah, al, bh[j], bl[j]);
        }
      }
    }
    if (kc + 1 < nk) transform(kc + 1);
  }
  __syncthreads();                                 // the stages are free

  // W2cat streams by tap, [128][32] slices, through RING slots after v_lo;
  // tap 0's copy overlaps epilogue 1
  auto load_tap = [&](int tap) {
    float* t_s = reinterpret_cast<float*>(taps + (tap % RING) * TAP_BYTES);
#pragma unroll
    for (int i = 0; i < MID * (GROWTH / 4) / THREADS; ++i) {
      const int e = tid + i * THREADS, k = e / (GROWTH / 4),
                vv = e % (GROWTH / 4);
      cp_async16(t_s + k * LDW + vv * 4,
                 w2cat + (size_t)k * 9 * GROWTH + tap * GROWTH + vv * 4, true);
    }
  };
  load_tap(0);
  cp_async_commit();

  // epilogue 1: v = relu(acc + b2) at the row's halo position, split into
  // TF32 hi and lo planes once here for all nine taps; v_lo is 0 outside
  // the image (those halo pixels are no GEMM-1 row)
  for (int e = tid; e < hpix * LDV / 4; e += THREADS) {
    const int px = e / (LDV / 4), hy = oy - 1 + px / hw, hx = ox - 1 + px % hw;
    if (hy < 0 || hy >= h || hx < 0 || hx >= w)
      reinterpret_cast<float4*>(v_lo)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = (i * WM + wm) * 16 + g + half * 8;
      if (r >= m1) continue;
      const int hp = (hy0 + r / cw - oy + 1) * hw + hx0 + r % cw - ox + 1;
      const int o = hp * LDV + wn * 64 + c2;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint2 hi, lo;
        split_tf32(fmaxf(acc[i][j][half * 2] + b2r[j][0], 0.f), hi.x, lo.x);
        split_tf32(fmaxf(acc[i][j][half * 2 + 1] + b2r[j][1], 0.f), hi.y,
                   lo.y);
        *reinterpret_cast<uint2*>(v_hi + o + j * 8) = hi;
        *reinterpret_cast<uint2*>(v_lo + o + j * 8) = lo;
      }
    }
  }

  // ---- GEMM 2: y = conv3x3(v), 9 taps x K 128, N 32 ----------------------
  // 64-row m-groups (two for a 128-pixel tile, one for 64 or fewer) and
  // the warps of a group split each tap's 128 channels (K split 4 or 8);
  // the partial sums meet in shared memory
  const int m2 = th * tw;
  const int n_mg = m2 > 64 ? 2 : 1, n_kg = 8 / n_mg;
  const int mg = warp % n_mg, kg = warp / n_mg;
  const int ck = MID / n_kg;                       // channels per tap per warp
  float acc2[4][4][4];
  int hrow[4];                                     // this lane's halo row
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int m = (mg * 4 + i) * 16 + (lane & 15);
    if (m >= m2) m = 0;                            // padding row, discarded
    hrow[i] = (m / tw) * hw + m % tw;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[i][j][e] = 0.f;
  }
  for (int tap = 0; tap < 9; ++tap) {
    cp_async_wait<0>();
    __syncthreads();                               // v, tap's slice ready
    if (tap + 1 < 9) load_tap(tap + 1);            // into tap-1's slot
    cp_async_commit();
    const float* t_s =
        reinterpret_cast<const float*>(taps + (tap % RING) * TAP_BYTES);
    const int shift = ((tap / 3) * hw + tap % 3) * LDV;
    for (int k0 = kg * ck; k0 < kg * ck + ck; k0 += 8) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        load_b_tf32(bh[j], bl[j], t_s, LDW, k0, j * 8, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if ((mg * 4 + i) * 16 >= m2) break;        // warp-uniform
        const int o = shift + hrow[i] * LDV + k0 + (lane >> 4) * 4;
        uint32_t ah[4], al[4];
        ldsm_x4(ah, v_hi + o);
        ldsm_x4(al, v_lo + o);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_3xtf32(acc2[i][j], ah, al, bh[j], bl[j]);
      }
    }
  }
  __syncthreads();                                 // partials reuse v_hi

  float* y_s = v_hi;                               // [n_kg][m2][LDY]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = (mg * 4 + i) * 16 + g + half * 8;
      if (m >= m2) continue;
      float* dst = y_s + (kg * m2 + m) * LDY + c2;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float2*>(dst + j * 8) =
            make_float2(acc2[i][j][half * 2], acc2[i][j][half * 2 + 1]);
    }
  }
  __syncthreads();
  for (int e = tid; e < m2 * (GROWTH / VEC); e += THREADS) {
    const int m = e / (GROWTH / VEC), vv = e % (GROWTH / VEC);
    const int gy = oy + m / tw, gx = ox + m % tw;
    if (gy >= h || gx >= w) continue;
    float* out = x + (img + (size_t)gy * w + gx) * c_end + k_in + vv * VEC;
    if constexpr (VEC == 4) {
      float4 y = *reinterpret_cast<const float4*>(y_s + m * LDY + vv * 4);
      for (int k = 1; k < n_kg; ++k) {
        const float4 p =
            *reinterpret_cast<const float4*>(y_s + (k * m2 + m) * LDY + vv * 4);
        y.x += p.x; y.y += p.y; y.z += p.z; y.w += p.w;
      }
      *reinterpret_cast<float4*>(out) = y;
    } else {
      float y = y_s[m * LDY + vv];
      for (int k = 1; k < n_kg; ++k) y += y_s[(k * m2 + m) * LDY + vv];
      *out = y;
    }
  }
}

template <int VEC>
int launch_vec(float* x, const float* a1, const float* b1, const float* w1f,
               const float* b2, const float* w2cat, int bsz, int h, int w,
               int c_end, int k_in, cudaStream_t stream) {
  const int th = h < TH ? h : TH, tw = w < TW ? w : TW;
  cudaError_t err = cudaFuncSetAttribute(
      dense_layer_tf32<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((h + th - 1) / th) * ((w + tw - 1) / tw), bsz);
  dense_layer_tf32<VEC><<<grid, THREADS, SMEM_BYTES, stream>>>(
      x, a1, b1, w1f, b2, w2cat, h, w, c_end, k_in, th, tw);
  return (int)cudaGetLastError();
}

int launch(float* x, const float* a1, const float* b1, const float* w1f,
           const float* b2, const float* w2cat, int bsz, int h, int w,
           int c_end, int k_in, cudaStream_t stream) {
  return c_end % 4 == 0
             ? launch_vec<4>(x, a1, b1, w1f, b2, w2cat, bsz, h, w, c_end, k_in,
                             stream)
             : launch_vec<1>(x, a1, b1, w1f, b2, w2cat, bsz, h, w, c_end, k_in,
                             stream);
}
}  // namespace tf

bool bad_slot(int c_end, int k_in, int slot) {
  return k_in % 32 != 0 || k_in <= 0 || slot * GROWTH != k_in ||
         k_in + GROWTH > c_end;
}

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

extern "C" int dense_layer_bf16_occupancy(int* blocks, int* smem_bytes) {
  return occupancy(tc::dense_layer_tc, tc::THREADS, tc::SMEM_BYTES, blocks,
                   smem_bytes);
}

// the main path's instantiation (C_end % 4 == 0)
extern "C" int dense_layer_f32_occupancy(int* blocks, int* smem_bytes) {
  return occupancy(tf::dense_layer_tf32<4>, tf::THREADS, tf::SMEM_BYTES,
                   blocks, smem_bytes);
}

extern "C" int dense_layer_f32(float* x, const float* a1, const float* b1,
                               const float* w1f, const float* b2,
                               const float* w2cat, int bsz, int h, int w,
                               int c_end, int k_in, int slot,
                               cudaStream_t stream) {
  if (bad_slot(c_end, k_in, slot)) return (int)cudaErrorInvalidValue;
  return tf::launch(x, a1, b1, w1f, b2, w2cat, bsz, h, w, c_end, k_in, stream);
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
