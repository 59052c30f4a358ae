// Exact L2 k-nearest neighbours of one slide, f32 on the CUDA cores.
//
// Replaces wsi_hgnn_tpu/ops/pallas_knn.py::knn_l2_pallas (Pallas body
// `_kernel`). Same function: d2 = (|q|^2 + |c|^2) - 2 q.c in f32, clamped
// at 0; self and masked candidates get FLT_MAX (the value the exact XLA
// path ops/knn.py::knn_l2 uses); the k smallest per query, ascending, ties
// to the lower candidate index; with fewer live candidates than k the
// FLT_MAX entries fill the rest in index order.
//
// What bounds it on the H100: the f32 operations of the symmetric Gram
// matrix x.x^T, N*(N+1)*D of them (its upper triangle, diagonal = the row
// norms; 4.3 GFLOP at N=2048, D=1024), against 67 TFLOP/s of f32 FMA,
// about 0.064 ms; the bytes (N*D read once) take a few microseconds. So it
// is an f32 GEMM with a top-k epilogue, and the design is about keeping all
// 132 SMs issuing FMAs. This design computes every pair twice (once per
// query row), so it can reach at most half of that bound; a symmetric
// design (tile pairs j >= i, each merged into both row sets) would not.
// Distances stay in f32 FMA on purpose: TF32 or bf16 tensor cores would
// move distances by more than the gaps between neighbours and change
// neighbour sets against the JAX package.
//
// Design, three launches on the caller's stream:
// 1. `knn_l2_row_norms`: |x|^2 of every row once per call, one warp per
//    row.
// 2. `knn_l2_split_kernel`: the grid is (query tile of 128) x (candidate
//    split). A split is a contiguous, index-ordered range of 128-candidate
//    tiles; `knn_l2_splits` picks as many splits as fill one wave of
//    resident blocks, so a 2048-patch slide still occupies every SM.
//    Mainloop: 8 features per step, staged through registers (one float4
//    of the query tile and one of the candidate tile per thread) into
//    double-buffered k-major shared tiles, one barrier per step; each of
//    the 256 threads keeps an 8x8 register tile of dot products (rows
//    ty*4+{0..3} and 64+ty*4+{0..3}, columns likewise from tx), fed by four
//    float4 shared reads per feature, double-buffered in registers. The
//    global loads read clamped, always valid addresses and are masked only
//    when stored, so no step waits on them. (Row-major tiles read with
//    eight float4 loads per four features stayed far below the f32 peak
//    on the H100 whatever the occupancy; this k-major form is the classic
//    SIMT SGEMM layout.)
//    Top-k epilogue after each candidate tile: the 128x128 distances go to
//    shared memory, so the register tile is free, and each half-warp takes
//    its 8 rows one by one (`merge_tile`, out of line, so the mainloop keeps
//    its registers): its 16 lanes read the row (8 values each) and
//    keep the candidates below the row's current k-th entry (on a split's
//    first tile, with k <= 16, below the k-th smallest of the 16 lane
//    minima, which bounds it). The survivors are compacted into a batch
//    (the operand ring, idle between the tile's two barriers) and every
//    list or batch entry moves to its rank in their union: a binary search
//    in the sorted list plus a count over the batch. A half-warp owns its
//    rows, so the merge itself needs no block barrier and all warps run it;
//    two barriers per tile bracket the ring's use as the batch.
// 3. `knn_l2_merge_kernel` (more than one split only): one warp per query
//    ranks the union of its split lists and writes the k smallest.
// Every comparison (filter, rank, merge) is on (d2, index) pairs, so equal
// distances keep the lower index first whatever order threads and splits
// arrive in, as lax.top_k does. Ragged N and D are masked in the kernel;
// the wrapper pads D to a multiple of 4 with zero columns, which changes no
// distance.
#include <cfloat>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 128;          // queries per block
constexpr int BC = 128;          // candidates per tile
constexpr int DC = 8;            // features per pipeline step
constexpr int LDT = BQ + 4;      // k-major operand row stride (BQ == BC)
constexpr int LDD = BC + 4;      // distance tile row stride
constexpr int THREADS = 256;     // 16 x 16 threads, 8x8 pairs each
constexpr int KMAX = 32;         // largest k the kernel keeps
constexpr int MAX_SPLITS = 16;
constexpr int HALF_WARPS = THREADS / 16;
constexpr unsigned FULL = 0xffffffffu;

static_assert(BQ == BC, "one operand row stride serves both tiles");
static_assert(HALF_WARPS * BC <= 2 * DC * LDT,
              "a half-warp's batch (a whole row) fits in one operand ring");

// dynamic shared memory: the distance tile, then the lists (odd row stride)
__host__ __device__ constexpr int list_stride(int k) { return k | 1; }
constexpr int smem_bytes(int k) {
  return BQ * LDD * 4 + BQ * list_stride(k) * 8;
}

__device__ __forceinline__ bool lex_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// row (query) of accumulator row i, column (candidate) of column j
__device__ __forceinline__ int row_of(int ty, int i) {
  return (i < 4 ? 0 : BQ / 2) + ty * 4 + (i & 3);
}
__device__ __forceinline__ int col_of(int tx, int j) {
  return (j < 4 ? 0 : BC / 2) + tx * 4 + (j & 3);
}

__global__ void __launch_bounds__(256)
knn_l2_row_norms(const float* __restrict__ x, int n, int d,
                 float* __restrict__ sq) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= n) return;
  const float4* p = reinterpret_cast<const float4*>(x + (size_t)row * d);
  float s = 0.f;
  for (int c = lane; c < d / 4; c += 32) {
    const float4 v = __ldg(p + c);
    s = fmaf(v.x, v.x, s);
    s = fmaf(v.y, v.y, s);
    s = fmaf(v.z, v.z, s);
    s = fmaf(v.w, v.w, s);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  if (lane == 0) sq[row] = s;
}

// Merge one row of the finished tile into the row's sorted list (ld, li).
// The 16 lanes of the half-warp (lane l) read the row's distances at
// columns col_of(l, j); NaN marks no candidate. `first`: the split's first
// tile, whose list is still empty.
__device__ __forceinline__ void merge_row(const float* dist_row, float* ld,
                                          int* li, float* bat_d, int* bat_i,
                                          int cbase, int l, int gshift, int k,
                                          bool first) {
  const float4 v0 = *reinterpret_cast<const float4*>(dist_row + l * 4);
  const float4 v1 = *reinterpret_cast<const float4*>(dist_row + BC / 2 + l * 4);
  const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
  const float kd = ld[k - 1];
  const int ki = li[k - 1];
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (lex_less(v[j], cbase + col_of(l, j), kd, ki)) m |= 1u << j;

  if (first && k <= 16) {
    // bound the k-th entry by the k-th smallest of the 16 lane minima (k
    // candidates lie at or below it), sorted across the lanes by a bitonic
    // network of shuffles; keep the candidates at or below it
    float bd = INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if ((m >> j & 1u) && lex_less(v[j], cbase + col_of(l, j), bd, bi)) {
        bd = v[j];
        bi = cbase + col_of(l, j);
      }
#pragma unroll
    for (int size = 2; size <= 16; size <<= 1)
#pragma unroll
      for (int stride = size / 2; stride > 0; stride >>= 1) {
        const float od = __shfl_xor_sync(FULL, bd, stride);
        const int oi = __shfl_xor_sync(FULL, bi, stride);
        const bool keep_min = ((l & stride) == 0) == ((l & size) == 0);
        if (keep_min == lex_less(od, oi, bd, bi)) {
          bd = od;
          bi = oi;
        }
      }
    const float td = __shfl_sync(FULL, bd, gshift + k - 1);
    const int ti = __shfl_sync(FULL, bi, gshift + k - 1);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (lex_less(td, ti, v[j], cbase + col_of(l, j))) m &= ~(1u << j);
  }
  if (!__any_sync(FULL, m != 0)) return;

  // compact the survivors into the batch: a prefix sum of the lanes' counts
  const int c = __popc(m);
  int incl = c;
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, o, 16);
    if (l >= o) incl += t;
  }
  const int cnt = __shfl_sync(FULL, incl, gshift + 15);
  int pos = incl - c;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (m >> j & 1u) {
      bat_d[pos] = v[j];
      bat_i[pos] = cbase + col_of(l, j);
      ++pos;
    }
  __syncwarp();

  // entry e = l + 16h of the union: list slot e (e < k) or batch entry
  // e - k; its rank is its place among the list's entries plus the count of
  // batch entries below it
  constexpr int H = (KMAX + BC + 15) / 16;
  float ed[H];
  int ei[H], rk[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int e = l + 16 * h;
    rk[h] = k;  // no entry: never written
    ed[h] = INFINITY;
    ei[h] = INT_MAX;
    if (16 * h >= k + cnt) continue;
    if (e < k) {
      ed[h] = ld[e];
      ei[h] = li[e];
      rk[h] = e;
    } else if (e < k + cnt) {
      ed[h] = bat_d[e - k];
      ei[h] = bat_i[e - k];
      int lo = 0, hi = k;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (lex_less(ld[mid], li[mid], ed[h], ei[h]))
          lo = mid + 1;
        else
          hi = mid;
      }
      rk[h] = lo;
    }
    for (int t = 0; t < cnt; ++t)
      rk[h] += lex_less(bat_d[t], bat_i[t], ed[h], ei[h]);
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < H; ++h)
    if (rk[h] < k) {
      ld[rk[h]] = ed[h];
      li[rk[h]] = ei[h];
    }
  __syncwarp();
}

// The merge of a finished tile: each half-warp merges its 8 rows. Kept
// out of line: inlined, its registers pushed the mainloop past the 128 that
// two blocks per SM allow, and the mainloop ran slower.
__device__ __noinline__ void merge_tile(const float* dist, float* top_d,
                                        int* top_i, float* bat_d, int* bat_i,
                                        int cbase, int ty, int lane, int k,
                                        bool first) {
  const int ks = list_stride(k), l = lane & 15, gshift = lane & 16;
  for (int i = 0; i < 8; ++i) {
    const int r = row_of(ty, i);
    merge_row(dist + r * LDD, top_d + r * ks, top_i + r * ks, bat_d, bat_i,
              cbase, l, gshift, k, first);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
knn_l2_split_kernel(const float* __restrict__ x, const float* __restrict__ sq,
                 const int* __restrict__ cmask, int n, int d, int k,
                 int splits, int* __restrict__ part_i,
                 float* __restrict__ part_d) {
  __shared__ __align__(16) float qs[2][DC * LDT];
  __shared__ __align__(16) float cs[2][DC * LDT];
  extern __shared__ __align__(16) float dyn[];
  const int ks = list_stride(k);
  float* dist = dyn;                                   // [BQ][LDD]
  float* top_d = dist + BQ * LDD;                      // [BQ][ks]
  int* top_i = reinterpret_cast<int*>(top_d + BQ * ks);

  const int tid = threadIdx.x, lane = tid % 32;
  const int ty = tid / 16, tx = tid % 16;
  const int qbase = blockIdx.x * BQ, split = blockIdx.y;
  const int n_tiles = (n + BC - 1) / BC;
  const int t0 = (int)((long long)split * n_tiles / splits);
  const int t1 = (int)((long long)(split + 1) * n_tiles / splits);
  const int n_chunks = (d + DC - 1) / DC;

  for (int e = tid; e < BQ * ks; e += THREADS) {
    top_d[e] = INFINITY;
    top_i[e] = INT_MAX;
  }

  // Each thread stages one float4 of the query tile and one of the
  // candidate tile per step (row lr, features f..f+3) and stores them
  // transposed into the other buffer. The loads always read a valid
  // address (rows and features clamped into the matrix); what lies past
  // the edges is zeroed only at the store, so no instruction waits for a
  // load before the step's products are done.
  const int lr = tid / 2, lf = (tid % 2) * 4;
  const int gq = qbase + lr;
  int gc = 0, f_ld = 0;
  float4 rq, rc;
  auto ldg = [&](int f) {
    f_ld = f;
    const int fc = f < d ? f : d - 4;
    const float* pq = x + (size_t)(gq < n ? gq : 0) * d + fc;
    const float* pc = x + (size_t)(gc < n ? gc : 0) * d + fc;
    rq = __ldg(reinterpret_cast<const float4*>(pq));
    rc = __ldg(reinterpret_cast<const float4*>(pc));
  };
  auto sts = [&](int buf) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 vq = gq < n && f_ld < d ? rq : zero;
    const float4 vc = gc < n && f_ld < d ? rc : zero;
    float* pq = qs[buf] + lf * LDT + lr;
    float* pc = cs[buf] + lf * LDT + lr;
    pq[0] = vq.x, pq[LDT] = vq.y, pq[2 * LDT] = vq.z, pq[3 * LDT] = vq.w;
    pc[0] = vc.x, pc[LDT] = vc.y, pc[2 * LDT] = vc.z, pc[3 * LDT] = vc.w;
  };

  int buf = 0;
  gc = t0 * BC + lr;
  ldg(lf);
  sts(0);
  __syncthreads();
  for (int tile = t0; tile < t1; ++tile) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      // the next step's loads fly during this step's products; a tile's
      // last step leaves them until after its epilogue
      const bool more = c + 1 < n_chunks;
      if (more) ldg((c + 1) * DC + lf);
      const float* a_s = qs[buf] + ty * 4;
      const float* b_s = cs[buf] + tx * 4;
      float4 fa[2][2], fb[2][2];
      fa[0][0] = *reinterpret_cast<const float4*>(a_s);
      fa[0][1] = *reinterpret_cast<const float4*>(a_s + BQ / 2);
      fb[0][0] = *reinterpret_cast<const float4*>(b_s);
      fb[0][1] = *reinterpret_cast<const float4*>(b_s + BC / 2);
#pragma unroll
      for (int kk = 0; kk < DC; ++kk) {
        const int cur = kk & 1, nxt = cur ^ 1;
        if (kk + 1 < DC) {
          const int o = (kk + 1) * LDT;
          fa[nxt][0] = *reinterpret_cast<const float4*>(a_s + o);
          fa[nxt][1] = *reinterpret_cast<const float4*>(a_s + o + BQ / 2);
          fb[nxt][0] = *reinterpret_cast<const float4*>(b_s + o);
          fb[nxt][1] = *reinterpret_cast<const float4*>(b_s + o + BC / 2);
        }
        const float av[8] = {fa[cur][0].x, fa[cur][0].y, fa[cur][0].z,
                             fa[cur][0].w, fa[cur][1].x, fa[cur][1].y,
                             fa[cur][1].z, fa[cur][1].w};
        const float bv[8] = {fb[cur][0].x, fb[cur][0].y, fb[cur][0].z,
                             fb[cur][0].w, fb[cur][1].x, fb[cur][1].y,
                             fb[cur][1].z, fb[cur][1].w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      if (more) {
        sts(buf ^ 1);
        __syncthreads();
        buf ^= 1;
      }
    }

    // The candidate tile is complete. Distances (NaN where there is no
    // candidate or no query) go to the shared tile; the operand ring is
    // free once every warp is past its products, and holds the batches.
    const int cbase = tile * BC;
    float sqc[8];
    unsigned live = 0, masked = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int g = cbase + col_of(tx, j);
      sqc[j] = 0.f;
      if (g < n) {
        live |= 1u << j;
        sqc[j] = sq[g];
        if (cmask[g] == 0) masked |= 1u << j;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ql = row_of(ty, i), q = qbase + ql;
      const float sqq = q < n ? sq[q] : 0.f;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int g = cbase + col_of(tx, j);
        v[j] = fmaxf(fmaf(-2.f, acc[i][j], sqq + sqc[j]), 0.f);
        if (g == q || (masked >> j & 1u)) v[j] = FLT_MAX;
        if (q >= n || !(live >> j & 1u)) v[j] = __int_as_float(0x7fffffff);
      }
      float* row = dist + ql * LDD + tx * 4;
      *reinterpret_cast<float4*>(row) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(row + BC / 2) =
          make_float4(v[4], v[5], v[6], v[7]);
    }
    __syncthreads();  // the ring is idle: it holds the half-warps' batches
    merge_tile(dist, top_d, top_i, qs[0] + (tid / 16) * BC,
               reinterpret_cast<int*>(cs[0]) + (tid / 16) * BC, cbase, ty,
               lane, k, tile == t0);
    __syncthreads();  // batches done before the ring is written again

    if (tile + 1 < t1) {  // the next tile's first step
      gc = (tile + 1) * BC + lr;
      ldg(lf);
      sts(buf ^ 1);
      __syncthreads();
      buf ^= 1;
    }
  }

  for (int e = tid; e < BQ * k; e += THREADS) {
    const int ql = e / k, j = e % k, q = qbase + ql;
    if (q < n) {
      const size_t o = ((size_t)split * n + q) * k + j;
      part_i[o] = top_i[ql * ks + j];
      part_d[o] = top_d[ql * ks + j];
    }
  }
}

constexpr int MERGE_WARPS = 4;

// The k smallest (d2, index) pairs of the union of a query's split lists:
// each entry's rank is its place in its own list plus, in every other list,
// the count of entries below it (a binary search). Lists are sorted and no
// index appears in two splits, so the ranks below k are 0..k-1 exactly once;
// unfilled slots (INT_MAX) are never written.
__global__ void __launch_bounds__(MERGE_WARPS * 32)
knn_l2_merge_kernel(const int* __restrict__ part_i,
                 const float* __restrict__ part_d, int n, int k, int splits,
                 int* __restrict__ idx_out, float* __restrict__ d_out) {
  __shared__ float md[MERGE_WARPS][MAX_SPLITS * KMAX];
  __shared__ int mi[MERGE_WARPS][MAX_SPLITS * KMAX];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = blockIdx.x * MERGE_WARPS + w;
  if (q >= n) return;
  const int total = splits * k;
  for (int e = lane; e < total; e += 32) {
    const size_t g = ((size_t)(e / k) * n + q) * k + e % k;
    md[w][e] = part_d[g];
    mi[w][e] = part_i[g];
  }
  __syncwarp();
  for (int e = lane; e < total; e += 32) {
    const float dv = md[w][e];
    const int iv = mi[w][e];
    if (iv == INT_MAX) continue;
    const int s = e / k;
    int rank = e % k;
    for (int s2 = 0; s2 < splits; ++s2) {
      if (s2 == s) continue;
      const float* ld = md[w] + s2 * k;
      const int* li = mi[w] + s2 * k;
      int lo = 0, hi = k;
      while (lo < hi) {
        const int mid = (lo + hi) / 2;
        if (lex_less(ld[mid], li[mid], dv, iv))
          lo = mid + 1;
        else
          hi = mid;
      }
      rank += lo;
    }
    if (rank < k) {
      idx_out[(size_t)q * k + rank] = iv;
      d_out[(size_t)q * k + rank] = dv;
    }
  }
}

cudaError_t set_smem() {
  return cudaFuncSetAttribute(knn_l2_split_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes(KMAX));
}

}  // namespace

// Candidate splits for N rows and k neighbours: as many as fill one wave of
// resident blocks (SMs x blocks per SM) over the ceil(N/128) query tiles,
// at most one per 128-candidate tile and at most MAX_SPLITS.
extern "C" int knn_l2_splits(int n, int k, int* splits) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = set_smem();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, knn_l2_split_kernel, THREADS, smem_bytes(k));
  if (err != cudaSuccess) return (int)err;
  const int q_tiles = (n + BQ - 1) / BQ, c_tiles = (n + BC - 1) / BC;
  int s = sms * (per_sm > 0 ? per_sm : 1) / (q_tiles > 0 ? q_tiles : 1);
  s = s < c_tiles ? s : c_tiles;
  s = s < MAX_SPLITS ? s : MAX_SPLITS;
  *splits = s > 1 ? s : 1;
  return 0;
}

// x [n, d] f32 (d a multiple of 4, rows 16-byte aligned), cmask [n] int32;
// scratch sq [n] and, when splits > 1, part_i / part_d [splits, n, k];
// out idx [n, k] int32 and d2 [n, k] f32.
extern "C" int knn_l2_f32(const float* x, const int* cmask, int n, int d,
                          int k, int splits, float* sq, int* part_i,
                          float* part_d, int* idx_out, float* d_out,
                          cudaStream_t stream) {
  if (k < 1 || k > KMAX || k > n || d < 4 || d % 4 != 0 || splits < 1 ||
      splits > MAX_SPLITS || splits > (n + BC - 1) / BC)
    return (int)cudaErrorInvalidValue;
  knn_l2_row_norms<<<(n + 7) / 8, 256, 0, stream>>>(x, n, d, sq);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = set_smem();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + BQ - 1) / BQ, splits);
  knn_l2_split_kernel<<<grid, THREADS, smem_bytes(k), stream>>>(
      x, sq, cmask, n, d, k, splits, splits > 1 ? part_i : idx_out,
      splits > 1 ? part_d : d_out);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  knn_l2_merge_kernel<<<(n + MERGE_WARPS - 1) / MERGE_WARPS,
                        MERGE_WARPS * 32, 0, stream>>>(part_i, part_d, n, k,
                                                       splits, idx_out, d_out);
  return (int)cudaGetLastError();
}
