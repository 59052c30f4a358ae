// Exact L2 k-nearest neighbours of one slide, f32 on the CUDA cores.
//
// Replaces wsi_hgnn_tpu/ops/pallas_knn.py::knn_l2_pallas (Pallas body
// `_kernel`). Same function: d2 = (|q|^2 + |c|^2) - 2 q.c in f32, clamped
// at 0; self and masked candidates get FLT_MAX (the value the exact XLA
// path ops/knn.py::knn_l2 uses); the k smallest per query, ascending, ties
// to the lower candidate index.
//
// Bound on the H100: 2*N^2*D f32 operations (8.6 GFLOP at N=2048,
// D=1024) against 67 TFLOP/s of f32 FMA, about 0.13 ms; the bytes (N*D
// read once) are a few microseconds, so it is compute-bound. Distances
// stay in f32 FMA on purpose: TF32 or bf16 tensor cores would move
// distances by more than the gaps between neighbours and change
// neighbour sets against the JAX package.
//
// Design: one block of 256 threads per tile of 32 queries walks every
// candidate tile of 128 in index order. Each step stages a 32-wide
// feature chunk of the queries and the candidates in shared memory and
// every thread accumulates a 4x4 block of dot products in registers; the
// candidate norms are accumulated from the same staged chunks. The
// finished 32x128 distance tile goes to shared memory, and one thread per
// query folds it into that query's running top-k (shared memory,
// insertion sort). Candidates arrive in increasing index order and an
// entry only moves past strictly larger distances, so equal distances
// keep the lower index first, as lax.top_k does. The ragged edge of N is
// masked in the kernel, so any N works (the Pallas kernel needed N to
// divide its tiles). The N x N distance matrix never exists in memory.
#include <cfloat>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int TQ = 32;       // queries per block
constexpr int TC = 128;      // candidates per tile
constexpr int DC = 32;       // feature chunk staged per step
constexpr int KMAX = 32;     // largest k the kernel keeps
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
knn_l2_kernel(const float* __restrict__ x, const int* __restrict__ cmask,
              int n, int d, int k, int* __restrict__ idx_out,
              float* __restrict__ d_out) {
  // +1 columns keep the transposed stores free of bank conflicts
  __shared__ float q_s[DC][TQ + 1];
  __shared__ float c_s[DC][TC + 1];
  __shared__ float dist_s[TQ][TC + 1];
  __shared__ float best_d[TQ][KMAX + 1];
  __shared__ int best_i[TQ][KMAX + 1];
  __shared__ float sqq_s[TQ];
  __shared__ float sqc_s[TC];

  const int tid = threadIdx.x;
  const int qbase = blockIdx.x * TQ;
  const int qy = tid / 32;  // queries qy*4 .. qy*4+3
  const int cx = tid % 32;  // candidates cx, cx+32, cx+64, cx+96

  if (tid < TQ) {
    for (int j = 0; j < k; ++j) {
      best_d[tid][j] = INFINITY;
      best_i[tid][j] = INT_MAX;
    }
  }
  float sq_q = 0.f;  // threads TC .. TC+TQ-1, during the first tile only

  for (int cbase = 0; cbase < n; cbase += TC) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float sq_c = 0.f;

    for (int d0 = 0; d0 < d; d0 += DC) {
      for (int e = tid; e < TQ * DC; e += THREADS) {
        const int q = e / DC, dd = e % DC;
        const int gq = qbase + q, gd = d0 + dd;
        q_s[dd][q] = (gq < n && gd < d) ? __ldg(x + (size_t)gq * d + gd) : 0.f;
      }
      for (int e = tid; e < TC * DC; e += THREADS) {
        const int c = e / DC, dd = e % DC;
        const int gc = cbase + c, gd = d0 + dd;
        c_s[dd][c] = (gc < n && gd < d) ? __ldg(x + (size_t)gc * d + gd) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int dd = 0; dd < DC; ++dd) {
        float qv[4], cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = q_s[dd][qy * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) cv[j] = c_s[dd][cx + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i], cv[j], acc[i][j]);
      }
      if (tid < TC) {
        for (int dd = 0; dd < DC; ++dd) sq_c = fmaf(c_s[dd][tid], c_s[dd][tid], sq_c);
      } else if (cbase == 0 && tid < TC + TQ) {
        const int q = tid - TC;
        for (int dd = 0; dd < DC; ++dd) sq_q = fmaf(q_s[dd][q], q_s[dd][q], sq_q);
      }
      __syncthreads();
    }
    if (tid < TC) sqc_s[tid] = sq_c;
    if (cbase == 0 && tid >= TC && tid < TC + TQ) sqq_s[tid - TC] = sq_q;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = qy * 4 + i, c = cx + 32 * j;
        const int gq = qbase + q, gc = cbase + c;
        float v = (sqq_s[q] + sqc_s[c]) - 2.0f * acc[i][j];
        v = fmaxf(v, 0.f);
        if (gc < n && (gc == gq || cmask[gc] == 0)) v = FLT_MAX;
        dist_s[q][c] = v;
      }
    }
    __syncthreads();

    if (tid < TQ) {
      const int q = tid;
      const int cend = min(TC, n - cbase);
      float kth = best_d[q][k - 1];
      for (int c = 0; c < cend; ++c) {
        const float v = dist_s[q][c];
        if (v < kth) {
          int j = k - 1;
          while (j > 0 && best_d[q][j - 1] > v) {
            best_d[q][j] = best_d[q][j - 1];
            best_i[q][j] = best_i[q][j - 1];
            --j;
          }
          best_d[q][j] = v;
          best_i[q][j] = cbase + c;
          kth = best_d[q][k - 1];
        }
      }
    }
    __syncthreads();  // dist_s is rewritten by the next tile
  }

  if (tid < TQ && qbase + tid < n) {
    const size_t row = (size_t)(qbase + tid) * k;
    for (int j = 0; j < k; ++j) {
      idx_out[row + j] = best_i[tid][j];
      d_out[row + j] = best_d[tid][j];
    }
  }
}

}  // namespace

extern "C" int knn_l2_f32(const float* x, const int* cmask, int n, int d,
                          int k, int* idx_out, float* d_out,
                          cudaStream_t stream) {
  if (k < 1 || k > KMAX || k > n) return (int)cudaErrorInvalidValue;
  knn_l2_kernel<<<(n + TQ - 1) / TQ, THREADS, 0, stream>>>(
      x, cmask, n, d, k, idx_out, d_out);
  return (int)cudaGetLastError();
}
