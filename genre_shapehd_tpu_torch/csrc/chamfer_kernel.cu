// K4 `nn_min_dist`: for every point of one cloud the least squared
// distance to the other cloud and the index that gives it, both ways in
// one launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_min_dist_kernel` of
// genre_shapehd_tpu/ops/pallas/chamfer_kernel.py (reached through
// `_one_sided_min` by `nndistance_pallas` / `nndistance_score_pallas`).
// The TPU kernel forms 1024 x 1024 tiles of x^2 + y^2 - 2xy on the MXU,
// pads points to 8 lanes and clouds to the tile with far-away rows, and
// returns no index: its VJP takes the argmin from a second pass in XLA.
// Here the distance is (x - y)^2 directly in float32, which loses no
// digits to cancellation; the ragged edge is padding with points at
// infinity; and the index comes out of the same launch, so the backward
// needs no second pass.
//
// x (B, N, 3), y (B, M, 3) float32 ->
//   d1 (B, N) = min_j |x_i - y_j|^2, i1 (B, N) int32 its j,
//   d2 (B, M) = min_i |y_j - x_i|^2, i2 (B, M) int32 its i.
// Ties go to the lowest index.
//
// What bounds it: operations, issued.  Memory is never the limit (24
// bytes a point).  A pair costs 3 subtractions, a multiplication and 2
// multiply-adds; the design keeps what else a pair costs small and fills
// the card at the scoring path's 1 x 1024 x 1024:
//   - a group of G lanes (1 to 32, a power of two; `plan` picks it from
//     B * (N + M) so that the grid fills the card) serves
//     kQ = 4 query points; each lane scans every G-th point of the other
//     cloud, so one staged point serves 4 queries and a 1024-point cloud
//     still spreads over 128 blocks;
//   - the other cloud is staged through shared memory in tiles of 1024
//     points, padded to float4 and with points at infinity to a whole
//     number of chunks, so the hot loop has no bounds check;
//   - the hot loop keeps the minimum alone (one min a pair) over a chunk
//     of kChunk points a lane; per chunk it keeps the chunk where the
//     minimum last fell (strictly), and at the end it scans that one
//     chunk again for the first point at the minimum: the index costs no
//     select a pair;
//   - the group reduces (distance, index) by shuffles, the lower index
//     winning a tie, so ties still go to the lowest index;
//   - both directions in one launch.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kQ = 4;          // query points per group
constexpr int kChunk = 16;     // points a lane scans between index checks
constexpr int kTile = 1024;    // points of the other cloud per stage
constexpr int64_t kFill = 1 << 17;  // threads that fill the card: ~1000 on
                                    // each of an H100's 132 SMs

// One formula for the hot loop and the rescan: the rescan finds the
// minimum bit for bit.
__device__ __forceinline__ float sqdist(float qx, float qy, float qz,
                                        float px, float py, float pz) {
  const float dx = qx - px, dy = qy - py, dz = qz - pz;
  return fmaf(dz, dz, fmaf(dy, dy, dx * dx));
}

// grid (blocks of the longer direction, B, 2 directions).  Thread t of a
// block is lane t % G of group t / G; group g serves queries q0 .. q0 + 3,
// q0 = (block * (kThreads / G) + g) * kQ.
template <int G>
__global__ void __launch_bounds__(kThreads)
nn_min_dist_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   float* __restrict__ d1, int* __restrict__ i1,
                   float* __restrict__ d2, int* __restrict__ i2, int N,
                   int M) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  // direction 0: queries x against y; direction 1: queries y against x
  const bool fwd = blockIdx.z == 0;
  const int nq = fwd ? N : M, nt = fwd ? M : N;
  const int q0 = (blockIdx.x * (kThreads / G) + threadIdx.x / G) * kQ;
  if ((int64_t)blockIdx.x * (kThreads / G) * kQ >= nq) return;  // whole block
  const float* q = (fwd ? x : y) + (int64_t)b * nq * 3;
  const float* t = (fwd ? y : x) + (int64_t)b * nt * 3;
  const int lg = threadIdx.x % G;

  float qx[kQ], qy[kQ], qz[kQ], best[kQ];
  int best_j[kQ];                            // start of the best chunk
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int64_t p = min(q0 + u, nq - 1);   // past the end: a repeat
    qx[u] = q[3 * p];
    qy[u] = q[3 * p + 1];
    qz[u] = q[3 * p + 2];
    best[u] = INFINITY;
    best_j[u] = 0;
  }
  const float4* lane_tile = tile + lg;
  for (int j0 = 0; j0 < nt; j0 += kTile) {
    const int n = min(kTile, nt - j0);
    // whole chunks for every lane; points past n lie at infinity
    const int span = (n + G * kChunk - 1) / (G * kChunk) * (G * kChunk);
    __syncthreads();                         // the tile is free again
#pragma unroll 8
    for (int s = threadIdx.x; s < span; s += kThreads) {
      if (s < n) {
        const float* src = t + 3 * (int64_t)(j0 + s);
        tile[s] = make_float4(src[0], src[1], src[2], 0.f);
      } else {
        tile[s] = make_float4(INFINITY, INFINITY, INFINITY, 0.f);
      }
    }
    __syncthreads();
    for (int c = 0; c < span; c += G * kChunk) {
      float cm[kQ];
#pragma unroll
      for (int s = 0; s < kChunk; ++s) {
        const float4 v = lane_tile[c + s * G];
#pragma unroll
        for (int u = 0; u < kQ; ++u) {
          const float d = sqdist(qx[u], qy[u], qz[u], v.x, v.y, v.z);
          cm[u] = s == 0 ? d : fminf(cm[u], d);
        }
      }
#pragma unroll
      for (int u = 0; u < kQ; ++u) {
        // strictly less: an equal minimum in a later chunk has a larger
        // index
        const bool lower = cm[u] < best[u];
        best[u] = lower ? cm[u] : best[u];
        best_j[u] = lower ? j0 + c + lg : best_j[u];
      }
    }
  }
  // the index: the first point of the best chunk at the minimum, with
  // every load of the chunk issued at once (a loop that stops at the match
  // waits for one load after another)
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int j_start = best_j[u];
    int found = -1;
#pragma unroll
    for (int s = kChunk - 1; s >= 0; --s) {
      const int j = j_start + s * G;
      const float* p = t + 3 * (int64_t)min(j, nt - 1);
      if (j < nt && sqdist(qx[u], qy[u], qz[u], p[0], p[1], p[2]) == best[u])
        found = j;
    }
    best_j[u] = found >= 0 ? found : j_start;
  }
  // the group's minimum, the lower index on a tie
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      const float od = __shfl_xor_sync(0xffffffffu, best[u], off);
      const int oj = __shfl_xor_sync(0xffffffffu, best_j[u], off);
      if (od < best[u] || (od == best[u] && oj < best_j[u])) {
        best[u] = od;
        best_j[u] = oj;
      }
    }
  }
  if (lg == 0) {
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      if (q0 + u >= nq) break;
      (fwd ? d1 : d2)[(int64_t)b * nq + q0 + u] = best[u];
      (fwd ? i1 : i2)[(int64_t)b * nq + q0 + u] = best_j[u];
    }
  }
}

// Lanes per group of kQ query points for clouds (B, N, 3), (B, M, 3): the
// least power of two up to 32 that gives kFill threads over both
// directions; and the blocks of the launch.
void plan(int B, int N, int M, int* group, int* blocks) {
  const int64_t queries = (int64_t)B * ((int64_t)N + M);
  int G = 1;
  while (G < 32 && queries * G < kFill * kQ) G *= 2;
  const int most = N > M ? N : M;
  const int per_block = kThreads / G * kQ;
  *group = G;
  *blocks = 2 * B * ((most + per_block - 1) / per_block);
}

template <int G>
int launch(const float* x, const float* y, float* d1, int* i1, float* d2,
           int* i2, int B, int N, int M, cudaStream_t st) {
  const int most = N > M ? N : M;
  const int per_block = kThreads / G * kQ;
  dim3 grid((unsigned)((most + per_block - 1) / per_block), (unsigned)B, 2u);
  nn_min_dist_kernel<G><<<grid, kThreads, 0, st>>>(x, y, d1, i1, d2, i2, N,
                                                   M);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The lanes per group and the blocks that nn_min_dist launches for these
// clouds.
void nn_min_dist_plan(int B, int N, int M, int* group, int* blocks) {
  plan(B, N, M, group, blocks);
}

// x (B, N, 3), y (B, M, 3) float32 contiguous -> d1, i1 (B, N), d2, i2
// (B, M).
int nn_min_dist(const float* x, const float* y, float* d1, int* i1,
                float* d2, int* i2, int B, int N, int M, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || N < 1 || M < 1) return (int)cudaErrorInvalidValue;
  int group = 0, blocks = 0;
  plan(B, N, M, &group, &blocks);
  switch (group) {
    case 1: return launch<1>(x, y, d1, i1, d2, i2, B, N, M, st);
    case 2: return launch<2>(x, y, d1, i1, d2, i2, B, N, M, st);
    case 4: return launch<4>(x, y, d1, i1, d2, i2, B, N, M, st);
    case 8: return launch<8>(x, y, d1, i1, d2, i2, B, N, M, st);
    case 16: return launch<16>(x, y, d1, i1, d2, i2, B, N, M, st);
    default: return launch<32>(x, y, d1, i1, d2, i2, B, N, M, st);
  }
}

}  // extern "C"
