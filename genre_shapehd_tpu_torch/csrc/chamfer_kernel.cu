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
// Here the distance is (x - y)^2 directly in float32 multiply-adds, which
// loses no digits to cancellation; the ragged edge is a bounds check; and
// the index comes out of the same pass, carried in a register beside the
// running minimum, so the backward needs no second pass.
//
// x (B, N, 3), y (B, M, 3) float32 ->
//   d1 (B, N) = min_j |x_i - y_j|^2, i1 (B, N) int32 its j,
//   d2 (B, M) = min_i |y_j - x_i|^2, i2 (B, M) int32 its i.
// Ties go to the lowest index.
//
// What bounds it: operations.  Every pair costs 8 float32 operations (3
// subtractions, 3 multiplications, 2 additions) plus a compare and two
// selects, against 24 bytes per POINT, so memory is never the limit.  The
// design follows:
//   - grid (tiles of the query cloud, B, 2 directions); one thread per
//     query point, its coordinates, running minimum and index in
//     registers;
//   - the other cloud is staged through shared memory in tiles of 1024
//     points, padded to float4 so that one 16-byte broadcast load serves
//     a whole warp per pair;
//   - both directions in one launch: the eval protocol's clouds (1024
//     points) give each direction only 8 blocks, and one launch fills the
//     card twice as well as two.
// Later work: split the other cloud across a thread group with a shuffle
// reduction when B * N is too small to fill 132 SMs.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;    // query points per block
constexpr int kTile = 1024;    // points of the other cloud per stage

__global__ void nn_min_dist_kernel(const float* __restrict__ x,
                                   const float* __restrict__ y,
                                   float* __restrict__ d1,
                                   int* __restrict__ i1,
                                   float* __restrict__ d2,
                                   int* __restrict__ i2, int N, int M) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  // direction 0: queries x against y; direction 1: queries y against x
  const bool fwd = blockIdx.z == 0;
  const int nq = fwd ? N : M, nt = fwd ? M : N;
  if ((int64_t)blockIdx.x * kBlock >= nq) return;    // whole block
  const float* q = (fwd ? x : y) + (int64_t)b * nq * 3;
  const float* t = (fwd ? y : x) + (int64_t)b * nt * 3;

  const int p = blockIdx.x * kBlock + threadIdx.x;
  const bool live = p < nq;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = q[3 * (int64_t)p];
    qy = q[3 * (int64_t)p + 1];
    qz = q[3 * (int64_t)p + 2];
  }
  float best = FLT_MAX;
  int best_j = 0;
  for (int j0 = 0; j0 < nt; j0 += kTile) {
    const int n = min(kTile, nt - j0);
    __syncthreads();                                 // tile free again
    for (int s = threadIdx.x; s < n; s += kBlock) {
      const float* src = t + 3 * (int64_t)(j0 + s);
      tile[s] = make_float4(src[0], src[1], src[2], 0.f);
    }
    __syncthreads();
#pragma unroll 4
    for (int s = 0; s < n; ++s) {
      const float4 v = tile[s];
      const float dx = qx - v.x, dy = qy - v.y, dz = qz - v.z;
      const float d = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
      if (d < best) {
        best = d;
        best_j = j0 + s;
      }
    }
  }
  if (live) {
    (fwd ? d1 : d2)[(int64_t)b * nq + p] = best;
    (fwd ? i1 : i2)[(int64_t)b * nq + p] = best_j;
  }
}

}  // namespace

extern "C" {

// x (B, N, 3), y (B, M, 3) float32 contiguous -> d1, i1 (B, N), d2, i2
// (B, M).
int nn_min_dist(const float* x, const float* y, float* d1, int* i1,
                float* d2, int* i2, int B, int N, int M, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || N < 1 || M < 1) return (int)cudaErrorInvalidValue;
  const int most = N > M ? N : M;
  dim3 grid((unsigned)((most + kBlock - 1) / kBlock), (unsigned)B, 2u);
  nn_min_dist_kernel<<<grid, kBlock, 0, st>>>(x, y, d1, i1, d2, i2, N, M);
  return (int)cudaGetLastError();
}

}  // extern "C"
