// K3 `deconv_final`: ConvTranspose3d(Cin -> 1, k=4, s=2, p=1) + bias, the
// last layer (dec6) of the 3D U-Net, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_final_tail_kernel` of
// genre_shapehd_tpu/ops/pallas/subpixel_kernel.py and the XLA phase conv
// in front of it (`_final_fwd`): the whole of `deconv_final_fused`.  The
// TPU splits the layer into an XLA conv that leaves an 8-phase tensor in
// memory and a kernel that interleaves the phases with selection-matrix
// matmuls, because Mosaic cannot interleave lanes.  A GPU thread writes
// wherever it likes, so here one kernel does the contraction and writes
// the interleaved output directly; no phase tensor exists.
//
// Layout (PyTorch's): x (B, Cin, S, S, S), weight (Cin, 1, 4, 4, 4) given
// as float32 (Cin, 64), bias (1,) float32 -> out (B, 1, 2S, 2S, 2S).
// Per axis, output o = 2i + a (a in {0,1}) takes inputs i + a - 1 + d with
// tap 3 - a - 2d, d in {0,1}, zero outside [0, S).
//
// What bounds it: device-memory bytes.  At the main path's shape (B=8,
// Cin=40, S=64, bf16) it reads 168 MB and writes 34 MB (about 60 us at
// 3.35 TB/s); its 5.4 G multiply-adds take about 160 us at the float32
// rate of the CUDA cores.  The design follows:
//   - one thread per INPUT position (i, j, k) computes the 2x2x2 output
//     block it owns (all 8 phases), and kRows = 4 such positions along
//     i: per channel it loads the 6 x 3 x 3 input neighbourhood once (54
//     loads) and spends 256 multiply-adds on it, instead of 8 loads per 8
//     multiply-adds per output voxel;
//   - threads run along k, the contiguous axis of x, so every load is
//     coalesced; the two outputs (2k, 2k+1) of a row are stored as one
//     pair, so stores are coalesced too;
//   - the whole weight (Cin * 64 floats, 10 KB at Cin = 40) sits in
//     shared memory; a warp reads the same address (broadcast), 4 taps per
//     load.
// Accumulation and the bias add are float32; the result is rounded once
// to the output type (as the Pallas kernel does).
// Later work: tensor cores (the contraction is a (positions x 27 Cin) by
// (27 Cin x 8) product), and staging the input slab in shared memory.
//
// `dtype` 0 = float32 x/out, 1 = bfloat16.  The entry point returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;    // input positions per thread along i

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T>
__global__ void deconv_final_kernel(const T* __restrict__ x,
                                    const float* __restrict__ w,
                                    const float* __restrict__ bias,
                                    T* __restrict__ out, int B, int Cin,
                                    int S) {
  constexpr int R = kRows;
  extern __shared__ float4 sw4[];            // (Cin, 64) floats
  float* sw = reinterpret_cast<float*>(sw4);
  for (int t = threadIdx.x; t < Cin * 64; t += blockDim.x) sw[t] = __ldg(w + t);
  __syncthreads();

  // thread n owns input positions (i0 .. i0+R-1, j, k) of batch item b
  const int SI = (S + R - 1) / R;
  const int64_t n = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t S3 = (int64_t)S * S * S;
  if (n >= (int64_t)B * SI * S * S) return;
  const int k = (int)(n % S);
  const int j = (int)((n / S) % S);
  const int i0 = (int)((n / ((int64_t)S * S)) % SI) * R;
  const int b = (int)(n / ((int64_t)SI * S * S));

  // the (R+2) x 3 x 3 neighbourhood; false where it leaves the volume
  bool ok_i[R + 2], ok_j[3], ok_k[3];
#pragma unroll
  for (int d = 0; d < R + 2; ++d)
    ok_i[d] = (unsigned)(i0 + d - 1) < (unsigned)S;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    ok_j[d] = (unsigned)(j + d - 1) < (unsigned)S;
    ok_k[d] = (unsigned)(k + d - 1) < (unsigned)S;
  }
  const T* xc = x + (int64_t)b * Cin * S3 + ((int64_t)i0 * S + j) * S + k;

  float acc[R][2][2][2];
#pragma unroll
  for (int a = 0; a < R * 8; ++a) (&acc[0][0][0][0])[a] = 0.f;

  for (int c = 0; c < Cin; ++c, xc += S3) {
    float wc[64];
    const float4* wv = sw4 + c * 16;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const float4 v = wv[q];
      wc[4 * q] = v.x; wc[4 * q + 1] = v.y;
      wc[4 * q + 2] = v.z; wc[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int pi = 0; pi < R + 2; ++pi) {      // input plane i0 + pi - 1
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
#pragma unroll
        for (int dk = 0; dk < 3; ++dk) {
          float v = 0.f;
          if (ok_i[pi] && ok_j[dj] && ok_k[dk])
            v = to_f32(xc[((int64_t)(pi - 1) * S + (dj - 1)) * S + (dk - 1)]);
          // for position r the plane sits at offset di = pi - r (0..2,
          // i.e. i + di - 1); offset d feeds phase a when d - a is 0 or
          // 1, with tap 3 + a - 2d
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int di = pi - r;
            if (di < 0 || di > 2) continue;
#pragma unroll
            for (int a = 0; a < 2; ++a) {
              if (di - a < 0 || di - a > 1) continue;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                if (dj - e < 0 || dj - e > 1) continue;
#pragma unroll
                for (int f = 0; f < 2; ++f) {
                  if (dk - f < 0 || dk - f > 1) continue;
                  const int tap =
                      ((3 + a - 2 * di) * 4 + (3 + e - 2 * dj)) * 4 +
                      (3 + f - 2 * dk);
                  acc[r][a][e][f] = fmaf(v, wc[tap], acc[r][a][e][f]);
                }
              }
            }
          }
        }
      }
    }
  }

  const float bv = __ldg(bias);
  const int64_t O = 2 * (int64_t)S;
  T* ob = out + (int64_t)b * O * O * O;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (i0 + r >= S) break;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        store_pair(
            ob + ((2 * (int64_t)(i0 + r) + a) * O + (2 * j + e)) * O + 2 * k,
            acc[r][a][e][0] + bv, acc[r][a][e][1] + bv);
  }
}

template <typename T>
int launch(const void* x, const float* w, const float* bias, void* out, int B,
           int Cin, int S, cudaStream_t st) {
  const int block = 128;
  const int64_t n = (int64_t)B * ((S + kRows - 1) / kRows) * S * S;
  const int64_t grid = (n + block - 1) / block;
  const size_t smem = (size_t)Cin * 64 * sizeof(float);
  if (grid > 0x7fffffff || smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        deconv_final_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  deconv_final_kernel<T><<<(unsigned)grid, block, smem, st>>>(
      static_cast<const T*>(x), w, bias, static_cast<T*>(out), B, Cin, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, Cin, S, S, S), w (Cin, 64) float32, bias (1,) float32 ->
// out (B, 1, 2S, 2S, 2S), all contiguous.
int deconv_final(const void* x, const float* w, const float* bias, void* out,
                 int dtype, int B, int Cin, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || Cin < 1 || S < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, w, bias, out, B, Cin, S, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, bias, out, B, Cin, S, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
