// K6 `critic_stem`: LeakyReLU(0.2) of Conv3d(1 -> 64, k=4, s=2, p=1), no
// bias, the first layer of the ShapeHD / WGAN-GP critic
// (nn/voxel_nets.py::VoxelDiscriminator, layer 0 and its activation), for
// Hopper (sm_90a), in inference under bf16 autocast.
//
// Replaces no Pallas kernel: the JAX package leaves this layer to XLA.
// It was added because cuDNN runs this one-channel layer through its
// channels-last tensor-core kernel with layout conversions around it: at
// the benchmark's shape (128, 1, 128^3) 38.9 ms a call on an H100 (22.8
// of product, 15.0 of conversions), twice a ShapeHD batch, and autocast's
// cast of the input to bf16 and a separate LeakyReLU pass (4.29 GB read
// and written) came on top: about 83 ms of a ~300 ms batch.
//
// Layout (PyTorch's): v (B, 1, R, R, R) float32 (the critic's sigmoid
// runs in float32 under autocast), R in {32, 64, 128}
// (VoxelDiscriminator.WIDTHS), w (64, 1, 4, 4, 4) given as float32 (64,
// 64) and rounded to bf16 by the kernel -> out (B, 64, R/2, R/2, R/2)
// bf16, NCDHW.  Output o takes inputs 2o - 1 + k, k = 0..3, on
// each axis, zero outside the volume.
//
// What bounds it: device-memory bytes.  At (128, 1, 128^3) it reads 1.074
// GB of float32 input and writes 4.295 GB of bf16 output: 5.37 GB, 1.60 ms
// at 3.35 TB/s.  Its 2.75e11 operations take 0.28 ms at the dense bf16
// peak, but 4.3 ms at the float32 rate of the CUDA cores, so the product
// runs on the tensor cores and the design is about the bytes:
//   - the layer is a GEMM per output row (od, oh): C (64 channels x OR
//     positions) = W (64 channels x 64 taps) x A (64 taps x OR positions),
//     with mma.sync.m16n8k16 (bf16 in, float32 sums).  W is the mma's A
//     operand: its 16 fragments (4 channel tiles x 4 tap planes kd) are
//     loaded once per block into registers.  The taps of one kd are the
//     mma's k = 16 = (kh, kw), so a thread's B fragment, taps (kh, kw),
//     (kh, kw + 1) of one position, is two neighbouring input values;
//   - a tile is 2 output planes x 8 output rows x all OR positions, 16
//     rows, two per warp.  Its input, 6 planes x 18 rows x (R + 2)
//     values with the zero padding, is read once as float32, rounded to
//     bf16 (as autocast's cast would: the tensor cores see the same
//     values), and staged in shared memory with input w at
//     element w + 1 of its row.  The pair a B fragment needs, inputs
//     2o - 1 + kw, kw in {0, 1} or {2, 3}, then starts at an even element:
//     one aligned 32-bit load, and the row stride (RW words, RW mod 32 in
//     9..23) puts the two rows a load reads (kh and kh + 1) in different
//     banks.  The halo re-reads 1.7x the input from L2, not from memory;
//   - the epilogue applies LeakyReLU(0.2) to the float32 sum and rounds
//     once to bf16, writes the row (64 channels x OR positions) into the
//     warp's shared buffer (channel stride OR / 2 + 4 words: conflict
//     free), and stores it as 16-byte stores along the last axis, 8 lanes
//     to a channel's 128 contiguous bytes, with the streaming hint (the
//     output does not fit in L2; the input's halo should stay there);
//   - persistent blocks, two per SM (105 KB of shared memory each at R =
//     128), walk the tiles; while one block stages its next tile's input
//     the other computes and stores.
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCout = 64;                 // output channels
constexpr int kTD = 2, kTH = 8;           // output planes, rows per tile
constexpr int kWarps = 8;                 // two of the tile's 16 rows each
constexpr int kSD = 2 * kTD + 2, kSH = 2 * kTH + 2;  // staged planes, rows
constexpr int kLoads = 16;                // staging loads in flight a thread

// Staged row stride in 32-bit words: at least the OR + 1 words of a row
// (R + 2 values), and mod 32 in 9..23, so that rows kh and kh + 1 fall in
// different banks.
__host__ __device__ constexpr int row_words(int R) {
  int w = R / 2 + 1;
  while (w % 32 < 9 || w % 32 > 23) ++w;
  return w;
}
// A channel's stride in the warp's output buffer: OR / 2 words and 4 more
// (an odd multiple of 4: the epilogue's 8 channels x 4 words of one store
// fall in 32 banks, and a 16-byte read stays aligned).
__host__ __device__ constexpr int out_words(int R) { return R / 4 + 4; }

__host__ __device__ constexpr int smem_bytes(int R) {
  return 4 * (kSD * kSH * row_words(R) + kWarps * kCout * out_words(R));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

__device__ __forceinline__ float leaky(float x) {
  return x > 0.f ? x : 0.2f * x;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Block n walks tiles n, n + gridDim.x, ...; tile = (b, plane pair, row
// octet), row octet fastest.  Shared memory: the staged input, planes pd
// = d - (2 od0 - 1), rows ph = h - (2 oh0 - 1), element w + 1 of a row of
// RW words; then each warp's output buffer, 64 channels x OW words.
template <int R>
__global__ void __launch_bounds__(kWarps * 32, 2)
critic_stem_kernel(const float* __restrict__ v, const float* __restrict__ w,
                   __nv_bfloat16* __restrict__ out, int B) {
  constexpr int OR = R / 2, NT = OR / 8;  // output extent, 8-position tiles
  constexpr int RW = row_words(R), OW = out_words(R);
  constexpr int ROW = R + 2;              // staged values a row
  constexpr int STAGED = kSD * kSH * ROW;
  constexpr int PG = OR / kTD, HG = OR / kTH;  // plane pairs, row octets
  extern __shared__ uint32_t smem[];
  uint32_t* xs = smem;
  uint16_t* xh = reinterpret_cast<uint16_t*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  uint32_t* os = smem + kSD * kSH * RW + warp * kCout * OW;

  // W's fragments: a[m][kd] is channels 16 m .. 16 m + 15 x taps
  // 16 kd .. 16 kd + 15, row-major as the mma's A wants it
  uint32_t a[4][4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int kd = 0; kd < 4; ++kd)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ch = 16 * m + g + 8 * (r & 1);
        const int tap = 16 * kd + 2 * t + 8 * (r >> 1);
        a[m][kd][r] = pack_bf16x2(__ldg(w + ch * 64 + tap),
                                  __ldg(w + ch * 64 + tap + 1));
      }

  const int tiles = B * PG * HG;
  const int64_t RR = (int64_t)R * R, OO = (int64_t)OR * OR;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / (PG * HG);
    const int od0 = (tile / HG % PG) * kTD, oh0 = (tile % HG) * kTH;
    const float* vb = v + (int64_t)b * R * RR;
    __syncthreads();                      // the last tile's reads are done
    // stage: element e of the (pd, ph) row is input w = e - 1, rounded to
    // bf16; kLoads loads in flight a thread before their stores
    for (int base = threadIdx.x; base < STAGED;
         base += kLoads * kWarps * 32) {
      float val[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = base + u * kWarps * 32;
        const int row = i / ROW, e = i % ROW;
        const int d = 2 * od0 - 1 + row / kSH, h = 2 * oh0 - 1 + row % kSH;
        const int x = e - 1;
        val[u] = i < STAGED && (unsigned)d < (unsigned)R &&
                         (unsigned)h < (unsigned)R && (unsigned)x < (unsigned)R
                     ? vb[d * RR + h * R + x]
                     : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = base + u * kWarps * 32;
        if (i < STAGED)
          xh[2 * ((i / ROW) * RW) + i % ROW] =
              __bfloat16_as_ushort(__float2bfloat16(val[u]));
      }
    }
    __syncthreads();

    // warp w computes rows (od0 + p, oh0 + w), p = 0, 1
#pragma unroll 1
    for (int p = 0; p < kTD; ++p) {
      const uint32_t* x0 =
          xs + ((2 * p) * kSH + 2 * warp + (t >> 1)) * RW + g + (t & 1);
#pragma unroll 2
      for (int nt = 0; nt < NT; ++nt) {
        float c[4][4];
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int r = 0; r < 4; ++r) c[m][r] = 0.f;
#pragma unroll
        for (int kd = 0; kd < 4; ++kd) {
          // taps (kh, kw) = (t / 2, 2 (t % 2) + {0, 1}) and kh + 2 of
          // position 8 nt + g: inputs 2 o - 1 + kw at element 2 o + kw
          const uint32_t* xr = x0 + kd * kSH * RW + 4 * (2 * nt);
          const uint32_t b0 = xr[0], b1 = xr[2 * RW];
#pragma unroll
          for (int m = 0; m < 4; ++m) mma_bf16(c[m], a[m][kd], b0, b1);
        }
        // c[m]: channel 16 m + g (entries 0, 1) and + 8 (2, 3), positions
        // 8 nt + 2 t, + 1
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          os[(16 * m + g) * OW + 4 * nt + t] =
              pack_bf16x2(leaky(c[m][0]), leaky(c[m][1]));
          os[(16 * m + g + 8) * OW + 4 * nt + t] =
              pack_bf16x2(leaky(c[m][2]), leaky(c[m][3]));
        }
      }
      __syncwarp();
      const int od = od0 + p, oh = oh0 + warp;
      __nv_bfloat16* orow =
          out + ((int64_t)b * kCout * OR + od) * OO + (int64_t)oh * OR;
#pragma unroll
      for (int q = lane; q < kCout * NT; q += 32) {
        const int ch = q / NT, j = q % NT;
        const uint4 val = *reinterpret_cast<const uint4*>(os + ch * OW + 4 * j);
        __stcs(reinterpret_cast<uint4*>(orow + ch * OR * OO + 8 * j), val);
      }
      __syncwarp();                       // the buffer is written again
    }
  }
}

template <int R>
int launch(const float* v, const float* w, void* out, int B,
           cudaStream_t st) {
  auto kernel = critic_stem_kernel<R>;
  constexpr int smem = smem_bytes(R);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kWarps * 32, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t tiles = (int64_t)B * (R / 2 / kTD) * (R / 2 / kTH);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int64_t fill = (int64_t)sms * per_sm;
  const unsigned grid = (unsigned)(tiles < fill ? tiles : fill);
  kernel<<<grid, kWarps * 32, smem, st>>>(
      v, w, static_cast<__nv_bfloat16*>(out), B);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// v (B, 1, R, R, R) float32, w (64, 64) float32 -> out (B, 64, R/2, R/2,
// R/2) bf16, all contiguous.
int critic_stem(const float* v, const float* w, void* out, int B, int R,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1) return (int)cudaErrorInvalidValue;
  switch (R) {
    case 32: return launch<32>(v, w, out, B, st);
    case 64: return launch<64>(v, w, out, B, st);
    case 128: return launch<128>(v, w, out, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
