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
// Layout: v (B, 1, R, R, R) float32 (the critic's sigmoid runs in float32
// under autocast), R in {32, 64, 128} (VoxelDiscriminator.WIDTHS), w (64,
// 1, 4, 4, 4) given as float32 (64, 64) and rounded to bf16 by the kernel
// -> out (B, R/2, R/2, R/2, 64) bf16, NDHWC (the caller's (B, 64, R/2,
// R/2, R/2) in channels_last_3d), the layout the critic's next layers
// read (K7, critic_conv_kernel.cu).  Output o takes inputs 2o - 1 + k, k
// = 0..3, on each axis, zero outside the volume.
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
//     once to bf16, writes the row (OR positions x 64 channels) into the
//     warp's shared buffer (position stride 36 words: conflict free), and
//     stores it as 16-byte stores, 8 lanes to a position's 128 contiguous
//     bytes (the row is OR x 128 contiguous bytes in NDHWC), with the
//     streaming hint (the output does not fit in L2; the input's halo
//     should stay there);
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
// A position's stride in the warp's output buffer: 32 words of 64 bf16
// channels and 4 more (an odd multiple of 4: the lanes of one 2-byte store,
// channels g, g + 1 .. of positions 2t, 2t + 1, fall in 16 banks, and a
// 16-byte read stays aligned).
constexpr int kPosWords = kCout / 2 + 4;

__host__ __device__ constexpr int smem_bytes(int R) {
  return 4 * (kSD * kSH * row_words(R) + kWarps * (R / 2) * kPosWords);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));
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
// RW words; then each warp's output buffer, OR positions x kPosWords.
template <int R>
__global__ void __launch_bounds__(kWarps * 32, 2)
critic_stem_kernel(const float* __restrict__ v, const float* __restrict__ w,
                   __nv_bfloat16* __restrict__ out, int B) {
  constexpr int OR = R / 2, NT = OR / 8;  // output extent, 8-position tiles
  constexpr int RW = row_words(R);
  constexpr int ROW = R + 2;              // staged values a row
  constexpr int STAGED = kSD * kSH * ROW;
  constexpr int PG = OR / kTD, HG = OR / kTH;  // plane pairs, row octets
  extern __shared__ uint32_t smem[];
  uint32_t* xs = smem;
  uint16_t* xh = reinterpret_cast<uint16_t*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  uint32_t* os = smem + kSD * kSH * RW + warp * OR * kPosWords;
  uint16_t* oh16 = reinterpret_cast<uint16_t*>(os);

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
  const int64_t RR = (int64_t)R * R;
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
        const int q0 = (8 * nt + 2 * t) * (2 * kPosWords) + g;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int q = q0 + 16 * m;
          oh16[q] = bf16_bits(leaky(c[m][0]));
          oh16[q + 2 * kPosWords] = bf16_bits(leaky(c[m][1]));
          oh16[q + 8] = bf16_bits(leaky(c[m][2]));
          oh16[q + 2 * kPosWords + 8] = bf16_bits(leaky(c[m][3]));
        }
      }
      __syncwarp();
      const int od = od0 + p, oh = oh0 + warp;
      uint4* orow = reinterpret_cast<uint4*>(
          out + (((int64_t)b * OR + od) * OR + oh) * OR * kCout);
#pragma unroll
      for (int q = lane; q < OR * 8; q += 32) {
        const uint4 val =
            *reinterpret_cast<const uint4*>(os + (q >> 3) * kPosWords +
                                            4 * (q & 7));
        __stcs(orow + q, val);
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

// ------------------------------------------------------------- backward
// The first pass of the stem's backward, channels-last in, channels-first
// out: gi (B, 64, S, S, S) bf16 = g where y > 0, else 0.2 g rounded once
// to bf16 (F.leaky_relu's backward on its own output), for g and y (B, S,
// S, S, 64) bf16 (K6's output, and its gradient from K7's backward), so
// that K3 reads gi as it stands and no layout pass runs.  A block takes
// one (b, d, h) row at a time: the row's S x 64 values of g and y by
// 16-byte loads, the masked values into shared memory transposed,
// [channel][S] with each channel's 16-byte chunks swizzled by its octet
// (the 8 lanes of one 128-byte load write 8 channel octets of one
// position: 8 chunks, 16 banks), then each channel's S values by 16-byte
// stores.  Bound by its bytes: 3 x 2.15 GB at (64, 64, 64^3), 1.92 ms at
// 3.35 TB/s.
template <int S>
__global__ void __launch_bounds__(256)
critic_stem_mask_kernel(const uint4* __restrict__ g,
                        const uint4* __restrict__ y,
                        __nv_bfloat16* __restrict__ gi, int rows) {
  constexpr int kChunks = S / 8;          // 16-byte chunks a channel's row
  __shared__ __align__(16) uint16_t buf[kCout * S];
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int64_t base = (int64_t)row * S * 8;   // in 16-byte units
    for (int i = threadIdx.x; i < S * 8; i += blockDim.x) {
      // position w = i / 8, channels 8 oct .. 8 oct + 7
      const uint4 gv = __ldcs(g + base + i), yv = __ldcs(y + base + i);
      const int w = i >> 3, oct = i & 7;
      const uint16_t* gh = reinterpret_cast<const uint16_t*>(&gv);
      const uint16_t* yh = reinterpret_cast<const uint16_t*>(&yv);
      uint16_t* dst = buf + 8 * oct * S + 8 * ((w >> 3) ^ (oct % kChunks)) +
                      (w & 7);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float gf = __bfloat162float(__ushort_as_bfloat16(gh[k]));
        const float yf = __bfloat162float(__ushort_as_bfloat16(yh[k]));
        dst[k * S] = yf > 0.f ? gh[k] : bf16_bits(0.2f * gf);
      }
    }
    __syncthreads();
    const int b = row / (S * S), dh = row % (S * S);
    for (int i = threadIdx.x; i < kCout * kChunks; i += blockDim.x) {
      const int c = i / kChunks, j = i % kChunks;
      const uint4 v = *reinterpret_cast<const uint4*>(
          buf + c * S + 8 * (j ^ ((c >> 3) % kChunks)));
      *reinterpret_cast<uint4*>(
          gi + (((int64_t)b * kCout + c) * S * S + dh) * S + 8 * j) = v;
    }
    __syncthreads();                      // the buffer is written again
  }
}

template <int S>
int launch_mask(const void* g, const void* y, void* gi, int B,
                cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t rows = (int64_t)B * S * S, fill = (int64_t)sms * 8;
  if (rows > 0x7fffffff) return (int)cudaErrorInvalidValue;
  critic_stem_mask_kernel<S><<<(unsigned)(rows < fill ? rows : fill), 256, 0,
                               st>>>(static_cast<const uint4*>(g),
                                     static_cast<const uint4*>(y),
                                     static_cast<__nv_bfloat16*>(gi),
                                     (int)rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// g, y (B, S, S, S, 64) bf16 -> gi (B, 64, S, S, S) bf16, all contiguous,
// S in {16, 32, 64}.
int critic_stem_mask(const void* g, const void* y, void* gi, int B, int S,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1) return (int)cudaErrorInvalidValue;
  switch (S) {
    case 16: return launch_mask<16>(g, y, gi, B, st);
    case 32: return launch_mask<32>(g, y, gi, B, st);
    case 64: return launch_mask<64>(g, y, gi, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// v (B, 1, R, R, R) float32, w (64, 64) float32 -> out (B, R/2, R/2, R/2,
// 64) bf16, all contiguous.
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
